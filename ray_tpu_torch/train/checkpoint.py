"""Checkpoint save/restore (port of ``ray_tpu/train/checkpoint.py``).

The JAX package writes through orbax; the port writes one ``torch.save``
file per step into a step-numbered directory (``<directory>/<step>/``),
written under a temporary name and renamed into place, and keeps the
newest ``max_to_keep``.  Saving is synchronous: ``wait`` is accepted for
the JAX package's signature.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Any, List, Optional

import torch

from ray_tpu_torch.train.state import TrainState

_FILE = "state.pt"


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_host(v) for v in tree)
    return tree.detach().cpu() if torch.is_tensor(tree) else tree


@torch.no_grad()
def _fill(like: Any, saved: Any, where: str = "state") -> Any:
    """``saved``'s values in ``like``'s tensors (copied in place, so
    devices, dtypes and ``requires_grad`` stay), shapes checked; dicts,
    tuples and lists (the int8 Adam states' ``(q, scale)`` pairs) are
    walked alike."""
    if isinstance(like, dict):
        if set(like) != set(saved):
            raise ValueError(f"checkpoint {where}: keys {sorted(saved)}, "
                             f"want {sorted(like)}")
        return {k: _fill(like[k], saved[k], f"{where}.{k}") for k in like}
    if isinstance(like, (tuple, list)):
        if not isinstance(saved, (tuple, list)) or len(saved) != len(like):
            raise ValueError(f"checkpoint {where}: {type(saved).__name__} "
                             f"where a {type(like).__name__} of {len(like)} "
                             "is wanted")
        return type(like)(_fill(a, b, f"{where}[{i}]")
                          for i, (a, b) in enumerate(zip(like, saved)))
    if torch.is_tensor(like):
        if tuple(saved.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint {where}: shape "
                             f"{tuple(saved.shape)}, want {tuple(like.shape)}")
        return like.copy_(saved)
    return saved


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, _FILE)))

    def save(self, step: int, state: TrainState, *,
             metrics: Optional[dict] = None, wait: bool = False) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory)
        torch.save({"state": _to_host(tuple(state)), "metrics": metrics},
                   os.path.join(tmp, _FILE))
        final = os.path.join(self.directory, str(step))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[:-self.max_to_keep or None]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, state_like: TrainState, *,
                step: Optional[int] = None) -> TrainState:
        """The checkpoint of ``step`` (default: the newest) loaded into
        ``state_like``'s tensors."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        saved = torch.load(os.path.join(self.directory, str(step), _FILE),
                           map_location="cpu", weights_only=True)["state"]
        return TrainState(*(_fill(like, got, name) for like, got, name in
                            zip(state_like, saved, TrainState._fields)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        pass
