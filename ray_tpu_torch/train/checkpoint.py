"""Checkpoint save/restore (port of ``ray_tpu/train/checkpoint.py``).

The JAX package writes through orbax, each host its own shards.  The
port writes a step-numbered directory (``<directory>/<step>/``): each
rank of the mesh ``torch.save``s its shards of the state
(``shard-<rank>.pt``), then rank 0 writes ``manifest.json`` (the world
size and, given the state's layout, each leaf's spec) and renames the
directory into place from its temporary name; the newest
``max_to_keep`` stay.  A restore needs the same world size and layout,
and each rank reads its own shards back into its state's tensors.
Without a mesh (or on a mesh of one rank) there is one shard.  A leaf
split over ``ep`` (a rank's experts) is a shard like any other.  Saving
is synchronous: ``wait`` is accepted for the JAX package's signature.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch.train.state import TrainState

_MANIFEST = "manifest.json"


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


def _specs(tree: Any, prefix: str = "") -> Dict[str, str]:
    """Each layout leaf of a ``Sharding`` tree as ``path: spec``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_specs(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_specs(v, f"{prefix}[{i}]"))
        return out
    return {} if tree is None else {prefix: repr(tree.spec)}


class CheckpointManager:
    """``mesh``: the ranks that save and restore together (each its own
    shards; default: this process alone).  ``shardings``: the state's
    layout (``zero.state_shardings``), recorded at save and checked at
    restore."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 mesh=None, shardings: Optional[TrainState] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.rank = mesh.rank if mesh is not None else 0
        self.world = mesh.size if mesh is not None else 1
        self._distributed = mesh is not None and mesh.distributed \
            and self.world > 1
        self.layouts = _specs(tuple(shardings)) if shardings else None
        os.makedirs(self.directory, exist_ok=True)

    def _barrier(self) -> None:
        if self._distributed:
            import torch.distributed as dist

            dist.barrier()

    def _steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.exists(
                          os.path.join(self.directory, n, _MANIFEST)))

    def save(self, step: int, state: TrainState, *,
             metrics: Optional[dict] = None, wait: bool = False) -> None:
        tmp = os.path.join(self.directory, f".{step}.tmp")
        if self.rank == 0:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        self._barrier()
        torch.save({"state": _to_host(tuple(state)), "metrics": metrics},
                   os.path.join(tmp, f"shard-{self.rank}.pt"))
        self._barrier()
        if self.rank == 0:
            with open(os.path.join(tmp, _MANIFEST), "w") as f:
                json.dump({"step": int(step), "world_size": self.world,
                           "layouts": self.layouts}, f, indent=1)
            final = os.path.join(self.directory, str(step))
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self._steps()[:-self.max_to_keep or None]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        self._barrier()

    def restore(self, state_like: TrainState, *,
                step: Optional[int] = None) -> TrainState:
        """The checkpoint of ``step`` (default: the newest) loaded into
        ``state_like``'s tensors (this rank's shards)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        where = os.path.join(self.directory, str(step))
        with open(os.path.join(where, _MANIFEST)) as f:
            manifest = json.load(f)
        if manifest["world_size"] != self.world:
            raise ValueError(
                f"checkpoint {where}: written by {manifest['world_size']} "
                f"ranks, restored on {self.world}")
        if (self.layouts is not None and manifest["layouts"] is not None
                and manifest["layouts"] != self.layouts):
            diff = sorted(k for k in set(self.layouts)
                          | set(manifest["layouts"])
                          if self.layouts.get(k)
                          != manifest["layouts"].get(k))
            raise ValueError(f"checkpoint {where}: layouts differ at "
                             f"{diff[:4]}")
        saved = torch.load(os.path.join(where, f"shard-{self.rank}.pt"),
                           map_location="cpu", weights_only=True)["state"]
        return TrainState(*(_fill(like, got, name) for like, got, name in
                            zip(state_like, saved, TrainState._fields)))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        pass
