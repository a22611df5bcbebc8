"""The loss-split protocol: what the data-parallel step tells the loss it
runs, and what the loss tells the step.

Inside ``shard_map`` a JAX function sees its mesh axes by name, and under
GSPMD a loss is written over the global batch.  The port runs one process
a data member, each with its rows of the batch (``train/step.py``).  So
the step publishes its data group while it runs the loss and its
backward (``publish``), and the loss declares how its value splits over
the members (``declare``):

* ``"tokens"``: a masked mean over tokens whose aux holds the member's
  token count (``ntokens``) and nothing but ``loss``.  The step weights
  the member's loss and grads by its share of the global count (the
  Llama and Mamba-2 losses; an aux of exactly those keys declares it).
* ``"rows"``: a mean over the batch's rows, with no aux but ``loss``.
  The step weights the member's loss and grads by its share of the
  global rows (ViT).
* ``"global"``: the loss reads the data group and returns its additive
  share of the global objective, and every aux value as its additive
  share (Mixtral, CLIP).  The step sums them over the members.

A loss called outside the data-parallel step (the single-device step,
a test) gets no group and computes over its own batch.  The group also
carries the ``ep`` axis, over which a rank holds its share of the
experts (``models/mixtral.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import torch

from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel.mesh import Mesh

SPLITS = ("tokens", "rows", "global")


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The data members of the calling rank's step.

    ``axes`` are the mesh's data axes (the members differ only on them),
    ``n`` the members, ``index`` the calling member's chunk of the batch
    rows and ``order`` each member's chunk in the group's own order;
    ``rows`` the global rows of the (micro)batch the loss is given.
    ``ep`` and ``ep_index``: the ``ep`` axis's size and the caller's
    place on it (1 and 0 on a mesh without one)."""

    mesh: Mesh
    axes: Tuple[str, ...]
    n: int
    index: int
    order: Tuple[int, ...]
    rows: int
    ep: int = 1
    ep_index: int = 0

    @property
    def group(self):
        return self.mesh.group(self.axes)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the members, with no gradient."""
        return C.allreduce(x.detach(), self.axes, mesh=self.mesh)

    def _row_order(self, stacked: torch.Tensor) -> torch.Tensor:
        if list(self.order) == list(range(self.n)):
            return stacked
        where = [0] * self.n
        for pos, chunk in enumerate(self.order):
            where[chunk] = pos
        return stacked.index_select(0, torch.tensor(where,
                                                    device=stacked.device))

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The members' ``x`` stacked [n, ...] in row order, with no
        gradient."""
        out = C.allgather(x.detach()[None], self.axes, mesh=self.mesh)
        return self._row_order(out)

    def gather_grad(self, x: torch.Tensor) -> torch.Tensor:
        """The members' ``x`` concatenated along dim 0 in row order; the
        backward hands each member the gradient of its part summed over
        every member's use of it."""
        out = C.allgather_grad(x[None], self.axes, mesh=self.mesh)
        return self._row_order(out).reshape(-1, *x.shape[1:])


class _Frame:
    def __init__(self, group: DataGroup):
        self.group = group
        self.split: Optional[str] = None


_FRAMES: List[_Frame] = []


@contextlib.contextmanager
def publish(group: DataGroup):
    """Make ``group`` the data group that ``declare`` and ``current``
    return while the block runs (the step wraps the loss and its
    backward, so recomputed layers see it too); yields the frame whose
    ``split`` records what the loss declared."""
    frame = _Frame(group)
    _FRAMES.append(frame)
    try:
        yield frame
    finally:
        _FRAMES.pop()


def declare(split: str) -> Optional[DataGroup]:
    """Called by a loss: declares how its value splits over the data
    members (one of ``SPLITS``) and returns the step's data group, or
    None outside the data-parallel step."""
    if split not in SPLITS:
        raise ValueError(f"unknown loss split {split!r}; one of {SPLITS}")
    if not _FRAMES:
        return None
    frame = _FRAMES[-1]
    if frame.split not in (None, split):
        raise ValueError(f"the loss declared the split {split!r} after "
                         f"{frame.split!r}")
    frame.split = split
    return frame.group


def current() -> Optional[DataGroup]:
    """The step's data group without declaring a split (for a layer that
    reads it, as Mixtral's MoE block does), or None outside the
    data-parallel step."""
    return _FRAMES[-1].group if _FRAMES else None
