"""Device meshes and parallelism axes (port of ``ray_tpu/parallel/mesh.py``).

The JAX package lays a ``jax.sharding.Mesh`` over the devices of one
controller and lets XLA emit the collectives.  The port runs PyTorch's
way: one process per device, joined by the default ``torch.distributed``
process group (``train/backend.py`` starts it: NCCL for the card, gloo
for the CPU).  A ``Mesh`` lays the canonical axes over the group's ranks
in row-major order, exactly as the JAX mesh lays them over its devices,
and holds a process subgroup for each axis a collective runs over
(``parallel/collectives.py``).

Canonical axis names (order matters — outer axes map to slower links):

    pp    pipeline stages
    dp    pure data parallel    (gradient all-reduce only)
    fsdp  ZeRO-sharded data     (params gathered for the step)
    ep    expert parallel
    sp    sequence/context
    tp    tensor parallel       (innermost)

``MeshSpec`` and its sizing rules are the JAX package's.  A hybrid spec
(a ``dcn_*`` size above 1) puts the DCN axes first and groups ranks in
contiguous chunks, one a host: ranks on one host are contiguous under
``torchrun`` and ``train/backend.launch``.

A process without an initialised process group is a world of one rank:
its mesh has every axis of size 1 and no group.  ``shard_map_unchecked``
has no counterpart: port code already runs per rank.  The training step
runs over the data axes and ``ep``: ``group(("ep",))`` joins the ranks
that hold the other experts of the caller's rows, and the group of the
data axes joins the data members at the caller's ``ep`` coordinate.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

AXIS_ORDER: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

# Hybrid DCN×ICI axes: present in a mesh only when a hybrid spec asks
# for them.  dcn_tp sits last so hybrid train meshes keep their leading
# (dcn_pp, dcn_dp, dcn_fsdp) positions.
DCN_AXIS_ORDER: Tuple[str, ...] = ("dcn_pp", "dcn_dp", "dcn_fsdp", "dcn_tp")

# Axes over which a replica of the model parameters is complete: data is
# split over these; params are replicated (dp) or sharded and gathered
# (fsdp).
DATA_AXES: Tuple[str, ...] = ("dcn_dp", "dcn_fsdp", "dp", "fsdp")

AxisName = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative parallelism layout.

    Sizes of -1 mean "absorb remaining devices" (at most one axis may be
    -1).  Axes of size 1 are still present in the mesh so sharding rules
    can always refer to every canonical axis.  ``dcn_*`` sizes > 1
    request a hybrid mesh: ranks group by host, the dcn axes index the
    groups, and the canonical axes lay out each group.
    """

    pp: int = 1
    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    dcn_pp: int = 1
    dcn_dp: int = 1
    dcn_fsdp: int = 1
    dcn_tp: int = 1

    @property
    def hybrid(self) -> bool:
        return any(getattr(self, a) != 1 for a in DCN_AXIS_ORDER)

    def dcn_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in DCN_AXIS_ORDER}

    def sizes(self, num_devices: int) -> Dict[str, int]:
        for a, s in self.dcn_sizes().items():
            if s < 1:
                raise ValueError(
                    f"{a}={s}: DCN axes take explicit sizes >= 1 (the "
                    f"-1 wildcard applies to in-slice axes only)")
        n_groups = math.prod(self.dcn_sizes().values())
        if num_devices % n_groups:
            raise ValueError(
                f"{num_devices} devices not divisible into {n_groups} "
                f"DCN groups")
        per_group = num_devices // n_groups
        sizes = {a: getattr(self, a) for a in AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if per_group % fixed:
                raise ValueError(
                    f"{per_group} devices/group not divisible by fixed "
                    f"axes product {fixed}"
                )
            sizes[wild[0]] = per_group // fixed
        elif fixed != per_group:
            raise ValueError(
                f"mesh wants {fixed} devices per group but {per_group} "
                f"are available"
            )
        if self.hybrid:
            sizes.update(self.dcn_sizes())
        return sizes

    def with_axes(self, **kwargs) -> "MeshSpec":
        return dataclasses.replace(self, **kwargs)


def rank_grid(spec: MeshSpec, world_size: int,
              axis_names: Tuple[str, ...] = AXIS_ORDER
              ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """(axis names, ranks laid out on the mesh): rank ``r`` sits where
    the JAX package's ``create_mesh`` puts the device of id ``r`` on the
    CPU backend (ids in order; hybrid groups in contiguous chunks)."""
    sizes = spec.sizes(world_size)
    ranks = np.arange(world_size)
    if spec.hybrid:
        inner = tuple(sizes[a] for a in axis_names)
        dcn = tuple(sizes[a] for a in DCN_AXIS_ORDER)
        return DCN_AXIS_ORDER + tuple(axis_names), ranks.reshape(dcn + inner)
    return tuple(axis_names), ranks.reshape(
        tuple(sizes[a] for a in axis_names))


class Mesh:
    """The canonical axes over the ranks of the default process group.

    ``devices`` is the grid of ranks (the JAX mesh's grid of devices),
    ``shape`` each axis's size, ``rank`` and ``coords`` the calling
    process's place.  ``group(axes)`` is the process group of the ranks
    that share the caller's coordinates on every other axis: the
    default group when that is every rank, None for the caller alone
    (a collective over it is a local copy), else a subgroup.  Subgroups
    for each axis and for the data axes are made with the mesh, by every
    rank in the same order, as ``torch.distributed.new_group`` asks; one
    for another set of axes is made on its first request, so SPMD code
    must ask for it on every rank."""

    def __init__(self, axis_names: Tuple[str, ...], devices: np.ndarray,
                 rank: int = 0, distributed: bool = False):
        self.axis_names = tuple(axis_names)
        self.devices = devices
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))
        self.size = int(devices.size)
        self.rank = rank
        where = np.argwhere(devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} not on the mesh {devices}")
        self.coords: Dict[str, int] = dict(zip(self.axis_names,
                                               map(int, where[0])))
        self.distributed = distributed
        self._groups: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}"
                f"{'' if self.distributed else ', no process group'})")

    def _axes(self, axis: AxisName) -> Tuple[str, ...]:
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} not in mesh {self.axis_names}")
        order = [self.axis_names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"axes {axes} are not in the mesh's order "
                             f"{self.axis_names}")
        return axes

    def axis_size(self, axis: AxisName) -> int:
        return math.prod(self.shape[a] for a in self._axes(axis))

    def axis_index(self, axis: AxisName) -> int:
        """The caller's index along ``axis`` (row-major over a tuple)."""
        idx = 0
        for a in self._axes(axis):
            idx = idx * self.shape[a] + self.coords[a]
        return idx

    def line_ranks(self, axis: AxisName,
                   coords: Optional[Dict[str, int]] = None
                   ) -> Tuple[int, ...]:
        """The ranks that share ``coords`` (default: the caller's) on
        every axis but ``axis``, in the order of their index along it
        (ascending rank: the process group's own order)."""
        axes = self._axes(axis)
        coords = self.coords if coords is None else coords
        index = tuple(slice(None) if a in axes else coords[a]
                      for a in self.axis_names)
        return tuple(int(r) for r in self.devices[index].reshape(-1))

    def _lines(self, axes: Tuple[str, ...]) -> List[Tuple[int, ...]]:
        other = [a for a in self.axis_names if a not in axes]
        lines = []
        for idx in np.ndindex(*(self.shape[a] for a in other)):
            coords = dict(zip(other, idx))
            lines.append(self.line_ranks(axes, {**coords,
                                                **{a: 0 for a in axes}}))
        return lines

    def group(self, axis: AxisName):
        """The process group along ``axis`` (see the class docstring)."""
        axes = self._axes(axis)
        if axes in self._groups:
            return self._groups[axes]
        import torch.distributed as dist

        n = self.axis_size(axes)
        if self.distributed and n == self.size:
            g = dist.group.WORLD
        elif n == 1 or not self.distributed:
            g = None
        else:
            g = None
            mine = self.line_ranks(axes)
            for ranks in self._lines(axes):
                pg = dist.new_group(list(ranks))
                if ranks == mine:
                    g = pg
        self._groups[axes] = g
        return g


def create_mesh(spec: Optional[MeshSpec] = None, *,
                world_size: Optional[int] = None, rank: Optional[int] = None,
                axis_names: Tuple[str, ...] = AXIS_ORDER) -> Mesh:
    """The mesh of ``spec`` over the default process group's ranks (a
    world of one rank when none is initialised).  ``world_size`` and
    ``rank`` lay a mesh out without a process group (no collectives):
    what each rank of such a world would hold."""
    import torch.distributed as dist

    spec = spec or MeshSpec()
    distributed = world_size is None and dist.is_available() \
        and dist.is_initialized()
    if distributed:
        world_size, rank = dist.get_world_size(), dist.get_rank()
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    names, grid = rank_grid(spec, world_size, axis_names)
    mesh = Mesh(names, grid, rank, distributed)
    if distributed:
        for a in names:
            mesh.group(a)
        mesh.group(tuple(a for a in DATA_AXES if a in names))
    return mesh


def single_device_mesh(device: Optional[torch.device] = None) -> Mesh:
    """A mesh of the calling process alone (``device`` is accepted for
    the JAX signature: a rank's device is its own)."""
    return create_mesh(MeshSpec(dp=1), world_size=1, rank=0)


def create_serving_mesh(shards: int, tp: int) -> Mesh:
    """Mesh for a multi-host tensor-parallel serving replica: ``shards``
    shard-group members along ``dcn_tp`` × ``tp`` ranks inside each.
    The process group must hold exactly ``shards * tp`` ranks (a replica
    owns its ranks; the JAX package leaves extra devices out)."""
    return create_mesh(MeshSpec(dp=1, tp=tp, dcn_tp=shards))


def serving_mesh_shape(mesh: Mesh) -> str:
    """Human/CLI form of a serving mesh's layout ("dcn_tp=2 x tp=4")."""
    parts = []
    for a in ("dcn_tp", "tp"):
        if mesh.shape.get(a, 1) >= 1:
            parts.append(f"{a}={mesh.shape.get(a, 1)}")
    return " x ".join(parts)


def data_axis_size(mesh: Mesh) -> int:
    return math.prod(mesh.shape[a] for a in DATA_AXES if a in mesh.shape)


def model_axes(mesh: Mesh) -> List[str]:
    return [a for a in ("tp", "sp", "ep", "pp") if mesh.shape.get(a, 1) > 1]


@dataclasses.dataclass(frozen=True)
class GpuTopology:
    """The machine as a mesh sees it: the card's generation
    (from its name), the cards in the world, hosts and cards a host."""

    generation: str  # e.g. "h100"; "cpu" without a card
    chips: int
    hosts: int
    chips_per_host: int

    @property
    def name(self) -> str:
        return f"{self.generation}-{self.chips}"


def detect_topology() -> GpuTopology:
    """The card's generation and count; a torch.distributed world spans
    ``WORLD_SIZE // LOCAL_WORLD_SIZE`` hosts (the variables ``torchrun``
    and ``train/backend.launch`` set), else one."""
    import os

    if torch.cuda.is_available():
        kind = torch.cuda.get_device_name(0).lower()
        local = torch.cuda.device_count()
    else:
        kind, local = "cpu", 1
    gen = "cpu"
    for g in ("h200", "h100", "h800", "gh200", "a100", "l40", "l4"):
        if g in kind:
            gen = g
            break
    world = int(os.environ.get("WORLD_SIZE", local))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", min(local, world)))
    hosts = max(1, world // max(1, per_host))
    return GpuTopology(generation=gen, chips=world, hosts=hosts,
                       chips_per_host=max(1, world // hosts))


def default_spec_for(num_devices: int, *, model_bytes: int = 0) -> MeshSpec:
    """Heuristic layout: pure FSDP over every device, dp=1 on one."""
    if num_devices == 1:
        return MeshSpec(dp=1)
    return MeshSpec(dp=1, fsdp=num_devices)
