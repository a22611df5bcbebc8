"""Logical-axis sharding rules (port of ``ray_tpu/parallel/sharding.py``).

Models annotate their parameters and activations with *logical* axis
names ("embed", "mlp", "heads", "batch", ...) and a rule table maps
those to mesh axes, as in the JAX package: changing the layout is a
rule-table edit, not a model edit.  ``Rules``, ``DEFAULT_RULES``, the
DCN expansion and ``spec_for`` are the JAX package's, copied.

The port runs one process per device (``parallel/mesh.py``), so a
tensor a rank holds is its own shard, not a global array.  In place of
``NamedSharding`` a ``Sharding(mesh, spec)`` describes a layout: for
each dim, the mesh axes it is split over, major to minor as in a
``PartitionSpec`` entry (``("dp", "fsdp")`` splits a dim into ``dp ·
fsdp`` chunks and gives chunk ``dp_index · fsdp + fsdp_index`` to a
rank).  ``Sharding.local_slices(shape)`` is the calling rank's part of a
global shape; ``shard_tree`` cuts a rank's shards out of a full tree and
``replicated`` is the layout of no split.  No layout pads: a dim must
divide by its split count.  The "expert" rule puts the E axis of an
MoE layer's expert leaves ([L, E, ...]) and router ([L, D, E]) on
``ep``: each ``ep`` rank holds E/ep experts at rest.

``constrain``, ``constrain_to_spec`` and ``current_mesh`` have no
counterpart: they ask GSPMD to lay out a traced value inside a jitted
program, and an eager per-rank program holds its shards explicitly
(the training step's collectives are written out in ``train/step.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

# rule: logical axis name -> mesh axis | tuple of mesh axes | None (replicate)
Rules = Dict[str, Union[str, Tuple[str, ...], None]]

# Default rule table for transformer LMs: the JAX package's, so a layout
# named in one package means the same in the other.
DEFAULT_RULES: Rules = {
    # data
    "batch": ("dp", "fsdp"),
    "seq": "sp",
    # params
    "vocab": "tp",
    "embed": "fsdp",
    "embed_tp": "tp",     # activations' feature dim under tensor parallel
    "heads": "tp",
    "kv_heads": "tp",
    "head_dim": None,
    "mlp": "tp",
    "expert": "ep",
    "layers": None,       # used by scan-stacked params; pp handles stages
    # state-space models
    "state": None,
    # ZeRO weight-update sharding (train/zero.py): the axes optimizer
    # state and the update shard over.
    "zero": ("dp", "fsdp"),
}

# On a mesh that carries a dcn_* axis the matching in-slice axis expands
# to (dcn pair, axis) at spec time: rule tables stay written in the flat
# six-axis vocabulary.
_DCN_EXPANSION = {"dp": "dcn_dp", "fsdp": "dcn_fsdp", "pp": "dcn_pp",
                  "tp": "dcn_tp"}

Entry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dim entries: None (not split), a mesh axis, or a tuple of mesh
    axes (major to minor).  Trailing dims past its length are not split,
    as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries: Entry):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def spec_for(logical_axes: Sequence[Optional[str]],
             rules: Optional[Rules] = None, *,
             mesh_axes: Optional[frozenset] = None) -> PartitionSpec:
    """Map a tuple of logical axis names (None = replicated dim) to a
    PartitionSpec.  ``mesh_axes``: the target mesh's axis names — used
    to expand dp/fsdp/pp/tp over their DCN partners on hybrid meshes and
    to drop axes the mesh doesn't carry."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    out = []
    used = set()
    for name in logical_axes:
        if name is None:
            out.append(None)
            continue
        if name not in rules:
            raise KeyError(f"no sharding rule for logical axis {name!r}")
        axes = rules[name]
        if axes is None:
            out.append(None)
            continue
        if isinstance(axes, str):
            axes = (axes,)
        if mesh_axes is not None:
            expanded = []
            for a in axes:
                dcn = _DCN_EXPANSION.get(a)
                if dcn is not None and dcn in mesh_axes:
                    expanded.append(dcn)
                expanded.append(a)
            axes = tuple(a for a in expanded if a in mesh_axes)
        # A mesh axis may appear only once in a PartitionSpec.
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return PartitionSpec(*out)


def axis_tuple(entry: Entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of mesh axes (empty: not split)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Sharding:
    """A layout over ``mesh`` (``parallel/mesh.Mesh``): ``spec``'s entry
    for each dim names the mesh axes that dim is split over."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: Sequence[Entry]):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"Sharding({self.spec!r})"

    def axes(self, ndim: int) -> Tuple[Tuple[str, ...], ...]:
        """Per dim, the mesh axes it is split over (``ndim`` dims)."""
        if len(self.spec) > ndim:
            raise ValueError(f"{self.spec} has more entries than {ndim} dims")
        entries = list(self.spec) + [None] * (ndim - len(self.spec))
        return tuple(axis_tuple(e) for e in entries)

    def splits(self, ndim: int) -> Tuple[int, ...]:
        """Per dim, how many chunks it is cut into."""
        return tuple(math.prod(self.mesh.shape[a] for a in axes)
                     for axes in self.axes(ndim))

    @property
    def is_replicated(self) -> bool:
        return all(math.prod(self.mesh.shape[a] for a in axis_tuple(e)) == 1
                   for e in self.spec)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one shard of a global ``shape`` (JAX's
        ``NamedSharding.shard_shape``)."""
        out = []
        for n, k in zip(shape, self.splits(len(shape))):
            if n % k:
                raise ValueError(f"dim of {n} does not split into {k} "
                                 f"({self.spec}; shardings never pad)")
            out.append(n // k)
        return tuple(out)

    def global_shape(self, shard_shape: Sequence[int]) -> Tuple[int, ...]:
        """The global shape whose shard is ``shard_shape``."""
        return tuple(n * k for n, k in
                     zip(shard_shape, self.splits(len(shard_shape))))

    def slices_at(self, shape: Sequence[int],
                  coords: Dict[str, int]) -> Tuple[slice, ...]:
        """The shard of a global ``shape`` that the rank at mesh
        ``coords`` holds."""
        out = []
        for n, axes in zip(shape, self.axes(len(shape))):
            k = math.prod(self.mesh.shape[a] for a in axes)
            if n % k:
                raise ValueError(f"dim of {n} does not split into {k} "
                                 f"({self.spec}; shardings never pad)")
            idx = 0
            for a in axes:  # major to minor
                idx = idx * self.mesh.shape[a] + coords[a]
            size = n // k
            out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """The calling rank's shard of a global ``shape``."""
        return self.slices_at(shape, self.mesh.coords)


def sharding_for(mesh, logical_axes: Sequence[Optional[str]],
                 rules: Optional[Rules] = None) -> Sharding:
    return Sharding(mesh, spec_for(logical_axes, rules,
                                   mesh_axes=frozenset(mesh.axis_names)))


def is_axes_leaf(x) -> bool:
    """A logical-axes leaf: a tuple of axis names (or None) per dim."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_shardings(mesh, logical_tree: Any,
                   rules: Optional[Rules] = None) -> Any:
    """A tree of logical-axis tuples → the same tree of ``Sharding``s."""
    if is_axes_leaf(logical_tree):
        return sharding_for(mesh, logical_tree, rules)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(mesh, v, rules)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [tree_shardings(mesh, v, rules) for v in logical_tree]
    raise TypeError(f"not a logical-axes tree: {logical_tree!r}")


def local_shard(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """The calling rank's shard of the full tensor ``x``: ``x`` itself
    when the layout does not split it, else a contiguous copy of the
    slice (so the full tensor can be freed)."""
    if sharding.is_replicated:
        return x
    return x[sharding.local_slices(x.shape)].contiguous()


def shard_tree(mesh, tree: Any, logical_tree: Any,
               rules: Optional[Rules] = None) -> Any:
    """The calling rank's shards of a full tree, laid out by the
    logical-axes tree (each rank passes the same full tree)."""
    shardings = tree_shardings(mesh, logical_tree, rules)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, s)]
        return local_shard(t, s)

    return walk(tree, shardings)


def replicated(mesh) -> Sharding:
    return Sharding(mesh, PartitionSpec())
