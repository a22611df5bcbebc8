"""Cross-replica sharding of the weight update, ZeRO-style (port of
``ray_tpu/train/zero.py``).

The layout side of "Automatic Cross-Replica Sharding of Weight Update in
Data-Parallel Training" (PAPERS.md, arXiv 2004.13336): Adam's moments
live sharded over the data axes instead of replicated on every data
member.  The JAX package pins the layout and lets GSPMD turn the
gradient all-reduce into reduce-scatter → local update → all-gather;
the port writes those three steps out (``train/step.py``), each rank
holding its own shard.

Layout rules, per optimizer-state subtree of a ``TrainState``, as in the
JAX package:

* param-mirror subtrees (``AdamW``'s mu/nu, with the params' structure)
  keep their params' layout and additionally shard their largest
  still-replicated dim over the free data axes when sizes divide;
* int8 blockwise subtrees (``adamw8bit``'s ``(q [nb, 256], scale [nb,
  1])`` pairs) shard the leading block dim;
* scalars (the step count) replicate.

Nothing is ever padded: a dim is sharded over the longest prefix of the
data axes whose size product divides it, so tiny leaves stay replicated.

``LeafLayout`` and ``StepLayout`` are the port's own: where each param
leaf lives at rest and which part of it each data member updates, with
the packing that turns those parts into the chunks of one
reduce-scatter and one all-gather.  On a mesh with an ``ep`` axis a
leaf split over ``ep`` (an expert leaf, the router) is laid out as the
rank's ``ep`` part of it, over the data members at that ``ep``
coordinate: ZeRO shards its moments inside each coordinate, and the
global norm counts each ``ep`` part once.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch.parallel.mesh import DATA_AXES, Mesh
from ray_tpu_torch.parallel.sharding import (
    PartitionSpec,
    Rules,
    Sharding,
    axis_tuple,
    spec_for,
)
from ray_tpu_torch.train.state import TrainState, tree_leaves, tree_unflatten

# Logical axis name the rule table maps to the weight-update shard axes
# (DEFAULT_RULES: ("dp", "fsdp"), DCN-expanded on hybrid meshes).
ZERO_AXIS = "zero"
EP_AXIS = "ep"
BLOCK = 256  # optim8's block (kept here so the layout needs no optim8)


def zero_axes(mesh: Mesh, rules: Optional[Rules] = None) -> Tuple[str, ...]:
    """Mesh axes the weight update shards over: the "zero" rule resolved
    against ``mesh``, keeping only axes present with size > 1."""
    spec = spec_for((ZERO_AXIS,), rules,
                    mesh_axes=frozenset(mesh.axis_names))
    entry = spec[0] if len(spec) else None
    return tuple(a for a in axis_tuple(entry) if mesh.shape.get(a, 1) > 1)


def dp_shards(mesh: Mesh, rules: Optional[Rules] = None) -> int:
    """How many ways the optimizer state shards (1 = replicated layout)."""
    return max(1, math.prod(mesh.shape[a] for a in zero_axes(mesh, rules)))


def shardable_prefix(size: int, axes: Tuple[str, ...], mesh: Mesh
                     ) -> Tuple[str, ...]:
    """Longest prefix of ``axes`` whose size product divides ``size``."""
    for k in range(len(axes), 0, -1):
        prefix = axes[:k]
        if size % math.prod(mesh.shape.get(a, 1) for a in prefix) == 0:
            return prefix
    return ()


def is_blockpair(node) -> bool:
    """optim8's (q int8 [nb, BLOCK], f32 scale [nb, 1]) leaf pair."""
    if not (isinstance(node, tuple) and len(node) == 2):
        return False
    q, s = node
    return (torch.is_tensor(q) and torch.is_tensor(s) and q.dim() == 2
            and s.dim() == 2 and q.dtype == torch.int8
            and tuple(s.shape) == (q.shape[0], 1))


def block_sharding(mesh: Mesh, shape: Tuple[int, ...],
                   rules: Optional[Rules] = None) -> Sharding:
    """Sharding for a blockwise buffer: leading (block) dim over the data
    axes, divisibility permitting; replicated otherwise."""
    ax = shardable_prefix(shape[0], zero_axes(mesh, rules), mesh) \
        if shape else ()
    if not ax:
        return Sharding(mesh, PartitionSpec())
    entry = ax[0] if len(ax) == 1 else ax
    return Sharding(mesh, PartitionSpec(entry, *([None] * (len(shape) - 1))))


def _extend_spec(entries, shape, free: Tuple[str, ...], mesh: Mesh):
    """Assign the free data axes to the largest effectively-replicated
    dim they divide.  A dim already annotated with size-1 axes counts as
    replicated — the free axes compose onto it."""
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        cur = axis_tuple(entries[d])
        if math.prod(mesh.shape.get(a, 1) for a in cur) != 1:
            continue
        usable = shardable_prefix(shape[d], free, mesh)
        if not usable:
            continue
        new = cur + usable
        entries[d] = new[0] if len(new) == 1 else new
        return entries
    return entries


def _same_structure(node: Any, like: Any) -> bool:
    if isinstance(like, dict):
        return isinstance(node, dict) and set(node) == set(like) and all(
            _same_structure(node[k], like[k]) for k in like)
    if isinstance(like, list):
        return isinstance(node, list) and len(node) == len(like) and all(
            _same_structure(a, b) for a, b in zip(node, like))
    return not isinstance(node, (dict, list))


def _param_axes(params: Any, params_axes: Any) -> List[Tuple]:
    leaves = tree_leaves(params)
    if params_axes is None:
        return [(None,) * p.dim() for p in leaves]
    axes = tree_leaves(params_axes)
    if len(axes) != len(leaves):
        raise ValueError(f"params_axes has {len(axes)} leaves, the params "
                         f"{len(leaves)}")
    return axes


def state_shardings(mesh: Mesh, state: TrainState, params_axes: Any,
                    rules: Optional[Rules] = None, *,
                    zero: bool = False) -> TrainState:
    """The layout of a whole (full) ``TrainState``: params by their
    logical axes; optimizer-state mirrors of the params as the params,
    blockwise pairs and everything else replicated — or, with
    ``zero=True``, the ZeRO layout above.  Leaves that are no tensor
    (the step count) get None."""
    mesh_axes = frozenset(mesh.axis_names)
    axes = _param_axes(state.params, params_axes)
    param_specs = [spec_for(a, rules, mesh_axes=mesh_axes) for a in axes]
    params_sh = tree_unflatten(state.params,
                               [Sharding(mesh, s) for s in param_specs])
    zaxes = zero_axes(mesh, rules) if zero else ()
    replicated = Sharding(mesh, PartitionSpec())

    def mirror(spec, leaf) -> Sharding:
        entries = list(spec) + [None] * (leaf.dim() - len(spec))
        used = {a for e in entries for a in axis_tuple(e)}
        free = tuple(a for a in zaxes if a not in used)
        if free:
            entries = _extend_spec(entries, tuple(leaf.shape), free, mesh)
        return Sharding(mesh, PartitionSpec(*entries))

    def rec(node):
        if _same_structure(node, state.params):
            leaves = tree_leaves(node)
            if all(torch.is_tensor(x) for x in leaves):
                return tree_unflatten(node, [mirror(s, x) for s, x in
                                             zip(param_specs, leaves)])
            if all(is_blockpair(x) for x in leaves):
                if not zero:
                    return tree_unflatten(node, [(replicated, replicated)
                                                 for _ in leaves])
                return tree_unflatten(node, [
                    (block_sharding(mesh, tuple(q.shape), rules),
                     block_sharding(mesh, tuple(s.shape), rules))
                    for q, s in leaves])
        if isinstance(node, dict):
            return {k: rec(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return replicated if torch.is_tensor(node) else None

    return TrainState(step=None, params=params_sh,
                      opt_state=rec(state.opt_state))


def _walk_pairs(tree: Any, shardings: Any):
    """(leaf, its Sharding or None) over an optimizer state."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk_pairs(tree[k], None if shardings is None
                                   else shardings[k])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk_pairs(v, None if shardings is None
                                   else shardings[i])
    elif torch.is_tensor(tree):
        yield tree, shardings


def opt_state_bytes(opt_state: Any, shardings: Any = None) -> Dict[str, int]:
    """Optimizer-state footprint from the calling rank's shards:
    ``per_device`` the bytes it holds, ``global`` the bytes of the whole
    state across the mesh (each shard's global shape from its layout in
    ``shardings``; without it, the state is taken as whole, and the two
    are equal).  Tensor leaves only: the step count is a host int."""
    g = per = 0
    for leaf, sh in _walk_pairs(opt_state, shardings):
        nbytes = leaf.numel() * leaf.element_size()
        per += nbytes
        g += (math.prod(sh.global_shape(tuple(leaf.shape)))
              * leaf.element_size() if sh is not None else nbytes)
    return {"global": g, "per_device": per}


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """The calling rank's shards of a full ``TrainState`` (a leaf that
    its layout does not split is kept as it is, not copied)."""
    def cut(x, sh):
        if sh is None or not torch.is_tensor(x) or sh.is_replicated:
            return x
        piece = x[sh.local_slices(tuple(x.shape))].detach().clone()
        return piece.requires_grad_(x.requires_grad)

    def walk(t, s):
        if isinstance(t, dict):
            return {k: walk(t[k], s[k]) for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(a, b) for a, b in zip(t, s))
        return cut(t, s)

    return TrainState(state.step, walk(state.params, shardings.params),
                      walk(state.opt_state, shardings.opt_state))


# --- the step's per-leaf layout ----------------------------------------------

def _coords_of(mesh: Mesh, rank: int) -> Dict[str, int]:
    import numpy as np

    where = np.argwhere(mesh.devices == rank)[0]
    return dict(zip(mesh.axis_names, map(int, where)))


class LeafLayout:
    """One param leaf: its full ``shape``, where it lives at rest
    (``rest``) and which part each data member updates (``update``, the
    layout of its moments; ``blocks`` when they are optim8's block pairs,
    whose block b covers flat elements [256 b, 256 b + 256)).  A region
    is a tuple of slices of the full leaf, or a flat element range."""

    def __init__(self, shape: Tuple[int, ...], rest: Sharding,
                 update: Sharding, blocks: bool, members: Sequence[int]):
        self.shape = shape
        self.numel = math.prod(shape)
        self.rest = rest
        self.update = update
        self.blocks = blocks
        mesh = rest.mesh
        self.member_coords = [_coords_of(mesh, r) for r in members]
        self.n = len(members)
        self.me = list(members).index(mesh.rank)
        self.rest_split = not rest.is_replicated
        self.update_split = not update.is_replicated
        self.nb = -(-self.numel // BLOCK)
        self._rest = [rest.slices_at(shape, c) for c in self.member_coords]
        if blocks:
            self._upd = [update.slices_at((self.nb, BLOCK), c)[0]
                         for c in self.member_coords]
        else:
            self._upd = [update.slices_at(shape, c)
                         for c in self.member_coords]
        # Replicas of a region (members that differ only on the data
        # axes the update does not split) count it once in the norm.
        used = {a for e in update.spec for a in axis_tuple(e)}
        self.owner = all(mesh.coords[a] == 0 for a in DATA_AXES
                         if a in mesh.shape and a not in used)
        self.same_regions = (not blocks and update.axes(len(shape))
                             == rest.axes(len(shape)))

    # -- regions of the full leaf ------------------------------------------

    def rest_slices(self, j: Optional[int] = None) -> Tuple[slice, ...]:
        return self._rest[self.me if j is None else j]

    def update_view(self, full: torch.Tensor, j: Optional[int] = None
                    ) -> torch.Tensor:
        """Member j's (default: the caller's) update region of ``full``:
        a view (flat for block pairs)."""
        r = self._upd[self.me if j is None else j]
        if self.blocks:
            return full.view(-1)[r.start * BLOCK:
                                 min(r.stop * BLOCK, self.numel)]
        return full[r]

    def update_numel(self) -> int:
        """Elements of one update chunk (block pairs: whole blocks)."""
        r = self._upd[self.me]
        if self.blocks:
            return (r.stop - r.start) * BLOCK
        return math.prod(s.stop - s.start for s in r)

    def _ordered(self, regions, split) -> bool:
        """Member j holds chunk j of the leading (or flat) dim, nothing
        else is split: the chunks are the leaf's storage in order."""
        if self.blocks:
            return all(r == slice(j * self.nb // self.n,
                                  (j + 1) * self.nb // self.n)
                       for j, r in enumerate(regions)) and split == self.n
        rows = self.shape[0] if self.shape else 1
        return (bool(self.shape) and split == self.n and all(
            r[0] == slice(j * rows // self.n, (j + 1) * rows // self.n)
            and all(s == slice(0, n) for s, n in zip(r[1:], self.shape[1:]))
            for j, r in enumerate(regions)))

    # -- packing for one collective over the data members --------------------

    def pack_update(self, full: torch.Tensor) -> torch.Tensor:
        """``full`` as [n, chunk]: member j's update region in row j
        (block pairs: zero-padded to whole blocks).  A view when the
        regions are the storage in order."""
        m = self.update_numel()
        split = (self.update.splits(2)[0] if self.blocks else
                 self.update.splits(len(self.shape))[0]
                 if self.shape else 1)
        if self.blocks:
            flat = full.reshape(-1)
            pad = self.nb * BLOCK - self.numel
            if pad:
                flat = torch.nn.functional.pad(flat, (0, pad))
            blocks = flat.view(self.nb, BLOCK)
            if self._ordered(self._upd, split):
                return blocks.view(self.n, m)
            return torch.stack([blocks[r].reshape(-1) for r in self._upd])
        if self._ordered(self._upd, split):
            return full.reshape(self.n, m)
        return torch.stack([full[r].reshape(-1) for r in self._upd])

    def gather_into(self, full: torch.Tensor, chunks: torch.Tensor,
                    regions: str) -> None:
        """Write row j of ``chunks`` into member j's ``regions``
        ("update" or "rest") of ``full``."""
        for j in range(self.n):
            if regions == "rest":
                dst = full[self._rest[j]]
                dst.copy_(chunks[j].view(dst.shape))
            else:
                dst = self.update_view(full, j)
                dst.copy_(chunks[j][:dst.numel()].view(dst.shape))

    def rest_ordered(self) -> bool:
        split = self.rest.splits(len(self.shape))[0] if self.shape else 1
        return self._ordered(self._rest, split)


def _without_axis(sh: Sharding, axis: str, ndim: int) -> Sharding:
    """``sh`` with ``axis`` taken out of its spec: the layout, over the
    data members at one coordinate of ``axis``, of that coordinate's
    part of the leaf (``axis`` must be the major axis of its dim)."""
    entries = []
    for e in sh.axes(ndim):
        if axis in e:
            if e[0] != axis:
                raise NotImplementedError(
                    f"{sh.spec}: {axis!r} must be the major axis of its dim")
            e = e[1:]
        entries.append(None if not e else e[0] if len(e) == 1 else e)
    return Sharding(sh.mesh, PartitionSpec(*entries))


class StepLayout:
    """The layouts of every param leaf (in ``tree_leaves`` order) over
    the mesh's data members, and the data group they talk over.

    On a mesh with an ``ep`` axis the data members are those at the
    caller's ``ep`` coordinate: a leaf split over ``ep`` at rest (an
    expert leaf, the router) is laid out as that coordinate's part of it (``shape``,
    ``rest`` and ``update`` of its ``LeafLayout`` leave ``ep`` out), and
    its grads are that part's; a leaf replicated over ``ep`` has equal
    grads on every ``ep`` rank.  ``ep_split[i]`` says which leaves are
    split over ``ep``.  ``index`` is the caller's chunk of the batch rows
    and ``order`` each member's chunk in the data group's order (the
    "batch" rule's axes, row-major), or None when the rule does not split
    the rows one chunk a member."""

    def __init__(self, mesh: Mesh, leaves: List[LeafLayout], zero: bool,
                 ep_split: List[bool], num_params: int,
                 rules: Optional[Rules]):
        self.mesh = mesh
        self.leaves = leaves
        self.zero = zero
        axes = tuple(a for a in DATA_AXES if a in mesh.shape)
        self.data_axes = axes
        self.n = mesh.axis_size(axes)
        self.group = mesh.group(axes)
        self.ep_split = ep_split
        self.num_params = num_params
        self.ep = mesh.shape.get(EP_AXIS, 1)
        self.ep_index = mesh.coords.get(EP_AXIS, 0)
        self.ep_group = mesh.group(EP_AXIS) if self.ep > 1 else None
        self.order, self.index = self._row_order(rules)

    def _row_order(self, rules: Optional[Rules]):
        spec = spec_for(("batch",), rules,
                        mesh_axes=frozenset(self.mesh.axis_names))
        row_axes = [a for a in axis_tuple(spec[0] if len(spec) else None)
                    if self.mesh.shape[a] > 1]
        if not set(row_axes) <= set(self.data_axes) or \
                math.prod(self.mesh.shape[a] for a in row_axes) != self.n:
            return None, None

        def chunk(coords):
            idx = 0
            for a in row_axes:
                idx = idx * self.mesh.shape[a] + coords[a]
            return idx

        members = self.mesh.line_ranks(self.data_axes)
        order = tuple(chunk(_coords_of(self.mesh, r)) for r in members)
        return order, chunk(self.mesh.coords)

    @classmethod
    def build(cls, mesh: Mesh, state: TrainState, shardings: TrainState,
              zero: bool, rules: Optional[Rules] = None) -> "StepLayout":
        """From a rank's (sharded) state and its layout."""
        axes = tuple(a for a in DATA_AXES if a in mesh.shape)
        members = mesh.line_ranks(axes)
        other = [a for a in mesh.axis_names
                 if a not in axes and a != EP_AXIS]
        if any(mesh.shape[a] > 1 for a in other):
            raise NotImplementedError(
                f"the data-parallel step runs over the data axes and ep "
                f"only; mesh {mesh.shape}")
        ep = mesh.shape.get(EP_AXIS, 1)
        params = tree_leaves(state.params)
        rests = tree_leaves(shardings.params)
        opt = state.opt_state if isinstance(state.opt_state, dict) else {}
        opt_sh = shardings.opt_state if isinstance(shardings.opt_state,
                                                   dict) else {}
        mus = (tree_leaves(opt_sh["mu"]) if "mu" in opt_sh
               and _same_structure(opt["mu"], state.params) else None)
        out, split, total = [], [], 0
        for i, (p, rest) in enumerate(zip(params, rests)):
            shape = rest.global_shape(tuple(p.shape))
            total += math.prod(shape)
            dims = rest.axes(len(shape))
            on_ep = ep > 1 and any(EP_AXIS in d for d in dims)
            if mus is None:
                upd, blocks = Sharding(mesh, PartitionSpec()), False
            elif isinstance(mus[i], tuple):
                upd, blocks = mus[i][0], True
            else:
                upd, blocks = mus[i], False
            if on_ep:
                if blocks:
                    raise NotImplementedError(
                        "adamw8bit's block states cover a leaf's flat "
                        "elements whole, and an expert leaf is split over "
                        "ep: train ep-sharded experts with AdamW "
                        "(default_optimizer)")
                shape = tuple(n // ep if EP_AXIS in d else n
                              for n, d in zip(shape, dims))
                rest = _without_axis(rest, EP_AXIS, len(shape))
                upd = _without_axis(upd, EP_AXIS, len(shape))
            out.append(LeafLayout(shape, rest, upd, blocks, members))
            split.append(on_ep)
        return cls(mesh, out, zero, split, total, rules)
