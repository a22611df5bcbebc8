"""Collective communication over a mesh axis (port of
``ray_tpu/parallel/collectives.py``).

The JAX package's collectives are XLA ops over named mesh axes, traced
inside ``shard_map``.  Here each function acts on the calling rank's
tensor over one axis's process group (``Mesh.group``): every rank on the
axis calls it with its own tensor, as every device of a ``shard_map``
body does, and gets what that device would get.  NCCL carries them on
the card and gloo on the CPU (``train/backend.py``).  An axis of one
rank with no process group computes its result locally.

Two layers, as in the JAX package: functional ops (``allreduce``,
``allgather``, ...) that take the mesh as a keyword, and
``CollectiveGroup``, a mesh axis behind the reference's named-group API.

The functional ops carry no gradient.  Four more carry one, each as a
``torch.autograd.Function`` whose backward is the transpose JAX takes
through ``shard_map``: ``allgather_grad`` (backward: the reduce-scatter
of the cotangent), ``all_to_all_grad`` (backward: the reverse
exchange), and the pair that an expert- or tensor-parallel region needs
(Megatron's f and g): ``copy_to`` (identity forward, the cotangent
summed over the axis backward: a replicated value that each member uses
in part) and ``reduce_from`` (sum forward, identity backward: the
members' partial results made whole).  ``gather_from`` gathers a value
that every member then uses whole and alike, and hands each its part
of the (equal) cotangent.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import AxisName, Mesh

# torch 2.13 renamed the single-tensor collectives (the old names warn).
_all_gather_single = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_single = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "mean": dist.ReduceOp.SUM}


def _group(mesh: Mesh, axis: AxisName):
    """(process group or None, axis size, group ranks)."""
    return mesh.group(axis), mesh.axis_size(axis), mesh.line_ranks(axis)


def gather_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """All-gather ``x`` into ``out`` (``[n * x.numel()]`` elements in
    group-rank order); ``group`` None: a copy."""
    if group is None:
        out.view(-1).copy_(x.reshape(-1))
    else:
        # Flat on both sides: gloo wants the output [n * rows, ...] of
        # the input's rows.
        _all_gather_single(out.view(-1), x.contiguous().view(-1),
                           group=group)


def scatter_single(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Reduce-scatter (sum) ``x`` (n chunks in group-rank order) into
    ``out`` (one chunk); ``group`` None: a copy."""
    if group is None:
        out.view(-1).copy_(x.reshape(-1))
    else:
        _reduce_scatter_single(out.view(-1), x.contiguous().view(-1),
                               op=dist.ReduceOp.SUM, group=group)


def allreduce(x: torch.Tensor, axis: AxisName, op: str = "sum", *,
              mesh: Mesh) -> torch.Tensor:
    if op not in _OPS:
        raise ValueError(f"unsupported reduce op: {op!r}")
    group, n, _ = _group(mesh, axis)
    out = x.clone()
    if group is not None:
        dist.all_reduce(out, op=_OPS[op], group=group)
    if op == "mean":
        out = out / n
    return out


def allgather(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
              tiled_axis: int = 0) -> torch.Tensor:
    """Members' tensors concatenated along ``tiled_axis`` in axis
    order (``lax.all_gather(..., tiled=True)``)."""
    group, n, _ = _group(mesh, axis)
    xt = x.movedim(tiled_axis, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0], *xt.shape[1:]))
    gather_single(out, xt, group)
    return out.movedim(0, tiled_axis)


def reducescatter(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
                  scatter_axis: int = 0, op: str = "sum") -> torch.Tensor:
    """The sum over the axis, cut along ``scatter_axis`` into one chunk
    a member (``lax.psum_scatter(..., tiled=True)``)."""
    if op not in ("sum", "mean"):
        raise ValueError("reducescatter supports sum/mean")
    group, n, _ = _group(mesh, axis)
    xt = x.movedim(scatter_axis, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim of {xt.shape[0]} does not split into {n}")
    out = xt.new_empty((xt.shape[0] // n, *xt.shape[1:]))
    scatter_single(out, xt, group)
    if op == "mean":
        out = out / n
    return out.movedim(0, scatter_axis)


def broadcast(x: torch.Tensor, axis: AxisName, root: int = 0, *,
              mesh: Mesh) -> torch.Tensor:
    """Every member gets the value of the member at index ``root``."""
    group, _, ranks = _group(mesh, axis)
    out = x.clone()
    if group is not None:
        dist.broadcast(out, src=ranks[root], group=group)
    return out


def all_to_all(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """``x`` cut along ``split_axis`` into one chunk a member; chunk j
    goes to member j, and what arrives is concatenated along
    ``concat_axis`` in member order (``lax.all_to_all(..., tiled=True)``)."""
    group, n, _ = _group(mesh, axis)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim of {x.shape[split_axis]} does not split "
                         f"into {n}")
    send = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
    recv = torch.empty_like(send)
    if group is None:
        recv.copy_(send)
    else:
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_axis)


def permute(x: torch.Tensor, axis: AxisName, perm: Sequence[tuple], *,
            mesh: Mesh) -> torch.Tensor:
    """``lax.ppermute``: for each ``(src, dst)`` pair of axis indices,
    member dst receives member src's ``x``; a member no pair sends to
    gets zeros."""
    group, n, ranks = _group(mesh, axis)
    me = mesh.axis_index(axis)
    out = torch.zeros_like(x)
    xs = x.contiguous()
    ops = []
    for src, dst in perm:
        if not (0 <= src < n and 0 <= dst < n):
            raise ValueError(f"pair {(src, dst)} outside an axis of {n}")
        if src == me and dst == me:
            out.copy_(xs)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, xs, ranks[dst], group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, ranks[src], group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return out


def shift(x: torch.Tensor, axis: AxisName, offset: int = 1, *,
          mesh: Mesh) -> torch.Tensor:
    """Ring shift by ``offset`` (the ring-attention building block)."""
    n = mesh.axis_size(axis)
    return permute(x, axis, [(i, (i + offset) % n) for i in range(n)],
                   mesh=mesh)


def send_recv(x: torch.Tensor, axis: AxisName, src: int, dst: int, *,
              mesh: Mesh) -> torch.Tensor:
    """Point-to-point: dst receives src's x; everyone else receives
    zeros (the reference's send/recv in SPMD form)."""
    return permute(x, axis, [(src, dst)], mesh=mesh)


def axis_index(axis: AxisName, *, mesh: Mesh) -> int:
    return mesh.axis_index(axis)


# --- collectives that carry gradients ----------------------------------------

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, tiled_axis):
        ctx.args = (axis, mesh, tiled_axis)
        return allgather(x, axis, mesh=mesh, tiled_axis=tiled_axis)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, tiled_axis = ctx.args
        return (reducescatter(g, axis, mesh=mesh, scatter_axis=tiled_axis),
                None, None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh, split_axis, concat_axis):
        ctx.args = (axis, mesh, split_axis, concat_axis)
        return all_to_all(x, axis, mesh=mesh, split_axis=split_axis,
                          concat_axis=concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis, mesh, split_axis, concat_axis = ctx.args
        return (all_to_all(g, axis, mesh=mesh, split_axis=concat_axis,
                           concat_axis=split_axis), None, None, None, None)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        ctx.args = (axis, mesh)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        axis, mesh = ctx.args
        return allreduce(g, axis, mesh=mesh), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, mesh):
        return allreduce(x, axis, mesh=mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def allgather_grad(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
                   tiled_axis: int = 0) -> torch.Tensor:
    """``allgather`` whose backward reduce-scatters the cotangent: each
    member gets the sum of every member's gradient for its part, as
    ``lax.all_gather``'s transpose (``psum_scatter``) gives it."""
    return _AllGather.apply(x, axis, mesh, tiled_axis)


def all_to_all_grad(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
                    split_axis: int, concat_axis: int) -> torch.Tensor:
    """``all_to_all`` whose backward sends each cotangent chunk back to
    the member it came from (the exchange with the axes swapped)."""
    return _AllToAll.apply(x, axis, mesh, split_axis, concat_axis)


def copy_to(x: torch.Tensor, axis: AxisName, *, mesh: Mesh) -> torch.Tensor:
    """Identity forward; backward, the cotangent summed over the axis.
    For a value every member holds whole and uses in part (its share of
    the experts): the sum gives each member the value's whole gradient,
    as the transpose of JAX's implicit broadcast (``pvary``) does."""
    return _CopyTo.apply(x, axis, mesh)


def reduce_from(x: torch.Tensor, axis: AxisName, *,
                mesh: Mesh) -> torch.Tensor:
    """The sum over the axis forward; identity backward.  For partial
    results made whole (``psum`` of a value each member then holds
    replicated): each member's part takes the whole cotangent."""
    return _ReduceFrom.apply(x, axis, mesh)


def gather_from(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
                tiled_axis: int = 0) -> torch.Tensor:
    """``allgather`` whose backward keeps the caller's part of the
    cotangent (Megatron's gather-from-region).  For a value each member
    holds in part and every member then uses whole and alike, so that
    its cotangent is equal on every member (Mixtral's router over
    ``ep``): each part gets its gradient once."""
    i = axis_index(axis, mesh=mesh)
    parts = list(allgather(x.detach(), axis, mesh=mesh,
                           tiled_axis=tiled_axis).chunk(
        mesh.axis_size(axis), dim=tiled_axis))
    parts[i] = x
    return torch.cat(parts, dim=tiled_axis)


def axis_size(axis: AxisName, *, mesh: Mesh) -> int:
    return mesh.axis_size(axis)


# --- quantized DCN collectives ---------------------------------------------
#
# EQuARX-style int8 allreduce (PAPERS.md): each member quantizes its
# partial sum to int8 with one f32 absmax scale per ``chunk`` elements,
# the members exchange the int8 payload and the scales, and each
# dequantizes and sums locally.  Wire traffic drops from itemsize
# bytes/element to ~(1 + 4/chunk) bytes/element.

DEFAULT_QUANT_CHUNK = 256


def quantized_allreduce(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
                        chunk: int = DEFAULT_QUANT_CHUNK) -> torch.Tensor:
    """int8 sum-allreduce with per-chunk absmax scales, as the JAX
    package computes it: the payload flattened to f32 and zero-padded to
    a chunk multiple, scale = max(absmax / 127, 1e-8) (a true division:
    the divisor is a tensor), q = clip(round(x / scale)), an all-gather
    of q and the scales, then the dequantised members summed in member
    order."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    group, n, _ = _group(mesh, axis)
    shape, dtype = x.shape, x.dtype
    flat = x.float().reshape(-1)
    numel = flat.numel()
    pad = (-numel) % chunk
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    chunks = flat.reshape(-1, chunk)
    absmax = chunks.abs().amax(dim=1)
    scale = (absmax / torch.full((1,), 127.0, device=x.device)
             ).clamp_min(1e-8)
    q = torch.round(chunks / scale[:, None]).clamp_(-127, 127).to(
        torch.int8)
    qs = q.new_empty((n, *q.shape))
    ss = scale.new_empty((n, *scale.shape))
    gather_single(qs, q, group)
    gather_single(ss, scale, group)
    total = (qs.float() * ss[..., None]).sum(dim=0)
    out = total.reshape(-1)
    if pad:
        out = out[:numel]
    return out.reshape(shape).to(dtype)


def dcn_allreduce(x: torch.Tensor, axis: AxisName, *, mesh: Mesh,
                  quantized: bool = True,
                  chunk: int = DEFAULT_QUANT_CHUNK) -> torch.Tensor:
    """Sum-allreduce for a DCN mesh axis: int8-quantized by default,
    exact when ``quantized=False``."""
    if not quantized:
        return allreduce(x, axis, mesh=mesh)
    return quantized_allreduce(x, axis, mesh=mesh, chunk=chunk)


def allreduce_wire_bytes(n_elements: int, *, axis_size: int,
                         quantized: bool, itemsize: int = 4,
                         chunk: int = DEFAULT_QUANT_CHUNK) -> int:
    """Bytes one member puts on the link per allreduce of ``n_elements``
    (payload exchanged with the ``axis_size - 1`` peers; 0 for a size-1
    axis): the padded int8 payload plus one f32 scale a chunk when
    quantized, ``itemsize``-byte elements when exact.  Analytic, so every
    transport reports the same number."""
    if axis_size <= 1 or n_elements <= 0:
        return 0
    peers = axis_size - 1
    if not quantized:
        return n_elements * itemsize * peers
    n_chunks = -(-n_elements // chunk)
    return (n_chunks * chunk * 1 + n_chunks * 4) * peers


def reducescatter_wire_bytes(n_elements: int, *, axis_size: int,
                             itemsize: int = 4) -> int:
    """Bytes one member puts on the link per reduce-scatter of
    ``n_elements``: it sends its k-1 foreign shards of n/k elements."""
    if axis_size <= 1 or n_elements <= 0:
        return 0
    return (n_elements // axis_size) * itemsize * (axis_size - 1)


def allgather_wire_bytes(n_elements: int, *, axis_size: int,
                         itemsize: int = 4) -> int:
    """Bytes one member puts on the link per all-gather producing
    ``n_elements``: it sends its n/k shard to the k-1 peers."""
    return reducescatter_wire_bytes(n_elements, axis_size=axis_size,
                                    itemsize=itemsize)


def page_transfer_wire_bytes(n_pages: int, elements_per_page: int, *,
                             quantized: bool, itemsize: int = 4,
                             scales_per_page: int = 1) -> int:
    """Bytes a KV page migration puts on the wire for one pool tensor:
    1 int8 byte an element plus one f32 scale a (page, scale column)
    when quantized, the storage bytes when exact."""
    if n_pages <= 0:
        return 0
    if quantized:
        return n_pages * (elements_per_page * 1 + scales_per_page * 4)
    return n_pages * elements_per_page * itemsize


class CollectiveGroup:
    """Named-group API surface (the reference's init_collective_group):
    a group is a mesh axis, and its methods are the functions above over
    it.  The JAX package's ``run`` (a ``shard_map`` wrapper) has no
    counterpart: port code already runs per rank."""

    def __init__(self, mesh: Mesh, axis: str):
        if axis not in mesh.axis_names:
            raise ValueError(f"axis {axis!r} not in mesh {mesh.axis_names}")
        self.mesh = mesh
        self.axis = axis

    @property
    def world_size(self) -> int:
        return self.mesh.shape[self.axis]

    def allreduce(self, x, op: str = "sum"):
        return allreduce(x, self.axis, op, mesh=self.mesh)

    def allgather(self, x, tiled_axis: int = 0):
        return allgather(x, self.axis, mesh=self.mesh, tiled_axis=tiled_axis)

    def reducescatter(self, x, scatter_axis: int = 0, op: str = "sum"):
        return reducescatter(x, self.axis, mesh=self.mesh,
                             scatter_axis=scatter_axis, op=op)

    def broadcast(self, x, root: int = 0):
        return broadcast(x, self.axis, root, mesh=self.mesh)

    def all_to_all(self, x, split_axis: int, concat_axis: int):
        return all_to_all(x, self.axis, mesh=self.mesh,
                          split_axis=split_axis, concat_axis=concat_axis)

    def shift(self, x, offset: int = 1):
        return shift(x, self.axis, offset, mesh=self.mesh)


_NAMED_GROUPS: dict = {}


def init_collective_group(mesh: Mesh, axis: str, group_name: str = "default"
                          ) -> CollectiveGroup:
    """Register a named group (the reference's collective.py:120)."""
    group = CollectiveGroup(mesh, axis)
    _NAMED_GROUPS[group_name] = group
    return group


def get_group(group_name: str = "default") -> CollectiveGroup:
    return _NAMED_GROUPS[group_name]


def destroy_collective_group(group_name: str = "default") -> None:
    _NAMED_GROUPS.pop(group_name, None)
