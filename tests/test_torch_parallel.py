"""The port's mesh, sharding rules and collectives (``ray_tpu_torch.
parallel``) against the JAX package on the CPU.

``MeshSpec.sizes``, ``spec_for`` and the hybrid rank grid are pure
arithmetic and must equal the JAX functions on the same inputs.  The
collectives run once, on a gloo process group of 4 spawned ranks laid
out as dp=2 x fsdp=2 (``tests/torch_dist_cases.py``), and each rank's
result is held against JAX's ``shard_map`` of the same collective over
4 CPU devices.  Inputs are numpy draws of multiples of 1/4 below 2 in
magnitude, so every f32 sum is exact in any order: sums, gathers,
scatters and permutes must agree bit for bit.  The quantized all-reduce
draws normals and is held within one int8 step of each member's scale:
the JAX quantiser runs under jit, where ``/ 127.0`` and ``/ scale`` may
become reciprocal products, and the port divides truly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from ray_tpu.parallel import collectives as JC
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import create_mesh as j_create_mesh
from ray_tpu.parallel.mesh import shard_map_unchecked
from ray_tpu.parallel.sharding import spec_for as j_spec_for
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel import sharding as tsh
from ray_tpu_torch.train import backend

import torch_dist_cases as cases

WORLD = 4
QUANT_CHUNK = 16


# --- pure layout arithmetic --------------------------------------------------

SPECS = [
    (dict(), 8), (dict(dp=2, tp=4), 8), (dict(dp=-1, fsdp=2), 8),
    (dict(dcn_dp=2, dp=-1, tp=4), 8), (dict(dcn_fsdp=2, fsdp=-1), 4),
    (dict(dp=1, fsdp=3), 6), (dict(dcn_dp=3), 8), (dict(dp=-1, tp=-1), 8),
    (dict(dcn_dp=0), 4), (dict(fsdp=2), 3), (dict(dp=1, tp=8, dcn_tp=2), 16),
]


@pytest.mark.parametrize("kw,n", SPECS)
def test_mesh_spec_sizes_match_jax(kw, n):
    try:
        want = JMeshSpec(**kw).sizes(n)
    except ValueError as e:
        with pytest.raises(ValueError):
            tmesh.MeshSpec(**kw).sizes(n)
        return
    assert tmesh.MeshSpec(**kw).sizes(n) == want
    assert tmesh.MeshSpec(**kw).hybrid == JMeshSpec(**kw).hybrid


FLAT = frozenset({"pp", "dp", "fsdp", "ep", "sp", "tp"})
HYBRID = FLAT | {"dcn_pp", "dcn_dp", "dcn_fsdp", "dcn_tp"}
LOGICAL = [("batch", None), ("vocab", "embed"), ("embed", "mlp"),
           ("layers", "embed", "heads", "head_dim"), ("zero",),
           ("batch", "seq", "embed_tp"), ("expert", "embed", "mlp"),
           ("embed", "embed")]


@pytest.mark.parametrize("mesh_axes", [None, FLAT, HYBRID,
                                       frozenset({"dp", "tp"})])
@pytest.mark.parametrize("rules", [None, {"embed": ("fsdp", "tp"),
                                          "mlp": None}])
def test_spec_for_matches_jax(mesh_axes, rules):
    for axes in LOGICAL:
        want = j_spec_for(axes, rules, mesh_axes=mesh_axes)
        got = tsh.spec_for(axes, rules, mesh_axes=mesh_axes)
        assert tuple(got) == tuple(want), axes
    with pytest.raises(KeyError):
        tsh.spec_for(("nope",))


@pytest.mark.parametrize("kw", [
    dict(dcn_dp=2, dp=-1), dict(dcn_dp=2, tp=4), dict(dp=-1, tp=2),
    dict(dcn_fsdp=2, dp=2, fsdp=-1), dict(dp=1, tp=2, dcn_tp=4)])
def test_rank_grid_matches_jax_device_grid(cpu_devices, kw):
    """Rank r sits where the JAX mesh puts the CPU device of id r; hybrid
    groups are contiguous chunks."""
    jm = j_create_mesh(JMeshSpec(**kw), devices=cpu_devices[:8])
    names, grid = tmesh.rank_grid(tmesh.MeshSpec(**kw), 8)
    assert names == tuple(jm.axis_names)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    np.testing.assert_array_equal(grid, ids - min(d.id for d in cpu_devices))
    m = tmesh.create_mesh(tmesh.MeshSpec(**kw), world_size=8, rank=5)
    assert m.shape == dict(jm.shape) and not m.distributed
    assert tmesh.data_axis_size(m) == np.prod(
        [jm.shape[a] for a in tmesh.DATA_AXES if a in jm.shape])


def test_sharding_slices_and_single_process_mesh():
    spec = tmesh.MeshSpec(dp=2, fsdp=2)
    shapes = {}
    for rank in range(4):
        m = tmesh.create_mesh(spec, world_size=4, rank=rank)
        sh = tsh.Sharding(m, tsh.PartitionSpec(("dp", "fsdp"), None))
        shapes[rank] = sh.local_slices((8, 3))
        assert sh.shard_shape((8, 3)) == (2, 3)
        assert sh.global_shape((2, 3)) == (8, 3)
        assert tsh.Sharding(m, tsh.PartitionSpec(None, "fsdp")) \
            .local_slices((4, 6))[1] == slice(3 * m.coords["fsdp"],
                                              3 * m.coords["fsdp"] + 3)
    assert [s[0].start for s in shapes.values()] == [0, 2, 4, 6]
    with pytest.raises(ValueError, match="never pad"):
        tsh.Sharding(m, tsh.PartitionSpec("dp")).shard_shape((3,))
    one = tmesh.create_mesh(tmesh.MeshSpec(dp=1))
    assert one.size == 1 and not one.distributed and one.group("dp") is None
    assert tsh.replicated(one).is_replicated
    x = np.arange(6.0)
    assert tsh.local_shard(x, tsh.replicated(one)) is x
    with pytest.raises(ValueError, match="mesh's order"):
        one.axis_size(("fsdp", "dp"))
    assert tmesh.default_spec_for(1) == tmesh.MeshSpec(dp=1)
    assert tmesh.default_spec_for(8) == tmesh.MeshSpec(dp=1, fsdp=8)
    assert tmesh.detect_topology().chips >= 1
    with pytest.raises(ValueError, match="devices for 4 ranks"):
        backend.launch(print, 4, ["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="item 6"):
        backend.TorchDistributedBackend().on_start(None)


# --- collectives: 4 gloo ranks against shard_map over 4 CPU devices ----------

def _inputs():
    rng = np.random.default_rng(7)
    out = {n: (rng.integers(-8, 8, (WORLD, 8, 6)) / 4).astype(np.float32)
           for n in cases.COLLECTIVES}
    for n in ("quantized_allreduce", "dcn_allreduce"):
        out[n] = rng.standard_normal((WORLD, 8, 6)).astype(np.float32)
    return out


DP_FSDP = ("dp", "fsdp")
JAX_TWINS = {
    "allreduce_sum": lambda x: JC.allreduce(x, DP_FSDP),
    "allreduce_max_fsdp": lambda x: JC.allreduce(x, "fsdp", "max"),
    "allreduce_min_dp": lambda x: JC.allreduce(x, "dp", "min"),
    "allreduce_mean": lambda x: JC.allreduce(x, DP_FSDP, "mean"),
    "allgather_fsdp": lambda x: JC.allgather(x, "fsdp"),
    "allgather_axis1": lambda x: JC.allgather(x, DP_FSDP, tiled_axis=1),
    "reducescatter_fsdp": lambda x: JC.reducescatter(x, "fsdp"),
    "reducescatter_mean": lambda x: JC.reducescatter(x, DP_FSDP, op="mean"),
    "broadcast_dp": lambda x: JC.broadcast(x, "dp", 1),
    "all_to_all": lambda x: JC.all_to_all(x, DP_FSDP, split_axis=0,
                                          concat_axis=1),
    "permute": lambda x: JC.permute(x, DP_FSDP, [(0, 2), (2, 1), (1, 0)]),
    "shift_fsdp": lambda x: JC.shift(x, "fsdp"),
    "shift_back": lambda x: JC.shift(x, DP_FSDP, -1),
    "send_recv_dp": lambda x: JC.send_recv(x, "dp", 0, 1),
    "axis_index": lambda x: jnp.stack(
        [JC.axis_index(DP_FSDP), JC.axis_index("fsdp"),
         jnp.int32(JC.axis_size(DP_FSDP)), jnp.int32(JC.axis_size("dp"))]),
    "dcn_allreduce_exact": lambda x: JC.dcn_allreduce(x, "dp",
                                                      quantized=False),
    "quantized_allreduce": lambda x: JC.quantized_allreduce(
        x, DP_FSDP, chunk=QUANT_CHUNK),
    "dcn_allreduce": lambda x: JC.dcn_allreduce(x, "fsdp",
                                                chunk=QUANT_CHUNK),
    "group_allreduce": lambda x: JC.allreduce(x, "fsdp"),
}


@pytest.fixture(scope="module")
def collective_runs(cpu_devices):
    """{name: (port per-rank results, JAX per-device results)}; the port
    side is one launch of 4 gloo ranks."""
    inputs = _inputs()
    port = backend.launch(cases.collectives_rank, WORLD, ["cpu"],
                          args=(inputs,), timeout_s=240)
    mesh = j_create_mesh(JMeshSpec(dp=2, fsdp=2), devices=cpu_devices[:4])
    out = {}
    for name, fn in JAX_TWINS.items():
        mapped = jax.jit(shard_map_unchecked(
            lambda x, fn=fn: fn(x[0])[None], mesh=mesh,
            in_specs=JP(DP_FSDP), out_specs=JP(DP_FSDP)))
        want = np.asarray(mapped(jnp.asarray(inputs[name])))
        out[name] = ([p[name] for p in port], list(want), inputs[name])
    return out


@pytest.mark.parametrize("name", [n for n in cases.COLLECTIVES
                                  if "quantized" not in n
                                  and n != "dcn_allreduce"])
def test_collective_matches_shard_map(collective_runs, name):
    got, want, _ = collective_runs[name]
    for rank in range(WORLD):
        np.testing.assert_array_equal(got[rank], want[rank],
                                      err_msg=f"{name} rank {rank}")


@pytest.mark.parametrize("name", ["quantized_allreduce", "dcn_allreduce"])
def test_quantized_allreduce_matches_shard_map(collective_runs, name):
    """Within one int8 step of every member's chunk scale (the members'
    quantised values may each round one step apart), and within 4 % of
    the exact sum's range."""
    got, want, x = collective_runs[name]
    axis_members = 4 if name == "quantized_allreduce" else 2
    scale = np.abs(x).reshape(WORLD, -1).max() / 127
    for rank in range(WORLD):
        np.testing.assert_allclose(got[rank], want[rank], rtol=0,
                                   atol=axis_members * scale * 1.01,
                                   err_msg=f"{name} rank {rank}")
    exact = x[:axis_members].sum(0)  # rank 0's members: ranks 0..k-1
    np.testing.assert_allclose(got[0], exact, rtol=0,
                               atol=0.04 * np.abs(exact).max())


def test_wire_bytes_match_jax():
    from ray_tpu_torch.parallel import collectives as TC

    for n, k in ((1000, 4), (256, 2), (7, 1), (0, 8), (4096, 16)):
        for q in (False, True):
            assert TC.allreduce_wire_bytes(n, axis_size=k, quantized=q) == \
                JC.allreduce_wire_bytes(n, axis_size=k, quantized=q)
        assert TC.reducescatter_wire_bytes(n, axis_size=k) == \
            JC.reducescatter_wire_bytes(n, axis_size=k)
        assert TC.allgather_wire_bytes(n, axis_size=k, itemsize=2) == \
            JC.allgather_wire_bytes(n, axis_size=k, itemsize=2)
        assert TC.page_transfer_wire_bytes(n, 64, quantized=True) == \
            JC.page_transfer_wire_bytes(n, 64, quantized=True)
