"""Whole-batch losses over ranks against the JAX package on the CPU: ViT
(the ``"rows"`` split) and CLIP (the ``"global"`` split, its negatives
all-gathered) trained over dp=2 x fsdp=2, CLIP's explicit
``contrastive_loss(axis_name=...)``, and the collectives that carry
gradients (``ray_tpu_torch.parallel.collectives``), at ``VIT_TINY`` and
``CLIP_TINY`` in f32.

The port runs on a gloo process group of 4 spawned ranks (one launch for
the file, ``tests/torch_dist_cases.py``); the JAX package runs the same
computations on 4 CPU devices while the ranks run, each compiled once.
The trainers: a ``JaxTrainer`` on the same mesh from the same weights
and numpy batches; each step's loss to 2e-6 of its size and grad norm
to 1e-5, every rank's shard of the final params to 1e-6 plus 1e-4 of
their size.  The explicit form on a dp=4 mesh against JAX's under
``shard_map``: the loss to 1e-6 and the ranks' grads, summed (each rank
holds its share), against ``jax.grad`` of JAX's to 1e-6 plus 1e-4 of
their size.  The collectives on a dp=2 x fsdp=2 mesh against JAX's under
``shard_map`` with ``jax.grad``: inputs and cotangents are multiples of
1/4 below 2, so every sum is exact and outputs and grads agree bit for
bit.  ``gather_from`` has no JAX twin (a value gathered and then used
alike on every member is invariant in JAX's typing only under GSPMD),
so it is held to its definition on integers.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP

from ray_tpu.models import clip as jclip
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.parallel.mesh import shard_map_unchecked
from ray_tpu.train import JaxTrainer
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import ScalingConfig as JScalingConfig
from ray_tpu.train import default_optimizer as j_default_optimizer
from ray_tpu_torch import bridge
from ray_tpu_torch.train import backend

import torch_dist_cases as cases

JV_CFG = dataclasses.replace(jvit.VIT_TINY, dtype=jnp.float32)
JC_CFG = dataclasses.replace(
    jclip.CLIP_TINY,
    vision=dataclasses.replace(jclip.CLIP_TINY.vision, dtype=jnp.float32),
    text=dataclasses.replace(jclip.CLIP_TINY.text, dtype=jnp.float32))
WORLD = 4
LOSS_RTOL, GNORM_RTOL = 2e-6, 1e-5
PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
AXES = ("dp", "fsdp")


@pytest.fixture(scope="module")
def family_params():
    """The port's seeded inits as numpy, the trees both packages run;
    ViT's head made non-zero, so its first step trains the backbone."""
    import torch

    from ray_tpu_torch.models import clip as tclip
    from ray_tpu_torch.models import vit as tvit

    vit = bridge.params_to_numpy(tvit.init_params(
        torch.Generator().manual_seed(0), cases.V_CFG, device="cpu"))
    rng = np.random.default_rng(1)
    vit["head_w"] = (rng.normal(size=vit["head_w"].shape) * 0.05
                     ).astype(np.float32)
    clip = bridge.params_to_numpy(tclip.init_params(
        torch.Generator().manual_seed(1), cases.C_CFG, device="cpu"))
    return vit, clip


def _clip_rows():
    rng = np.random.default_rng(2)
    v = cases.C_CFG.vision
    images = rng.normal(size=(8, v.image_size, v.image_size, v.channels)
                        ).astype(np.float32)
    tokens = rng.integers(1, cases.C_CFG.text.vocab_size,
                          (8, cases.C_CFG.text.max_len)).astype(np.int32)
    return images, tokens


def _quarters(rng, shape):
    return (rng.integers(-7, 8, shape) / 4).astype(np.float32)


# name: (x's global shape, its spec, ct's global shape, its spec, the
# body, the outputs' spec); a rank's x and ct are its device's blocks.
def _coll_specs():
    ax = AXES
    return {
        "allgather_grad": ((16, 3), JP(ax), (64, 3), JP(ax),
                           lambda x: lax.all_gather(x, ax, tiled=True),
                           JP(ax)),
        "allgather_grad_axis1": ((16, 3), JP(ax), (16, 6), JP(ax),
                                 lambda x: lax.all_gather(
                                     x, "fsdp", axis=1, tiled=True), JP(ax)),
        "all_to_all_grad": ((32, 3), JP(ax), (8, 12), JP(ax),
                            lambda x: lax.all_to_all(x, ax, 0, 1,
                                                     tiled=True), JP(ax)),
        # x replicated over fsdp (one block a dp member), used whole.
        "copy_to": ((4, 3), JP("dp"), (8, 3), JP(ax), lambda x: x,
                    JP(ax)),
        # The sum is replicated; so is its cotangent.
        "reduce_from": ((16, 3), JP(ax), (4, 3), JP(), lambda x: lax.psum(
            x, ax), JP()),
    }


def _blocks(a, spec, mesh):
    """Each of the 4 devices' block of the global ``a`` under ``spec``."""
    out = []
    for d in range(WORLD):
        dp, fsdp = divmod(d, 2)
        entry = spec[0] if len(spec) else None
        if entry is None:
            out.append(a)
        elif entry == "dp":
            n = a.shape[0] // 2
            out.append(a[dp * n:(dp + 1) * n])
        else:
            n = a.shape[0] // 4
            out.append(a[d * n:(d + 1) * n])
    return np.stack(out)


def _coll_inputs():
    rng = np.random.default_rng(3)
    out, glob = {}, {}
    for name, (xs, xspec, cs, cspec, _, _) in _coll_specs().items():
        x, ct = _quarters(rng, xs), _quarters(rng, cs)
        glob[name] = (x, ct)
        out[name] = {"x": _blocks(x, xspec, None),
                     "ct": _blocks(ct, cspec, None)}
    return out, glob


def _jax_collectives(glob, devices):
    """Every collective's output and grad, in one jitted program."""
    mesh = JMesh(np.array(devices).reshape(2, 2), AXES)
    specs = _coll_specs()

    def one(name, x, ct):
        _, xspec, _, cspec, body, ospec = specs[name]
        whole = ospec == JP()

        def loss(x):
            return jax.shard_map(
                lambda x, c: (body(x) * c).sum() if whole
                else (body(x) * c).sum()[None], mesh=mesh,
                in_specs=(xspec, cspec),
                out_specs=JP() if whole else JP(AXES))(x, ct).sum()

        y = jax.shard_map(body, mesh=mesh, in_specs=xspec,
                          out_specs=ospec)(x)
        return y, jax.grad(loss)(x)

    got = jax.jit(lambda g: {name: one(name, *g[name]) for name in g})(
        {k: tuple(map(jnp.asarray, v)) for k, v in glob.items()})
    return {k: tuple(map(np.asarray, v)) for k, v in got.items()}


def _jax_fit(family, np_params, devices):
    if family == "vit":
        axes = jvit.logical_axes(JV_CFG)
        loss = lambda p, b: (jvit.loss_fn(  # noqa: E731
            p, b["images"], b["labels"], JV_CFG), {})
        batch_axes = {"images": ("batch", None, None, None),
                      "labels": ("batch",)}
    else:
        axes = jclip.logical_axes(JC_CFG)
        loss = lambda p, b: (jclip.contrastive_loss(  # noqa: E731
            p, b["images"], b["tokens"], JC_CFG), {})
        batch_axes = {"images": ("batch", None, None, None),
                      "tokens": ("batch", None)}
    jt = JaxTrainer(
        init_params=lambda r: jax.tree.map(jnp.asarray, np_params),
        loss_fn=loss, params_axes=axes, batch_axes=batch_axes,
        rules=cases.FAMILY_RULES,
        optimizer=j_default_optimizer(cases.LR, warmup_steps=cases.WARMUP),
        scaling_config=JScalingConfig(
            mesh_spec=JMeshSpec(**dict(cases.DP_FSDP2)), devices=devices),
        run_config=JRunConfig(report_every=1))
    res = jt.fit(cases.family_batches(family), num_steps=cases.STEPS)
    assert res.error is None, res.error
    return {"history": res.metrics_history,
            "params": jax.tree.map(np.asarray, jt.state.params)}


def _jax_contrastive(np_params, images, tokens, devices):
    mesh = JMesh(np.array(devices), ("dp",))
    sharded = shard_map_unchecked(
        lambda p, i, t: jclip.contrastive_loss(p, i, t, JC_CFG,
                                               axis_name="dp"),
        mesh=mesh, in_specs=(JP(), JP("dp"), JP("dp")), out_specs=JP())
    loss, grads = jax.jit(jax.value_and_grad(sharded))(
        jax.tree.map(jnp.asarray, np_params), jnp.asarray(images),
        jnp.asarray(tokens))
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.fixture(scope="module")
def runs(family_params, cpu_devices):
    vit, clip = family_params
    images, tokens = _clip_rows()
    coll_in, coll_glob = _coll_inputs()
    got = {}

    def port():
        try:
            got["ranks"] = backend.launch(
                cases.dp_losses_rank, WORLD, ["cpu"],
                args=(vit, clip, images, tokens, coll_in), timeout_s=240)
        except BaseException as e:  # reported below
            got["error"] = e

    t = threading.Thread(target=port)
    t.start()
    devices = cpu_devices[:WORLD]
    want = {"vit": _jax_fit("vit", vit, devices),
            "clip": _jax_fit("clip", clip, devices),
            "contrastive": _jax_contrastive(clip, images, tokens, devices),
            "collectives": _jax_collectives(coll_glob, devices)}
    t.join(timeout=270)
    assert not t.is_alive(), "the ranks did not finish"
    if "error" in got:
        raise got["error"]
    return got["ranks"], want


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_leaves(tree[k], f"{prefix}.{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("family", ["vit", "clip"])
def test_losses_and_grad_norms_match_jax(runs, family):
    ranks, want = runs
    w = want[family]["history"]
    for r, rank in enumerate(ranks):
        got = rank[family]["history"]
        assert len(got) == len(w) == cases.STEPS
        for key, rtol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL)):
            np.testing.assert_allclose([m[key] for m in got],
                                       [float(m[key]) for m in w], rtol=rtol,
                                       err_msg=f"rank {r} {key}")


@pytest.mark.parametrize("family", ["vit", "clip"])
def test_final_param_shards_match_jax(runs, family):
    ranks, want = runs
    full = _leaves(want[family]["params"])
    for r, rank in enumerate(ranks):
        got = _leaves(rank[family]["params"])
        assert sorted(got) == sorted(full)
        split = 0
        for key, shard in got.items():
            sl = tuple(slice(a, b) for a, b in rank[family]["slices"][key])
            split += shard.shape != full[key].shape
            np.testing.assert_allclose(shard, full[key][sl], atol=PARAM_ATOL,
                                       rtol=PARAM_RTOL,
                                       err_msg=f"{family} rank {r} {key}")
        assert split > 0  # fsdp splits params at rest


def test_contrastive_axis_name_matches_jax(runs):
    ranks, want = runs
    loss, grads = want["contrastive"]
    summed = {}
    for r, rank in enumerate(ranks):
        got = rank["contrastive"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-6,
                                   err_msg=f"rank {r}")
        for k, v in _leaves(got["grads"]).items():
            summed[k] = summed.get(k, 0) + v
    for k, w in _leaves(grads).items():
        np.testing.assert_allclose(summed[k], w, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("name", list(cases.GRAD_COLLECTIVES))
def test_collectives_with_grads_match_jax(runs, name):
    """Each rank's output and grad equal its device's block of JAX's."""
    ranks, want = runs
    y, g = want["collectives"][name]
    _, xspec, _, _, _, ospec = _coll_specs()[name]
    ys = _blocks(y, ospec, None)
    gs = _blocks(g, xspec, None)
    for r, rank in enumerate(ranks):
        got_y, got_g = rank["collectives"][name]
        np.testing.assert_array_equal(got_y, ys[r], err_msg=f"rank {r}")
        np.testing.assert_array_equal(got_g, gs[r], err_msg=f"rank {r}")


def test_gather_from_keeps_the_callers_part_of_the_cotangent(runs):
    """``gather_from`` (Mixtral's router over ep) on the dp=2 x fsdp=2
    mesh: each rank gets its fsdp line's parts in order, and the grad of
    its own part, its rows of the cotangent the line shares (no sum)."""
    ranks, _ = runs
    for r, rank in enumerate(ranks):
        y, g = rank["collectives"]["gather_from"]
        dp, f = divmod(r, 2)
        line = [10.0 * (2 * dp + j) + np.arange(3.0) for j in range(2)]
        ct = np.arange(6.0).reshape(2, 3) + 100.0 * dp
        np.testing.assert_array_equal(y, np.stack(line))
        np.testing.assert_array_equal(g, ct[f:f + 1])
