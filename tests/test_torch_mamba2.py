"""Port of Mamba-2 training against the JAX package on the CPU:
``MAMBA2_TINY`` and the hybrid ``JAMBA_TINY`` (an attention layer every
second layer) on bridged JAX weights — logits and loss in f32 and in
bf16, gradients with remat on and off against ``jax.grad``, the port's
``use_pallas_ssd`` route (K12's plain version forward, ``ssd_chunked``
backward) against the JAX einsum path, ``TorchTrainer.fit`` against
``JaxTrainer`` on one device, and the refusals.  Tokens come from a
seeded numpy generator; S = 32 (four chunks of 8)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mamba2 as jm
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.train import JaxTrainer
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import ScalingConfig as JScalingConfig
from ray_tpu.train import default_optimizer as j_default_optimizer
from ray_tpu_torch import bridge, train
from ray_tpu_torch.models import mamba2 as tm

NAMES = ("tiny", "jamba-tiny")
# f32 on both sides: XLA and ATen sum in other orders, and the chunk
# states run through a loop here and lax.associative_scan there.
LOGIT_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# bf16 matmuls and activations: both sides round to bf16 at the same
# points, but the f32 sums under each rounding run in other orders (and
# XLA rounds silu's sigmoid before the product, ATen after), so a value
# an ulp off moves on.  Measured: logits (|x| < 4.4) within 0.047, two
# bf16 ulps at 4 (2^-5 each); the loss within 3.7e-4 relative.
BF16_LOGIT_ATOL = 2 ** -4
BF16_LOSS_RTOL = 1e-3


def _cfgs(name, dtype="float32", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    return (dataclasses.replace(jm.CONFIGS[name], dtype=jd, **kw),
            dataclasses.replace(tm.CONFIGS[name], dtype=td, **kw))


@pytest.fixture(scope="module")
def np_params():
    init = jax.jit(jm.init_params, static_argnums=1)
    return {name: jax.tree.map(np.asarray, init(jax.random.PRNGKey(i),
                                                jm.CONFIGS[name]))
            for i, name in enumerate(NAMES)}


def _tokens(seed, B=2, S=32, V=256):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: x
                for k in sorted(tree) for p, x in _leaves(tree[k]).items()}
    return {"": tree}


def test_configs_params_and_axes_match_jax(np_params):
    for name in jm.CONFIGS:
        jc, tc = jm.CONFIGS[name], tm.CONFIGS[name]
        assert tc.num_params() == jc.num_params(), name
        assert tm.logical_axes(tc) == jm.logical_axes(jc), name
        assert tm._layer_kinds(tc) == jm._layer_kinds(jc), name
        assert (tc.d_inner, tc.head_dim) == (jc.d_inner, jc.head_dim)
    assert tm.MAMBA2_2_7B.num_params() == jm.MAMBA2_2_7B.num_params()
    for name in NAMES:
        tp = tm.init_params(torch.Generator().manual_seed(0),
                            tm.CONFIGS[name], device="cpu")
        want = {k: v.shape for k, v in _leaves(np_params[name]).items()}
        got = {k: tuple(v.shape) for k, v in _leaves(tp).items()}
        assert got == want, name
        a = -torch.exp(tp["mamba"]["a_log"])
        dt = torch.nn.functional.softplus(tp["mamba"]["dt_bias"])
        assert (a < -1 + 1e-6).all() and (a > -8).all()
        assert (dt > 1e-3 - 1e-7).all() and (dt < 1e-1 + 1e-7).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_jax(np_params, name, dtype):
    jc, tc = _cfgs(name, dtype)
    toks = _tokens(1)
    jp = jax.tree.map(jnp.asarray, np_params[name])
    want = np.asarray(jax.jit(lambda p, t: jm.forward(p, t, jc))(
        jp, jnp.asarray(toks)))
    want_loss = float(jax.jit(lambda p, t: jm.loss_fn(
        p, {"tokens": t}, jc)[0])(jp, jnp.asarray(toks)))
    tp = bridge.params_from_jax(np_params[name], device="cpu")
    atol, rtol = ((LOGIT_TOL, LOGIT_TOL) if dtype == "float32"
                  else (BF16_LOGIT_ATOL, 0))
    with torch.no_grad():
        for pallas in (False, True):
            c = dataclasses.replace(tc, use_pallas_ssd=pallas)
            got = tm.forward(tp, torch.from_numpy(toks), c)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, atol=atol,
                                       rtol=rtol,
                                       err_msg=f"use_pallas_ssd={pallas}")
            loss, aux = tm.loss_fn(tp, {"tokens": torch.from_numpy(toks)}, c)
            np.testing.assert_allclose(
                loss.item(), want_loss,
                rtol=LOGIT_TOL if dtype == "float32" else BF16_LOSS_RTOL)
            assert aux["ntokens"].item() == toks.size - toks.shape[0]


def _torch_grads(np_params, cfg, toks):
    tp = bridge.params_from_jax(np_params, device="cpu")
    state = train.create_train_state(tp, train.default_optimizer())
    loss, _ = tm.loss_fn(state.params, {"tokens": torch.from_numpy(toks)},
                         cfg)
    leaves = train.state.tree_leaves(state.params)
    grads = torch.autograd.grad(loss, leaves)
    return train.step._unflatten_like(state.params, grads)


@pytest.mark.parametrize("name", NAMES)
def test_grads_match_jax_with_remat_on_and_off(np_params, name):
    """remat (checkpointed SSM layers; the hybrid never rematerialises, as
    in the JAX package) and the K12 route give the einsum path's grads:
    recomputation repeats the same operations, so remat on and off agree
    exactly."""
    jc, tc = _cfgs(name)
    toks = _tokens(2)
    jp = jax.tree.map(jnp.asarray, np_params[name])
    want = _leaves(jax.jit(jax.grad(lambda p: jm.loss_fn(
        p, {"tokens": jnp.asarray(toks)}, jc)[0]))(jp))
    got = {}
    for remat in (False, True):
        for pallas in (False, True):
            c = dataclasses.replace(tc, remat=remat, use_pallas_ssd=pallas)
            got[(remat, pallas)] = _leaves(_torch_grads(np_params[name], c,
                                                        toks))
            for key, w in want.items():
                np.testing.assert_allclose(
                    got[(remat, pallas)][key].numpy(), np.asarray(w),
                    atol=GRAD_ATOL, rtol=GRAD_RTOL,
                    err_msg=f"remat={remat} pallas={pallas}: {key}")
    for pallas in (False, True):
        for key, g in got[(True, pallas)].items():
            assert torch.equal(g, got[(False, pallas)][key]), (pallas, key)


def _data(seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32)}


def test_fit_losses_match_jax_trainer(np_params):
    jc, tc = _cfgs("tiny", remat=True)
    jt = JaxTrainer(
        init_params=lambda r: jax.tree.map(jnp.asarray, np_params["tiny"]),
        loss_fn=lambda p, b: jm.loss_fn(p, b, jc),
        params_axes=jm.logical_axes(jc),
        batch_axes={"tokens": ("batch", None)},
        optimizer=j_default_optimizer(3e-3, warmup_steps=2),
        scaling_config=JScalingConfig(mesh_spec=JMeshSpec(dp=1),
                                      devices=jax.devices()[:1]),
        run_config=JRunConfig(report_every=1))
    want = jt.fit(_data(3), num_steps=4)
    tt = train.TorchTrainer(
        init_params=lambda g: bridge.params_from_jax(np_params["tiny"],
                                                     device="cpu"),
        loss_fn=lambda p, b: tm.loss_fn(
            p, b, dataclasses.replace(tc, use_pallas_ssd=True)),
        optimizer=train.default_optimizer(3e-3, warmup_steps=2),
        scaling_config=train.ScalingConfig(devices=["cpu"]),
        run_config=train.RunConfig(report_every=1))
    got = tt.fit(_data(3), num_steps=4)
    assert got.error is None and want.error is None
    assert [m["step"] for m in got.metrics_history] == [0, 1, 2, 3]
    np.testing.assert_allclose(
        [m["loss"] for m in got.metrics_history],
        [m["loss"] for m in want.metrics_history], rtol=1e-5)
    np.testing.assert_allclose(
        [m["grad_norm"] for m in got.metrics_history],
        [m["grad_norm"] for m in want.metrics_history], rtol=1e-4)


def test_refusals():
    tc = tm.MAMBA2_TINY
    tp = tm.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    toks = torch.zeros((1, 32), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="sequence_parallel"):
        tm.forward(tp, toks, dataclasses.replace(tc, sequence_parallel=True))
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tm.forward(tp, toks[:, :12], tc)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tm.forward(tp, toks[:, :12],
                   dataclasses.replace(tc, use_pallas_ssd=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init_params(torch.Generator(), tc)
