"""The port's 8-bit Adam (``train/optim8.py``) against the JAX package's
on the CPU: the block quantiser, three updates of ``adamw8bit`` from the
same params and grads, the bridge of the chain state both ways, a
``TorchTrainer`` run on LLAMA_TINY against the JAX run, and checkpoints
of int8 states.  The JAX quantiser runs under ``jit``, where ``/ 127.0``
and ``/ scale`` become products with the reciprocal; the port divides
truly, so a quantisation's scales are held to one float32 ulp and its
int8 values to one step.  The next update dequantises those states, so
after n updates the scales are held to n ulps (int8 values still to one
step)."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.train import optim8 as j8
from ray_tpu_torch import bridge, train
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.train import optim8 as t8

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
# Leaves of 185 (one block: nb < 16), 6,800 (27 blocks: not a multiple of
# 16) and 20,000 elements (79 blocks, the last one partial).
SHAPES = {"a": (37, 5), "b": {"w": (40, 170)}, "c": (20_000,)}


def _tree(fn, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(fn, v) for k, v in shapes.items()}
    return fn(shapes)


def _pairs(tree, prefix=""):
    """{path: leaf} of a nested dict whose leaves may be (q, scale)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_pairs(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _np(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x).astype(np.float32) if np.asarray(x).dtype == \
        ml_dtypes.bfloat16 else np.asarray(x)


def _assert_states_close(got, want, what, max_ulps=1):
    """int8 values within one step, scales within ``max_ulps`` float32
    ulps."""
    for m in ("mu", "nu"):
        g, w = _pairs(got[m]), _pairs(want[m])
        assert sorted(g) == sorted(w)
        for key in w:
            (gq, gs), (wq, ws) = map(_np, g[key]), map(_np, w[key])
            assert gq.dtype == np.int8 and gq.shape == wq.shape
            step = np.abs(gq.astype(np.int32) - wq.astype(np.int32)).max()
            assert step <= 1, f"{what} {m}.{key}: int8 {step} steps apart"
            ulps = np.abs(gs - ws) / np.spacing(np.maximum(np.abs(gs),
                                                           np.abs(ws)))
            assert ulps.max() <= max_ulps, f"{what} {m}.{key}: scales " \
                f"{ulps.max()} ulps apart"


def test_quantize_matches_jax():
    """A 300 x 7 leaf (2,100 elements: the last block padded); the
    quantiser's blocks and scales, and the round trip."""
    x = (np.random.default_rng(1).standard_normal((300, 7))
         * np.logspace(-3, 1, 7)).astype(np.float32)
    wq, ws = jax.jit(j8._quantize)(jnp.asarray(x))
    gq, gs = t8._quantize(torch.from_numpy(x))
    assert gq.shape == (9, t8.BLOCK) and gq.dtype == torch.int8
    assert gs.shape == (9, 1) and gs.dtype == torch.float32
    _assert_states_close({"mu": {"x": (gq, gs)}, "nu": {}},
                         {"mu": {"x": (wq, ws)}, "nu": {}}, "quantize")
    want = np.asarray(j8._dequantize((wq, ws), x.shape))
    got = t8._dequantize((gq, gs), x.shape).numpy()
    # One int8 step of a block is its scale.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=float(np.asarray(ws).max()) * 1.0001)
    np.testing.assert_allclose(got, x, rtol=0,
                               atol=float(np.asarray(ws).max()) * 0.5001)
    # 1 byte a parameter and a float32 scale a block.
    state = t8.scale_by_adam8bit().init({"x": torch.zeros(300, 7)})
    assert state["count"] == 0 and state["mu"]["x"][0].dtype == torch.int8


def test_scale_by_adam8bit_update_matches_jax():
    """The bare transform (optax's ``update(grads, state)``): two updates
    in float32, the updates to f32 rounding, the given state untouched."""
    rng = np.random.default_rng(5)
    grads = [_tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(2)]
    jtx, ttx = j8.scale_by_adam8bit(), t8.scale_by_adam8bit()
    jupd = jax.jit(lambda g, s: jtx.update(g, s))
    js = jtx.init(jax.tree.map(jnp.asarray, grads[0]))
    ts = ttx.init(bridge.params_from_jax(grads[0], "cpu"))
    for i, g in enumerate(grads):
        ju, js = jupd(jax.tree.map(jnp.asarray, g), js)
        before = [t.clone() for t in ts["mu"]["a"]]
        tu, ts_new = ttx.update(bridge.params_from_jax(g, "cpu"), ts)
        assert all(torch.equal(a, b) for a, b in zip(ts["mu"]["a"], before))
        ts = ts_new
        for key, w in _pairs(jax.tree.map(np.asarray, ju)).items():
            np.testing.assert_allclose(_pairs(tu)[key].numpy(), w,
                                       atol=1e-6, rtol=1e-5, err_msg=key)
        _assert_states_close(ts, bridge.opt_state_from_jax(
            jax.tree.map(np.asarray, (js,)), "cpu"), f"update {i + 1}",
            max_ulps=i + 1)


_CASES = {
    "f32": (np.float32, dict(learning_rate=1e-2, warmup_steps=1)),
    "bf16": (ml_dtypes.bfloat16, dict(learning_rate=1e-2, warmup_steps=1)),
    "no_clip_no_decay": (np.float32, dict(learning_rate=1e-2,
                                          warmup_steps=2, grad_clip=0.0,
                                          weight_decay=0.0)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_adamw8bit_matches_jax(case):
    """Three updates from the same params and grads (the second's grads
    large enough to clip): params to f32 rounding (one bf16 ulp for bf16
    params), int8 states within one step after every update, scales
    within one ulp after the first and one more after each later one."""
    dtype, kw = _CASES[case]
    rng = np.random.default_rng(2)
    params = _tree(lambda s: rng.standard_normal(s).astype(dtype))
    grads = [_tree(lambda s, c=c: (rng.standard_normal(s) * c).astype(dtype))
             for c in (0.01, 0.3, 0.02)]
    jtx, ttx = j8.adamw8bit(**kw), t8.adamw8bit(**kw)

    @jax.jit
    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s, optax.global_norm(g)

    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = bridge.params_from_jax(params, "cpu")
    ts = ttx.init(tp)
    for i, g in enumerate(grads):
        jp, js, jn = jstep(jp, js, jax.tree.map(jnp.asarray, g))
        ts, tn = ttx.update_(tp, bridge.params_from_jax(g, "cpu"), ts)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-2
                                   if dtype != np.float32 else 1e-6)
        want = bridge.opt_state_from_jax(jax.tree.map(np.asarray, js),
                                         "cpu")
        assert ts["count"] == want["count"] == i + 1
        _assert_states_close(ts, want, f"{case} update {i + 1}",
                             max_ulps=i + 1)
    atol, rtol = ((2 ** -14, 2 ** -7) if dtype != np.float32
                  else (1e-6, 1e-6))
    for key, w in _pairs(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(_np(_pairs(tp)[key]), _np(w), atol=atol,
                                   rtol=rtol, err_msg=f"{case} params {key}")


def test_bridge_round_trip_and_resume():
    """A JAX state after one update crosses into the port and back
    unchanged, and two more updates from it in both packages agree."""
    rng = np.random.default_rng(3)
    params = _tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [_tree(lambda s: (rng.standard_normal(s) * 0.05).astype(
        np.float32)) for _ in range(3)]
    jtx, ttx = j8.adamw8bit(1e-2, warmup_steps=1), t8.adamw8bit(
        1e-2, warmup_steps=1)

    @jax.jit
    def jstep(p, s, g):
        u, s = jtx.update(g, s, p)
        return optax.apply_updates(p, u), s

    jp, js = jstep(jax.tree.map(jnp.asarray, params),
                   jtx.init(jax.tree.map(jnp.asarray, params)),
                   jax.tree.map(jnp.asarray, grads[0]))
    host = jax.tree.map(np.asarray, js)
    ts = bridge.opt_state_from_jax(host, "cpu")
    back = bridge.opt_state_to_jax(ts, host)
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    for g in grads[1:]:
        jp, js = jstep(jp, js, jax.tree.map(jnp.asarray, g))
        ts, _ = ttx.update_(tp, bridge.params_from_jax(g, "cpu"), ts)
    _assert_states_close(
        ts, bridge.opt_state_from_jax(jax.tree.map(np.asarray, js), "cpu"),
        "resumed", max_ulps=3)
    for key, w in _pairs(jax.tree.map(np.asarray, jp)).items():
        np.testing.assert_allclose(_np(_pairs(tp)[key]), w, atol=1e-6,
                                   rtol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray, jax.jit(
        jl.init_params, static_argnums=1)(jax.random.PRNGKey(0), J_CFG))


def _tokens():
    return np.random.default_rng(4).integers(
        0, J_CFG.vocab_size, (2, 64)).astype(np.int32)


def _trainer(tp, **run):
    return train.TorchTrainer(
        init_params=lambda g: tp,
        loss_fn=lambda p, b: tl.loss_fn(p, b, T_CFG),
        optimizer=train.adamw8bit(1e-3, warmup_steps=1),
        scaling_config=train.ScalingConfig(devices=["cpu"]),
        run_config=train.RunConfig(report_every=1, **run))


def _fixed(tokens):
    while True:
        yield {"tokens": tokens}


def test_fit_follows_the_jax_adamw8bit_run(np_params):
    """tests/test_optim8.py's LLAMA_TINY run (adamw8bit(1e-3,
    warmup_steps=1), one fixed [2, 64] batch) in both packages: losses and
    grad norms per step agree, and the loss falls."""
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = bridge.params_from_jax(np_params, "cpu")
    tokens = _tokens()
    jtx = j8.adamw8bit(1e-3, warmup_steps=1)

    @jax.jit
    def jstep(params, state):
        (loss, _), grads = jax.value_and_grad(
            lambda p: jl.loss_fn(p, {"tokens": jnp.asarray(tokens)}, J_CFG),
            has_aux=True)(params)
        updates, state = jtx.update(grads, state, params)
        return (optax.apply_updates(params, updates), state, loss,
                optax.global_norm(grads))

    state, want = jtx.init(jp), []
    for _ in range(6):
        jp, state, loss, gn = jstep(jp, state)
        want.append((float(loss), float(gn)))
    res = _trainer(tp).fit(_fixed(tokens), num_steps=6)
    assert res.error is None
    got = [(m["loss"], m["grad_norm"]) for m in res.metrics_history]
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want],
                               rtol=1e-5)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want],
                               rtol=1e-4)
    assert got[-1][0] < got[0][0]


def test_checkpoint_restores_int8_states_in_place(np_params, tmp_path):
    """A checkpoint of int8 states restores into the state's own tensors
    (its device), and a resumed run equals a straight one; a pair of the
    wrong shape is refused."""
    host = np_params
    tokens = _tokens()
    full = _trainer(bridge.params_from_jax(host, "cpu")).fit(
        _fixed(tokens), num_steps=4)
    first = _trainer(bridge.params_from_jax(host, "cpu"),
                     storage_path=str(tmp_path), name="r")
    res = first.fit(_fixed(tokens), num_steps=2)
    resumed = _trainer(bridge.params_from_jax(host, "cpu"))
    like = resumed.state.opt_state["mu"]["layers"]["attn"]["wq"]
    assert resumed.restore(res.checkpoint_path) == 2
    got = resumed.state.opt_state["mu"]["layers"]["attn"]["wq"]
    assert isinstance(got, tuple) and all(a is b for a, b in zip(got, like))
    assert got[0].device == like[0].device and got[0].dtype == torch.int8
    want = first.state.opt_state["mu"]["layers"]["attn"]["wq"]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rest = resumed.fit(_fixed(tokens), num_steps=2)
    assert [m["loss"] for m in rest.metrics_history] == \
        [m["loss"] for m in full.metrics_history[2:]]
    bad = resumed.state.opt_state["nu"]["final_norm"]
    resumed.state.opt_state["nu"]["final_norm"] = (bad[0][:, :8], bad[1])
    with pytest.raises(ValueError, match="shape"):
        resumed.restore(res.checkpoint_path)


def test_shard_update_raises():
    with pytest.raises(NotImplementedError, match="ZeRO"):
        train.adamw8bit(1e-4, shard_update=True)
    with pytest.raises(NotImplementedError, match="ZeRO"):
        train.scale_by_adam8bit(shard_update=True)
    assert math.isclose(t8.adamw8bit(1e-4, warmup_steps=10).schedule(5),
                        5e-5, rel_tol=1e-6)
