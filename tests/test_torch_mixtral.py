"""Port of the Mixtral sparse-MoE transformer against the JAX package on
the CPU, on ``MIXTRAL_TINY`` with bridged JAX weights: the routing (the
top-k experts, buffer positions and the ``keep`` set exactly, with and
without drops), ``moe_block`` in both dispatch modes against JAX and
against a per-token oracle, ``forward`` logits and aux, ``loss_fn`` and
the gradients of one ``value_and_grad`` in f32 and in bf16, remat, a
short ``TorchTrainer.fit`` and the refusals.  Weights are the port's
seeded init carried to JAX through the bridge; inputs come from a seeded
numpy generator; each JAX function is jitted once per case."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import mixtral as jm
from ray_tpu_torch import bridge, train
from ray_tpu_torch.models import mixtral as tm
from ray_tpu_torch.ops.moe_a2a import moe_block_ep
from ray_tpu_torch.parallel import loss_split
from ray_tpu_torch.parallel.mesh import MeshSpec, create_mesh

# f32 on both sides: XLA and ATen sum the products in other orders.
F32_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# bf16 products and activations round at the same points in both
# packages (dispatch, combine, gates, expert FFN), but the f32 sums under
# each rounding run in other orders, so a value an ulp off moves on.
# Measured on MIXTRAL_TINY: logits (|x| < 3.8) within 0.043, under three
# bf16 ulps at 2 (2^-6 each); the loss within 2.4e-4 relative and the aux
# within 7e-5; every grad within 0.031 of its leaf's largest entry
# (``ln_mlp``, whose grad sums over every token and expert).
BF16_LOGIT_ATOL = 2 ** -4
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 5e-2


def _cfgs(dtype="float32", **kw):
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    return (dataclasses.replace(jm.MIXTRAL_TINY, dtype=jd, **kw),
            dataclasses.replace(tm.MIXTRAL_TINY, dtype=td, **kw))


@pytest.fixture(scope="module")
def np_params():
    """The port's seeded init as numpy: the tree both packages run."""
    return bridge.params_to_numpy(tm.init_params(
        torch.Generator().manual_seed(0), tm.MIXTRAL_TINY, device="cpu"))


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: x
                for k in sorted(tree) for p, x in _leaves(tree[k]).items()}
    return {"": tree}


def _moe0(np_params):
    return {k: v[0] for k, v in np_params["layers"]["moe"].items()}


def _x(seed, B=2, S=16, D=64):
    return np.random.default_rng(seed).normal(size=(B, S, D)).astype(
        np.float32)


def _tokens(seed, B=2, S=16):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def test_configs_params_and_bridge_match_jax(np_params):
    for name in jm.CONFIGS:
        jc, tc = jm.CONFIGS[name], tm.CONFIGS[name]
        assert tc.num_params() == jc.num_params(), name
        assert tc.active_params() == jc.active_params(), name
        assert tm.logical_axes(tc) == jm.logical_axes(jc), name
        for n in (32, 4096, 7):
            assert tm.capacity(tc, n) == jm.capacity(jc, n)
    # The card's cut: MIXTRAL_8X7B at 2 layers.
    two = dataclasses.replace(tm.MIXTRAL_8X7B, n_layers=2)
    assert two.num_params() == 3_164_688_384
    assert tm.capacity(two, 2 * 2048) == 1280
    jshapes = jax.eval_shape(lambda k: jm.init_params(k, jm.MIXTRAL_TINY),
                             jax.random.PRNGKey(0))
    want = {k: (v.shape, v.dtype) for k, v in _leaves(jshapes).items()}
    assert {k: (v.shape, v.dtype) for k, v in _leaves(np_params).items()} \
        == want
    # The bridge carries the tree exactly, and back.
    back = _leaves(bridge.params_to_numpy(
        bridge.params_from_jax(np_params, device="cpu")))
    for k, v in _leaves(np_params).items():
        assert back[k].shape == v.shape and np.array_equal(back[k], v), k


@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
def test_route_keeps_the_same_assignments_as_jax(np_params,
                                                 capacity_factor):
    """Top-k, buffer positions and the keep set equal the JAX routing
    exactly; at capacity factor 0.25 some assignments drop, and the same
    ones drop (earlier tokens win capacity)."""
    jc, tc = _cfgs(capacity_factor=capacity_factor)
    moe = _moe0(np_params)
    xf = _x(1).reshape(-1, 64)
    C = jm.capacity(jc, xf.shape[0])
    want = jax.jit(lambda x, m: jm._route(x, m, jc, C))(
        jnp.asarray(xf), jax.tree.map(jnp.asarray, moe))
    got = tm._route(torch.from_numpy(xf),
                    bridge.params_from_jax(moe, device="cpu"), tc, C)
    w_idx, w_gate, w_pos, w_keep, w_probs, w_oh = (np.asarray(a)
                                                   for a in want)
    idx, gate, pos, keep, probs, oh = (a.numpy() for a in got)
    np.testing.assert_array_equal(idx, w_idx)
    np.testing.assert_array_equal(pos, w_pos)
    np.testing.assert_array_equal(keep, w_keep)
    np.testing.assert_array_equal(oh, w_oh)
    np.testing.assert_allclose(gate, w_gate, atol=1e-6)
    np.testing.assert_allclose(probs, w_probs, atol=1e-6)
    dropped = int((keep == 0).sum())
    assert (dropped > 0) == (capacity_factor < 1), dropped


@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
@pytest.mark.parametrize("mode", ["dense", "scatter"])
def test_moe_block_matches_jax(np_params, mode, capacity_factor):
    jc, tc = _cfgs(capacity_factor=capacity_factor, dispatch_mode=mode)
    moe = _moe0(np_params)
    x = _x(2)
    want_y, want_aux = jax.jit(lambda x, m: jm.moe_block(x, m, jc))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, moe))
    y, aux = tm.moe_block(torch.from_numpy(x),
                          bridge.params_from_jax(moe, device="cpu"), tc)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=1e-6)


def _moe_oracle(x, moe, k):
    """Per-token loop (the JAX test's oracle): each token goes to its
    top-k experts with renormalised gates, no capacity limit, f32."""
    B, S, D = x.shape
    out = np.zeros((B, S, D), np.float32)
    for b in range(B):
        for s in range(S):
            t = x[b, s]
            logits = t @ moe["w_router"]
            probs = np.exp(logits - logits.max())
            probs /= probs.sum()
            top = np.argsort(-probs)[:k]
            gates = probs[top] / probs[top].sum()
            for e, g in zip(top, gates):
                gg = t @ moe["w_gate"][e]
                hidden = (gg / (1 + np.exp(-gg))) * (t @ moe["w_up"][e])
                out[b, s] += g * (hidden @ moe["w_down"][e])
    return out


@pytest.mark.parametrize("mode", ["dense", "scatter"])
def test_moe_block_matches_per_token_oracle(np_params, mode):
    _, tc = _cfgs(capacity_factor=8.0, dispatch_mode=mode)
    moe = _moe0(np_params)
    x = _x(3, S=8)
    y, aux = tm.moe_block(torch.from_numpy(x),
                          bridge.params_from_jax(moe, device="cpu"), tc)
    np.testing.assert_allclose(y.numpy(), _moe_oracle(x, moe, 2),
                               rtol=2e-4, atol=2e-4)
    assert aux.item() > 0


def test_dropped_assignments_read_a_clamped_row_with_gate_zero(np_params):
    """With drops, scatter equals dense in f32 (a dropped assignment adds
    nothing either way) and its gradient reaches no expert row through
    the clamped gather."""
    _, tc = _cfgs(capacity_factor=0.25)
    moe = bridge.params_from_jax(_moe0(np_params), device="cpu")
    x = torch.from_numpy(_x(4)).requires_grad_(True)
    outs = {}
    for mode in ("dense", "scatter"):
        c = dataclasses.replace(tc, dispatch_mode=mode)
        y, _ = tm.moe_block(x, moe, c)
        outs[mode] = (y.detach(), torch.autograd.grad(y.sum(), x)[0])
    torch.testing.assert_close(outs["scatter"][0], outs["dense"][0],
                               atol=F32_TOL, rtol=F32_TOL)
    torch.testing.assert_close(outs["scatter"][1], outs["dense"][1],
                               atol=F32_TOL, rtol=F32_TOL)
    # A token whose every assignment dropped gets exactly 0.
    xf = x.detach().reshape(-1, 64)
    C = tm.capacity(tc, xf.shape[0])
    _, _, _, keep, _, _ = tm._route(xf, moe, tc, C)
    gone = keep.reshape(-1, 2).sum(dim=1) == 0
    assert gone.any()
    assert (outs["scatter"][0].reshape(-1, 64)[gone] == 0).all()


def _loss_and_forward(jc, t):
    """JAX's ``loss_fn`` of the params, with the (logits, aux) of the
    ``forward`` it runs carried out beside its metrics: one program gives
    the forward, the loss and the grads (a second ``forward`` would
    double the compile)."""
    def f(q):
        seen = []
        forward = jm.forward

        def recorded(*args, **kw):
            seen.append(forward(*args, **kw))
            return seen[-1]

        jm.forward = recorded
        try:
            loss, metrics = jm.loss_fn(q, {"tokens": t}, jc)
        finally:
            jm.forward = forward
        return loss, (metrics, seen[0])

    return f


# (dtype, dispatch mode, capacity factor): the last f32 case drops.
GRAD_CASES = [("float32", "dense", 1.25), ("float32", "scatter", 0.5),
              ("bfloat16", "dense", 1.25), ("bfloat16", "scatter", 1.25)]


@pytest.mark.parametrize("dtype,mode,cf", GRAD_CASES)
def test_forward_loss_and_grads_match_jax(np_params, dtype, mode, cf):
    jc, tc = _cfgs(dtype, dispatch_mode=mode, capacity_factor=cf)
    toks = _tokens(5)
    jp = jax.tree.map(jnp.asarray, np_params)

    @jax.jit
    def ref(p, t):
        (loss, (metrics, (logits, aux))), grads = jax.value_and_grad(
            _loss_and_forward(jc, t), has_aux=True)(p)
        return logits, aux, loss, metrics, grads

    w_logits, w_aux, w_loss, w_metrics, w_grads = ref(jp, jnp.asarray(toks))
    tp = bridge.params_from_jax(np_params, device="cpu")
    state = train.create_train_state(tp, train.default_optimizer())
    t = torch.from_numpy(toks)
    with torch.no_grad():
        logits, aux = tm.forward(state.params, t, tc)
    loss, metrics = tm.loss_fn(state.params, {"tokens": t}, tc)
    leaves = train.state.tree_leaves(state.params)
    grads = _leaves(train.step._unflatten_like(
        state.params, torch.autograd.grad(loss, leaves)))
    assert logits.dtype == torch.float32 and logits.shape == (2, 16, 256)
    if dtype == "float32":
        np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits),
                                   atol=F32_TOL, rtol=F32_TOL)
        np.testing.assert_allclose(loss.item(), float(w_loss), rtol=1e-5)
        for key, w in _leaves(w_grads).items():
            np.testing.assert_allclose(grads[key].numpy(), np.asarray(w),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=key)
    else:
        np.testing.assert_allclose(logits.numpy(), np.asarray(w_logits),
                                   atol=BF16_LOGIT_ATOL, rtol=0)
        np.testing.assert_allclose(loss.item(), float(w_loss),
                                   rtol=BF16_LOSS_RTOL)
        for key, w in _leaves(w_grads).items():
            w = np.asarray(w, np.float32)
            scale = max(np.abs(w).max(), 1e-30)
            np.testing.assert_allclose(grads[key].numpy() / scale,
                                       w / scale, atol=BF16_GRAD_TOL,
                                       rtol=0, err_msg=key)
    np.testing.assert_allclose(aux.item(), float(w_aux),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    for key in ("ce_loss", "aux_loss"):
        np.testing.assert_allclose(metrics[key].item(),
                                   float(w_metrics[key]), rtol=1e-3)
    assert metrics["ntokens"].item() == toks.size - toks.shape[0]


def _grads(params, cfg, toks):
    state = train.create_train_state(params, train.default_optimizer())
    loss, _ = tm.loss_fn(state.params, {"tokens": toks}, cfg)
    return loss.detach(), torch.autograd.grad(
        loss, train.state.tree_leaves(state.params))


@pytest.mark.parametrize("mode", ["dense", "scatter"])
def test_remat_recomputes_the_same_grads(np_params, mode):
    """"dots" and "full" remat repeat the same operations: the loss and
    every gradient equal remat off bit for bit."""
    _, tc = _cfgs(dispatch_mode=mode, capacity_factor=0.5)
    tp = bridge.params_from_jax(np_params, device="cpu")
    toks = torch.from_numpy(_tokens(6))
    base = _grads(tp, tc, toks)
    for policy in ("dots", "full"):
        got = _grads(tp, dataclasses.replace(tc, remat=True,
                                             remat_policy=policy), toks)
        assert torch.equal(got[0], base[0]), policy
        for a, b in zip(got[1], base[1]):
            assert torch.equal(a, b), policy


def test_fit_on_the_cpu_lowers_the_loss(np_params):
    _, tc = _cfgs(remat=True)
    toks = _tokens(7)
    tt = train.TorchTrainer(
        init_params=lambda g: bridge.params_from_jax(np_params,
                                                     device="cpu"),
        loss_fn=lambda p, b: tm.loss_fn(p, b, tc),
        optimizer=train.default_optimizer(3e-3, warmup_steps=1),
        scaling_config=train.ScalingConfig(devices=["cpu"]),
        run_config=train.RunConfig(report_every=1))
    res = tt.fit(iter([{"tokens": toks}] * 4), num_steps=4)
    assert res.error is None
    losses = [m["loss"] for m in res.metrics_history]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(m["aux_loss"] > 0 for m in res.metrics_history)


def test_refusals():
    tc = tm.MIXTRAL_TINY
    tp = tm.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    toks = torch.zeros((1, 16), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="item 7"):
        tm.forward(tp, toks, dataclasses.replace(tc, sequence_parallel=True))
    with pytest.raises(ValueError, match="remat_policy"):
        tm.forward(tp, toks, dataclasses.replace(tc, remat_policy="none"))
    # Expert parallelism is ported (tests/test_torch_moe_ep.py): ep=2
    # asks for a process group of that size, and the op and the block
    # refuse experts that do not split over ep.
    with pytest.raises(NotImplementedError, match="process group") as e:
        train.ScalingConfig(mesh_spec=train.MeshSpec(ep=2),
                            devices=["cpu"]).device()
    assert "item" not in str(e.value)
    x = torch.zeros((2, 16, tc.dim))
    moe = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    mesh = create_mesh(MeshSpec(dp=1, ep=3), world_size=3, rank=0)
    with pytest.raises(ValueError, match="not divisible by ep=3"):
        moe_block_ep(x, moe, tc, mesh=mesh)
    mesh = create_mesh(MeshSpec(dp=1, ep=2), world_size=2, rank=0)
    with pytest.raises(ValueError, match="holds 4 experts"):
        moe_block_ep(x, moe, tc, mesh=mesh)
    group = loss_split.DataGroup(mesh, ("dp",), 1, 0, (0,), 2, 2, 0)
    with loss_split.publish(group), pytest.raises(ValueError,
                                                  match="2 of 4"):
        tm.moe_block(x, moe, tc)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init_params(torch.Generator(), tc)
