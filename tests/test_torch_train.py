"""Port of the training path against the JAX package on ``LLAMA_TINY`` in
f32 on the CPU: the losses, the gradients of ``loss_fn`` under each
remat mode, the optimizer against optax, the step with gradient
accumulation, ``TorchTrainer.fit`` against ``JaxTrainer`` on a
one-device mesh, checkpoint resume, and the flash route (K9f, K10, K11
through their plain versions) against the JAX Pallas kernels in
interpret mode.  Weights come from the JAX init through the numpy
bridge; batches and gradients from seeded numpy generators."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.ops import attention as jattn
from ray_tpu.parallel import MeshSpec as JMeshSpec
from ray_tpu.train import JaxTrainer
from ray_tpu.train import RunConfig as JRunConfig
from ray_tpu.train import ScalingConfig as JScalingConfig
from ray_tpu.train import create_train_state as j_create_state
from ray_tpu.train import default_optimizer as j_default_optimizer
from ray_tpu.train import make_train_step as j_make_train_step
from ray_tpu_torch import bridge, train
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tfa

J_CFG = dataclasses.replace(jl.LLAMA_TINY, dtype=jnp.float32)
T_CFG = dataclasses.replace(tl.LLAMA_TINY, dtype=torch.float32)
V = J_CFG.vocab_size
# f32 on both sides; XLA and ATen sum in other orders (a few ulps of
# the O(1) losses, more of the small gradients relative to their size).
LOSS_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4


@pytest.fixture(scope="module")
def np_params():
    return jax.tree.map(np.asarray,
                        jl.init_params(jax.random.PRNGKey(0), J_CFG))


def _tparams(np_params):
    return bridge.params_from_jax(np_params, device="cpu")


def _tokens(seed, B=2, S=32):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _mask(seed, B=2, S=32):
    m = (np.random.default_rng(seed).random((B, S)) > 0.3).astype(np.int32)
    m[:, 0] = 1
    return m


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: x
                for k in sorted(tree) for p, x in _leaves(tree[k]).items()}
    return {"": tree}


def _close_trees(got, want, atol, rtol, what):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for key in want:
        g = got[key]
        g = g.detach().float().numpy() if torch.is_tensor(g) else g
        np.testing.assert_allclose(np.asarray(g, np.float32),
                                   np.asarray(want[key], np.float32),
                                   atol=atol, rtol=rtol,
                                   err_msg=f"{what}: {key}")


# --- losses -----------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_next_token_and_chunked_losses_match_jax(masked):
    rng = np.random.default_rng(1)
    B, S, Dm = 2, 32, 16
    toks = _tokens(2)
    mask = _mask(3) if masked else None
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = jl.next_token_loss(jnp.asarray(logits), jnp.asarray(toks), jm,
                              z_loss=1e-3)
    got = tl.next_token_loss(torch.from_numpy(logits), torch.from_numpy(toks),
                             tm, z_loss=1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LOSS_TOL)
    # Chunked: S - 1 = 31 rows in chunks of 8, so the last chunk is padded.
    x = rng.standard_normal((B, S, Dm)).astype(np.float32)
    head = rng.standard_normal((Dm, V)).astype(np.float32)
    want = jl.chunked_next_token_loss(jnp.asarray(x), jnp.asarray(head),
                                      jnp.asarray(toks), jm, chunk=8,
                                      z_loss=1e-3)
    got = tl.chunked_next_token_loss(torch.from_numpy(x),
                                     torch.from_numpy(head),
                                     torch.from_numpy(toks), tm, chunk=8,
                                     z_loss=1e-3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=LOSS_TOL)


@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_fn_matches_jax(np_params, loss_chunk):
    batch = {"tokens": _tokens(4), "loss_mask": _mask(5)}
    jc = dataclasses.replace(J_CFG, loss_chunk=loss_chunk)
    tc = dataclasses.replace(T_CFG, loss_chunk=loss_chunk)
    jp = jax.tree.map(jnp.asarray, np_params)
    want, want_aux = jl.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jc,
                                z_loss=1e-4)
    got, aux = tl.loss_fn(_tparams(np_params),
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          tc, z_loss=1e-4)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_TOL)
    assert aux["ntokens"].item() == float(want_aux["ntokens"])
    assert aux["loss"] is got


def test_num_params_and_remat_policy_check():
    for name in ("LLAMA3_8B", "LLAMA3_1B", "LLAMA_TINY"):
        assert getattr(tl, name).num_params() == getattr(jl, name).num_params()
    bad = dataclasses.replace(T_CFG, remat_policy="most")
    with pytest.raises(ValueError, match="remat_policy must be 'dots' or "
                                         "'full', got 'most'"):
        tl.forward_hidden({}, torch.zeros((1, 4), dtype=torch.int32), bad)


# --- gradients --------------------------------------------------------------

def _jax_grads(np_params, cfg, batch):
    jp = jax.tree.map(jnp.asarray, np_params)
    return jax.grad(lambda p: jl.loss_fn(p, batch, cfg)[0])(jp)


def _torch_grads(params, cfg, batch):
    state = train.create_train_state(params, train.default_optimizer())
    loss, _ = tl.loss_fn(state.params, batch, cfg)
    leaves = train.state.tree_leaves(state.params)
    grads = torch.autograd.grad(loss, leaves)
    return train.step._unflatten_like(state.params, grads)


def test_loss_grads_match_jax_under_every_remat_mode(np_params):
    toks = _tokens(6)
    want = _jax_grads(np_params, J_CFG, {"tokens": jnp.asarray(toks)})
    got = {}
    for remat, policy in ((False, "dots"), (True, "dots"), (True, "full")):
        cfg = dataclasses.replace(T_CFG, remat=remat, remat_policy=policy)
        got[(remat, policy)] = _torch_grads(
            _tparams(np_params), cfg, {"tokens": torch.from_numpy(toks)})
        _close_trees(got[(remat, policy)], want, GRAD_ATOL, GRAD_RTOL,
                     f"remat={remat} {policy}")
    # Recomputation repeats the same operations: the three agree exactly.
    base = _leaves(got[(False, "dots")])
    for mode, grads in got.items():
        for key, g in _leaves(grads).items():
            assert torch.equal(g, base[key]), (mode, key)


def test_flash_route_grads_match_jax_interpret_kernels(np_params,
                                                       monkeypatch):
    """S = 256 takes the flash route on both sides once the device checks
    are lifted: the JAX Pallas kernels (K9f forward, K10/K11 backward) in
    interpret mode, the port's autograd Function through the plain
    versions, under "dots" remat on both."""
    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    monkeypatch.setattr(tattn, "_on_card", lambda q: True)
    calls = []
    real = tfa.flash_backward

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfa, "flash_backward", spy)
    toks = _tokens(7, B=1, S=256)
    jc = dataclasses.replace(J_CFG, remat=True, remat_policy="dots")
    tc = dataclasses.replace(T_CFG, remat=True, remat_policy="dots")
    want = _jax_grads(np_params, jc, {"tokens": jnp.asarray(toks)})
    got = _torch_grads(_tparams(np_params), tc,
                       {"tokens": torch.from_numpy(toks)})
    assert len(calls) == T_CFG.n_layers  # one backward per layer
    _close_trees(got, want, GRAD_ATOL, GRAD_RTOL, "flash route")


# --- optimizer --------------------------------------------------------------

def _adam_state(jstate):
    """optax.chain(clip, adamw) state → its ScaleByAdamState."""
    return jstate[1][0]


@pytest.mark.parametrize("case", ["plain", "mu_bf16", "clipped", "cosine",
                                  "bf16_params"])
def test_default_optimizer_matches_optax(np_params, case):
    kw = dict(warmup_steps=2, weight_decay=0.1)
    if case == "mu_bf16":
        kw_j, kw_t = dict(kw, mu_dtype=jnp.bfloat16), dict(
            kw, mu_dtype=torch.bfloat16)
    elif case == "cosine":
        kw_j = kw_t = dict(kw, total_steps=5)
    else:
        kw_j = kw_t = kw
    # bf16 master params, grads and moments: optax takes the global norm
    # in bf16 and the port must too, so everything is bit for bit.
    bf16 = case == "bf16_params"
    base = (jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), np_params)
            if bf16 else np_params)
    # Grads of norm ~ 1.6: clipped at 1.0, not at 10.
    clip = 1.0 if case == "clipped" else 10.0
    jtx = j_default_optimizer(1e-2, grad_clip=clip, **kw_j)
    ttx = train.default_optimizer(1e-2, grad_clip=clip, **kw_t)
    jp = jax.tree.map(jnp.asarray, base)
    jstate = jtx.init(jp)
    tstate = train.create_train_state(_tparams(base), ttx)
    params, opt = tstate.params, tstate.opt_state
    rng = np.random.default_rng(8)
    # bf16: optax under jit, as the JAX step runs it (and one compile
    # instead of each bf16 op's own).
    update = jax.jit(jtx.update) if bf16 else jtx.update
    for step in range(6 if bf16 else 4):
        g = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.005).astype(
                np.float32).astype(a.dtype), base)
        updates, jstate = update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        opt, gnorm = ttx.update_(params, bridge.params_from_jax(g, "cpu"),
                                 opt)
        want_norm = optax.global_norm(jax.tree.map(jnp.asarray, g))
        if bf16:
            assert gnorm.dtype == torch.bfloat16
            assert gnorm.item() == float(want_norm)
        else:
            np.testing.assert_allclose(gnorm.item(), float(want_norm),
                                       rtol=1e-6)
        assert (gnorm.item() >= clip) == (case == "clipped")
        if step == 0:
            # The schedule starts at 0: the first update moves nothing.
            _close_trees(params, base, 0, 0, "step 0")
        tol = (0, 0) if bf16 else (1e-7, 1e-6)
        _close_trees(params, jax.tree.map(np.asarray, jp), *tol,
                     f"params after step {step}")
        got = bridge.opt_state_to_numpy(opt, bf16_dtype=ml_dtypes.bfloat16)
        want = _adam_state(jstate)
        assert got["count"] == int(want.count) == step + 1
        # bf16 moments beside f32 params: one bf16 ulp (2^-8) where an
        # f32 sum an ulp apart rounds to the other side.
        mu_rtol = 8e-3 if case == "mu_bf16" else 1e-5
        _close_trees(got["mu"], jax.tree.map(np.asarray, want.mu),
                     *((0, 0) if bf16 else (1e-9, mu_rtol)),
                     f"mu after step {step}")
        _close_trees(got["nu"], jax.tree.map(np.asarray, want.nu),
                     *((0, 0) if bf16 else (1e-12, 1e-5)),
                     f"nu after step {step}")
        if case == "mu_bf16":
            assert all(m.dtype == torch.bfloat16
                       for m in train.state.tree_leaves(opt["mu"]))


def test_update_in_slices_equals_whole_leaf(monkeypatch):
    """A leaf above ``_UPDATE_SLICE`` elements updates one slice of its
    leading axis at a time: the same bits as the whole leaf at once."""
    rng = np.random.default_rng(9)
    leaves = {"w": rng.standard_normal((6, 5, 4)).astype(np.float32),
              "b": rng.standard_normal((7,)).astype(np.float32)}
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.5)
                          .astype(np.float32), leaves) for _ in range(3)]
    out = []
    for limit in (1 << 24, 40):
        monkeypatch.setattr(train.state, "_UPDATE_SLICE", limit)
        tx = train.default_optimizer(1e-2, warmup_steps=1,
                                     mu_dtype=torch.bfloat16)
        st = train.create_train_state(bridge.params_from_jax(leaves, "cpu"),
                                      tx)
        opt = st.opt_state
        for g in grads:
            opt, _ = tx.update_(st.params, bridge.params_from_jax(g, "cpu"),
                                opt)
        out.append((st.params, opt))
    assert [len(train.state._slices(torch.zeros(6, 5, 4)))] == [3]
    for key in ("w", "b"):
        assert torch.equal(out[0][0][key], out[1][0][key]), key
        for m in ("mu", "nu"):
            assert torch.equal(out[0][1][m][key], out[1][1][m][key]), (m, key)


# --- step and trainer -------------------------------------------------------

def test_train_step_with_grad_accum_matches_jax(np_params):
    jtx = j_default_optimizer(1e-3, warmup_steps=1)
    ttx = train.default_optimizer(1e-3, warmup_steps=1)
    jstep = jax.jit(j_make_train_step(
        lambda p, b: jl.loss_fn(p, b, J_CFG), jtx, grad_accum=2))
    tstep = train.make_train_step(lambda p, b: tl.loss_fn(p, b, T_CFG), ttx,
                                  grad_accum=2)
    js = j_create_state(jax.tree.map(jnp.asarray, np_params), jtx)
    ts = train.create_train_state(_tparams(np_params), ttx)
    for i in range(2):
        toks = _tokens(10 + i, B=4)
        js, jm = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(toks)})
        assert tm["step"] == int(jm["step"]) == i
        for key in ("loss", "grad_norm", "ntokens"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-5, err_msg=key)
    assert ts.step == int(js.step) == 2
    _close_trees(ts.params, jax.tree.map(np.asarray, js.params), 1e-6, 1e-4,
                 "params after 2 steps")
    with pytest.raises(ValueError, match="grad_accum=2"):
        tstep(ts, {"tokens": torch.zeros((3, 32), dtype=torch.int32)})


def test_train_step_bf16_params_matches_jax(np_params):
    """bf16 master params (f32 compute): the step's grad_norm is taken in
    bf16 on both sides, and loss, grad_norm and params after two steps
    agree to one bf16 ulp: the f32 grads round to bf16 from sums taken in
    other orders.  One bf16 ulp is 2^-8 to 2^-7 of a value, and a param
    moves by about lr (1e-2), whose ulp is 2^-14, whatever its own size."""
    jc = dataclasses.replace(J_CFG, param_dtype=jnp.bfloat16)
    tc = dataclasses.replace(T_CFG, param_dtype=torch.bfloat16)
    base = jax.tree.map(lambda a: a.astype(ml_dtypes.bfloat16), np_params)
    jtx = j_default_optimizer(1e-2, warmup_steps=1)
    ttx = train.default_optimizer(1e-2, warmup_steps=1)
    jstep = jax.jit(j_make_train_step(lambda p, b: jl.loss_fn(p, b, jc), jtx))
    tstep = train.make_train_step(lambda p, b: tl.loss_fn(p, b, tc), ttx)
    js = j_create_state(jax.tree.map(jnp.asarray, base), jtx)
    ts = train.create_train_state(_tparams(base), ttx)
    for i in range(2):
        toks = _tokens(40 + i)
        js, jm = jstep(js, {"tokens": jnp.asarray(toks)})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(toks)})
        assert jm["grad_norm"].dtype == jnp.bfloat16
        assert tm["grad_norm"].dtype == torch.bfloat16
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=2 ** -7)
    _close_trees(ts.params, jax.tree.map(np.asarray, js.params), 2 ** -14,
                 2 ** -7, "bf16 params after 2 steps")


def _data(seed, B=4, S=32):
    rng = np.random.default_rng(seed)
    while True:
        yield {"tokens": rng.integers(0, V, (B, S)).astype(np.int32)}


def _torch_trainer(np_params, **run):
    return train.TorchTrainer(
        init_params=lambda g: _tparams(np_params),
        loss_fn=lambda p, b: tl.loss_fn(p, b, T_CFG),
        optimizer=train.default_optimizer(1e-3, warmup_steps=2),
        scaling_config=train.ScalingConfig(devices=["cpu"]),
        run_config=train.RunConfig(report_every=1, **run))


def test_fit_losses_match_jax_trainer(np_params):
    jt = JaxTrainer(
        init_params=lambda r: jax.tree.map(jnp.asarray, np_params),
        loss_fn=lambda p, b: jl.loss_fn(p, b, J_CFG),
        params_axes=jl.logical_axes(J_CFG),
        batch_axes={"tokens": ("batch", None)},
        optimizer=j_default_optimizer(1e-3, warmup_steps=2),
        scaling_config=JScalingConfig(mesh_spec=JMeshSpec(dp=1),
                                      devices=jax.devices()[:1]),
        run_config=JRunConfig(report_every=1))
    want = jt.fit(_data(20), num_steps=4)
    got = _torch_trainer(np_params).fit(_data(20), num_steps=4)
    assert got.error is None and want.error is None
    assert [m["step"] for m in got.metrics_history] == [0, 1, 2, 3]
    # Losses within f32 rounding of each other at every step (the first
    # two steps run on identical weights: the warmup's first lr is 0).
    np.testing.assert_allclose(
        [m["loss"] for m in got.metrics_history],
        [m["loss"] for m in want.metrics_history], rtol=1e-5)
    np.testing.assert_allclose(
        [m["grad_norm"] for m in got.metrics_history],
        [m["grad_norm"] for m in want.metrics_history], rtol=1e-4)


def test_checkpoint_resume_equals_straight_run(np_params, tmp_path):
    straight = _torch_trainer(np_params)
    full = straight.fit(_data(30), num_steps=4)
    data = _data(30)
    first = _torch_trainer(np_params, storage_path=str(tmp_path), name="r")
    res = first.fit(data, num_steps=2)
    assert res.checkpoint_path == f"{tmp_path}/r"
    assert train.CheckpointManager(res.checkpoint_path).latest_step() == 2
    resumed = _torch_trainer(np_params)
    assert resumed.restore(res.checkpoint_path) == 2
    assert resumed.state.opt_state["count"] == 2
    rest = resumed.fit(data, num_steps=2)
    assert [m["loss"] for m in rest.metrics_history] == \
        [m["loss"] for m in full.metrics_history[2:]]
    for key, t in _leaves(resumed.state.params).items():
        assert torch.equal(t, _leaves(straight.state.params)[key]), key


def test_checkpoint_manager_keeps_the_newest(np_params, tmp_path):
    tx = train.default_optimizer()
    state = train.create_train_state(_tparams(np_params), tx)
    mngr = train.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        mngr.save(step, state._replace(step=step))
    assert mngr._steps() == [2, 3] and mngr.latest_step() == 3
    restored = mngr.restore(state, step=2)
    assert restored.step == 2
    with pytest.raises(ValueError, match="shape"):
        other = train.create_train_state(
            _tparams(jax.tree.map(lambda a: a[..., :1], np_params)), tx)
        mngr.restore(other)


def test_trainer_runs_on_the_card_unless_asked(np_params):
    kw = dict(init_params=lambda g: _tparams(np_params),
              loss_fn=lambda p, b: tl.loss_fn(p, b, T_CFG))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train.TorchTrainer(**kw)
    with pytest.raises(NotImplementedError, match="more than one device"):
        train.TorchTrainer(**kw, scaling_config=train.ScalingConfig(
            mesh_spec=train.MeshSpec(fsdp=2), devices=["cpu"]))
    with pytest.raises(NotImplementedError, match="more than one device"):
        train.TorchTrainer(**kw, scaling_config=train.ScalingConfig(
            devices=["cpu", "cpu"]))
    t = train.TorchTrainer(**kw, scaling_config=train.ScalingConfig(
        devices=["cpu"]), trainer_config=train.TrainerConfig(
            zero_sharding=True))
    with pytest.raises(NotImplementedError, match="zero_sharding"):
        t.state
    assert t.device == torch.device("cpu")
