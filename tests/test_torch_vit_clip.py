"""Port of ViT and CLIP against the JAX package on the CPU, on
``VIT_TINY`` and ``CLIP_TINY`` with bridged JAX weights: ``patchify``
exactly, ``layer_norm`` (population variance) and the tanh GELU,
``encode``/``forward`` with cls and gap pooling, ``loss_fn`` and its
gradients from a non-zero head (the initial zero head makes every
backbone gradient exactly 0, checked on the port), CLIP's embeddings,
``contrastive_loss`` and its gradients (``logit_scale``, a 0-d leaf,
included), the bridge on both trees, and ``axis_name`` over a world of one
rank (the multi-rank form: tests/test_torch_dp_losses.py).
Weights are the port's seeded init carried to JAX through the bridge;
inputs come from a seeded numpy generator; each JAX program is jitted
once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import clip as jclip
from ray_tpu.models import vit as jvit
from ray_tpu_torch import bridge
from ray_tpu_torch.models import clip as tclip
from ray_tpu_torch.models import vit as tvit

# f32 on both sides: XLA and ATen sum in other orders.
F32_TOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# bf16 products (the JAX defaults): the sums under each rounding run in
# other orders; measured features within 0.016 (two ulps at 1).
BF16_ATOL = 2 ** -5


def _images(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, cfg.image_size, cfg.image_size,
                            cfg.channels)).astype(np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: x
                for k in sorted(tree) for p, x in _leaves(tree[k]).items()}
    return {"": tree}


def _f32(jcfg, tcfg):
    return (dataclasses.replace(jcfg, dtype=jnp.float32),
            dataclasses.replace(tcfg, dtype=torch.float32))


def _port_tree(init, cfg, seed):
    """The port's seeded init as numpy, the tree both packages run."""
    return bridge.params_to_numpy(
        init(torch.Generator().manual_seed(seed), cfg, device="cpu"))


@pytest.fixture(scope="module")
def vit_params():
    return {pool: _port_tree(tvit.init_params, dataclasses.replace(
        tvit.VIT_TINY, pooling=pool), i)
        for i, pool in enumerate(("cls", "gap"))}


@pytest.fixture(scope="module")
def clip_params():
    return _port_tree(tclip.init_params, tclip.CLIP_TINY, 3)


def test_configs_axes_and_bridge(vit_params, clip_params):
    for name in jvit.CONFIGS:
        jc, tc = jvit.CONFIGS[name], tvit.CONFIGS[name]
        assert tc.num_params() == jc.num_params(), name
        assert (tc.seq_len, tc.patch_dim, tc.head_dim) == \
            (jc.seq_len, jc.patch_dim, jc.head_dim)
        assert tvit.logical_axes(tc) == jvit.logical_axes(jc)
    assert tvit.VIT_L16.num_params() == jvit.VIT_L16.num_params()
    for name in jclip.CONFIGS:
        jc, tc = jclip.CONFIGS[name], tclip.CONFIGS[name]
        assert tclip.logical_axes(tc) == jclip.logical_axes(jc)
        assert tc.vision.num_params() == jc.vision.num_params()
    key = jax.random.PRNGKey(0)
    for tree, jshapes in (
            (vit_params["cls"], jax.eval_shape(
                lambda k: jvit.init_params(k, jvit.VIT_TINY), key)),
            (vit_params["gap"], jax.eval_shape(
                lambda k: jvit.init_params(k, dataclasses.replace(
                    jvit.VIT_TINY, pooling="gap")), key)),
            (clip_params, jax.eval_shape(
                lambda k: jclip.init_params(k, jclip.CLIP_TINY), key))):
        want = {k: (v.shape, v.dtype) for k, v in _leaves(jshapes).items()}
        assert {k: (v.shape, v.dtype) for k, v in _leaves(tree).items()} \
            == want
        back = _leaves(bridge.params_to_numpy(
            bridge.params_from_jax(tree, device="cpu")))
        for k, v in _leaves(tree).items():
            assert back[k].shape == v.shape and np.array_equal(back[k], v), k
    # CLIP's logit scale is a 0-d leaf and stays one.
    tp = bridge.params_from_jax(clip_params, device="cpu")
    assert tp["logit_scale"].shape == ()
    # Truncated normal draws stay inside [-2, 2] x fan_in^-0.5, with the
    # truncated standard normal's spread (0.8796).
    w = tvit.trunc_normal(torch.Generator().manual_seed(1), (1024, 1024),
                          1024, torch.device("cpu"), torch.float32)
    assert w.abs().max().item() <= 2 * 1024 ** -0.5
    assert abs(w.std().item() * 1024 ** 0.5 - 0.8796) < 0.005


def test_patchify_layer_norm_and_gelu_match_jax():
    cfg = tvit.VIT_TINY
    imgs = _images(cfg, n=3)
    got = tvit.patchify(torch.from_numpy(imgs), cfg).numpy()
    want = np.asarray(jvit.patchify(jnp.asarray(imgs), jvit.VIT_TINY))
    assert got.shape == (3, cfg.n_patches, cfg.patch_dim)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(4, 64)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=(64,)).astype(np.float32)
    bias = rng.normal(size=(64,)).astype(np.float32)
    want = np.asarray(jax.jit(lambda a, s, b: jvit.layer_norm(
        a, s, b, 1e-6))(x, scale, bias))
    got = tvit.layer_norm(*(torch.from_numpy(a) for a in (x, scale, bias)),
                          1e-6).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    want = np.asarray(jax.jit(jax.nn.gelu)(x))
    np.testing.assert_allclose(
        F.gelu(torch.from_numpy(x), approximate="tanh").numpy(), want,
        atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_vit_encode_and_forward_match_jax(vit_params, pool, dtype):
    jc = dataclasses.replace(jvit.VIT_TINY, pooling=pool)
    tc = dataclasses.replace(tvit.VIT_TINY, pooling=pool)
    if dtype == "float32":
        jc, tc = _f32(jc, tc)
    imgs = _images(tc, seed=2)
    jp = jax.tree.map(jnp.asarray, vit_params[pool])
    w_feats, w_logits = jax.jit(lambda p, x: (jvit.encode(p, x, jc),
                                              jvit.forward(p, x, jc)))(
        jp, jnp.asarray(imgs))
    tp = bridge.params_from_jax(vit_params[pool], device="cpu")
    with torch.no_grad():
        feats = tvit.encode(tp, torch.from_numpy(imgs), tc)
        logits = tvit.forward(tp, torch.from_numpy(imgs), tc)
    assert feats.dtype == tc.dtype and logits.dtype == torch.float32
    assert logits.shape == (2, 10)
    atol = F32_TOL if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(feats.float().numpy(),
                               np.asarray(w_feats, np.float32), atol=atol,
                               rtol=F32_TOL if dtype == "float32" else 0)
    # The head starts at zero in both packages.
    assert not logits.any() and not np.asarray(w_logits).any()


def _grads_torch(loss, params, *args):
    """(loss, {leaf: grad}) of ``loss`` at ``params`` (a nested dict of
    tensors), every leaf taking a gradient."""
    leaves = list(_leaves(params).items())
    ps = [v.clone().requires_grad_(True) for _, v in leaves]

    def tree(vals):
        out = {}
        for (key, _), v in zip(leaves, vals):
            node = out
            *path, last = key.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[last] = v
        return out

    out = loss(tree(ps), *args)
    # A leaf the loss never reads (CLIP's vision head at 0 classes) gets
    # zeros, as jax.grad gives it.
    gs = torch.autograd.grad(out, ps, allow_unused=True)
    return out.item(), {k: torch.zeros_like(p) if g is None else g
                        for (k, _), p, g in zip(leaves, ps, gs)}


def _check_grads(got, want):
    """Each leaf within GRAD_RTOL relative, or GRAD_ATOL plus GRAD_RTOL of
    its largest entry absolute (f32 sums in other orders: a small entry
    of a leaf carries its large entries' rounding)."""
    for key, w in _leaves(want).items():
        w = np.asarray(w)
        atol = GRAD_ATOL + GRAD_RTOL * np.abs(w).max(initial=0.0)
        np.testing.assert_allclose(got[key].numpy(), w, atol=atol,
                                   rtol=GRAD_RTOL, err_msg=key)


@pytest.mark.parametrize("pool", ["cls", "gap"])
def test_vit_loss_and_grads_match_jax(vit_params, pool):
    """From the initial zero head every backbone grad is exactly 0 (only
    the head learns on a first step); from a non-zero head every leaf's
    grad matches ``jax.grad``."""
    jc, tc = _f32(dataclasses.replace(jvit.VIT_TINY, pooling=pool),
                  dataclasses.replace(tvit.VIT_TINY, pooling=pool,
                                      remat=True))
    imgs = _images(tc, n=4, seed=3)
    labels = np.array([0, 1, 2, 3], np.int32)
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)

    def loss(p, a, b):
        return tvit.loss_fn(p, a, b, tc)

    l0, g0 = _grads_torch(loss, bridge.params_from_jax(vit_params[pool],
                                                       device="cpu"), x, y)
    assert l0 == pytest.approx(np.log(10), rel=1e-6)
    for key, g in g0.items():
        assert g.any() == key.startswith("head_"), key
    tree = dict(vit_params[pool])
    rng = np.random.default_rng(5)
    tree["head_w"] = rng.normal(size=tree["head_w"].shape).astype(
        np.float32) * 0.1
    tree["head_b"] = rng.normal(size=tree["head_b"].shape).astype(
        np.float32) * 0.1
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p, a, b: jvit.loss_fn(p, a, b, jc)))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs),
        jnp.asarray(labels))
    l1, g1 = _grads_torch(loss, bridge.params_from_jax(tree, device="cpu"),
                          x, y)
    np.testing.assert_allclose(l1, float(wl), rtol=1e-5)
    _check_grads(g1, wg)
    assert all(g1[k].any() for k in g1 if k.startswith("layers."))


def _clip_inputs(cfg, n=3, seed=4):
    imgs = _images(cfg.vision, n=n, seed=seed)
    toks = np.random.default_rng(seed).integers(
        1, cfg.text.vocab_size, (n, cfg.text.max_len)).astype(np.int32)
    toks[0, 5] = toks[0, 9] = cfg.text.vocab_size - 1  # a repeated EOT id
    return imgs, toks


def test_clip_embeddings_loss_and_grads_match_jax(clip_params):
    jc = dataclasses.replace(
        jclip.CLIP_TINY,
        vision=dataclasses.replace(jclip.CLIP_TINY.vision, dtype=jnp.float32),
        text=dataclasses.replace(jclip.CLIP_TINY.text, dtype=jnp.float32))
    tc = dataclasses.replace(
        tclip.CLIP_TINY,
        vision=dataclasses.replace(tclip.CLIP_TINY.vision,
                                   dtype=torch.float32),
        text=dataclasses.replace(tclip.CLIP_TINY.text, dtype=torch.float32))
    imgs, toks = _clip_inputs(tc)
    jp = jax.tree.map(jnp.asarray, clip_params)
    w_img, w_txt, w_ti = jax.jit(lambda p, x, t: (
        *jclip.forward(p, x, t, jc), jclip.encode_text(p, t, jc)))(
        jp, jnp.asarray(imgs), jnp.asarray(toks))
    tp = bridge.params_from_jax(clip_params, device="cpu")
    x, t = torch.from_numpy(imgs), torch.from_numpy(toks)
    with torch.no_grad():
        img, txt = tclip.forward(tp, x, t, tc)
        ti = tclip.encode_text(tp, t, tc)
    for a, b in ((img, w_img), (txt, w_txt), (ti, w_ti)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_TOL,
                                   rtol=F32_TOL)
    np.testing.assert_allclose(torch.linalg.vector_norm(img, dim=-1).numpy(),
                               1.0, rtol=1e-5)
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p, a, b: jclip.contrastive_loss(p, a, b, jc)))(
        jp, jnp.asarray(imgs), jnp.asarray(toks))
    loss, g = _grads_torch(
        lambda p, a, b: tclip.contrastive_loss(p, a, b, tc), tp, x, t)
    np.testing.assert_allclose(loss, float(wl), rtol=1e-5)
    assert g["logit_scale"].shape == () and g["logit_scale"].item() != 0
    _check_grads(g, wg)


def test_clip_bf16_embeddings_match_jax(clip_params):
    imgs, toks = _clip_inputs(tclip.CLIP_TINY, seed=5)
    w_img, w_txt = jax.jit(lambda p, x, t: jclip.forward(
        p, x, t, jclip.CLIP_TINY))(jax.tree.map(jnp.asarray, clip_params),
                                   jnp.asarray(imgs), jnp.asarray(toks))
    tp = bridge.params_from_jax(clip_params, device="cpu")
    with torch.no_grad():
        img, txt = tclip.forward(tp, torch.from_numpy(imgs),
                                 torch.from_numpy(toks), tclip.CLIP_TINY)
    np.testing.assert_allclose(img.numpy(), np.asarray(w_img),
                               atol=BF16_ATOL, rtol=0)
    np.testing.assert_allclose(txt.numpy(), np.asarray(w_txt),
                               atol=BF16_ATOL, rtol=0)


def test_vit_and_clip_train_through_the_trainer(vit_params, clip_params):
    """``TorchTrainer`` with AdamW takes both trees on the CPU: CLIP's
    unread vision head gets zero grads and its 0-d ``logit_scale`` is
    updated as a whole leaf."""
    from ray_tpu_torch import train

    vc = tvit.VIT_TINY
    cc = tclip.CLIP_TINY
    imgs, toks = _clip_inputs(cc, n=4, seed=6)
    cases = (
        (vit_params["cls"], lambda p, b: (tvit.loss_fn(
            p, b["images"], b["labels"], vc), {}),
         {"images": imgs, "labels": np.arange(4, dtype=np.int32)}),
        (clip_params, lambda p, b: (tclip.contrastive_loss(
            p, b["images"], b["tokens"], cc), {}),
         {"images": imgs, "tokens": toks}))
    for tree, loss, batch in cases:
        tt = train.TorchTrainer(
            init_params=lambda g, t=tree: bridge.params_from_jax(
                t, device="cpu"),
            loss_fn=loss,
            optimizer=train.default_optimizer(1e-3, warmup_steps=1),
            scaling_config=train.ScalingConfig(devices=["cpu"]),
            run_config=train.RunConfig(report_every=1))
        res = tt.fit(iter([batch] * 3), num_steps=3)
        assert res.error is None, res.error
        losses = [m["loss"] for m in res.metrics_history]
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    scale = tt.state.params["logit_scale"]
    assert scale.shape == () and scale.item() != pytest.approx(
        float(clip_params["logit_scale"]), abs=1e-6)


def test_refusals(clip_params):
    tp = bridge.params_from_jax(clip_params, device="cpu")
    imgs, toks = _clip_inputs(tclip.CLIP_TINY, n=2)
    # Cross-device negatives are ported: without a process group the
    # explicit form runs over a world of one rank, the local loss.
    args = (tp, torch.from_numpy(imgs), torch.from_numpy(toks),
            tclip.CLIP_TINY)
    assert torch.equal(tclip.contrastive_loss(*args, axis_name="dp"),
                       tclip.contrastive_loss(*args))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tvit.init_params(torch.Generator(), tvit.VIT_TINY)
        with pytest.raises(RuntimeError, match="CUDA"):
            tclip.init_params(torch.Generator(), tclip.CLIP_TINY)
