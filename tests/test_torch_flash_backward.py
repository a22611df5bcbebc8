"""Port of the flash backward (K10 dq, K11 dk/dv) against
ray_tpu.ops.flash_attention on the CPU: the JAX backward kernels run in
interpret mode, as tests/test_flash_attention.py runs them, and the
port's plain versions take the same inputs.  Then the port's autograd
Function (K9f + K10 + K11, here their plain versions) against
``jax.grad`` of the JAX flash attention and against autograd through the
port's einsum path.  Inputs come from a seeded numpy generator; B = 1,
H <= 4, D <= 64."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import flash_attention as tfa

S, D = 256, 64
# bf16: the kernels' products accumulate in f32 in both, and both round
# p, ds and the outputs to bf16 at the same points; an f32 value an ulp
# off on the other side of a rounding tie moves one term by one bf16 ulp
# (2^-8 relative).  Measured here: at most 1.3e-3 of the largest element.
BF16_TOL = 5e-3


def _inputs(seed, H, KVH, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shapes = [(1, S, H, D), (1, S, KVH, D), (1, S, KVH, D), (1, S, H, D)]
    return [rng.standard_normal(s).astype(np.float32).astype(dtype)
            for s in shapes]


def _t(a):
    """numpy (f32 or bf16) → torch, bit-exactly."""
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    return t.float().numpy()


def _jax_backward(q, k, v, do, causal, bq, bk):
    """The JAX kernels on [B,H,S,D]: forward for o and lse, then
    ``_flash_backward`` on k/v expanded to H heads."""
    H, KVH = q.shape[2], k.shape[2]
    qt, kt, vt, dot = (jnp.asarray(a).transpose(0, 2, 1, 3)
                       for a in (q, k, v, do))
    scale = D ** -0.5
    o, lse = jfa._flash_forward(qt, kt, vt, scale=scale, causal=causal,
                                block_q=bq, block_kv=bk)
    kx = jnp.repeat(kt, H // KVH, axis=1)
    vx = jnp.repeat(vt, H // KVH, axis=1)
    dq, dk_exp, dv_exp = jfa._flash_backward(
        qt, kx, vx, o, lse, dot, scale=scale, causal=causal, block_q=bq,
        block_kv=bk)
    back = lambda a: np.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    return (back(o), np.asarray(lse)[..., 0], back(dq), back(dk_exp),
            back(dv_exp))


def _group(x_exp, KVH):
    """JAX's per-q-head dk_exp/dv_exp [B,S,H,D] summed over each kv
    head's group, as ``_flash_bwd_rule`` sums them."""
    B, S_, H, D_ = x_exp.shape
    return x_exp.astype(np.float32).reshape(B, S_, KVH, H // KVH, D_).sum(3)


@pytest.mark.parametrize("dtype,bq,bk", [("f32", 128, 128),
                                         ("f32", 256, 128),
                                         ("bf16", 128, 128)])
@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])  # MHA and GQA
@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_match_jax_backward_kernels(dtype, bq, bk, H, KVH,
                                                   causal):
    npdt = np.float32 if dtype == "f32" else ml_dtypes.bfloat16
    q, k, v, do = _inputs(H * 10 + KVH + causal, H, KVH, npdt)
    o, lse, dq_j, dk_j, dv_j = _jax_backward(q, k, v, do, causal, bq, bk)
    tq, tk, tv, tdo, to = (_t(a) for a in (q, k, v, do, o.astype(npdt)))
    tlse = torch.from_numpy(lse.copy())
    delta = tfa.flash_backward_delta(to, tdo)
    dq = tfa.flash_backward_dq_plain(tq, tk, tv, tdo, tlse, delta, causal)
    dk, dv = tfa.flash_backward_dkv_plain(tq, tk, tv, tdo, tlse, delta,
                                          causal)
    assert dq.dtype == dk.dtype == dv.dtype == tq.dtype
    assert dk.shape == dv.shape == tk.shape
    for name, got, want in (("dq", dq, dq_j), ("dk", dk, _group(dk_j, KVH)),
                            ("dv", dv, _group(dv_j, KVH))):
        want = want.astype(np.float32)
        if dtype == "f32":
            np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-5,
                                       err_msg=name)
        else:
            scale = np.abs(want).max()
            np.testing.assert_allclose(_np(got) / scale, want / scale,
                                       atol=BF16_TOL, rtol=0, err_msg=name)


def test_group_sum_matches_the_jax_rule():
    """The wrapper's CPU path sums dk/dv over each kv head's q heads as
    ``_flash_bwd_rule`` does (q head h → kv head h // group)."""
    q, k, v, do = _inputs(5, 4, 2)
    o, lse, _, dk_j, dv_j = _jax_backward(q, k, v, do, True, 128, 128)
    tq, tk, tv, tdo, to = (_t(a) for a in (q, k, v, do, o))
    tlse = torch.from_numpy(lse.copy())
    delta = tfa.flash_backward_delta(to, tdo)
    dk, dv = tfa.flash_backward_dkv(tq, tk, tv, tdo, tlse, delta, True)
    np.testing.assert_allclose(
        dk.numpy(), dk_j.reshape(1, S, 2, 2, D).sum(3), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        dv.numpy(), dv_j.reshape(1, S, 2, 2, D).sum(3), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])
def test_autograd_function_matches_jax_grad(H, KVH):
    q, k, v, w = _inputs(7 + KVH, H, KVH)

    def jloss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, causal=True, block_q=128,
                                           block_kv=128) * jnp.asarray(w))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    before = (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
              tfa.flash_backward_dkv.launches)
    o = tfa.flash_attention(tq, tk, tv, causal=True)
    got = torch.autograd.grad(o, (tq, tk, tv), _t(w))
    # CPU tensors: the plain versions, no kernel launch.
    assert (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
            tfa.flash_backward_dkv.launches) == before
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-4,
                                   rtol=5e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_autograd_function_matches_einsum_path_grads(causal):
    q, k, v, w = _inputs(11, 4, 2)
    grads = []
    for route in ("flash", "einsum"):
        tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
        if route == "flash":
            o = tfa.flash_attention(tq, tk, tv, causal=causal)
        else:
            o = tattn.dot_product_attention(tq, tk, tv, causal=causal)
        grads.append(torch.autograd.grad(o, (tq, tk, tv), _t(w)))
    for name, a, b in zip("qkv", *grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5,
                                   msg=f"d{name}")
