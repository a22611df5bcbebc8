"""Port of the Mamba-2 SSD chunk scan against the JAX package on the CPU:
K12's plain version (``ssd_pallas_plain``) against the JAX Pallas
``ssd_pallas`` in interpret mode, as tests/test_mamba_ssd_kernel.py runs
it; the port's ``ssd_chunked`` against JAX's and the sequential numpy
oracle of tests/test_mamba2.py; the ``ssd_pallas`` autograd Function's
gradients against ``jax.grad`` of ``ssd_chunked`` (the JAX ``custom_vjp``
runs exactly that, so no interpret mode is needed).  Inputs come from a
seeded numpy generator, at tiny H, P and N: interpret mode costs seconds
a call, so each JAX kernel result is computed once for the module."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ray_tpu.models import mamba2 as jm
from ray_tpu.ops import mamba_ssd as jssd
from ray_tpu_torch.models import mamba2 as tm
from ray_tpu_torch.ops import mamba_ssd as tssd
from tests.test_mamba2 import ssd_oracle

# f32 on both sides, the tolerance of the JAX package's own kernel test:
# the sums run in other orders (einsum or loop vs Pallas dots, a loop
# over chunk states vs lax.associative_scan).
TOL = 2e-4


def _inputs(seed, B=1, S=32, H=2, P=4, N=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    # log decay <= 0 of moderate size (-softplus of a normal), as the JAX
    # kernel test draws it.
    log_a = -np.logaddexp(rng.standard_normal((B, S, H)), 0).astype(
        np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.3).astype(np.float32)
    return x, log_a, Bm, Cm


def _t(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# (S, chunk): chunk 8 kept at S = 32; chunk 64 becomes 256 at S = 256.
CASES = [(32, 8), (256, 64)]


@pytest.fixture(scope="module")
def pallas_runs():
    out = {}
    for S, chunk in CASES:
        ins = _inputs(S, S=S)
        got = jssd.ssd_pallas(*map(jnp.asarray, ins), chunk)
        out[S] = (ins, chunk, np.asarray(got))
    return out


def test_chunk_rule():
    assert tssd.resolve_chunk(256, 64) == 256
    assert tssd.resolve_chunk(32, 8) == 8
    assert tssd.resolve_chunk(384, 64) == 64   # 384 % 256 != 0
    assert tssd.resolve_chunk(512, 512) == 512
    with pytest.raises(ValueError, match="not divisible"):
        tssd.resolve_chunk(48, 32)


@pytest.mark.parametrize("S", [S for S, _ in CASES])
def test_plain_matches_jax_interpret_kernel(pallas_runs, S):
    ins, chunk, want = pallas_runs[S]
    got = tssd.ssd_pallas_plain(*map(_t, ins), chunk)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # The wrapper takes the plain version for CPU tensors, and at S = 256
    # the given chunk resolves to the same 256 as an explicit one.
    np.testing.assert_array_equal(
        tssd.ssd_forward(*map(_t, ins), chunk).numpy(), got.numpy())
    if S == 256:
        np.testing.assert_array_equal(
            tssd.ssd_pallas_plain(*map(_t, ins), 256).numpy(), got.numpy())


@pytest.mark.parametrize("chunk", [8, 32])
def test_ssd_chunked_matches_jax_and_oracle(chunk):
    x, la, Bm, Cm = _inputs(3, B=2, S=32, H=3, P=4, N=5)
    got = tm.ssd_chunked(*map(_t, (x, la, Bm, Cm)), chunk).numpy()
    want = np.asarray(jax.jit(jm.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (x, la, Bm, Cm)), chunk))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got, ssd_oracle(x, la, Bm, Cm), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("bc_dtype", ["float32", "bfloat16"])
def test_function_grads_match_jax_grad(bc_dtype):
    """The Function's backward recomputes ``ssd_chunked`` at the GIVEN
    chunk (8 here, though the forward runs at 256) and returns each
    cotangent in its input's dtype: bf16 for bf16 B and C, as JAX's VJP
    returns them."""
    x, la, Bm, Cm = _inputs(4, S=256, H=2, P=4, N=8)
    rng = np.random.default_rng(5)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    if bc_dtype == "bfloat16":
        Bm, Cm = (a.astype(ml_dtypes.bfloat16) for a in (Bm, Cm))

    def loss(*a):
        return jnp.sum(jm.ssd_chunked(*a, chunk=8) * gy)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (x, la, Bm, Cm)))
    ins = [_t(a).requires_grad_(True) for a in (x, la, Bm, Cm)]
    y = tssd.ssd_pallas(*ins, 8)
    assert y.dtype == torch.float32
    got = torch.autograd.grad(y, ins, torch.from_numpy(gy))
    # bf16 cotangents of B and C: one bf16 ulp (2^-8 to 2^-7 of a value)
    # where an f32 sum taken in another order rounds to the other side.
    for name, g, w, t in zip(("x", "log_a", "Bm", "Cm"), got, want, ins):
        assert g.dtype == t.dtype, name
        tol = 2 ** -7 if g.dtype == torch.bfloat16 else 1e-4
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)

