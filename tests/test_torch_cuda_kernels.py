"""The port's CUDA kernels (K1, K2, K9f, K4, K5) against their plain
PyTorch versions on the card, in f32 and bf16, across head dims, page
sizes and GQA groups.  CUDA kernels have no CPU mode: without a card every
test here skips.  On a machine with one (no jax needed):

    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest
"""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import paged_attention as tpa
from ray_tpu_torch.ops import ragged_paged_attention as trpa

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator(device="cuda").manual_seed(seed)


# f32: same arithmetic, other summation order.  bf16 inputs convert
# exactly to f32 in both versions, so K1 keeps the f32 tolerance; K9f
# rounds its f32 result to bf16 (one ulp = 2^-8 relative).
K1_TOL = 1e-4
K9_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpg,D,page", [(1, 16, 16), (2, 64, 16),
                                        (4, 128, 64), (8, 128, 32)])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k1_matches_plain(dev, dtype, qpg, D, page, soft_cap):
    g = _gen(qpg * D + page)
    L, B, KVH, maxp = 3, 6, 2, 5
    P = B * maxp + 1
    q = torch.randn((B, KVH * qpg, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=dtype)
    v = torch.randn_like(k)
    lens = [0, 1, page - 1, page, page + 1, maxp * page]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live]
    for layer in range(L):
        got = tpa.paged_decode_attention_partial(q, k, v, layer, bt, lengths,
                                                 soft_cap=soft_cap)
        want = tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=K1_TOL, rtol=K1_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 128])
def test_k2_matches_plain(dev, dtype, D):
    g = _gen(D)
    L, KVH, P, page, B = 4, 2, 9, 8, 5
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=dtype)
    v = torch.randn_like(k)
    k_new = torch.randn((L, B, KVH, D), generator=g, device=dev, dtype=dtype)
    v_new = torch.randn_like(k_new)
    pids = torch.tensor([0, 3, P - 1, 7, P], dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 7, 3, 4, 1], dtype=torch.int32, device=dev)
    before = tpa.paged_append.launches
    k1, v1 = k.clone(), v.clone()
    tpa.paged_append(k1, v1, k_new, v_new, pids, offs)
    k2, v2 = k.clone(), v.clone()
    tpa.paged_append_plain(k2, v2, k_new, v_new, pids, offs)
    torch.cuda.synchronize()
    assert tpa.paged_append.launches == before + 1
    # Live pages are exact copies; the scratch page (two writers at
    # offsets 3 and 1) may keep either one.
    assert torch.equal(k1[:, :, : P - 1], k2[:, :, : P - 1])
    assert torch.equal(v1[:, :, : P - 1], v2[:, :, : P - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("S,causal", [(64, True), (256, True),
                                      (128, False)])
def test_k9f_matches_plain(dev, dtype, D, S, causal):
    g = _gen(D + S)
    B, H, KVH = 2, 4, 2
    q = torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev, dtype=dtype)
    v = torch.randn_like(k)
    o, lse = tfa.flash_forward(q, k, v, causal)
    o_p, lse_p = tfa.flash_forward_plain(q, k, v, causal)
    torch.cuda.synchronize()
    tol = K9_TOL[dtype]
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn((2, 128, 4, 64), device=dev)
    k = torch.randn((2, 128, 2, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, k)
    with pytest.raises(ValueError, match="S % 64"):
        tfa.flash_forward(q[:, :100].contiguous(), k[:, :100].contiguous(),
                          k[:, :100].contiguous())
    pools = torch.zeros((1, 2, 3, 8, 64), device=dev)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_decode_attention_partial(
            torch.zeros((1, 4, 64), device=dev), pools, pools, 0,
            torch.zeros((1, 2), dtype=torch.int64, device=dev),
            torch.zeros((1,), dtype=torch.int32, device=dev))


def _ragged_case(dev, g, dtype, L, H, KVH, D, page, rows):
    """Pools, block tables and a flat buffer for ``rows`` = [(start,
    len)] (len 0 = padding), one distinct slot each, shuffled pages."""
    R = len(rows)
    maxp = max(-(-(s + n) // page) for s, n in rows) + 1
    P = R * maxp + 1
    T = sum(n for _, n in rows) + 3  # a few tokens no row covers
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=dtype)
    v = torch.randn_like(k)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((R, maxp), P - 1, dtype=torch.int32, device=dev)
    slot, start, ln, off = [], [], [], []
    cur = 0
    for r, (s, n) in enumerate(rows):
        live = -(-(s + n) // page)
        bt[r, :live] = perm[r * maxp: r * maxp + live]
        slot.append(R - 1 - r)  # rows and slots in other orders
        start.append(s)
        ln.append(n)
        off.append(cur if n else 0)
        cur += n
    bt = bt.flip(0).contiguous()  # row r owns slot R - 1 - r
    meta = [torch.tensor(a, dtype=torch.int32, device=dev)
            for a in (slot, start, ln, off)]
    q = torch.randn((T, H, D), generator=g, device=dev, dtype=dtype)
    kn = torch.randn((T, KVH, D), generator=g, device=dev, dtype=dtype)
    vn = torch.randn_like(kn)
    covered = torch.zeros(T, dtype=torch.bool, device=dev)
    for n, o in zip(ln, off):
        covered[o:o + n] = True
    return k, v, q, kn, vn, meta, bt, covered


# The decode / chunk / padding mixes a ragged step packs.
_MIX = [(19, 1), (0, 11), (40, 30), (0, 0), (70, 1), (5, 64)]


@pytest.mark.parametrize("qpg,D,page", [(1, 16, 16), (2, 64, 16),
                                        (4, 128, 64), (8, 32, 32)])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k4_matches_plain_f32(dev, qpg, D, page, soft_cap):
    g = _gen(qpg * D + page)
    L, KVH = 2, 2
    k, v, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.float32, L, KVH * qpg, KVH, D, page, _MIX)
    before = trpa.ragged_paged_attention.launches
    for layer in range(L):
        got = trpa.ragged_paged_attention(q, kn, vn, k, v, layer, *meta, bt,
                                          soft_cap=soft_cap)
        want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, layer,
                                                 *meta, bt, soft_cap=soft_cap)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[covered], want[covered], atol=K1_TOL,
                                   rtol=K1_TOL)
        assert not got[~covered].any()
    assert trpa.ragged_paged_attention.launches == before + L


def test_k4_matches_plain_bf16_8b_heads(dev):
    """LLAMA3_8B head shapes (H 32, KVH 8, D 128, page 64): seven decode
    rows with long pasts beside one 256-token chunk row.  bf16 inputs
    convert exactly to f32 in both versions: only the summation order
    differs."""
    g = _gen(8)
    rows = [(300, 1), (517, 1), (800, 1), (1023, 1), (1200, 1), (1400, 1),
            (1500, 1), (512, 256)]
    k, v, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.bfloat16, 2, 32, 8, 128, 64, rows)
    got = trpa.ragged_paged_attention(q, kn, vn, k, v, 1, *meta, bt)
    want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, 1, *meta, bt)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[covered], want[covered], atol=1e-3,
                               rtol=1e-3)
    assert not got[~covered].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", [(16, 16), (128, 64)])
def test_k5_matches_plain(dev, dtype, D, page):
    g = _gen(D + page)
    L, KVH = 3, 2
    k, v, _q, _kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, dtype, L, KVH, KVH, D, page, _MIX)
    T = _kn.shape[0]
    k_new = torch.randn((L, T, KVH, D), generator=g, device=dev, dtype=dtype)
    v_new = torch.randn_like(k_new)
    before = trpa.ragged_paged_append.launches
    k1, v1 = k.clone(), v.clone()
    trpa.ragged_paged_append(k1, v1, k_new, v_new, *meta, bt)
    k2, v2 = k.clone(), v.clone()
    trpa.ragged_paged_append_plain(k2, v2, k_new, v_new, *meta, bt)
    torch.cuda.synchronize()
    assert trpa.ragged_paged_append.launches == before + 1
    # A copy: exact on every page but the scratch page, which the plain
    # version writes for uncovered tokens and the kernel never touches.
    assert torch.equal(k1[:, :, :-1], k2[:, :, :-1])
    assert torch.equal(v1[:, :, :-1], v2[:, :, :-1])
    assert torch.equal(k1[:, :, -1], k[:, :, -1])
    n_rows = sum(n for _, n in _MIX)
    assert int((k1 != k).any(dim=-1).sum()) == L * KVH * n_rows
