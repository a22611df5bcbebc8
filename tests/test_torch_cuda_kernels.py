"""The port's CUDA kernels (K1, K2, K3, K9f, K10, K11, K4, K5, K6, K7,
K8, K12, K13; K1, K4, K7 and K8 on bf16/f32 and on int8 pools; K1 and K13
on both their routes) against their plain PyTorch versions on the card, in
f32 and bf16, across head dims, page sizes and GQA groups (Mixtral
8x7B's group of 4 among them), and a Mixtral layer on the card against the
CPU.  CUDA kernels have no CPU mode: without a card every
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


# f32: same arithmetic, other summation order.  K1 in bf16 rounds p to
# bf16 before p.v at the running max, as its plain version does, and both
# reach the same f32 p (q.k summed in one fixed order, exp in f64 rounded
# once), so p rounds identically and K1 keeps the f32 tolerance; K9f
# rounds p to bf16 before p.v (at its running max; the plain version at
# the final lse) and its f32 result to bf16 (one ulp = 2^-8 relative).
K1_TOL = 1e-4
K9_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _k1_case(dev, dtype, qpg, D, page, maxp, seed, L=3, B=6, KVH=2):
    """q, pools of L layers, lengths 0, 1, page - 1, page, page + 1, a
    slot of every page (at most 1,000 tokens) and, past six slots, fractions
    of it, a block table of shuffled pages with the scratch page past each
    slot's live ones."""
    g = _gen(seed)
    P = B * maxp + 1
    q = torch.randn((B, KVH * qpg, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=dtype)
    v = torch.randn_like(k)
    full = min(maxp * page, 1000)
    lens = [0, 1, page - 1, page, page + 1, full][:B]
    lens += [full // (i + 2) for i in range(B - len(lens))]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live]
    return q, k, v, bt, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpg,D,page,maxp", [
    (1, 16, 16, 5), (2, 64, 16, 5), (4, 128, 64, 5), (8, 128, 32, 5),
    # A 1,000-token slot over an 8-CTA cluster of 2 pages each.
    (4, 128, 64, 16),
    # qpg 5 (padded to 8) and D 32 on the Hopper route; D 48 on the
    # page-walk route.
    (5, 32, 16, 5), (2, 48, 16, 5)])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k1_matches_plain(dev, dtype, qpg, D, page, maxp, soft_cap):
    L = 3
    q, k, v, bt, lengths = _k1_case(dev, dtype, qpg, D, page, maxp,
                                    seed=qpg * D + page + maxp - 5, L=L)
    for layer in range(L):
        got = tpa.paged_decode_attention_partial(q, k, v, layer, bt, lengths,
                                                 soft_cap=soft_cap)
        want = tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=K1_TOL, rtol=K1_TOL)


@pytest.fixture(scope="module")
def one_launch_runs():
    """K1 at the 8B decode shape, then K13, each called once inside ONE
    torch.profiler session (a second session in a process can come back
    without device events): the device kernels of the session, and per
    call its result and the bytes it allocated."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    q1, k1, v1, bt1, len1 = _k1_case(dev, torch.bfloat16, 4, 128, 64, 16,
                                     seed=41, L=2, B=8, KVH=8)
    q13, k13, v13, bt13, len13 = _k13_inputs(dev, torch.bfloat16, 4, 128,
                                             64, 16, seed=31, B=6, KVH=8)
    calls = {"K1": lambda: tpa.paged_decode_attention_partial(
                 q1, k1, v1, 1, bt1, len1),
             "K13": lambda: tpa.paged_decode_attention(q13, k13, v13, bt13,
                                                       len13)}
    for f in calls.values():
        f()
    torch.cuda.synchronize()
    runs = {}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for name, f in calls.items():
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = f()
            torch.cuda.synchronize()
            runs[name] = (out, torch.cuda.max_memory_allocated() - before)
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels, runs


def test_k1_is_one_launch_without_scratch(dev, one_launch_runs):
    """K1 at the 8B decode shape is one kernel per call on the Hopper route
    (torch.profiler on the card counts its device kernels: K1's
    instantiation of paged_decode_hopper has PARTIAL = true, K13's false),
    and the call allocates only acc, m and l."""
    kernels, runs = one_launch_runs
    assert len(kernels) == 2, kernels
    mine = [name for name in kernels if "true>" in name]
    assert len(mine) == 1 and "paged_decode_hopper" in mine[0], kernels
    (acc, m, l), grown = runs["K1"]
    outs = sum(-(-t.numel() * 4 // 512) * 512 for t in (acc, m, l))
    assert grown <= outs, (grown, outs)


@pytest.mark.parametrize("int8", [False, True])
def test_k1_is_deterministic(dev, int8):
    """Two launches of K1 on the Hopper route give the same bits (the
    ranks of a cluster merge in rank order)."""
    q, k, v, bt, lengths = _k1_case(dev, torch.bfloat16, 4, 128, 64, 16,
                                    seed=42)
    scales = {}
    if int8:
        k, v, ks, vs = _quantise(_gen(43), k, k.shape[2], k.shape[1])
        scales = {"k_scales": ks, "v_scales": vs}
    first = tpa.paged_decode_attention_partial(q, k, v, 2, bt, lengths,
                                               soft_cap=30.0, **scales)
    again = tpa.paged_decode_attention_partial(q, k, v, 2, bt, lengths,
                                               soft_cap=30.0, **scales)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_k1_is_capturable(dev):
    """K1 captured in a CUDA graph replays to the eager bits, on both
    routes and on int8 pools."""
    q, k, v, bt, lengths = _k1_case(dev, torch.bfloat16, 4, 128, 64, 16,
                                    seed=44)
    k8, v8, ks, vs = _quantise(_gen(45), k, k.shape[2], k.shape[1])
    qw, kw, vw, btw, lw = _k1_case(dev, torch.bfloat16, 2, 48, 16, 5,
                                   seed=46)
    calls = [lambda: tpa.paged_decode_attention_partial(
                 q, k, v, 1, bt, lengths, soft_cap=30.0),
             lambda: tpa.paged_decode_attention_partial(
                 q, k8, v8, 1, bt, lengths, k_scales=ks, v_scales=vs),
             lambda: tpa.paged_decode_attention_partial(
                 qw, kw, vw, 1, btw, lw)]
    eager = [f() for f in calls]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(outs, eager):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


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


# Sequence lengths and heads: S % 128 == 64 leaves the last 128-row tile
# of the bf16 D in {64, 128} kernels half empty; (8, 4, 2048) are
# BENCH_CFG's heads and length; groups 1, 2 and 8.
K9F_CASES = [(64, True, 4, 2), (256, True, 4, 2), (128, False, 4, 2),
             (192, True, 4, 2), (192, False, 4, 2), (320, True, 4, 2),
             (192, True, 8, 1), (320, True, 4, 4), (2048, True, 8, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("S,causal,H,KVH", K9F_CASES)
def test_k9f_matches_plain(dev, dtype, D, S, causal, H, KVH):
    g = _gen(D + S + H * KVH)
    B = 2
    q = torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev, dtype=dtype)
    v = torch.randn_like(k)
    o, lse = tfa.flash_forward(q, k, v, causal)
    o_p, lse_p = tfa.flash_forward_plain(q, k, v, causal)
    torch.cuda.synchronize()
    tol = K9_TOL[dtype]
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)


# K10/K11: f32 sums in another order; bf16 outputs round once (one ulp
# = 2^-8 relative) and the rounded p / ds feed the products in both
# versions, so a rounding that lands on the other side of a tie moves a
# few terms by one ulp.  Both versions of K11 sum the group in f32
# before their one rounding.
K10_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


# Every head pair at every (S, causal), then BENCH_CFG's attention.
K10_CASES = [(H, KVH, S, causal)
             for H, KVH in ((4, 4), (4, 2), (8, 1))
             for S, causal in ((64, True), (256, True), (192, False),
                               (192, True), (320, True), (320, False))]
K10_CASES.append((8, 4, 2048, True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
@pytest.mark.parametrize("H,KVH,S,causal", K10_CASES)
def test_k10_k11_match_plain(dev, dtype, D, H, KVH, S, causal):
    g = _gen(D + S + H * KVH)
    B = 2
    q = torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev, dtype=dtype)
    v = torch.randn_like(k)
    do = torch.randn_like(q)
    o, lse = tfa.flash_forward_plain(q, k, v, causal)
    delta = tfa.flash_backward_delta(o, do)
    b10, b11 = tfa.flash_backward_dq.launches, tfa.flash_backward_dkv.launches
    dq = tfa.flash_backward_dq(q, k, v, do, lse, delta, causal)
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, lse, delta, causal)
    torch.cuda.synchronize()
    assert tfa.flash_backward_dq.launches == b10 + 1
    assert tfa.flash_backward_dkv.launches == b11 + 1
    dq_p = tfa.flash_backward_dq_plain(q, k, v, do, lse, delta, causal)
    dk_p, dv_p = tfa.flash_backward_dkv_plain(q, k, v, do, lse, delta,
                                              causal)
    tol = K10_TOL[dtype]
    for name, a, b in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        scale = b.float().abs().max().item()
        torch.testing.assert_close(a.float() / scale, b.float() / scale,
                                   atol=tol, rtol=0, msg=name)


def _bench_attention(g, dev, B=2, S=2048, H=8, KVH=4, D=128):
    """bf16 q, k, v and do at BENCH_CFG's heads (8 of 128, 4 kv)."""
    q = torch.randn((B, S, H, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    do = torch.randn_like(q)
    return q, k, v, do


def test_k11_is_deterministic(dev):
    """K11 sums each kv head's group in a fixed order inside one CTA, with
    no atomics: two launches give the same bits."""
    q, k, v, do = _bench_attention(_gen(21), dev)
    o, lse = tfa.flash_forward(q, k, v, True)
    delta = tfa.flash_backward_delta(o, do)
    first = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True)
    second = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_k10_is_deterministic(dev):
    """K10 owns its dq rows in one CTA each, with no atomics: two launches
    give the same bits."""
    q, k, v, do = _bench_attention(_gen(23), dev)
    o, lse = tfa.flash_forward(q, k, v, True)
    delta = tfa.flash_backward_delta(o, do)
    first = tfa.flash_backward_dq(q, k, v, do, lse, delta, True)
    second = tfa.flash_backward_dq(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_forward_and_backward_are_capturable(dev):
    """K9f, then K10 and K11, captured in one CUDA graph, replay to the
    eager results (the tensor maps travel as kernel parameters)."""
    q, k, v, do = _bench_attention(_gen(22), dev, S=320)

    def call():
        o, lse = tfa.flash_forward(q, k, v, True)
        return (o, lse, *tfa.flash_backward(q, k, v, o, lse, do, True))

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def test_autograd_function_launches_k9f_k10_k11(dev):
    g = _gen(7)
    q, k, v = (torch.randn((1, 256, H, 64), generator=g, device=dev)
               for H in (4, 2, 2))
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
              tfa.flash_backward_dkv.launches)
    o = tfa.flash_attention(q, k, v, causal=True)
    # A non-contiguous upstream gradient, as autograd may hand one over.
    do = torch.randn((1, 64, 4, 256), generator=g, device=dev).transpose(1, 3)
    got = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    after = (tfa.flash_forward.launches, tfa.flash_backward_dq.launches,
             tfa.flash_backward_dkv.launches)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
    o_p, _ = tfa.flash_forward_plain(q, k, v, True)
    want = torch.autograd.grad(o_p, (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn((2, 128, 4, 64), device=dev)
    k = torch.randn((2, 128, 2, 64), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_forward(q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, k)
    with pytest.raises(ValueError, match="S % 64"):
        tfa.flash_forward(q[:, :100].contiguous(), k[:, :100].contiguous(),
                          k[:, :100].contiguous())
    # K11 copies lse and delta rows in 16-byte bulk copies.
    lse = torch.zeros(2 * 4 * 128 + 1, device=dev)[1:].view(2, 4, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa.flash_backward_dkv(q, k, k, q, lse, lse, True)
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


# ---------------------------------------------------------------------------
# int8 pools: K1 and K4 with page scales, the quantised appends K3 and K6
# ---------------------------------------------------------------------------

_INT8_DIMS = [(16, 16), (64, 16), (64, 64), (128, 16), (128, 64)]
# K3 also at D 256 (two words of the row a lane); K4 takes no D 256.
_K3_DIMS = _INT8_DIMS + [(256, 16)]


def _quantise(g, pools_like, P, KVH):
    """Random int8 pools shaped like ``pools_like`` and page-major f32
    scales [L, P, KVH, 1]."""
    L = pools_like.shape[0]
    k = torch.randint(-127, 128, pools_like.shape, generator=g,
                      device="cuda", dtype=torch.int8)
    v = torch.randint(-127, 128, pools_like.shape, generator=g,
                      device="cuda", dtype=torch.int8)
    ks = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 + 0.005
    vs = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 + 0.005
    return k, v, ks, vs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page,maxp", [(D, page, 5)
                                         for D, page in _INT8_DIMS] + [
    # A 1,000-token slot over an 8-CTA cluster; D 48 on the page-walk
    # route.
    (128, 64, 16), (48, 16, 5)])
@pytest.mark.parametrize("qpg,soft_cap", [(1, None), (4, 30.0)])
def test_k1_int8_matches_plain(dev, dtype, D, page, maxp, qpg, soft_cap):
    g = _gen(qpg * D + page + 1)
    L, B, KVH = 3, 6, 2
    P = B * maxp + 1
    q = torch.randn((B, KVH * qpg, D), generator=g, device=dev, dtype=dtype)
    k, v, ks, vs = _quantise(g, torch.empty((L, KVH, P, page, D)), P, KVH)
    lens = [0, 1, page - 1, page, page + 1, min(maxp * page, 1000)]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live]
    before = (tpa.paged_decode_attention_partial.launches,
              tpa.paged_decode_attention_partial.launches_int8)
    for layer in range(L):
        got = tpa.paged_decode_attention_partial(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap, k_scales=ks,
            v_scales=vs)
        want = tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap, k_scales=ks,
            v_scales=vs)
        torch.cuda.synchronize()
        # f32 arithmetic on exactly converted inputs in both versions;
        # only the order of the sums differs (values up to ~|q| * 127 *
        # scale * sqrt(D) before the softmax).
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)
        acc, m, l = got
        assert (m[0] == -1e30).all() and (l[0] == 0).all() \
            and (acc[0] == 0).all()
    assert tpa.paged_decode_attention_partial.launches == before[0] + L
    assert tpa.paged_decode_attention_partial.launches_int8 == before[1] + L


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", _K3_DIMS)
def test_k3_matches_plain_bytes(dev, dtype, D, page):
    """Stored bytes and scales equal the plain version's bit for bit on
    live pages, through a first write (offset 0 on a stale page), stable
    scales, grown scales, an all-zero row and an inactive slot."""
    g = _gen(D + page + 3)
    L, KVH, P, B = 3, 2, 9, 6
    k, v, ks, vs = _quantise(g, torch.empty((L, KVH, P, page, D)), P, KVH)
    # Slots: 0 fresh page, 1 small row (stable), 2 large row (grown),
    # 3 all-zero row at offset 0, 4 inactive (scratch), 5 the sentinel.
    pids = torch.tensor([0, 3, 5, 6, P - 1, P], dtype=torch.int32,
                        device=dev)
    offs = torch.tensor([0, 3, page - 1, 0, 2, 1], dtype=torch.int32,
                        device=dev)
    mag = torch.tensor([1.0, 0.01, 50.0, 0.0, 1.0, 1.0], device=dev)
    k_new = (torch.randn((L, B, KVH, D), generator=g, device=dev)
             * mag[None, :, None, None]).to(dtype)
    v_new = (torch.randn((L, B, KVH, D), generator=g, device=dev)
             * mag[None, :, None, None]).to(dtype)
    got = [t.clone() for t in (k, v, ks, vs)]
    want = [t.clone() for t in (k, v, ks, vs)]
    before = tpa.paged_append_quantized.launches
    tpa.paged_append_quantized(*got, k_new, v_new, pids, offs)
    tpa.paged_append_quantized_plain(*want, k_new, v_new, pids, offs)
    torch.cuda.synchronize()
    assert tpa.paged_append_quantized.launches == before + 1
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[:, :, : P - 1], b[:, :, : P - 1])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a[:, : P - 1], b[:, : P - 1])
        assert torch.isfinite(a).all()
    # The cases are what they claim: stable keeps every other byte,
    # grown changes some, fresh zeroes the stale rows, zero row -> 0.
    assert torch.equal(got[0][:, :, 3, :3], k[:, :, 3, :3])
    assert torch.equal(got[2][:, 3], ks[:, 3])
    assert (got[2][:, 5] > ks[:, 5]).all()
    assert (got[0][:, :, 5, : page - 1] != k[:, :, 5, : page - 1]).any()
    assert not got[0][:, :, 0, 1:].any() and got[0][:, :, 0, 0].any()
    assert not got[2][:, 6].any() and not got[0][:, :, 6].any()
    for p in (1, 2, 4, 7):
        assert torch.equal(got[0][:, :, p], k[:, :, p])


def _k3_state_48(g, dev, dtype, L=4, KVH=8, D=128, page=64, B=48):
    """int8 pools and scales for 48 slots, one page each plus the scratch
    page, and new rows whose magnitudes, offsets and page ids mix every
    case: fresh pages (offset 0), stable and grown scales, all-zero rows
    and inactive slots on the scratch page."""
    P = B + 1
    state = _quantise(g, torch.empty((L, KVH, P, page, D)), P, KVH)
    pids = torch.randperm(B, generator=g, device=dev).to(torch.int32)
    pids[5::11] = P - 1                      # inactive: the scratch page
    offs = torch.randint(0, page, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    offs[::7] = 0                            # fresh pages
    mag = torch.tensor([0.0, 0.01, 0.3, 1.0, 5.0, 40.0], device=dev)
    mag = mag[torch.arange(B, device=dev) % 6]
    k_new = (torch.randn((L, B, KVH, D), generator=g, device=dev)
             * mag[None, :, None, None]).to(dtype)
    v_new = (torch.randn((L, B, KVH, D), generator=g, device=dev)
             * mag[None, :, None, None]).to(dtype)
    return state, k_new, v_new, pids, offs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_bytes_48_slots(dev, dtype):
    """K3 at 48 slots (the fused int8 step's count) and 8B widths: stored
    bytes and scales equal the plain version's on every live page."""
    state, k_new, v_new, pids, offs = _k3_state_48(_gen(48), dev, dtype)
    P = state[0].shape[2]
    got = [t.clone() for t in state]
    want = [t.clone() for t in state]
    tpa.paged_append_quantized(*got, k_new, v_new, pids, offs)
    tpa.paged_append_quantized_plain(*want, k_new, v_new, pids, offs)
    torch.cuda.synchronize()
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[:, :, : P - 1], b[:, :, : P - 1])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a[:, : P - 1], b[:, : P - 1])
        assert torch.isfinite(a).all()
    # Some scales grew, some held.
    grew = got[2][:, : P - 1] > state[2][:, : P - 1]
    assert grew.any() and not grew.all()


def test_k2_is_capturable(dev):
    """K2 captured in a CUDA graph writes what the eager call writes, with
    new rows, page ids and offsets copied into the captured buffers."""
    g = _gen(71)
    L, KVH, P, page, D, B = 4, 8, 17, 16, 128, 8
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    rows = [torch.randn((L, B, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16) for _ in range(2)]
    meta = [torch.randperm(P - 1, generator=g, device=dev)[:B].to(
                torch.int32),
            torch.randint(0, page, (B,), generator=g, device=dev,
                          dtype=torch.int32)]
    kg, vg = k.clone(), v.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_append(k.clone(), v.clone(), *rows, *meta)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tpa.paged_append(kg, vg, *rows, *meta)
    kg.copy_(k)
    vg.copy_(v)
    new = [torch.randn_like(rows[0]), torch.randn_like(rows[1]),
           meta[0].flip(0), (meta[1] + 3) % page]
    for buf, x in zip(rows + meta, new):
        buf.copy_(x)
    graph.replay()
    ke, ve = k.clone(), v.clone()
    tpa.paged_append(ke, ve, *new)
    torch.cuda.synchronize()
    assert torch.equal(kg, ke) and torch.equal(vg, ve)
    assert not torch.equal(kg, k)


def test_k3_is_capturable(dev):
    """K3 captured in a CUDA graph writes the bytes and scales the eager
    call writes, with new rows, page ids and offsets copied into the
    captured buffers (the fresh, stable and grown cases all occur)."""
    state, k_new, v_new, pids, offs = _k3_state_48(
        _gen(72), dev, torch.bfloat16, L=2, B=12)
    inputs = [k_new, v_new, pids, offs]
    graph_state = [t.clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_append_quantized(*[t.clone() for t in state], *inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tpa.paged_append_quantized(*graph_state, *inputs)
    for t, t0 in zip(graph_state, state):
        t.copy_(t0)
    new = [k_new * 2.0, v_new.flip(1), pids.flip(0), offs.roll(1)]
    for buf, x in zip(inputs, new):
        buf.copy_(x)
    graph.replay()
    eager = [t.clone() for t in state]
    tpa.paged_append_quantized(*eager, *new)
    torch.cuda.synchronize()
    P = state[0].shape[2]  # live pages below the scratch page P - 1
    for a, b in zip(graph_state[:2], eager[:2]):
        assert torch.equal(a[:, :, : P - 1], b[:, :, : P - 1])
    for a, b in zip(graph_state[2:], eager[2:]):
        assert torch.equal(a[:, : P - 1], b[:, : P - 1])
    assert not torch.equal(graph_state[0], state[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", _INT8_DIMS)
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k4_int8_matches_plain(dev, dtype, D, page, soft_cap):
    g = _gen(D + page + 4)
    L, KVH, qpg = 2, 2, 4
    kf, _vf, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, dtype, L, KVH * qpg, KVH, D, page, _MIX)
    k, v, ks, vs = _quantise(g, kf, kf.shape[2], KVH)
    before = (trpa.ragged_paged_attention.launches,
              trpa.ragged_paged_attention.launches_int8)
    for layer in range(L):
        got = trpa.ragged_paged_attention(
            q, kn, vn, k, v, layer, *meta, bt, soft_cap=soft_cap,
            k_scales=ks, v_scales=vs)
        want = trpa.ragged_paged_attention_plain(
            q, kn, vn, k, v, layer, *meta, bt, soft_cap=soft_cap,
            k_scales=ks, v_scales=vs)
        torch.cuda.synchronize()
        # f32 arithmetic in both versions, other summation order; the
        # plain version dequantises first, the kernel scales the score.
        torch.testing.assert_close(got[covered], want[covered], atol=2e-4,
                                   rtol=2e-4)
        assert not got[~covered].any()
    assert trpa.ragged_paged_attention.launches == before[0] + L
    assert trpa.ragged_paged_attention.launches_int8 == before[1] + L


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,page", _INT8_DIMS)
def test_k6_matches_plain_bytes(dev, dtype, D, page):
    """Stored bytes and scales equal the plain version's bit for bit on
    every page but the scratch page, over decode rows, chunks crossing
    pages, a chunk starting mid-page and a padding row; untouched pages
    keep bytes and scale."""
    g = _gen(D + page + 6)
    L, KVH = 3, 2
    kf, _vf, _q, _kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, dtype, L, KVH, KVH, D, page, _MIX)
    P = kf.shape[2]
    k, v, ks, vs = _quantise(g, kf, P, KVH)
    T = _kn.shape[0]
    # Magnitudes per token: small ones keep a page's scale, large ones
    # grow it.
    mag = torch.rand((1, T, 1, 1), generator=g, device=dev) * 4.0
    k_new = (torch.randn((L, T, KVH, D), generator=g, device=dev)
             * mag).to(dtype)
    v_new = (torch.randn((L, T, KVH, D), generator=g, device=dev)
             * 0.001).to(dtype)
    got = [t.clone() for t in (k, v, ks, vs)]
    want = [t.clone() for t in (k, v, ks, vs)]
    before = trpa.ragged_paged_append_quantized.launches
    trpa.ragged_paged_append_quantized(*got, k_new, v_new, *meta, bt)
    trpa.ragged_paged_append_quantized_plain(*want, k_new, v_new, *meta, bt)
    torch.cuda.synchronize()
    assert trpa.ragged_paged_append_quantized.launches == before + 1
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a[:, :, :-1], b[:, :, :-1])
    for a, b in zip(got[2:], want[2:]):
        assert torch.equal(a[:, :-1], b[:, :-1])
        assert torch.isfinite(a).all()
    # The scratch page is never touched by the kernel (no row here runs
    # past its block table), and the pages changed are exactly those the
    # rows' fresh tokens touch.
    assert torch.equal(got[0][:, :, -1], k[:, :, -1])
    slot, start, ln, _off = (t.tolist() for t in meta)
    touched = set()
    for s_, st, n in zip(slot, start, ln):
        for pos in range(st, st + n):
            touched.add(int(bt[s_, pos // page]))
    changed = {p for p in range(P - 1)
               if not torch.equal(got[2][:, p], ks[:, p])
               or not torch.equal(got[0][:, :, p], k[:, :, p])}
    assert changed == touched
    # v: tiny fresh values under a stable scale leave old cells alone.
    stable = [p for p in touched if torch.equal(got[3][:, p], vs[:, p])]
    assert stable
    rows = dict(zip(slot, zip(start, ln)))
    for s_, (st, n) in rows.items():
        p = int(bt[s_, st // page])
        if n and st % page and p in stable:
            assert torch.equal(got[1][:, :, p, : st % page],
                               v[:, :, p, : st % page])


def test_k6_is_capturable(dev):
    """K6 captured in a CUDA graph writes what the eager call writes: the
    live (row, page) pairs are found on the card, so a replay with new
    rows, row lengths and starts lands them where an eager call does."""
    g = _gen(61)
    L, KVH, D, page = 2, 2, 64, 16
    kf, _vf, _q, _kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, torch.bfloat16, L, KVH, KVH, D, page, _MIX)
    P = kf.shape[2]
    T = _kn.shape[0]
    state0 = _quantise(g, kf, P, KVH)
    k_new = torch.randn((L, T, KVH, D), generator=g, device=dev).to(
        torch.bfloat16)
    v_new = torch.randn_like(k_new)
    meta_in = [t.clone() for t in meta]
    rows_in = [k_new.clone(), v_new.clone()]
    graph_state = [t.clone() for t in state0]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        trpa.ragged_paged_append_quantized(
            *[t.clone() for t in state0], *rows_in, *meta_in, bt)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        trpa.ragged_paged_append_quantized(*graph_state, *rows_in, *meta_in,
                                           bt)
    # New inputs in the captured buffers: the rows shifted by one token
    # and the second row one token shorter.
    slot, start, ln, off = (t.clone() for t in meta)
    start += 1
    ln[1] = max(int(ln[1]) - 1, 0)
    for buf, new in zip(meta_in, (slot, start, ln, off)):
        buf.copy_(new)
    rows_in[0].mul_(3.0)
    for t, t0 in zip(graph_state, state0):
        t.copy_(t0)
    graph.replay()
    eager = [t.clone() for t in state0]
    trpa.ragged_paged_append_quantized(*eager, *rows_in, slot, start, ln,
                                       off, bt)
    torch.cuda.synchronize()
    for a, b in zip(graph_state, eager):
        assert torch.equal(a, b)
    assert not torch.equal(graph_state[0], state0[0])


def test_int8_wrappers_reject_what_the_kernels_do_not_take(dev):
    pools = torch.zeros((1, 2, 3, 8, 16), dtype=torch.int8, device=dev)
    sc = torch.ones((1, 3, 2, 1), device=dev)
    q = torch.zeros((1, 4, 16), device=dev)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    lens = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int8 pools need"):
        tpa.paged_decode_attention_partial(q, pools, pools, 0, bt, lens)
    with pytest.raises(ValueError, match="f32 or bf16"):
        tpa.paged_decode_attention_partial(q.half(), pools, pools, 0, bt,
                                           lens, k_scales=sc, v_scales=sc)
    pools8 = torch.zeros((1, 2, 3, 8, 8), dtype=torch.int8, device=dev)
    new = torch.zeros((1, 1, 2, 8), device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        tpa.paged_append_quantized(pools8, pools8, sc, sc, new, new,
                                   lens, lens)


# ---------------------------------------------------------------------------
# K7 fused decode layer and K8 fused ragged layer
# ---------------------------------------------------------------------------

# Widths (D, H, KVH, M): a small layer and one LLAMA3_8B layer.
_SMALL = (128, 4, 2, 256)
_8B = (4096, 32, 8, 14336)
# f32: the kernel and the plain version do the same f32 arithmetic, the
# projections sum over D or M in another order.  bf16: both round the
# norm, the dot operands and the outputs to bf16 at the same points; an
# f32 value that differs in its last bits may round one bf16 ulp apart,
# and that propagates through the layer.
_FUSED_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def _fused_layer(seed, widths, form, dtype):
    """One layer's weights on the card: plain (``dtype``), separate int8
    leaves, or the fused int8 artifact; norms random around one."""
    from ray_tpu_torch.models import llama as tl
    from ray_tpu_torch.models import quant as tq

    D, H, KVH, M = widths
    cfg = tl.LlamaConfig(vocab_size=64, dim=D, n_layers=1, n_heads=H,
                         n_kv_heads=KVH, mlp_dim=M, dtype=dtype)
    g = _gen(seed)
    params = tq.init_quantized_llama(g, cfg, device="cuda")
    if form == "fused":
        params = tq.fuse_for_decode(params, cfg)
    elif form == "plain":
        params = tq.dequantize_params(params, dtype)
    for key in ("ln_attn", "ln_mlp"):
        params["layers"][key] = (1 + 0.1 * torch.randn(
            (1, D), generator=g, device="cuda")).to(dtype)

    def first(node):
        if isinstance(node, dict):
            return {k: first(v) for k, v in node.items()}
        return node[0]

    return first(params["layers"])


def _fused_pools(g, pool, L, KVH, P, page, hd, dtype):
    shape = (L, KVH, P, page, hd)
    if pool == "int8":
        k = torch.randint(-127, 128, shape, generator=g, device="cuda",
                          dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=g, device="cuda",
                          dtype=torch.int8)
        ks = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 \
            + 0.005
        vs = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 \
            + 0.005
        return k, v, {"k_scales": ks, "v_scales": vs}
    k = torch.randn(shape, generator=g, device="cuda", dtype=dtype)
    return k, torch.randn_like(k), {}


def _rope_rows(positions, hd, theta=500_000.0):
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device="cuda") / half)
    ang = positions.float()[:, None] * freqs
    return torch.sin(ang), torch.cos(ang)


def _assert_fused_close(got, want, dtype, rows=None):
    tol = _FUSED_TOL[dtype]
    for name, a, b in zip(("x_out", "k_new", "v_new"), got, want):
        assert a.dtype == dtype and a.shape == b.shape, name
        if rows is not None:
            a, b = a[rows], b[rows]
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=name)


# (pool kind, activation dtype)
_POOLS = [("f32", torch.float32), ("bf16", torch.bfloat16),
          ("int8", torch.float32), ("int8", torch.bfloat16)]


@pytest.mark.parametrize("form", ["plain", "int8", "fused"])
@pytest.mark.parametrize("pool,dtype", _POOLS)
def test_k7_matches_plain(dev, form, pool, dtype):
    from ray_tpu_torch.ops import fused_decode as tfd

    D, H, KVH, M = _SMALL
    hd = D // H
    layer = _fused_layer(3, _SMALL, form, dtype)
    g = _gen(4)
    L, B, page, maxp = 2, 13, 16, 5       # B not a multiple of 8
    P = B * maxp + 1
    k, v, scales = _fused_pools(g, pool, L, KVH, P, page, hd, dtype)
    x = torch.randn((B, D), generator=g, device=dev).to(dtype)
    lens = [0, 1, 15, 16, 17, 80, 33, 0, 2, 64, 50, 31, 5]  # 0: inactive
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live]
    sin, cos = _rope_rows(lengths, hd)
    soft_cap = 20.0 if form == "fused" else None
    before = tfd.fused_decode_layer.launches
    for layer_idx in range(L):
        got = tfd.fused_decode_layer(
            x, layer, k, v, layer_idx, bt, lengths, sin, cos, eps=1e-5,
            n_heads=H, n_kv_heads=KVH, soft_cap=soft_cap, **scales)
        want = tfd.fused_decode_layer_reference(
            x, layer, k, v, layer_idx, bt, lengths, sin, cos, eps=1e-5,
            n_heads=H, n_kv_heads=KVH, soft_cap=soft_cap, **scales)
        torch.cuda.synchronize()
        _assert_fused_close(got, want, dtype)
    assert tfd.fused_decode_layer.launches == before + L


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_k7_matches_plain_8b_layer(dev, pool):
    """One LLAMA3_8B layer from the fused int8 artifact, 48 slots with
    128-160 past tokens, page 64, bf16."""
    from ray_tpu_torch.ops import fused_decode as tfd

    D, H, KVH, M = _8B
    hd = D // H
    layer = _fused_layer(5, _8B, "fused", torch.bfloat16)
    g = _gen(6)
    B, page, maxp = 48, 64, 4
    P = B * maxp + 1
    k, v, scales = _fused_pools(g, pool, 1, KVH, P, page, hd, torch.bfloat16)
    x = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.randint(128, 161, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    bt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp)
    sin, cos = _rope_rows(lengths, hd)
    got = tfd.fused_decode_layer(x, layer, k, v, 0, bt, lengths, sin, cos,
                                 eps=1e-5, n_heads=H, n_kv_heads=KVH,
                                 **scales)
    want = tfd.fused_decode_layer_reference(
        x, layer, k, v, 0, bt, lengths, sin, cos, eps=1e-5, n_heads=H,
        n_kv_heads=KVH, **scales)
    torch.cuda.synchronize()
    _assert_fused_close(got, want, torch.bfloat16)


def _ragged_rows(rows_spec, T):
    """(slot, start, len) rows → int32 row tensors and per-token
    positions (tokens no row covers sit at position 0)."""
    offs, at = [], 0
    for _s, _st, n in rows_spec:
        offs.append(at)
        at += n
    assert at <= T
    cols = [torch.tensor(c, dtype=torch.int32, device="cuda")
            for c in zip(*rows_spec)]
    cols.append(torch.tensor(offs, dtype=torch.int32, device="cuda"))
    pos = torch.zeros(T, dtype=torch.int32)
    for (_s, st, n), off in zip(rows_spec, offs):
        pos[off:off + n] = torch.arange(st, st + n, dtype=torch.int32)
    return cols, pos.cuda()


def _ragged_bt(g, rows_spec, maxp, page, P):
    perm = torch.randperm(P - 1, device="cuda", generator=g).to(torch.int32)
    bt = torch.full((len(rows_spec), maxp), P - 1, dtype=torch.int32,
                    device="cuda")
    for r, (s, st, n) in enumerate(rows_spec):
        live = -(-(st + n) // page)
        bt[s, :live] = perm[s * maxp: s * maxp + live]
    return bt


@pytest.mark.parametrize("form", ["plain", "int8", "fused"])
@pytest.mark.parametrize("pool,dtype", _POOLS)
def test_k8_matches_plain(dev, form, pool, dtype):
    from ray_tpu_torch.ops import ragged_paged_attention as trpa

    D, H, KVH, M = _SMALL
    hd = D // H
    layer = _fused_layer(7, _SMALL, form, dtype)
    g = _gen(8)
    L, page, maxp, T = 2, 16, 8, 96
    # A chunk over a pooled past longer than 64 fresh keys, decode rows
    # (one with no past), a fresh prompt, a zero-length padding row, and
    # buffer tokens no row covers.
    spec = [(0, 40, 70), (1, 33, 1), (2, 0, 1), (3, 0, 9), (4, 100, 1),
            (5, 0, 0)]
    rows, pos = _ragged_rows(spec, T)
    P = len(spec) * maxp + 1
    k, v, scales = _fused_pools(g, pool, L, KVH, P, page, hd, dtype)
    bt = _ragged_bt(g, spec, maxp, page, P)
    x = torch.randn((T, D), generator=g, device=dev).to(dtype)
    sin, cos = _rope_rows(pos, hd)
    soft_cap = 20.0 if form == "int8" else None
    before = trpa.fused_ragged_layer.launches
    for layer_idx in range(L):
        got = trpa.fused_ragged_layer(
            x, layer, k, v, layer_idx, *rows, bt, sin, cos, eps=1e-5,
            n_heads=H, n_kv_heads=KVH, soft_cap=soft_cap, **scales)
        want = trpa.fused_ragged_layer_reference(
            x, layer, k, v, layer_idx, *rows, bt, sin, cos, eps=1e-5,
            n_heads=H, n_kv_heads=KVH, soft_cap=soft_cap, **scales)
        torch.cuda.synchronize()
        _assert_fused_close(got, want, dtype)
    assert trpa.fused_ragged_layer.launches == before + L


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_k8_matches_plain_8b_layer(dev, pool):
    """One LLAMA3_8B layer from the fused int8 artifact at the 8B ragged
    mix (seven decode rows, one 256-token chunk at 512; T = 264)."""
    from ray_tpu_torch.ops import ragged_paged_attention as trpa

    D, H, KVH, M = _8B
    hd = D // H
    layer = _fused_layer(9, _8B, "fused", torch.bfloat16)
    g = _gen(10)
    page, maxp, T = 64, 32, 264
    spec = [(r, s, n) for r, (s, n) in enumerate(
        [(300, 1), (517, 1), (700, 1), (900, 1), (1100, 1), (1300, 1),
         (1500, 1), (512, 256)])]
    rows, pos = _ragged_rows(spec, T)
    P = len(spec) * maxp + 1
    k, v, scales = _fused_pools(g, pool, 1, KVH, P, page, hd, torch.bfloat16)
    bt = _ragged_bt(g, spec, maxp, page, P)
    x = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    sin, cos = _rope_rows(pos, hd)
    got = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                  eps=1e-5, n_heads=H, n_kv_heads=KVH,
                                  **scales)
    want = trpa.fused_ragged_layer_reference(
        x, layer, k, v, 0, *rows, bt, sin, cos, eps=1e-5, n_heads=H,
        n_kv_heads=KVH, **scales)
    torch.cuda.synchronize()
    _assert_fused_close(got, want, torch.bfloat16)


# ---------------------------------------------------------------------------
# The Hopper K4 (csrc/ragged_attention.cuh) and K8 on the WGMMA route
# ---------------------------------------------------------------------------

# (start, len) rows per case, at LLAMA3_8B head shapes (H 32, KVH 8, D
# 128, page 64): past 0; pasts off the page (1, 65); chunks at start 0 of
# 256 and 257 tokens (the second crosses a q tile); padding rows.
_HOPPER_CASES = {
    "past0": [(0, 1), (0, 5), (700, 1)],
    "past_off_page": [(1, 1), (65, 1), (65, 40), (1, 3)],
    "chunk256": [(0, 256), (300, 1)],
    "chunk257": [(0, 257), (64, 1), (129, 1)],
    "padding": [(100, 1), (0, 0), (40, 20), (0, 0), (1500, 1)],
}


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("case", sorted(_HOPPER_CASES))
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k4_hopper_matches_plain(dev, pool, case, soft_cap):
    g = _gen(len(case) + (pool == "int8"))
    k, v, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.bfloat16, 2, 32, 8, 128, 64, _HOPPER_CASES[case])
    scales = {}
    if pool == "int8":
        k, v, ks, vs = _quantise(g, k, k.shape[2], 8)
        scales = {"k_scales": ks, "v_scales": vs}
    before = (trpa.ragged_paged_attention.launches,
              trpa.ragged_paged_attention.launches_int8)
    got = trpa.ragged_paged_attention(q, kn, vn, k, v, 1, *meta, bt,
                                      soft_cap=soft_cap, **scales)
    want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, 1, *meta, bt,
                                             soft_cap=soft_cap, **scales)
    torch.cuda.synchronize()
    # bf16 q and pages are exact in bf16; p is split hi + lo (2^-17).
    torch.testing.assert_close(got[covered], want[covered], atol=1e-3,
                               rtol=1e-3)
    assert not got[~covered].any()
    assert trpa.ragged_paged_attention.launches == before[0] + 1
    assert trpa.ragged_paged_attention.launches_int8 == before[1] + (
        pool == "int8")


@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("per_rank", [1, 12])
def test_k4_hopper_past_over_every_page(dev, pool, per_rank, monkeypatch):
    """Pasts longer than maxp pages attend to the first maxp pages only;
    one or twelve key blocks a rank (clusters of 8 and of 1 to 4)."""
    monkeypatch.setattr(trpa, "HOPPER_BLOCKS_PER_RANK", per_rank)
    g = _gen(31 + per_rank)
    rows = [(900, 1), (700, 1), (300, 30)]
    k, v, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.bfloat16, 1, 32, 8, 128, 64, rows)
    bt = bt[:, :8].contiguous()   # 512 past positions: the rows' pasts
    scales = {}
    if pool == "int8":
        k, v, ks, vs = _quantise(g, k, k.shape[2], 8)
        scales = {"k_scales": ks, "v_scales": vs}
    got = trpa.ragged_paged_attention(q, kn, vn, k, v, 0, *meta, bt,
                                      **scales)
    want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, 0, *meta, bt,
                                             **scales)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[covered], want[covered], atol=1e-3,
                               rtol=1e-3)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_k4_hopper_is_deterministic(dev, pool):
    g = _gen(41)
    rows = [(300, 1), (1500, 1), (512, 256)]
    k, v, q, kn, vn, meta, bt, _ = _ragged_case(
        dev, g, torch.bfloat16, 1, 32, 8, 128, 64, rows)
    scales = {}
    if pool == "int8":
        k, v, ks, vs = _quantise(g, k, k.shape[2], 8)
        scales = {"k_scales": ks, "v_scales": vs}
    a = trpa.ragged_paged_attention(q, kn, vn, k, v, 0, *meta, bt, **scales)
    b = trpa.ragged_paged_attention(q, kn, vn, k, v, 0, *meta, bt, **scales)
    assert torch.equal(a, b)


# A layer on the WGMMA route: every projection's segments are multiples
# of 64 columns (and its columns of 128), head_dim 128.
_WIDE = (1024, 8, 2, 2048)


@pytest.mark.parametrize("form", ["plain", "fused"])   # bf16 or int8 weights
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("T", [1, 264, 300])
def test_k8_wgmma_matches_plain(dev, form, pool, T):
    D, H, KVH, M = _WIDE
    hd = D // H
    layer = _fused_layer(51, _WIDE, form, torch.bfloat16)
    g = _gen(52 + T)
    page, maxp = 64, 24
    if T == 1:
        spec = [(0, 700, 1)]
    else:  # decode rows beside a chunk that fills the rest of the buffer
        spec = [(0, 300, 1), (1, 1500, 1), (2, 65, 1), (3, 0, 0),
                (4, 512, T - 3)]
    rows, pos = _ragged_rows(spec, T)
    P = len(spec) * maxp + 1
    k, v, scales = _fused_pools(g, pool, 1, KVH, P, page, hd, torch.bfloat16)
    bt = _ragged_bt(g, spec, maxp, page, P)
    x = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    sin, cos = _rope_rows(pos, hd)
    kw = dict(eps=1e-5, n_heads=H, n_kv_heads=KVH, **scales)
    before = trpa.fused_ragged_layer.launches
    got = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                  **kw)
    again = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                    **kw)
    want = trpa.fused_ragged_layer_reference(x, layer, k, v, 0, *rows, bt,
                                             sin, cos, **kw)
    torch.cuda.synchronize()
    covered = sum(n for *_, n in spec)
    _assert_fused_close([t[:covered] for t in got],
                        [t[:covered] for t in want], torch.bfloat16)
    for a, b in zip(got, again):   # bit-identical over two launches
        assert torch.equal(a, b)
    assert trpa.fused_ragged_layer.launches == before + 2


# A layer off the WGMMA route: head_dim 16, so the k/v segments are 32
# columns; its bf16 projections run on the CUDA cores, its attention on
# K4's CUDA-core design.
_NARROW = (64, 4, 2, 128)


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_fused_cuda_core_route_bf16(dev, pool):
    from ray_tpu_torch.ops import fused_decode as tfd

    D, H, KVH, M = _NARROW
    hd = D // H
    layer = _fused_layer(61, _NARROW, "int8", torch.bfloat16)
    g = _gen(62)
    page, maxp, T = 16, 8, 40
    spec = [(0, 40, 30), (1, 33, 1), (2, 0, 9)]
    rows, pos = _ragged_rows(spec, T)
    P = len(spec) * maxp + 1
    k, v, scales = _fused_pools(g, pool, 1, KVH, P, page, hd, torch.bfloat16)
    bt = _ragged_bt(g, spec, maxp, page, P)
    x = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    sin, cos = _rope_rows(pos, hd)
    kw = dict(eps=1e-5, n_heads=H, n_kv_heads=KVH, **scales)
    got = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                  **kw)
    want = trpa.fused_ragged_layer_reference(x, layer, k, v, 0, *rows, bt,
                                             sin, cos, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, want, torch.bfloat16)
    lengths = torch.tensor([40, 0, 17, 5], dtype=torch.int32, device=dev)
    bt4 = bt[:1].repeat(4, 1)
    sin, cos = _rope_rows(lengths, hd)
    xb = x[:4]
    got = tfd.fused_decode_layer(xb, layer, k, v, 0, bt4, lengths, sin, cos,
                                 **kw)
    want = tfd.fused_decode_layer_reference(xb, layer, k, v, 0, bt4, lengths,
                                            sin, cos, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, want, torch.bfloat16)


def test_k7_is_capturable(dev):
    """One K7 call captured in a CUDA graph replays to the eager result
    (no host sync, no host-made tensor inside the call)."""
    from ray_tpu_torch.ops import fused_decode as tfd

    D, H, KVH, M = _SMALL
    hd = D // H
    layer = _fused_layer(11, _SMALL, "fused", torch.bfloat16)
    g = _gen(12)
    B, page, maxp = 8, 16, 4
    P = B * maxp + 1
    k, v, scales = _fused_pools(g, "int8", 1, KVH, P, page, hd,
                                torch.bfloat16)
    x = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.randint(0, maxp * page, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    bt = torch.arange(B * maxp, dtype=torch.int32, device=dev).reshape(B, maxp)
    sin, cos = _rope_rows(lengths, hd)

    def call():
        return tfd.fused_decode_layer(x, layer, k, v, 0, bt, lengths, sin,
                                      cos, eps=1e-5, n_heads=H,
                                      n_kv_heads=KVH, **scales)

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert torch.equal(a, b)


def _decode_case(dev, rows, form, pool, seed):
    """A _WIDE layer (head_dim 128), ``rows`` slots with 0-200 past
    tokens on pages of 64, bf16 activations."""
    D, H, KVH, M = _WIDE
    hd = D // H
    layer = _fused_layer(seed, _WIDE, form, torch.bfloat16)
    g = _gen(seed + 1)
    page, maxp = 64, 4
    P = rows * maxp + 1
    k, v, scales = _fused_pools(g, pool, 2, KVH, P, page, hd, torch.bfloat16)
    x = torch.randn((rows, D), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.randint(0, 201, (rows,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[0] = 200
    bt = torch.randperm(P - 1, generator=g, device=dev)[: rows * maxp] \
        .to(torch.int32).reshape(rows, maxp)
    sin, cos = _rope_rows(lengths, hd)
    kw = dict(eps=1e-5, n_heads=H, n_kv_heads=KVH, soft_cap=None, **scales)
    return (x, layer, k, v, 1, bt, lengths, sin, cos), kw


@pytest.mark.parametrize("form", ["fused", "plain"])   # int8 or bf16 weights
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("rows", [1, 8, 48, 64])
def test_k7_decode_route_matches_plain(dev, form, pool, rows):
    """K7 at decode widths: int8 weights take the DECODE projections
    (bf16 weights the WGMMA route), head_dim 128 the tensor-core
    attention; within the fused tolerance of the plain version,
    bit-identical over two launches."""
    from ray_tpu_torch.ops import fused_decode as tfd

    args, kw = _decode_case(dev, rows, form, pool, 70 + rows)
    before = tfd.fused_decode_layer.launches
    got = tfd.fused_decode_layer(*args, **kw)
    again = tfd.fused_decode_layer(*args, **kw)
    want = tfd.fused_decode_layer_reference(*args, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, want, torch.bfloat16)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert tfd.fused_decode_layer.launches == before + 2


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_k8_one_token_takes_the_decode_route(dev, pool):
    """A K8 call of one token over int8 weights runs the DECODE
    projections (the route is chosen by the call's token count): within
    the fused tolerance of the plain version, bit-identical twice."""
    from ray_tpu_torch.ops import fused_decode as tfd

    D, H, KVH, M = _WIDE
    hd = D // H
    layer = _fused_layer(81, _WIDE, "fused", torch.bfloat16)
    wqkv = layer["attn"]["wqkv"]
    pj, _ = tfd._proj("t", [wqkv], D, 1, torch.bfloat16, wqkv["q"].device)
    assert pj.route == tfd._DECODE
    g = _gen(82)
    page, maxp = 64, 24
    spec = [(0, 700, 1)]
    rows, pos = _ragged_rows(spec, 1)
    P = maxp + 1
    k, v, scales = _fused_pools(g, pool, 1, KVH, P, page, hd, torch.bfloat16)
    bt = _ragged_bt(g, spec, maxp, page, P)
    x = torch.randn((1, D), generator=g, device=dev).to(torch.bfloat16)
    sin, cos = _rope_rows(pos, hd)
    kw = dict(eps=1e-5, n_heads=H, n_kv_heads=KVH, **scales)
    got = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                  **kw)
    again = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                    **kw)
    want = trpa.fused_ragged_layer_reference(x, layer, k, v, 0, *rows, bt,
                                             sin, cos, **kw)
    torch.cuda.synchronize()
    _assert_fused_close(got, want, torch.bfloat16)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


def test_k7_decode_route_is_capturable(dev):
    """The DECODE chain (per-tile arrival counts in the call's workspace)
    captured in a CUDA graph replays to the eager result, twice."""
    from ray_tpu_torch.ops import fused_decode as tfd

    args, kw = _decode_case(dev, 48, "fused", "int8", 90)

    def call():
        return tfd.fused_decode_layer(*args, **kw)

    eager = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, eager):
            assert torch.equal(a, b)


def test_k7_decode_route_on_two_streams_at_once(dev):
    """Two DECODE chains running at once on two streams keep their own
    arrival counts: each gives the eager result, every time."""
    from ray_tpu_torch.ops import fused_decode as tfd

    args, kw = _decode_case(dev, 48, "fused", "int8", 91)
    eager = tfd.fused_decode_layer(*args, **kw)
    streams = [torch.cuda.Stream() for _ in range(2)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = [[], []]
    for _ in range(8):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                outs[i].append(tfd.fused_decode_layer(*args, **kw))
    torch.cuda.synchronize()
    for got in outs[0] + outs[1]:
        for a, b in zip(got, eager):
            assert torch.equal(a, b)


def test_fused_wrappers_reject_what_the_kernels_do_not_take(dev):
    from ray_tpu_torch.ops import fused_decode as tfd

    D, H, KVH, M = _SMALL
    hd = D // H
    layer = _fused_layer(13, _SMALL, "int8", torch.float32)
    k = torch.zeros((1, KVH, 5, 16, hd), device=dev)
    bt = torch.zeros((2, 2), dtype=torch.int32, device=dev)
    lengths = torch.zeros((2,), dtype=torch.int32, device=dev)
    x = torch.zeros((2, D), device=dev)
    sin = torch.zeros((2, hd // 2), device=dev)
    mixed = dict(layer, attn=dict(layer["attn"],
                                  wk=layer["attn"]["wk"]["q"].float()))
    with pytest.raises(ValueError, match="mixed"):
        tfd.fused_decode_layer(x, mixed, k, k, 0, bt, lengths, sin, sin,
                               eps=1e-5, n_heads=H, n_kv_heads=KVH)
    with pytest.raises(ValueError, match="dtype"):
        tfd.fused_decode_layer(x.bfloat16(), layer, k, k, 0, bt, lengths,
                               sin, sin, eps=1e-5, n_heads=H,
                               n_kv_heads=KVH)


# ---------------------------------------------------------------------------
# K12 SSD chunk scan and K13 normalised paged decode attention
# ---------------------------------------------------------------------------

# K12 against ssd_pallas_plain: the same recurrence, but the kernel walks
# 32-position blocks (products in 3xTF32 split precision) where the plain
# version walks the resolved chunk (up to 256) in f32, and sums in other
# orders.  Relative to 1 + |y|.
K12_TOL = 2e-4


def _ssd_inputs(g, B, S, H, P, N, bc_dtype):
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    log_a = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    Bm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(
        bc_dtype)
    Cm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(
        bc_dtype)
    return x, log_a, Bm, Cm


def _assert_k12_close(got, want):
    err = ((got - want).abs() / (1 + want.abs())).max().item()
    assert err <= K12_TOL, err


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 512, 4, 64, 128, 64),   # S % 256 == 0: the chunk becomes 256
    (1, 192, 3, 32, 16, 64),    # S % 256 != 0: chunk 64 kept
    (2, 100, 2, 16, 8, 20),     # a partial last block of 64
    (1, 256, 2, 16, 128, 256),  # two CTAs: a grid far below the SM count
    (1, 128, 2, 32, 64, 64),    # 64 state rows
    (1, 128, 2, 32, 256, 64),   # 256 state rows, the most a CTA holds
])
def test_k12_matches_plain(dev, bc_dtype, B, S, H, P, N, chunk):
    from ray_tpu_torch.ops import mamba_ssd as tssd

    g = _gen(S + N)
    x, log_a, Bm, Cm = _ssd_inputs(g, B, S, H, P, N, bc_dtype)
    want = tssd.ssd_pallas_plain(x, log_a, Bm, Cm, chunk)
    # Grids this small take the 16-column tile (ssd_plan); the 2.7B
    # layer's test below takes the 32-column one.
    before = tssd.ssd_forward.launches
    got = tssd.ssd_forward(x, log_a, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert tssd.ssd_forward.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == x.shape
    _assert_k12_close(got, want)
    # B and C as column slices of one projection, as the model passes them.
    proj = torch.cat([Bm, Cm, Bm[..., :8]], dim=-1)
    got = tssd.ssd_forward(x, log_a, proj[..., :N], proj[..., N:2 * N],
                           chunk)
    torch.cuda.synchronize()
    _assert_k12_close(got, want)


@pytest.mark.parametrize("N", [264, 512])
def test_k12_more_state_rows_than_a_cta_holds(dev, N):
    """N above 256: one launch per slice of 256 state rows, the slices'
    y summed in order; close to the plain version, bit-identical over
    two calls."""
    from ray_tpu_torch.ops import mamba_ssd as tssd

    g = _gen(N)
    x, log_a, Bm, Cm = _ssd_inputs(g, 1, 192, 2, 32, N, torch.bfloat16)
    want = tssd.ssd_pallas_plain(x, log_a, Bm, Cm, 64)
    before = tssd.ssd_forward.launches
    got = tssd.ssd_forward(x, log_a, Bm, Cm, 64)
    again = tssd.ssd_forward(x, log_a, Bm, Cm, 64)
    torch.cuda.synchronize()
    assert tssd.ssd_forward.launches == before + 2 * -(-N // 256)
    _assert_k12_close(got, want)
    assert torch.equal(got, again)


def test_k12_function_backward_on_the_card(dev):
    """The Function on the card: K12 forward, the backward through
    ``ssd_chunked`` on the card, each cotangent in its input's dtype,
    against autograd of ``ssd_chunked`` itself."""
    from ray_tpu_torch.models import mamba2 as tm
    from ray_tpu_torch.ops import mamba_ssd as tssd

    g = _gen(77)
    x, log_a, Bm, Cm = _ssd_inputs(g, 2, 256, 4, 32, 16, torch.bfloat16)
    gy = torch.randn(x.shape, generator=g, device="cuda")
    ins = [t.clone().requires_grad_(True) for t in (x, log_a, Bm, Cm)]
    ref = [t.clone().requires_grad_(True) for t in (x, log_a, Bm, Cm)]
    before = tssd.ssd_forward.launches
    got = torch.autograd.grad(tssd.ssd_pallas(*ins, 64), ins, gy)
    want = torch.autograd.grad(tm.ssd_chunked(*ref, chunk=64), ref, gy)
    torch.cuda.synchronize()
    assert tssd.ssd_forward.launches == before + 1
    # The same ssd_chunked VJP on the same inputs: equal up to the order
    # cuBLAS picks for a product.
    for name, a, b, t in zip(("x", "log_a", "Bm", "Cm"), got, want, ins):
        assert a.dtype == t.dtype, name
        tol = 1e-5 if a.dtype == torch.float32 else 2 ** -7
        torch.testing.assert_close(a, b, atol=tol, rtol=tol, msg=name)


def test_k12_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from ray_tpu_torch.ops import mamba_ssd as tssd

    g = _gen(5)
    x, log_a, Bm, Cm = _ssd_inputs(g, 1, 64, 2, 16, 8, torch.float32)
    with pytest.raises(ValueError, match="float32"):
        tssd.ssd_forward(x.bfloat16(), log_a, Bm, Cm, 64)
    with pytest.raises(ValueError, match="share dtype"):
        tssd.ssd_forward(x, log_a, Bm, Cm.bfloat16(), 64)
    with pytest.raises(ValueError, match="unsupported P"):
        tssd.ssd_forward(x[..., :8], log_a, Bm, Cm, 64)
    with pytest.raises(ValueError, match="unsupported P"):
        tssd.ssd_forward(x, log_a, Bm[..., :4], Cm[..., :4], 64)
    with pytest.raises(ValueError, match="not divisible"):
        tssd.ssd_forward(x, log_a, Bm, Cm, 48)
    with pytest.raises(ValueError, match="is on cpu"):
        tssd.ssd_forward(x, log_a.cpu(), Bm, Cm, 64)


@pytest.mark.parametrize("S", [2048, 1984, 1000])
def test_k12_tensor_core_route_at_the_27b_layer(dev, S):
    """One MAMBA2_2_7B layer's shape (B 2, H 80, P 64, N 128, bf16 B/C):
    the 32-column plan, S = 2048, 1984 (31 blocks of 64) and 1000 (a
    partial last block); bit-identical over two launches."""
    from ray_tpu_torch.ops import mamba_ssd as tssd

    g = _gen(S)
    x, log_a, Bm, Cm = _ssd_inputs(g, 2, S, 80, 64, 128, torch.bfloat16)
    chunk = 64 if S % 64 == 0 else 8 if S % 8 == 0 else 1
    plan = tssd.ssd_plan(2, 80, 64, 128, 2, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert plan["p_tile"] == 32 and plan["waves"] == 1
    before = tssd.ssd_forward.launches
    got = tssd.ssd_forward(x, log_a, Bm, Cm, chunk)
    again = tssd.ssd_forward(x, log_a, Bm, Cm, chunk)
    want = tssd.ssd_pallas_plain(x, log_a, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert tssd.ssd_forward.launches == before + 2
    _assert_k12_close(got, want)
    assert torch.equal(got, again)


def _k13_inputs(dev, dtype, qpg, D, page, maxp, seed, B=6, KVH=2):
    """q, one layer's pages, a block table with OOB ids past each slot's
    live pages (P + 3 clamps to P - 1) and lengths 0, 1, page - 1, page,
    page + 1 and a slot of every page (its last page partial past 5)."""
    g = _gen(seed)
    P = B * maxp + 1
    q = torch.randn((B, KVH * qpg, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((KVH, P, page, D), generator=g, device=dev, dtype=dtype)
    v = torch.randn_like(k)
    lens = [0, 1, page - 1, page, page + 1,
            maxp * page - (3 if maxp > 5 else 0)][:B]
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, device=dev, generator=g).to(torch.int32)
    bt = torch.full((B, maxp), P + 3, dtype=torch.int32, device=dev)
    for b, n in enumerate(lens):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live]
    return q, k, v, bt, lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpg,D,page,maxp", [
    (1, 16, 16, 5), (2, 64, 16, 5), (4, 128, 64, 5), (8, 128, 32, 5),
    # A 40-page slot: a whole 8-CTA cluster of 5 pages each, more pages
    # than the ring holds at once, and a partial last page.
    (4, 128, 64, 40), (2, 64, 16, 40),
    # Groups of 3 and 5 (padded to 4 and 8 rows) and D 32.
    (3, 64, 16, 5), (5, 128, 64, 40), (2, 32, 16, 5)])
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k13_matches_plain(dev, dtype, qpg, D, page, maxp, soft_cap):
    q, k, v, bt, lengths = _k13_inputs(dev, dtype, qpg, D, page, maxp,
                                       seed=qpg * D + page + 13)
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=soft_cap)
    want = tpa.paged_decode_attention_plain(q, k, v, bt, lengths,
                                            soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    assert got.dtype == dtype and (got[0] == 0).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=K1_TOL, rtol=K1_TOL)
    else:
        # The same rounding points on both sides (every f32 value up to
        # p the same, p rounded to bf16 against the same power of two),
        # sums in other orders: at most one ulp of the output apart, which
        # is at most 2^-7 |out|; 1e-5 covers f32 sums in other orders
        # near 0.
        err = (got.float() - want.float()).abs()
        limit = 2 ** -7 * want.float().abs() + 1e-5
        assert (err <= limit).all(), (err / limit).max().item()


def test_k13_is_one_launch_without_scratch(dev, one_launch_runs):
    """K13 is one kernel per call (torch.profiler on the card counts its
    device kernels, in the session it shares with K1), and the call
    allocates only its output."""
    kernels, runs = one_launch_runs
    assert len(kernels) == 2, kernels
    mine = [name for name in kernels if "false>" in name]
    assert len(mine) == 1 and "paged_decode_hopper" in mine[0], kernels
    out, grown = runs["K13"]
    assert grown <= -(-out.numel() * out.element_size() // 512) * 512, grown


def test_k13_is_capturable(dev):
    """K13 captured in a CUDA graph replays to the eager bits (a fixed
    summation order: deterministic)."""
    q, k, v, bt, lengths = _k13_inputs(dev, torch.bfloat16, 4, 128, 64, 40,
                                       seed=32)
    eager = tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=30.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=30.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=30.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_k13_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 4, 16), device=dev)
    pages = torch.zeros((2, 3, 8, 16), device=dev)
    bt = torch.zeros((1, 2), dtype=torch.int32, device=dev)
    lens = torch.zeros((1,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="share dtype"):
        tpa.paged_decode_attention(q, pages.to(torch.int8),
                                   pages.to(torch.int8), bt, lens)
    with pytest.raises(ValueError, match="int32"):
        tpa.paged_decode_attention(q, pages, pages, bt.long(), lens)
    with pytest.raises(ValueError, match="bad shapes"):
        tpa.paged_decode_attention(q[:, :3], pages, pages, bt, lens)
    # A group above 8 rows and D 48, which the Hopper route does not take,
    # run on the page-walk route; D above 256 is no route's.
    g = _gen(57)
    for H, D in ((9, 16), (4, 48)):
        KVH = 1 if H == 9 else 2
        q_ = torch.randn((1, H, D), generator=g, device=dev)
        kp = torch.randn((KVH, 3, 8, D), generator=g, device=dev)
        vp = torch.randn_like(kp)
        lens_ = torch.tensor([13], dtype=torch.int32, device=dev)
        torch.testing.assert_close(
            tpa.paged_decode_attention(q_, kp, vp, bt, lens_),
            tpa.paged_decode_attention_plain(q_, kp, vp, bt, lens_),
            atol=K1_TOL, rtol=K1_TOL)
    with pytest.raises(ValueError, match="unsupported D=257"):
        tpa.paged_decode_attention(torch.zeros((1, 4, 257), device=dev),
                                   pages.new_zeros((2, 3, 8, 257)),
                                   pages.new_zeros((2, 3, 8, 257)), bt, lens)


# ---------------------------------------------------------------------------
# The page-walk route of K1 and K13: the shapes the Hopper route refuses
# ---------------------------------------------------------------------------

# (qpg, D, page, maxp): groups of 9 and 16 at D 128 (two CTAs of 8 rows
# each at 16), D 36 (element loads, zero-padded to 40), 48, 80 and 256, a
# slot over 40 pages, and page 128 at D 256, where k and v of a page do
# not fit in shared memory together and are staged one after the other.
_WALK_CASES = [(9, 128, 16, 5), (16, 128, 16, 40), (2, 36, 16, 5),
               (4, 48, 16, 40), (2, 80, 64, 5), (2, 256, 64, 5),
               (1, 256, 128, 5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpg,D,page,maxp", _WALK_CASES)
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k13_walk_matches_plain(dev, dtype, qpg, D, page, maxp, soft_cap):
    """K13 on the page-walk route against its plain version, with
    test_k13_matches_plain's tolerances: an empty slot gives 0."""
    q, k, v, bt, lengths = _k13_inputs(dev, dtype, qpg, D, page, maxp,
                                       seed=qpg * D + page + 17)
    assert tpa.hopper_decode_plan(6, 2, qpg, D, page, maxp, k.element_size(),
                                  False, dev) is None
    before = tpa.paged_decode_attention.launches
    got = tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=soft_cap)
    want = tpa.paged_decode_attention_plain(q, k, v, bt, lengths,
                                            soft_cap=soft_cap)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention.launches == before + 1
    assert got.dtype == dtype and (got[0] == 0).all()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=K1_TOL, rtol=K1_TOL)
    else:
        err = (got.float() - want.float()).abs()
        limit = 2 ** -7 * want.float().abs() + 1e-5
        assert (err <= limit).all(), (err / limit).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpg,D,page,maxp", _WALK_CASES)
@pytest.mark.parametrize("soft_cap", [None, 30.0])
def test_k1_walk_matches_plain(dev, dtype, qpg, D, page, maxp, soft_cap):
    """K1 on the page-walk route against its plain version on two layers,
    with test_k1_matches_plain's tolerance; an empty slot gives acc 0,
    m -1e30, l 0."""
    q, k, v, bt, lengths = _k1_case(dev, dtype, qpg, D, page, maxp,
                                    seed=qpg * D + page + maxp, L=2)
    assert tpa.hopper_decode_plan(6, 2, qpg, D, page, maxp, k.element_size(),
                                  True, dev) is None
    for layer in range(2):
        got = tpa.paged_decode_attention_partial(q, k, v, layer, bt, lengths,
                                                 soft_cap=soft_cap)
        want = tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths, soft_cap=soft_cap)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=K1_TOL, rtol=K1_TOL)
        acc, m, l = got
        assert (m[0] == -1e30).all() and (l[0] == 0).all() \
            and (acc[0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("qpg,D,page,maxp", [(16, 128, 16, 40),
                                             (2, 36, 16, 5), (2, 256, 64, 5)])
def test_k1_walk_int8_matches_plain(dev, dtype, qpg, D, page, maxp):
    """K1 on int8 pools on the page-walk route (D 36: element loads of
    int8 rows) against its plain version, with test_k1_int8_matches_plain's
    tolerance."""
    q, k, v, bt, lengths = _k1_case(dev, dtype, qpg, D, page, maxp,
                                    seed=qpg * D + 5, L=2)
    k, v, ks, vs = _quantise(_gen(qpg + D), k, k.shape[2], k.shape[1])
    before = tpa.paged_decode_attention_partial.launches_int8
    got = tpa.paged_decode_attention_partial(q, k, v, 1, bt, lengths,
                                             soft_cap=30.0, k_scales=ks,
                                             v_scales=vs)
    want = tpa.paged_decode_attention_partial_plain(
        q, k, v, 1, bt, lengths, soft_cap=30.0, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert tpa.paged_decode_attention_partial.launches_int8 == before + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=2e-4)


def test_k13_walk_is_capturable(dev):
    """K13 on the page-walk route (a group of 16) captured in a CUDA graph
    replays to the eager bits."""
    q, k, v, bt, lengths = _k13_inputs(dev, torch.bfloat16, 16, 128, 16, 40,
                                       seed=33)
    eager = tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=30.0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=30.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tpa.paged_decode_attention(q, k, v, bt, lengths, soft_cap=30.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


# ---------------------------------------------------------------------------
# Speculative decoding's row shapes for K4, K5, K6 and K8: verify rows of
# 2-5 tokens starting 1-4 tokens before a page boundary beside decode rows,
# then the rows that overwrite the rejected tails (each verify row restarts
# 1 + j tokens later, j drafts accepted), at LLAMA3_8B shapes
# ---------------------------------------------------------------------------

_VERIFY = [(62, 2), (125, 3), (188, 5), (253, 5), (300, 1), (510, 1)]
_REWRITE = [(63, 2), (126, 3), (190, 5), (254, 5), (301, 1), (511, 1)]


def _rows_like(meta, rows):
    """``meta``'s slots with other (start, len) rows, packed in order."""
    dev = meta[0].device
    offs, at = [], 0
    for _s, n in rows:
        offs.append(at)
        at += n
    return [meta[0]] + [torch.tensor(c, dtype=torch.int32, device=dev)
                        for c in ([s for s, _ in rows],
                                  [n for _, n in rows], offs)]


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_k4_verify_rows_match_plain(dev, pool):
    g = _gen(71)
    kf, vf, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.bfloat16, 2, 32, 8, 128, 64, _VERIFY)
    scales = {}
    if pool == "int8":
        kf, vf, ks, vs = _quantise(g, kf, kf.shape[2], 8)
        scales = {"k_scales": ks, "v_scales": vs}
    for rows in (meta, _rows_like(meta, _REWRITE)):
        n = int(rows[2].sum())
        got = trpa.ragged_paged_attention(q, kn, vn, kf, vf, 1, *rows, bt,
                                          **scales)
        want = trpa.ragged_paged_attention_plain(q, kn, vn, kf, vf, 1,
                                                 *rows, bt, **scales)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[:n], want[:n], atol=1e-3, rtol=1e-3)
        assert not got[n:].any()


def test_k5_verify_rows_and_rewrite_match_plain(dev):
    g = _gen(72)
    L, KVH, D = 2, 8, 128
    k, v, _q, kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, torch.bfloat16, L, KVH, KVH, D, 64, _VERIFY)
    T = kn.shape[0]
    got, want = (k.clone(), v.clone()), (k.clone(), v.clone())
    for rows in (meta, _rows_like(meta, _REWRITE)):
        k_new = torch.randn((L, T, KVH, D), generator=g, device=dev,
                            dtype=torch.bfloat16)
        v_new = torch.randn_like(k_new)
        trpa.ragged_paged_append(*got, k_new, v_new, *rows, bt)
        trpa.ragged_paged_append_plain(*want, k_new, v_new, *rows, bt)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a[:, :, :-1], b[:, :, :-1])


def test_k6_verify_rows_and_rewritten_pages_match_plain_bytes(dev):
    """The verify rows, then the rewrite rows fed values 8x larger: every
    page they touch grows its scale and is requantised whole (K6's "pages
    rewritten" case), bytes and scales equal the plain version's."""
    g = _gen(73)
    L, KVH, D = 2, 8, 128
    kf, _vf, _q, kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, torch.bfloat16, L, KVH, KVH, D, 64, _VERIFY)
    P, T = kf.shape[2], kn.shape[0]
    k, v, ks, vs = _quantise(g, kf, P, KVH)
    got = [t.clone() for t in (k, v, ks, vs)]
    want = [t.clone() for t in (k, v, ks, vs)]
    for rows, mag in ((meta, 1.0), (_rows_like(meta, _REWRITE), 8.0)):
        k_new = (torch.randn((L, T, KVH, D), generator=g, device=dev)
                 * mag).to(torch.bfloat16)
        v_new = (torch.randn((L, T, KVH, D), generator=g, device=dev)
                 * mag).to(torch.bfloat16)
        scales_before = got[2].clone()
        trpa.ragged_paged_append_quantized(*got, k_new, v_new, *rows, bt)
        trpa.ragged_paged_append_quantized_plain(*want, k_new, v_new, *rows,
                                                 bt)
        torch.cuda.synchronize()
        for a, b in zip(got[:2], want[:2]):
            assert torch.equal(a[:, :, :-1], b[:, :, :-1])
        for a, b in zip(got[2:], want[2:]):
            assert torch.equal(a[:, :-1], b[:, :-1])
    slot, start, ln, _off = (t.tolist() for t in _rows_like(meta, _REWRITE))
    rewritten = {int(bt[s_, p // 64]) for s_, st, n in zip(slot, start, ln)
                 for p in range(st, st + n)}
    for p in rewritten:
        assert (got[2][:, p] > scales_before[:, p]).all()


@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_k8_verify_rows_match_plain_8b_layer(dev, pool):
    """One LLAMA3_8B layer of the fused int8 artifact over the verify
    rows, then the rewrite rows."""
    D, H, KVH, M = _8B
    hd = D // H
    layer = _fused_layer(74, _8B, "fused", torch.bfloat16)
    g = _gen(75)
    page, maxp, T = 64, 10, 24
    P = len(_VERIFY) * maxp + 1
    k, v, scales = _fused_pools(g, pool, 1, KVH, P, page, hd, torch.bfloat16)
    bt = _ragged_bt(g, [(r, s, n) for r, (s, n) in enumerate(_VERIFY)],
                    maxp, page, P)
    x = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    for rows_spec in (_VERIFY, _REWRITE):
        spec = [(r, s, n) for r, (s, n) in enumerate(rows_spec)]
        rows, pos = _ragged_rows(spec, T)
        sin, cos = _rope_rows(pos, hd)
        n = sum(n_ for _, n_ in rows_spec)
        got = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                      eps=1e-5, n_heads=H, n_kv_heads=KVH,
                                      **scales)
        want = trpa.fused_ragged_layer_reference(
            x, layer, k, v, 0, *rows, bt, sin, cos, eps=1e-5, n_heads=H,
            n_kv_heads=KVH, **scales)
        torch.cuda.synchronize()
        _assert_fused_close(got, want, torch.bfloat16, rows=slice(0, n))


# ---------------------------------------------------------------------------
# A GQA group of 5 (BENCH_2B_CFG: 20 query heads over 4 kv heads, D 128)
# and CUDA-graph capture of K4 and K5
# ---------------------------------------------------------------------------

def _flash_group_matches_plain(dev, dtype, B, S, H, KVH, seed):
    """K9f, K10 and K11 (one launch each) against their plain versions
    at a causal GQA shape with D 128 (K9F / K10 tolerances above)."""
    g = _gen(seed)
    D = 128
    q = torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev, dtype=dtype)
    v = torch.randn_like(k)
    do = torch.randn_like(q)
    counts = [f.launches for f in (tfa.flash_forward, tfa.flash_backward_dq,
                                   tfa.flash_backward_dkv)]
    o, lse = tfa.flash_forward(q, k, v, True)
    o_p, lse_p = tfa.flash_forward_plain(q, k, v, True)
    delta = tfa.flash_backward_delta(o, do)
    dq = tfa.flash_backward_dq(q, k, v, do, lse, delta, True)
    dk, dv = tfa.flash_backward_dkv(q, k, v, do, lse, delta, True)
    torch.cuda.synchronize()
    assert [f.launches for f in (tfa.flash_forward, tfa.flash_backward_dq,
                                 tfa.flash_backward_dkv)] == \
        [c + 1 for c in counts]
    tol = K9_TOL[dtype]
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)
    del o_p, lse_p
    dq_p = tfa.flash_backward_dq_plain(q, k, v, do, lse, delta, True)
    dk_p, dv_p = tfa.flash_backward_dkv_plain(q, k, v, do, lse, delta, True)
    tol = K10_TOL[dtype]
    for name, a, b in (("dq", dq, dq_p), ("dk", dk, dk_p), ("dv", dv, dv_p)):
        scale = b.float().abs().max().item()
        torch.testing.assert_close(a.float() / scale, b.float() / scale,
                                   atol=tol, rtol=0, msg=name)


@pytest.mark.parametrize("dtype,B,S", [(torch.bfloat16, 4, 2048),
                                       (torch.float32, 1, 256)])
def test_flash_group_of_5_matches_plain(dev, dtype, B, S):
    """K9f, K10 and K11 at BENCH_2B_CFG's attention (H 20, KVH 4, D 128,
    causal), in bf16 at its batch and length and in f32 at a small one,
    against their plain versions (K9F / K10 tolerances above)."""
    _flash_group_matches_plain(dev, dtype, B, S, 20, 4, 55 + S)


# ---------------------------------------------------------------------------
# Mixtral 8x7B's attention (32 query heads over 8 kv heads: a GQA group of
# 4, D 128) and a Mixtral layer on the card against the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,B,S", [(torch.bfloat16, 2, 2048),
                                       (torch.float32, 1, 256)])
def test_flash_mixtral_attention_matches_plain(dev, dtype, B, S):
    """K9f, K10 and K11 at MIXTRAL_8X7B's attention (H 32, KVH 8, D 128,
    causal), in bf16 at the smoke's batch and length (2 x 2048) and in
    f32 at a small one, against their plain versions."""
    _flash_group_matches_plain(dev, dtype, B, S, 32, 8, 77 + S)


@pytest.mark.parametrize("mode", ["dense", "scatter"])
def test_mixtral_layer_forward_backward_card_vs_cpu(dev, mode):
    """One f32 Mixtral layer (S 256, 4 heads of 64 over 2 kv heads, 4
    experts, capacity factor 0.5 so assignments drop) forward and
    backward on the card (K9f, K10, K11 once each) against the same
    layer on the CPU (einsum attention): output, aux and every gradient
    within 1e-4 of the largest entry (f32; other summation orders)."""
    import dataclasses

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.models import mixtral as tm

    cfg = dataclasses.replace(
        tm.MIXTRAL_TINY, dim=256, n_heads=4, n_kv_heads=2, mlp_dim=256,
        max_seq_len=256, dtype=torch.float32, capacity_factor=0.5,
        dispatch_mode=mode)
    params = tm.init_params(torch.Generator().manual_seed(3), cfg,
                            device="cpu")
    layer0 = {g: ({k: v[0] for k, v in leaves.items()}
                  if isinstance(leaves, dict) else leaves[0])
              for g, leaves in params["layers"].items()}
    x0 = torch.randn((2, 256, 256), generator=torch.Generator().manual_seed(4))
    pos = torch.arange(256).expand(2, 256)

    def run(device):
        acfg = tm._attn_cfg(cfg)
        sin, cos = llama.rope_table(acfg, pos.to(device))
        layer = {g: ({k: v.to(device).requires_grad_(True)
                      for k, v in leaves.items()} if isinstance(leaves, dict)
                     else leaves.to(device).requires_grad_(True))
                 for g, leaves in layer0.items()}
        x = x0.to(device).requires_grad_(True)
        y, aux = tm._layer_fn(cfg, acfg, x, layer, sin, cos, None)
        flat = [x] + [t for leaves in layer.values()
                      for t in (leaves.values() if isinstance(leaves, dict)
                                else [leaves])]
        grads = torch.autograd.grad((y * y).mean() + aux, flat)
        return [y.detach(), aux.detach(), *grads]

    counts = [f.launches for f in (tfa.flash_forward, tfa.flash_backward_dq,
                                   tfa.flash_backward_dkv)]
    got = run(dev)
    torch.cuda.synchronize()
    assert [f.launches for f in (tfa.flash_forward, tfa.flash_backward_dq,
                                 tfa.flash_backward_dkv)] == \
        [c + 1 for c in counts]
    want = run("cpu")
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(b.abs().max().item(), 1e-30)
        torch.testing.assert_close(a.cpu() / scale, b / scale, atol=1e-4,
                                   rtol=0, msg=f"output {i}")


def _capture(call):
    """``call`` warmed on a side stream, then captured as one graph."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    return graph, out


def test_k4_is_capturable(dev):
    """K4 captured in a CUDA graph returns what the eager call returns,
    with new q, k/v rows and row descriptors copied into the captured
    buffers (8B heads: the Hopper route)."""
    g = _gen(91)
    rows = [(300, 1), (517, 1), (70, 1), (0, 0), (40, 64)]
    other = [(301, 1), (0, 0), (71, 1), (5, 1), (41, 63)]
    k, v, q, kn, vn, meta, bt, covered = _ragged_case(
        dev, g, torch.bfloat16, 2, 32, 8, 128, 64, rows)
    bufs = [q, kn, vn, *meta]
    graph, out = _capture(lambda: trpa.ragged_paged_attention(
        q, kn, vn, k, v, 1, *meta, bt))
    new = [torch.randn_like(q), torch.randn_like(kn), torch.randn_like(vn),
           *[torch.tensor(a, dtype=torch.int32, device=dev) for a in (
               meta[0].tolist(), [s for s, _ in other],
               [n for _, n in other],
               [0, 0, 1, 2, 3])]]
    for buf, x in zip(bufs, new):
        buf.copy_(x)
    graph.replay()
    eager = trpa.ragged_paged_attention(*new[:3], k, v, 1, *new[3:], bt)
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert out[:67].abs().sum() > 0


def test_k5_is_capturable(dev):
    """K5 captured in a CUDA graph writes what the eager call writes, with
    new rows and row descriptors copied into the captured buffers."""
    g = _gen(92)
    L, KVH, D, page = 3, 8, 128, 64
    k, v, _q, kn, _vn, meta, bt, _cov = _ragged_case(
        dev, g, torch.bfloat16, L, KVH, KVH, D, page, _MIX)
    T = kn.shape[0]
    k_new = torch.randn((L, T, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    kg, vg = k.clone(), v.clone()
    graph, _ = _capture(lambda: trpa.ragged_paged_append(
        kg, vg, k_new, v_new, *meta, bt))
    kg.copy_(k)
    vg.copy_(v)
    new = [torch.randn_like(k_new), torch.randn_like(v_new),
           meta[0], meta[1] + 1, meta[2], meta[3]]
    for buf, x in zip([k_new, v_new, *meta], new):
        buf.copy_(x.clone())
    graph.replay()
    ke, ve = k.clone(), v.clone()
    trpa.ragged_paged_append(ke, ve, *new, bt)
    torch.cuda.synchronize()
    assert torch.equal(kg, ke) and torch.equal(vg, ve)
    assert not torch.equal(kg, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [311, 300, 449])
def test_flash_attention_pads_causal_lengths_off_the_tile(dev, dtype, S):
    """Causal S from 256 to 511 off the 64-row tile (the JAX rule's one
    block of S): ``flash_attention`` pads, launches K9f and, through
    autograd, K10 and K11, and its output and gradients agree with the
    plain versions on the unpadded tensors (K9F / K10 tolerances)."""
    g = _gen(S)
    H, KVH, D = 20, 4, 128
    q, k, v = (torch.randn((2, S, h, D), generator=g, device=dev,
                           dtype=dtype).requires_grad_(True)
               for h in (H, KVH, KVH))
    do = torch.randn((2, S, H, D), generator=g, device=dev, dtype=dtype)
    counts = [f.launches for f in (tfa.flash_forward, tfa.flash_backward_dq,
                                   tfa.flash_backward_dkv)]
    o = tfa.flash_attention(q, k, v, causal=True)
    grads = torch.autograd.grad(o, (q, k, v), do)
    torch.cuda.synchronize()
    assert [f.launches for f in (tfa.flash_forward, tfa.flash_backward_dq,
                                 tfa.flash_backward_dkv)] == \
        [c + 1 for c in counts]
    assert o.shape == (2, S, H, D)
    q, k, v = (t.detach() for t in (q, k, v))
    o_p, lse_p = tfa.flash_forward_plain(q, k, v, True)
    tol = K9_TOL[dtype]
    torch.testing.assert_close(o.float(), o_p.float(), atol=tol, rtol=tol)
    delta = tfa.flash_backward_delta(o_p, do)
    want = (tfa.flash_backward_dq_plain(q, k, v, do, lse_p, delta, True),
            *tfa.flash_backward_dkv_plain(q, k, v, do, lse_p, delta, True))
    tol = K10_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        scale = b.float().abs().max().item()
        torch.testing.assert_close(a.float() / scale, b.float() / scale,
                                   atol=tol, rtol=0, msg=name)
