"""Host-side plans and arithmetic of the Hopper kernels of K4/K8
(``csrc/ragged_attention.cuh``) and of K7/K8's WGMMA projections
(``csrc/fused_layer.cuh``), on the CPU.

The kernels run only on the card; here the wrappers' plans are checked to
cover every (row, token, key) and every output column exactly once, the
projection routes are checked for the shapes each takes, and a plain
PyTorch emulation of the Hopper attention's arithmetic (bf16 operands,
f32 sums, hi + lo splits of p and of an f32 q, 64-key blocks walked by
the ranks of a cluster and merged in rank order) is held against the
port's plain K4 with ten times the card's margin.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import fused_decode as tfd
from ray_tpu_torch.ops import ragged_paged_attention as trpa


def _rows_for(T, rng):
    """A ragged packing of at most T tokens: decode rows, chunks and
    padding rows, with pasts on and off page boundaries."""
    rows, left = [], T
    while left > 0 and len(rows) < 12:
        kind = rng.integers(3)
        n = 0 if kind == 0 else 1 if kind == 1 else int(
            rng.integers(1, left + 1))
        n = min(n, left)
        rows.append((int(rng.integers(0, 2000)), n))
        left -= n
    return rows


def _work(row_start, row_len, qpg, maxp, page, cluster, slots):
    """The Hopper kernel's assignment for one kv head (``attention_hopper``
    in csrc/ragged_attention.cuh), mirrored: for every CTA (slot, rank)
    that does not exit at once, its row, tokens [t0, t0 + ntok), key
    blocks [b0, b0 + n) of the tile's nbp pooled then fresh blocks (64
    keys each), the tile's live ranks, and the share [lo, hi) of the
    tile's nrows * D outputs (per unit of D) it stores."""
    tpt = 64 // qpg
    tiles = []
    for r, n in enumerate(row_len):
        cnt = -(-n // tpt) if n > 0 else 0
        tiles += [(r, cnt - 1 - i) for i in range(cnt)]
    out = []
    for z in range(slots):
        if z >= len(tiles):
            continue
        r, tile = tiles[z]
        t0 = tile * tpt
        ntok = min(tpt, row_len[r] - t0)
        n_pool = min(row_start[r], maxp * page)
        nbp = -(-n_pool // 64)
        nb = nbp + -(-(t0 + ntok) // 64)
        per = -(-nb // cluster)
        n_live = -(-nb // per)
        nrows = ntok * qpg
        for rank in range(n_live):
            out.append({"row": r, "t0": t0, "ntok": ntok, "nbp": nbp,
                        "n_pool": n_pool, "b0": rank * per,
                        "n": min(per, nb - rank * per), "n_live": n_live,
                        "lo": nrows * rank // n_live,
                        "hi": nrows * (rank + 1) // n_live})
    return out


@pytest.mark.parametrize("qpg", [1, 4, 8])
def test_hopper_attention_plan_covers_every_key_once(qpg):
    rng = np.random.default_rng(qpg)
    page, maxp = 64, 24
    for T in range(1, 301):
        rows = _rows_for(T, rng)
        R = len(rows)
        starts = [s for s, _ in rows]
        lens = [n for _, n in rows]
        cluster, slots = trpa.hopper_attention_plan(T, R, qpg, maxp, page)
        assert 1 <= cluster <= 8 and cluster & (cluster - 1) == 0
        work = _work(starts, lens, qpg, maxp, page,
                                          cluster, slots)
        tokens = {}
        tiles = {}
        for w in work:
            tiles.setdefault((w["row"], w["t0"]), []).append(w)
        for (r, t0), ranks in tiles.items():
            ntok = ranks[0]["ntok"]
            for t in range(t0, t0 + ntok):
                tokens[(r, t)] = tokens.get((r, t), 0) + 1
            assert len(ranks) == ranks[0]["n_live"] <= cluster
            # The ranks' runs tile the blocks [0, nb) once, in order.
            at = 0
            for w in sorted(ranks, key=lambda w: w["b0"]):
                assert w["b0"] == at and w["n"] >= 1
                at += w["n"]
            nbp = ranks[0]["nbp"]
            assert nbp * 64 >= ranks[0]["n_pool"] > (nbp - 1) * 64 or nbp == 0
            assert at == nbp + -(-(t0 + ntok) // 64)  # fresh keys <= last
            # The output shares partition the tile's rows.
            shares = sorted((w["lo"], w["hi"]) for w in ranks)
            assert shares[0][0] == 0 and shares[-1][1] == ntok * qpg
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
        want = {(r, t): 1 for r, n in enumerate(lens) for t in range(n)}
        assert tokens == want, T


@pytest.mark.parametrize("K,cols,wb", [(4096, 6144, 1), (4096, 4096, 2),
                                       (14336, 4096, 1), (1024, 4096, 2)])
def test_wgmma_plan_covers_every_column_and_k_once(K, cols, wb):
    for rows in range(1, 301):
        plan = tfd.wgmma_plan(rows, K, cols, wb, 132)
        nt = plan["nw"] * plan["nc"]
        assert plan["token_tiles"] * nt >= rows > (plan["token_tiles"]
                                                   - 1) * nt
        assert (plan["nw"], plan["nc"]) in tfd._WGMMA_TILES
        assert plan["col_tiles"] * 128 == cols
        assert plan["kps"] % 64 == 0 and 1 <= plan["splits"] <= 8
        assert plan["splits"] * plan["kps"] >= K > (plan["splits"] - 1) \
            * plan["kps"]
        ring = plan["stages"] * plan["stage_bytes"]
        assert 2 <= plan["stages"] and ring <= tfd._WGMMA_SMEM
        assert ring >= nt * 132 * 4  # the f32 result tile fits the ring
        if rows <= 272:  # one token tile: each weight byte read once
            assert plan["token_tiles"] == 1


def test_projection_routes(monkeypatch):
    monkeypatch.setattr(tfd, "_sm_count", lambda _i: 132)
    dev = torch.device("cpu")
    q8 = {"q": torch.zeros((256, 512), dtype=torch.int8),
          "scale": torch.ones((1, 512))}
    pj, n = tfd._proj("t", [q8], 256, 264, torch.bfloat16, dev)
    assert (pj.route, n) == (tfd._WGMMA, 0) and pj.splits >= 1
    wb = torch.zeros((256, 512), dtype=torch.bfloat16)
    pj, n = tfd._proj("t", [wb, wb], 256, 48, torch.bfloat16, dev)
    assert pj.route == tfd._WGMMA and (pj.nw, pj.nc) == (64, 1)
    # f32 activations: exact f32 products on the CUDA cores.
    pj, n = tfd._proj("t", [q8], 256, 264, torch.float32, dev)
    assert pj.route == tfd._CUDA_CORES and n > 0
    # Segments off 64 columns (a tiny model's k/v) or f32 weights: the
    # CUDA cores, with their partial sums.
    narrow = {"q": torch.zeros((256, 32), dtype=torch.int8),
              "scale": torch.ones((1, 32))}
    pj, n = tfd._proj("t", [q8, narrow, narrow], 256, 8, torch.bfloat16, dev)
    assert pj.route == tfd._CUDA_CORES and n > 0
    pj, _ = tfd._proj("t", [torch.zeros((256, 512))], 256, 8,
                      torch.bfloat16, dev)
    assert pj.route == tfd._CUDA_CORES


# ---------------------------------------------------------------------------
# the Hopper attention's arithmetic, emulated
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634


def _bf(x):
    return x.to(torch.bfloat16).float()


def _emulate(q, kn, vn, kp, vp, ks, vs, rows, bt, page, cluster,
             soft_cap=None):
    """The Hopper kernel's arithmetic on one layer's pages [KVH, P, page,
    D] (scales [P, KVH] or None): per (tile, kv head, rank) an f32 online
    softmax over 64-key blocks in log2 units, S = q_hi.k + q_lo.k and
    O += p_hi.v + p_lo.v with bf16 operands and f32 sums, then the ranks'
    (acc, m, l) merged in rank order."""
    T, H, D = q.shape
    KVH, P = kp.shape[0], kp.shape[1]
    qpg = H // KVH
    maxp = bt.shape[1]
    scale = D ** -0.5
    out = torch.zeros((T, H, D))
    starts = [s for _s, s, _n, _o in rows]
    lens = [n for _s, _s2, n, _o in rows]
    work = _work(starts, lens, qpg, maxp, page, cluster,
                                      -(-T * qpg // 64) + len(rows))
    tiles = {}
    for w in work:
        tiles.setdefault((w["row"], w["t0"]), []).append(w)
    for (r, t0), ranks in tiles.items():
        slot, _start, _n, off = rows[r]
        ntok, nbp, n_pool = ranks[0]["ntok"], ranks[0]["nbp"], \
            ranks[0]["n_pool"]
        nrows = ntok * qpg
        tok = t0 + torch.arange(nrows) // qpg
        for g in range(KVH):
            qt = q[off + t0: off + t0 + ntok, g * qpg:(g + 1) * qpg]
            qt = qt.reshape(nrows, D).float()
            q_hi = _bf(qt)
            q_lo = _bf(qt - q_hi)
            parts = []
            for w in sorted(ranks, key=lambda w: w["b0"]):
                m = torch.full((nrows,), -1e30)
                l = torch.zeros(nrows)
                acc = torch.zeros((nrows, D))
                for blk in range(w["b0"], w["b0"] + w["n"]):
                    c = torch.arange(64)
                    if blk < nbp:
                        pos = blk * 64 + c
                        pid = bt[slot, (pos // page).clamp(max=maxp - 1)]
                        pid = pid.long().clamp(0, P - 1)
                        kb = kp[g, pid, pos % page].float()
                        vb = vp[g, pid, pos % page].float()
                        valid = (pos < n_pool)[None, :].expand(nrows, 64)
                        ksc = ks[pid, g] if ks is not None else None
                        vsc = vs[pid, g] if vs is not None else None
                    else:
                        j = (blk - nbp) * 64 + c
                        jj = (off + j).clamp(max=T - 1)
                        kb = torch.where((off + j < T)[:, None],
                                         kn[jj, g].float(), 0.0)
                        vb = torch.where((off + j < T)[:, None],
                                         vn[jj, g].float(), 0.0)
                        valid = j[None, :] <= tok[:, None]
                        ksc = vsc = None
                    s = q_hi @ kb.T + q_lo @ kb.T
                    x = s * scale
                    if ksc is not None:
                        x = x * ksc[None, :]
                    if soft_cap is not None:
                        x = soft_cap * torch.tanh(x / soft_cap)
                    y = torch.where(valid, x * LOG2E, -1e30)
                    m_new = torch.maximum(m, y.amax(dim=1))
                    corr = torch.exp2(m - m_new)
                    p = torch.where(valid, torch.exp2(y - m_new[:, None]),
                                    0.0)
                    l = corr * l + p.sum(dim=1)
                    pv = p * vsc[None, :] if vsc is not None else p
                    p_hi = _bf(pv)
                    p_lo = _bf(pv - p_hi)
                    acc = acc * corr[:, None] + p_hi @ vb + p_lo @ vb
                    m = m_new
                parts.append((acc, m, l))
            M = torch.stack([pm for _a, pm, _l in parts]).amax(dim=0)
            a = torch.zeros((nrows, D))
            lsum = torch.zeros(nrows)
            for pa, pm, pl in parts:
                f = torch.exp2(pm - M)
                a = a + pa * f[:, None]
                lsum = lsum + pl * f
            o = (a / lsum[:, None]).reshape(ntok, qpg, D)
            out[off + t0: off + t0 + ntok, g * qpg:(g + 1) * qpg] = o
    return out


@pytest.mark.parametrize("q_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
@pytest.mark.parametrize("cluster", [1, 4])
def test_hopper_attention_arithmetic_matches_plain(q_dtype, pool, cluster):
    """bf16 q (K4) or f32 q split hi + lo (K8), D 128, qpg 4: the
    emulation within 1e-4 of the plain K4, ten times under the card's
    1e-3."""
    rng = np.random.default_rng(7 + cluster)
    D, KVH, qpg, page, maxp = 128, 2, 4, 16, 24
    H = KVH * qpg
    rows_se = [(300, 1), (130, 1), (0, 1), (100, 40), (0, 0), (33, 70)]
    T = sum(n for _s, n in rows_se) + 2
    R = len(rows_se)
    P = R * maxp + 1
    rows, at = [], 0
    for r, (s, n) in enumerate(rows_se):
        rows.append((r, s, n, at))
        at += n
    perm = rng.permutation(P - 1)
    bt = np.full((R, maxp), P - 1, np.int32)
    for r, (s, n) in enumerate(rows_se):
        live = -(-(s + n) // page)
        bt[r, :live] = perm[r * maxp: r * maxp + live]
    bt = torch.from_numpy(bt)
    q = torch.from_numpy(rng.standard_normal((T, H, D), np.float32))
    q = q.to(q_dtype)
    kn = torch.from_numpy(rng.standard_normal((T, KVH, D), np.float32)).to(
        torch.bfloat16)
    vn = torch.from_numpy(rng.standard_normal((T, KVH, D), np.float32)).to(
        torch.bfloat16)
    ks = vs = None
    if pool == "int8":
        kp = torch.from_numpy(rng.integers(-127, 128, (1, KVH, P, page, D),
                                           dtype=np.int8))
        vp = torch.from_numpy(rng.integers(-127, 128, (1, KVH, P, page, D),
                                           dtype=np.int8))
        ks = torch.from_numpy(rng.uniform(0.005, 0.025, (1, P, KVH, 1))
                              .astype(np.float32))
        vs = torch.from_numpy(rng.uniform(0.005, 0.025, (1, P, KVH, 1))
                              .astype(np.float32))
    else:
        kp = torch.from_numpy(rng.standard_normal((1, KVH, P, page, D),
                                                  np.float32)).bfloat16()
        vp = torch.from_numpy(rng.standard_normal((1, KVH, P, page, D),
                                                  np.float32)).bfloat16()
    meta = [torch.tensor(c, dtype=torch.int32) for c in zip(*rows)]
    want = trpa.ragged_paged_attention_plain(
        q, kn, vn, kp, vp, 0, *meta, bt, k_scales=ks, v_scales=vs)
    got = _emulate(q, kn, vn, kp[0], vp[0],
                   None if ks is None else ks[0, :, :, 0],
                   None if vs is None else vs[0, :, :, 0], rows, bt, page,
                   cluster)
    err = (got - want).abs().max().item()
    assert err <= 1e-4, err
    assert not got[at:].any()


# ---------------------------------------------------------------------------
# K7/K8's DECODE projections and K12's split-precision scan
# ---------------------------------------------------------------------------

# (K, columns, SwiGLU) of the four projections of one layer: LLAMA3_8B,
# and a narrow layer with head_dim 128 (the on-card tests' _WIDE).
_DECODE_SHAPES = {
    "8b": [(4096, 6144, False), (4096, 4096, False), (4096, 28672, True),
           (14336, 4096, False)],
    "wide": [(1024, 1536, False), (1024, 1024, False), (1024, 4096, True),
             (2048, 1024, False)],
}


def _decode_shares(plan):
    """The [start, end) units of each CTA of a DECODE plan, as the kernel
    cuts them (csrc/fused_layer.cuh unit_start), in CTA order."""
    U, G = plan["units"], plan["grid"]
    return [(i * U // G, (i + 1) * U // G) for i in range(G)]


@pytest.mark.parametrize("shape", sorted(_DECODE_SHAPES))
def test_decode_plan_covers_every_tile_and_k_step_once(shape):
    """For every token count the route takes (1-64): the CTAs' shares
    partition the (column tile, 64-K step) units in order, their sizes
    differ by at most one unit (the balance across SMs), the two
    warpgroups' 128-column boxes cover every output column of the tiles
    once, and the ring fits beside the SwiGLU exchange."""
    for K, cols, swiglu in _DECODE_SHAPES[shape]:
        for rows in range(1, tfd.DECODE_MAX_ROWS + 1):
            plan = tfd.decode_plan(rows, K, cols, 132)
            assert plan["nt"] % 8 == 0 and rows <= plan["nt"] < rows + 8
            assert plan["grid"] == min(132, plan["units"])
            seen = np.zeros(plan["units"], dtype=np.int64)
            sizes = []
            shares = _decode_shares(plan)
            for lo, hi in shares:
                seen[lo:hi] += 1
                sizes.append(hi - lo)
            assert (seen == 1).all()
            assert shares[0][0] == 0
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
            assert plan["units"] == plan["tiles"] * plan["ksteps"] \
                and plan["ksteps"] * 64 == K
            assert 2 <= plan["stages"] and plan["smem"] <= tfd._WGMMA_SMEM
        # The boxes of the two warpgroups over the tiles: every column once.
        cover = np.zeros(cols, dtype=np.int64)
        M = cols // 2
        for t in range(plan["tiles"]):
            for w in range(2):
                c = w * M + 128 * t if swiglu else 256 * t + 128 * w
                cover[c:c + 128] += 1
        assert (cover == 1).all()


def test_decode_route_is_taken_by_decode_widths(monkeypatch):
    monkeypatch.setattr(tfd, "_sm_count", lambda _i: 132)
    dev = torch.device("cpu")
    q8 = {"q": torch.zeros((256, 512), dtype=torch.int8),
          "scale": torch.ones((1, 512))}
    for rows in (1, 48, 64):
        pj, n = tfd._proj("t", [q8], 256, rows, torch.bfloat16, dev)
        plan = tfd.decode_plan(rows, 256, 512, 132)
        assert (pj.route, pj.nw, pj.splits, pj.stages) == (
            tfd._DECODE, plan["nt"], plan["grid"], plan["stages"])
        assert n == plan["part_floats"]
    # 65 tokens, bf16 weights, or a 128-column projection: the WGMMA route.
    assert tfd._proj("t", [q8], 256, 65, torch.bfloat16, dev)[0].route \
        == tfd._WGMMA
    wb = torch.zeros((256, 512), dtype=torch.bfloat16)
    assert tfd._proj("t", [wb], 256, 8, torch.bfloat16, dev)[0].route \
        == tfd._WGMMA
    q128 = {"q": torch.zeros((256, 128), dtype=torch.int8),
            "scale": torch.ones((1, 128))}
    assert tfd._proj("t", [q128], 256, 8, torch.bfloat16, dev)[0].route \
        == tfd._WGMMA


# (B, S, H, P, N, B/C bytes): one MAMBA2_2_7B layer, bench.py's
# _measure_ssd, and tiny shapes (a partial block, N padded, P 16).
_K12_SHAPES = [(2, 2048, 80, 64, 128, 2), (4, 4096, 8, 64, 128, 4),
               (2, 100, 3, 16, 8, 4), (1, 192, 2, 32, 24, 2),
               (1, 64, 1, 16, 256, 2)]


@pytest.mark.parametrize("shape", _K12_SHAPES)
def test_k12_plan_covers_every_output_once(shape):
    """K12's grid and warps, mirrored: CTA (slice, head, batch) owns
    columns [slice * p_tile, + p_tile) of its head, its warp w the y rows
    16 (w & 1) + 0..15 of every 32-position block and columns 8 (w >> 1)
    + 0..7 of the slice, and the state rows 16 MT (w & 1) + 0..16 MT - 1;
    every (batch, head, column, position) and every state entry is owned
    once.  Shared memory within the H100's 227 KB; the 2.7B layer's 320
    CTAs run in one wave."""
    from ray_tpu_torch.ops import mamba_ssd as tssd

    B, S, H, P, N, bc = shape
    plan = tssd.ssd_plan(B, H, P, N, bc, 132)
    pt, np_ = plan["p_tile"], plan["np"]
    gx, gy, gz = plan["grid"]
    assert (gx, gy, gz) == (P // pt, H, B) and plan["ctas"] == gx * gy * gz
    assert plan["threads"] == 8 * pt and plan["smem"] <= 227 * 1024
    assert np_ >= N and np_ % 32 == 0
    warps = pt // 4
    cols = np.zeros((B, H, P), dtype=np.int64)
    state = np.zeros((B, H, np_, P), dtype=np.int64)
    rows = np.zeros(tssd.BLOCK_T, dtype=np.int64)
    for b in range(gz):
        for h in range(gy):
            for sx in range(gx):
                for w in range(warps):
                    c0 = sx * pt + 8 * (w >> 1)
                    cols[b, h, c0:c0 + 8] += 1
                    n0 = np_ // 2 * (w & 1)
                    state[b, h, n0:n0 + np_ // 2, c0:c0 + 8] += 1
    for w in range(2):  # one column pair of warps covers the block's rows
        rows[16 * w:16 * w + 16] += 1
    assert (cols == 2).all()    # two warps (rows 0-15, 16-31) a column
    assert (rows == 1).all() and (state == 1).all()
    nblk = -(-S // tssd.BLOCK_T)
    assert nblk * tssd.BLOCK_T >= S > (nblk - 1) * tssd.BLOCK_T
    if shape[:5] == (2, 2048, 80, 64, 128):
        assert (pt, plan["ctas"], plan["per_sm"], plan["waves"]) \
            == (32, 320, 3, 1)


def _tf32(x):
    """Round to TF32 as cvt.rna does (nearest, ties away from zero)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """TF32 as the mma reads an f32 register: the low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm(a, b, a_exact, b_exact, passes=3):
    """a @ b on the tensor cores in split precision: hi.hi + hi.lo +
    lo.hi (an exact operand has no lo), products exact, summed in f64
    and rounded to f32; passes=1 is one plain TF32 product."""
    ah = a if a_exact else _tf32(a)
    bh = b if b_exact else _tf32(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        if not a_exact:
            out += _tf32_trunc(a - ah).double() @ bh.double()
        if not b_exact:
            out += ah.double() @ _tf32_trunc(b - bh).double()
    return out.float()


def _k12_emulate(x, log_a, Bm, Cm, passes=3):
    """K12's block walk (csrc/mamba_ssd.cu) in plain PyTorch: blocks of
    32 positions (zeros past S), C.B^T masked and scaled into the decay
    matrix, (G o L).x and C.state and the state update in split
    precision; B and C exact when they are bf16."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    T = 32
    ex = Bm.dtype == torch.bfloat16
    Sp = -(-S // T) * T
    pad = (0, 0, 0, 0, 0, Sp - S)
    xf = torch.nn.functional.pad(x.float(), pad)
    la = torch.nn.functional.pad(log_a.float(), (0, 0, 0, Sp - S))
    Bf = torch.nn.functional.pad(Bm.float(), (0, 0, 0, Sp - S))
    Cf = torch.nn.functional.pad(Cm.float(), (0, 0, 0, Sp - S))
    lower = torch.tril(torch.ones(T, T, dtype=torch.bool))
    y = torch.zeros((B, Sp, H, P))
    state = torch.zeros((B, H, N, P))
    for t0 in range(0, Sp, T):
        sl = slice(t0, t0 + T)
        cum = torch.cumsum(la[:, sl], dim=1)                  # [B, T, H]
        total = cum[:, -1]
        G = _mm(Cf[:, sl], Bf[:, sl].transpose(1, 2), ex, ex, passes)
        for h in range(H):
            c = cum[:, :, h]
            L = torch.exp(torch.where(lower, c[:, :, None] - c[:, None, :],
                                      torch.full_like(G, -torch.inf)))
            W = torch.where(lower, G * L, torch.zeros_like(G))
            xh = xf[:, sl, h]                                  # [B, T, P]
            yi = _mm(W, xh, False, False, passes)
            ys = _mm(Cf[:, sl], state[:, h], ex, False, passes)
            y[:, sl, h] = yi + torch.exp(c)[..., None] * ys
            dte = torch.exp(total[:, h, None] - c)            # [B, T]
            state[:, h] = torch.exp(total[:, h])[:, None, None] \
                * state[:, h] + _mm(Bf[:, sl].transpose(1, 2),
                                    dte[..., None] * xh, ex, False, passes)
    return y[:, :S]


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
def test_k12_split_precision_matches_plain(bc_dtype):
    """The kernel's arithmetic (3xTF32 products, TF32 by mantissa masking)
    within K12_TOL = 2e-4 of ssd_pallas_plain relative to 1 + |y|, and
    far closer than one TF32 pass, which keeps about three digits."""
    from ray_tpu_torch.ops import mamba_ssd as tssd

    rng = np.random.default_rng(12)
    B, S, H, P, N = 1, 100, 2, 16, 32
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    log_a = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H)).astype(np.float32)))
    Bm = (torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
          * 0.3).to(bc_dtype)
    Cm = (torch.from_numpy(rng.standard_normal((B, S, N)).astype(np.float32))
          * 0.3).to(bc_dtype)
    want = tssd.ssd_pallas_plain(x, log_a, Bm, Cm, 20)

    def err(got):
        return ((got - want).abs() / (1 + want.abs())).max().item()

    split = err(_k12_emulate(x, log_a, Bm, Cm))
    one_pass = err(_k12_emulate(x, log_a, Bm, Cm, passes=1))
    assert split <= 2e-4
    assert one_pass > 10 * split


def test_k12_state_rows_above_a_cta_sum_by_slice():
    """N above 256 is more than a CTA holds: ssd_forward launches K12 once
    per slice of 256 state rows and sums the slices' y in order.  The
    kernel's arithmetic over the slices of N = 264 (256 + 8) is within
    K12_TOL = 2e-4 of ssd_pallas_plain over all of N, relative to 1 +
    |y|; no single launch is planned for it."""
    from ray_tpu_torch.ops import mamba_ssd as tssd

    rng = np.random.default_rng(264)
    B, S, H, P, N = 1, 64, 1, 16, 264
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    log_a = -torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H)).astype(np.float32)))
    Bm, Cm = (torch.from_numpy(rng.standard_normal((B, S, N)).astype(
        np.float32) * 0.1).to(torch.bfloat16) for _ in range(2))
    want = tssd.ssd_pallas_plain(x, log_a, Bm, Cm, 64)
    got = _k12_emulate(x, log_a, Bm[..., :256], Cm[..., :256]) \
        + _k12_emulate(x, log_a, Bm[..., 256:], Cm[..., 256:])
    assert ((got - want).abs() / (1 + want.abs())).max().item() <= 2e-4
    with pytest.raises(ValueError, match="at most 256"):
        tssd.ssd_plan(B, H, P, N, 2, 132)


# ---------------------------------------------------------------------------
# K1 and K13 (csrc/paged_decode.cu): the Hopper route's plan and the fixed
# order of the q·k dot that both routes share with the plain versions
# ---------------------------------------------------------------------------

from ray_tpu_torch.ops import paged_attention as tpa  # noqa: E402


@pytest.mark.parametrize("B,KVH,qpg,D,page,maxp,esize,partial,takes", [
    (8, 8, 4, 128, 64, 16, 2, True, True),     # K1 at the 8B decode shape
    (8, 8, 4, 128, 64, 16, 1, True, True),     # its int8 pools
    (8, 8, 4, 128, 64, 16, 2, False, True),    # K13
    (6, 2, 3, 64, 16, 5, 4, False, True),      # groups of 3, 5, 7 are padded
    (6, 2, 5, 128, 64, 40, 2, False, True),
    (1, 1, 7, 32, 16, 1, 4, True, True),       # head_dim 32
    (6, 2, 9, 64, 16, 5, 2, True, False),      # a group above 8 rows
    (6, 2, 2, 48, 16, 5, 2, True, False),      # head_dim 48, 256: page walk
    (6, 2, 1, 256, 16, 5, 2, True, False),
    (2, 2, 8, 128, 64, 512, 4, True, False),   # scores past shared memory
    (2, 2, 8, 128, 16, 512, 2, True, True),
])
def test_paged_decode_plan(monkeypatch, B, KVH, qpg, D, page, maxp, esize,
                           partial, takes):
    """The plan covers every page with at most 8 CTAs a cluster and a ring
    of 2 to 16 stages within the H100's shared memory, or is None exactly
    for the shapes the Hopper route does not take."""
    monkeypatch.setattr(tpa, "_sm_count", lambda _i: 132)
    plan = tpa.hopper_decode_plan(B, KVH, qpg, D, page, maxp, esize, partial,
                                  torch.device("cpu"))
    assert (plan is not None) == takes
    if plan is None:
        return
    csize, ppc, stages = plan
    assert 1 <= csize <= 8 and csize * ppc >= maxp > (csize - 1) * ppc
    assert 2 <= stages <= 16
    qpg_p = next(n for n in (1, 2, 4, 8) if n >= qpg)
    smem = (max(stages * page * D * esize, 16 * qpg_p * D)
            + 4 * (qpg_p * ppc * page + csize * qpg_p * D
                   + (2 * ppc * qpg_p if partial else 0)))
    assert smem + 4096 <= 227 * 1024


def _dot_serial(a: np.ndarray, b: np.ndarray) -> np.float32:
    """csrc/paged_decode.cu's dot_fixed, one f32 operation at a time."""
    n = len(a) // 8
    part = []
    for c in range(n):
        s = np.float32(a[8 * c] * b[8 * c])
        for i in range(1, 8):
            s = np.float32(s + np.float32(a[8 * c + i] * b[8 * c + i]))
        part.append(s)
    while n > 1:
        h = n // 2
        for i in range(h):
            part[i] = np.float32(part[i] + part[i + h])
        if n % 2:
            part[h] = part[2 * h]
        n -= h
    return part[0]


@pytest.mark.parametrize("D", [8, 16, 24, 36, 48, 64, 72, 128, 256])
def test_fixed_order_dot_is_the_kernels_order(D):
    """The plain versions' q·k (``_fixed_order_dot``) equals, bit for bit,
    the kernels' fixed order: eight products left to right, then pairs of
    partial sums i, i + n/2 with an odd one carried (the halving exchanges
    of the Hopper route where D/8 is a power of two); a D off a multiple
    of 8 is zero-padded, as the page-walk route pads q and k in shared
    memory."""
    rng = np.random.default_rng(D)
    q = rng.standard_normal((2, 3, D)).astype(np.float32)
    k = rng.standard_normal((2, 5, D)).astype(np.float32)
    got = tpa._fixed_order_dot(torch.from_numpy(q)[None, :, :, :],
                               torch.from_numpy(k)[None]).numpy()[0]
    for g in range(2):
        for i in range(3):
            for t in range(5):
                pad = (0, -D % 8)
                assert got[g, i, t] == _dot_serial(np.pad(q[g, i], pad),
                                                   np.pad(k[g, t], pad))


@pytest.mark.parametrize("qpg,D,page,rows,split", [
    (4, 128, 64, 4, 0),      # the 8B shape: one CTA a (slot, kv head)
    (16, 128, 64, 8, 0),     # a group of 16: two CTAs of 8 rows
    (9, 36, 16, 9, 0),       # 1024 // 36 = 28 rows: the whole group
    (64, 48, 16, 21, 0),
    (2, 256, 64, 2, 0),
    (1, 256, 128, 1, 1),     # k, then v, into one buffer
    (4, 1, 16, 4, 0),
])
def test_walk_plan(qpg, D, page, rows, split):
    """K1's and K13's page-walk plan: at most 1024 / D rows a CTA (its
    accumulators), k and v staged together where they fit the H100's
    shared memory, else one after the other."""
    assert tpa.walk_plan("k", qpg, D, page) == (rows, split)
    assert rows * D <= 1024 and 1 <= rows <= qpg
    Dp = -(-D // 8) * 8
    smem = 4 * (page * (Dp + 4) + (0 if split else page * D) + rows * Dp
                + rows * page + 3 * rows)
    assert smem <= 227 * 1024


def test_walk_plan_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="unsupported D=257"):
        tpa.walk_plan("k", 4, 257, 16)
    with pytest.raises(ValueError, match="over the H100's 227 KB"):
        tpa.walk_plan("k", 1, 256, 256)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k13_walk_arithmetic_matches_plain(dtype):
    """K13's page walk, emulated one page at a time as page_walk_kernel
    runs it: p against a running power of two M (raised to the ceiling of
    y = s·log2(e) page by page), the sums so far scaled by 2^(M_old - M).
    Every p it rounds, taken to the slot's final M, equals the plain
    version's rounded p bit for bit (powers of two rescale exactly), and
    the output is within one ulp of the plain version's in q's dtype."""
    rng = np.random.default_rng(3)
    B, H, D, page, maxp = 2, 3, 36, 8, 3
    q = torch.from_numpy(rng.standard_normal((B, H, D)) * 3).to(dtype)
    k = torch.from_numpy(rng.standard_normal((1, 7, page, D))).to(dtype)
    v = torch.from_numpy(rng.standard_normal((1, 7, page, D))).to(dtype)
    bt = torch.tensor([[4, 1, 6], [2, 0, 5]], dtype=torch.int32)
    lengths = torch.tensor([21, 9], dtype=torch.int32)
    want = tpa.paged_decode_attention_plain(q, k, v, bt, lengths,
                                            soft_cap=20.0)
    scale = torch.tensor(D ** -0.5, dtype=torch.float32)
    for b in range(B):
        n = int(lengths[b])
        ks = k[0, bt[b].long()].reshape(-1, D)[:n]
        vs = v[0, bt[b].long()].reshape(-1, D)[:n]
        s = tpa._fixed_order_dot(q[b][None, None], ks[None, None])[0, 0]
        s = torch.tanh((s * scale / 20.0).double()).float() * 20.0
        y = s.double() * tpa._LOG2E
        final = torch.exp2(y - torch.ceil(y.amax(-1, keepdim=True)))
        want_p = final.float().to(dtype).float()
        M = torch.full((H, 1), float("-inf"), dtype=torch.float64)
        acc = torch.zeros((H, D))
        l = torch.zeros((H, 1))
        for j in range(-(-n // page)):
            cols = slice(j * page, min((j + 1) * page, n))
            m_new = torch.maximum(M, torch.ceil(y[:, cols].amax(-1, True)))
            corr = torch.exp2(M - m_new).float()
            p = torch.exp2(y[:, cols] - m_new).float()
            p_r = p.to(dtype).float()
            # This page's rounded p at the final M: the plain version's.
            to_final = torch.exp2(m_new - torch.ceil(y.amax(-1, True)))
            assert torch.equal(p_r * to_final.float(), want_p[:, cols])
            acc = acc * corr + p_r @ vs[cols].float()
            l = l * corr + p.sum(-1, keepdim=True)
            M = m_new
        got = (acc / l).to(dtype).float()
        err = (got - want[b].float()).abs()
        assert (err <= 2 ** -7 * want[b].float().abs() + 1e-6).all()
