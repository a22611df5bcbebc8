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
