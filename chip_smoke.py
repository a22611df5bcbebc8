#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out smoke_out/chip_smoke.json]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. device: torch/CUDA versions, the card's name and power limit;
2. build: every kernel of ``ray_tpu_torch/csrc`` through ``nvcc``
   (one process per source, all started together);
3. kernels at LLAMA3_8B shapes (bf16, H=32, KVH=8, D=128, page 64,
   L=32): K1 paged decode partials, K2 paged append, K9f flash forward,
   each held against its plain PyTorch version on the same inputs and
   timed beside it, beside one PyTorch library call computing the same
   function (a yardstick the port never calls), and beside its bound;
   K4 ragged paged attention and K5 ragged append at the same shapes
   (seven decode rows with pasts of 300-1500 tokens beside one
   256-token prompt chunk at position 512: T = 264);
4. path parity: a tiny f32 Llama through the port's LLMEngine on the
   card (kernels) and on the CPU (plain versions) — identical greedy
   streams, with a prompt long enough for a flash-attention bucket;
   then the same for the ragged engine (prefill_chunk 64, prompts of
   several chunks);
5. the bucketed path at full width: LLAMA3_8B in bf16 (random weights
   from a seeded generator on the card, made once for phases 5 and 6)
   served by the port's LLMEngine, four concurrent requests; every
   launch counter is set to 0 just before, and K1, K2 and K9f must all
   have risen just after;
6. the ragged path at full width: the same weights served by the ragged
   engine (prefill_chunk 256, token budget 264), prompts of 17, 300, 700
   and 1500 tokens and a fifth of 1000 submitted after the first stream's
   first token, so its chunks ride beside live decode rows; counters set
   to 0 just before, and K4 must run 32 times and K5 once per ragged
   step, with at least one step packing decode rows and prompt tokens
   together.  One mixed ragged step is then timed alone (host, and
   device from a CUDA-graph replay).

The last three lines of standard output are the kernel table (K1, K2,
K9f, K4, K5) as one JSON object, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Details go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def time_ms(torch, fn, n: int = 10, blocks: int = 5) -> float:
    """Median over ``blocks`` of the mean time of ``n`` back-to-back
    calls ``fn(i)``, from CUDA events.  Each block starts behind a
    device-side sleep, so the host has queued the calls before the
    first one runs and host launch gaps do not count."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    means = []
    for blk in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for i in range(n):
            fn(blk * n + i)
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / n)
    return statistics.median(means)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase_k1(torch, F, tpa, report):
    L, B, H, KVH, D, page, maxp = 32, 8, 32, 8, 128, 64, 16
    P = B * maxp + 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    q = torch.randn((B, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    lens_list = [0, 1, 63, 64, 65, 1000, 517, 230]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(2))
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32)
    for b, n in enumerate(lens_list):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live].to(torch.int32)
    bt = bt.to(dev)

    worst = {"out": 0.0, "m": 0.0, "l_rel": 0.0}
    for layer in range(L):
        acc, m, l = tpa.paged_decode_attention_partial(q, k, v, layer, bt,
                                                       lengths)
        acc_p, m_p, l_p = tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths)
        live = lengths > 0
        out = (acc / l.clamp(min=1e-30))[live]
        out_p = (acc_p / l_p.clamp(min=1e-30))[live]
        worst["out"] = max(worst["out"], (out - out_p).abs().max().item())
        worst["m"] = max(worst["m"], (m - m_p).abs().max().item())
        worst["l_rel"] = max(worst["l_rel"],
                             ((l - l_p).abs() / l_p.clamp(min=1)).max().item())
        if (m[~live] != -1e30).any() or (l[~live] != 0).any() \
                or (acc[~live] != 0).any():
            raise AssertionError("K1: an empty slot must give acc=0, "
                                 "m=-1e30, l=0")
    # Same f32 arithmetic on exactly converted bf16 inputs: only the
    # summation order differs.
    tol = {"out": 1e-3, "m": 1e-3, "l_rel": 1e-4}
    if any(worst[key] > tol[key] for key in tol):
        raise AssertionError(f"K1 disagrees with its plain version: {worst} "
                             f"(tolerance {tol})")

    ms = time_ms(torch, lambda i: tpa.paged_decode_attention_partial(
        q, k, v, i % L, bt, lengths))
    plain_ms = time_ms(torch, lambda i: tpa.paged_decode_attention_partial_plain(
        q, k, v, i % L, bt, lengths), n=4, blocks=3)
    # Library yardstick: SDPA over the gathered dense k/v of each layer.
    T = maxp * page
    kd = k[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, KVH, T, D)
    vd = v[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, KVH, T, D)
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    try:
        F.scaled_dot_product_attention(q4, kd[0], vd[0], attn_mask=mask,
                                       enable_gqa=True)
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd[i % L], vd[i % L], attn_mask=mask, enable_gqa=True)
    except TypeError:
        kd = kd.repeat_interleave(H // KVH, dim=2)
        vd = vd.repeat_interleave(H // KVH, dim=2)
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd[i % L], vd[i % L], attn_mask=mask)
    library_ms = time_ms(torch, lib)
    tokens = sum(lens_list)
    nbytes = (B * H * D * 2 + tokens * KVH * D * 2 * 2 + bt.numel() * 4
              + B * 4 + B * H * D * 4 + 2 * B * H * 4)
    flops = 4 * tokens * H * D
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    report["K1"] = {
        "name": "paged_decode_attention_partial", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_decode.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:263",
        "max_abs_err": max(worst["out"], worst["m"]),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={B} H={H} KVH={KVH} D={D} page={page} bf16, lengths "
                 f"{lens_list}, layer cycling over L={L}",
        "errors": worst,
    }
    log(f"K1 paged_decode_attention_partial: err {worst}  kernel {ms:.4f} ms"
        f"  plain {plain_ms:.4f} ms  SDPA {library_ms:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by})")


def kernel_phase_k2(torch, tpa, report):
    L, B, KVH, D, page = 32, 8, 8, 128, 64
    P = 8 * 16 + 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    k_new = torch.randn((L, B, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    # Slot 3 is inactive: its row goes to the scratch page P - 1.
    pids = torch.tensor([5, 17, 40, P - 1, 77, 2, 128 - 1, 64],
                        dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 1, 63, 9, 32, 17, 5, 62], dtype=torch.int32,
                        device=dev)
    k1, v1 = k.clone(), v.clone()
    tpa.paged_append(k1, v1, k_new, v_new, pids, offs)
    k2, v2 = k.clone(), v.clone()
    tpa.paged_append_plain(k2, v2, k_new, v_new, pids, offs)
    err = max((k1.float() - k2.float()).abs().max().item(),
              (v1.float() - v2.float()).abs().max().item())
    if err != 0.0:  # a copy: exact
        raise AssertionError(f"K2 disagrees with its plain version: {err}")
    changed = (k1 != k).any(dim=-1).nonzero()
    if changed.shape[0] != L * KVH * B:
        raise AssertionError(f"K2 wrote {changed.shape[0]} rows, want "
                             f"{L * KVH * B}")
    del k1, v1, k2, v2

    ms = time_ms(torch, lambda i: tpa.paged_append(k, v, k_new, v_new, pids,
                                                    offs))
    plain_ms = time_ms(torch, lambda i: tpa.paged_append_plain(
        k, v, k_new, v_new, pids, offs))
    kf = k.view(L, KVH, P * page, D)
    vf = v.view(L, KVH, P * page, D)
    flat = (pids.long().clamp(max=P - 1) * page + offs.long())
    kn = k_new.permute(0, 2, 1, 3).contiguous()
    vn = v_new.permute(0, 2, 1, 3).contiguous()

    def lib(i):
        kf.index_copy_(2, flat, kn)
        vf.index_copy_(2, flat, vn)

    library_ms = time_ms(torch, lib)
    nbytes = 2 * (2 * L * B * KVH * D * 2) + 2 * B * 4
    b_ms, b_by = bound(nbytes, 0, BF16_FLOPS)
    report["K2"] = {
        "name": "paged_append", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_append.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:515",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"L={L} B={B} KVH={KVH} D={D} page={page} bf16, one "
                 "inactive slot",
    }
    log(f"K2 paged_append: err {err}  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  index_copy_ {library_ms:.4f} ms  bound "
        f"{b_ms:.5f} ms ({b_by})")


def kernel_phase_k9(torch, F, tfa, report):
    B, H, KVH, D = 2, 32, 8, 128
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = {}
    for S in (256, 1024):
        q = torch.randn((B, S, H, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((B, S, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((B, S, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        o, lse = tfa.flash_forward(q, k, v, causal=True)
        o_p, lse_p = tfa.flash_forward_plain(q, k, v, causal=True)
        err = (o.float() - o_p.float()).abs().max().item()
        rel = ((o.float() - o_p.float()).abs()
               / (1 + o_p.float().abs())).max().item()
        lse_err = (lse - lse_p).abs().max().item()
        # Both round an f32 result to bf16: at most about one bf16 ulp
        # (2^-8 relative) apart; lse stays f32.
        if rel > 1e-2 or lse_err > 1e-3:
            raise AssertionError(f"K9f disagrees with its plain version at "
                                 f"S={S}: abs {err}, rel {rel}, lse "
                                 f"{lse_err}")
        ms = time_ms(torch, lambda i: tfa.flash_forward(q, k, v, True))
        plain_ms = time_ms(torch, lambda i: tfa.flash_forward_plain(
            q, k, v, True), n=4, blocks=3)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        try:
            F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
            lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=True, enable_gqa=True)
        except TypeError:
            kx = kt.repeat_interleave(H // KVH, dim=1)
            vx = vt.repeat_interleave(H // KVH, dim=1)
            lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qt, kx, vx, is_causal=True)
        library_ms = time_ms(torch, lib)
        flops = 4 * B * H * D * (S * (S + 1) // 2)
        nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 4 * B * H * S
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        rows[S] = {"max_abs_err": err, "max_rel_err": rel,
                   "lse_err": lse_err, "ms": ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": b_ms,
                   "bound_by": b_by,
                   "tflops": flops / (ms * 1e-3) / 1e12}
        log(f"K9f flash_forward S={S}: err {err:.3e} (rel {rel:.3e}, lse "
            f"{lse_err:.3e})  kernel {ms:.4f} ms ({rows[S]['tflops']:.1f} "
            f"TFLOP/s)  plain {plain_ms:.4f} ms  SDPA {library_ms:.4f} ms  "
            f"bound {b_ms:.4f} ms ({b_by})")
    top = rows[1024]
    report["K9f"] = {
        "name": "flash_forward", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:98",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "library_ms": top["library_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "shape": f"B={B} S=1024 H={H} KVH={KVH} D={D} causal bf16",
        "by_seq_len": rows,
    }


# The ragged row mix of phases 3 and 6: (start, len) per row, the first
# seven decode rows with long pasts, the last a 256-token prompt chunk,
# in the 8B engine's token budget (8 slots + a 256-token chunk).
RAGGED_ROWS = [(300, 1), (517, 1), (700, 1), (900, 1), (1100, 1), (1300, 1),
               (1500, 1), (512, 256)]
RAGGED_T = 8 + 256


def ragged_inputs(torch, L=32, H=32, KVH=8, D=128, page=64, maxp=32,
                  seed=7):
    """Pools, block tables and a flat buffer at LLAMA3_8B shapes for
    RAGGED_ROWS (row r owns slot r and shuffled pages)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    R = len(RAGGED_ROWS)
    P = R * maxp + 1
    T = RAGGED_T
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(seed))
    bt = torch.full((R, maxp), P - 1, dtype=torch.int32)
    offs, at = [], 0
    for r, (start, n) in enumerate(RAGGED_ROWS):
        live = -(-(start + n) // page)
        bt[r, :live] = perm[r * maxp: r * maxp + live].to(torch.int32)
        offs.append(at)
        at += n
    rows = [torch.tensor(a, dtype=torch.int32, device=dev) for a in (
        list(range(R)), [s for s, _ in RAGGED_ROWS],
        [n for _, n in RAGGED_ROWS], offs)]
    q = torch.randn((T, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    kn = torch.randn((T, KVH, D), generator=g, device=dev,
                     dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    return k, v, q, kn, vn, rows, bt.to(dev)


def kernel_phase_k4(torch, F, trpa, report):
    L, H, KVH, D = 32, 32, 8, 128
    k, v, q, kn, vn, rows, bt = ragged_inputs(torch)
    T = q.shape[0]
    err = 0.0
    covered = sum(n for _, n in RAGGED_ROWS)  # the buffer's tail is empty
    for layer in range(L):
        got = trpa.ragged_paged_attention(q, kn, vn, k, v, layer, *rows, bt)
        want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, layer,
                                                 *rows, bt)
        err = max(err, (got - want).abs().max().item())
        if got[covered:].any():
            raise AssertionError("K4: tokens no row covers must be zero")
    # f32 arithmetic on exactly converted bf16 inputs in both versions:
    # only the summation order differs.
    if err > 1e-3:
        raise AssertionError(f"K4 disagrees with its plain version: {err} "
                             "(tolerance 1e-3)")
    ms = time_ms(torch, lambda i: trpa.ragged_paged_attention(
        q, kn, vn, k, v, i % L, *rows, bt))
    plain_ms = time_ms(torch, lambda i: trpa.ragged_paged_attention_plain(
        q, kn, vn, k, v, i % L, *rows, bt), n=4, blocks=3)
    # Library yardstick: one SDPA over each row's pre-gathered, padded
    # dense k/v (pooled past then fresh keys) with a boolean causal mask.
    R = len(RAGGED_ROWS)
    page, maxp = k.shape[3], bt.shape[1]
    lq = max(n for _, n in RAGGED_ROWS)
    lk = max(s + n for s, n in RAGGED_ROWS)
    qd = torch.zeros((R, H, lq, D), dtype=q.dtype, device=q.device)
    kd = torch.zeros((L, R, KVH, lk, D), dtype=k.dtype, device=k.device)
    vd = torch.zeros_like(kd)
    mask = torch.zeros((R, 1, lq, lk), dtype=torch.bool, device=q.device)
    mask[:, :, :, 0] = True  # padded query rows see one key: no NaN
    at = 0
    for r, (start, n) in enumerate(RAGGED_ROWS):
        pages = bt[r, : maxp].long()
        past_k = k[:, :, pages].permute(0, 2, 3, 1, 4).reshape(
            L, maxp * page, KVH, D)[:, :start].permute(0, 2, 1, 3)
        past_v = v[:, :, pages].permute(0, 2, 3, 1, 4).reshape(
            L, maxp * page, KVH, D)[:, :start].permute(0, 2, 1, 3)
        kd[:, r, :, :start] = past_k
        vd[:, r, :, :start] = past_v
        kd[:, r, :, start:start + n] = kn[at:at + n].permute(1, 0, 2)
        vd[:, r, :, start:start + n] = vn[at:at + n].permute(1, 0, 2)
        qd[r, :, :n] = q[at:at + n].permute(1, 0, 2)
        i = torch.arange(n, device=q.device)
        mask[r, 0, :n] = (torch.arange(lk, device=q.device)[None, :]
                          <= start + i[:, None])
        at += n
    try:
        F.scaled_dot_product_attention(qd, kd[0], vd[0], attn_mask=mask,
                                       enable_gqa=True)
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qd, kd[i % L], vd[i % L], attn_mask=mask, enable_gqa=True)
    except TypeError:
        kx = kd.repeat_interleave(H // KVH, dim=2)
        vx = vd.repeat_interleave(H // KVH, dim=2)
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qd, kx[i % L], vx[i % L], attn_mask=mask)
    library_ms = time_ms(torch, lib)
    # Bytes: q, fresh k/v and the pooled past each read once, f32 out
    # written once; operations: q.k and p.v over every attended key.
    past = sum(s for s, _ in RAGGED_ROWS)
    attended = sum(n * s + n * (n + 1) // 2 for s, n in RAGGED_ROWS)
    nbytes = (T * H * D * 2 + 2 * T * KVH * D * 2 + 2 * past * KVH * D * 2
              + T * H * D * 4 + bt.numel() * 4 + 4 * R * 4)
    flops = 4 * attended * H * D
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    report["K4"] = {
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "ray_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "ray_tpu/ops/ragged_paged_attention.py:303",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"T={T} H={H} KVH={KVH} D={D} page={page} bf16, rows "
                 f"(start, len) {RAGGED_ROWS}, layer cycling over L={L}",
        "bound_bytes": nbytes, "bound_flops": flops,
    }
    log(f"K4 ragged_paged_attention: err {err:.3e}  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  SDPA {library_ms:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by})")


def kernel_phase_k5(torch, trpa, report):
    k, v, _q, kn, _vn, rows, bt = ragged_inputs(torch, seed=8)
    L, KVH, P, page, D = k.shape
    T = kn.shape[0]
    g = torch.Generator(device="cuda").manual_seed(9)
    k_new = torch.randn((L, T, KVH, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    k1, v1 = k.clone(), v.clone()
    trpa.ragged_paged_append(k1, v1, k_new, v_new, *rows, bt)
    k2, v2 = k.clone(), v.clone()
    trpa.ragged_paged_append_plain(k2, v2, k_new, v_new, *rows, bt)
    # A copy: exact on every page but the scratch page.
    err = max((k1[:, :, :-1].float() - k2[:, :, :-1].float()).abs().max()
              .item(), (v1[:, :, :-1].float() - v2[:, :, :-1].float()).abs()
              .max().item())
    if err != 0.0:
        raise AssertionError(f"K5 disagrees with its plain version: {err}")
    covered = sum(n for _, n in RAGGED_ROWS)
    changed = int((k1 != k).any(dim=-1).sum())
    if changed != L * KVH * covered:
        raise AssertionError(f"K5 wrote {changed} rows, want "
                             f"{L * KVH * covered}")
    del k1, v1, k2, v2
    ms = time_ms(torch, lambda i: trpa.ragged_paged_append(
        k, v, k_new, v_new, *rows, bt))
    plain_ms = time_ms(torch, lambda i: trpa.ragged_paged_append_plain(
        k, v, k_new, v_new, *rows, bt))
    # Library yardstick: index_put_ of the same rows at precomputed flat
    # positions, once per pool.
    slots, starts, lens, offs = (t.tolist() for t in rows)
    flat = torch.empty(covered, dtype=torch.long)
    for s, st, n, o in zip(slots, starts, lens, offs):
        pos = torch.arange(st, st + n)
        flat[o:o + n] = bt[s].cpu().long()[pos // page] * page + pos % page
    flat = flat.cuda()
    kf = k.view(L, KVH, P * page, D)
    vf = v.view(L, KVH, P * page, D)
    kn_t = k_new[:, :covered].permute(0, 2, 1, 3).contiguous()
    vn_t = v_new[:, :covered].permute(0, 2, 1, 3).contiguous()

    def lib(i):
        kf[:, :, flat] = kn_t
        vf[:, :, flat] = vn_t

    library_ms = time_ms(torch, lib)
    nbytes = 2 * (2 * L * covered * KVH * D * 2) + 4 * len(slots) * 4 \
        + bt.numel() * 4
    b_ms, b_by = bound(nbytes, 0, BF16_FLOPS)
    report["K5"] = {
        "name": "ragged_paged_append", "route": "cuda",
        "source": "ray_tpu_torch/csrc/ragged_append.cu",
        "replaces": "ray_tpu/ops/ragged_paged_attention.py:506",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"L={L} T={T} KVH={KVH} D={D} page={page} bf16, rows "
                 f"{RAGGED_ROWS}",
    }
    log(f"K5 ragged_paged_append: err {err}  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  index_put_ {library_ms:.4f} ms  bound "
        f"{b_ms:.5f} ms ({b_by})")


def parity_phase(torch, llama, eng_mod):
    """Tiny f32 Llama: the engine on the card against the engine on the
    CPU, same weights, identical greedy streams."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.ops import flash_attention as tfa

    cfg = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=512,
                              dtype=torch.float32)
    cpu_params = llama.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu", dtype=torch.float32)

    ecfg = eng_mod.EngineConfig(max_slots=4, max_seq_len=512, page_size=64,
                                decode_chunk=8, min_prefill_bucket=32,
                                max_new_tokens_default=16)
    rng = np.random.default_rng(5)
    # 130 and 300 tokens: buckets 256 and 512 take the flash kernel.
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 40, 130, 300)]
    streams = {}
    flash_before = tfa.flash_forward.launches
    for device, params in (("cuda", _to(cpu_params, "cuda")),
                           ("cpu", cpu_params)):
        eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg),
                                ecfg, device=device)
        try:
            streams[device] = [s.result(timeout_s=300)
                               for s in [eng.submit(p) for p in prompts]]
        finally:
            eng.shutdown()
    if tfa.flash_forward.launches == flash_before:
        raise AssertionError("parity phase: no prefill bucket ran K9f")
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"greedy streams differ: cuda "
                             f"{streams['cuda']} vs cpu {streams['cpu']}")
    log(f"parity: LLAMA_TINY f32 (max_seq_len 512), {len(prompts)} prompts "
        f"of {[len(p) for p in prompts]} tokens: cuda == cpu greedy streams "
        f"({sum(len(s) for s in streams['cuda'])} tokens)")
    return {"prompts": [len(p) for p in prompts],
            "tokens": sum(len(s) for s in streams["cuda"])}


def ragged_parity_phase(torch, llama, eng_mod, trpa):
    """The ragged engine (K4, K5) on the card against the same engine on
    the CPU (plain versions): tiny f32 Llama, prompts of several 64-token
    chunks, identical greedy streams."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=512,
                              dtype=torch.float32)
    cpu_params = llama.init_params(torch.Generator().manual_seed(1), cfg,
                                   device="cpu", dtype=torch.float32)
    ecfg = eng_mod.EngineConfig(max_slots=4, max_seq_len=512, page_size=64,
                                decode_chunk=8, max_new_tokens_default=16,
                                ragged_batching=True, prefill_chunk=64)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 70, 150, 300, 33)]
    streams, launches = {}, {}
    for device in ("cuda", "cpu"):
        params = _to(cpu_params, device)
        before = (trpa.ragged_paged_attention.launches,
                  trpa.ragged_paged_append.launches)
        eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg),
                                ecfg, device=device)
        try:
            streams[device] = [s.result(timeout_s=300)
                               for s in [eng.submit(p) for p in prompts]]
            mixed = eng.stats()["mixed_steps"]
        finally:
            eng.shutdown()
        launches[device] = (trpa.ragged_paged_attention.launches - before[0],
                            trpa.ragged_paged_append.launches - before[1])
    if min(launches["cuda"]) == 0 or max(launches["cpu"]) != 0:
        raise AssertionError(f"ragged parity: kernel launches {launches}")
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"ragged greedy streams differ: cuda "
                             f"{streams['cuda']} vs cpu {streams['cpu']}")
    log(f"ragged parity: LLAMA_TINY f32, {len(prompts)} prompts of "
        f"{[len(p) for p in prompts]} tokens, chunk 64: cuda == cpu greedy "
        f"streams ({sum(len(s) for s in streams['cuda'])} tokens, K4/K5 "
        f"launches {launches['cuda']}, {mixed} mixed steps on the cpu run)")
    return {"prompts": [len(p) for p in prompts],
            "tokens": sum(len(s) for s in streams["cuda"]),
            "launches": launches["cuda"]}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def decode_step_breakdown(torch, llama, params, cfg, lens, page=64,
                          slots=8, maxp=16):
    """One 8B decode step outside the engine (timed as ``time_step``
    says), at this run's live slots (the four prompts, 16 tokens into
    their decode)."""
    cache = llama.init_paged_cache(cfg, slots * maxp, page, device="cuda")
    bt = torch.arange(slots * maxp, dtype=torch.int32,
                      device="cuda").reshape(slots, maxp)
    lengths = torch.zeros(slots, dtype=torch.int32, device="cuda")
    lengths[: len(lens)] = torch.tensor([n + 16 for n in lens],
                                        dtype=torch.int32)
    active = lengths > 0
    tokens = torch.zeros(slots, dtype=torch.int32, device="cuda")
    step = lambda: llama.decode_slots_paged(  # noqa: E731
        params, tokens, active, bt, lengths, cfg, cache)
    out = {"live_lengths": [n + 16 for n in lens], **time_step(torch, step)}
    weight_bytes = sum(t.numel() * t.element_size()
                       for t in _leaves(params))
    out["weights_gb"] = weight_bytes / 1e9
    out["weight_stream_bound_ms"] = weight_bytes / HBM_BYTES_PER_S * 1e3
    return out


def time_step(torch, step) -> dict:
    """host_ms: wall of the eager call starting on an idle card (the
    host enqueue when it is the slower side); device_ms: the same step
    captured as one CUDA graph and replayed, so no host launch gap
    counts; aten_ops: ATen calls of one step.  Medians."""
    out = {}
    with torch.no_grad():
        for _ in range(2):
            step()
        host = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        out["host_ms"] = statistics.median(host)
        out["aten_ops"] = count_aten_ops(step)
        try:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                step()
            out["device_ms"] = time_ms(torch, lambda i: graph.replay(),
                                       n=5, blocks=5)
            del graph
        except RuntimeError as e:  # capture refused: report, don't guess
            out["device_ms"] = None
            out["device_ms_error"] = repr(e)[:300]
    return out


def count_aten_ops(fn) -> int:
    """ATen operator calls made by one call of ``fn`` (each is one or
    more kernel launches on the card; the ctypes kernels are not
    counted)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def init_8b(torch, llama):
    """LLAMA3_8B weights in bf16 on the card, random from seed 0; made
    once for both serving phases."""
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0),
                               llama.LLAMA3_8B, device="cuda",
                               dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def check_first_token(torch, llama, params, cfg, prompt, token, what):
    """The first token of ``prompt`` against a dense forward of the same
    prompt (einsum attention, no pages): finite logits whose top 5 holds
    the engine's token (bf16 noise may reorder near-ties)."""
    with torch.no_grad():
        logits = llama.forward(params, torch.tensor([prompt], device="cuda"),
                               cfg)
    last = logits[0, -1]
    if not torch.isfinite(last).all():
        raise AssertionError(f"{what}: 8B forward logits are not finite")
    top5 = last.topk(5).indices.tolist()
    if token not in top5:
        raise AssertionError(f"{what}: 8B first token {token} not in the "
                             f"dense forward's top 5 {top5}")


def serving_phase(torch, llama, eng_mod, kernels, card, params, init_s):
    import numpy as np

    cfg = llama.LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    ecfg = eng_mod.EngineConfig(max_slots=8, max_seq_len=1024, page_size=64,
                                decode_chunk=8)
    eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg), ecfg,
                            device="cuda")
    rng = np.random.default_rng(6)
    lens = (17, 100, 300, 700)  # paged buckets 64, 128, 512, 1024
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    new = 32
    try:
        # Warm-up request (first cuBLAS handles, allocator growth): not
        # part of the measured run.
        eng.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        for fn in kernels.values():
            fn.launches = 0
        steps0 = eng.stats()["steps"]
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new) for p in prompts]
        outs = [s.result(timeout_s=600) for s in streams]
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        steps = eng.stats()["steps"] - steps0
        metrics = [s.metrics for s in streams]
        reqs = [s._req for s in streams]
    finally:
        eng.shutdown()
    for out in outs:
        if len(out) != new or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"8B stream malformed: {out}")
    missing = [n for n in ("paged_decode_attention_partial",
                           "paged_append", "flash_forward")
               if launches[n] == 0]
    if missing:
        raise AssertionError(f"8B serving never launched {missing}")
    if launches["paged_decode_attention_partial"] \
            != cfg.n_layers * launches["paged_append"]:
        raise AssertionError(f"K1 launches {launches} != L x K2 launches")
    check_first_token(torch, llama, params, cfg, prompts[0], outs[0][0],
                      "8B serving")
    first = min(r.first_token_at for r in reqs)
    last_done = max(r.finished_at for r in reqs)
    decode_tokens = sum(len(o) - 1 for o in outs)
    breakdown = decode_step_breakdown(torch, llama, params, cfg, lens)
    res = {
        "config": "LLAMA3_8B bf16, 32 layers, random weights (seed 0)",
        "engine": "max_slots=8 max_seq_len=1024 page_size=64 decode_chunk=8",
        "prompt_lens": list(lens), "max_new_tokens": new,
        "init_s": init_s, "wall_s": wall,
        "ttft_s": [m["ttft_s"] for m in metrics],
        "decode_tokens_per_s": decode_tokens / (last_done - first),
        "decode_steps": steps,
        "engine_step_ms": (last_done - first) / max(steps, 1) * 1e3,
        "decode_step": breakdown, "launches": launches,
        "launches_per_decode_step": {
            k: launches[k] / steps
            for k in ("paged_decode_attention_partial", "paged_append")},
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"8B serving ({card}): TTFT "
        f"{[round(t, 4) for t in res['ttft_s']]} s, decode "
        f"{res['decode_tokens_per_s']:.1f} tok/s over {steps} steps, peak "
        f"{res['peak_memory_gb']:.2f} GB, launches {launches}")
    dev_ms = breakdown["device_ms"]
    if dev_ms is not None:
        res["device_idle_share"] = 1 - dev_ms / res["engine_step_ms"]
    log(f"8B decode step: engine {res['engine_step_ms']:.2f} ms/step; one "
        f"step alone ({breakdown['aten_ops']} ATen ops): host "
        f"{breakdown['host_ms']:.2f} ms, device "
        + (f"{dev_ms:.2f} ms" if dev_ms is not None else
           f"not measured ({breakdown['device_ms_error']})")
        + f", weight-streaming bound "
        f"{breakdown['weight_stream_bound_ms']:.2f} ms "
        f"({breakdown['weights_gb']:.2f} GB)")
    return res


def ragged_step_breakdown(torch, llama, params, cfg):
    """One mixed 8B ragged step outside the engine (timed as
    ``time_step`` says): the K4/K5 phases' row mix (seven decode rows,
    one 256-token chunk) over a cache of the 8B ragged engine's size."""
    slots, maxp, page = 8, 32, 64
    cache = llama.init_paged_cache(cfg, slots * maxp, page, device="cuda")
    *_unused, rows, bt = ragged_inputs(torch, L=1, H=1, KVH=1, D=16,
                                       maxp=maxp)
    del _unused
    T = RAGGED_T
    tok_pos = torch.zeros(T, dtype=torch.int32)
    at = 0
    for s, n in RAGGED_ROWS:
        tok_pos[at:at + n] = torch.arange(s, s + n, dtype=torch.int32)
        at += n
    tok_pos = tok_pos.cuda()
    tokens = torch.randint(0, cfg.vocab_size, (T,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(12)).cuda()
    step = lambda: llama.ragged_step_paged(  # noqa: E731
        params, tokens, tok_pos, *rows, bt, cfg, cache)
    return {"rows": RAGGED_ROWS, "T": T, **time_step(torch, step)}


def ragged_serving_phase(torch, llama, eng_mod, kernels, card, params):
    """LLAMA3_8B served by the ragged engine: four prompts at once, then
    a fifth of 1000 tokens once the first stream has its first token, so
    its chunks ride beside live decode rows."""
    import numpy as np

    cfg = llama.LLAMA3_8B
    torch.cuda.reset_peak_memory_stats()
    ecfg = eng_mod.EngineConfig(max_slots=8, max_seq_len=2048, page_size=64,
                                decode_chunk=8, ragged_batching=True,
                                prefill_chunk=256)
    eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg), ecfg,
                            device="cuda")
    rng = np.random.default_rng(13)
    lens = (17, 300, 700, 1500)
    late_len = 1000
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    late_prompt = rng.integers(0, cfg.vocab_size, late_len).tolist()
    new = 32
    try:
        if eng._token_budget != RAGGED_T:
            raise AssertionError(f"token budget {eng._token_budget}, want "
                                 f"{RAGGED_T}")
        # Warm-up request (cuBLAS handles, allocator growth): not part of
        # the measured run.
        eng.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        st0 = eng.stats()
        for fn in kernels.values():
            fn.launches = 0
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new) for p in prompts]
        it = iter(streams[0])
        first0 = [next(it)]
        late = eng.submit(late_prompt, max_new_tokens=new)
        outs = [first0 + list(it)]
        outs += [s.result(timeout_s=600) for s in streams[1:]]
        outs.append(late.result(timeout_s=600))
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in kernels.items()}
        st1 = eng.stats()
        reqs = [s._req for s in streams] + [late._req]
    finally:
        eng.shutdown()
    steps = st1["steps"] - st0["steps"]
    mixed = st1["mixed_steps"] - st0["mixed_steps"]
    step_tokens = {k: st1["step_tokens"][k] - st0["step_tokens"][k]
                   for k in st1["step_tokens"]}
    for out in outs:
        if len(out) != new or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"8B ragged stream malformed: {out}")
    k4 = launches["ragged_paged_attention"]
    k5 = launches["ragged_paged_append"]
    if steps == 0 or k4 != cfg.n_layers * steps or k5 != steps:
        raise AssertionError(f"8B ragged: K4 {k4} / K5 {k5} launches over "
                             f"{steps} ragged steps, want {cfg.n_layers} "
                             "and 1 per step")
    if mixed < 1 or min(step_tokens.values()) <= 0:
        raise AssertionError(f"8B ragged: no step packed decode rows beside "
                             f"prompt tokens (mixed {mixed}, tokens "
                             f"{step_tokens})")
    if step_tokens["prefill"] != sum(lens) + late_len:
        raise AssertionError(f"8B ragged: {step_tokens['prefill']} prompt "
                             f"tokens dispatched, want {sum(lens) + late_len}")
    check_first_token(torch, llama, params, cfg, prompts[0], outs[0][0],
                      "8B ragged serving")
    first = min(r.first_token_at for r in reqs)
    last_done = max(r.finished_at for r in reqs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    breakdown = ragged_step_breakdown(torch, llama, params, cfg)
    res = {
        "config": "LLAMA3_8B bf16, 32 layers, random weights (seed 0)",
        "engine": "max_slots=8 max_seq_len=2048 page_size=64 decode_chunk=8 "
                  "ragged_batching=True prefill_chunk=256 (token budget "
                  f"{RAGGED_T})",
        "prompt_lens": list(lens) + [late_len], "max_new_tokens": new,
        "wall_s": wall,
        "ttft_s": [r.first_token_at - r.submitted_at for r in reqs],
        "decode_tokens_per_s": step_tokens["decode"] / (last_done - first),
        "ragged_steps": steps, "mixed_steps": mixed,
        "step_tokens": step_tokens,
        "engine_step_ms": wall / steps * 1e3,
        "launches": launches,
        "launches_per_ragged_step": {"ragged_paged_attention": k4 / steps,
                                     "ragged_paged_append": k5 / steps},
        "mixed_step": breakdown,
        "peak_memory_gb": peak, "card": card,
    }
    dev_ms = breakdown["device_ms"]
    log(f"8B ragged serving ({card}): TTFT "
        f"{[round(t, 4) for t in res['ttft_s']]} s, decode "
        f"{res['decode_tokens_per_s']:.1f} tok/s, {steps} ragged steps "
        f"({mixed} mixed, {res['engine_step_ms']:.2f} ms/step), tokens "
        f"{step_tokens}, peak {peak:.2f} GB, launches {launches}")
    log(f"8B mixed ragged step alone ({breakdown['aten_ops']} ATen ops): "
        f"host {breakdown['host_ms']:.2f} ms, device "
        + (f"{dev_ms:.2f} ms" if dev_ms is not None else
           f"not measured ({breakdown['device_ms_error']})"))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "smoke_out",
        "chip_smoke.json"))
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import flash_attention as tfa
        from ray_tpu_torch.ops import paged_attention as tpa
        from ray_tpu_torch.ops import ragged_paged_attention as trpa
        from ray_tpu_torch.serve import llm_engine as eng_mod
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 3
    # f32 comparisons run in full f32 on the card.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
        f"  count {torch.cuda.device_count()}")
    log(f"card: {card}")
    t_all = time.perf_counter()
    build_s = _build.build_all()
    log(f"build: {len(_build.SOURCES)} kernels in {build_s:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    kernels = {"paged_decode_attention_partial":
               tpa.paged_decode_attention_partial,
               "paged_append": tpa.paged_append,
               "flash_forward": tfa.flash_forward,
               "ragged_paged_attention": trpa.ragged_paged_attention,
               "ragged_paged_append": trpa.ragged_paged_append}
    report = {}
    kernel_phase_k1(torch, F, tpa, report)
    kernel_phase_k2(torch, tpa, report)
    kernel_phase_k9(torch, F, tfa, report)
    kernel_phase_k4(torch, F, trpa, report)
    kernel_phase_k5(torch, trpa, report)
    torch.cuda.empty_cache()
    parity = parity_phase(torch, llama, eng_mod)
    ragged_parity = ragged_parity_phase(torch, llama, eng_mod, trpa)
    params, init_s = init_8b(torch, llama)
    # Each path is driven with every launch counter at 0 just before it
    # and read just after: the bucketed path's K1, K2, K9f, then the
    # ragged path's K4, K5.
    serving = serving_phase(torch, llama, eng_mod, kernels, card, params,
                            init_s)
    ragged = ragged_serving_phase(torch, llama, eng_mod, kernels, card,
                                  params)
    del params
    for key, name, run in (
            ("K1", "paged_decode_attention_partial", serving),
            ("K2", "paged_append", serving),
            ("K9f", "flash_forward", serving),
            ("K4", "ragged_paged_attention", ragged),
            ("K5", "ragged_paged_append", ragged)):
        report[key]["launches"] = run["launches"][name]
        report[key]["kernel_ms"] = report[key]["ms"]
    total_s = time.perf_counter() - t_all
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    line = {"kernels": [{k: report[key][k] for k in keys}
                        for key in ("K1", "K2", "K9f", "K4", "K5")]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": build_s,
                   "total_s": total_s, "kernels": report, "parity": parity,
                   "ragged_parity": ragged_parity, "serving": serving,
                   "ragged_serving": ragged}, f, indent=1)
    log(f"total {total_s:.1f} s; details in {args.out}")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
