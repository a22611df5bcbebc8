#!/usr/bin/env python3
"""Time two checkouts' K2 and K3 on one card, in turns.

    python3 chip_pair.py PARENT_DIR [--out smoke_out/chip_pair.json]

PARENT_DIR is another checkout of the repo (``git archive`` of an older
commit, unpacked into a directory ``.gitignore`` lists).  The script runs
four processes, PARENT_DIR, this checkout, this checkout, PARENT_DIR, so
that a drift of the card over the run shows as a difference between the
two runs of one tree.  Each process builds that tree's kernels, then times
with ``chip_smoke.time_ms`` (medians of CUDA-event means behind a
device-side sleep) an empty launch, K2 (``paged_append``, bf16 pools) and
K3 (``paged_append_quantized``, int8 pools, every page scale stable: the
common case, and every page requantised) at LLAMA3_8B widths (32 layers,
8 kv heads of 128, page 64) and 8 and 48 slots, and checks each against
its plain version (K2 exact, K3 bytes and scales bit for bit).  It prints
one line per process and run, the card's name and power limit, and
writes every number to ``--out``.  Needs one card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SLOTS = (8, 48)


def _smoke():
    """This checkout's chip_smoke (time_ms, growing, int8_pools)."""
    spec = importlib.util.spec_from_file_location(
        "_pair_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def child(tree: str) -> dict:
    """Times of ``tree``'s K2 and K3 (run in a process of its own)."""
    import torch

    sys.path.insert(0, tree)
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import paged_attention as tpa

    if os.path.dirname(tpa.__file__) != os.path.join(tree, "ray_tpu_torch",
                                                      "ops"):
        raise AssertionError(f"imported {tpa.__file__}, not {tree}'s")
    _build.build_all(["paged_append", "paged_append_quantized"])
    sm = _smoke()
    L, KVH, D, page, P = 32, 8, 128, 64, 129
    out = {"launch_floor_ms": sm.time_ms(torch,
                                         lambda i: torch.cuda._sleep(0))}
    for B in SLOTS:
        g = torch.Generator(device="cuda").manual_seed(B)
        pids = torch.randperm(P - 1, generator=g, device="cuda")[:B].to(
            torch.int32)
        pids[3] = P - 1
        offs = torch.randint(1, page, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        # K2 on bf16 pools.
        k = torch.randn((L, KVH, P, page, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
        kn = torch.randn((L, B, KVH, D), generator=g, device="cuda",
                         dtype=torch.bfloat16)
        vn = torch.randn_like(kn)
        got = [k.clone(), v.clone()]
        want = [k.clone(), v.clone()]
        tpa.paged_append(*got, kn, vn, pids, offs)
        tpa.paged_append_plain(*want, kn, vn, pids, offs)
        if not all(torch.equal(a[:, :, : P - 1], b[:, :, : P - 1])
                   for a, b in zip(got, want)):
            raise AssertionError(f"K2 at {B} slots differs from plain")
        del got, want
        k2 = sm.time_ms(torch, lambda i: tpa.paged_append(k, v, kn, vn, pids,
                                                           offs))
        del k, v
        # K3 on int8 pools: first against the plain version from random
        # scales, then timed with stable scales and with growing rows.
        k, v, ks, vs = sm.int8_pools(torch, g, (L, KVH, P, page, D))
        got = [t.clone() for t in (k, v, ks, vs)]
        want = [t.clone() for t in (k, v, ks, vs)]
        tpa.paged_append_quantized(*got, kn, vn, pids, offs)
        tpa.paged_append_quantized_plain(*want, kn, vn, pids, offs)
        sm.compare_quantised(f"K3 at {B} slots", got, want, P - 1)
        del got, want
        ks.fill_(100.0)
        vs.fill_(100.0)
        k3 = sm.time_ms(torch, lambda i: tpa.paged_append_quantized(
            k, v, ks, vs, kn, vn, pids, offs))
        n, blocks = 5, 3
        feed = iter(sm.growing(torch, kn, 3 + n * blocks))
        ks.fill_(1e-3)
        vs.fill_(1e-3)

        def grow(i):
            x = next(feed)
            tpa.paged_append_quantized(k, v, ks, vs, x, x, pids, offs)

        k3_rewrite = sm.time_ms(torch, grow, n=n, blocks=blocks)
        out[f"slots{B}"] = {"K2_ms": k2, "K3_ms": k3,
                            "K3_rewrite_ms": k3_rewrite}
        del k, v, ks, vs
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", nargs="?")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--out", default=os.path.join(HERE, "smoke_out",
                                                  "chip_pair.json"))
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(os.path.abspath(args.child))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_pair: torch.cuda.is_available() is False — this needs "
              "an NVIDIA card", file=sys.stderr)
        return 2
    if not args.parent:
        ap.error("PARENT_DIR is required")
    trees = {"parent": os.path.abspath(args.parent), "this": HERE}
    runs = []
    for name in ("parent", "this", "this", "parent"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             trees[name]], cwd=trees[name], capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, **res})
        print(json.dumps(runs[-1]), flush=True)
    card = _smoke().card_line()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
