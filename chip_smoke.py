#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ray_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--out smoke_out/chip_smoke.json]

Phases (any failure exits non-zero and prints no ``ok`` line):

1. device: torch/CUDA versions, the card's name and power limit;
2. build: every kernel of ``ray_tpu_torch/csrc`` through ``nvcc``
   (one process per source, all started together); the Hopper kernels
   (K9f, K10 and K11 in bf16 at D 64 and 128, K7/K8's WGMMA projections
   and K4/K8's ragged attention) must show no ptxas report of serialised
   wgmma and, where the toolkit has ``cuobjdump``, HGMMA and UTMALDG
   instructions in their SASS, and every instantiation of K1's and K13's
   Hopper kernel its bulk copies (UBLKCP); K12's
   scan must hold HMMA (mma.sync) and LDGSTS (cp.async), K7/K8's DECODE
   projection HGMMA and UTMALDG, K7's tensor-core attention HMMA and
   UTMALDG, and none of the three may spill (counts printed);
3. kernels at LLAMA3_8B shapes (bf16, H=32, KVH=8, D=128, page 64,
   L=32), after a launch floor (an empty launch, ``torch.cuda._sleep(0)``,
   timed as the kernels are): K1 paged decode partials on its Hopper
   route (also timed on its page-walk route, the route of shapes its
   Hopper route does not take, on the same inputs), K2 paged append at 8
   and at 48 slots, K9f flash forward
   (then K10 and K11, phase 9; K9f and K11 also with TFLOP/s and
   kernel / SDPA),
   each held against its plain PyTorch version on the same inputs and
   timed beside it, beside one PyTorch library call computing the same
   function (a yardstick the port never calls), and beside its bound;
   K4 ragged paged attention and K5 ragged append at the same shapes
   (seven decode rows with pasts of 300-1500 tokens beside one
   256-token prompt chunk at position 512: T = 264; K4 also with only
   the decode rows and only the chunk row, each against its own bound);
   then the int8-KV
   kernels at the same shapes and row mixes: K1 and K4 on int8 pools
   with page scales (library yardstick: dequantise, then SDPA), and the
   quantising appends K3 (at 8 and at 48 slots) and K6, whose stored
   bytes and scales must equal the plain versions' bit for bit, each timed
   in its common case (stable page scales) and with every extended page
   rewritten (grown scales);
4. path parity: a tiny f32 Llama through the port's LLMEngine on the
   card (kernels) and on the CPU (plain versions) — identical greedy
   streams, with a prompt long enough for a flash-attention bucket;
   then the same for the ragged engine (prefill_chunk 64, prompts of
   several chunks), for int8 KV pools on both engines, and for the
   ragged engine with the prefix cache (a partial hit and an exact
   full-prompt hit);
5. the bucketed path at full width: LLAMA3_8B in bf16 (random weights
   from a seeded generator on the card, made once for phases 5 and 6)
   served by the port's LLMEngine, four concurrent requests; every
   launch counter is set to 0 just before, and K1 (on its Hopper route:
   no launch on the page walk), K2 and K9f must all have risen just
   after;
6. the ragged path at full width: the same weights served by the ragged
   engine (prefill_chunk 256, token budget 264), prompts of 17, 300, 700
   and 1500 tokens and a fifth of 1000 submitted after the first stream's
   first token, so its chunks ride beside live decode rows; counters set
   to 0 just before, and K4 must run 32 times and K5 once per ragged
   step, with at least one step packing decode rows and prompt tokens
   together.  One mixed ragged step is then timed alone (host, and
   device from a CUDA-graph replay);
7. int8 KV at full width and depth: the same weights with
   ``kv_int8=True``.  The ragged engine with ``prefix_cache=True`` serves
   phase 6's traffic, then two prompts that share a 512-token prefix one
   after the other, so the second hits the cache; counters set to 0 just
   before, and K4 (its int8 instantiation) must run 32 times and K6 once
   per ragged step, K5 never, and the hit must be 512 tokens.  Then a
   short bucketed int8 run, counters again at 0: K1 (int8) 32 times and
   K3 once per decode step, K2 never;
8. the fused decode path over int8 weights (the JAX package's headline
   8B serving configuration): K7 and K8 on one LLAMA3_8B layer of the
   fused int8 artifact, each on bf16 and on int8 pools, held against
   their plain versions and timed beside the bound and the port's
   unfused layer (no single library call computes a layer), K7's device
   time split into projections, attention and the rest, K8's
   projection phase beside
   the same four products as ``torch.matmul`` on the dequantised bf16
   weights (``proj_cublas_ms``); cuda-vs-cpu
   greedy streams of a tiny f32 model with ``fused_decode=True`` on both
   engines, with f32 weights and pools and with an int8 fused artifact
   on int8 pools; then LLAMA3_8B from ``init_quantized_llama`` +
   ``fuse_for_decode`` with ``kv_int8=True, fused_decode=True``: the
   bucketed engine at 48 slots (48 prompts of 128 tokens, 32 new
   tokens: K7 = 32 x K3, no K1 or K2; one decode step timed as a CUDA
   graph against the int8 weight-streaming bound), the ragged engine
   with phase 6's traffic (K8 32 and K6 1 per step, no K4 or K5), and a
   short run of both on bf16 pools (K7 beside K2, K8 beside K5);
9. training (bench.py's headline path): K10 and K11 (flash backward dq,
   dk/dv) at BENCH_CFG's attention shapes (B 8, S 2048, 8/4 heads of
   128, causal, bf16) and one small f32 case against their plain
   versions, timed beside the bound and the backward of causal SDPA,
   with K9f's output and lse on the same cases held against its plain
   version (kernel phase, after K9f); then a small f32 Llama at S = 256 trained
   3 steps through ``TorchTrainer.fit`` on the card and on the CPU from
   the same weights (losses and grad norms agree; K9f, K10, K11 counted);
   then BENCH_CFG (319M params, 8 x 2048 tokens, bf16 compute, f32
   master, "dots" remat, bf16 first moment) as bench.py's ``_measure``
   drives it: ``trainer.state``, ``trainer._step_fn``, staged batches, 2
   warm-up and 5 timed steps, one step's stream time between CUDA events
   and its kernel time under the profiler, then ``fit`` for 2 steps with a checkpoint written and
   restored; counters at 0 before and read after: K9f 32, K10 and K11 16
   per step; the loss on the first batch must fall; then BENCH_1B_CFG
   (bf16 master, "full" remat, loss chunks of 512) for 2 steps;
10. Mamba-2 training and K13: K12 (the SSD chunk scan) against its plain
   version at bench.py's ``_measure_ssd`` shape (B 4, S 4096, H 8, P 64,
   N 128, chunk 128), at one 2.7B layer's (B 2, S 2048, H 80, P 64, N
   128, chunk 64, bf16 B/C) and with the chunk kept (S 1984), each
   bit-identical over two launches, timed beside the plain version, the
   port's ``ssd_chunked``, its kernels' device times and the bound on
   its route (the TF32 products it issues, or bytes), and the
   ``ssd_pallas`` Function's gradients card vs CPU; K13 (normalised
   paged decode attention) against its plain version at LLAMA3_8B decode
   shapes on each of 32 layers' pages, an empty slot, OOB page ids and a
   soft-capped case, plus a group of 5 query heads and head_dim 32 on
   one layer, timed beside SDPA with each call on the next layer's pages
   (and on one layer's, L2-hot); K1 and K13 on their page-walk route at
   shapes the Hopper route refuses (a group of 16 query heads at D 128,
   and D 48; 8 slots, 4 layers), every launch counted on the walk, each
   held against its plain version and timed; MAMBA2_TINY (f32,
   ``use_pallas_ssd=True``) trained 3
   steps on the card and on the CPU (losses agree); JAMBA_TINY at S 512
   for 2 steps (K12 and K9f/K10/K11 once a step); MAMBA2_2_7B with
   ``use_pallas_ssd=True`` at full width and depth on a fixed 2 x 2048
   batch through ``TorchTrainer.fit`` (2 warm-up, 3 timed steps, one
   profiled by kernel and one by op): finite logits, a falling loss, K12
   128 a step from 0; then
   K13's path, ``paged_decode_attention_tp`` without a mesh over 32
   layers (K13 32 times from 0);
11. speculative decoding and multi-tenant LoRA (no kernel of their own):
   K4 (bf16 and int8 pools), K5, K6 and K8 (bf16 and int8 pools) at 8B
   shapes on verify rows of 2-5 tokens starting 1-4 tokens before a page
   boundary beside decode rows, then on the rows that overwrite the
   rejected tails (K6's pages requantised whole), each against its plain
   version (after phase 3's kernels); tiny f32 cuda-vs-cpu parity (after
   phase 8's): spec on with self-draft and a wrong one-layer draft on
   f32 and int8 pools (equal to spec off on f32 pools), a batch mixing
   three adapters and the base model on f32 and int8 adapter pages, with
   and without spec (its null row equal to the adapter-off stream); then
   LLAMA3_8B (after phase 7) at bench.py's ``_probe_spec_ablation``
   traffic (24 short_chat prompts, 32 new tokens, 16 slots), spec off,
   self-draft and a random LLAMA3_1B-shaped draft: decode tokens/s, the
   accept ratio, accepted tokens per step, cooldowns (at least one with
   the 1B draft), K4 = 32 x target steps + draft layers x draft steps,
   K5 = target + draft steps, peak memory, and each stream's common
   prefix with spec off (a first divergence must rank in the top 2 of a
   dense forward there), then a step of 16 decode rows and one of 16
   verify rows of 5 tokens timed alone; and at ``_measure_serving_adapters``' traffic
   (6 Zipf(1.1) adapters, a pool of 4, 24 requests of 96 tokens at 8/s,
   16 new, rank 4), single-model then multiplexed: tokens/s, their
   ratio, TTFT p50/p95 and the pool's hits, misses and evictions; null
   rows beside adapter rows equal the adapter-off engine's, and the first
   token of each of three adapters lies within 1.5 logit std of the top
   of a dense forward over the merged weights W + scale A B and ranks
   above 100 under the base weights (ranks, gaps and spreads printed);
   one adapter load and one step of the leg's row mix, base vs LoRA,
   timed alone;
12. the dense (non-paged) serving path (``llama_adapter``, no kernel of
   its own; its prefills take K9f): a tiny f32 Llama on the dense engine,
   cuda vs cpu greedy streams identical and equal to the paged engine's
   on the card, K9f launched and no other kernel; then LLAMA3_8B in bf16
   (after phase 11, on the same weights) with 8 slots of 2048 and prompts
   of 17, 300, 700 and 1500 tokens at once: counters at 0 just before,
   K9f risen and no paged kernel (K1, K2, K4, K5, K13 or their int8
   kin); the paged engine on the same prompts, each stream's common
   prefix with it (a first divergence must rank in the top 2 of a dense
   forward); decode tokens/s beside the paged engine's and phase 5's,
   one dense decode step timed alone (host, and device from a
   CUDA-graph replay) and peak memory;
13. int8 Adam states (``train.adamw8bit``, no kernel of its own), after
   phase 9's training: K9f, K10 and K11 at BENCH_2B_CFG's attention (B
   4, S 2048, 20 query heads over 4 kv heads: a GQA group of 5, D 128,
   bf16) against their plain versions, timed beside them, SDPA and the
   bound; a small f32 Llama trained 3 steps with ``adamw8bit`` on the
   card and on the CPU (losses, grad norms and int8 states agree); then
   BENCH_2B_CFG at full width and depth (2.24 B params, bf16 master,
   "full" remat, loss chunks of 512) with ``adamw8bit(1e-4,
   warmup_steps=10)`` on 4 x 2048 batches, as bench.py drives it: 2
   warm-up and 3 timed steps with counters read per step (K9f 44, K10
   and K11 22 a step), tokens/s, MFU, one step's kernel time by kernel,
   peak memory and the optimizer state's bytes beside AdamW's; the loss
   on the first batch must fall, and a checkpoint is written and
   restored on the card; then one step through ``fit``, after which the
   trainer's ``raytpu_train_*`` families are printed (phase 9's 2-step
   ``fit`` prints them too): ``steps_total`` up by the steps ``fit`` ran,
   ``opt_state_bytes`` equal to the state's bytes;
14. the serving engine's planes (run after phase 12, on phase 5's
   weights): a tiny f32 Llama drained mid-stream through ``LLMServer``
   on the card, each continuation (exactly the delivered tokens) resumed
   on a second engine to the undisturbed stream; LLAMA3_8B through
   ``LLMServer(adapter_factory=llama_paged_adapter)`` at phase 5's
   traffic with an SLO every request meets by nine orders of magnitude:
   streams equal to phase 5's engine-direct ones, the exposition's counts
   (TTFT count, FINISHED, SLO met and missed, shed, prefill step tokens)
   equal to what was submitted, K1 = 32 x K2 and K9f counted from 0, a
   deep audit's ms and 0 violations; a drain of four streams mid-decode,
   resumed on a fresh engine (common prefix with phase 5's streams and
   the rank of a first divergence, top 5 wanted); a burst of 24 requests
   on 8 slots with ``shed_queue_age_s`` 0.05 (the ShedErrors equal
   ``raytpu_serve_shed_total``); the ragged engine with the prefix cache
   through ``LLMServer``: phase 6's four prompts, then two sharing a
   512-token prefix (a 512-token hit, the prefix gauges, K4 = 32 and
   K5 = 1 per step counted from 0); and phase 5's decode tokens/s and
   one step's host ms, now with the planes on;
15. KV page migration, the latency waterfall and the device plane (run
   after phase 14, on phase 5's weights): a tiny f32 Llama's transfer
   exported by an engine on the CPU and ingested on the card (the probe
   over it is a full hit and streams the CPU engine's tokens); then,
   with tracing on, the ragged 8B engine with the prefix cache serves
   phase 6's four prompts and two sharing 512 tokens, and exports its
   hot prefixes exactly and as int8 (transfers, pages, wire bytes, ms,
   GB/s); a cold engine ingests the exact ones (pages in = the warm
   engine's cached pages), and a probe over the deepest migrated path
   is a hit over exactly those pages whose stream equals the warm
   engine's token for token (its TTFT beside a third engine that
   recomputes the probe; K4 = 32 and K5 = 1 per step counted from 0);
   the int8 transfers into a bf16 pool (common prefix with the warm
   stream, rank of a first divergence, top 5 wanted); a lease left open
   across ``drain()`` is released and the deep audit is clean with
   ``kv.lease_accounting`` in it; both pools int8 (raw bytes and scales,
   no requantisation; streams equal; K4 int8 = 32 x K6); every terminal
   request's waterfall sums to its e2e within 1e-6 s (the control-plane
   share printed); ``xprof.roofline()``'s ``serve.ragged`` row at or
   below 1.0 of the card's bandwidth; the analytic decode bound beside
   PERF.md's 4.79 ms; the ``raytpu_device_hbm_*`` gauges equal to
   ``torch.cuda.memory_stats()``;
16. the HF Llama import (run after phase 15, on phase 5's weights): the
   bf16 8B tree rewritten into HF names and [out, in] layouts on the
   card and imported by ``params_from_hf_state_dict`` (every leaf equal
   to its source bit for bit; import time and GB/s), ``quantize=True``
   equal to ``quant.quantize_params`` of the same tree, phase 5's four
   prompts served for 8 tokens on the bucketed engine from the imported
   tree (streams equal to phase 5's first 8 tokens; K1, K2, K9f counted
   from 0); then a tiny f32 Llama laid out by hand as two
   ``.safetensors`` shards plus ``config.json`` (the card's machine has
   no ``safetensors`` package) and read back by
   ``load_llama_from_hf(dir)``, every leaf equal;
17. the other model families (after phase 10): K9f, K10 and K11 at
   MIXTRAL_8X7B's attention (B 2, S 2048, 32 query heads over 8 kv heads
   of 128: a GQA group of 4, bf16) against their plain versions, timed
   beside them, SDPA and the bound; a small f32 Mixtral (S 256, head_dim
   64, 4 experts, "dots" remat) trained 3 steps on the card and on the
   CPU (losses, grad norms and aux losses agree; K9f 12, K10 and K11 6);
   MIXTRAL_8X7B at full width cut to 2 layers (3.165 B params, 1.051 B
   active, f32 params, bf16 compute) trained with AdamW through
   ``TorchTrainer`` on a fixed 2 x 2048 batch with dense dispatch: 2
   warm-up and 4 timed steps with counters read per step (K9f 4, K10 and
   K11 2), one step's kernels under the profiler, step ms, tokens/s, MFU
   over active params, peak memory, the dropped-assignment share per
   layer at capacity factor 1.25, a finite falling loss; then one step of
   scatter dispatch from the same state, its loss within one bf16 ulp of
   dense's; VIT_TINY and CLIP_TINY in f32 trained 3 steps on the card and
   on the CPU (losses and grad norms agree); ViT-L/16 (224, 1,000
   classes) and CLIP_L14_LIKE at full width and depth on fixed batches of
   64 images: 2 warm-up and 3 timed AdamW steps, step ms, images/s, peak
   memory, a falling loss, and no kernel launched (both take the einsum
   attention).
18. RLlib (after phase 17): K9f, K10 and K11 at GRPO's attention on
   LLAMA3_1B (B 32, S 256, 32/8 heads of 64, bf16) against their plain
   versions, timed beside them, SDPA and the bound; cuda-vs-cpu parity
   of a small f32 GRPO policy at S 256 (the same sampled tokens, one
   iteration's params within RL_PARAM_TOL; K9f, K10, K11 counted) and of
   one PPO iteration on CartPole; GRPO at LLAMA3_1B's full width and
   depth (f32 master weights, bf16 compute, "dots" remat, 4 prompts x 8,
   192 + 64 tokens, 2 epochs) for 2 iterations, each with K9f 1,104, K10
   and K11 32 counted from 0, its s, sampling s, generated and trained
   tokens/s, reward, first epoch's ratio (within 1e-2 of 1) and max
   |sampled - recomputed logp|, and the peak memory; then learning on the
   card with the JAX tests' settings and gates (PPO and DQN on CartPole,
   GRPO on a tiny Llama) and PPO at 1,024 envs (env steps/s);
19. data-parallel training over ``torch.distributed`` (after phase 18,
   once every earlier phase has freed its memory), on an NCCL process
   group of world size 1 formed by ``train/backend.init_process_group``:
   every function of ``parallel/collectives.py`` on CUDA tensors (each
   result equal to its one member's; the quantized all-reduce equal to
   its formula); a small f32 Llama (S 256) trained 3 steps through
   ``TorchTrainer`` with ``zero_sharding`` off and on, for fp32 AdamW and
   ``adamw8bit`` (both through the data-parallel step, its all-reduces
   on NCCL: ZeRO equal to the replicated run and to the single-device
   step without a layout bit for bit, the single-device step on the CPU
   within ZERO_PARITY_TOL; K9f 12, K10 and K11 6); K9f,
   K10 and K11 at the 8B rung's attention (B 1, S 2048, 32/8 heads of
   128, bf16) against their plain versions, timed beside them, SDPA and
   the bound; then bench.py's full-8B AdamW rung (``_measure_8b_train``):
   LLAMA3_8B at full width and depth, bf16 params, "full" remat, loss
   chunks of 512, ``adamw8bit(1e-4, warmup_steps=10, shard_update=True)``,
   ``TrainerConfig(zero_sharding=True, grad_accum=4)``, ``MeshSpec(dp=1,
   fsdp=1)``, batches of 4 x 2048: its memory plan against
   ``torch.cuda.mem_get_info`` (it fails with the math when the card is
   short; the model is never cut), 2 warm-up and 3 timed steps (K9f 256,
   K10 and K11 128 a step), tokens/s, MFU, optimizer bytes a param and a
   device, peak memory, one step's kernels by family under the profiler,
   4 alternating pairs of the data-parallel and the single-device step
   (each timed alone), and the loss on the first batch falling;
20. RLlib's SAC, TD3, DDPG, BC, CQL, MARWIL and MultiAgentPPO (after
   phase 18, before phase 19's process group; no kernel): each at the
   CPU tests' sizes on the CPU and on the card from one seed (params,
   targets and metrics within RL_PARAM_TOL), and SAC's, TD3's, DDPG's
   and CQL's steps as CUDA graphs against the same steps run eagerly on
   the card (equal); then the JAX tests' learning gates at seed 0 on the
   card: SAC, TD3 and DDPG on Pendulum, the seed-0 SAC's logged datasets
   (checked as the JAX test checks them), BC, CQL and MARWIL on the JAX
   tests' own datasets (``scripts/data``), MultiAgentPPO on
   TwoAgentReach; each algorithm's seconds, env steps/s or updates/s,
   gate and value;
21. Mixtral, ViT and CLIP through the data-parallel step and expert
   parallelism's all-to-all op (inside phase 19's NCCL group, after the
   8B rung): (a) phase 17's small f32 Mixtral at capacity factor 0.5
   (assignments drop) trained 3 steps through ``TorchTrainer`` with
   ``MeshSpec(dp=1, ep=1)`` (the loss's ``"global"`` split, its aux
   summed over NCCL): equal to the single-device step on the card bit
   for bit and to the CPU's within ZERO_PARITY_TOL, K9f 12, K10 and K11
   6 counted from 0; (b) MIXTRAL_8X7B at full width and 2 layers (1 if
   its memory plan does not fit ``mem_get_info``, said so) through the
   same step at bf16 on phase 17's 2 x 2048 batch: 3 steps with K9f 4,
   K10 and K11 2 counted a step, 4 alternating pairs of the
   data-parallel and the single-device step (each timed alone), tokens/s,
   the dropped share, peak memory, a falling loss; (c)
   ``ops/moe_a2a.moe_block_ep`` at 8x7B widths (bf16, 2 x 2048 tokens,
   capacity factor 4: nothing drops) over the one-rank ep group: output
   and aux equal ``moe_block``'s bit for bit, each one's ms; (d) ViT-L/16
   and CLIP-L, 2 steps on 64 images through the data-parallel step (ViT's
   ``"rows"`` split; CLIP's ``"global"`` one, its embeddings all-gathered
   on NCCL): equal to the single-device step bit for bit, images/s.

The last three lines of standard output are the kernel table (K1, K2,
K9f, K10, K11, K4, K5, K1 int8, K3, K4 int8, K6, K7, K7 int8, K8, K8
int8, K12, K13; K1, K2, K9f, K4 and K5 launched by phase 14's
``LLMServer`` runs; then K9f, K10 and K11 at GRPO's shape, launched by
phase 18's GRPO 1B run, and at the 8B rung's, launched by phase 19's
five 8B steps) as one JSON object, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.  Details go to ``--out`` (with
``launch_floor_ms``, K2's and K3's 48-slot runs under ``slots48``, the
page-walk phases under ``kernels.walk``, the verify-row phases under
``kernels.verify_rows`` and the group-5 rows of K9f, K10 and K11 under
each one's ``group5``, phase 14 under ``planes``, phase 15 under
``migration``, phase 16 under ``hf_import``, phase 17 under
``mixtral_parity``, ``mixtral_8x7b``, ``vit_clip_parity``, ``vit_clip``
and each flash kernel's ``group4``, phase 18 under ``rl_parity``,
``grpo_1b``, ``rl_learning`` and each flash kernel's ``grpo``, phase 19
under ``collectives``, ``zero_parity``, ``train_8b`` and each flash
kernel's ``8b``, phase 20 under ``rl20_parity`` and ``rl20_learning``,
phase 21 under ``phase21``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12              # H100 SXM dense bf16 tensor-core peak
TF32_FLOPS = 495e12              # H100 SXM dense TF32 tensor-core peak
F32_FLOPS = 67e12                # H100 SXM float32 outside the tensor cores


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` after the seconds since the smoke started."""
    print(f"[{time.perf_counter() - _T0:6.1f} s] {msg}", flush=True)


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


# The libraries holding the Hopper kernels: the names that pick a
# library's Hopper functions out of its SASS, and the kernels it must hold
# (K9f, K10 and K11 in bf16 at D 64 and 128; K7/K8's WGMMA projections;
# K4/K8's ragged attention).
HOPPER_KERNELS = {
    "flash_fwd": (("wgmma",), ("flash_fwd_wgmma",)),
    "flash_bwd": (("wgmma",), ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma")),
    "fused_decode": (("proj_wgmma",), ("proj_wgmma",)),
    "fused_ragged": (("proj_wgmma", "attention_hopper"),
                     ("proj_wgmma", "attention_hopper")),
    "ragged_attention": (("attention_hopper",), ("attention_hopper",)),
}
# K1's and K13's Hopper kernel (one template; K1's instantiations carry
# PARTIAL = true), which copies its pages with cp.async.bulk (UBLKCP).
PAGED_DECODE_KERNEL = ("paged_decode", "paged_decode_hopper")
# The mma.sync and DECODE kernels and the SASS opcodes each must hold:
# K12's scan (mma.sync on TF32, HMMA; cp.async, LDGSTS), K7/K8's DECODE
# projection (HGMMA, UTMALDG) and K7's tensor-core attention (HMMA,
# UTMALDG).  None may spill.
TC_KERNELS = (("mamba_ssd", "ssd_kernel", ("HMMA", "LDGSTS")),
              ("fused_decode", "proj_decode", ("HGMMA", "UTMALDG")),
              ("fused_decode", "decode_attn_tc", ("HMMA", "UTMALDG")),
              ("fused_ragged", "proj_decode", ("HGMMA", "UTMALDG")))


def ptxas_spills(log_text: str, name_part: str) -> dict:
    """Spill stores and loads ptxas reported (-v) for each function whose
    name holds ``name_part``."""
    out, fn = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1) if name_part in m.group(1) else None
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            out[fn] = int(m.group(1)) + int(m.group(2))
            fn = None
    return out


def _cuobjdump(_build):
    """The toolkit's cuobjdump: on PATH or beside nvcc; None without."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    try:
        cand = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    except RuntimeError:
        return None
    return cand if os.path.exists(cand) else None


def _sass_counts(tool, _build, lib, name_parts, ops) -> dict:
    """Per function of csrc/<lib>.cu whose name holds one of
    ``name_parts``: the number of SASS lines holding each opcode of
    ``ops``."""
    sass = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if any(part in m.group(1)
                                   for part in name_parts) else None
            if fn:
                out[fn] = {"lib": lib, **{op: 0 for op in ops}}
        elif fn:
            for op in ops:
                out[fn][op] += op in line
    return out


def hopper_check(_build) -> dict:
    """The Hopper kernels run wgmma on TMA-fed shared memory: in the SASS
    of each one (K9f, K10, K11, K7/K8's projections, K4/K8's ragged
    attention), HGMMA (warpgroup MMA) and UTMALDG (TMA tile load) counts
    above 0, and no ptxas report of serialised wgmma in their builds;
    K12's scan, K7/K8's DECODE projection and K7's attention hold the
    opcodes of ``TC_KERNELS`` and spill nothing; every instantiation of
    K1's and K13's Hopper kernel copies its pages with UBLKCP (bulk
    copies).  Fails otherwise; without cuobjdump
    the SASS counts are not taken."""
    out = {}
    for lib in HOPPER_KERNELS:
        for line in _build.build_logs.get(lib, "").splitlines():
            if "wgmma" in line and "serializ" in line.lower():
                raise AssertionError(f"ptxas serialised wgmma in csrc/{lib}"
                                     f".cu: {line.strip()}")
    tool = _cuobjdump(_build)
    if tool is None:
        log("hopper kernels: no cuobjdump here, SASS not counted")
        return {"sass": "not measured (no cuobjdump)"}
    for lib, (parts, required) in HOPPER_KERNELS.items():
        found = _sass_counts(tool, _build, lib, parts, ("HGMMA", "UTMALDG"))
        out.update({f"{lib}:{f}": c for f, c in found.items()})
        missing = [k for k in required if not any(k in f for f in found)]
        if missing or any(c[op] == 0 for c in found.values()
                          for op in ("HGMMA", "UTMALDG")):
            raise AssertionError(f"csrc/{lib}.cu: Hopper kernels missing "
                                 f"({missing}) or without wgmma or TMA "
                                 f"loads in their SASS: {found}")
    for f, c in out.items():
        short = re.search(r"hk\d+(\w+?)ILi(\d+)E", f) or re.search(
            r"(proj_wgmma|attention_hopper)I(\w+?)EEv", f)
        name = f"{short.group(1)}<{short.group(2)}>" if short else f[:60]
        log(f"  SASS {c['lib']} {name}: HGMMA {c['HGMMA']}  "
            f"UTMALDG {c['UTMALDG']}")
    for lib, part, ops in TC_KERNELS:
        spills = ptxas_spills(_build.build_logs.get(lib, ""), part)
        if any(spills.values()):
            raise AssertionError(f"csrc/{lib}.cu: {part} spills: {spills}")
        found = _sass_counts(tool, _build, lib, (part,), ops)
        if not found or any(c[op] == 0 for c in found.values() for op in ops):
            raise AssertionError(f"csrc/{lib}.cu: {part} missing or without "
                                 f"{ops} in its SASS: {found}")
        log(f"  SASS {lib} {part}: {len(found)} instantiations, "
            + ", ".join(f"{op} {sorted(c[op] for c in found.values())}"
                        for op in ops)
            + f"; ptxas spills {sorted(set(spills.values())) or 'not read'}")
        out.update({f"{lib}:{f}": c for f, c in found.items()})
    lib, part = PAGED_DECODE_KERNEL
    found = _sass_counts(tool, _build, lib, (part,), ("UBLKCP",))
    k1 = {f: c for f, c in found.items() if "Lb1E" in f}
    if not k1 or len(k1) == len(found) \
            or any(c["UBLKCP"] == 0 for c in found.values()):
        raise AssertionError(f"csrc/{lib}.cu: K1 or K13 missing, or without "
                             f"bulk copies (UBLKCP) in its SASS: {found}")
    log(f"  SASS {part}: {len(k1)} K1 and {len(found) - len(k1)} K13 "
        f"instantiations, UBLKCP "
        f"{sorted(set(c['UBLKCP'] for c in found.values()))}")
    out.update(found)
    return out


def int8_pools(torch, g, shape):
    """Random int8 pools [L, KVH, P, page, D] with page-major f32 scales
    [L, P, KVH, 1] in [0.005, 0.025)."""
    L, KVH, P = shape[:3]
    k = torch.randint(-127, 128, shape, generator=g, device="cuda",
                      dtype=torch.int8)
    v = torch.randint(-127, 128, shape, generator=g, device="cuda",
                      dtype=torch.int8)
    ks = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 + 0.005
    vs = torch.rand((L, P, KVH, 1), generator=g, device="cuda") * 0.02 + 0.005
    return k, v, ks, vs


# Times of the kernels' previous designs (K1's page-split kernel with
# its merge pass, K6's CTA per row, page slot and kv head, K2's CTA per
# (slot, layer), K3's CTA per row), measured by this script on an NVIDIA
# H100 80GB HBM3 at 700 W (PERF.md's kernel table), printed beside this
# run's.
PREVIOUS_MS = {"K1": 0.02851, "K1 int8": 0.033, "K6": 0.05769,
               "K2": 0.002694, "K3": 0.006182}


# K1 against its plain version: the same f32 values up to p on both sides
# (q.k in one fixed order, exp in f64), p rounded to bf16 at the same
# running max: only the order of the sums differs.
K1_SMOKE_TOL = {"out": 1e-3, "m": 1e-3, "l_rel": 1e-4}


def k1_err(got, want, live) -> dict:
    """K1's (acc, m, l) against the plain version's on the ``live`` slots:
    the normalised output, m, and l relative to max(l, 1)."""
    (acc, m, l), (acc_p, m_p, l_p) = got, want
    out = (acc / l.clamp(min=1e-30))[live]
    out_p = (acc_p / l_p.clamp(min=1e-30))[live]
    return {"out": (out - out_p).abs().max().item(),
            "m": (m - m_p).abs().max().item(),
            "l_rel": ((l - l_p).abs() / l_p.clamp(min=1)).max().item()}


def kernel_phase_k1(torch, F, tpa, report, int8=False):
    L, B, H, KVH, D, page, maxp = 32, 8, 32, 8, 128, 64, 16
    P = B * maxp + 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    scales = {}
    if int8:
        k, v, ks, vs = int8_pools(torch, g, (L, KVH, P, page, D))
        scales = {"k_scales": ks, "v_scales": vs}
    else:
        k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
    tag = "K1 int8" if int8 else "K1"
    q = torch.randn((B, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    lens_list = [0, 1, 63, 64, 65, 1000, 517, 230]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(2))
    bt = torch.full((B, maxp), P - 1, dtype=torch.int32)
    for b, n in enumerate(lens_list):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live].to(torch.int32)
    bt = bt.to(dev)

    live = lengths > 0
    errors = functools.partial(k1_err, live=live)
    tol = K1_SMOKE_TOL
    worst = {"out": 0.0, "m": 0.0, "l_rel": 0.0}
    walk0 = tpa.paged_decode_attention_partial.launches_walk
    for layer in range(L):
        got = tpa.paged_decode_attention_partial(q, k, v, layer, bt, lengths,
                                                 **scales)
        e = errors(got, tpa.paged_decode_attention_partial_plain(
            q, k, v, layer, bt, lengths, **scales))
        worst = {key: max(worst[key], e[key]) for key in worst}
        acc, m, l = got
        if (m[~live] != -1e30).any() or (l[~live] != 0).any() \
                or (acc[~live] != 0).any():
            raise AssertionError(f"{tag}: an empty slot must give acc=0, "
                                 "m=-1e30, l=0")
    if tpa.paged_decode_attention_partial.launches_walk != walk0:
        raise AssertionError(f"{tag} left its Hopper route at the 8B shape")
    if any(worst[key] > tol[key] for key in tol):
        raise AssertionError(f"{tag} disagrees with its plain version: "
                             f"{worst} (tolerance {tol})")

    ms = time_ms(torch, lambda i: tpa.paged_decode_attention_partial(
        q, k, v, i % L, bt, lengths, **scales))
    # The page-walk route (shapes the Hopper route does not take) on the
    # same inputs, its plan patched away for the call.
    plan = tpa.hopper_decode_plan
    tpa.hopper_decode_plan = lambda *a, **kw: None
    try:
        walk = tpa.paged_decode_attention_partial(q, k, v, L - 1, bt, lengths,
                                                  **scales)
        walk_ms = time_ms(torch, lambda i: tpa.paged_decode_attention_partial(
            q, k, v, i % L, bt, lengths, **scales))
    finally:
        tpa.hopper_decode_plan = plan
    walk_err = errors(walk, tpa.paged_decode_attention_partial(
        q, k, v, L - 1, bt, lengths, **scales))
    if any(walk_err[key] > tol[key] for key in tol):
        raise AssertionError(f"{tag}: the page-walk route is {walk_err} off "
                             f"the Hopper route (tolerance {tol})")
    plain_ms = time_ms(torch, lambda i: tpa.paged_decode_attention_partial_plain(
        q, k, v, i % L, bt, lengths, **scales), n=4, blocks=3)
    # Library yardstick: SDPA over the gathered dense k/v of each layer
    # (int8: the gathered bytes are dequantised inside the timed call).
    T = maxp * page
    kd = k[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, KVH, T, D)
    vd = v[:, :, bt.long()].permute(0, 2, 1, 3, 4, 5).reshape(L, B, KVH, T, D)
    if int8:
        # [L, B, maxp, KVH, 1] -> one scale per key [L, B, KVH, T, 1]
        ksd, vsd = (sc[:, bt.long()].permute(0, 1, 3, 2, 4)
                    .repeat_interleave(page, dim=3).to(torch.bfloat16)
                    for sc in (ks, vs))
        dense = lambda i: (kd[i % L].to(torch.bfloat16) * ksd[i % L],  # noqa: E731
                           vd[i % L].to(torch.bfloat16) * vsd[i % L])
    else:
        dense = lambda i: (kd[i % L], vd[i % L])  # noqa: E731
    mask = (torch.arange(T, device=dev)[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    try:
        F.scaled_dot_product_attention(q4, *dense(0), attn_mask=mask,
                                       enable_gqa=True)
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, *dense(i), attn_mask=mask, enable_gqa=True)
    except TypeError:
        rep = H // KVH
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, *(t.repeat_interleave(rep, dim=1) for t in dense(i)),
            attn_mask=mask)
    library_ms = time_ms(torch, lib)
    tokens = sum(lens_list)
    live_pages = sum(-(-n // page) for n in lens_list)
    kv_bytes = tokens * KVH * D * 2 * (1 if int8 else 2) \
        + (2 * live_pages * KVH * 4 if int8 else 0)
    nbytes = (B * H * D * 2 + kv_bytes + bt.numel() * 4
              + B * 4 + B * H * D * 4 + 2 * B * H * 4)
    flops = 4 * tokens * H * D
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    report["K1i8" if int8 else "K1"] = {
        "name": "paged_decode_attention_partial"
                + (" (int8 pools)" if int8 else ""), "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_decode.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:263",
        "max_abs_err": max(worst["out"], worst["m"]),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={B} H={H} KVH={KVH} D={D} page={page} q bf16, pools "
                 f"{'int8 + f32 page scales' if int8 else 'bf16'}, lengths "
                 f"{lens_list}, layer cycling over L={L}",
        "errors": worst, "bound_bytes": nbytes, "walk_ms": walk_ms,
        "walk_err": walk_err,
    }
    log(f"{tag} paged_decode_attention_partial: err {worst}  kernel "
        f"{ms:.5f} ms (previous design: {PREVIOUS_MS[tag]} ms; the "
        f"page-walk route here: {walk_ms:.5f} ms, {walk_err} off)  plain "
        f"{plain_ms:.4f} ms  {'dequantise + ' if int8 else ''}SDPA "
        f"{library_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})")


def launch_floor_ms(torch) -> float:
    """An empty launch (``torch.cuda._sleep(0)``) timed as the kernels are:
    the least a kernel of one launch can take here."""
    return time_ms(torch, lambda i: torch.cuda._sleep(0))


K2_SLOTS = (8, 48)  # the bucketed bf16 step's slots; the fused int8 step's


def _k2_case(torch, tpa, B):
    """K2 at LLAMA3_8B widths and B slots (one inactive, on the scratch
    page): exact against its plain version, then timed beside the plain
    version, two ``index_copy_`` calls and the bound (bytes)."""
    L, KVH, D, page = 32, 8, 128, 64
    P = 8 * 16 + 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3 + B)
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    k_new = torch.randn((L, B, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    pids = torch.randperm(P - 1, generator=g, device=dev)[:B].to(torch.int32)
    pids[3] = P - 1  # slot 3 is inactive: its row goes to the scratch page
    offs = torch.randint(0, page, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    k1, v1 = k.clone(), v.clone()
    tpa.paged_append(k1, v1, k_new, v_new, pids, offs)
    k2, v2 = k.clone(), v.clone()
    tpa.paged_append_plain(k2, v2, k_new, v_new, pids, offs)
    err = max((k1.float() - k2.float()).abs().max().item(),
              (v1.float() - v2.float()).abs().max().item())
    if err != 0.0:  # a copy: exact
        raise AssertionError(f"K2 at {B} slots disagrees with its plain "
                             f"version: {err}")
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
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_bytes": nbytes,
            "shape": f"L={L} B={B} KVH={KVH} D={D} page={page} bf16, one "
                     "inactive slot"}


def kernel_phase_k2(torch, tpa, report, floor_ms):
    runs = {B: _k2_case(torch, tpa, B) for B in K2_SLOTS}
    report["K2"] = {
        "name": "paged_append", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_append.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:515",
        **runs[8], "launch_floor_ms": floor_ms,
        "slots48": runs[48]}
    for B, r in runs.items():
        log(f"K2 paged_append at {B} slots: err {r['max_abs_err']}  kernel "
            f"{r['ms']:.5f} ms (previous design at 8 slots: "
            f"{PREVIOUS_MS['K2']} ms; launch floor {floor_ms:.5f} ms)  "
            f"plain {r['plain_ms']:.4f} ms  index_copy_ "
            f"{r['library_ms']:.5f} ms  bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it)")


# K9f against its plain version, |o - o_plain| / (1 + |o_plain|) and
# |lse - lse_plain|.  bf16: both round p to bf16 before p.v (the kernel
# at its running max, the plain version at the final lse) and the output
# once, a bf16 ulp or two (2^-8 relative) apart; lse stays f32.  f32:
# summation order only.
K9F_TOL = {"bfloat16": (1e-2, 1e-3), "float32": (1e-4, 1e-4)}


def check_k9f(torch, tfa, q, k, v, o, lse, where: str):
    """Hold K9f's (o, lse) on (q, k, v) against ``flash_forward_plain``;
    returns (max abs error of o, its relative error, lse error)."""
    o_p, lse_p = tfa.flash_forward_plain(q, k, v, causal=True)
    diff = (o.float() - o_p.float()).abs()
    err = diff.max().item()
    rel = (diff / (1 + o_p.float().abs())).max().item()
    lse_err = (lse - lse_p).abs().max().item()
    rel_tol, lse_tol = K9F_TOL[str(q.dtype).split(".")[-1]]
    if not (rel <= rel_tol and lse_err <= lse_tol):
        raise AssertionError(f"K9f disagrees with its plain version at "
                             f"{where}: abs {err}, rel {rel}, lse {lse_err}")
    return err, rel, lse_err


def kernel_phase_k9(torch, F, tfa, report):
    B, H, KVH, D = 2, 32, 8, 128
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    rows = {}
    # Prefill buckets of 256 and 1024 tokens, and a 4096-token prompt,
    # where each CTA's fixed costs (its first loads, its unoverlapped
    # first and last products) weigh least.
    for S in (256, 1024, 4096):
        q = torch.randn((B, S, H, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k = torch.randn((B, S, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn((B, S, KVH, D), generator=g, device=dev,
                        dtype=torch.bfloat16)
        o, lse = tfa.flash_forward(q, k, v, causal=True)
        err, rel, lse_err = check_k9f(torch, tfa, q, k, v, o, lse, f"S={S}")
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
                   "tflops": flops / (ms * 1e-3) / 1e12,
                   "vs_library": ms / library_ms}
        log(f"K9f flash_forward S={S}: err {err:.3e} (rel {rel:.3e}, lse "
            f"{lse_err:.3e})  kernel {ms:.4f} ms ({rows[S]['tflops']:.1f} "
            f"TFLOP/s)  plain {plain_ms:.4f} ms  SDPA {library_ms:.4f} ms  "
            f"kernel / SDPA {ms / library_ms:.3f}  bound {b_ms:.4f} ms "
            f"({b_by})")
    top = rows[1024]
    report["K9f"] = {
        "name": "flash_forward", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:98",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": top["ms"], "plain_ms": top["plain_ms"],
        "library_ms": top["library_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "tflops": top["tflops"],
        "vs_library": top["vs_library"],
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
                  seed=7, rows_spec=None, T=RAGGED_T):
    """Pools, block tables and a flat buffer of T tokens at LLAMA3_8B
    shapes for ``rows_spec`` [(start, len)] (default RAGGED_ROWS; row r
    owns slot r and shuffled pages)."""
    spec = rows_spec or RAGGED_ROWS
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    R = len(spec)
    P = R * maxp + 1
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(seed))
    bt = torch.full((R, maxp), P - 1, dtype=torch.int32)
    for r, (start, n) in enumerate(spec):
        live = -(-(start + n) // page)
        bt[r, :live] = perm[r * maxp: r * maxp + live].to(torch.int32)
    rows = row_tensors(torch, spec)
    q = torch.randn((T, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    kn = torch.randn((T, KVH, D), generator=g, device=dev,
                     dtype=torch.bfloat16)
    vn = torch.randn_like(kn)
    return k, v, q, kn, vn, rows, bt.to(dev)


def row_tensors(torch, spec):
    """(slot, start, len, off) int32 row tensors on the card for ``spec``
    [(start, len)], row r on slot r, packed in order."""
    offs, at = [], 0
    for _s, n in spec:
        offs.append(at)
        at += n
    return [torch.tensor(a, dtype=torch.int32, device="cuda") for a in (
        list(range(len(spec))), [s for s, _ in spec], [n for _, n in spec],
        offs)]


def k4_work(rows, H, KVH, D, page, int8, bt_elems):
    """K4's bound terms for ``rows`` [(start, len)]: bytes of q, the
    fresh k/v and the pooled past (with its pages' scales, for int8) read
    once, the f32 output written once, the block table and the row
    descriptors; operations of q.k and p.v over every attended key."""
    n = sum(n for _, n in rows)
    past = sum(s for s, _ in rows)
    past_pages = sum(-(-s // page) for s, _ in rows)
    attended = sum(n * s + n * (n + 1) // 2 for s, n in rows)
    past_bytes = 2 * past * KVH * D * (1 if int8 else 2) \
        + (2 * past_pages * KVH * 4 if int8 else 0)
    nbytes = (n * H * D * 2 + 2 * n * KVH * D * 2 + past_bytes
              + n * H * D * 4 + bt_elems * 4 + 4 * len(RAGGED_ROWS) * 4)
    return nbytes, 4 * attended * H * D


def kernel_phase_k4(torch, F, trpa, report, int8=False):
    L, H, KVH, D = 32, 32, 8, 128
    k, v, q, kn, vn, rows, bt = ragged_inputs(torch)
    scales = {}
    if int8:
        g = torch.Generator(device="cuda").manual_seed(17)
        k, v, ks, vs = int8_pools(torch, g, tuple(k.shape))
        scales = {"k_scales": ks, "v_scales": vs}
    tag = "K4 int8" if int8 else "K4"
    T = q.shape[0]
    err = 0.0
    covered = sum(n for _, n in RAGGED_ROWS)  # the buffer's tail is empty
    for layer in range(L):
        got = trpa.ragged_paged_attention(q, kn, vn, k, v, layer, *rows, bt,
                                          **scales)
        want = trpa.ragged_paged_attention_plain(q, kn, vn, k, v, layer,
                                                 *rows, bt, **scales)
        err = max(err, (got - want).abs().max().item())
        if got[covered:].any():
            raise AssertionError(f"{tag}: tokens no row covers must be zero")
    # The Hopper kernel: bf16 q and bf16 (or int8) pages are exact in
    # bf16 and the products sum in f32; p goes to P.V split hi + lo (2^-17
    # of p dropped); the plain version is f32 throughout (int8: it
    # dequantises first, the kernel scales the score).
    if err > 1e-3:
        raise AssertionError(f"{tag} disagrees with its plain version: "
                             f"{err} (tolerance 1e-3)")
    ms = time_ms(torch, lambda i: trpa.ragged_paged_attention(
        q, kn, vn, k, v, i % L, *rows, bt, **scales))
    plain_ms = time_ms(torch, lambda i: trpa.ragged_paged_attention_plain(
        q, kn, vn, k, v, i % L, *rows, bt, **scales), n=4, blocks=3)
    # Library yardstick: one SDPA over each row's pre-gathered, padded
    # dense k/v (pooled past then fresh keys) with a boolean causal mask.
    R = len(RAGGED_ROWS)
    page, maxp = k.shape[3], bt.shape[1]
    lq = max(n for _, n in RAGGED_ROWS)
    lk = max(s + n for s, n in RAGGED_ROWS)
    qd = torch.zeros((R, H, lq, D), dtype=q.dtype, device=q.device)
    kd = torch.zeros((L, R, KVH, lk, D), dtype=k.dtype, device=k.device)
    vd = torch.zeros_like(kd)
    # int8: the pooled keys stay int8 in kd/vd with a scale per key beside
    # them (1 on the fresh keys, which are rounded to int8 here only to
    # share the tensor: the yardstick's time, not its values, is used).
    ksd = torch.ones((L, R, KVH, lk, 1), dtype=q.dtype, device=q.device)
    vsd = torch.ones_like(ksd)
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
        if int8:
            for sd, sc in ((ksd, ks), (vsd, vs)):
                sd[:, r, :, :start] = sc[:, pages].permute(0, 2, 1, 3) \
                    .repeat_interleave(page, dim=2)[:, :, :start].to(q.dtype)
        kd[:, r, :, start:start + n] = kn[at:at + n].permute(1, 0, 2)
        vd[:, r, :, start:start + n] = vn[at:at + n].permute(1, 0, 2)
        qd[r, :, :n] = q[at:at + n].permute(1, 0, 2)
        i = torch.arange(n, device=q.device)
        mask[r, 0, :n] = (torch.arange(lk, device=q.device)[None, :]
                          <= start + i[:, None])
        at += n
    if int8:
        dense = lambda i: (kd[i % L].to(q.dtype) * ksd[i % L],  # noqa: E731
                           vd[i % L].to(q.dtype) * vsd[i % L])
    else:
        dense = lambda i: (kd[i % L], vd[i % L])  # noqa: E731
    try:
        F.scaled_dot_product_attention(qd, *dense(0), attn_mask=mask,
                                       enable_gqa=True)
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qd, *dense(i), attn_mask=mask, enable_gqa=True)
    except TypeError:
        rep = H // KVH
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qd, *(t.repeat_interleave(rep, dim=1) for t in dense(i)),
            attn_mask=mask)
    library_ms = time_ms(torch, lib)
    nbytes, flops = k4_work(RAGGED_ROWS, H, KVH, D, page, int8,
                            bt.numel())
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    # The mix's two kinds of rows alone (the others set to length 0):
    # the decode rows' past walks, and the chunk row's tensor-core work.
    parts = {}
    for part, keep in (("decode_rows", lambda n: n == 1),
                       ("chunk_row", lambda n: n > 1)):
        sub = [(s_, n) for s_, n in RAGGED_ROWS if keep(n)]
        lens = torch.tensor([n if keep(n) else 0 for _, n in RAGGED_ROWS],
                            dtype=torch.int32, device=q.device)
        sub_rows = [rows[0], rows[1], lens, rows[3]]
        part_ms = time_ms(torch, lambda i: trpa.ragged_paged_attention(
            q, kn, vn, k, v, i % L, *sub_rows, bt, **scales))
        pb, pf = k4_work(sub, H, KVH, D, page, int8, bt.numel())
        p_ms, p_by = bound(pb, pf, BF16_FLOPS)
        parts[part] = {"ms": part_ms, "bound_ms": p_ms, "bound_by": p_by,
                       "rows": sub}
        log(f"  {tag} {part} alone: {part_ms:.4f} ms  bound {p_ms:.5f} ms "
            f"({p_by})")
    report["K4i8" if int8 else "K4"] = {
        "name": "ragged_paged_attention"
                + (" (int8 pools)" if int8 else ""), "route": "cuda",
        "source": "ray_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "ray_tpu/ops/ragged_paged_attention.py:303",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"T={T} H={H} KVH={KVH} D={D} page={page} q bf16, pools "
                 f"{'int8 + f32 page scales' if int8 else 'bf16'}, rows "
                 f"(start, len) {RAGGED_ROWS}, layer cycling over L={L}",
        "bound_bytes": nbytes, "bound_flops": flops, "parts": parts,
    }
    log(f"{tag} ragged_paged_attention: err {err:.3e}  kernel {ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  {'dequantise + ' if int8 else ''}SDPA "
        f"{library_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by})")


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


def growing(torch, base, count, ratio=1.3):
    """``count`` copies of ``base`` with magnitudes growing by ``ratio``:
    fed one after the other, each outgrows the page scales the one before
    left, so every call of a quantising append requantises its pages."""
    return [(base.float() * ratio ** i).to(base.dtype) for i in range(count)]


def compare_quantised(tag, got, want, live):
    """Pools and scales of a quantising append against the plain
    version's: bit for bit on the ``live`` pages; every scale finite."""
    for a, b in zip(got[:2], want[:2]):
        if not torch_equal(a[:, :, :live], b[:, :, :live]):
            raise AssertionError(f"{tag}: stored bytes differ from the plain "
                                 "version's")
    for a, b in zip(got[2:], want[2:]):
        if not torch_equal(a[:, :live], b[:, :live]):
            raise AssertionError(f"{tag}: page scales differ from the plain "
                                 "version's")
        if not a.isfinite().all():
            raise AssertionError(f"{tag}: a page scale is not finite")


def torch_equal(a, b) -> bool:
    return a.shape == b.shape and bool((a == b).all())


def _k3_cases(torch, tpa, g, B):
    """K3 against its plain version at LLAMA3_8B widths and B slots, one
    page each: stored bytes and scales equal bit for bit, through fresh
    pages, stable and grown scales, all-zero rows and inactive slots.  At
    8 slots each slot is one named case (the fresh page, the stable ones
    and the zero row in one row, the grown ones whole, checked); at 48 the
    cases cycle over the slots."""
    L, KVH, D, page = 32, 8, 128, 64
    P = 8 * 16 + 1
    k, v, ks, vs = int8_pools(torch, g, (L, KVH, P, page, D))
    if B == 8:
        # Slot 0 opens a fresh page, 1 and 2 fit their page's scale, 3 is
        # inactive (scratch page), 4-6 outgrow the scale, 7 is all zeros.
        pids = torch.tensor([5, 17, 40, P - 1, 77, 2, 127, 64],
                            dtype=torch.int32, device="cuda")
        offs = torch.tensor([0, 1, 63, 9, 32, 17, 5, 62], dtype=torch.int32,
                            device="cuda")
        mag = torch.tensor([1.0, 0.01, 0.02, 1.0, 30.0, 60.0, 9.0, 0.0],
                           device="cuda")
    else:
        pids = torch.randperm(P - 1, generator=g, device="cuda")[:B].to(
            torch.int32)
        pids[3::11] = P - 1
        offs = torch.randint(1, page, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        offs[::7] = 0
        mag = torch.tensor([0.0, 0.01, 0.3, 1.0, 5.0, 40.0],
                           device="cuda")[torch.arange(B, device="cuda") % 6]
    mag = mag[None, :, None, None]
    k_new = (torch.randn((L, B, KVH, D), generator=g, device="cuda")
             * mag).to(torch.bfloat16)
    v_new = (torch.randn((L, B, KVH, D), generator=g, device="cuda")
             * mag).to(torch.bfloat16)
    got = [t.clone() for t in (k, v, ks, vs)]
    want = [t.clone() for t in (k, v, ks, vs)]
    tpa.paged_append_quantized(*got, k_new, v_new, pids, offs)
    tpa.paged_append_quantized_plain(*want, k_new, v_new, pids, offs)
    torch.cuda.synchronize()
    compare_quantised(f"K3 at {B} slots", got, want, P - 1)
    if B == 8:
        pages_changed = int((got[0][:, :, : P - 1] != k[:, :, : P - 1])
                            .any(dim=-1).any(dim=-1).sum())
        # Seven live slots, one page each: the fresh page and the three
        # grown ones change whole, the stable ones (the zero row's too) in
        # one row.
        if pages_changed != L * KVH * 7:
            raise AssertionError(f"K3 changed {pages_changed} pages, want "
                                 f"{L * KVH * 7}")
        if not torch_equal(got[2][:, 17], ks[:, 17]) \
                or not (got[2][:, 77] > ks[:, 77]).all():
            raise AssertionError("K3: a stable scale moved or a grown one "
                                 "did not")
    return k, v, ks, vs, k_new, v_new, pids, offs


def _k3_times(torch, tpa, g, B, state):
    """K3 timed with every scale stable (the common case: D bytes written
    per slot, layer and kv head) and with every page requantised (inputs
    growing call by call), beside the plain version and the bounds."""
    k, v, ks, vs, k_new, v_new, pids, offs = state
    L, KVH, P, page, D = k.shape
    ks.fill_(100.0)  # scales that hold any row of this magnitude
    vs.fill_(100.0)
    offs_c = offs.clamp(min=1)
    ms = time_ms(torch, lambda i: tpa.paged_append_quantized(
        k, v, ks, vs, k_new, v_new, pids, offs_c))
    plain_ms = time_ms(torch, lambda i: tpa.paged_append_quantized_plain(
        k, v, ks, vs, k_new, v_new, pids, offs_c), n=4, blocks=3)
    if not bool((ks == 100.0).all()):
        raise AssertionError("K3 common case: a scale moved")
    # Whole-page rewrite: every call outgrows the scales of the last.
    n, blocks = 5, 3
    base = torch.randn((L, B, KVH, D), generator=g, device="cuda").to(
        torch.bfloat16)
    feed = growing(torch, base, 3 + n * blocks)
    ks.fill_(1e-3)
    vs.fill_(1e-3)
    calls = iter(feed)

    def grow(i):
        x = next(calls)
        tpa.paged_append_quantized(k, v, ks, vs, x, x, pids, offs_c)

    rewrite_ms = time_ms(torch, grow, n=n, blocks=blocks)
    rows_b = 2 * L * B * KVH * D
    common_bytes = rows_b * 2 + rows_b + 2 * 2 * L * B * KVH * 4 + 2 * B * 4
    rewrite_bytes = common_bytes + 2 * (2 * L * B * KVH * (page - 1) * D)
    b_ms, b_by = bound(common_bytes, 0, F32_FLOPS)
    rb_ms, _ = bound(rewrite_bytes, 0, F32_FLOPS)
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "rewrite_ms": rewrite_ms, "rewrite_bound_ms": rb_ms,
            "bound_bytes": common_bytes, "rewrite_bound_bytes": rewrite_bytes,
            "shape": f"L={L} B={B} KVH={KVH} D={D} page={page}, rows bf16, "
                     "pools int8; ms = stable scales (rows only), "
                     "rewrite_ms = every page requantised"}


def kernel_phase_k3(torch, tpa, report, floor_ms):
    runs = {}
    for B in K2_SLOTS:
        g = torch.Generator(device="cuda").manual_seed(21 + B)
        runs[B] = _k3_times(torch, tpa, g, B, _k3_cases(torch, tpa, g, B))
        torch.cuda.empty_cache()
    report["K3"] = {
        "name": "paged_append_quantized", "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_append_quantized.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:456",
        **runs[8], "launch_floor_ms": floor_ms, "slots48": runs[48]}
    for B, r in runs.items():
        log(f"K3 paged_append_quantized at {B} slots: bytes and scales equal "
            f"the plain version's  common case {r['ms']:.5f} ms (previous "
            f"design at 8 slots: {PREVIOUS_MS['K3']} ms; bound "
            f"{r['bound_ms']:.5f} ms, {r['bound_by']}, "
            f"{r['bound_ms'] / r['ms']:.1%} of it; launch floor "
            f"{floor_ms:.5f} ms)  every page rewritten "
            f"{r['rewrite_ms']:.4f} ms (bound {r['rewrite_bound_ms']:.4f} "
            f"ms)  plain {r['plain_ms']:.4f} ms  no single library call")


def k6_page_counts(rows, page):
    """(pages the rows' fresh tokens touch, those of them extended past
    older tokens, cells of fresh pages beyond the landing tokens)."""
    touched = extended = fresh_tail = 0
    for s, n in rows:
        for pg in range(s // page, (s + n - 1) // page + 1 if n else 0):
            touched += 1
            if pg * page >= s:
                fresh_tail += max(0, (pg + 1) * page - (s + n))
            else:
                extended += 1
    return touched, extended, fresh_tail


def kernel_phase_k6(torch, trpa, report):
    """K6 at the 8B ragged mix: seven decode rows extending pages beside
    a 256-token chunk opening four fresh pages.  Timed with the decode
    rows' scales stable (the common case) and with their pages
    requantised on every call."""
    kb, _vb, _q, kn, _vn, rows, bt = ragged_inputs(torch, seed=8)
    L, KVH, P, page, D = kb.shape
    T = kn.shape[0]
    del kb, _vb
    g = torch.Generator(device="cuda").manual_seed(23)
    k, v, ks, vs = int8_pools(torch, g, (L, KVH, P, page, D))
    # Per token magnitudes: some rows fit their page's scale, some do not.
    mag = (torch.rand((1, T, 1, 1), generator=g, device="cuda") * 4.0)
    k_new = (torch.randn((L, T, KVH, D), generator=g, device="cuda")
             * mag).to(torch.bfloat16)
    v_new = (torch.randn((L, T, KVH, D), generator=g, device="cuda")
             * 0.001).to(torch.bfloat16)
    got = [t.clone() for t in (k, v, ks, vs)]
    want = [t.clone() for t in (k, v, ks, vs)]
    trpa.ragged_paged_append_quantized(*got, k_new, v_new, *rows, bt)
    trpa.ragged_paged_append_quantized_plain(*want, k_new, v_new, *rows, bt)
    torch.cuda.synchronize()
    compare_quantised("K6", got, want, P - 1)
    touched, extended, fresh_tail = k6_page_counts(RAGGED_ROWS, page)
    moved = int((got[2][:, : P - 1] != ks[:, : P - 1]).any(dim=0)
                .any(dim=-1).any(dim=-1).sum())
    kept = int((got[3][:, : P - 1] == vs[:, : P - 1]).all(dim=0)
               .all(dim=-1).all(dim=-1).sum())
    if moved > touched or kept < P - 1 - touched:
        raise AssertionError(f"K6 moved the scales of {moved} pages, kept "
                             f"{kept}; the rows touch {touched}")
    if not torch_equal(got[0][:, :, -1], k[:, :, -1]):
        raise AssertionError("K6 wrote the scratch page")
    err = 0.0
    del got, want

    ks.fill_(1.0)
    vs.fill_(1.0)
    ms = time_ms(torch, lambda i: trpa.ragged_paged_append_quantized(
        k, v, ks, vs, k_new, v_new, *rows, bt))
    plain_ms = time_ms(torch, lambda i:
                       trpa.ragged_paged_append_quantized_plain(
                           k, v, ks, vs, k_new, v_new, *rows, bt),
                       n=4, blocks=3)
    n, blocks = 5, 3
    feed = growing(torch, k_new, 3 + n * blocks)
    ks.fill_(1e-3)
    vs.fill_(1e-3)
    calls = iter(feed)

    def grow(i):
        x = next(calls)
        trpa.ragged_paged_append_quantized(k, v, ks, vs, x, x, *rows, bt)

    rewrite_ms = time_ms(torch, grow, n=n, blocks=blocks)
    covered = sum(n_ for _, n_ in RAGGED_ROWS)
    tok_b = 2 * L * covered * KVH * D
    common_bytes = tok_b * 2 + tok_b + 2 * 2 * L * touched * KVH * 4 \
        + 4 * len(RAGGED_ROWS) * 4 + bt.numel() * 4
    # A fresh page is zeroed beyond its landing tokens; an extended page
    # whose scale grew is read and written whole.
    common_bytes += 2 * L * KVH * fresh_tail * D
    rewrite_bytes = common_bytes + 2 * (2 * L * KVH * extended * page * D)
    b_ms, b_by = bound(common_bytes, 0, F32_FLOPS)
    rb_ms, _ = bound(rewrite_bytes, 0, F32_FLOPS)
    report["K6"] = {
        "name": "ragged_paged_append_quantized", "route": "cuda",
        "source": "ray_tpu_torch/csrc/ragged_append_quantized.cu",
        "replaces": "ray_tpu/ops/ragged_paged_attention.py:562",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "rewrite_ms": rewrite_ms, "rewrite_bound_ms": rb_ms,
        "bound_bytes": common_bytes, "rewrite_bound_bytes": rewrite_bytes,
        "shape": f"L={L} T={T} KVH={KVH} D={D} page={page}, rows bf16, "
                 f"pools int8, rows {RAGGED_ROWS}; ms = stable scales on the "
                 "decode rows' pages, rewrite_ms = those pages requantised",
    }
    log(f"K6 ragged_paged_append_quantized: bytes and scales equal the "
        f"plain version's  common case {ms:.5f} ms (previous design: "
        f"{PREVIOUS_MS['K6']} "
        f"ms; bound {b_ms:.4f} ms, "
        f"{b_by})  extended pages rewritten {rewrite_ms:.4f} ms (bound "
        f"{rb_ms:.4f} ms)  plain {plain_ms:.4f} ms  no single library call")


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


INT8 = " (int8 pools)"
K1, K3 = "paged_decode_attention_partial", "paged_append_quantized"
K4, K6 = "ragged_paged_attention", "ragged_paged_append_quantized"


WALK = " (page walk)"
_SUB_COUNTS = (("launches_int8", INT8), ("launches_walk", WALK))


def reset_counts(kernels) -> None:
    for fn in kernels.values():
        fn.launches = 0
        for attr, _ in _SUB_COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def read_counts(kernels) -> dict:
    """Launches of every kernel since ``reset_counts``; K1 and K4 also
    under ``name + INT8`` for their int8 instantiations, K1 and K13 under
    ``name + WALK`` for their page-walk route (each a part of the name's
    own count)."""
    out = {name: fn.launches for name, fn in kernels.items()}
    for attr, suffix in _SUB_COUNTS:
        out.update({name + suffix: getattr(fn, attr)
                    for name, fn in kernels.items() if hasattr(fn, attr)})
    return out


def int8_parity_phase(torch, llama, eng_mod, kernels):
    """Tiny f32 Llama with int8 KV pools, and the prefix cache: the
    engine on the card (kernels) against the engine on the CPU (plain
    versions), identical greedy streams.  Three runs: bucketed int8 (K1
    int8, K3), ragged int8 (K4 int8, K6), and the ragged engine with the
    prefix cache on int8 pools, fed one request after the other (a cold
    prompt, a partial hit, and the first prompt again: an exact
    full-prompt hit, which copies the deepest shared page)."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=512,
                              dtype=torch.float32, kv_int8=True)
    cpu_params = llama.init_params(torch.Generator().manual_seed(2), cfg,
                                   device="cpu", dtype=torch.float32)
    base = dict(max_slots=4, max_seq_len=512, page_size=64, decode_chunk=8,
                max_new_tokens_default=16)
    ragged = dict(base, ragged_batching=True, prefill_chunk=64)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 70, 150, 300, 33)]
    shared = rng.integers(0, cfg.vocab_size, 128).tolist()
    cached = [shared, shared + rng.integers(0, cfg.vocab_size, 20).tolist(),
              shared]
    runs = {"bucketed": (base, prompts, False, (K1 + INT8, K3)),
            "ragged": (ragged, prompts, False, (K4 + INT8, K6)),
            "prefix": (dict(ragged, prefix_cache=True), cached, True,
                       (K4 + INT8, K6))}
    out = {}
    for name, (kw, reqs, one_by_one, must) in runs.items():
        streams, counts, hits = {}, {}, {}
        for device in ("cuda", "cpu"):
            reset_counts(kernels)
            eng = eng_mod.LLMEngine(_to(cpu_params, device),
                                    eng_mod.llama_paged_adapter(cfg),
                                    eng_mod.EngineConfig(**kw), device=device)
            try:
                if one_by_one:
                    streams[device] = [eng.submit(p).result(timeout_s=300)
                                       for p in reqs]
                    hits[device] = eng.stats()["prefix"]["hit_tokens"]
                else:
                    streams[device] = [s.result(timeout_s=300) for s in
                                       [eng.submit(p) for p in reqs]]
            finally:
                eng.shutdown()
            counts[device] = read_counts(kernels)
        if any(counts["cuda"][k] == 0 for k in must) \
                or any(counts["cpu"].values()):
            raise AssertionError(f"int8 parity ({name}): kernel launches "
                                 f"{counts}")
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"int8 {name} greedy streams differ: cuda "
                                 f"{streams['cuda']} vs cpu {streams['cpu']}")
        if one_by_one and (hits["cuda"] != hits["cpu"]
                           or hits["cuda"] != 128 + 127):
            raise AssertionError(f"prefix parity: hit tokens {hits}, want "
                                 f"{128 + 127} on both")
        tokens = sum(len(s) for s in streams["cuda"])
        log(f"int8 parity ({name}): LLAMA_TINY f32 weights, int8 pools, "
            f"{len(reqs)} prompts of {[len(p) for p in reqs]} tokens: cuda "
            f"== cpu greedy streams ({tokens} tokens; launches "
            f"{ {k: counts['cuda'][k] for k in must} }"
            + (f"; prefix hit tokens {hits['cuda']}" if one_by_one else "")
            + ")")
        out[name] = {"prompts": [len(p) for p in reqs], "tokens": tokens,
                     "launches": {k: counts["cuda"][k] for k in must},
                     "prefix_hit_tokens": hits.get("cuda")}
    return out


def int8_serving_phase(torch, llama, eng_mod, kernels, card, params):
    """LLAMA3_8B with int8 KV pools at full width and depth.  The ragged
    engine with the prefix cache serves the bf16 ragged phase's traffic,
    then two prompts sharing a 512-token prefix, the second submitted
    once the first has finished and donated its pages; then a short
    bucketed run."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(llama.LLAMA3_8B, kv_int8=True)
    torch.cuda.reset_peak_memory_stats()
    ecfg = eng_mod.EngineConfig(max_slots=8, max_seq_len=2048, page_size=64,
                                decode_chunk=8, ragged_batching=True,
                                prefill_chunk=256, prefix_cache=True)
    eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg), ecfg,
                            device="cuda")
    rng = np.random.default_rng(13)
    lens = (17, 300, 700, 1500)
    late_len, tail = 1000, (40, 75)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    late_prompt = rng.integers(0, cfg.vocab_size, late_len).tolist()
    shared = rng.integers(0, cfg.vocab_size, 512).tolist()
    pair = [shared + rng.integers(0, cfg.vocab_size, n).tolist()
            for n in tail]
    new = 32
    try:
        cache = eng._cache
        pool_bytes = {key: t.numel() * t.element_size()
                      for key, t in cache.items()}
        if cache["k"].dtype != torch.int8 or "k_scale" not in cache:
            raise AssertionError("the 8B int8 engine did not build int8 "
                                 "pools")
        # Warm-up request (allocator growth): not part of the measured
        # run; 5 tokens donate no page.
        eng.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        st0 = eng.stats()
        reset_counts(kernels)
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new) for p in prompts]
        it = iter(streams[0])
        first0 = [next(it)]
        late = eng.submit(late_prompt, max_new_tokens=new)
        outs = [first0 + list(it)]
        outs += [s.result(timeout_s=600) for s in streams[1:]]
        outs.append(late.result(timeout_s=600))
        cold = eng.submit(pair[0], max_new_tokens=new)
        outs.append(cold.result(timeout_s=600))
        hit = eng.submit(pair[1], max_new_tokens=new)
        outs.append(hit.result(timeout_s=600))
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
        st1 = eng.stats()
        reqs = [s._req for s in streams] + [late._req, cold._req, hit._req]
        if not torch.isfinite(cache["k_scale"]).all() \
                or not torch.isfinite(cache["v_scale"]).all():
            raise AssertionError("8B int8: a page scale is not finite")
    finally:
        eng.shutdown()
    steps = st1["steps"] - st0["steps"]
    step_tokens = {k: st1["step_tokens"][k] - st0["step_tokens"][k]
                   for k in st1["step_tokens"]}
    for out in outs:
        if len(out) != new or not all(0 <= t < cfg.vocab_size for t in out):
            raise AssertionError(f"8B int8 ragged stream malformed: {out}")
    k4, k6 = launches[K4 + INT8], launches[K6]
    if steps == 0 or k4 != cfg.n_layers * steps or k6 != steps \
            or launches[K4] != k4 or launches["ragged_paged_append"] \
            or launches[K1] or launches["paged_append"] or launches[K3]:
        raise AssertionError(f"8B int8 ragged: launches {launches} over "
                             f"{steps} ragged steps, want K4 int8 "
                             f"{cfg.n_layers} and K6 1 per step and no other "
                             "paged kernel")
    hit_tokens = st1["prefix"]["hit_tokens"] - st0["prefix"]["hit_tokens"]
    if hit._req.prefix_hit != 512 or hit_tokens != 512:
        raise AssertionError(f"8B int8: prefix hit {hit._req.prefix_hit} "
                             f"(engine total {hit_tokens}), want 512")
    want_prefill = sum(lens) + late_len + 2 * 512 + sum(tail) - 512
    if step_tokens["prefill"] != want_prefill:
        raise AssertionError(f"8B int8 ragged: {step_tokens['prefill']} "
                             f"prompt tokens dispatched, want {want_prefill}")
    # A prompt shorter than one chunk attends only to its own fresh k/v:
    # its first token does not depend on the int8 pool at all.
    check_first_token(torch, llama, params, cfg, prompts[0], outs[0][0],
                      "8B int8 ragged serving")
    # The hit request read 512 tokens of int8 KV it never computed: its
    # first token must still rank at the top of a dense bf16 forward.
    hit_rank = first_token_rank(torch, llama, params, cfg, pair[1],
                                outs[-1][0])
    if hit_rank >= 20:
        raise AssertionError(f"8B int8: the prefix-hit request's first token "
                             f"ranks {hit_rank} in the dense forward")
    peak = torch.cuda.max_memory_allocated() / 1e9
    ragged = {
        "config": "LLAMA3_8B bf16 weights, int8 KV pools, 32 layers, random "
                  "weights (seed 0)",
        "engine": "max_slots=8 max_seq_len=2048 page_size=64 decode_chunk=8 "
                  "ragged_batching=True prefill_chunk=256 prefix_cache=True",
        "prompt_lens": list(lens) + [late_len] + [len(p) for p in pair],
        "max_new_tokens": new, "wall_s": wall,
        "ttft_s": [r.first_token_at - r.submitted_at for r in reqs],
        "ragged_steps": steps,
        "mixed_steps": st1["mixed_steps"] - st0["mixed_steps"],
        "step_tokens": step_tokens,
        "engine_step_ms": wall / steps * 1e3, "launches": launches,
        "prefix": {k: st1["prefix"][k] for k in st1["prefix"]},
        "prefix_hit_tokens": hit_tokens,
        "prefix_hit_first_token_rank": hit_rank,
        "pool_bytes": pool_bytes, "peak_memory_gb": peak, "card": card,
    }
    log(f"8B int8 ragged serving with the prefix cache ({card}): TTFT "
        f"{[round(t, 4) for t in ragged['ttft_s']]} s (the last two share a "
        f"512-token prefix: hit {hit_tokens} tokens, first token rank "
        f"{hit_rank}), {steps} ragged steps ({ragged['mixed_steps']} mixed, "
        f"{ragged['engine_step_ms']:.2f} ms/step), tokens {step_tokens}, "
        f"pools {sum(pool_bytes.values()) / 1e9:.3f} GB (scales "
        f"{(pool_bytes['k_scale'] + pool_bytes['v_scale']) / 1e6:.2f} MB), "
        f"peak {peak:.2f} GB, launches {launches}")

    # The bucketed path on int8 pools: K1 (int8) per layer, K3 per step.
    ecfg = eng_mod.EngineConfig(max_slots=8, max_seq_len=1024, page_size=64,
                                decode_chunk=8)
    eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg), ecfg,
                            device="cuda")
    short = [prompts[0], prompts[1]]
    new_b = 16
    try:
        eng.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        steps0 = eng.stats()["steps"]
        reset_counts(kernels)
        t0 = time.perf_counter()
        b_streams = [eng.submit(p, max_new_tokens=new_b) for p in short]
        b_outs = [s.result(timeout_s=600) for s in b_streams]
        b_wall = time.perf_counter() - t0
        b_launches = read_counts(kernels)
        b_steps = eng.stats()["steps"] - steps0
    finally:
        eng.shutdown()
    for out in b_outs:
        if len(out) != new_b or not all(0 <= t < cfg.vocab_size
                                        for t in out):
            raise AssertionError(f"8B int8 bucketed stream malformed: {out}")
    if b_launches[K3] == 0 \
            or b_launches[K1 + INT8] != cfg.n_layers * b_launches[K3] \
            or b_launches[K1] != b_launches[K1 + INT8] \
            or b_launches[K1 + WALK] \
            or b_launches["paged_append"] or b_launches[K6] \
            or b_launches["flash_forward"] == 0:
        raise AssertionError(f"8B int8 bucketed: launches {b_launches}, want "
                             f"K1 int8 = {cfg.n_layers} x K3 > 0 on the "
                             "Hopper route, K9f > 0 and no K2")
    check_first_token(torch, llama, params, cfg, short[0], b_outs[0][0],
                      "8B int8 bucketed serving")
    bucketed = {"prompt_lens": [len(p) for p in short],
                "max_new_tokens": new_b, "wall_s": b_wall,
                "decode_steps": b_steps, "launches": b_launches,
                "ttft_s": [s.metrics["ttft_s"] for s in b_streams]}
    log(f"8B int8 bucketed serving: {b_steps} decode steps, TTFT "
        f"{[round(t, 4) for t in bucketed['ttft_s']]} s, launches "
        f"{b_launches}")
    return ragged, bucketed


def first_token_rank(torch, llama, params, cfg, prompt, token) -> int:
    """Rank (0 = argmax) of ``token`` among the dense forward's logits at
    the end of ``prompt`` (einsum attention, no pages, no int8)."""
    with torch.no_grad():
        logits = llama.forward(params, torch.tensor([prompt], device="cuda"),
                               cfg)
    last = logits[0, -1]
    if not torch.isfinite(last).all():
        raise AssertionError("8B forward logits are not finite")
    return int((last > last[token]).sum())


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
        reset_counts(kernels)
        steps0 = eng.stats()["steps"]
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new) for p in prompts]
        outs = [s.result(timeout_s=600) for s in streams]
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
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
            != cfg.n_layers * launches["paged_append"] \
            or launches["paged_decode_attention_partial" + INT8] \
            or launches["paged_decode_attention_partial" + WALK] \
            or launches["paged_append_quantized"]:
        raise AssertionError(f"K1 launches {launches} != L x K2 launches, an "
                             "int8 kernel ran on bf16 pools, or K1 left its "
                             "Hopper route")
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
        "outputs": outs,
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
        reset_counts(kernels)
        t0 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new) for p in prompts]
        it = iter(streams[0])
        first0 = [next(it)]
        late = eng.submit(late_prompt, max_new_tokens=new)
        outs = [first0 + list(it)]
        outs += [s.result(timeout_s=600) for s in streams[1:]]
        outs.append(late.result(timeout_s=600))
        wall = time.perf_counter() - t0
        launches = read_counts(kernels)
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
    if steps == 0 or k4 != cfg.n_layers * steps or k5 != steps \
            or launches["ragged_paged_attention" + INT8] \
            or launches["ragged_paged_append_quantized"]:
        raise AssertionError(f"8B ragged: K4 {k4} / K5 {k5} launches over "
                             f"{steps} ragged steps, want {cfg.n_layers} "
                             f"and 1 per step and no int8 kernel: {launches}")
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


# --------------------------------------------------------------------------
# the fused decode path over int8 weights (K7, K8)
# --------------------------------------------------------------------------

FUSED_SLOTS = 48                 # the bench's bucketed decode width
FUSED_TOL = 3e-2                 # bf16 outputs: |a - b| <= tol + tol |b|


def fused_layer_8b(torch, llama, quant, seed):
    """One LLAMA3_8B layer of the fused int8 artifact (init_quantized_llama
    from a seeded generator on the card, then fuse_for_decode), and its
    leaves' bytes (int8 weights, f32 scales, bf16 norms)."""
    import dataclasses

    cfg = dataclasses.replace(llama.LLAMA3_8B, n_layers=1, vocab_size=256)
    params = quant.fuse_for_decode(quant.init_quantized_llama(
        torch.Generator(device="cuda").manual_seed(seed), cfg,
        device="cuda"), cfg)
    layer = llama._layers(params["layers"], 1)[0]
    return layer, quant.quantized_bytes(params["layers"])


def fused_check(tag, got, want, tol):
    """Max abs error of (x_out, k_new, v_new) against the plain version;
    raises past tol + tol * |plain| or on a non-finite value."""
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    for name, a, b in zip(("x_out", "k_new", "v_new"), got, want):
        a, b = a.float(), b.float()
        if not a.isfinite().all() or ((a - b).abs()
                                      > tol + tol * b.abs()).any():
            raise AssertionError(f"{tag} disagrees with its plain version "
                                 f"on {name}: max error {err} (tolerance "
                                 f"{tol} + {tol}|plain|)")
    return err


def unfused_decode_layer(llama, tpa, cfg, layer, x, k, v, bt, lengths, sin,
                         cos, scales):
    """The port's unfused decode layer at the same shapes (eager ATen,
    the layer dequantised to bf16, K1 and combine_with_self): the body of
    decode_slots_paged's layer loop, the yardstick beside K7."""
    lay = llama._deq_layer(layer, cfg.dtype)
    B = x.shape[0]
    xx = x[:, None]
    normed = llama.rms_norm(xx, lay["ln_attn"], cfg.norm_eps)
    q, kk, vv = llama._qkv(normed, lay, cfg, sin[:, None], cos[:, None])
    acc, m, l = tpa.paged_decode_attention_partial(q[:, 0], k, v, 0, bt,
                                                   lengths, **scales)
    out = tpa.combine_with_self(q[:, 0], kk[:, 0], vv[:, 0], acc, m, l)
    wo = lay["attn"]["wo"]
    h = xx + (out.reshape(B, -1) @ wo.reshape(-1, wo.shape[-1]))[:, None]
    return h + llama._mlp_block(llama.rms_norm(h, lay["ln_mlp"],
                                               cfg.norm_eps), lay, cfg)


def unfused_ragged_layer(llama, trpa, cfg, layer, x, k, v, rows, bt, sin,
                         cos, scales):
    """The port's unfused ragged layer (eager ATen + K4), as in
    ragged_step_paged's layer loop."""
    lay = llama._deq_layer(layer, cfg.dtype)
    T = x.shape[0]
    normed = llama.rms_norm(x, lay["ln_attn"], cfg.norm_eps)
    q, kk, vv = llama._qkv(normed[None], lay, cfg, sin[None], cos[None])
    out = trpa.ragged_paged_attention(q[0], kk[0], vv[0], k, v, 0, *rows, bt,
                                      **scales)
    wo = lay["attn"]["wo"]
    h = x + out.to(cfg.dtype).reshape(T, -1) @ wo.reshape(-1, wo.shape[-1])
    return h + llama._mlp_block(llama.rms_norm(h, lay["ln_mlp"],
                                               cfg.norm_eps), lay, cfg)


def kernel_breakdown(torch, fn, reps: int = 3) -> dict:
    """Device ms per call of each CUDA kernel that ``fn`` launches, from
    torch.profiler (CUPTI) over ``reps`` calls; an "error" entry where the
    profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError as e:  # no CUPTI here: report, don't guess
        return {"error": repr(e)[:200]}
    out = {}
    for evt in events:
        us = getattr(evt, "device_time_total", 0) or getattr(
            evt, "cuda_time_total", 0)
        if us:
            m = re.search(r"(\w+_kernel|\w+Kernel\w*|\w+)(<[^(]*>)?\(",
                          evt.key)
            name = (m.group(1) + (m.group(2) or "")) if m else evt.key[:50]
            out[name] = out.get(name, 0.0) + us / reps / 1e3
    return out or {"error": "the profiler recorded no device time"}


def _fmt_breakdown(bd: dict) -> str:
    if "error" in bd:
        return f"not measured ({bd['error']})"
    return ", ".join(f"{k} {v:.4f}" for k, v in
                     sorted(bd.items(), key=lambda kv: -kv[1]))


def phase_groups(phases: dict) -> dict:
    """A fused layer's device ms per call by part: the projections (the
    WGMMA, DECODE and CUDA-core projection kernels with their epilogue),
    the attention, and the rest (norms, RoPE)."""
    if "error" in phases:
        return phases
    out = {"projections": 0.0, "attention": 0.0, "rest": 0.0}
    for name, ms in phases.items():
        key = ("projections" if any(p in name for p in (
            "proj_", "gemv", "epilogue")) else "attention"
            if "attn" in name or "attention" in name else "rest")
        out[key] += ms
    return out


def _layer_flops(T, D, H, KVH, hd, M):
    return 2 * T * (D * (H + 2 * KVH) * hd + H * hd * D + D * 2 * M + M * D)


def projection_yardstick(torch, llama, layer, phases, T, cfg) -> dict:
    """The fused layer's projection phase (its WGMMA launches, from the
    profile ``phases``) beside a yardstick: the four projections as
    ``torch.matmul`` on the same weights dequantised to bf16, on T random
    bf16 rows (``proj_cublas_ms``, a cuBLAS call the port never makes),
    each with its TFLOP/s."""
    D, H, KVH, hd, M = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.mlp_dim)
    lay = llama._deq_layer(layer, torch.bfloat16)
    ws = [lay["attn"]["wqkv"].reshape(D, -1),
          lay["attn"]["wo"].reshape(H * hd, D),
          lay["mlp"]["w_gateup"].reshape(D, -1),
          lay["mlp"]["w_down"].reshape(M, D)]
    g = torch.Generator(device="cuda").manual_seed(28)
    acts = [torch.randn((T, w.shape[0]), generator=g, device="cuda")
            .to(torch.bfloat16) for w in ws]
    cublas_ms = time_ms(torch, lambda i: [a @ w for a, w in zip(acts, ws)])
    flops = _layer_flops(T, D, H, KVH, hd, M)
    out = {"proj_cublas_ms": cublas_ms,
           "proj_cublas_tflops": flops / cublas_ms / 1e9,
           "proj_flops": flops}
    if "error" not in phases:
        proj_ms = sum(v for k_, v in phases.items() if "proj_wgmma" in k_)
        out["proj_ms"] = proj_ms or None
        out["proj_tflops"] = flops / proj_ms / 1e9 if proj_ms else None
        out["attn_ms"] = sum(v for k_, v in phases.items()
                             if "attention" in k_) or None
    log(f"  projections: {out.get('proj_ms')} ms "
        f"({out.get('proj_tflops')} TFLOP/s); torch.matmul on the "
        f"dequantised bf16 weights {cublas_ms:.4f} ms "
        f"({out['proj_cublas_tflops']:.1f} TFLOP/s)")
    return out


def k7_attention_on_k4(torch, tfd, trpa, k, v, bt, lengths, H, scales):
    """K7's attention as K4's Hopper route (ragged_attention.cuh's decode
    rows) would compute it over the same slots and pools: each slot a row
    of one token at its past, q rounded to bf16 as K7's page dot takes
    it.  Its time (``k4_ms``, beside K7's attention phase), and its
    largest distance from K7's rounding (the plain version's page walk:
    p rounded to bf16 for p.v, the self term from the f32 q) and from its
    own inputs' attention in f32 throughout."""
    B, hd = bt.shape[0], k.shape[-1]
    KVH = k.shape[1]
    g = torch.Generator(device="cuda").manual_seed(24)
    q = torch.randn((B, H, hd), generator=g, device="cuda")
    kn = torch.randn((B, KVH, hd), generator=g, device="cuda").to(
        torch.bfloat16)
    vn = torch.randn_like(kn)
    ar = torch.arange(B, dtype=torch.int32, device="cuda")
    rows = (ar, lengths, torch.ones_like(lengths), ar)
    qb = q.to(torch.bfloat16)

    def k4(i):
        return trpa.ragged_paged_attention(qb, kn, vn, k, v, 0, *rows, bt,
                                           **scales)

    ks, vs = scales.get("k_scales"), scales.get("v_scales")
    want = tfd._decode_attention_reference(q, kn, vn, k, v, 0, bt, lengths,
                                           torch.bfloat16, None, ks, vs)
    f32 = tfd._decode_attention_reference(qb.float(), kn, vn, k, v, 0, bt,
                                          lengths, torch.float32, None, ks,
                                          vs)
    got = k4(0)
    return {"k4_ms": time_ms(torch, k4),
            "k4_from_k7_rounding": (got - want).abs().max().item(),
            "k4_from_f32": (got - f32).abs().max().item()}


def kernel_phase_k7(torch, llama, quant, tfd, tpa, trpa, report,
                    int8=False):
    """K7 at the bench's bucketed shape: 48 slots with 128-160 past
    tokens, page 64, one LLAMA3_8B layer of the fused int8 artifact."""
    cfg = llama.LLAMA3_8B
    D, H, KVH, hd, M = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.mlp_dim)
    layer, w_bytes = fused_layer_8b(torch, llama, quant, 21)
    B, page, maxp = FUSED_SLOTS, 64, 4
    P = B * maxp + 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    scales = {}
    if int8:
        k, v, ks, vs = int8_pools(torch, g, (1, KVH, P, page, hd))
        scales = {"k_scales": ks, "v_scales": vs}
    else:
        k = torch.randn((1, KVH, P, page, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
        v = torch.randn_like(k)
    x = torch.randn((B, D), generator=g, device=dev).to(torch.bfloat16)
    lengths = torch.randint(128, 161, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(23))
    bt = perm[: B * maxp].reshape(B, maxp).to(torch.int32).to(dev)
    sin, cos = llama.rope_table(cfg, lengths[:, None])
    sin, cos = sin[:, 0], cos[:, 0]
    tag = "K7 int8" if int8 else "K7"
    kw = dict(eps=cfg.norm_eps, n_heads=H, n_kv_heads=KVH, **scales)
    got = tfd.fused_decode_layer(x, layer, k, v, 0, bt, lengths, sin, cos,
                                 **kw)
    want = tfd.fused_decode_layer_reference(x, layer, k, v, 0, bt, lengths,
                                            sin, cos, **kw)
    err = fused_check(tag, got, want, FUSED_TOL)
    ms = time_ms(torch, lambda i: tfd.fused_decode_layer(
        x, layer, k, v, 0, bt, lengths, sin, cos, **kw))
    plain_ms = time_ms(torch, lambda i: tfd.fused_decode_layer_reference(
        x, layer, k, v, 0, bt, lengths, sin, cos, **kw), n=2, blocks=3)
    unfused_ms = time_ms(torch, lambda i: unfused_decode_layer(
        llama, tpa, cfg, layer, x, k, v, bt, lengths, sin, cos, scales),
        n=5, blocks=3)
    phases = kernel_breakdown(torch, lambda: tfd.fused_decode_layer(
        x, layer, k, v, 0, bt, lengths, sin, cos, **kw))
    groups = phase_groups(phases)
    alt = k7_attention_on_k4(torch, tfd, trpa, k, v, bt, lengths, H, scales)
    tokens = int(lengths.sum())
    pages = int(((lengths + page - 1) // page).sum())
    kv_bytes = 2 * tokens * KVH * hd * (1 if int8 else 2) \
        + (2 * pages * KVH * 4 if int8 else 0)
    nbytes = (w_bytes + kv_bytes + B * D * 2 + B * hd * 4 + bt.numel() * 4
              + B * 4 + B * D * 2 + 2 * B * KVH * hd * 2)
    flops = _layer_flops(B, D, H, KVH, hd, M) + 4 * (tokens + B) * H * hd
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    report["K7i8" if int8 else "K7"] = {
        "name": "fused_decode_layer" + (" (int8 pools)" if int8 else ""),
        "route": "cuda", "source": "ray_tpu_torch/csrc/fused_decode.cu",
        "replaces": "ray_tpu/ops/fused_decode.py:325",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "unfused_layer_ms": unfused_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"B={B} D={D} H={H} KVH={KVH} hd={hd} M={M} page={page}, "
                 f"one LLAMA3_8B layer of the fused int8 artifact "
                 f"({w_bytes / 1e6:.1f} MB), x bf16, pools "
                 f"{'int8 + f32 page scales' if int8 else 'bf16'}, "
                 f"{tokens} past tokens (128-160 per slot)",
        "bound_bytes": nbytes, "bound_flops": flops,
        "phase_ms": phases, "phase_groups_ms": groups,
        "weight_bytes": w_bytes, "attention_on_k4": alt,
    }
    if "error" not in groups:
        report["K7i8" if int8 else "K7"]["proj_weight_rate_tb_s"] = (
            w_bytes / groups["projections"] / 1e9)
    log(f"{tag} fused_decode_layer: err {err:.3e}  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  no single library call (unfused layer, eager "
        f"ATen + K1: {unfused_ms:.4f} ms)  bound {b_ms:.4f} ms ({b_by})")
    log(f"  {tag} phases (device ms per call): {_fmt_breakdown(phases)}")
    log(f"  {tag} by part: {_fmt_breakdown(groups)}")
    log(f"  {tag} attention on K4's decode rows instead: {alt['k4_ms']:.4f} "
        f"ms, {alt['k4_from_k7_rounding']:.3e} from K7's rounding "
        f"(K4's own tolerance {alt['k4_from_f32']:.3e} from f32)")


def kernel_phase_k8(torch, llama, quant, trpa, report, int8=False):
    """K8 at the 8B ragged mix (seven decode rows, one 256-token chunk;
    T = 264), one LLAMA3_8B layer of the fused int8 artifact."""
    cfg = llama.LLAMA3_8B
    D, H, KVH, hd, M = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.mlp_dim)
    layer, w_bytes = fused_layer_8b(torch, llama, quant, 24)
    k, v, _q, _kn, _vn, rows, bt = ragged_inputs(torch, L=1, seed=25)
    del _q, _kn, _vn
    scales = {}
    if int8:
        g = torch.Generator(device="cuda").manual_seed(26)
        k, v, ks, vs = int8_pools(torch, g, tuple(k.shape))
        scales = {"k_scales": ks, "v_scales": vs}
    T, page = RAGGED_T, k.shape[3]
    g = torch.Generator(device="cuda").manual_seed(27)
    x = torch.randn((T, D), generator=g, device="cuda").to(torch.bfloat16)
    tok_pos = torch.zeros(T, dtype=torch.int32)
    at = 0
    for s, n in RAGGED_ROWS:
        tok_pos[at:at + n] = torch.arange(s, s + n, dtype=torch.int32)
        at += n
    sin, cos = llama.rope_table(cfg, tok_pos.cuda()[None])
    sin, cos = sin[0], cos[0]
    tag = "K8 int8" if int8 else "K8"
    kw = dict(eps=cfg.norm_eps, n_heads=H, n_kv_heads=KVH, **scales)
    got = trpa.fused_ragged_layer(x, layer, k, v, 0, *rows, bt, sin, cos,
                                  **kw)
    want = trpa.fused_ragged_layer_reference(x, layer, k, v, 0, *rows, bt,
                                             sin, cos, **kw)
    err = fused_check(tag, got, want, FUSED_TOL)
    ms = time_ms(torch, lambda i: trpa.fused_ragged_layer(
        x, layer, k, v, 0, *rows, bt, sin, cos, **kw), n=5, blocks=3)
    plain_ms = time_ms(torch, lambda i: trpa.fused_ragged_layer_reference(
        x, layer, k, v, 0, *rows, bt, sin, cos, **kw), n=2, blocks=3)
    unfused_ms = time_ms(torch, lambda i: unfused_ragged_layer(
        llama, trpa, cfg, layer, x, k, v, rows, bt, sin, cos, scales),
        n=5, blocks=3)
    phases = kernel_breakdown(torch, lambda: trpa.fused_ragged_layer(
        x, layer, k, v, 0, *rows, bt, sin, cos, **kw))
    proj = projection_yardstick(torch, llama, layer, phases, T, cfg)
    past = sum(s for s, _ in RAGGED_ROWS)
    past_pages = sum(-(-s // page) for s, _ in RAGGED_ROWS)
    attended = sum(n * s + n * (n + 1) // 2 for s, n in RAGGED_ROWS)
    past_bytes = 2 * past * KVH * hd * (1 if int8 else 2) \
        + (2 * past_pages * KVH * 4 if int8 else 0)
    nbytes = (w_bytes + past_bytes + 2 * T * D * 2 + T * hd * 4
              + 2 * T * KVH * hd * 2 + bt.numel() * 4 + 4 * len(RAGGED_ROWS)
              * 4)
    flops = _layer_flops(T, D, H, KVH, hd, M) + 4 * attended * H * hd
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    report["K8i8" if int8 else "K8"] = {
        "name": "fused_ragged_layer" + (" (int8 pools)" if int8 else ""),
        "route": "cuda", "source": "ray_tpu_torch/csrc/fused_ragged.cu",
        "replaces": "ray_tpu/ops/ragged_paged_attention.py:837",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "library_ms": None, "unfused_layer_ms": unfused_ms,
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": f"T={T} D={D} H={H} KVH={KVH} hd={hd} M={M} page={page}, "
                 f"one LLAMA3_8B layer of the fused int8 artifact, x bf16, "
                 f"pools {'int8 + f32 page scales' if int8 else 'bf16'}, "
                 f"rows (start, len) {RAGGED_ROWS}",
        "bound_bytes": nbytes, "bound_flops": flops,
        "phase_ms": phases, **proj,
    }
    log(f"{tag} fused_ragged_layer: err {err:.3e}  kernel {ms:.4f} ms  plain "
        f"{plain_ms:.4f} ms  no single library call (unfused layer, eager "
        f"ATen + K4: {unfused_ms:.4f} ms)  bound {b_ms:.4f} ms ({b_by})")
    log(f"  {tag} phases (device ms per call): {_fmt_breakdown(phases)}")


K7, K8 = "fused_decode_layer", "fused_ragged_layer"


def fused_parity_phase(torch, llama, quant, eng_mod, kernels):
    """Tiny f32 Llama with ``fused_decode=True``: the bucketed and the
    ragged engine on the card (K7, K8) against the same engines on the CPU
    (plain versions), identical greedy streams; once with f32 weights and
    f32 pools, once with an int8 fuse_for_decode artifact and int8 pools."""
    import dataclasses

    import numpy as np

    base_cfg = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=512,
                                   dtype=torch.float32, fused_decode=True)
    f32_params = llama.init_params(torch.Generator().manual_seed(3),
                                   base_cfg, device="cpu",
                                   dtype=torch.float32)
    int8_params = quant.fuse_for_decode(quant.init_quantized_llama(
        torch.Generator().manual_seed(4), base_cfg, device="cpu"), base_cfg)
    base = dict(max_slots=4, max_seq_len=512, page_size=64, decode_chunk=8,
                max_new_tokens_default=16)
    ragged = dict(base, ragged_batching=True, prefill_chunk=64)
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, base_cfg.vocab_size, n).tolist()
               for n in (9, 70, 150, 300, 33)]
    out = {}
    for weights, params, kv_int8 in (("f32", f32_params, False),
                                     ("int8 fused", int8_params, True)):
        cfg = dataclasses.replace(base_cfg, kv_int8=kv_int8)
        for mode, kw, must in (("bucketed", base, K7), ("ragged", ragged, K8)):
            streams, counts = {}, {}
            for device in ("cuda", "cpu"):
                reset_counts(kernels)
                eng = eng_mod.LLMEngine(_to(params, device),
                                        eng_mod.llama_paged_adapter(cfg),
                                        eng_mod.EngineConfig(**kw),
                                        device=device)
                try:
                    streams[device] = [s.result(timeout_s=300) for s in
                                       [eng.submit(p) for p in prompts]]
                finally:
                    eng.shutdown()
                counts[device] = read_counts(kernels)
            name = f"{mode}, {weights} weights"
            if counts["cuda"][must] == 0 or any(counts["cpu"].values()):
                raise AssertionError(f"fused parity ({name}): kernel "
                                     f"launches {counts}")
            if streams["cuda"] != streams["cpu"]:
                raise AssertionError(f"fused parity ({name}): greedy streams "
                                     f"differ: cuda {streams['cuda']} vs "
                                     f"cpu {streams['cpu']}")
            tokens = sum(len(s) for s in streams["cuda"])
            log(f"fused parity ({name}, {'int8' if kv_int8 else 'f32'} "
                f"pools): LLAMA_TINY f32, {len(prompts)} prompts of "
                f"{[len(p) for p in prompts]} tokens: cuda == cpu greedy "
                f"streams ({tokens} tokens; {must} launches "
                f"{counts['cuda'][must]})")
            out[name] = {"tokens": tokens, "launches": counts["cuda"][must]}
    return out


def dense_rank(torch, llama, params, cfg, prompt, token) -> int:
    """Rank (0 = argmax) of ``token`` among the logits of a dense bf16
    forward at the end of ``prompt``: einsum attention, no pages, each
    layer's int8 leaves dequantised by llama._deq_layer, int8 head."""
    with torch.no_grad():
        tokens = torch.tensor([prompt], device="cuda")
        sin, cos = llama.rope_table(cfg, torch.arange(
            len(prompt), device="cuda")[None])
        x = params["tok_embed"][tokens].to(cfg.dtype)
        for layer in llama._layers(params["layers"], cfg.n_layers):
            layer = llama._deq_layer(layer, cfg.dtype)
            h = x + llama._attn_block(
                llama.rms_norm(x, layer["ln_attn"], cfg.norm_eps), layer,
                cfg, sin, cos, None)[0]
            x = h + llama._mlp_block(
                llama.rms_norm(h, layer["ln_mlp"], cfg.norm_eps), layer, cfg)
        x = llama.rms_norm(x[0, -1], params["final_norm"], cfg.norm_eps)
        last = llama._head_matmul(x, llama._head(params, cfg), cfg).float()
    if not torch.isfinite(last).all():
        raise AssertionError("8B dense forward logits are not finite")
    return int((last > last[token]).sum())


def fused_serving_phase(torch, llama, quant, eng_mod, kernels, card):
    """The JAX package's headline 8B serving configuration: int8 weights
    (init_quantized_llama from a seeded generator on the card, then
    fuse_for_decode), int8 KV, fused_decode=True.  The bucketed engine at
    48 slots (48 prompts of 128 tokens, 32 new tokens each: K7 per layer,
    K3 per step), then the ragged engine with the ragged phase's traffic
    (K8 per layer, K6 per step); then a short run of both on bf16 pools
    (K7 and K8 beside K2 and K5)."""
    import dataclasses

    import numpy as np

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    base = llama.LLAMA3_8B
    params = quant.init_quantized_llama(
        torch.Generator(device="cuda").manual_seed(0), base, device="cuda")
    params = quant.fuse_for_decode(params, base)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    artifact = quant.quantized_bytes(params)
    stream_bytes = quant.quantized_bytes(params["layers"]) \
        + quant.quantized_bytes(params["lm_head"])
    cfg = dataclasses.replace(base, kv_int8=True, fused_decode=True)
    L = cfg.n_layers
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, cfg.vocab_size, 128).tolist()
               for _ in range(FUSED_SLOTS)]
    new = 32
    ecfg = eng_mod.EngineConfig(max_slots=FUSED_SLOTS, max_seq_len=256,
                                page_size=64, decode_chunk=8)
    eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg), ecfg,
                            device="cuda")
    try:
        # Warm-up request (allocator growth): not part of the measured run.
        eng.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        steps0 = eng.stats()["steps"]
        reset_counts(kernels)
        t1 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new) for p in prompts]
        outs = [s.result(timeout_s=900) for s in streams]
        wall = time.perf_counter() - t1
        launches = read_counts(kernels)
        steps = eng.stats()["steps"] - steps0
        reqs = [s._req for s in streams]
        if eng._cache["k"].dtype != torch.int8:
            raise AssertionError("8B fused: the engine did not build int8 "
                                 "pools")
    finally:
        eng.shutdown()
    for o in outs:
        if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"8B fused bucketed stream malformed: {o}")
    k7, k3 = launches[K7], launches[K3]
    if k3 == 0 or k7 != L * k3 or launches[K7 + INT8] != k7 \
            or launches[K1] or launches["paged_append"] or launches[K8]:
        raise AssertionError(f"8B fused bucketed: launches {launches}, want "
                             f"K7 = {L} x K3 > 0 and no K1, K2")
    rank0 = dense_rank(torch, llama, params, cfg, prompts[0], outs[0][0])
    if rank0 >= 5:
        raise AssertionError(f"8B fused: first token ranks {rank0} in the "
                             "dense forward (want top 5)")
    # The second token is K7's: its rank says the fused layers serve the
    # model, not noise (a random token ranks ~64k of 128k).
    rank1 = dense_rank(torch, llama, params, cfg, prompts[0] + outs[0][:1],
                       outs[0][1])
    if rank1 >= 1000:
        raise AssertionError(f"8B fused: the first K7 token ranks {rank1} "
                             "in the dense forward")
    first = min(r.first_token_at for r in reqs)
    last_done = max(r.finished_at for r in reqs)
    decode_tokens = sum(len(o) - 1 for o in outs)
    breakdown = decode_step_breakdown(torch, llama, params, cfg,
                                      [128] * FUSED_SLOTS,
                                      slots=FUSED_SLOTS, maxp=4)
    breakdown["weight_stream_bound_ms"] = stream_bytes / HBM_BYTES_PER_S * 1e3
    breakdown["weights_gb"] = stream_bytes / 1e9
    bucketed = {
        "config": "LLAMA3_8B, int8 weights (fuse_for_decode), int8 KV, "
                  "fused_decode=True, 32 layers, random weights (seed 0)",
        "engine": f"max_slots={FUSED_SLOTS} max_seq_len=256 page_size=64 "
                  "decode_chunk=8",
        "artifact_bytes": artifact, "init_s": init_s,
        "prompt_lens": [128] * FUSED_SLOTS, "max_new_tokens": new,
        "wall_s": wall, "decode_steps": steps,
        "ttft_s": [r.first_token_at - r.submitted_at for r in reqs],
        "decode_tokens_per_s": decode_tokens / (last_done - first),
        "engine_step_ms": (last_done - first) / max(steps, 1) * 1e3,
        "decode_step": breakdown, "launches": launches,
        "first_token_rank": rank0, "second_token_rank": rank1,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    dev_ms = breakdown["device_ms"]
    if dev_ms is not None:
        bucketed["device_idle_share"] = 1 - dev_ms / bucketed["engine_step_ms"]
    ttft = bucketed["ttft_s"]
    log(f"8B fused int8 bucketed serving ({card}): artifact "
        f"{artifact / 1e9:.3f} GB (init + fuse {init_s:.1f} s), {steps} "
        f"decode steps at {bucketed['engine_step_ms']:.2f} ms/step, "
        f"{bucketed['decode_tokens_per_s']:.1f} decode tok/s, TTFT "
        f"{min(ttft):.3f}-{max(ttft):.3f} s, peak "
        f"{bucketed['peak_memory_gb']:.2f} GB, first token rank {rank0}, "
        f"first K7 token rank {rank1}, launches {launches}")
    log(f"8B fused decode step alone ({breakdown['aten_ops']} ATen ops, "
        f"{FUSED_SLOTS} slots): host {breakdown['host_ms']:.2f} ms, device "
        + (f"{dev_ms:.2f} ms" if dev_ms is not None else
           f"not measured ({breakdown['device_ms_error']})")
        + f", int8 weight-streaming bound "
        f"{breakdown['weight_stream_bound_ms']:.2f} ms "
        f"({breakdown['weights_gb']:.2f} GB)")

    # The ragged engine on the same weights, with the ragged phase's mix.
    ecfg = eng_mod.EngineConfig(max_slots=8, max_seq_len=2048, page_size=64,
                                decode_chunk=8, ragged_batching=True,
                                prefill_chunk=256)
    eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg), ecfg,
                            device="cuda")
    rng = np.random.default_rng(13)
    lens, late_len = (17, 300, 700, 1500), 1000
    r_prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    late_prompt = rng.integers(0, cfg.vocab_size, late_len).tolist()
    try:
        eng.submit(r_prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        st0 = eng.stats()
        reset_counts(kernels)
        t1 = time.perf_counter()
        streams = [eng.submit(p, max_new_tokens=new) for p in r_prompts]
        it = iter(streams[0])
        first0 = [next(it)]
        late = eng.submit(late_prompt, max_new_tokens=new)
        r_outs = [first0 + list(it)]
        r_outs += [s.result(timeout_s=900) for s in streams[1:]]
        r_outs.append(late.result(timeout_s=900))
        r_wall = time.perf_counter() - t1
        r_launches = read_counts(kernels)
        st1 = eng.stats()
        r_reqs = [s._req for s in streams] + [late._req]
    finally:
        eng.shutdown()
    r_steps = st1["steps"] - st0["steps"]
    step_tokens = {k: st1["step_tokens"][k] - st0["step_tokens"][k]
                   for k in st1["step_tokens"]}
    for o in r_outs:
        if len(o) != new or not all(0 <= t < cfg.vocab_size for t in o):
            raise AssertionError(f"8B fused ragged stream malformed: {o}")
    k8 = r_launches[K8]
    if r_steps == 0 or k8 != L * r_steps or r_launches[K6] != r_steps \
            or r_launches[K8 + INT8] != k8 or r_launches[K4] \
            or r_launches["ragged_paged_append"] or r_launches[K7]:
        raise AssertionError(f"8B fused ragged: launches {r_launches} over "
                             f"{r_steps} steps, want K8 {L} and K6 1 per "
                             "step and no K4, K5")
    if step_tokens["prefill"] != sum(lens) + late_len:
        raise AssertionError(f"8B fused ragged: {step_tokens['prefill']} "
                             f"prompt tokens, want {sum(lens) + late_len}")
    r_rank = dense_rank(torch, llama, params, cfg, r_prompts[0], r_outs[0][0])
    if r_rank >= 5:
        raise AssertionError(f"8B fused ragged: first token ranks {r_rank} "
                             "in the dense forward (want top 5)")
    r_first = min(r.first_token_at for r in r_reqs)
    r_last = max(r.finished_at for r in r_reqs)
    ragged = {
        "config": bucketed["config"],
        "engine": "max_slots=8 max_seq_len=2048 page_size=64 decode_chunk=8 "
                  f"ragged_batching=True prefill_chunk=256 (token budget "
                  f"{RAGGED_T})",
        "prompt_lens": list(lens) + [late_len], "max_new_tokens": new,
        "wall_s": r_wall, "ragged_steps": r_steps,
        "mixed_steps": st1["mixed_steps"] - st0["mixed_steps"],
        "step_tokens": step_tokens,
        "ttft_s": [r.first_token_at - r.submitted_at for r in r_reqs],
        "decode_tokens_per_s": step_tokens["decode"] / (r_last - r_first),
        "engine_step_ms": r_wall / r_steps * 1e3,
        "launches": r_launches, "first_token_rank": r_rank,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "card": card,
    }
    log(f"8B fused int8 ragged serving ({card}): {r_steps} ragged steps "
        f"({ragged['mixed_steps']} mixed, {ragged['engine_step_ms']:.2f} "
        f"ms/step), {ragged['decode_tokens_per_s']:.1f} decode tok/s, TTFT "
        f"{[round(t, 3) for t in ragged['ttft_s']]} s, tokens {step_tokens}, "
        f"first token rank {r_rank}, launches {r_launches}")

    # bf16 pools on the same weights: K7 beside K2, K8 beside K5.
    cfg16 = dataclasses.replace(cfg, kv_int8=False)
    short = {}
    for mode, kw, must in (
            ("bucketed", dict(max_slots=8, max_seq_len=256, page_size=64,
                              decode_chunk=8), (K7, "paged_append")),
            ("ragged", dict(max_slots=8, max_seq_len=512, page_size=64,
                            decode_chunk=8, ragged_batching=True,
                            prefill_chunk=256),
             (K8, "ragged_paged_append"))):
        eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg16),
                                eng_mod.EngineConfig(**kw), device="cuda")
        try:
            eng.submit(prompts[0][:5], max_new_tokens=2).result(
                timeout_s=600)
            steps0 = eng.stats()["steps"]
            reset_counts(kernels)
            b_outs = [s.result(timeout_s=600) for s in
                      [eng.submit(p, max_new_tokens=8) for p in prompts[:4]]]
            b_launches = read_counts(kernels)
            b_steps = eng.stats()["steps"] - steps0
        finally:
            eng.shutdown()
        if any(len(o) != 8 for o in b_outs) or b_launches[must[0]] == 0 \
                or b_launches[must[0] + INT8] or b_launches[must[1]] == 0 \
                or b_launches[must[0]] != L * b_launches[must[1]]:
            raise AssertionError(f"8B fused {mode} on bf16 pools: launches "
                                 f"{b_launches}, want {must[0]} = {L} x "
                                 f"{must[1]} > 0 and no int8 kernel")
        short[mode] = {"steps": b_steps, "launches": b_launches}
        log(f"8B fused {mode} on bf16 pools: {b_steps} steps, launches "
            f"{ {k: b_launches[k] for k in must} }")
    del params
    torch.cuda.empty_cache()
    return bucketed, ragged, short


# --------------------------------------------------------------------------
# training: the flash backward (K10, K11) and the train step
# --------------------------------------------------------------------------

K9F, K10, K11 = "flash_forward", "flash_backward_dq", "flash_backward_dkv"
TRAIN_B, TRAIN_S = 8, 2048       # bench.py's BATCH x SEQ
# bf16 gradients: one ulp is 2^-8 relative, and the rounded p and ds feed
# the products in both versions, so a value an f32 ulp apart that rounds
# to the other side moves a term by one ulp; f32: summation order only.
# Both relative to the largest element of the plain version's output.
BWD_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def bench_cfg(torch, llama, big: bool = False):
    """bench.py's BENCH_CFG (319M) or, with ``big``, BENCH_1B_CFG (bf16
    master params, full remat, chunked loss)."""
    if big:
        return llama.LlamaConfig(
            vocab_size=32_768, dim=2048, n_layers=16, n_heads=16,
            n_kv_heads=8, mlp_dim=8192, max_seq_len=TRAIN_S,
            param_dtype=torch.bfloat16, remat_policy="full", loss_chunk=512)
    return llama.LlamaConfig(vocab_size=32_768, dim=1024, n_layers=16,
                             n_heads=8, n_kv_heads=4, mlp_dim=4096,
                             max_seq_len=TRAIN_S)


def _bwd_case(torch, tfa, g, B, S, H, KVH, D, dtype):
    dev = torch.device("cuda")
    q = torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype)
    k = torch.randn((B, S, KVH, D), generator=g, device=dev, dtype=dtype)
    v = torch.randn((B, S, KVH, D), generator=g, device=dev, dtype=dtype)
    do = torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype)
    o, lse = tfa.flash_forward(q, k, v, True)
    return q, k, v, do, o, lse, tfa.flash_backward_delta(o, do)


def _k9f_training_row(torch, F, tfa, q, k, v, o, lse, tag, timed=None):
    """K9f on a training case's (q, k, v), which the case's backward
    reads: (o, lse) held against the plain version; at BENCH_CFG's
    shapes (or with ``timed``) also timed beside the plain version,
    causal SDPA and the bound."""
    err, rel, lse_err = check_k9f(torch, tfa, q, k, v, o, lse, tag)
    row = {"max_abs_err": err, "max_rel_err": rel, "lse_err": lse_err}
    log(f"K9f flash_forward {tag}: err {err:.3e} (rel {rel:.3e}, lse "
        f"{lse_err:.3e})")
    if not (tag == "bench" if timed is None else timed):
        return row
    B, S, H, D = q.shape
    KVH = k.shape[2]
    row["ms"] = time_ms(torch, lambda i: tfa.flash_forward(q, k, v, True),
                        n=5, blocks=3)
    row["plain_ms"] = time_ms(torch, lambda i: tfa.flash_forward_plain(
        q, k, v, True), n=2, blocks=3)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row["library_ms"] = time_ms(
        torch, lambda i: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), n=5, blocks=3)
    flops = 4 * B * H * D * (S * (S + 1) // 2)
    nbytes = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 4 * B * H * S
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
    row["vs_library"] = row["ms"] / row["library_ms"]
    log(f"  kernel {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s)  plain "
        f"{row['plain_ms']:.4f} ms  SDPA {row['library_ms']:.4f} ms  "
        f"kernel / SDPA {row['vs_library']:.3f}  bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def kernel_phase_k10_k11(torch, F, tfa, report):
    """K10 and K11 at BENCH_CFG's attention shapes (B 8, S 2048, 8 heads
    of 128, 4 kv heads, causal, bf16) and one small f32 case, against
    their plain versions; timed beside the plain versions, the bound and
    the backward of causal SDPA (dq + dk + dv, one autograd call).  K9f's
    (o, lse) of each case, which K10/K11 read, is held against its plain
    version too and its row kept beside K9f's serving rows."""
    g = torch.Generator(device="cuda").manual_seed(10)
    rows, k9f_rows = {}, {}
    for tag, shape in (("bench", (TRAIN_B, TRAIN_S, 8, 4, 128,
                                  torch.bfloat16)),
                       ("small_f32", (1, 256, 4, 2, 64, torch.float32))):
        B, S, H, KVH, D, dtype = shape
        q, k, v, do, o, lse, delta = _bwd_case(torch, tfa, g, *shape)
        k9f_rows[tag] = _k9f_training_row(torch, F, tfa, q, k, v, o, lse,
                                          tag)
        del o
        got = (tfa.flash_backward_dq(q, k, v, do, lse, delta, True),
               *tfa.flash_backward_dkv(q, k, v, do, lse, delta, True))
        want = (tfa.flash_backward_dq_plain(q, k, v, do, lse, delta, True),
                *tfa.flash_backward_dkv_plain(q, k, v, do, lse, delta, True))
        torch.cuda.synchronize()
        errs = {}
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - b.float()).abs().max().item()
            rel = err / b.float().abs().max().item()
            errs[name] = {"max_abs_err": err, "rel_to_max": rel}
            if not rel <= BWD_TOL[str(dtype).split(".")[-1]]:
                raise AssertionError(
                    f"K10/K11 {name} disagrees with its plain version "
                    f"({tag}): abs {err}, {rel} of the largest element")
        rows[tag] = {"shape": f"B={B} S={S} H={H} KVH={KVH} D={D} causal "
                              f"{str(dtype).split('.')[-1]}", "errs": errs}
        log(f"K10/K11 {tag}: " + ", ".join(
            f"{n} err {e['max_abs_err']:.3e} ({e['rel_to_max']:.2e} of max)"
            for n, e in errs.items()))
        if tag != "bench":
            del q, k, v, do, lse, delta, got, want
            continue
        ms_dq = time_ms(torch, lambda i: tfa.flash_backward_dq(
            q, k, v, do, lse, delta, True), n=3, blocks=3)
        ms_dkv = time_ms(torch, lambda i: tfa.flash_backward_dkv(
            q, k, v, do, lse, delta, True), n=3, blocks=3)
        plain_dq = time_ms(torch, lambda i: tfa.flash_backward_dq_plain(
            q, k, v, do, lse, delta, True), n=2, blocks=3)
        plain_dkv = time_ms(torch, lambda i: tfa.flash_backward_dkv_plain(
            q, k, v, do, lse, delta, True), n=2, blocks=3)
        del got, want
        # Library yardstick: the backward of causal SDPA with GQA on the
        # same tensors ([B, H, S, D] views), dq + dk + dv in one call.
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        try:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
        except TypeError:
            out = F.scaled_dot_product_attention(
                qt, kt.repeat_interleave(H // KVH, dim=1),
                vt.repeat_interleave(H // KVH, dim=1), is_causal=True)
        dot = do.transpose(1, 2)
        library_ms = time_ms(torch, lambda i: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True), n=3, blocks=3)
        del out, qt, kt, vt
        pairs = S * (S + 1) // 2            # causal (query, key) pairs
        io = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 8 * B * H * S
        flops10, flops11 = (n * 2 * B * H * D * pairs for n in (3, 4))
        b10 = bound(io + 2 * B * S * H * D, flops10, BF16_FLOPS)
        b11 = bound(io + 2 * 2 * B * S * KVH * D, flops11, BF16_FLOPS)
        for key, name, line, ms, plain, bnd, err, flops in (
                ("K10", K10, 263, ms_dq, plain_dq, b10, errs["dq"], flops10),
                ("K11", K11, 284, ms_dkv, plain_dkv, b11,
                 max(errs["dk"], errs["dv"],
                     key=lambda e: e["max_abs_err"]), flops11)):
            report[key] = {
                "name": name, "route": "cuda",
                "source": "ray_tpu_torch/csrc/flash_bwd.cu",
                "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
                "max_abs_err": err["max_abs_err"], "ms": ms,
                "plain_ms": plain, "library_ms": library_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1],
                "tflops": flops / (ms * 1e-3) / 1e12,
                "vs_library": ms / library_ms,
                "shape": rows["bench"]["shape"], "cases": rows}
            log(f"{key} {name}: kernel {ms:.4f} ms "
                f"({report[key]['tflops']:.1f} TFLOP/s)  plain {plain:.4f} "
                f"ms  SDPA backward (dq+dk+dv) {library_ms:.4f} ms  kernel / "
                f"SDPA backward {ms / library_ms:.3f}  bound {bnd[0]:.4f} ms "
                f"({bnd[1]})")
        del q, k, v, do, lse, delta
    k9f = report["K9f"]
    k9f["training_shapes"] = k9f_rows
    k9f["max_abs_err"] = max(k9f["max_abs_err"], *(
        r["max_abs_err"] for r in k9f_rows.values()))
    torch.cuda.empty_cache()


def _clone_to(torch, tree, device):
    if isinstance(tree, dict):
        return {k: _clone_to(torch, v, device) for k, v in tree.items()}
    return tree.detach().clone().to(device)


def train_parity_phase(torch, llama, train, kernels):
    """A small f32 Llama at S = 256 trained 3 steps from the same weights
    and batches on the card (K9f, K10, K11) and on the CPU (the einsum
    path): losses and grad norms per step must agree."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, mlp_dim=256, max_seq_len=256,
                            dtype=torch.float32, param_dtype=torch.float32)
    base = llama.init_params(torch.Generator().manual_seed(5), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 2, 256),
                           generator=torch.Generator().manual_seed(6),
                           dtype=torch.int32)
    hist, counts = {}, None
    for dev in ("cuda", "cpu"):
        params = _clone_to(torch, base, dev)
        trainer = train.TorchTrainer(
            init_params=lambda g, p=params: p,
            loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
            optimizer=train.default_optimizer(1e-3, warmup_steps=1),
            scaling_config=train.ScalingConfig(devices=[dev]),
            run_config=train.RunConfig(report_every=1))
        trainer.state
        if dev == "cuda":
            reset_counts(kernels)
        res = trainer.fit(({"tokens": t} for t in tokens), num_steps=3)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts(kernels)
        if res.error is not None:
            raise res.error
        hist[dev] = res.metrics_history
    # Under "dots" remat K9f runs twice a layer (forward, recompute).
    want = {K9F: 2 * 2 * 3, K10: 2 * 3, K11: 2 * 3}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"train parity: launches {got}, want {want}")
    worst = {}
    for key in ("loss", "grad_norm"):
        a = [m[key] for m in hist["cuda"]]
        b = [m[key] for m in hist["cpu"]]
        worst[key] = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        # f32 both sides (TF32 off); kernel vs einsum and cuBLAS vs the
        # CPU's matmuls sum in other orders.
        if worst[key] > 1e-4:
            raise AssertionError(f"train parity: {key} cuda {a} vs cpu {b}")
    log(f"train parity (f32, S=256, 3 steps): losses cuda "
        f"{[round(m['loss'], 6) for m in hist['cuda']]} cpu "
        f"{[round(m['loss'], 6) for m in hist['cpu']]}, worst relative "
        f"loss {worst['loss']:.2e}, grad_norm {worst['grad_norm']:.2e}; "
        f"launches {got}")
    return {"launches": got, "history": hist, "worst_rel": worst}


def _host_batches(torch, cfg, seed):
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                                       generator=gen, dtype=torch.int32)}


def _trainer(torch, llama, train, cfg, **run):
    return train.TorchTrainer(
        init_params=lambda g: llama.init_params(g, cfg),
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        optimizer=train.default_optimizer(1e-4, warmup_steps=10,
                                          mu_dtype=torch.bfloat16),
        run_config=train.RunConfig(**run))


def _step_breakdown(torch, step_once) -> dict:
    """Device ms of one train step by kernel (torch.profiler): the flash
    kernels, cuBLAS's matrix products, the rest (elementwise ATen), and
    the flash kernels' share of all kernel time."""
    bd = kernel_breakdown(torch, step_once, reps=1)
    if "error" in bd:
        return bd
    total = sum(bd.values())
    flash = {name: sum(v for k, v in bd.items() if k.startswith(prefix))
             for name, prefix in ((K9F, "flash_fwd_"),
                                  (K10, "flash_bwd_dq_"),
                                  (K11, "flash_bwd_dkv_"))}
    gemm = sum(v for k, v in bd.items()
               if re.search(r"gemm|nvjet|cutlass|xmma", k, re.I))
    return {"kernel_ms_total": total, "flash_ms": flash,
            "flash_share": sum(flash.values()) / total,
            "gemm_ms": gemm,
            "other_ms": total - gemm - sum(flash.values()),
            "by_kernel": dict(sorted(bd.items(), key=lambda kv: -kv[1]))}


def headline_train_phase(torch, llama, train, kernels, repo):
    """BENCH_CFG at full width and depth on the card, as bench.py's
    _measure drives it: the trainer's state and step function, batches of
    8 x 2048 staged on the card, 2 warm-up and 5 timed steps, one step's
    stream time between CUDA events, one step's kernels under the
    profiler, then ``fit`` for 2
    steps through the RunConfig with a checkpoint written, then restored.
    Every launch counter is 0 just before the first step and read after
    the fit: K9f 32 (forward and "dots" recompute), K10 and K11 16 per
    step."""
    cfg = bench_cfg(torch, llama)
    ckpt_root = os.path.join(repo, "smoke_out", "train_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    trainer = _trainer(torch, llama, train, cfg, name="bench",
                       storage_path=ckpt_root, report_every=1_000_000)
    t0 = time.perf_counter()
    state = trainer.state
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = trainer._step_fn
    batches = _host_batches(torch, cfg, 0)
    staged = [trainer.shard_batch(next(batches)) for _ in range(4)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_steps, losses = 0, []
    reset_counts(kernels)
    for _ in range(2):
        state, metrics = step(state, staged[0])
        losses.append(metrics["loss"])
        n_steps += 1
    float(metrics["loss"])
    timed = 5
    t0 = time.perf_counter()
    for i in range(timed):
        state, metrics = step(state, staged[i % len(staged)])
        losses.append(metrics["loss"])
        n_steps += 1
    float(metrics["loss"])
    wall = time.perf_counter() - t0
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    ev0.record()
    state, metrics = step(state, staged[1])
    host_ms = (time.perf_counter() - h0) * 1e3
    ev1.record()
    torch.cuda.synchronize()
    # Stream time between two events: the step's kernels and the gaps
    # where the host's enqueue kept the card waiting.  Device busy time
    # is the profiler's kernel sum below.
    stream_ms = ev0.elapsed_time(ev1)
    n_steps += 1
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], staged[2])

    breakdown = _step_breakdown(torch, one_step)
    n_steps += 2  # the profiler's warm-up call and the profiled one
    trainer._state = holder[0]
    fit_steps0 = train_telemetry(trainer.state.opt_state)["steps_total"]
    result = trainer.fit(batches, num_steps=2)
    n_steps += 2
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    telemetry = train_telemetry(trainer.state.opt_state)
    telemetry["fit_steps"] = telemetry["steps_total"] - fit_steps0
    if telemetry["fit_steps"] != 2:
        raise AssertionError(f"headline training: telemetry {telemetry} "
                             "after a 2-step fit")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if result.error is not None:
        raise result.error
    per_step = {k: counts[k] / n_steps for k in (K9F, K10, K11)}
    want = {K9F: 2 * cfg.n_layers, K10: cfg.n_layers, K11: cfg.n_layers}
    if per_step != want:
        raise AssertionError(f"headline training: launches per step "
                             f"{per_step}, want {want} ({n_steps} steps)")
    losses = [float(x) for x in losses] + [m["loss"] for m in
                                           result.metrics_history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"headline training: losses {losses}")
    # The loss falls: the first batch again, after every update.
    with torch.no_grad():
        end_loss = float(llama.loss_fn(trainer.state.params, staged[0],
                                       cfg)[0])
    if not end_loss < losses[0]:
        raise AssertionError(f"headline training: loss on the first batch "
                             f"{losses[0]} -> {end_loss}: not falling")
    # The fit wrote the final checkpoint: restore it over a changed leaf.
    leaf = trainer.state.params["final_norm"]
    saved = leaf.detach().clone()
    with torch.no_grad():
        leaf.zero_()
    restored_step = trainer.restore(result.checkpoint_path)
    if restored_step != trainer.state.step or not torch.equal(
            trainer.state.params["final_norm"], saved):
        raise AssertionError("headline training: checkpoint restore")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    tokens_per_s = TRAIN_B * TRAIN_S * timed / wall
    out = {
        "config": "BENCH_CFG (bench.py:40-51)", "params": cfg.num_params(),
        "batch": [TRAIN_B, TRAIN_S], "init_s": init_s,
        "tokens_per_s": tokens_per_s, "step_ms": wall / timed * 1e3,
        "stream_ms_one_step": stream_ms, "host_ms_one_step": host_ms,
        "mfu": 6 * cfg.num_params() * tokens_per_s / BF16_FLOPS,
        "peak_gb": peak_gb, "losses": losses, "end_loss_first_batch":
        end_loss, "launches": counts, "launches_per_step": per_step,
        "steps": n_steps, "breakdown": breakdown,
        "fit_steps_per_sec": result.metrics["steps_per_sec"],
        "checkpoint_restored_step": restored_step, "telemetry": telemetry}
    log(f"BENCH_CFG train ({cfg.num_params() / 1e6:.1f} M params, "
        f"{TRAIN_B} x {TRAIN_S}): {tokens_per_s:.0f} tokens/s, step "
        f"{out['step_ms']:.1f} ms (one step: stream {stream_ms:.1f} ms, "
        f"host enqueue {host_ms:.1f} ms), MFU {out['mfu']:.4f}, peak "
        f"{peak_gb:.2f} GB; loss {losses[0]:.4f} -> first batch again "
        f"{end_loss:.4f}; launches per step {per_step}")
    log(f"  raytpu_train_*: steps_total +{telemetry['fit_steps']} over the "
        f"2-step fit, opt_state_bytes {telemetry['opt_state_bytes']} (state "
        f"{telemetry['state_bytes']} bytes), hbm_headroom_bytes "
        f"{telemetry['hbm_headroom_bytes']}")
    if "error" in breakdown:
        log(f"  breakdown: not measured ({breakdown['error']})")
    else:
        out["device_idle_share"] = 1 - breakdown["kernel_ms_total"] / (
            wall / timed * 1e3)
        top = dict(list(breakdown["by_kernel"].items())[:6])
        log(f"  one step's kernels {breakdown['kernel_ms_total']:.1f} ms "
            f"(idle {out['device_idle_share']:.3f} of the step): flash "
            f"{breakdown['flash_share']:.3f} "
            f"({_fmt_breakdown(breakdown['flash_ms'])}), matrix products "
            f"{breakdown['gemm_ms']:.1f}, other {breakdown['other_ms']:.1f};"
            f" top: {_fmt_breakdown(top)}")
    del trainer, state, holder, staged, metrics
    torch.cuda.empty_cache()
    return out


def train_1b_phase(torch, llama, train, kernels):
    """BENCH_1B_CFG (bf16 master params, "full" remat, loss chunks of 512)
    for 2 steps of ``fit`` on the card: K9f twice a layer a step (forward
    and full recompute), K10 and K11 once."""
    cfg = bench_cfg(torch, llama, big=True)
    trainer = _trainer(torch, llama, train, cfg, report_every=1)
    trainer.state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    result = trainer.fit(_host_batches(torch, cfg, 1), num_steps=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(kernels)
    if result.error is not None:
        raise result.error
    want = {K9F: 2 * 2 * cfg.n_layers, K10: 2 * cfg.n_layers,
            K11: 2 * cfg.n_layers}
    got = {k: counts[k] for k in want}
    losses = [m["loss"] for m in result.metrics_history]
    if got != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"1B training: launches {got} (want {want}), "
                             f"losses {losses}")
    out = {"config": "BENCH_1B_CFG (bench.py:56-67)",
           "params": cfg.num_params(), "steps": 2, "wall_s": wall,
           "losses": losses, "launches": got,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"BENCH_1B_CFG train ({cfg.num_params() / 1e6:.1f} M params, bf16 "
        f"master, full remat, loss chunk 512): 2 steps in {wall:.1f} s, "
        f"losses {[round(x, 4) for x in losses]}, peak "
        f"{out['peak_gb']:.2f} GB, launches {got}")
    del trainer
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Mamba-2 training (K12) and normalised paged decode attention (K13)
# --------------------------------------------------------------------------

K12, K13 = "ssd_forward", "paged_decode_attention"
# K12 against ssd_pallas_plain, relative to 1 + |y|: the same recurrence,
# walked in 32-position blocks by the kernel (products in 3xTF32 split
# precision) and at the resolved chunk (up to 256) in f32 by the plain
# version, sums in other orders.
K12_TOL = 2e-4
MAMBA_B, MAMBA_S = 2, 2048       # the 2.7B phase's fixed batch


def _ssd_case(torch, g, B, S, H, P, N, bc_dtype):
    x = torch.randn((B, S, H, P), generator=g, device="cuda")
    log_a = -torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device="cuda"))
    Bm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(
        bc_dtype)
    Cm = (torch.randn((B, S, N), generator=g, device="cuda") * 0.3).to(
        bc_dtype)
    return x, log_a, Bm, Cm


def k12_flops(tssd, B: int, S: int, H: int, P: int, N: int,
              bc_bytes: int) -> dict:
    """Tensor operations of K12's route (csrc/mamba_ssd.cu) that the
    function needs, two a multiply-add, every split-precision pass
    counted, by the peak they run at.  C.B^T is counted once per (batch,
    block of ``BLOCK_T`` positions), its six 16 x 8 tiles j <= i: on bf16
    mma.sync in one pass for bf16 B/C (``bf16``), three TF32 passes for
    f32 ones.  Every CTA of the kernel builds it again (twice per head at
    the 2.7B layer); those repeats are work of the route, not of the
    function, and are not counted.  Per head, block and 8 state columns
    (two warps of the kernel, N rounded up to 8): (G o L).x over the tiles
    each 16 rows need, three passes; C.state and the state update, two
    passes (bf16 B/C exact) or three (f32)."""
    T = tssd.BLOCK_T
    blocks = -(-S // T)
    n8 = -(-N // 8) * 8
    exact = bc_bytes == 2
    p_cs = 2 if exact else 3
    mma = 2 * 16 * 8 * 8                     # one m16n8k8 tile step
    cb = B * blocks * 6 * (n8 // 8) * mma    # C.B^T, one pass
    col8 = B * H * (P // 8) * blocks         # (batch, head, 8 columns, block)
    rest = col8 * mma * ((2 + 4) * 3              # (G o L).x, rows 0-15, 16-31
                         + 2 * (n8 // 8) * p_cs   # C.state, 32 rows
                         + (n8 // 16) * (T // 8) * p_cs)  # update, N rows
    return {"bf16": cb if exact else 0,
            "tf32": rest + (0 if exact else 3 * cb)}


def k12_useful_flops(B: int, S: int, H: int, P: int, N: int) -> int:
    """The recurrence's own f32 work at 64-position blocks (the count of
    the f32 CUDA-core route: C.B^T once per batch and block, the decay
    product over each block's lower triangle, C.state and the update),
    two a multiply-add."""
    T, nblk = 64, -(-S // 64)
    return (2 * B * nblk * T * T * N
            + 2 * B * H * P * (nblk * T * (T + 1) // 2 + 2 * nblk * T * N))


def _k12_err(got, want) -> float:
    return ((got - want).abs() / (1 + want.abs())).max().item()


def kernel_phase_k12(torch, tssd, tm, report):
    """K12 against ssd_pallas_plain at bench.py's ``_measure_ssd`` shape
    (B 4, S 4096, H 8, P 64, N 128, chunk 128 → 256, f32), at one 2.7B
    layer's (B 2, S 2048, H 80, P 64, N 128, chunk 64 → 256, bf16 B/C)
    and at S = 1984 (chunk 64 kept); timed at the two main shapes beside
    the plain version, the port's ``ssd_chunked``
    (the JAX benchmark's own comparison) and the bound; then the
    ``ssd_pallas`` Function's gradients on the card against the CPU's."""
    g = torch.Generator(device="cuda").manual_seed(12)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {"measure_ssd": (4, 4096, 8, 64, 128, 128, torch.float32),
             "mamba2_2.7b_layer": (2, 2048, 80, 64, 128, 64, torch.bfloat16),
             "chunk_kept": (2, 1984, 80, 64, 128, 64, torch.bfloat16)}
    rows = {}
    for tag, (B, S, H, P, N, chunk, bc) in cases.items():
        x, la, Bm, Cm = _ssd_case(torch, g, B, S, H, P, N, bc)
        want = tssd.ssd_pallas_plain(x, la, Bm, Cm, chunk)
        got = tssd.ssd_forward(x, la, Bm, Cm, chunk)
        torch.cuda.synchronize()
        err = _k12_err(got, want)
        row = {"shape": f"B={B} S={S} H={H} P={P} N={N} chunk={chunk} -> "
                        f"{tssd.resolve_chunk(S, chunk)}, B/C "
                        f"{str(bc).split('.')[-1]}",
               "max_rel_err": err,
               "max_abs_err": (got - want).abs().max().item(),
               "plan": {k: v for k, v in tssd.ssd_plan(
                   B, H, P, N, Bm.element_size(), sms).items()
                   if k in ("p_tile", "np", "ctas", "smem", "per_sm",
                            "waves")}}
        if not err <= K12_TOL:
            raise AssertionError(f"K12 disagrees with its plain version "
                                 f"({tag}): {err} > {K12_TOL}")
        again = tssd.ssd_forward(x, la, Bm, Cm, chunk)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K12 ({tag}): two launches differ")
        if tag != "chunk_kept":
            row["ms"] = time_ms(torch, lambda i: tssd.ssd_forward(
                x, la, Bm, Cm, chunk), n=5, blocks=3)
            row["plain_ms"] = time_ms(torch, lambda i: tssd.ssd_pallas_plain(
                x, la, Bm, Cm, chunk), n=2, blocks=3)
            row["ssd_chunked_ms"] = time_ms(torch, lambda i: tm.ssd_chunked(
                x, la, Bm, Cm, chunk), n=2, blocks=3)
            # Device time of each kernel the call launches (one: the scan).
            row["by_kernel_ms"] = kernel_breakdown(
                torch, lambda: tssd.ssd_forward(x, la, Bm, Cm, chunk))
            nbytes = (2 * B * S * H * P * 4 + B * S * H * 4
                      + 2 * B * S * N * Bm.element_size())
            fl = k12_flops(tssd, B, S, H, P, N, Bm.element_size())
            row["flops"] = fl["tf32"] + fl["bf16"]
            row["flops_by_type"] = fl
            row["useful_f32_flops"] = k12_useful_flops(B, S, H, P, N)
            # TF32 work at 495 TFLOP/s plus bf16 work at 989, as TF32 time.
            row["bound_ms"], row["bound_by"] = bound(
                nbytes, fl["tf32"] + fl["bf16"] * TF32_FLOPS / BF16_FLOPS,
                TF32_FLOPS)
            row["bound_route"] = ("tensor cores, every split-precision "
                                  "pass: TF32 at 495 TFLOP/s, C.B^T of bf16 "
                                  "B/C at 989, once per (batch, block); or "
                                  "bytes at 3.35 TB/s")
            row["f32_cuda_core_bound_ms"] = bound(
                nbytes, row["useful_f32_flops"], F32_FLOPS)[0]
            log(f"K12 ssd_forward {tag} ({row['shape']}): err {err:.2e} "
                f"kernel {row['ms']:.4f} ms (plan {row['plan']})  plain "
                f"{row['plain_ms']:.4f} ms  ssd_chunked "
                f"{row['ssd_chunked_ms']:.4f} ms  bound {row['bound_ms']:.4f}"
                f" ms ({row['bound_by']}, {fl['tf32'] / 1e9:.2f} GFLOP "
                f"TF32 + {fl['bf16'] / 1e9:.2f} bf16; f32 CUDA-core bound "
                f"{row['f32_cuda_core_bound_ms']:.4f} ms)")
            log(f"  K12 kernels (device ms per call): "
                f"{_fmt_breakdown(row['by_kernel_ms'])}")
        else:
            log(f"K12 ssd_forward {tag} ({row['shape']}): err {err:.2e}")
        rows[tag] = row
        del x, la, Bm, Cm, want, got, again

    # The Function's gradients: card (K12 forward, ssd_chunked backward on
    # the card) against the CPU (plain forward, ssd_chunked on the CPU).
    x, la, Bm, Cm = _ssd_case(torch, g, 1, 512, 8, 64, 64, torch.bfloat16)
    gy = torch.randn(x.shape, generator=g, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        ins = [t.detach().to(dev).requires_grad_(True)
               for t in (x, la, Bm, Cm)]
        y = tssd.ssd_pallas(*ins, 64)
        grads[dev] = torch.autograd.grad(y, ins, gy.to(dev))
    grad_err = {}
    for name, a, b in zip(("x", "log_a", "Bm", "Cm"), grads["cuda"],
                          grads["cpu"]):
        if a.dtype != b.dtype:
            raise AssertionError(f"K12 Function: d{name} dtype {a.dtype} on "
                                 f"the card, {b.dtype} on the CPU")
        a, b = a.float().cpu(), b.float()
        grad_err[name] = ((a - b).abs().max() / b.abs().max()).item()
    # f32 grads: sums in other orders; bf16 ones (B, C): one bf16 ulp.
    tol = {"x": 1e-4, "log_a": 1e-4, "Bm": 2 ** -7, "Cm": 2 ** -7}
    if any(grad_err[k] > tol[k] for k in tol):
        raise AssertionError(f"K12 Function grads card vs CPU: {grad_err} "
                             f"(tolerance {tol}, relative to the largest)")
    log(f"K12 Function grads, card vs CPU (B 1, S 512, H 8, P 64, N 64, "
        f"bf16 B/C): {grad_err}")
    main = rows["mamba2_2.7b_layer"]
    report["K12"] = {
        "name": K12, "route": "cuda",
        "source": "ray_tpu_torch/csrc/mamba_ssd.cu",
        "replaces": "ray_tpu/ops/mamba_ssd.py:113",
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": main["ms"], "plain_ms": main["plain_ms"], "library_ms": None,
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "bound_route": main["bound_route"],
        "f32_cuda_core_bound_ms": main["f32_cuda_core_bound_ms"],
        "by_kernel_ms": main["by_kernel_ms"],
        "shape": main["shape"], "cases": rows, "function_grad_err": grad_err}
    torch.cuda.empty_cache()


def _k13_inputs(torch, g, L, B, H, KVH, D, page, maxp, lens_list):
    dev = torch.device("cuda")
    P = B * maxp + 1
    k = torch.randn((L, KVH, P, page, D), generator=g, device=dev,
                    dtype=torch.bfloat16)
    v = torch.randn_like(k)
    q = torch.randn((B, H, D), generator=g, device=dev, dtype=torch.bfloat16)
    lengths = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(P - 1, generator=torch.Generator().manual_seed(13))
    # OOB sentinels (P) past each slot's live pages: clamped, never read.
    bt = torch.full((B, maxp), P, dtype=torch.int32)
    for b, n in enumerate(lens_list):
        live = -(-n // page)
        bt[b, :live] = perm[b * maxp: b * maxp + live].to(torch.int32)
    return q, k, v, bt.to(dev), lengths


def k13_err(got, want) -> dict:
    """K13 against its plain version: both reach the same f32 values up
    to p, round p at the same points and the output to q's dtype, so in
    bf16 they differ by at most one ulp of the output, which is at most
    2^-7 |out|; 1e-5 covers f32 sums in other orders near 0.
    ``over_limit`` > 1 fails."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    limit = 2 ** -7 * want.abs() + 1e-5
    return {"max_abs_err": err.max().item(),
            "over_limit": (err / limit).max().item()}


def kernel_phase_k13(torch, F, tpa, report):
    """K13 against its plain version at LLAMA3_8B decode shapes (8 slots,
    32/8 heads of 128, page 64, bf16 pages of 32 layers), with a
    zero-length slot and OOB page ids, without and with a soft cap, on
    every layer; timed beside the plain version, SDPA on the gathered
    dense k/v and the bound (bytes).  Each timed call reads the next
    layer's pages, as a decode step would, so they come from HBM (one
    layer's 8 MB of live pages would stay in the 50 MB L2); the one-layer
    reading is kept as ``l2_hot_ms``."""
    L, B, H, KVH, D, page, maxp = 32, 8, 32, 8, 128, 64, 16
    lens_list = [0, 1, 63, 64, 65, 1000, 517, 230]
    g = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, bt, lengths = _k13_inputs(torch, g, L, B, H, KVH, D, page, maxp,
                                       lens_list)
    errs = {}
    walk0 = tpa.paged_decode_attention.launches_walk
    for soft_cap in (None, 30.0):
        worst = None
        for layer in range(L):
            got = tpa.paged_decode_attention(q, k[layer], v[layer], bt,
                                             lengths, soft_cap=soft_cap)
            want = tpa.paged_decode_attention_plain(
                q, k[layer], v[layer], bt, lengths, soft_cap=soft_cap)
            torch.cuda.synchronize()
            if not (got[0] == 0).all():
                raise AssertionError("K13: a slot with length 0 must give 0")
            e = k13_err(got, want)
            if worst is None or e["over_limit"] > worst["over_limit"]:
                worst = dict(e, layer=layer)
        errs[str(soft_cap)] = worst
    if any(e["over_limit"] > 1 for e in errs.values()):
        raise AssertionError(f"K13 disagrees with its plain version: {errs}")
    if tpa.paged_decode_attention.launches_walk != walk0:
        raise AssertionError("K13 left its Hopper route at the 8B shape")
    # The limit must see a wrong page: the plain version with one page id
    # of the 1000-token slot pointing at another slot's page fails it.
    kp, vp = k[L - 1], v[L - 1]
    bad = bt.clone()
    bad[5, 3] = bt[6, 0]
    swapped = k13_err(got, tpa.paged_decode_attention_plain(
        q, kp, vp, bad, lengths, soft_cap=30.0))
    if swapped["over_limit"] <= 1:
        raise AssertionError(f"K13's limit passes a swapped page: {swapped}")
    errs["swapped_page"] = swapped
    # Shapes the kernel took only from this version on: a group of 5 query
    # heads (padded to 8 rows) and head_dim 32, one layer each.
    for key, (H_, D_) in {"qpg5": (40, 128), "d32": (32, 32)}.items():
        q_, k_, v_, bt_, len_ = _k13_inputs(torch, g, 1, B, H_, KVH, D_, page,
                                            maxp, lens_list)
        got_ = tpa.paged_decode_attention(q_, k_[0], v_[0], bt_, len_,
                                          soft_cap=30.0)
        errs[key] = k13_err(got_, tpa.paged_decode_attention_plain(
            q_, k_[0], v_[0], bt_, len_, soft_cap=30.0))
        if errs[key]["over_limit"] > 1 or not (got_[0] == 0).all():
            raise AssertionError(f"K13 at {key} disagrees with its plain "
                                 f"version: {errs[key]}")
    ms = time_ms(torch, lambda i: tpa.paged_decode_attention(
        q, k[i % L], v[i % L], bt, lengths))
    l2_hot_ms = time_ms(torch, lambda i: tpa.paged_decode_attention(
        q, kp, vp, bt, lengths))
    plain_ms = time_ms(torch, lambda i: tpa.paged_decode_attention_plain(
        q, k[i % L], v[i % L], bt, lengths), n=4, blocks=3)
    T = maxp * page
    btc = bt.long().clamp(max=k.shape[2] - 1)
    kd = k[:, :, btc].permute(0, 2, 1, 3, 4, 5).reshape(L, B, KVH, T, D)
    vd = v[:, :, btc].permute(0, 2, 1, 3, 4, 5).reshape(L, B, KVH, T, D)
    mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    try:
        F.scaled_dot_product_attention(q4, kd[0], vd[0], attn_mask=mask,
                                       enable_gqa=True)
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd[i], vd[i], attn_mask=mask, enable_gqa=True)
    except TypeError:
        lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            q4, kd[i].repeat_interleave(H // KVH, dim=1),
            vd[i].repeat_interleave(H // KVH, dim=1), attn_mask=mask)
    library_ms = time_ms(torch, lambda i: lib(i % L))
    library_l2_hot_ms = time_ms(torch, lambda i: lib(0))
    del kd, vd
    tokens = sum(lens_list)
    nbytes = (2 * B * H * D * 2 + tokens * KVH * D * 2 * 2 + bt.numel() * 4
              + B * 4)
    b_ms, b_by = bound(nbytes, 4 * tokens * H * D, BF16_FLOPS)
    report["K13"] = {
        "name": K13, "route": "cuda",
        "source": "ray_tpu_torch/csrc/paged_decode.cu",
        "replaces": "ray_tpu/ops/paged_attention.py:157",
        "max_abs_err": max(e["max_abs_err"] for k, e in errs.items()
                           if k != "swapped_page"),
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": b_ms, "bound_by": b_by, "l2_hot_ms": l2_hot_ms,
        "library_l2_hot_ms": library_l2_hot_ms,
        "vs_library": ms / library_ms,
        "shape": f"B={B} H={H} KVH={KVH} D={D} page={page} bf16, lengths "
                 f"{lens_list}, OOB ids past the live pages, {L} layers "
                 "cycled",
        "errors": errs, "bound_bytes": nbytes}
    log(f"K13 paged_decode_attention: err {errs}  kernel {ms:.5f} ms (one "
        f"layer, L2-hot: {l2_hot_ms:.5f})  plain {plain_ms:.4f} ms  SDPA "
        f"{library_ms:.5f} ms (L2-hot {library_l2_hot_ms:.5f})  kernel / "
        f"SDPA {ms / library_ms:.3f}  bound {b_ms:.5f} ms ({b_by})")


def k13_path_phase(torch, tpa, kernels):
    """K13's path: ``paged_decode_attention_tp`` without a mesh (the JAX
    package's fallback, K13 itself) over each layer of a LLAMA3_8B-shaped
    bf16 pool, as a decode step calls it once a layer; counters at 0
    before and read after: K13 32 times, no K1."""
    L, B, H, KVH, D, page, maxp = 32, 8, 32, 8, 128, 64, 16
    lens_list = [0, 1, 63, 64, 65, 1000, 517, 230]
    g = torch.Generator(device="cuda").manual_seed(31)
    q, k, v, bt, lengths = _k13_inputs(torch, g, L, B, H, KVH, D, page, maxp,
                                       lens_list)
    reset_counts(kernels)
    outs = [tpa.paged_decode_attention_tp(q, k[layer], v[layer], bt, lengths)
            for layer in range(L)]
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    if counts[K13] != L or counts[K13 + WALK] or counts[K1] != 0:
        raise AssertionError(f"K13 path: launches {counts} (want K13 {L} on "
                             "its Hopper route, no K1)")
    if not all(torch.isfinite(o).all() and (o[0] == 0).all() for o in outs):
        raise AssertionError("K13 path: outputs not finite, or an empty "
                             "slot not 0")
    log(f"K13 path (paged_decode_attention_tp, no mesh, {L} layers): "
        f"launches {K13} {counts[K13]}")
    return {"launches": counts, "layers": L}


# Shapes of K1's and K13's page-walk route, which the Hopper route
# refuses: (qpg, D) at 8 kv heads.
WALK_SHAPES = {"qpg16_d128": (16, 128), "qpg4_d48": (4, 48)}


def kernel_phase_walk(torch, tpa, kernels, report):
    """K1 and K13 on their page-walk route at the shapes of WALK_SHAPES,
    8 slots of the 8B decode mix, page 64, bf16, 4 layers: counters at 0
    before each kernel's layers and read after (every launch on the page
    walk), each held against its plain version (K1 with
    ``K1_SMOKE_TOL``, K13 with a soft cap within one ulp of the output),
    and timed beside the plain version and the bound (bytes)."""
    L, B, KVH, page, maxp = 4, 8, 8, 64, 16
    lens_list = [0, 1, 63, 64, 65, 1000, 517, 230]
    tokens = sum(lens_list)
    out = {}
    for key, (qpg, D) in WALK_SHAPES.items():
        H = KVH * qpg
        g = torch.Generator(device="cuda").manual_seed(qpg + D)
        q, k, v, bt, lengths = _k13_inputs(torch, g, L, B, H, KVH, D, page,
                                           maxp, lens_list)
        live = lengths > 0
        reset_counts(kernels)
        got = [tpa.paged_decode_attention_partial(q, k, v, layer, bt,
                                                  lengths)
               for layer in range(L)]
        got13 = [tpa.paged_decode_attention(q, k[layer], v[layer], bt,
                                            lengths, soft_cap=30.0)
                 for layer in range(L)]
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        if not (counts[K1] == counts[K1 + WALK] == L
                and counts[K13] == counts[K13 + WALK] == L):
            raise AssertionError(f"walk {key}: launches {counts}, want K1 "
                                 f"and K13 {L} each on the page walk")
        e1 = {"out": 0.0, "m": 0.0, "l_rel": 0.0}
        e13 = {"max_abs_err": 0.0, "over_limit": 0.0}
        for layer in range(L):
            e = k1_err(got[layer], tpa.paged_decode_attention_partial_plain(
                q, k, v, layer, bt, lengths), live)
            e1 = {n: max(e1[n], e[n]) for n in e1}
            if not (got13[layer][0] == 0).all():
                raise AssertionError(f"K13 walk {key}: a slot with length 0 "
                                     "must give 0")
            e = k13_err(got13[layer], tpa.paged_decode_attention_plain(
                q, k[layer], v[layer], bt, lengths, soft_cap=30.0))
            e13 = {n: max(e13[n], e[n]) for n in e13}
        if any(e1[n] > K1_SMOKE_TOL[n] for n in e1) or e13["over_limit"] > 1:
            raise AssertionError(f"walk {key} disagrees with the plain "
                                 f"versions: K1 {e1}, K13 {e13}")
        del got, got13
        nbytes = (B * H * D * 2 + tokens * KVH * D * 2 * 2 + bt.numel() * 4
                  + B * 4)
        b_ms, b_by = bound(nbytes + B * H * (D + 2) * 4,
                           4 * tokens * H * D, BF16_FLOPS)
        b13_ms, _ = bound(nbytes + B * H * D * 2, 4 * tokens * H * D,
                          BF16_FLOPS)
        out[key] = {
            "shape": f"B={B} H={H} KVH={KVH} D={D} page={page} bf16, "
                     f"lengths {lens_list}, {L} layers cycled",
            "K1": {"errors": e1, "bound_ms": b_ms, "bound_by": b_by,
                   "ms": time_ms(torch, lambda i: (
                       tpa.paged_decode_attention_partial(
                           q, k, v, i % L, bt, lengths))),
                   "plain_ms": time_ms(torch, lambda i: (
                       tpa.paged_decode_attention_partial_plain(
                           q, k, v, i % L, bt, lengths)), n=4, blocks=3)},
            "K13": {"errors": e13, "bound_ms": b13_ms,
                    "ms": time_ms(torch, lambda i: tpa.paged_decode_attention(
                        q, k[i % L], v[i % L], bt, lengths)),
                    "plain_ms": time_ms(torch, lambda i: (
                        tpa.paged_decode_attention_plain(
                            q, k[i % L], v[i % L], bt, lengths)),
                        n=4, blocks=3)}}
        for name in ("K1", "K13"):
            r = out[key][name]
            log(f"{name} page walk at qpg {qpg}, D {D}: err {r['errors']}  "
                f"kernel {r['ms']:.5f} ms  plain {r['plain_ms']:.4f} ms  "
                f"bound {r['bound_ms']:.5f} ms")
        del q, k, v
        torch.cuda.empty_cache()
    report["walk"] = out


def mamba_parity_phase(torch, tm, train, kernels):
    """MAMBA2_TINY in f32 with ``use_pallas_ssd=True`` trained 3 steps
    through ``TorchTrainer.fit`` from the same weights and batches on the
    card (K12 forward) and on the CPU (its plain version): the losses and
    grad norms agree."""
    cfg = dataclasses.replace(tm.MAMBA2_TINY, dtype=torch.float32,
                                 use_pallas_ssd=True)
    base = tm.init_params(torch.Generator().manual_seed(7), cfg,
                          device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 2, cfg.max_seq_len),
                           generator=torch.Generator().manual_seed(8),
                           dtype=torch.int32)
    hist, counts = {}, None
    for dev in ("cuda", "cpu"):
        params = _clone_to(torch, base, dev)
        trainer = train.TorchTrainer(
            init_params=lambda g, p=params: p,
            loss_fn=lambda p, b: tm.loss_fn(p, b, cfg),
            optimizer=train.default_optimizer(3e-3, warmup_steps=1),
            scaling_config=train.ScalingConfig(devices=[dev]),
            run_config=train.RunConfig(report_every=1))
        trainer.state
        if dev == "cuda":
            reset_counts(kernels)
        res = trainer.fit(({"tokens": t} for t in tokens), num_steps=3)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts(kernels)
        if res.error is not None:
            raise res.error
        hist[dev] = res.metrics_history
    want = cfg.n_layers * 3   # no remat in MAMBA2_TINY: once a layer
    if counts[K12] != want:
        raise AssertionError(f"Mamba-2 parity: K12 {counts[K12]}, "
                             f"want {want}")
    worst = {}
    for key in ("loss", "grad_norm"):
        a = [m[key] for m in hist["cuda"]]
        b = [m[key] for m in hist["cpu"]]
        worst[key] = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        # f32 on both (TF32 off): K12 vs the plain recurrence, cuBLAS vs
        # the CPU's products sum in other orders.
        if worst[key] > 1e-4:
            raise AssertionError(f"Mamba-2 parity: {key} cuda {a} vs cpu {b}")
    log(f"Mamba-2 parity (MAMBA2_TINY f32, use_pallas_ssd, S "
        f"{cfg.max_seq_len}, 3 steps): losses cuda "
        f"{[round(m['loss'], 6) for m in hist['cuda']]} cpu "
        f"{[round(m['loss'], 6) for m in hist['cpu']]}, worst relative "
        f"{worst}; K12 {counts[K12]}")
    return {"launches": counts, "history": hist, "worst_rel": worst}


def jamba_phase(torch, tm, train, kernels):
    """JAMBA_TINY (an SSM layer, then an attention layer) with
    ``use_pallas_ssd=True`` at S = 512 through ``TorchTrainer.fit`` for 2
    steps on the card: K12 once and K9f, K10, K11 once a step (a hybrid
    does not rematerialise, as in the JAX package)."""
    cfg = dataclasses.replace(tm.JAMBA_TINY, use_pallas_ssd=True)
    gen = torch.Generator().manual_seed(9)
    trainer = train.TorchTrainer(
        init_params=lambda g: tm.init_params(g, cfg),
        loss_fn=lambda p, b: tm.loss_fn(p, b, cfg),
        optimizer=train.default_optimizer(1e-3, warmup_steps=1),
        run_config=train.RunConfig(report_every=1))
    trainer.state
    reset_counts(kernels)
    res = trainer.fit(({"tokens": torch.randint(0, cfg.vocab_size, (2, 512),
                                                generator=gen,
                                                dtype=torch.int32)}
                       for _ in range(2)), num_steps=2)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    if res.error is not None:
        raise res.error
    want = {K12: 2, K9F: 2, K10: 2, K11: 2}
    got = {k: counts[k] for k in want}
    losses = [m["loss"] for m in res.metrics_history]
    if got != want or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"JAMBA_TINY: launches {got} (want {want}), "
                             f"losses {losses}")
    log(f"JAMBA_TINY (S 512, bf16, use_pallas_ssd): 2 steps, losses "
        f"{[round(x, 4) for x in losses]}, launches {got}")
    return {"launches": counts, "losses": losses}


def _mamba_breakdown(torch, step_once) -> dict:
    """Device ms of one train step by kernel family: K12 (its scores and
    scan kernels), cuBLAS's matrix products, the rest (ATen elementwise,
    reductions, copies)."""
    bd = kernel_breakdown(torch, step_once, reps=1)
    if "error" in bd:
        return bd
    total = sum(bd.values())
    k12 = sum(v for k, v in bd.items() if k.startswith("ssd_"))
    gemm = sum(v for k, v in bd.items()
               if re.search(r"gemm|nvjet|cutlass|xmma", k, re.I))
    return {"kernel_ms_total": total, "k12_ms": k12, "gemm_ms": gemm,
            "other_ms": total - gemm - k12, "k12_share": k12 / total,
            "by_kernel": dict(sorted(bd.items(), key=lambda kv: -kv[1]))}


def op_breakdown(torch, fn, top: int = 12) -> dict:
    """Self device ms of the ATen ops (by name and input shapes) that one
    call of ``fn`` runs, from torch.profiler with CPU and CUDA activity:
    the ``top`` largest, so a kernel family's time can be traced to the
    op that launched it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages(group_by_input_shape=True)
    except RuntimeError as e:
        return {"error": repr(e)[:200]}
    rows = []
    for evt in events:
        us = getattr(evt, "self_device_time_total", 0) or getattr(
            evt, "self_cuda_time_total", 0)
        if us and evt.key.startswith("aten::"):
            shapes = str(evt.input_shapes)[:80]
            rows.append((f"{evt.key} {shapes} x{evt.count}", us / 1e3))
    rows.sort(key=lambda kv: -kv[1])
    return dict(rows[:top]) or {"error": "no op with device time"}


def mamba_27b_phase(torch, tm, train, kernels):
    """MAMBA2_2_7B with ``use_pallas_ssd=True`` at full width and depth
    (2.70 B params, 64 layers, bf16 compute, f32 master params, full
    remat) trained through ``TorchTrainer.fit`` on a fixed batch of 2 x
    2048 random tokens: 2 warm-up steps, 3 timed steps, one step under
    the profiler by kernel and one by ATen op, one AdamW update timed on
    its own; counters at 0 before the first step and read after:
    K12 twice a layer a step (forward and recompute), 128 a step.  The
    forward's logits on the batch must be finite and the loss on it must
    fall from the first step to the last."""
    cfg = dataclasses.replace(tm.MAMBA2_2_7B, use_pallas_ssd=True)
    tokens = torch.randint(0, cfg.vocab_size, (MAMBA_B, MAMBA_S),
                           generator=torch.Generator().manual_seed(27),
                           dtype=torch.int32)
    trainer = train.TorchTrainer(
        init_params=lambda g: tm.init_params(g, cfg),
        loss_fn=lambda p, b: tm.loss_fn(p, b, cfg),
        optimizer=train.default_optimizer(1e-4, warmup_steps=10,
                                          mu_dtype=torch.bfloat16),
        run_config=train.RunConfig(report_every=1))
    t0 = time.perf_counter()
    trainer.state
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = {"tokens": tokens}
    with torch.no_grad():
        logits = tm.forward(trainer.state.params, tokens.cuda(), cfg)
        finite = bool(torch.isfinite(logits).all())
        logits_shape = list(logits.shape)
        del logits
    if not finite:
        raise AssertionError("Mamba-2 2.7B: non-finite logits")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    warm = trainer.fit(iter([batch] * 2), num_steps=2)
    if warm.error is not None:
        raise warm.error
    t0 = time.perf_counter()
    timed = trainer.fit(iter([batch] * 3), num_steps=3)
    wall = time.perf_counter() - t0
    if timed.error is not None:
        raise timed.error
    step = trainer._step_fn
    staged = trainer.shard_batch(batch)
    holder = [trainer.state]

    def one_step():
        holder[0], _ = step(holder[0], staged)

    breakdown = _mamba_breakdown(torch, one_step)
    by_op = op_breakdown(torch, one_step)
    trainer._state = holder[0]
    torch.cuda.synchronize()
    # The kernel profile's warm-up call and profiled one, the op profile's.
    n_steps = 2 + 3 + 3
    counts = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # The optimizer's share: one AdamW update of the 2.7 B params (f32
    # master, bf16 first moment) on zero grads (the same arithmetic),
    # stream time between CUDA events.
    state = trainer.state
    grads = train.state.tree_map(torch.zeros_like, state.params)
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    trainer.tx.update_(state.params, grads, state.opt_state)
    ev1.record()
    torch.cuda.synchronize()
    optimizer_ms = ev0.elapsed_time(ev1)
    del grads, state
    losses = [m["loss"] for m in warm.metrics_history
              + timed.metrics_history]
    want = 2 * cfg.n_layers * n_steps
    if counts[K12] != want:
        raise AssertionError(f"Mamba-2 2.7B: K12 {counts[K12]} in {n_steps} "
                             f"steps, want {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"Mamba-2 2.7B: losses {losses} not falling")
    tokens_per_s = MAMBA_B * MAMBA_S * 3 / wall
    params = cfg.num_params()
    out = {"config": "MAMBA2_2_7B (ray_tpu/models/mamba2.py:77), "
                     "use_pallas_ssd=True", "params": params,
           "batch": [MAMBA_B, MAMBA_S], "init_s": init_s,
           "logits_shape": logits_shape, "logits_finite": finite,
           "losses": losses, "step_ms": wall / 3 * 1e3,
           "tokens_per_s": tokens_per_s,
           "mfu": 6 * params * tokens_per_s / BF16_FLOPS,
           "peak_gb": peak_gb, "launches": counts, "steps": n_steps,
           "k12_per_step": counts[K12] / n_steps, "breakdown": breakdown,
           "by_op": by_op, "optimizer_ms": optimizer_ms}
    log(f"Mamba-2 2.7B train ({params / 1e9:.3f} B params, {MAMBA_B} x "
        f"{MAMBA_S}, use_pallas_ssd): {tokens_per_s:.0f} tokens/s, step "
        f"{out['step_ms']:.1f} ms, MFU {out['mfu']:.4f} (6 N tokens/s, "
        f"without the SSD's own work), peak {peak_gb:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; K12 {counts[K12]} in {n_steps} "
        f"steps; one AdamW update {optimizer_ms:.1f} ms")
    if "error" in breakdown:
        log(f"  breakdown: not measured ({breakdown['error']})")
    else:
        out["device_idle_share"] = 1 - breakdown["kernel_ms_total"] / (
            out["step_ms"])
        top = dict(list(breakdown["by_kernel"].items())[:6])
        log(f"  one step's kernels {breakdown['kernel_ms_total']:.1f} ms "
            f"(idle {out['device_idle_share']:.3f} of the step): K12 "
            f"{breakdown['k12_ms']:.1f} ({breakdown['k12_share']:.3f}), "
            f"matrix products {breakdown['gemm_ms']:.1f}, other "
            f"{breakdown['other_ms']:.1f}; top: {_fmt_breakdown(top)}")
    log(f"  by ATen op (self device ms, one step): {_fmt_breakdown(by_op)}")
    del trainer, holder, staged
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# speculative decoding and multi-tenant LoRA (no kernel of their own: their
# verify rows and adapter rows ride K4, K5, K6 and K8)
# --------------------------------------------------------------------------

# Verify rows of 2-5 tokens whose start lies 1-4 tokens before a page
# boundary (page 64) beside four decode rows; then the rows that overwrite
# the rejected tails (each verify row restarts 1 + j tokens on, j drafts
# accepted; the fourth restarts on its page boundary, a fresh page).
VERIFY_ROWS = [(62, 2), (125, 3), (188, 5), (255, 4), (300, 1), (700, 1),
               (1100, 1), (1500, 1)]
REWRITE_ROWS = [(63, 2), (126, 3), (190, 5), (256, 4), (301, 1), (701, 1),
                (1101, 1), (1501, 1)]
VERIFY_T = 24


def verify_rows_phase(torch, llama, quant, trpa, report):
    """K4 (bf16 and int8 pools), K5, K6 and K8 (bf16 and int8 pools) at
    LLAMA3_8B shapes on VERIFY_ROWS, then on REWRITE_ROWS over the state
    the first call left, each against its plain version; K6's second call
    feeds rows 8x larger, so every page it touches is requantised whole
    (its "pages rewritten" case).  Timed beside the plain versions."""
    out = {}
    L, KVH, D = 32, 8, 128
    k, v, q, kn, vn, rows, bt = ragged_inputs(
        torch, seed=81, rows_spec=VERIFY_ROWS, T=VERIFY_T)
    rewrite = row_tensors(torch, REWRITE_ROWS)
    n_tok = sum(n for _, n in VERIFY_ROWS)
    g = torch.Generator(device="cuda").manual_seed(82)
    ki, vi, ks, vs = int8_pools(torch, g, tuple(k.shape))
    for tag, pools, scales in (("K4", (k, v), {}),
                               ("K4 int8", (ki, vi),
                                {"k_scales": ks, "v_scales": vs})):
        err = 0.0
        for rs in (rows, rewrite):
            got = trpa.ragged_paged_attention(q, kn, vn, *pools, 3, *rs, bt,
                                              **scales)
            want = trpa.ragged_paged_attention_plain(q, kn, vn, *pools, 3,
                                                     *rs, bt, **scales)
            err = max(err, (got - want).abs().max().item())
            if got[n_tok:].any():
                raise AssertionError(f"{tag} verify rows: tokens no row "
                                     "covers must be zero")
        if err > 1e-3:
            raise AssertionError(f"{tag} verify rows disagree with the plain "
                                 f"version: {err} (tolerance 1e-3)")
        ms = time_ms(torch, lambda i: trpa.ragged_paged_attention(
            q, kn, vn, *pools, i % L, *rows, bt, **scales))
        plain_ms = time_ms(torch, lambda i: trpa.ragged_paged_attention_plain(
            q, kn, vn, *pools, i % L, *rows, bt, **scales), n=4, blocks=3)
        out[tag] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    T = VERIFY_T
    k_new = torch.randn((L, T, KVH, D), generator=g, device="cuda",
                        dtype=torch.bfloat16)
    v_new = torch.randn_like(k_new)
    got, want = (k.clone(), v.clone()), (k.clone(), v.clone())
    for rs in (rows, rewrite):
        trpa.ragged_paged_append(*got, k_new, v_new, *rs, bt)
        trpa.ragged_paged_append_plain(*want, k_new, v_new, *rs, bt)
        if not all(torch_equal(a[:, :, :-1], b[:, :, :-1])
                   for a, b in zip(got, want)):
            raise AssertionError("K5 verify rows disagree with the plain "
                                 "version")
    del got, want
    out["K5"] = {"max_abs_err": 0.0,
                 "ms": time_ms(torch, lambda i: trpa.ragged_paged_append(
                     k, v, k_new, v_new, *rows, bt)),
                 "plain_ms": time_ms(torch, lambda i:
                                     trpa.ragged_paged_append_plain(
                                         k, v, k_new, v_new, *rows, bt))}
    got = [t.clone() for t in (ki, vi, ks, vs)]
    want = [t.clone() for t in (ki, vi, ks, vs)]
    P = ki.shape[2]
    for tag, rs, mag in (("verify rows", rows, 1.0),
                         ("rewritten tails", rewrite, 8.0)):
        kx = (k_new.float() * mag).to(torch.bfloat16)
        before = got[2].clone()
        trpa.ragged_paged_append_quantized(*got, kx, kx, *rs, bt)
        trpa.ragged_paged_append_quantized_plain(*want, kx, kx, *rs, bt)
        torch.cuda.synchronize()
        compare_quantised(f"K6 ({tag})", got, want, P - 1)
    pages = {int(bt[r, p // 64]) for r, (s_, n) in enumerate(REWRITE_ROWS)
             for p in range(s_, s_ + n)}
    if not all(bool((got[2][:, p] > before[:, p]).all()) for p in pages):
        raise AssertionError("K6: a rewritten page's scale did not grow")
    del got, want
    feed = iter(growing(torch, k_new, 40))
    out["K6"] = {"max_abs_err": 0.0,
                 "ms": time_ms(torch, lambda i:
                               trpa.ragged_paged_append_quantized(
                                   ki, vi, ks, vs, k_new, v_new, *rows, bt)),
                 "rewrite_ms": time_ms(torch, lambda i: (
                     lambda x: trpa.ragged_paged_append_quantized(
                         ki, vi, ks, vs, x, x, *rewrite, bt))(next(feed)),
                     n=5, blocks=3),
                 "plain_ms": time_ms(torch, lambda i:
                                     trpa.ragged_paged_append_quantized_plain(
                                         ki, vi, ks, vs, k_new, v_new, *rows,
                                         bt), n=4, blocks=3)}
    del k, v, ki, vi
    torch.cuda.empty_cache()
    cfg = llama.LLAMA3_8B
    layer, _w = fused_layer_8b(torch, llama, quant, 83)
    k, v, _q, _kn, _vn, rows, bt = ragged_inputs(
        torch, L=1, seed=84, rows_spec=VERIFY_ROWS, T=VERIFY_T)
    ki, vi, ks, vs = int8_pools(torch, g, tuple(k.shape))
    x = torch.randn((T, cfg.dim), generator=g, device="cuda").to(
        torch.bfloat16)
    for tag, pools, scales in (("K8", (k, v), {}),
                               ("K8 int8", (ki, vi),
                                {"k_scales": ks, "v_scales": vs})):
        kw = dict(eps=cfg.norm_eps, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads, **scales)
        err = 0.0
        for spec in (VERIFY_ROWS, REWRITE_ROWS):
            rs = row_tensors(torch, spec)
            pos = torch.zeros(T, dtype=torch.int32)
            at = 0
            for s_, n in spec:
                pos[at:at + n] = torch.arange(s_, s_ + n, dtype=torch.int32)
                at += n
            sin, cos = llama.rope_table(cfg, pos.cuda()[None])
            args = (x, layer, *pools, 0, *rs, bt, sin[0], cos[0])
            got = trpa.fused_ragged_layer(*args, **kw)
            want = trpa.fused_ragged_layer_reference(*args, **kw)
            err = max(err, fused_check(f"{tag} verify rows",
                                       [t[:n_tok] for t in got],
                                       [t[:n_tok] for t in want], FUSED_TOL))
        out[tag] = {"max_abs_err": err,
                    "ms": time_ms(torch, lambda i: trpa.fused_ragged_layer(
                        *args, **kw), n=5, blocks=3),
                    "plain_ms": time_ms(
                        torch, lambda i: trpa.fused_ragged_layer_reference(
                            *args, **kw), n=2, blocks=3)}
    report["verify_rows"] = {"rows": VERIFY_ROWS, "rewrite_rows": REWRITE_ROWS,
                             "T": T, **out}
    for tag, r in out.items():
        log(f"{tag} on verify rows {VERIFY_ROWS} then rewrites "
            f"{REWRITE_ROWS}: err {r['max_abs_err']:.3e}  kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
            + (f"  rewritten pages {r['rewrite_ms']:.4f} ms"
               if "rewrite_ms" in r else ""))


def _tiny_lora(torch, cfg, lora_mod, seed):
    """A LoRA loader for the tiny model: factors drawn on the CPU from a
    generator seeded with ``seed`` and the id, so both devices load the
    same adapters."""
    import zlib

    lora = lora_mod.LoRAConfig(rank=4, alpha=8.0)

    def load(adapter_id):
        g = torch.Generator().manual_seed(seed + zlib.crc32(
            adapter_id.encode()))
        return lora_mod.init_adapter_params(g, cfg, lora)

    return lora, load


def spec_lora_parity_phase(torch, llama, eng_mod, kernels):
    """Tiny f32 Llama, the engine on the card against the engine on the
    CPU, identical greedy streams: spec on with self-draft and with a
    wrong draft (one layer, other weights) on f32 and on int8 pools (on
    f32 pools spec on must also equal spec off); then a batch mixing
    three adapters and the base model, on f32 and on int8 adapter pages,
    with and without spec."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.ops import segmented_lora as lora_mod

    base_cfg = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=512,
                                   dtype=torch.float32)
    draft_cfg = dataclasses.replace(base_cfg, n_layers=1)
    params = llama.init_params(torch.Generator().manual_seed(5), base_cfg,
                               device="cpu", dtype=torch.float32)
    wrong = llama.init_params(torch.Generator().manual_seed(6), draft_cfg,
                              device="cpu", dtype=torch.float32)
    ecfg = dict(max_slots=4, max_seq_len=512, page_size=64,
                max_new_tokens_default=24, ragged_batching=True,
                prefill_chunk=64)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, base_cfg.vocab_size, n).tolist()
               for n in (9, 70, 150, 33)]
    lora, load = _tiny_lora(torch, base_cfg, lora_mod, 7)
    lora_cfg = dataclasses.replace(base_cfg, lora=lora)
    tenants = ["tenant-a", "", "tenant-b", "tenant-c"]
    runs = []
    for pools in ("f32", "int8"):
        cfg = dataclasses.replace(base_cfg, kv_int8=pools == "int8")
        runs.append((f"spec off, {pools} pools", cfg, {}, None, None))
        runs.append((f"spec self-draft, {pools} pools", cfg,
                     {"spec_decode": True}, None, None))
        runs.append((f"spec wrong draft, {pools} pools", cfg,
                     {"spec_decode": True, "spec_cold_accept": 0.0}, wrong,
                     draft_cfg))
    for pages in ("f32", "int8"):
        for spec in (False, True):
            runs.append((f"LoRA mix, {pages} adapter pages"
                         + (", spec" if spec else ""), lora_cfg,
                         {"adapter_int8": pages == "int8",
                          "adapter_page_elems": 4096,
                          "spec_decode": spec}, None, None))
    out = {}
    for name, cfg, kw, draft, dcfg in runs:
        streams, counts, stats = {}, {}, {}
        for device in ("cuda", "cpu"):
            reset_counts(kernels)
            eng = eng_mod.LLMEngine(
                _to(params, device),
                eng_mod.llama_paged_adapter(cfg, load if cfg.lora else None),
                eng_mod.EngineConfig(**ecfg, **kw), device=device,
                draft_params=None if draft is None else _to(draft, device),
                draft_adapter=(None if dcfg is None
                               else eng_mod.llama_paged_adapter(dcfg)))
            try:
                ids = tenants if cfg.lora else [""] * len(prompts)
                streams[device] = [s.result(timeout_s=300) for s in [
                    eng.submit(p, adapter_id=a) for p, a in zip(prompts, ids)]]
                stats[device] = eng.stats()
            finally:
                eng.shutdown()
            counts[device] = read_counts(kernels)
        must = (K4 + INT8, K6) if cfg.kv_int8 else (K4, "ragged_paged_append")
        if any(counts["cuda"][k] == 0 for k in must) \
                or any(counts["cpu"].values()):
            raise AssertionError(f"spec/LoRA parity ({name}): kernel "
                                 f"launches {counts}")
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"spec/LoRA parity ({name}): greedy streams "
                                 f"differ: cuda {streams['cuda']} vs cpu "
                                 f"{streams['cpu']}")
        sp = stats["cuda"].get("spec")
        if kw.get("spec_decode") and not sp["rounds"]:
            raise AssertionError(f"spec/LoRA parity ({name}): no round")
        out[name] = {"streams": streams["cuda"], "spec": sp,
                     "adapters": stats["cuda"].get("adapters")}
        log(f"spec/LoRA parity ({name}): LLAMA_TINY f32, prompts "
            f"{[len(p) for p in prompts]}: cuda == cpu greedy streams "
            f"({sum(len(s) for s in streams['cuda'])} tokens"
            + (f"; {sp['rounds']} rounds, accept ratio "
               f"{sp['accept_ratio']}" if sp else "") + ")")
    for name in ("spec self-draft, f32 pools", "spec wrong draft, f32 pools"):
        if out[name]["streams"] != out["spec off, f32 pools"]["streams"]:
            raise AssertionError(f"{name}: spec on != spec off")
    for pages in ("f32", "int8"):
        mix = out[f"LoRA mix, {pages} adapter pages"]["streams"]
        if out[f"LoRA mix, {pages} adapter pages, spec"]["streams"] != mix:
            raise AssertionError(f"LoRA mix, {pages} pages: spec on != off")
        if mix[1] != out["spec off, f32 pools"]["streams"][1]:
            raise AssertionError(f"LoRA mix, {pages} pages: the null row "
                                 "differs from the adapter-off stream")
    return {k: {kk: vv for kk, vv in v.items() if kk != "streams"}
            for k, v in out.items()}


SPEC_SLOTS, SPEC_GEN, SPEC_N = 16, 32, 24


def _divergence(torch, llama, params, cfg, prompts, base, other):
    """Per stream: the common prefix of ``other`` with ``base``, and at
    the first divergence the rank of ``other``'s token among a dense
    forward's logits at the end of prompt + common prefix (0 = argmax)."""
    prefix, ranks = [], []
    for p, a, b in zip(prompts, base, other):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        prefix.append(n)
        if n < len(b):
            ranks.append(first_token_rank(torch, llama, params, cfg,
                                          p + a[:n], b[n]))
    return prefix, ranks


def rows_step_breakdown(torch, llama, params, cfg, rows_spec, T, page,
                        maxp, step_fn=None, **kw):
    """One 8B ragged step over ``rows_spec`` [(start, len)] (row r on
    slot r, a cache of len(rows_spec) x maxp pages), timed as ``time_step``
    says: ``ragged_step_paged`` with ``kw`` (``logit_idx``), or
    ``step_fn(params, tokens, tok_pos, *rows, block_tables, cache)``."""
    slots = len(rows_spec)
    cache = llama.init_paged_cache(cfg, slots * maxp, page, device="cuda")
    bt = torch.arange(slots * maxp, dtype=torch.int32,
                      device="cuda").reshape(slots, maxp)
    rows = row_tensors(torch, rows_spec)
    pos = torch.zeros(T, dtype=torch.int32)
    at = 0
    for s_, n in rows_spec:
        pos[at:at + n] = torch.arange(s_, s_ + n, dtype=torch.int32)
        at += n
    pos = pos.cuda()
    tokens = torch.randint(0, cfg.vocab_size, (T,), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(14)).cuda()
    if step_fn is None:
        step = lambda: llama.ragged_step_paged(  # noqa: E731
            params, tokens, pos, *rows, bt, cfg, cache, **kw)
    else:
        step = lambda: step_fn(params, tokens, pos, *rows, bt,  # noqa: E731
                               cache)
    return {"rows": rows_spec, "T": T, **time_step(torch, step)}


def spec_serving_phase(torch, llama, eng_mod, kernels, card, params):
    """LLAMA3_8B in bf16 at ``_probe_spec_ablation``'s traffic (bench.py):
    24 prompts of the short_chat mix (32/64/128 tokens, rng 5), 32 new
    tokens, 16 slots, page 64, decode_chunk 8, prefill_chunk 256, ragged;
    spec off, spec on with self-draft, spec on with a LLAMA3_1B-shaped
    random draft (same vocabulary).  Each run: counters at 0 after a
    warm-up request, K4 = 32 x target steps + draft layers x draft steps
    and K5 = target + draft steps."""
    import numpy as np

    cfg = llama.LLAMA3_8B
    rng = np.random.default_rng(5)
    mix_lens, weights = (32, 64, 128), np.asarray((0.5, 0.3, 0.2))
    lens = rng.choice(np.asarray(mix_lens), SPEC_N, p=weights / weights.sum())
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).tolist() for n in lens]
    max_seq = max(512, int(64 * np.ceil((lens.max() + SPEC_GEN + 1) / 64)))
    draft_cfg = llama.LLAMA3_1B
    out, streams = {}, {}
    for label in ("off", "self", "1b"):
        torch.cuda.reset_peak_memory_stats()
        draft = None
        if label == "1b":
            draft = llama.init_params(
                torch.Generator(device="cuda").manual_seed(1), draft_cfg,
                device="cuda", dtype=torch.bfloat16)
        eng = eng_mod.LLMEngine(
            params, eng_mod.llama_paged_adapter(cfg),
            eng_mod.EngineConfig(max_slots=SPEC_SLOTS, max_seq_len=max_seq,
                                 decode_chunk=8,
                                 max_new_tokens_default=SPEC_GEN,
                                 page_size=64, ragged_batching=True,
                                 prefill_chunk=256,
                                 spec_decode=label != "off"),
            device="cuda", draft_params=draft,
            draft_adapter=(eng_mod.llama_paged_adapter(draft_cfg)
                           if draft is not None else None))
        try:
            eng.submit(prompts[0], max_new_tokens=SPEC_GEN).result(
                timeout_s=600)
            st0 = eng.stats()
            reset_counts(kernels)
            t0 = time.perf_counter()
            ss = [eng.submit(p, max_new_tokens=SPEC_GEN) for p in prompts]
            streams[label] = [s.result(timeout_s=600) for s in ss]
            dt = time.perf_counter() - t0
            launches = read_counts(kernels)
            st1 = eng.stats()
        finally:
            eng.shutdown()
        for o in streams[label]:
            if len(o) != SPEC_GEN or not all(0 <= t < cfg.vocab_size
                                             for t in o):
                raise AssertionError(f"8B spec ({label}): stream malformed")
        steps = st1["steps"] - st0["steps"]
        sp0, sp = st0.get("spec") or {}, st1.get("spec") or {}
        dsteps = sp.get("draft_steps", 0) - sp0.get("draft_steps", 0)
        dlayers = (draft_cfg if label == "1b" else cfg).n_layers
        k4, k5 = launches[K4], launches["ragged_paged_append"]
        if k4 != cfg.n_layers * steps + dlayers * dsteps \
                or k5 != steps + dsteps:
            raise AssertionError(
                f"8B spec ({label}): K4 {k4} / K5 {k5} launches, want "
                f"{cfg.n_layers} x {steps} + {dlayers} x {dsteps} and "
                f"{steps} + {dsteps}")
        res = {"decode_tokens_per_s": SPEC_N * SPEC_GEN / dt, "wall_s": dt,
               "target_steps": steps, "draft_steps": dsteps,
               "launches": {K4: k4, "ragged_paged_append": k5},
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
               "card": card}
        if label != "off":
            rounds = sp["rounds"] - sp0["rounds"]
            drafted = sp["drafted_tokens"] - sp0["drafted_tokens"]
            accepted = sp["accepted_tokens"] - sp0["accepted_tokens"]
            res.update({
                "rounds": rounds, "drafted_tokens": drafted,
                "accepted_tokens": accepted,
                "accept_ratio": accepted / drafted if drafted else None,
                "accepted_tokens_per_step": ((accepted + rounds) / rounds
                                             if rounds else None),
                "cooldowns": sp["cooldowns"] - sp0["cooldowns"]})
            if not rounds:
                raise AssertionError(f"8B spec ({label}): no verify round")
            prefix, ranks = _divergence(torch, llama, params, cfg, prompts,
                                        streams["off"], streams[label])
            res["common_prefix"] = prefix
            res["first_divergence_ranks"] = ranks
            if any(r > 1 for r in ranks):
                raise AssertionError(
                    f"8B spec ({label}): a first divergence from spec off "
                    f"ranks {ranks} (want top 2 of the dense logits)")
        del draft
        out[label] = res
        log(f"8B spec {label} ({card}): decode {res['decode_tokens_per_s']:.1f}"
            f" tok/s, {steps} target + {dsteps} draft steps, K4 {k4}, K5 "
            f"{k5}, peak {res['peak_memory_gb']:.2f} GB"
            + (f"; {res['rounds']} rounds, accept ratio "
               f"{res['accept_ratio']}, accepted/step "
               f"{res['accepted_tokens_per_step']}, cooldowns "
               f"{res['cooldowns']}, common prefix {sum(res['common_prefix'])}"
               f"/{SPEC_N * SPEC_GEN} tokens, divergence ranks "
               f"{res['first_divergence_ranks']}" if label != "off" else ""))
        torch.cuda.empty_cache()
    if out["1b"]["cooldowns"] < 1:
        raise AssertionError("8B spec (1B draft): the cooldown never engaged")
    out["speedup_self"] = (out["self"]["decode_tokens_per_s"]
                           / out["off"]["decode_tokens_per_s"])
    out["speedup_1b"] = (out["1b"]["decode_tokens_per_s"]
                         / out["off"]["decode_tokens_per_s"])
    # One step of 16 decode rows against one of 16 verify rows of 5 tokens
    # (with the verify gather), alone, at this phase's budget of 272.
    T = SPEC_SLOTS + 256
    decode = rows_step_breakdown(
        torch, llama, params, cfg, [(100 + 7 * r, 1) for r in
                                    range(SPEC_SLOTS)], T, 64, 8)
    verify = rows_step_breakdown(
        torch, llama, params, cfg, [(100 + 7 * r, 5) for r in
                                    range(SPEC_SLOTS)], T, 64, 8,
        logit_idx=torch.arange(5 * SPEC_SLOTS, dtype=torch.int32,
                               device="cuda"))
    out["decode_step"], out["verify_step"] = decode, verify
    log(f"8B spec: a step of {SPEC_SLOTS} decode rows alone: host "
        f"{decode['host_ms']:.2f} ms, device {decode['device_ms']} ms; of "
        f"{SPEC_SLOTS} verify rows of 5 tokens: host {verify['host_ms']:.2f} "
        f"ms, device {verify['device_ms']} ms ({card})")
    return out


def _merged_params(torch, params, cfg, lora, adapter):
    """``params`` with W + scale * A @ B merged into every targeted weight,
    one layer at a time (an f32 sum rounded to the weights' dtype): the
    dense model one adapter stands for."""
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    qkv = {"wq": slice(0, H * hd), "wk": slice(H * hd, (H + KVH) * hd),
           "wv": slice((H + KVH) * hd, None)}

    def merge(w, target, cols=slice(None)):
        a = adapter[target]["a"].to("cuda")
        b = adapter[target]["b"].to("cuda")
        out = torch.empty_like(w)
        for layer in range(cfg.n_layers):
            dw = (a[layer] @ b[layer])[:, cols] * lora.scale
            out[layer] = (w[layer].float() + dw.reshape(w[layer].shape)
                          ).to(w.dtype)
        return out

    attn, mlp = params["layers"]["attn"], params["layers"]["mlp"]
    merged_attn = {k: merge(attn[k], "qkv", c) for k, c in qkv.items()}
    merged_attn["wo"] = merge(attn["wo"], "o")
    merged_mlp = {"w_gate": merge(mlp["w_gate"], "gate"),
                  "w_up": merge(mlp["w_up"], "up"),
                  "w_down": merge(mlp["w_down"], "down")}
    return {**params, "layers": {**params["layers"], "attn": merged_attn,
                                 "mlp": merged_mlp}}


def lora_serving_phase(torch, llama, eng_mod, kernels, card, params):
    """LLAMA3_8B in bf16 at ``_measure_serving_adapters``' defaults
    (bench.py): 6 adapters drawn Zipf(1.1), a pool of 4, 24 requests of
    96 tokens at 8 requests/s, 16 new tokens, 8 slots, page 32,
    prefill_chunk 64, rank 4; single-model, then multiplexed.  Then null
    rows beside adapter rows against the adapter-off engine, and three
    adapters' first tokens against a dense forward of the merged
    weights."""
    import dataclasses

    import numpy as np

    from ray_tpu_torch.ops import segmented_lora as lora_mod

    cfg = llama.LLAMA3_8B
    n_adapters, pool_adapters, n_req, gen, plen = 6, 4, 24, 16, 96
    rng = np.random.default_rng(11)
    pz = np.arange(1, n_adapters + 1, dtype=np.float64) ** -1.1
    draws = rng.choice(n_adapters, n_req, p=pz / pz.sum())
    prompts = [rng.integers(0, cfg.vocab_size, plen).tolist()
               for _ in range(n_req)]
    max_seq = max(128, int(64 * np.ceil((plen + gen + 1) / 64)))
    lora = lora_mod.LoRAConfig(rank=4, alpha=8.0)
    lcfg = dataclasses.replace(cfg, lora=lora)
    pp = -(-lora_mod.adapter_elems(cfg, lora) // 8192)
    loader = lora_mod.default_adapter_loader(cfg, lora)

    def engine(model_cfg, pages):
        return eng_mod.LLMEngine(
            params, eng_mod.llama_paged_adapter(model_cfg),
            eng_mod.EngineConfig(max_slots=8, max_seq_len=max_seq,
                                 page_size=32, decode_chunk=4,
                                 ragged_batching=True, prefill_chunk=64,
                                 max_new_tokens_default=gen,
                                 adapter_pool_pages=pages),
            device="cuda")

    legs = {}
    for label, model_cfg, ids in (
            ("single", cfg, None),
            ("multiplexed", lcfg, [f"tenant-{d}" for d in draws])):
        eng = engine(model_cfg, pool_adapters * pp if ids else 0)
        try:
            eng.submit(prompts[0][: plen // 2], max_new_tokens=gen,
                       adapter_id=ids[0] if ids else "").result(timeout_s=600)
            reset_counts(kernels)
            steps0 = eng.stats()["steps"]
            t0 = time.perf_counter()
            ss = []
            for i, p in enumerate(prompts):
                delay = t0 + i / 8.0 - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
                ss.append(eng.submit(p, max_new_tokens=gen,
                                     adapter_id=ids[i] if ids else ""))
            outs = [s.result(timeout_s=600) for s in ss]
            dt = time.perf_counter() - t0
            launches = read_counts(kernels)
            st = eng.stats()
        finally:
            eng.shutdown()
        steps = st["steps"] - steps0
        if launches[K4] != cfg.n_layers * steps \
                or launches["ragged_paged_append"] != steps:
            raise AssertionError(f"8B LoRA ({label}): launches {launches} "
                                 f"over {steps} steps")
        ttfts = sorted(s._req.ttft_s for s in ss)
        legs[label] = {
            "tokens_per_s": sum(len(o) for o in outs) / dt,
            "ttft_p50_ms": ttfts[len(ttfts) // 2] * 1e3,
            "ttft_p95_ms": ttfts[min(len(ttfts) - 1,
                                     int(0.95 * len(ttfts)))] * 1e3,
            "steps": steps, "launches": {K4: launches[K4]}}
        if ids:
            pool = st["adapters"]
            legs[label]["pool"] = {k: pool[k] for k in (
                "pool_pages", "resident", "hits", "misses", "evictions")}
            legs[label]["first_tokens"] = [o[0] for o in outs]
        log(f"8B LoRA {label} ({card}): {legs[label]['tokens_per_s']:.1f} "
            f"tok/s, TTFT p50 {legs[label]['ttft_p50_ms']:.1f} ms p95 "
            f"{legs[label]['ttft_p95_ms']:.1f} ms, {steps} steps"
            + (f", pool {legs[label]['pool']}" if ids else ""))
    legs["ratio"] = (legs["multiplexed"]["tokens_per_s"]
                     / legs["single"]["tokens_per_s"])
    # Where the multiplexed leg's time goes: one adapter load (a miss:
    # loader, flatten, hash, upload) and one step of the leg's row mix
    # (seven decode rows, a 64-token chunk; T = 72) alone, base vs LoRA.
    from ray_tpu_torch.serve.adapter_pool import AdapterPool

    pool = AdapterPool(cfg, lora, num_pages=2 * pp, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool.acquire("tenant-0")
    torch.cuda.synchronize()
    legs["adapter_load_s"] = time.perf_counter() - t0
    pool.acquire("tenant-1")
    mix = [(40 + 3 * r, 1) for r in range(7)] + [(0, 64)]
    tok_adapter = torch.tensor([1, 2, 0, 1, 2, 0, 1] + [2] * 64 + [0],
                               dtype=torch.int32, device="cuda")
    page_table = torch.from_numpy(pool.page_table(
        ["tenant-0", "tenant-1"])).cuda()
    lora_step = eng_mod.llama_paged_adapter(lcfg).ragged_step_lora
    legs["base_step"] = rows_step_breakdown(torch, llama, params, cfg, mix,
                                            72, 32, 4)
    legs["lora_step"] = rows_step_breakdown(
        torch, llama, params, lcfg, mix, 72, 32, 4,
        step_fn=lambda *a: lora_step(*a, pool.device_pool, page_table,
                                     tok_adapter))
    del pool
    log(f"8B LoRA: one adapter load {legs['adapter_load_s']:.3f} s; the "
        f"leg's step alone, base: host {legs['base_step']['host_ms']:.2f} ms "
        f"({legs['base_step']['aten_ops']} ATen ops), device "
        f"{legs['base_step']['device_ms']} ms; LoRA (two adapters): host "
        f"{legs['lora_step']['host_ms']:.2f} ms "
        f"({legs['lora_step']['aten_ops']} ATen ops), device "
        f"{legs['lora_step']['device_ms']} ms")
    # Null rows beside adapter rows: four 16-token prompts (each one whole
    # row: the budget of 72 holds them all), two on the base model.
    short = [p[:16] for p in prompts[:4]]
    ids = ["tenant-0", "", "tenant-1", ""]
    mixed = {}
    for label, model_cfg, aids in (("off", cfg, [""] * 4),
                                   ("mixed", lcfg, ids)):
        eng = engine(model_cfg, pool_adapters * pp if model_cfg.lora else 0)
        try:
            mixed[label] = [s.result(timeout_s=600) for s in [
                eng.submit(p, max_new_tokens=gen, adapter_id=a)
                for p, a in zip(short, aids)]]
        finally:
            eng.shutdown()
    if mixed["mixed"][1] != mixed["off"][1] \
            or mixed["mixed"][3] != mixed["off"][3]:
        raise AssertionError("8B LoRA: null-adapter rows differ from the "
                             "adapter-off engine")
    legs["null_rows_equal"] = True
    # The first request of each of the first three adapters: its first
    # token against a dense forward over the merged weights.  This random
    # 8B's logits are flat (std about 1, the top five within about half a
    # std), and these adapters' deltas are twice the weights' size (alpha 8
    # on rank 4), which sharpens attention and amplifies bf16 rounding
    # (merged vs unmerged factors, chunked vs one row) into swaps among
    # near-ties, so a rank bar would gate on noise.  The bar is the token's
    # gap to the top logit: within 1.5 logit std, where a token the adapter
    # did not shape lies about 4 std below; and its rank under the base
    # weights above 100, which shows the adapter took effect.
    checks = []
    for aid in dict.fromkeys(f"tenant-{d}" for d in draws).keys():
        if len(checks) == 3:
            break
        i = [f"tenant-{d}" for d in draws].index(aid)
        tok = legs["multiplexed"]["first_tokens"][i]
        merged = _merged_params(torch, params, cfg, lora, loader(aid))
        with torch.no_grad():
            last = llama.forward(merged, torch.tensor(
                [prompts[i]], device="cuda"), cfg)[0, -1].float()
        del merged
        torch.cuda.empty_cache()
        top = last.topk(5).values
        checks.append({
            "adapter": aid, "request": i, "token": tok,
            "rank": int((last > last[tok]).sum()),
            "gap_to_top": float(top[0] - last[tok]),
            "top5_spread": float(top[0] - top[4]),
            "logit_std": float(last.std()),
            "base_rank": first_token_rank(torch, llama, params, cfg,
                                          prompts[i], tok)})
    if any(c["gap_to_top"] > 1.5 * c["logit_std"] or c["base_rank"] <= 100
           for c in checks):
        raise AssertionError(f"8B LoRA: an adapter's first token lies more "
                             f"than 1.5 logit std under the merged dense "
                             f"forward's top, or the adapter did not move "
                             f"it: {checks}")
    legs["merged_first_tokens"] = checks
    legs["card"] = card
    log(f"8B LoRA: multiplexed / single {legs['ratio']:.3f}; null rows equal "
        f"the adapter-off engine; first tokens against the merged dense "
        f"forward (rank, gap to the top logit, top-5 spread, logit std, rank "
        f"under the base weights): "
        + "; ".join(f"{c['adapter']} {c['rank']}, {c['gap_to_top']:.3f}, "
                    f"{c['top5_spread']:.3f}, {c['logit_std']:.3f}, "
                    f"{c['base_rank']}" for c in checks))
    return legs


# --------------------------------------------------------------------------
# Phase 12: the dense (non-paged) serving path
# --------------------------------------------------------------------------

DENSE_LENS = (17, 300, 700, 1500)
DENSE_NEW = 32


def dense_parity_phase(torch, llama, eng_mod, kernels):
    """Tiny f32 Llama on the dense engine (``llama_adapter``): cuda vs cpu
    greedy streams identical, with prompts long enough for flash buckets
    (K9f on the card, no paged kernel); on the card the dense streams
    equal the paged engine's."""
    import numpy as np

    cfg = dataclasses.replace(llama.LLAMA_TINY, max_seq_len=512,
                              dtype=torch.float32)
    cpu_params = llama.init_params(torch.Generator().manual_seed(2), cfg,
                                   device="cpu", dtype=torch.float32)
    ecfg = eng_mod.EngineConfig(max_slots=4, max_seq_len=512, page_size=64,
                                decode_chunk=8, min_prefill_bucket=32,
                                max_new_tokens_default=16)
    rng = np.random.default_rng(12)
    # Five prompts on four slots: 130 and 300 take buckets 256 and 512.
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 40, 130, 300, 21)]
    streams, counts = {}, None
    for name, device, adapter in (
            ("cuda", "cuda", eng_mod.llama_adapter(cfg)),
            ("cpu", "cpu", eng_mod.llama_adapter(cfg)),
            ("cuda paged", "cuda", eng_mod.llama_paged_adapter(cfg))):
        if name == "cuda":
            reset_counts(kernels)
        eng = eng_mod.LLMEngine(_to(cpu_params, device), adapter, ecfg,
                                device=device)
        try:
            streams[name] = [s.result(timeout_s=300)
                             for s in [eng.submit(p) for p in prompts]]
        finally:
            eng.shutdown()
        if name == "cuda":
            torch.cuda.synchronize()
            counts = read_counts(kernels)
    ran = {k: n for k, n in counts.items() if n}
    if set(ran) != {K9F}:
        raise AssertionError(f"dense parity: launches {ran}, want K9f only")
    for other in ("cpu", "cuda paged"):
        if streams["cuda"] != streams[other]:
            raise AssertionError(f"dense parity: cuda dense streams "
                                 f"{streams['cuda']} vs {other} "
                                 f"{streams[other]}")
    log(f"dense parity: LLAMA_TINY f32, {len(prompts)} prompts of "
        f"{[len(p) for p in prompts]} tokens on 4 slots: cuda dense == cpu "
        f"dense == cuda paged greedy streams "
        f"({sum(len(s) for s in streams['cuda'])} tokens, K9f {ran[K9F]})")
    return {"prompts": [len(p) for p in prompts], "launches": ran,
            "tokens": sum(len(s) for s in streams["cuda"])}


def dense_step_breakdown(torch, llama, params, cfg, lens, slots=8,
                         max_len=2048):
    """One 8B dense decode step outside the engine (timed as ``time_step``
    says), at this run's live slots 16 tokens into their decode."""
    cache = llama.init_kv_cache(cfg, slots, max_len, device="cuda")
    cache["length"][: len(lens)] = torch.tensor(
        [n + 16 for n in lens], dtype=torch.int32)
    active = cache["length"] > 0
    tokens = torch.zeros(slots, dtype=torch.int32, device="cuda")
    step = lambda: llama.decode_slots(  # noqa: E731
        params, tokens, active, cfg, cache)
    out = {"live_lengths": [n + 16 for n in lens], **time_step(torch, step)}
    del cache
    torch.cuda.empty_cache()
    return out


def _serve_8b(torch, eng_mod, params, adapter, ecfg, prompts, kernels):
    """Serve ``prompts`` at once on a fresh engine (after a warm-up
    request) with every counter at 0 just before; returns (streams,
    launches, decode tokens/s, engine steps, TTFTs)."""
    eng = eng_mod.LLMEngine(params, adapter, ecfg, device="cuda")
    try:
        eng.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        torch.cuda.synchronize()
        reset_counts(kernels)
        steps0 = eng.stats()["steps"]
        streams = [eng.submit(p, max_new_tokens=DENSE_NEW) for p in prompts]
        outs = [s.result(timeout_s=600) for s in streams]
        torch.cuda.synchronize()
        launches = read_counts(kernels)
        steps = eng.stats()["steps"] - steps0
        reqs = [s._req for s in streams]
    finally:
        eng.shutdown()
    first = min(r.first_token_at for r in reqs)
    last_done = max(r.finished_at for r in reqs)
    tps = sum(len(o) - 1 for o in outs) / (last_done - first)
    return outs, launches, tps, steps, [r.ttft_s for r in reqs]


def dense_serving_phase(torch, llama, eng_mod, kernels, card, params,
                        paged_phase5_tps):
    """LLAMA3_8B in bf16 (phase 5's weights) on the dense engine: 8 slots
    of 2048, prompts of 17, 300, 700 and 1500 tokens at once (one prefill
    of 4 x 2048: K9f), 32 new tokens; counters at 0 just before: K9f
    risen, no paged kernel.  The paged engine serves the same prompts;
    each dense stream's common prefix with it is printed, and a first
    divergence must rank in the top 2 of a dense forward."""
    import numpy as np

    cfg = llama.LLAMA3_8B
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in DENSE_LENS]
    torch.cuda.reset_peak_memory_stats()
    ecfg = eng_mod.EngineConfig(max_slots=8, max_seq_len=2048, page_size=64,
                                decode_chunk=8)
    outs, launches, tps, steps, ttft = _serve_8b(
        torch, eng_mod, params, eng_mod.llama_adapter(cfg), ecfg, prompts,
        kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for out in outs:
        if len(out) != DENSE_NEW or not all(0 <= t < cfg.vocab_size
                                            for t in out):
            raise AssertionError(f"8B dense stream malformed: {out}")
    ran = {k: n for k, n in launches.items() if n}
    if set(ran) != {K9F}:
        raise AssertionError(f"8B dense serving: launches {ran}, want K9f "
                             "only (no paged kernel)")
    p_outs, p_launches, p_tps, p_steps, _ = _serve_8b(
        torch, eng_mod, params, eng_mod.llama_paged_adapter(cfg), ecfg,
        prompts, kernels)
    prefix, ranks = _divergence(torch, llama, params, cfg, prompts, p_outs,
                                outs)
    if any(r > 1 for r in ranks):
        raise AssertionError(f"8B dense: a first divergence from the paged "
                             f"stream ranks {ranks} (want top 2)")
    breakdown = dense_step_breakdown(torch, llama, params, cfg, DENSE_LENS)
    res = {"config": "LLAMA3_8B bf16, 32 layers, random weights (seed 0)",
           "engine": "dense, max_slots=8 max_seq_len=2048 decode_chunk=8",
           "prompt_lens": list(DENSE_LENS), "max_new_tokens": DENSE_NEW,
           "ttft_s": ttft, "decode_tokens_per_s": tps, "decode_steps": steps,
           "launches": ran, "peak_memory_gb": peak_gb,
           "paged_same_prompts": {"decode_tokens_per_s": p_tps,
                                  "decode_steps": p_steps},
           "paged_phase5_decode_tokens_per_s": paged_phase5_tps,
           "common_prefix": prefix, "first_divergence_ranks": ranks,
           "decode_step": breakdown, "card": card}
    dev_ms = breakdown["device_ms"]
    log(f"8B dense serving ({card}): prompts {list(DENSE_LENS)}, TTFT "
        f"{[round(t, 4) for t in ttft]} s, decode {tps:.1f} tok/s over "
        f"{steps} steps (paged engine on the same prompts {p_tps:.1f}, "
        f"phase 5's paged run {paged_phase5_tps:.1f}), peak {peak_gb:.2f} "
        f"GB, launches {ran}; common prefix with the paged streams {prefix} "
        f"of {DENSE_NEW}, divergence ranks {ranks}")
    log(f"8B dense decode step alone ({breakdown['aten_ops']} ATen ops): "
        f"host {breakdown['host_ms']:.2f} ms, device "
        + (f"{dev_ms:.2f} ms" if dev_ms is not None else
           f"not measured ({breakdown['device_ms_error']})"))
    return res


# --------------------------------------------------------------------------
# Phase 13: int8 Adam states and bench.py's 2.24B point
# --------------------------------------------------------------------------

B2_B = 4                          # bench.py's batch at the 2.24B point
# int8 states: card vs cpu, relative to the block's scale (grads summed in
# other orders move m and sqrt(v) by f32 roundings: one int8 step at most).
ADAM8_SCALE_TOL = 1e-4


def bench_2b_cfg(llama, torch):
    """bench.py's BENCH_2B_CFG (bench.py:72-83)."""
    return llama.LlamaConfig(
        vocab_size=32_768, dim=2560, n_layers=22, n_heads=20, n_kv_heads=4,
        mlp_dim=10240, max_seq_len=TRAIN_S, param_dtype=torch.bfloat16,
        remat_policy="full", loss_chunk=512)


def kernel_phase_gqa(torch, F, tfa, report, tag, B, H, KVH, seed,
                     S=TRAIN_S, D=128):
    """K9f, K10 and K11 at a training attention shape (causal, bf16, a
    GQA group of H / KVH; S 2048 and D 128 unless given) against their
    plain versions, timed beside the plain versions, SDPA and the bound;
    kept under each kernel's ``tag`` entry: ``group5`` is BENCH_2B_CFG's
    (B 4, 20/4 heads), ``group4`` Mixtral 8x7B's (B 2, 32/8 heads),
    ``grpo`` GRPO's at LLAMA3_1B (B 32, S 256, 32/8 heads of 64)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do, o, lse, delta = _bwd_case(torch, tfa, g, B, S, H, KVH, D,
                                           torch.bfloat16)
    report["K9f"][tag] = _k9f_training_row(
        torch, F, tfa, q, k, v, o, lse, tag, timed=True)
    del o
    got = (tfa.flash_backward_dq(q, k, v, do, lse, delta, True),
           *tfa.flash_backward_dkv(q, k, v, do, lse, delta, True))
    want = (tfa.flash_backward_dq_plain(q, k, v, do, lse, delta, True),
            *tfa.flash_backward_dkv_plain(q, k, v, do, lse, delta, True))
    torch.cuda.synchronize()
    errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        rel = err / b.float().abs().max().item()
        errs[name] = {"max_abs_err": err, "rel_to_max": rel}
        if not rel <= BWD_TOL["bfloat16"]:
            raise AssertionError(f"K10/K11 {name} at {tag} disagrees with "
                                 f"its plain version: {rel} of the max")
    del got, want
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                         enable_gqa=True)
    library_ms = time_ms(torch, lambda i: torch.autograd.grad(
        out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True), n=3,
        blocks=3)
    del out, qt, kt, vt
    pairs = S * (S + 1) // 2
    io = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D) + 8 * B * H * S
    for key, fn, plain, extra, mult, part in (
            ("K10", tfa.flash_backward_dq, tfa.flash_backward_dq_plain,
             2 * B * S * H * D, 3, ("dq",)),
            ("K11", tfa.flash_backward_dkv, tfa.flash_backward_dkv_plain,
             2 * 2 * B * S * KVH * D, 4, ("dk", "dv"))):
        ms = time_ms(torch, lambda i, fn=fn: fn(q, k, v, do, lse, delta,
                                                True), n=3, blocks=3)
        plain_ms = time_ms(torch, lambda i, fn=plain: fn(
            q, k, v, do, lse, delta, True), n=2, blocks=3)
        flops = mult * 2 * B * H * D * pairs
        bnd = bound(io + extra, flops, BF16_FLOPS)
        row = {"shape": f"B={B} S={S} H={H} KVH={KVH} D={D} causal bfloat16",
               "max_abs_err": max(errs[n]["max_abs_err"] for n in part),
               "errs": {n: errs[n] for n in part}, "ms": ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bnd[0], "bound_by": bnd[1],
               "tflops": flops / (ms * 1e-3) / 1e12,
               "vs_library": ms / library_ms}
        report[key][tag] = row
        log(f"{key} at {tag}: kernel {ms:.4f} ms ({row['tflops']:.1f} "
            f"TFLOP/s)  plain {plain_ms:.4f} ms  SDPA backward "
            f"{library_ms:.4f} ms  bound {bnd[0]:.4f} ms ({bnd[1]}); errs "
            + ", ".join(f"{n} {e['rel_to_max']:.2e} of max"
                        for n, e in row["errs"].items()))
    del q, k, v, do, lse, delta
    torch.cuda.empty_cache()


def _state_pairs(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _state_pairs(tree[k])
    else:
        yield tree


def adam8_parity_phase(torch, llama, train, kernels):
    """A small f32 Llama at S = 256 trained 3 steps with ``adamw8bit`` on
    the card (K9f, K10, K11) and on the CPU from the same weights and
    batches: losses and grad norms agree, and the int8 states agree within
    one step (scales within ADAM8_SCALE_TOL)."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, mlp_dim=256, max_seq_len=256,
                            dtype=torch.float32, param_dtype=torch.float32)
    base = llama.init_params(torch.Generator().manual_seed(8), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 2, 256),
                           generator=torch.Generator().manual_seed(9),
                           dtype=torch.int32)
    hist, states, counts = {}, {}, None
    for dev in ("cuda", "cpu"):
        params = _clone_to(torch, base, dev)
        trainer = train.TorchTrainer(
            init_params=lambda g, p=params: p,
            loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
            optimizer=train.adamw8bit(1e-3, warmup_steps=1),
            scaling_config=train.ScalingConfig(devices=[dev]),
            run_config=train.RunConfig(report_every=1))
        trainer.state
        if dev == "cuda":
            reset_counts(kernels)
        res = trainer.fit(({"tokens": t} for t in tokens), num_steps=3)
        if res.error is not None:
            raise res.error
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts(kernels)
        hist[dev] = res.metrics_history
        states[dev] = trainer.state.opt_state
    want = {K9F: 2 * 2 * 3, K10: 2 * 3, K11: 2 * 3}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"adam8 parity: launches {got}, want {want}")
    worst = {}
    for key in ("loss", "grad_norm"):
        a = [m[key] for m in hist["cuda"]]
        b = [m[key] for m in hist["cpu"]]
        worst[key] = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        if worst[key] > 1e-4:
            raise AssertionError(f"adam8 parity: {key} cuda {a} vs cpu {b}")
    steps, scale_rel = 0, 0.0
    for m in ("mu", "nu"):
        for (qa, sa), (qb, sb) in zip(_state_pairs(states["cuda"][m]),
                                      _state_pairs(states["cpu"][m])):
            steps = max(steps, (qa.cpu().int() - qb.int()).abs().max().item())
            scale_rel = max(scale_rel, ((sa.cpu() - sb).abs() / sb).max()
                            .item())
    if steps > 1 or scale_rel > ADAM8_SCALE_TOL:
        raise AssertionError(f"adam8 parity: int8 states {steps} steps apart,"
                             f" scales {scale_rel:.2e} relative")
    log(f"adam8 parity (f32, S=256, 3 steps): losses cuda "
        f"{[round(m['loss'], 6) for m in hist['cuda']]}, worst relative loss "
        f"{worst['loss']:.2e}, grad_norm {worst['grad_norm']:.2e}; int8 "
        f"states at most {steps} step apart, scales {scale_rel:.2e}; "
        f"launches {got}")
    return {"launches": got, "worst_rel": worst, "int8_steps": steps,
            "scale_rel": scale_rel}


def _opt_state_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_opt_state_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_opt_state_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def train_2b_phase(torch, llama, train, kernels, repo):
    """BENCH_2B_CFG at full width and depth (22 layers, dim 2560, 20/4
    heads, bf16 master, "full" remat, loss chunks of 512) with
    ``adamw8bit(1e-4, warmup_steps=10)`` on batches of 4 x 2048, as
    bench.py:1580-1593 drives it: 2 warm-up and 3 timed steps through the
    trainer's state and step, counters read per step (full remat: K9f
    twice a layer, forward and recompute; K10 and K11 once), one step's
    kernels under the profiler, the loss on the first batch again, then a
    checkpoint written and restored on the card."""
    cfg = bench_2b_cfg(llama, torch)
    want = {K9F: 2 * cfg.n_layers, K10: cfg.n_layers, K11: cfg.n_layers}
    trainer = train.TorchTrainer(
        init_params=lambda g: llama.init_params(g, cfg),
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        optimizer=train.adamw8bit(1e-4, warmup_steps=10),
        run_config=train.RunConfig(report_every=1_000_000))
    t0 = time.perf_counter()
    state = trainer.state
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = trainer._step_fn
    gen = torch.Generator().manual_seed(3)
    staged = [trainer.shard_batch({"tokens": torch.randint(
        0, cfg.vocab_size, (B2_B, TRAIN_S), generator=gen,
        dtype=torch.int32)}) for _ in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_step, losses = [], []

    def counted(batch):
        # The counters move on the host at each launch: reading them
        # needs no sync.
        nonlocal state
        reset_counts(kernels)
        state, metrics = step(state, batch)
        counts = read_counts(kernels)
        per_step.append({k: counts[k] for k in want})
        losses.append(metrics["loss"])
        return metrics

    for i in range(2):
        counted(staged[i % len(staged)])
    float(losses[-1])
    t0 = time.perf_counter()
    timed = 3
    for i in range(timed):
        metrics = counted(staged[i % len(staged)])
    float(metrics["loss"])
    wall = time.perf_counter() - t0
    losses = [float(x) for x in losses]
    reset_counts(kernels)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], staged[1])

    breakdown = _step_breakdown(torch, one_step)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    per_step.append({k: counts[k] // 2 for k in want})
    state = holder[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if any(c != want for c in per_step):
        raise AssertionError(f"2B training: launches per step {per_step}, "
                             f"want {want}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"2B training: losses {losses}")
    with torch.no_grad():
        end_loss = float(llama.loss_fn(state.params, staged[0], cfg)[0])
    if not end_loss < losses[0]:
        raise AssertionError(f"2B training: loss on the first batch "
                             f"{losses[0]} -> {end_loss}: not falling")
    n = cfg.num_params()
    opt_bytes = sum(_opt_state_bytes(state.opt_state[m])
                    for m in ("mu", "nu"))
    adamw_bytes = 2 * sum(p.numel() * p.element_size()
                          for p in _leaves(state.params))
    # A checkpoint of the whole state (int8 pairs included), written, then
    # restored over a zeroed leaf and a zeroed int8 state: the restore
    # copies into the state's own tensors on the card.
    ckpt_root = os.path.join(repo, "smoke_out", "train_2b_ckpt")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    mngr = train.CheckpointManager(ckpt_root)
    t0 = time.perf_counter()
    mngr.save(state.step, state)
    save_s = time.perf_counter() - t0
    q, sc = state.opt_state["mu"]["layers"]["mlp"]["w_up"]
    saved = (state.params["final_norm"].detach().clone(), q.clone())
    with torch.no_grad():
        state.params["final_norm"].zero_()
        q.zero_()
    t0 = time.perf_counter()
    restored = mngr.restore(state)
    restore_s = time.perf_counter() - t0
    rq, rsc = restored.opt_state["mu"]["layers"]["mlp"]["w_up"]
    if not (rq is q and rsc is sc and rq.is_cuda
            and torch.equal(rq, saved[1])
            and torch.equal(restored.params["final_norm"], saved[0])
            and restored.step == state.step):
        raise AssertionError("2B training: checkpoint restore")
    shutil.rmtree(ckpt_root, ignore_errors=True)
    # One step through fit, so the trainer's families move: steps_total by
    # 1, and the optimizer-state gauge equal to the bytes printed below.
    trainer._state = state
    fit_steps0 = train_telemetry(state.opt_state)["steps_total"]
    result = trainer.fit(iter([staged[2]]), num_steps=1)
    if result.error is not None:
        raise result.error
    telemetry = train_telemetry(trainer.state.opt_state)
    telemetry["fit_steps"] = telemetry["steps_total"] - fit_steps0
    if telemetry["fit_steps"] != 1 or telemetry["state_bytes"] != opt_bytes:
        raise AssertionError(f"2B training: telemetry {telemetry}, state "
                             f"{opt_bytes} bytes")
    tokens_per_s = B2_B * TRAIN_S * timed / wall
    out = {"config": "BENCH_2B_CFG (bench.py:72-83)", "params": n,
           "optimizer": "adamw8bit(1e-4, warmup_steps=10)",
           "batch": [B2_B, TRAIN_S], "init_s": init_s,
           "tokens_per_s": tokens_per_s, "step_ms": wall / timed * 1e3,
           "mfu": 6 * n * tokens_per_s / BF16_FLOPS, "peak_gb": peak_gb,
           "losses": losses, "end_loss_first_batch": end_loss,
           "launches_per_step": per_step, "want_per_step": want,
           "opt_state_bytes": opt_bytes, "adamw_state_bytes": adamw_bytes,
           "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
           "breakdown": breakdown, "telemetry": telemetry}
    log(f"BENCH_2B_CFG train ({n / 1e9:.3f} B params, {B2_B} x {TRAIN_S}, "
        f"adamw8bit): {tokens_per_s:.0f} tokens/s, step "
        f"{out['step_ms']:.1f} ms, MFU {out['mfu']:.4f}, peak "
        f"{peak_gb:.2f} GB; optimizer state {opt_bytes / 1e9:.3f} GB "
        f"(AdamW would hold {adamw_bytes / 1e9:.3f} GB); loss "
        f"{losses[0]:.4f} -> first batch again {end_loss:.4f}; launches per "
        f"step {per_step[0]} (want {want}); checkpoint save {save_s:.1f} s, "
        f"restore {restore_s:.1f} s")
    log(f"  raytpu_train_*: steps_total +{telemetry['fit_steps']} over a "
        f"1-step fit, opt_state_bytes {telemetry['opt_state_bytes']} (= the "
        f"{opt_bytes} state bytes above), hbm_headroom_bytes "
        f"{telemetry['hbm_headroom_bytes']}")
    if "error" in breakdown:
        log(f"  breakdown: not measured ({breakdown['error']})")
    else:
        out["device_idle_share"] = 1 - breakdown["kernel_ms_total"] / (
            wall / timed * 1e3)
        top = dict(list(breakdown["by_kernel"].items())[:6])
        log(f"  one step's kernels {breakdown['kernel_ms_total']:.1f} ms "
            f"(idle {out['device_idle_share']:.3f} of the step): flash "
            f"{breakdown['flash_share']:.3f} "
            f"({_fmt_breakdown(breakdown['flash_ms'])}), matrix products "
            f"{breakdown['gemm_ms']:.1f}, other {breakdown['other_ms']:.1f};"
            f" top: {_fmt_breakdown(top)}")
    del trainer, state, holder, staged, restored, saved
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# Phase 14: the serving engine's planes, LLMServer, trainer telemetry
# --------------------------------------------------------------------------

# Bounds every request meets by nine orders of magnitude: the verdicts
# test the accounting, not the card's speed.
PLANES_SLO = {"ttft_s": 1e9, "tpot_s": 1e9, "e2e_s": 1e9}
PLANES_NEW = 32                  # phase 5's new tokens
SHED_BUDGET_S = 0.05             # the burst's shedding budget
REQUEST_FAMILIES = ("raytpu_serve_request_itl_seconds",
                    "raytpu_serve_request_slo_total",
                    "raytpu_serve_request_terminal_total",
                    "raytpu_serve_goodput_ratio", "raytpu_serve_requests")


def _exposition(metrics) -> dict:
    """{(sample name, sorted label pairs): value} of the port's registry."""
    out = {}
    for line in metrics.export_prometheus().splitlines():
        if not line or line.startswith("#"):
            continue
        name_labels, value = line.rsplit(" ", 1)
        name, _, labels = name_labels.partition("{")
        out[(name, tuple(sorted(p for p in labels.rstrip("}").split(",")
                                if p)))] = float(value)
    return out


def _delta(before, after, name, **labels) -> float:
    key = (name, tuple(sorted(f'{k}="{v}"' for k, v in labels.items())))
    return after.get(key, 0.0) - before.get(key, 0.0)


def _plane_counts(before, after) -> dict:
    """The counts an operator reads off the exposition for one run."""
    return {
        "ttft_count": _delta(before, after, "raytpu_serve_ttft_seconds_count"),
        "finished": _delta(before, after,
                           "raytpu_serve_request_terminal_total",
                           state="FINISHED"),
        "slo_met": _delta(before, after, "raytpu_serve_request_slo_total",
                          outcome="met"),
        "slo_missed": _delta(before, after, "raytpu_serve_request_slo_total",
                             outcome="missed"),
        "shed": _delta(before, after, "raytpu_serve_shed_total"),
        "prefill_tokens": _delta(before, after,
                                 "raytpu_serve_step_tokens_total",
                                 phase="prefill"),
    }


def _check_counts(what, counts, n, prefill) -> None:
    want = {"ttft_count": n, "finished": n, "slo_met": n, "slo_missed": 0,
            "shed": 0, "prefill_tokens": prefill}
    if counts != want:
        raise AssertionError(f"{what}: exposition counts {counts}, want "
                             f"{want}")


def _audit(srv, what) -> dict:
    report = srv.doctor(deep=True)
    if report["violations"]:
        raise AssertionError(f"{what}: deep audit found violations: "
                             f"{report['checks']}")
    return {"violations": report["violations"],
            "checks_run": report["checks_run"],
            "ms": report["audit_seconds"] * 1e3}


def _decode_tps(results) -> float:
    """Decode tokens/s of requests submitted together: tokens after each
    first one over the span from the first first token to the last
    finish (phase 5's definition, from each request's metrics)."""
    first = min(r["metrics"]["ttft_s"] for r in results)
    last = max(r["metrics"]["total_s"] for r in results)
    return sum(len(r["tokens"]) - 1 for r in results) / (last - first)


def _drain_streams(srv, payloads, min_tokens):
    """Stream ``payloads`` through ``srv.stream`` on threads, drain once
    every stream holds ``min_tokens`` tokens, and return (delivered tokens
    per stream, continuations, preempted count)."""
    import threading

    from ray_tpu_torch.core.exceptions import PreemptedError

    got = [[] for _ in payloads]
    conts = [None] * len(payloads)
    errors = []

    def consume(i):
        try:
            for tok in srv.stream(payloads[i]):
                got[i].append(tok)
        except PreemptedError as e:
            conts[i] = e.continuation
        except Exception as e:  # reported by the caller's thread below
            errors.append(e)

    threads = [threading.Thread(target=consume, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 600
    while (min(len(g) for g in got) < min_tokens and not errors
           and time.monotonic() < deadline):
        time.sleep(0.002)
    n = srv.drain(grace_s=0.0)
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("drain: a stream did not end within 600 s")
    if errors or any(c is None for c in conts):
        raise AssertionError(f"drain: streams ended without a continuation "
                             f"({errors}, {conts})")
    return got, conts, n


def tiny_drain_parity(torch, llama, eng_mod) -> dict:
    """Tiny f32 Llama on the card: drain mid-stream (steps in flight),
    then resume each continuation on a second engine; every resumed
    stream equals the undisturbed one token for token."""
    import dataclasses

    import numpy as np

    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda", dtype=torch.float32)
    ecfg = eng_mod.EngineConfig(max_slots=4, max_seq_len=256, page_size=16,
                                min_prefill_bucket=16, decode_chunk=2)
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 20, 40)]
    new = 200
    ref = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg), ecfg,
                            device="cuda")
    try:
        want = [ref.generate(p, max_new_tokens=new) for p in prompts]
    finally:
        ref.shutdown()
    srv = eng_mod.LLMServer(cfg, ecfg, lambda: params,
                            adapter_factory=eng_mod.llama_paged_adapter,
                            device="cuda")
    try:
        got, conts, n = _drain_streams(
            srv, [{"tokens": p, "max_new_tokens": new} for p in prompts], 3)
        audit = _audit(srv, "tiny drain")
    finally:
        srv.engine.shutdown()
    for c, g in zip(conts, got):
        if c["tokens"] != g or len(g) >= new:
            raise AssertionError(f"tiny drain: continuation {c['tokens']} "
                                 f"is not the delivered stream {g}")
    res_eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg),
                                ecfg, device="cuda")
    try:
        resumed = [g + res_eng.generate(c["prompt"] + c["tokens"],
                                        max_new_tokens=new - len(g))
                   for c, g in zip(conts, got)]
    finally:
        res_eng.shutdown()
    if resumed != want:
        raise AssertionError("tiny drain: resumed streams differ from the "
                             "undisturbed ones")
    res = {"preempted": n, "delivered": [len(g) for g in got],
           "audit": audit}
    log(f"planes tiny f32 drain: {n} preempted after {res['delivered']} "
        f"delivered tokens; resumed = undisturbed streams ({new} tokens); "
        f"deep audit {audit['violations']} violations")
    return res


def planes_phase(torch, llama, eng_mod, kernels, card, params, serving):
    """Phase 14, on phase 5's weights: LLAMA3_8B through ``LLMServer``
    (the bucketed paged engine with an SLO, phase 5's traffic; the ragged
    engine with the prefix cache), a shedding burst, a drain mid-stream
    with resumed continuations, and deep audits."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ray_tpu_torch.core.exceptions import ShedError
    from ray_tpu_torch.util import metrics

    cfg = llama.LLAMA3_8B
    slo = eng_mod.SLO(**PLANES_SLO)
    res = {"tiny_drain": tiny_drain_parity(torch, llama, eng_mod),
           "card": card}
    # (a) The bucketed engine through LLMServer at phase 5's traffic.
    rng = np.random.default_rng(6)
    lens = (17, 100, 300, 700)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    payloads = [{"tokens": p, "max_new_tokens": PLANES_NEW} for p in prompts]
    bucketed = dict(max_slots=8, max_seq_len=1024, page_size=64,
                    decode_chunk=8)
    srv = eng_mod.LLMServer(cfg, eng_mod.EngineConfig(**bucketed, slo=slo),
                            lambda: params,
                            adapter_factory=eng_mod.llama_paged_adapter,
                            device="cuda")
    try:
        srv({"tokens": prompts[0][:5], "max_new_tokens": 2})  # warm-up
        torch.cuda.synchronize()
        before = _exposition(metrics)
        reset_counts(kernels)
        with ThreadPoolExecutor(len(payloads)) as ex:
            results = list(ex.map(srv, payloads))
        launches = read_counts(kernels)
        after = _exposition(metrics)
        audit = _audit(srv, "8B LLMServer bucketed")
        pressure = srv.pressure()
        srv.check_health()
        # (d) A drain mid-stream on the same server: every stream holds a
        # few tokens, steps are in flight.
        got, conts, n_pre = _drain_streams(srv, payloads, 4)
        drain_audit = _audit(srv, "8B drain")
    finally:
        srv.engine.shutdown()
    outs = [r["tokens"] for r in results]
    if outs != serving["outputs"]:
        raise AssertionError("8B LLMServer streams differ from phase 5's "
                             "engine-direct streams on the same weights")
    counts = _plane_counts(before, after)
    _check_counts("8B LLMServer bucketed", counts, len(prompts), sum(lens))
    k1, k2 = (launches["paged_decode_attention_partial"],
              launches["paged_append"])
    if (not k1 or not k2 or not launches["flash_forward"]
            or k1 != cfg.n_layers * k2
            or launches["paged_decode_attention_partial" + INT8]
            or launches["paged_decode_attention_partial" + WALK]):
        raise AssertionError(f"8B LLMServer bucketed: launches {launches}")
    problems = _check_exposition(metrics.export_prometheus())
    if problems:
        raise AssertionError(f"8B LLMServer: exposition {problems}")
    res["bucketed"] = {
        "engine": "LLMServer(adapter_factory=llama_paged_adapter), "
                  "max_slots=8 max_seq_len=1024 page_size=64 decode_chunk=8, "
                  f"slo={PLANES_SLO}",
        "prompt_lens": list(lens), "max_new_tokens": PLANES_NEW,
        "launches": launches, "counts": counts, "audit": audit,
        "pressure": pressure,
        "decode_tokens_per_s": _decode_tps(results),
        "ttft_s": [r["metrics"]["ttft_s"] for r in results]}
    log(f"planes 8B LLMServer bucketed ({card}): streams = phase 5's; "
        f"exposition {counts}; decode {res['bucketed']['decode_tokens_per_s']:.1f}"
        f" tok/s; launches {launches}; deep audit {audit['ms']:.3f} ms, "
        f"{audit['violations']} violations over {audit['checks_run']} checks")
    # The drained streams, resumed on a fresh engine: common prefix with
    # phase 5's undisturbed streams, and the rank of a first divergence.
    for c, g in zip(conts, got):
        if c["tokens"] != g or len(g) >= PLANES_NEW:
            raise AssertionError(f"8B drain: continuation {len(c['tokens'])}"
                                 f" tokens, delivered {len(g)}")
    eng = eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg),
                            eng_mod.EngineConfig(**bucketed), device="cuda")
    try:
        streams = [eng.submit(c["prompt"] + c["tokens"],
                              max_new_tokens=PLANES_NEW - len(g))
                   for c, g in zip(conts, got)]
        resumed = [g + s.result(timeout_s=600) for g, s in zip(got, streams)]
    finally:
        eng.shutdown()
    prefix, ranks = _divergence(torch, llama, params, cfg, prompts, outs,
                                resumed)
    # The resumed stream re-prefills prompt + delivered tokens where the
    # undisturbed one decoded them: bf16 rounding of another path, on
    # logits whose top five lie within about half a logit std (a random
    # 8B).  The bar is check_first_token's: the dense forward's top 5.
    if any(r > 4 for r in ranks):
        raise AssertionError(f"8B drain: a resumed stream's first divergence "
                             f"ranks {ranks} (want top 5)")
    res["drain"] = {"preempted": n_pre, "delivered": [len(g) for g in got],
                    "common_prefix": prefix, "first_divergence_ranks": ranks,
                    "audit": drain_audit}
    log(f"planes 8B drain: {n_pre} preempted after {res['drain']['delivered']}"
        f" delivered tokens; resumed streams' common prefix with phase 5's "
        f"{prefix} of {PLANES_NEW}, divergence ranks {ranks}; deep audit "
        f"{drain_audit['ms']:.3f} ms, {drain_audit['violations']} violations")
    # (c) A burst past the slots with a small shedding budget: 16 requests
    # take the 8 slots and queue, and once the queue is older than the
    # budget every further submission is shed.
    burst = [{"tokens": rng.integers(0, cfg.vocab_size, 17).tolist(),
              "max_new_tokens": 16} for _ in range(24)]
    srv = eng_mod.LLMServer(cfg, eng_mod.EngineConfig(
        **bucketed, slo=slo, shed_queue_age_s=SHED_BUDGET_S), lambda: params,
        adapter_factory=eng_mod.llama_paged_adapter, device="cuda")

    def call(payload):
        try:
            return srv(payload)
        except ShedError as e:
            return e

    try:
        srv({"tokens": burst[0]["tokens"][:5], "max_new_tokens": 2})
        before = _exposition(metrics)
        with ThreadPoolExecutor(len(burst)) as ex:
            first = [ex.submit(call, p) for p in burst[:16]]
            deadline = time.monotonic() + 60
            while (srv.engine.admission_queue_age() <= 2 * SHED_BUDGET_S
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            late = [ex.submit(call, p) for p in burst[16:]]
            outcomes = [f.result() for f in first + late]
        after = _exposition(metrics)
        shed_audit = _audit(srv, "8B shed burst")
    finally:
        srv.engine.shutdown()
    n_shed = sum(isinstance(o, ShedError) for o in outcomes)
    shed_total = _delta(before, after, "raytpu_serve_shed_total")
    done = [o for o in outcomes if not isinstance(o, ShedError)]
    if (n_shed == 0 or shed_total != n_shed
            or _delta(before, after, "raytpu_serve_request_terminal_total",
                      state="SHED") != n_shed
            or any(len(o["tokens"]) != 16 for o in done)):
        raise AssertionError(f"8B shed burst: {n_shed} ShedErrors, "
                             f"shed_total {shed_total}, {len(done)} served")
    res["shed"] = {"submitted": len(burst), "shed": n_shed,
                   "shed_total": shed_total, "served": len(done),
                   "budget_s": SHED_BUDGET_S, "audit": shed_audit}
    log(f"planes 8B shed burst: {len(burst)} submitted to 8 slots, {n_shed} "
        f"shed = raytpu_serve_shed_total {shed_total:.0f}, {len(done)} served")
    # (b) The ragged engine with the prefix cache: phase 6's four prompts
    # at once, then two prompts sharing a 512-token prefix one after the
    # other.
    rng = np.random.default_rng(13)
    r_lens = (17, 300, 700, 1500)
    r_prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in r_lens]
    shared = rng.integers(0, cfg.vocab_size, 512).tolist()
    pair = [shared + rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (40, 60)]
    srv = eng_mod.LLMServer(cfg, eng_mod.EngineConfig(
        max_slots=8, max_seq_len=2048, page_size=64, decode_chunk=8,
        ragged_batching=True, prefill_chunk=256, prefix_cache=True, slo=slo),
        lambda: params, adapter_factory=eng_mod.llama_paged_adapter,
        device="cuda")
    try:
        srv({"tokens": r_prompts[0][:5], "max_new_tokens": 2})
        torch.cuda.synchronize()
        before = _exposition(metrics)
        steps0 = srv.stats()["steps"]
        reset_counts(kernels)
        with ThreadPoolExecutor(len(r_prompts)) as ex:
            results = list(ex.map(srv, [{"tokens": p,
                                         "max_new_tokens": PLANES_NEW}
                                        for p in r_prompts]))
        results += [srv({"tokens": p, "max_new_tokens": PLANES_NEW,
                         "request_id": f"planes-pair-{i}"})
                    for i, p in enumerate(pair)]
        launches_r = read_counts(kernels)
        steps = srv.stats()["steps"] - steps0
        after = _exposition(metrics)
        hit = srv.engine._ring.row("planes-pair-1")["prefix_hit"]
        prefix_stats = srv.stats()["prefix"]
        audit_r = _audit(srv, "8B LLMServer ragged")
    finally:
        srv.engine.shutdown()
    n_req = len(r_prompts) + len(pair)
    counts_r = _plane_counts(before, after)
    _check_counts("8B LLMServer ragged", counts_r, n_req,
                  sum(r_lens) + sum(len(p) for p in pair) - 512)
    k4, k5 = (launches_r["ragged_paged_attention"],
              launches_r["ragged_paged_append"])
    if (hit != 512 or k4 != cfg.n_layers * steps or k5 != steps
            or launches_r["ragged_paged_attention" + INT8]):
        raise AssertionError(f"8B LLMServer ragged: hit {hit}, launches "
                             f"{launches_r} over {steps} steps")
    gauges = {g: after.get((g, ()), 0.0) for g in (
        "raytpu_serve_prefix_hit_ratio", "raytpu_serve_kv_pages_cached",
        "raytpu_serve_prefix_cached_pages")}
    hits = _delta(before, after, "raytpu_serve_prefix_requests_total",
                  outcome="hit")
    if hits != 1 or min(gauges.values()) <= 0:
        raise AssertionError(f"8B LLMServer ragged: prefix hits {hits}, "
                             f"gauges {gauges}")
    check_first_token(torch, llama, params, cfg, r_prompts[0],
                      results[0]["tokens"][0], "8B LLMServer ragged")
    res["ragged"] = {
        "engine": "LLMServer, ragged_batching=True prefill_chunk=256 "
                  "prefix_cache=True max_seq_len=2048",
        "prompt_lens": list(r_lens) + [len(p) for p in pair],
        "launches": launches_r, "ragged_steps": steps, "counts": counts_r,
        "prefix_hit_tokens": hit, "prefix_hit_requests": hits,
        "gauges": gauges, "prefix": prefix_stats, "audit": audit_r}
    log(f"planes 8B LLMServer ragged + prefix cache: exposition {counts_r}; "
        f"hit {hit} tokens, gauges {gauges}; K4 {k4} / K5 {k5} over {steps} "
        f"steps; deep audit {audit_r['ms']:.3f} ms, "
        f"{audit_r['violations']} violations")
    res["launches"] = {**launches, **{k: v for k, v in launches_r.items()
                                      if k.startswith("ragged_paged")}}
    # Phase 5 ran with the planes on: its numbers beside PR 14 call 4's
    # (71.6 decode tokens/s; one step alone 61.45 ms of host time).
    res["phase5"] = {"decode_tokens_per_s": serving["decode_tokens_per_s"],
                     "step_host_ms": serving["decode_step"]["host_ms"],
                     "engine_step_ms": serving["engine_step_ms"]}
    log(f"phase 5 with the planes on: {serving['decode_tokens_per_s']:.1f} "
        f"decode tok/s (PR 14 call 4: 71.6), engine step "
        f"{serving['engine_step_ms']:.2f} ms, one step alone host "
        f"{serving['decode_step']['host_ms']:.2f} ms (PR 14 call 4: 61.45)")
    return res


def _check_exposition(text) -> list:
    """scripts/check_metrics.check_exposition over ``text``, pinning the
    request plane's families."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "check_metrics.py")
    spec = importlib.util.spec_from_file_location("check_metrics", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.check_exposition(text, require=REQUEST_FAMILIES)


def train_telemetry(opt_state) -> dict:
    """The trainer's raytpu_train_* values, and the optimizer state's
    bytes counted from its tensors (the gauge must equal them)."""
    from ray_tpu_torch.train import trainer as ttrainer

    tm = ttrainer._telemetry()

    def by_tag(m):
        return {dict(tags).get(m.tag_keys[0], "") if m.tag_keys else "": v
                for _n, tags, v, _k in m._samples()}

    out = {"steps_total": sum(by_tag(tm["steps"]).values()),
           "checkpoints_total": sum(by_tag(tm["checkpoints"]).values()),
           "opt_state_bytes": by_tag(tm["opt_bytes"]),
           "hbm_headroom_bytes": by_tag(tm["hbm_headroom"]),
           "state_bytes": sum(_opt_state_bytes(opt_state[m])
                              for m in ("mu", "nu"))}
    if not (out["opt_state_bytes"].get("global") == out["state_bytes"]
            == out["opt_state_bytes"].get("per_device")
            and out["hbm_headroom_bytes"]):
        raise AssertionError(f"trainer telemetry: {out}")
    return out


# --------------------------------------------------------------------------
# Phase 15: KV page migration, the latency waterfall and the device plane
# --------------------------------------------------------------------------

MIG_NEW = 32                     # phase 6's new tokens
MIG_ENGINE = dict(max_slots=8, max_seq_len=2048, page_size=64, decode_chunk=8,
                  ragged_batching=True, prefill_chunk=256, prefix_cache=True)
WEIGHT_STREAM_MS = 4.79          # PERF.md: bf16 8B weights / 3.35 TB/s


def _mig_engine(eng_mod, cfg, params, device="cuda", **kw):
    return eng_mod.LLMEngine(params, eng_mod.llama_paged_adapter(cfg),
                             eng_mod.EngineConfig(**dict(MIG_ENGINE, **kw)),
                             device=device)


def _mig_export(eng, mode) -> tuple:
    """``export_hot_prefixes`` timed, every lease released after it."""
    t0 = time.perf_counter()
    transfers = eng.export_hot_prefixes(mode=mode)
    sec = time.perf_counter() - t0
    if eng._prefix.leased_pages() or eng._mig_leases:
        raise AssertionError(f"export ({mode}) left leases open: "
                             f"{eng._prefix.leased_pages()}")
    wire = sum(t["wire_bytes"] for t in transfers)
    return transfers, {
        "transfers": len(transfers),
        "pages": sum(len(t["hashes"]) for t in transfers),
        "wire_bytes": wire, "ms": sec * 1e3, "gb_per_s": wire / sec / 1e9}


def _mig_ingest(torch, eng, transfers) -> tuple:
    """Every transfer ingested, timed to the end of the scatter."""
    t0 = time.perf_counter()
    n = sum(eng.migration_ingest(t) for t in transfers)
    torch.cuda.synchronize()
    return n, (time.perf_counter() - t0) * 1e3


def _mig_probe(eng, kernels, probe) -> tuple:
    """One request alone, its kernels counted from 0: (stream, facts)."""
    steps0 = eng.stats()["steps"]
    reset_counts(kernels)
    s = eng.submit(probe, max_new_tokens=MIG_NEW)
    out = s.result(timeout_s=600)
    launches = read_counts(kernels)
    return out, {"prefix_hit": s._req.prefix_hit, "ttft_s": s._req.ttft_s,
                 "steps": eng.stats()["steps"] - steps0,
                 "launches": {k: v for k, v in launches.items()
                              if k.startswith("ragged_paged") and v}}


def _mig_launches_ok(cfg, facts, int8) -> bool:
    ln, steps = facts["launches"], facts["steps"]
    k4 = ln.get("ragged_paged_attention", 0)
    app = ln.get("ragged_paged_append_quantized" if int8
                 else "ragged_paged_append", 0)
    other = ln.get("ragged_paged_append" if int8
                   else "ragged_paged_append_quantized", 0)
    return (steps > 0 and k4 == cfg.n_layers * steps and app == steps
            and not other
            and ln.get("ragged_paged_attention" + INT8, 0)
            == (k4 if int8 else 0))


def _waterfalls(lat, engines) -> dict:
    """Every terminal request's waterfall over its engine's ring row: the
    components must sum to the e2e within 1e-6 s."""
    worst, n = 0.0, 0
    for eng in engines:
        for rec in eng._ring.snapshot():
            if not rec.is_terminal():
                continue
            wf = lat.waterfall(rec.request_id, rows=[rec.to_dict()])
            gap = abs(sum(wf["components"].values()) - wf["e2e_s"])
            if gap > 1e-6 or min(wf["components"].values()) < -1e-9:
                raise AssertionError(f"waterfall of {rec.request_id}: "
                                     f"{wf['components']} vs e2e "
                                     f"{wf['e2e_s']}")
            worst, n = max(worst, gap), n + 1
    return {"requests": n, "max_gap_s": worst}


def tiny_migration_parity(torch, llama, eng_mod, kernels) -> dict:
    """Tiny f32 Llama: a transfer exported by an engine on the CPU and
    ingested by one on the card (the host→device scatter); the card
    engine's probe over the migrated pages is a full hit and its stream
    equals the CPU engine's."""
    import numpy as np

    cfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    params = llama.init_params(torch.Generator().manual_seed(3), cfg,
                               device="cpu", dtype=torch.float32)
    kw = dict(max_seq_len=256, prefill_chunk=64, max_slots=4)
    rng = np.random.default_rng(15)
    prompt = rng.integers(0, cfg.vocab_size, 150).tolist()
    cpu = _mig_engine(eng_mod, cfg, params, device="cpu", **kw)
    try:
        out = cpu.generate(prompt, max_new_tokens=20)
        transfers, exp = _mig_export(cpu, "exact")
        n = cpu._prefix.cached_pages
        probe = (prompt + out)[:n * 64] + [5, 6, 7]
        want = cpu.generate(probe, max_new_tokens=MIG_NEW)
    finally:
        cpu.shutdown()
    card = _mig_engine(eng_mod, cfg, _to(params, "cuda"), **kw)
    try:
        n_in, ingest_ms = _mig_ingest(torch, card, transfers)
        got, facts = _mig_probe(card, kernels, probe)
        audit = card.doctor(deep=True)
    finally:
        card.shutdown()
    if (n_in != n or n < 2 or facts["prefix_hit"] != n * 64 or got != want
            or not _mig_launches_ok(cfg, facts, False)
            or audit["violations"]):
        raise AssertionError(f"tiny migration cpu → card: {n_in} of {n} "
                             f"pages, {facts}, streams equal {got == want}, "
                             f"{audit['violations']} violations")
    log(f"migration tiny f32: cpu engine exported {exp['pages']} pages "
        f"({exp['wire_bytes']} wire bytes), card engine ingested {n_in} in "
        f"{ingest_ms:.2f} ms; probe hit {facts['prefix_hit']} tokens, stream "
        f"= the cpu engine's ({MIG_NEW} tokens), launches "
        f"{facts['launches']}")
    return {"pages": n, "export": exp, "ingest_ms": ingest_ms,
            "probe": facts}


def migration_phase(torch, llama, eng_mod, kernels, card, params) -> dict:
    """Phase 15, on phase 5's weights: hot prefixes of a warm ragged
    engine exported exactly and as int8 and ingested by cold engines (a
    migrated probe's hit, stream and TTFT beside a recomputing engine);
    int8 pools end to end; a lease left open across a drain; with tracing
    on, every request's waterfall, the roofline's serve.ragged row, the
    decode bound and the device-memory gauges."""
    import numpy as np

    from ray_tpu_torch.serve import latency_attribution as lat
    from ray_tpu_torch.util import metrics, tracing, xprof

    cfg = llama.LLAMA3_8B
    res = {"card": card,
           "tiny": tiny_migration_parity(torch, llama, eng_mod, kernels)}
    tracing.clear()
    tracing.enable_tracing()
    t_phase = time.time()
    rng = np.random.default_rng(13)
    lens = (17, 300, 700, 1500)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    shared = rng.integers(0, cfg.vocab_size, 512).tolist()
    pair = [shared + rng.integers(0, cfg.vocab_size, n).tolist()
            for n in (40, 60)]
    tail = rng.integers(0, cfg.vocab_size, 7).tolist()
    engines = []
    try:
        # (a) The warm engine: phase 6's four prompts at once, then the
        # pair one after the other; its hot prefixes exported both ways.
        warm = _mig_engine(eng_mod, cfg, params)
        engines.append(warm)
        warm.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        outs = [s.result(timeout_s=600) for s in
                [warm.submit(p, max_new_tokens=MIG_NEW) for p in prompts]]
        outs += [warm.submit(p, max_new_tokens=MIG_NEW).result(timeout_s=600)
                 for p in pair]
        cached = warm._prefix.cached_pages
        exact, exp_exact = _mig_export(warm, "exact")
        quant, exp_int8 = _mig_export(warm, "int8")
        deepest = max(exact, key=lambda t: len(t["hashes"]))
        depth = len(deepest["hashes"]) * MIG_ENGINE["page_size"]
        probe = deepest["tokens"] + tail
        log(f"migration 8B ({card}): warm engine {cached} cached pages; "
            f"export exact {exp_exact}; int8 {exp_int8}")
        # (b) Cold engine, exact ingest: a full hit over the migrated depth
        # and the warm engine's stream token for token.
        cold = _mig_engine(eng_mod, cfg, params)
        engines.append(cold)
        cold.submit(tail[:5], max_new_tokens=2).result(timeout_s=600)
        n_in, ingest_ms = _mig_ingest(torch, cold, exact)
        got, facts = _mig_probe(cold, kernels, probe)
        want, warm_facts = _mig_probe(warm, kernels, probe)
        if (n_in != cached or cold.stats()["kv_migration"]["pages_in"]
                != cached or facts["prefix_hit"] != depth
                or warm_facts["prefix_hit"] != depth or got != want
                or not _mig_launches_ok(cfg, facts, False)):
            raise AssertionError(f"8B exact migration: {n_in} of {cached} "
                                 f"pages in, probe {facts}, warm {warm_facts},"
                                 f" streams equal {got == want}")
        # The same probe recomputed by a third engine.
        recompute = _mig_engine(eng_mod, cfg, params)
        engines.append(recompute)
        recompute.submit(tail[:5], max_new_tokens=2).result(timeout_s=600)
        rec_out, rec_facts = _mig_probe(recompute, kernels, probe)
        check_first_token(torch, llama, params, cfg, probe, got[0],
                          "8B migrated probe")
        res["exact"] = {"export": exp_exact, "pages_in": n_in,
                        "ingest_ms": ingest_ms, "probe": facts,
                        "warm_probe": warm_facts, "recompute": rec_facts,
                        "recompute_equal": rec_out == got}
        log(f"migration 8B exact: {n_in} pages ingested in {ingest_ms:.1f} "
            f"ms; probe of {len(probe)} tokens hit {facts['prefix_hit']}, "
            f"stream = the warm engine's; TTFT {facts['ttft_s'] * 1e3:.1f} "
            f"ms migrated vs {rec_facts['ttft_s'] * 1e3:.1f} ms recomputed "
            f"(stream equal {rec_out == got}); probe launches "
            f"{facts['launches']} over {facts['steps']} steps")
        # (c) An int8-mode transfer into a bf16 pool: quantised pages, so
        # the stream may part from the warm one at a near-tie.
        cold8 = _mig_engine(eng_mod, cfg, params)
        engines.append(cold8)
        n8, ingest8_ms = _mig_ingest(torch, cold8, quant)
        got8, facts8 = _mig_probe(cold8, kernels, probe)
        prefix, ranks = _divergence(torch, llama, params, cfg, [probe],
                                    [want], [got8])
        if (n8 != cached or facts8["prefix_hit"] != depth
                or any(r > 4 for r in ranks)):
            raise AssertionError(f"8B int8 → bf16 migration: {n8} pages, "
                                 f"probe {facts8}, divergence ranks {ranks}")
        res["int8_into_bf16"] = {"pages_in": n8, "ingest_ms": ingest8_ms,
                                 "probe": facts8, "common_prefix": prefix[0],
                                 "first_divergence_ranks": ranks}
        log(f"migration 8B int8 → bf16 pool: {n8} pages in {ingest8_ms:.1f} "
            f"ms; common prefix with the warm stream {prefix[0]} of "
            f"{MIG_NEW}, divergence ranks {ranks}")
        # (d) A lease left open across drain(): released before the drain's
        # audit, and the deep audit clean with kv.lease_accounting in it.
        lease = cold.migration_lease(probe)
        if len(lease["pages"]) * MIG_ENGINE["page_size"] != depth:
            raise AssertionError(f"lease covers {len(lease['pages'])} pages")
        cold.drain(grace_s=0.0)
        deadline = time.monotonic() + 30
        while cold._mig_leases and time.monotonic() < deadline:
            time.sleep(0.01)
        report = cold.doctor(deep=True)
        checks = {row["check"] for row in report["checks"]}
        if (cold._mig_leases or cold._prefix.leased_pages()
                or report["violations"]
                or "kv.lease_accounting" not in checks):
            raise AssertionError(f"lease across drain: leases "
                                 f"{cold._mig_leases}, report {report}")
        res["drain_lease"] = {"pages": len(lease["pages"]),
                              "violations": report["violations"],
                              "checks_run": report["checks_run"],
                              "ms": report["audit_seconds"] * 1e3}
        log(f"migration drain: a lease of {len(lease['pages'])} pages "
            f"released by the drain; deep audit {report['violations']} "
            f"violations over {report['checks_run']} checks "
            f"(kv.lease_accounting among them)")
        for eng in (warm, recompute, cold8):
            rep = eng.doctor(deep=True)
            if rep["violations"]:
                raise AssertionError(f"8B migration audit: {rep['checks']}")
        res["waterfalls_bf16"] = _waterfalls(lat, engines)
    finally:
        for eng in engines:
            eng.shutdown()
    engines.clear()
    torch.cuda.empty_cache()
    # (e) Both pools int8: the transfer ships raw bytes and scales, no
    # requantisation; the migrated stream equals the warm one.
    cfg8 = dataclasses.replace(cfg, kv_int8=True)
    try:
        warm = _mig_engine(eng_mod, cfg8, params)
        engines.append(warm)
        warm.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        warm.submit(prompts[3], max_new_tokens=MIG_NEW).result(timeout_s=600)
        t8, exp8 = _mig_export(warm, "int8")
        cold = _mig_engine(eng_mod, cfg8, params)
        engines.append(cold)
        n_in, ingest_ms = _mig_ingest(torch, cold, t8)
        got, facts = _mig_probe(cold, kernels, probe)
        want, _ = _mig_probe(warm, kernels, probe)
        back, _ = _mig_export(cold, "exact")
        src = max(t8, key=lambda t: len(t["hashes"]))
        dst = max(back, key=lambda t: len(t["hashes"]))
        raw = all(np.array_equal(np.asarray(src[k]), np.asarray(dst[k]))
                  and np.asarray(src[k]).dtype == np.asarray(dst[k]).dtype
                  for k in ("k", "v", "k_scale", "v_scale"))
        if (n_in != warm._prefix.cached_pages or not raw or got != want
                or facts["prefix_hit"] != depth
                or not _mig_launches_ok(cfg, facts, True)):
            raise AssertionError(f"8B int8 → int8 migration: {n_in} pages, "
                                 f"raw bytes equal {raw}, probe {facts}, "
                                 f"streams equal {got == want}")
        for eng in (warm, cold):
            if eng.doctor(deep=True)["violations"]:
                raise AssertionError("8B int8 migration audit")
        res["int8_pools"] = {"export": exp8, "pages_in": n_in,
                             "ingest_ms": ingest_ms, "probe": facts,
                             "raw_bytes_equal": raw}
        log(f"migration 8B int8 pools: export {exp8}; {n_in} pages in "
            f"{ingest_ms:.1f} ms, bytes and scales re-exported from the cold "
            f"pool equal the warm pool's; probe hit {facts['prefix_hit']}, "
            f"stream = the warm engine's; launches {facts['launches']} over "
            f"{facts['steps']} steps")
        res["waterfalls_int8"] = _waterfalls(lat, engines)
    finally:
        for eng in engines:
            eng.shutdown()
    engines.clear()
    # (f) The device plane, with tracing on since (a).
    agg = lat.aggregate(since=t_phase)
    roof = xprof.roofline()
    tracing.disable_tracing()
    row = roof.get("serve.ragged")
    if row is None or not 0 < row.get("hbm_utilization", 0) <= 1.0:
        raise AssertionError(f"roofline serve.ragged: {row}")
    mc = xprof.llama_costs(cfg, params)
    _f, weights = xprof.step_cost(mc, [(0, 1)], 1)
    bound = {"weights_and_head_ms": weights / HBM_BYTES_PER_S * 1e3,
             "with_embedding_table_ms": (weights + cfg.vocab_size * cfg.dim
                                         * 2) / HBM_BYTES_PER_S * 1e3}
    dec = xprof.programs().get("serve.decode")
    if dec is not None:
        bound["serve_decode_record_ms"] = \
            dec.bytes_accessed / HBM_BYTES_PER_S * 1e3
    if abs(bound["with_embedding_table_ms"] / WEIGHT_STREAM_MS - 1) > 0.02:
        raise AssertionError(f"8B decode bound {bound}")
    torch.cuda.synchronize()
    mem = xprof.sample_device_memory()
    stats = torch.cuda.memory_stats(0)
    expo = _exposition(metrics)
    gauges = {name: expo.get((name, ('device="cuda:0"',)))
              for name in ("raytpu_device_hbm_bytes_in_use",
                           "raytpu_device_hbm_bytes_peak")}
    if (gauges["raytpu_device_hbm_bytes_in_use"]
            != stats["allocated_bytes.all.current"]
            or gauges["raytpu_device_hbm_bytes_peak"]
            != stats["allocated_bytes.all.peak"]):
        raise AssertionError(f"memory gauges {gauges} vs memory_stats "
                             f"{stats['allocated_bytes.all.current']}, "
                             f"{stats['allocated_bytes.all.peak']}")
    res.update(aggregate=agg, roofline=roof, decode_bound=bound,
               memory=mem, memory_gauges=gauges)
    log(f"migration waterfalls: {res['waterfalls_bf16']} and "
        f"{res['waterfalls_int8']} (sum = e2e); control-plane share "
        f"{agg['control_plane_share']:.4f} over {agg['requests']} requests, "
        f"mean components {agg['components']}")
    log(f"roofline serve.ragged ({card}): {row}")
    log(f"decode bound: {bound} (PERF.md {WEIGHT_STREAM_MS} ms counts the "
        f"embedding table whole; a decode step gathers one row a token)")
    log(f"device memory gauges {gauges} = torch.cuda.memory_stats()")
    return res


# --------------------------------------------------------------------------
# Phase 16: the other model families (Mixtral, ViT, CLIP) and the HF import
# --------------------------------------------------------------------------

MIX_B = 2                         # Mixtral 8x7B: 2 x 2048 = 4,096 tokens a
MIX_LAYERS = 2                    # step (C = 1,280); the one cut is depth
MIX_WARM, MIX_TIMED = 2, 4
# Dense and scatter dispatch share the routing and differ only in the
# order of the combine's sums (dense: f32 over the one-hot products;
# scatter: each gate x output rounded to bf16, then summed): one bf16 ulp
# of the loss.
MIX_SCATTER_RTOL = 2 ** -8
FAMILY_B = 64                     # ViT-L/16 and CLIP-L images a step
FAMILY_WARM, FAMILY_TIMED = 2, 3
HF_NEW = 8                        # tokens compared with phase 5's streams


def mixtral_parity_phase(torch, tm, train, kernels):
    """A small f32 Mixtral whose attention takes the flash path on the
    card (S 256, head_dim 64, "dots" remat) trained 3 steps from the same
    weights and batches on the card (K9f, K10, K11) and on the CPU (the
    einsum path): losses and grad norms agree; the routing is f32 on both
    devices."""
    cfg = dataclasses.replace(
        tm.MIXTRAL_TINY, vocab_size=512, dim=256, n_heads=4, n_kv_heads=2,
        mlp_dim=256, max_seq_len=256, dtype=torch.float32, remat=True)
    base = tm.init_params(torch.Generator().manual_seed(11), cfg,
                          device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 2, 256),
                           generator=torch.Generator().manual_seed(12),
                           dtype=torch.int32)
    hist, counts = {}, None
    for dev in ("cuda", "cpu"):
        params = _clone_to(torch, base, dev)
        trainer = train.TorchTrainer(
            init_params=lambda g, p=params: p,
            loss_fn=lambda p, b: tm.loss_fn(p, b, cfg),
            optimizer=train.default_optimizer(1e-3, warmup_steps=1),
            scaling_config=train.ScalingConfig(devices=[dev]),
            run_config=train.RunConfig(report_every=1))
        trainer.state
        if dev == "cuda":
            reset_counts(kernels)
        res = trainer.fit(({"tokens": t} for t in tokens), num_steps=3)
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts(kernels)
        if res.error is not None:
            raise res.error
        hist[dev] = res.metrics_history
    # "dots" remat: K9f twice a layer (forward, recompute), K10/K11 once.
    want = {K9F: 2 * 2 * 3, K10: 2 * 3, K11: 2 * 3}
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"Mixtral parity: launches {got}, want {want}")
    worst = {}
    for key in ("loss", "grad_norm", "aux_loss"):
        a = [m[key] for m in hist["cuda"]]
        b = [m[key] for m in hist["cpu"]]
        worst[key] = max(abs(x - y) / abs(y) for x, y in zip(a, b))
        # f32 both sides (TF32 off); kernel vs einsum and cuBLAS vs the
        # CPU's matmuls sum in other orders.
        if worst[key] > 1e-4:
            raise AssertionError(f"Mixtral parity: {key} cuda {a} vs cpu {b}")
    log(f"Mixtral parity (f32, S=256, D 64, 4 experts, 3 steps): losses "
        f"cuda {[round(m['loss'], 6) for m in hist['cuda']]} cpu "
        f"{[round(m['loss'], 6) for m in hist['cpu']]}, worst relative "
        f"{worst}; launches {got}")
    return {"launches": got, "history": hist, "worst_rel": worst}


def _mixtral_drop_share(torch, tm, params, batch, cfg) -> list:
    """The share of top-k assignments past their expert's capacity in
    each layer, read from ``_route`` over one no-grad forward."""
    shares = []
    route = tm._route

    def counted(*args):
        out = route(*args)
        shares.append(1.0 - float(out[3].mean()))
        return out

    tm._route = counted
    try:
        with torch.no_grad():
            tm.forward(params, batch["tokens"], cfg)
    finally:
        tm._route = route
    return shares


def mixtral_8x7b_phase(torch, tm, train, kernels, card):
    """MIXTRAL_8X7B at full width (dim 4096, 32/8 heads of 128, 8 experts
    of 14,336, top-2, capacity factor 1.25, vocab 32,000, f32 params, bf16
    compute, "dots" remat) cut to 2 layers, trained with AdamW through
    ``TorchTrainer`` on a fixed 2 x 2048 batch: dense dispatch for 2
    warm-up and 4 timed steps (counters read per step: K9f 4, K10 and K11
    2), one step under the profiler, the dropped-assignment share, then
    one step of scatter dispatch from the same state, whose loss must be
    dense's within one bf16 ulp."""
    cfg = dataclasses.replace(tm.MIXTRAL_8X7B, n_layers=MIX_LAYERS)
    L = cfg.n_layers
    want = {K9F: 2 * L, K10: L, K11: L}
    trainer = train.TorchTrainer(
        init_params=lambda g: tm.init_params(g, cfg),
        loss_fn=lambda p, b: tm.loss_fn(p, b, cfg),
        optimizer=train.default_optimizer(1e-4, warmup_steps=1),
        run_config=train.RunConfig(report_every=1_000_000))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.state
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = trainer._step_fn
    batch = trainer.shard_batch({"tokens": torch.randint(
        0, cfg.vocab_size, (MIX_B, TRAIN_S),
        generator=torch.Generator().manual_seed(13), dtype=torch.int32)})
    torch.cuda.synchronize()
    per_step, metrics_seen = [], []

    def counted():
        nonlocal state
        reset_counts(kernels)
        state, metrics = step(state, batch)
        counts = read_counts(kernels)
        per_step.append({k: counts[k] for k in want})
        metrics_seen.append(metrics)
        return metrics

    for _ in range(MIX_WARM):
        counted()
    float(metrics_seen[-1]["loss"])
    t0 = time.perf_counter()
    for _ in range(MIX_TIMED):
        metrics = counted()
    float(metrics["loss"])
    wall = time.perf_counter() - t0
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batch)

    reset_counts(kernels)
    breakdown = _step_breakdown(torch, one_step)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    per_step.append({k: counts[k] // 2 for k in want})
    state = holder[0]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = [{k: float(v) for k, v in m.items()
             if k in ("loss", "ce_loss", "aux_loss", "grad_norm")}
            for m in metrics_seen]
    losses = [h["loss"] for h in hist]
    if any(c != want for c in per_step):
        raise AssertionError(f"Mixtral 8x7B: launches per step {per_step}, "
                             f"want {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"Mixtral 8x7B: losses {losses}: not finite "
                             "and falling")
    drop = _mixtral_drop_share(torch, tm, state.params, batch, cfg)
    # Scatter dispatch from the same state: dense's loss there (no grad),
    # then one scatter training step, whose loss is taken before its
    # update.
    scfg = dataclasses.replace(cfg, dispatch_mode="scatter")
    with torch.no_grad():
        dense_loss = float(tm.loss_fn(state.params, batch, cfg)[0])
    sstep = train.compile_train_step(lambda p, b: tm.loss_fn(p, b, scfg),
                                     trainer.tx)
    reset_counts(kernels)
    t0 = time.perf_counter()
    state, smetrics = sstep(state, batch)
    scatter_loss = float(smetrics["loss"])
    scatter_s = time.perf_counter() - t0
    scounts = read_counts(kernels)
    scounts = {k: scounts[k] for k in want}
    if scounts != want or not math.isfinite(scatter_loss) or \
            abs(scatter_loss - dense_loss) > MIX_SCATTER_RTOL * abs(
                dense_loss):
        raise AssertionError(f"Mixtral 8x7B scatter: loss {scatter_loss} vs "
                             f"dense {dense_loss}, launches {scounts}")
    with torch.no_grad():
        end_loss = float(tm.loss_fn(state.params, batch, cfg)[0])
    n, active = cfg.num_params(), cfg.active_params()
    tokens = MIX_B * TRAIN_S
    tokens_per_s = tokens * MIX_TIMED / wall
    out = {"config": "MIXTRAL_8X7B at 2 layers (ray_tpu/models/mixtral.py"
                     ":65, MixtralConfig defaults)",
           "params": n, "active_params": active,
           "capacity": tm.capacity(cfg, tokens),
           "optimizer": "default_optimizer(1e-4, warmup_steps=1) (AdamW)",
           "batch": [MIX_B, TRAIN_S], "init_s": init_s,
           "step_ms": wall / MIX_TIMED * 1e3, "tokens_per_s": tokens_per_s,
           "mfu_active": 6 * active * tokens_per_s / BF16_FLOPS,
           "peak_gb": peak_gb, "history": hist,
           "end_loss_dense": end_loss, "launches_per_step": per_step,
           "want_per_step": want, "dropped_share_by_layer": drop,
           "scatter": {"loss": scatter_loss, "dense_loss": dense_loss,
                       "rel": abs(scatter_loss - dense_loss) / dense_loss,
                       "step_s": scatter_s, "launches": scounts},
           "breakdown": breakdown, "card": card}
    log(f"Mixtral 8x7B train ({card}; {n / 1e9:.3f} B params, "
        f"{active / 1e9:.3f} B active, 2 layers, {MIX_B} x {TRAIN_S}, C "
        f"{out['capacity']}): step {out['step_ms']:.1f} ms, {tokens_per_s:.0f}"
        f" tokens/s, MFU over active params (attention flops not counted) "
        f"{out['mfu_active']:.4f}, peak {peak_gb:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; dropped share by layer "
        f"{[round(x, 4) for x in drop]}; launches per step {per_step[0]}; "
        f"scatter loss {scatter_loss:.6f} vs dense {dense_loss:.6f} (rel "
        f"{out['scatter']['rel']:.2e})")
    if "error" in breakdown:
        log(f"  breakdown: not measured ({breakdown['error']})")
    else:
        out["device_idle_share"] = 1 - breakdown["kernel_ms_total"] / (
            out["step_ms"])
        top = dict(list(breakdown["by_kernel"].items())[:6])
        log(f"  one step's kernels {breakdown['kernel_ms_total']:.1f} ms "
            f"(idle {out['device_idle_share']:.3f} of the step): flash "
            f"{breakdown['flash_share']:.3f} "
            f"({_fmt_breakdown(breakdown['flash_ms'])}), matrix products "
            f"{breakdown['gemm_ms']:.1f}, other {breakdown['other_ms']:.1f};"
            f" top: {_fmt_breakdown(top)}")
    del trainer, state, holder, batch, step, sstep
    torch.cuda.empty_cache()
    return out


def _f32_family(torch, tvit, tclip):
    vcfg = dataclasses.replace(tvit.VIT_TINY, dtype=torch.float32)
    ccfg = dataclasses.replace(
        tclip.CLIP_TINY,
        vision=dataclasses.replace(tclip.CLIP_TINY.vision,
                                   dtype=torch.float32),
        text=dataclasses.replace(tclip.CLIP_TINY.text, dtype=torch.float32))
    return vcfg, ccfg


def _vit_loss(tvit, cfg):
    return lambda p, b: (tvit.loss_fn(p, b["images"], b["labels"], cfg), {})


def _clip_loss(tclip, cfg):
    return lambda p, b: (tclip.contrastive_loss(p, b["images"], b["tokens"],
                                                cfg), {})


def _images_batch(torch, gen, B, vcfg):
    return torch.randn((B, vcfg.image_size, vcfg.image_size, vcfg.channels),
                       generator=gen)


def vit_clip_parity_phase(torch, tvit, tclip, train, kernels):
    """VIT_TINY and CLIP_TINY in f32 trained 3 steps from the same weights
    and batches on the card and on the CPU: losses and grad norms agree.
    No kernel runs (non-causal S 17, causal S 16: the einsum path)."""
    vcfg, ccfg = _f32_family(torch, tvit, tclip)
    gen = torch.Generator().manual_seed(14)
    cases = {
        "vit_tiny": (tvit.init_params(gen, vcfg, device="cpu"),
                     _vit_loss(tvit, vcfg),
                     {"images": _images_batch(torch, gen, 8, vcfg),
                      "labels": torch.randint(0, 10, (8,), generator=gen)}),
        "clip_tiny": (tclip.init_params(gen, ccfg, device="cpu"),
                      _clip_loss(tclip, ccfg),
                      {"images": _images_batch(torch, gen, 8, ccfg.vision),
                       "tokens": torch.randint(1, 256, (8, 16),
                                               generator=gen)}),
    }
    out = {}
    for name, (base, loss, batch) in cases.items():
        hist = {}
        for dev in ("cuda", "cpu"):
            params = _clone_to(torch, base, dev)
            trainer = train.TorchTrainer(
                init_params=lambda g, p=params: p, loss_fn=loss,
                optimizer=train.default_optimizer(1e-3, warmup_steps=1),
                scaling_config=train.ScalingConfig(devices=[dev]),
                run_config=train.RunConfig(report_every=1))
            trainer.state
            reset_counts(kernels)
            res = trainer.fit(iter([batch] * 3), num_steps=3)
            if res.error is not None:
                raise res.error
            if any(read_counts(kernels).values()):
                raise AssertionError(f"{name}: a kernel ran: "
                                     f"{read_counts(kernels)}")
            hist[dev] = res.metrics_history
        worst = {}
        for key in ("loss", "grad_norm"):
            a = [m[key] for m in hist["cuda"]]
            b = [m[key] for m in hist["cpu"]]
            worst[key] = max(abs(x - y) / abs(y) for x, y in zip(a, b))
            if worst[key] > 1e-4:
                raise AssertionError(f"{name} parity: {key} cuda {a} vs "
                                     f"cpu {b}")
        out[name] = {"history": hist, "worst_rel": worst}
        log(f"{name} parity (f32, 3 steps): losses cuda "
            f"{[round(m['loss'], 6) for m in hist['cuda']]} cpu "
            f"{[round(m['loss'], 6) for m in hist['cpu']]}, worst relative "
            f"{worst}")
    return out


def _family_train(torch, train, kernels, card, what, init, loss, batch,
                  images):
    """``what`` at full width through ``TorchTrainer`` with AdamW on one
    fixed batch: 2 warm-up and 3 timed steps, peak memory, the loss on
    the batch before and after; no kernel may run (both towers take the
    einsum path)."""
    trainer = train.TorchTrainer(
        init_params=init, loss_fn=loss,
        optimizer=train.default_optimizer(1e-4, warmup_steps=1),
        run_config=train.RunConfig(report_every=1_000_000))
    torch.cuda.reset_peak_memory_stats()
    state = trainer.state
    n_params = sum(t.numel() for t in _leaves(state.params))
    step = trainer._step_fn
    staged = trainer.shard_batch(batch)
    reset_counts(kernels)
    losses = []
    for _ in range(FAMILY_WARM):
        state, m = step(state, staged)
        losses.append(m["loss"])
    float(losses[-1])
    t0 = time.perf_counter()
    for _ in range(FAMILY_TIMED):
        state, m = step(state, staged)
        losses.append(m["loss"])
    float(losses[-1])
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in read_counts(kernels).items() if v}
    with torch.no_grad():
        end_loss = float(loss(state.params, staged)[0])
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launched or not all(math.isfinite(x) for x in losses) or \
            not end_loss < losses[0]:
        raise AssertionError(f"{what}: losses {losses} -> {end_loss}, "
                             f"kernels launched {launched}")
    out = {"params": n_params, "batch": images,
           "optimizer": "default_optimizer(1e-4, warmup_steps=1) (AdamW)",
           "step_ms": wall / FAMILY_TIMED * 1e3,
           "images_per_s": images * FAMILY_TIMED / wall,
           "peak_gb": peak_gb, "losses": losses,
           "end_loss_first_batch": end_loss, "card": card}
    log(f"{what} train ({card}; {n_params / 1e6:.1f} M params, batch "
        f"{images}): step {out['step_ms']:.1f} ms, "
        f"{out['images_per_s']:.1f} images/s, peak {peak_gb:.2f} GB; loss "
        f"{[round(x, 4) for x in losses]} -> {end_loss:.4f}")
    del trainer, state, staged, step
    torch.cuda.empty_cache()
    return out


def vit_clip_phase(torch, tvit, tclip, train, kernels, card):
    """ViT-L/16 at 224 with 1,000 classes and CLIP_L14_LIKE (a ViT-L/16
    image tower and a 12-layer text tower at S 77) at full width and
    depth, each on a fixed batch of 64."""
    gen = torch.Generator().manual_seed(15)
    vcfg = tvit.VIT_L16
    vit = _family_train(
        torch, train, kernels, card, "ViT-L/16",
        lambda g: tvit.init_params(g, vcfg), _vit_loss(tvit, vcfg),
        {"images": _images_batch(torch, gen, FAMILY_B, vcfg),
         "labels": torch.randint(0, vcfg.num_classes, (FAMILY_B,),
                                 generator=gen)},
        FAMILY_B)
    if vit["params"] != vcfg.num_params():
        raise AssertionError(f"ViT-L/16: {vit['params']} params, the config "
                             f"counts {vcfg.num_params()}")
    ccfg = tclip.CLIP_L14_LIKE
    clip = _family_train(
        torch, train, kernels, card, "CLIP-L",
        lambda g: tclip.init_params(g, ccfg), _clip_loss(tclip, ccfg),
        {"images": _images_batch(torch, gen, FAMILY_B, ccfg.vision),
         "tokens": torch.randint(1, ccfg.text.vocab_size,
                                 (FAMILY_B, ccfg.text.max_len),
                                 generator=gen)},
        FAMILY_B)
    return {"vit_l16": vit, "clip_l": clip}


_ST_DTYPE_NAMES = {"torch.float32": "F32", "torch.bfloat16": "BF16",
                   "torch.float16": "F16", "torch.int8": "I8",
                   "torch.int32": "I32", "torch.int64": "I64"}


def write_safetensors(torch, path, tensors) -> int:
    """``tensors`` laid out by hand in the public safetensors format (the
    card's machine has no ``safetensors`` package): an 8-byte
    little-endian header length, a JSON header (dtype, shape, data
    offsets), padded with spaces to 8 bytes, then the raw bytes."""
    import struct

    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _ST_DTYPE_NAMES[str(t.dtype)],
                        "shape": list(t.shape),
                        "data_offsets": [off, off + len(raw)]}
        blobs.append(raw)
        off += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)
    return 8 + len(text) + off


def hf_state_dict(params, cfg) -> dict:
    """A Llama param tree rewritten into HF names and [out, in] layouts
    (on the tree's device and in its dtype): the inverse of the import's
    mapping (models/hf_import.py's docstring)."""
    d, h, kvh, hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a, m = params["layers"]["attn"], params["layers"]["mlp"]
    sd = {"model.embed_tokens.weight": params["tok_embed"],
          "model.norm.weight": params["final_norm"]}
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd[pre + "self_attn.q_proj.weight"] = \
            a["wq"][i].reshape(d, h * hd).T.contiguous()
        sd[pre + "self_attn.k_proj.weight"] = \
            a["wk"][i].reshape(d, kvh * hd).T.contiguous()
        sd[pre + "self_attn.v_proj.weight"] = \
            a["wv"][i].reshape(d, kvh * hd).T.contiguous()
        sd[pre + "self_attn.o_proj.weight"] = \
            a["wo"][i].reshape(h * hd, d).T.contiguous()
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
            sd[pre + f"mlp.{theirs}.weight"] = m[ours][i].T.contiguous()
        sd[pre + "input_layernorm.weight"] = params["layers"]["ln_attn"][i]
        sd[pre + "post_attention_layernorm.weight"] = \
            params["layers"]["ln_mlp"][i]
    if not cfg.tie_embeddings:
        sd["lm_head.weight"] = params["lm_head"].T.contiguous()
    return sd


def hf_config(cfg) -> dict:
    """The HF config.json of a LlamaConfig (no rope scaling, no biases)."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers,
            "num_attention_heads": cfg.n_heads,
            "num_key_value_heads": cfg.n_kv_heads,
            "intermediate_size": cfg.mlp_dim,
            "max_position_embeddings": cfg.max_seq_len,
            "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.norm_eps,
            "tie_word_embeddings": cfg.tie_embeddings,
            "attention_bias": False, "mlp_bias": False}


def _equal_trees(torch, got, want, what) -> int:
    g, w = dict(_named_leaves(got)), dict(_named_leaves(want))
    if set(g) != set(w):
        raise AssertionError(f"{what}: leaves {sorted(set(g) ^ set(w))}")
    for k in w:
        if g[k].dtype != w[k].dtype or g[k].device != w[k].device \
                or not torch.equal(g[k], w[k]):
            raise AssertionError(f"{what}: leaf {k} differs ({g[k].dtype} "
                                 f"{g[k].device} vs {w[k].dtype} "
                                 f"{w[k].device})")
    return len(w)


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def hf_import_phase(torch, llama, quant, thf, eng_mod, kernels, card,
                    params, serving, repo):
    """The HF import at LLAMA3_8B on phase 5's weights: the bf16 tree
    rewritten into HF names and [out, in] layouts on the card, imported
    with ``params_from_hf_state_dict`` (every leaf equal to its source bit
    for bit), phase 5's prompts served for HF_NEW tokens on the bucketed
    engine from the imported tree (streams equal to phase 5's over those
    tokens; K1, K2 and K9f counted from 0), ``quantize=True`` against
    ``quant.quantize_params`` of the same tree (one layer at a time); then
    a tiny f32 model laid out by hand as two ``.safetensors`` shards and
    ``config.json`` and read back through ``load_llama_from_hf(dir)``."""
    import numpy as np

    cfg = dataclasses.replace(llama.LLAMA3_8B, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sd = hf_state_dict(params, cfg)
    torch.cuda.synchronize()
    rewrite_s = time.perf_counter() - t0
    hcfg = thf.llama_config_from_hf(hf_config(cfg),
                                    param_dtype=torch.bfloat16)
    arch = ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
            "mlp_dim", "max_seq_len", "rope_theta", "norm_eps",
            "tie_embeddings", "rope_scaling", "param_dtype")
    if any(getattr(hcfg, f) != getattr(cfg, f) for f in arch):
        raise AssertionError(f"HF config translation: {hcfg} != {cfg}")
    t0 = time.perf_counter()
    imported = thf.params_from_hf_state_dict(sd, hcfg)
    torch.cuda.synchronize()
    import_s = time.perf_counter() - t0
    n_leaves = _equal_trees(torch, imported, params, "8B HF import")
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    t0 = time.perf_counter()
    qimp = thf.params_from_hf_state_dict(sd, hcfg, quantize=True)
    torch.cuda.synchronize()
    qimport_s = time.perf_counter() - t0
    del sd
    # quant.quantize_params on one layer's slice of each stacked leaf
    # equals that slice of the whole tree's (the scale keeps the layer
    # axis), with one layer's f32 temporaries instead of the tree's.
    n_q = 0
    for i in range(cfg.n_layers):
        one = {"layers": {grp: {k: v[i:i + 1] for k, v in leaves.items()}
                          for grp, leaves in params["layers"].items()
                          if isinstance(leaves, dict)}}
        want = quant.quantize_params(one)["layers"]
        got = {grp: {k: {"q": v["q"][i:i + 1], "scale": v["scale"][i:i + 1]}
                     for k, v in leaves.items()}
               for grp, leaves in qimp["layers"].items()
               if isinstance(leaves, dict)}
        n_q += _equal_trees(torch, got, want, f"8B quantised import layer {i}")
    rest = {k: v for k, v in params.items() if k != "layers"}
    want = quant.quantize_params(rest)
    n_q += _equal_trees(torch, {k: qimp[k] for k in rest}, want,
                        "8B quantised import (embedding, head, norm)")
    for k in ("ln_attn", "ln_mlp"):
        if not torch.equal(qimp["layers"][k], params["layers"][k]):
            raise AssertionError(f"8B quantised import: {k}")
    del qimp, want, rest
    torch.cuda.empty_cache()
    # Phase 5's traffic (serving_phase: rng 6, four prompts at once) on
    # the imported tree.
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (17, 100, 300, 700)]
    ecfg = eng_mod.EngineConfig(max_slots=8, max_seq_len=1024, page_size=64,
                                decode_chunk=8)
    eng = eng_mod.LLMEngine(imported, eng_mod.llama_paged_adapter(
        llama.LLAMA3_8B), ecfg, device="cuda")
    try:
        eng.submit(prompts[0][:5], max_new_tokens=2).result(timeout_s=600)
        reset_counts(kernels)
        streams = [eng.submit(p, max_new_tokens=HF_NEW) for p in prompts]
        outs = [s.result(timeout_s=600) for s in streams]
        launches = read_counts(kernels)
    finally:
        eng.shutdown()
    want = [o[:HF_NEW] for o in serving["outputs"]]
    if outs != want:
        raise AssertionError(f"8B HF import: streams {outs} != phase 5's "
                             f"{want}")
    missing = [n for n in ("paged_decode_attention_partial",
                           "paged_append", "flash_forward")
               if launches[n] == 0]
    if missing:
        raise AssertionError(f"8B HF import serving never launched "
                             f"{missing}")
    del imported
    torch.cuda.empty_cache()
    # A tiny f32 model as two hand-written shards and config.json.
    tcfg = dataclasses.replace(llama.LLAMA_TINY, dtype=torch.float32)
    tiny = llama.init_params(torch.Generator(device="cuda").manual_seed(16),
                             tcfg, device="cuda")
    tsd = hf_state_dict(tiny, tcfg)
    root = os.path.join(repo, "smoke_out", "hf_tiny")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    names = sorted(tsd)
    half = len(names) // 2
    shard_bytes = [write_safetensors(
        torch, os.path.join(root, f"model-0000{i + 1}-of-00002.safetensors"),
        {k: tsd[k] for k in part})
        for i, part in enumerate((names[:half], names[half:]))]
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(hf_config(tcfg), f)
    loaded, lcfg = thf.load_llama_from_hf(
        root, config_overrides={"dtype": torch.float32,
                                "param_dtype": torch.float32})
    n_tiny = _equal_trees(torch, loaded, tiny, "tiny safetensors import")
    shutil.rmtree(root, ignore_errors=True)
    res = {"config": "LLAMA3_8B bf16 (phase 5's weights)",
           "leaves_equal": n_leaves, "bytes": nbytes,
           "rewrite_s": rewrite_s, "import_s": import_s,
           "import_gb_per_s": nbytes / import_s / 1e9,
           "quantized_import_s": qimport_s, "quantized_leaves_equal": n_q,
           "streams": outs, "launches": launches,
           "tiny_safetensors": {"shards": shard_bytes, "leaves_equal": n_tiny},
           "card": card}
    log(f"8B HF import ({card}): {n_leaves} leaves bit-equal, "
        f"{nbytes / 1e9:.2f} GB in {import_s:.3f} s "
        f"({res['import_gb_per_s']:.1f} GB/s; the HF rewrite {rewrite_s:.3f}"
        f" s), quantize=True {qimport_s:.3f} s = quantize_params ({n_q} "
        f"leaves); phase 5's prompts on the imported tree: first {HF_NEW} "
        f"tokens equal, launches {launches}; tiny model via two hand-written"
        f" .safetensors shards ({shard_bytes} bytes): {n_tiny} leaves equal")
    return res


# --------------------------------------------------------------------------
# RLlib (phase 18): GRPO at LLAMA3_1B through K9f, K10 and K11 at head_dim
# 64; PPO, PG, A2C and DQN on envs that live on the card
# --------------------------------------------------------------------------

GRPO_PROMPTS, GRPO_GROUP, GRPO_P, GRPO_N = 4, 8, 192, 64   # B 32, S 256
GRPO_B = GRPO_PROMPTS * GRPO_GROUP
# f32 on both devices (TF32 off): the flash kernels' FMA tiles and the
# CPU's einsum attention, cuBLAS and the CPU's matmuls sum in other
# orders; Adam's normalised steps carry those differences into the params
# at up to a few ulps of the step size.
RL_PARAM_TOL = 1e-4


def _grpo_flash_launches(L, N, E, remat):
    """K9f, K10, K11 launches of one GRPO iteration: a no-grad forward a
    sampled token and one for the reference logps, then a forward a
    layer an epoch (twice under "dots" remat: the backward recomputes
    it) with one K10 and one K11."""
    return {K9F: L * (N + 1 + E * (2 if remat else 1)), K10: L * E,
            K11: L * E}


def _max_diff(torch, a, b) -> float:
    if isinstance(a, dict):
        return max(_max_diff(torch, a[k], b[k]) for k in a)
    if isinstance(a, list):
        return max(_max_diff(torch, x, y) for x, y in zip(a, b))
    return (a.detach().float().cpu() - b.detach().float().cpu()
            ).abs().max().item()


def rl_parity_phase(torch, llama, rl, kernels):
    """Cuda-vs-cpu: a small f32 GRPO policy at S 256 (head_dim 64, "dots"
    remat: K9f, K10 and K11 on the card, the einsum path on the CPU) from
    the same weights — the same sampled tokens, then one iteration, params
    within RL_PARAM_TOL; and one PPO iteration on CartPole (32 envs, 128
    steps) from the same seed: the same episode ends, params within
    RL_PARAM_TOL.  Then DQN's CUDA-graph steps against the same steps run
    eagerly on the card: equal params and returns."""
    mcfg = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=2,
                             n_kv_heads=1, mlp_dim=256, max_seq_len=256,
                             dtype=torch.float32, param_dtype=torch.float32)
    P, N, E = 248, 8, 2

    def grpo(device):
        cfg = rl.GRPOConfig()
        cfg.model, cfg.prompt_len, cfg.max_new_tokens = mcfg, P, N
        cfg.num_prompts, cfg.group_size, cfg.num_epochs = 2, 4, E
        cfg.reward_fn = lambda p, c: (c < 256).float().mean(-1)
        cfg.lr, cfg.seed, cfg.device = 1e-3, 3, device
        return rl.GRPO(config=cfg)

    algos = {"cpu": grpo("cpu")}
    algos["cuda"] = grpo("cuda")
    algos["cuda"].set_state(algos["cpu"].get_state())
    prompts = torch.randint(0, 512, (3, P), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(4))
    toks, metrics = {}, {}
    for dev, algo in algos.items():
        toks[dev] = algo.sample(prompts, seed=9).cpu()
        if dev == "cuda":
            torch.cuda.synchronize()
            reset_counts(kernels)
        metrics[dev] = algo.train()
        if dev == "cuda":
            torch.cuda.synchronize()
            counts = read_counts(kernels)
    if not torch.equal(toks["cuda"], toks["cpu"]):
        raise AssertionError(f"GRPO parity: sampled tokens differ: "
                             f"{toks['cuda']} vs {toks['cpu']}")
    want = _grpo_flash_launches(mcfg.n_layers, N, E, True)
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"GRPO parity: launches {got}, want {want}")
    p_diff = _max_diff(torch, algos["cuda"].params, algos["cpu"].params)
    m_diff = {k: abs(metrics["cuda"][k] - metrics["cpu"][k])
              for k in ("reward_mean", "loss", "kl", "ratio_mean")}
    if p_diff > RL_PARAM_TOL or m_diff["reward_mean"] != 0:
        raise AssertionError(f"GRPO parity: params {p_diff}, metrics "
                             f"{m_diff}")
    log(f"GRPO parity (f32, S {P + N}, 2 layers, head_dim 64, 8 rows): "
        f"sampled tokens equal, after one iteration params within "
        f"{p_diff:.3e}, metrics {m_diff}; launches {got}")
    out = {"grpo": {"launches": got, "param_max_diff": p_diff,
                    "metric_diffs": m_diff, "metrics": metrics}}
    ppo, rolls = {}, {}
    for dev in ("cpu", "cuda"):
        ppo[dev] = (rl.PPOConfig().training(num_envs=32, rollout_length=128)
                    .debugging(seed=0).resources(device=dev).build())
    ppo["cuda"].set_state(ppo["cpu"].get_state())
    for dev, algo in ppo.items():
        rolls[dev] = algo._iteration(algo._draws())
    p_diff = _max_diff(torch, ppo["cuda"].params, ppo["cpu"].params)
    obs_diff = _max_diff(torch, rolls["cuda"][2], rolls["cpu"][2])
    ep = {dev: (r[4].cpu(), r[3].cpu()) for dev, r in rolls.items()}
    if p_diff > RL_PARAM_TOL or not torch.equal(ep["cuda"][0], ep["cpu"][0]):
        raise AssertionError(f"PPO parity: params {p_diff}, episode "
                             f"lengths {ep}")
    log(f"PPO parity (CartPole, 32 envs x 128 steps, 4 x 4 minibatch "
        f"steps): episode lengths equal, params within {p_diff:.3e}, final "
        f"obs within {obs_diff:.3e}")
    out["ppo"] = {"param_max_diff": p_diff, "obs_max_diff": obs_diff}
    # DQN's steps as CUDA graphs against the same steps run eagerly on the
    # card: the same kernels on the same draws, so the same bits.
    dqn = {}
    for mode in ("graphs", "eager"):
        algo = (rl.DQNConfig().training(num_envs=8, steps_per_iteration=256,
                                        learning_starts=512)
                .debugging(seed=0).build())
        if mode == "eager":
            algo._graphs = None
        dqn[mode] = (algo, [algo.train() for _ in range(3)])
    updates = dqn["graphs"][0].opt_state["count"]
    p_diff = _max_diff(torch, dqn["graphs"][0].params,
                       dqn["eager"][0].params)
    rets = {m: [r["episode_return_mean"] for r in v[1]]
            for m, v in dqn.items()}
    if p_diff != 0 or rets["graphs"] != rets["eager"]:
        raise AssertionError(f"DQN graphs vs eager: params {p_diff}, "
                             f"returns {rets}")
    log(f"DQN on the card, steps as CUDA graphs vs eager (3 x 256 steps of "
        f"8 envs, {updates} updates): params equal, returns "
        f"{rets['graphs']}")
    out["dqn_graphs"] = {"param_max_diff": p_diff, "returns": rets,
                         "updates": updates}
    return out


def grpo_1b_phase(torch, llama, rl, kernels, card):
    """GRPO at LLAMA3_1B's full width and depth (f32 master weights, bf16
    compute, "dots" remat; weights from a seeded generator): 4 prompts x
    a group of 8, prompts of 192 and 64 new tokens (S 256: K9f, K10 and
    K11 at head_dim 64, a GQA group of 4), 2 epochs, the reward the share
    of completion tokens below vocab / 2; 2 iterations, each with its
    launches counted from 0 (exactly ``_grpo_flash_launches``: no SDPA or
    plain fallback)."""
    mcfg = llama.LLAMA3_1B
    cfg = rl.GRPOConfig()
    cfg.model = mcfg
    cfg.num_prompts, cfg.group_size = GRPO_PROMPTS, GRPO_GROUP
    cfg.prompt_len, cfg.max_new_tokens, cfg.num_epochs = GRPO_P, GRPO_N, 2
    half = mcfg.vocab_size // 2
    cfg.reward_fn = lambda p, c: (c < half).float().mean(-1)
    cfg.seed = 18
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algo = rl.GRPO(config=cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(algo.params))
    if n_params != mcfg.num_params():
        raise AssertionError(f"GRPO 1B: {n_params} params, config says "
                             f"{mcfg.num_params()}")
    want = _grpo_flash_launches(mcfg.n_layers, GRPO_N, cfg.num_epochs,
                                mcfg.remat)
    S = GRPO_P + GRPO_N
    iters = []
    for i in range(2):
        reset_counts(kernels)
        m = algo.train()
        torch.cuda.synchronize()
        counts = read_counts(kernels)
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"GRPO 1B iteration {i}: launches {got}, "
                                 f"want {want}")
        train_s = m["time_this_iter_s"] - m["sample_s"]
        row = {"s": m["time_this_iter_s"], "sample_s": m["sample_s"],
               "generated_tokens_per_s": GRPO_B * GRPO_N / m["sample_s"],
               "trained_tokens_per_s": GRPO_B * S * cfg.num_epochs / train_s,
               "reward_mean": m["reward_mean"], "loss": m["loss"],
               "kl": m["kl"], "ratio_mean": m["ratio_mean"],
               "logp_gap": m["logp_gap"], "launches": got}
        iters.append(row)
        log(f"GRPO 1B iteration {i}: {row['s']:.3f} s (sampling "
            f"{row['sample_s']:.3f} s, {row['generated_tokens_per_s']:.1f} "
            f"generated tokens/s; {row['trained_tokens_per_s']:.0f} trained "
            f"tokens/s), reward {row['reward_mean']:.4f}, loss "
            f"{row['loss']:.5f}, kl {row['kl']:.3e}, first epoch's ratio "
            f"{row['ratio_mean']:.6f}, max |sampled - recomputed logp| "
            f"{row['logp_gap']:.4f}; launches {got}")
        vals = (row["reward_mean"], row["loss"], row["kl"], row["logp_gap"])
        if not all(math.isfinite(v) for v in vals) or row["kl"] < 0:
            raise AssertionError(f"GRPO 1B iteration {i}: {row}")
        if abs(row["ratio_mean"] - 1) > 1e-2:
            raise AssertionError(f"GRPO 1B iteration {i}: first epoch's "
                                 f"ratio_mean {row['ratio_mean']}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"GRPO LLAMA3_1B ({n_params:,} params, {GRPO_B} rows x S {S}): init "
        f"{init_s:.2f} s, peak {peak:.2f} GB on {card}")
    # One sampling step's kernels (a full-buffer forward, the head on one
    # position) beside its share of the sampling wall time.
    buf = torch.randint(0, mcfg.vocab_size, (GRPO_B, S), device="cuda",
                        generator=torch.Generator("cuda").manual_seed(5))
    with torch.no_grad():
        step = _step_breakdown(torch, lambda: rl.algorithms.grpo._logits_at(
            algo.params, buf, mcfg, GRPO_P - 1, GRPO_P))
    d, m, hd = mcfg.dim, mcfg.mlp_dim, mcfg.head_dim
    layer = (2 * d * mcfg.n_heads * hd + 2 * d * mcfg.n_kv_heads * hd
             + 3 * d * m)
    step_flops = 2 * GRPO_B * S * layer * mcfg.n_layers
    wall_ms = 1e3 * statistics.mean(r["sample_s"] for r in iters) / GRPO_N
    if "error" not in step:
        step.update(wall_ms=wall_ms,
                    idle_share=1 - step["kernel_ms_total"] / wall_ms,
                    gemm_tflops=step_flops / (step["gemm_ms"] * 1e-3) / 1e12)
        log(f"  one sampling step: {wall_ms:.2f} ms of wall, kernels "
            f"{step['kernel_ms_total']:.2f} ms (products {step['gemm_ms']:.2f}"
            f" ms at {step['gemm_tflops']:.0f} TFLOP/s, flash "
            f"{sum(step['flash_ms'].values()):.3f}, other "
            f"{step['other_ms']:.2f}), idle {step['idle_share']:.3f}")
    out = {"params": n_params, "rows": GRPO_B, "seq": S, "init_s": init_s,
           "peak_gb": peak, "iterations": iters, "sampling_step": step,
           "launches": {k: sum(r["launches"][k] for r in iters)
                        for k in want}}
    del algo
    torch.cuda.empty_cache()
    return out


def rl_learning_phase(torch, llama, rl):
    """Learning on the card with the JAX tests' settings and gates
    (tests/test_rllib.py:143-161, :188-205; tests/test_grpo.py:15-52):
    PPO on CartPole (32 envs, 128 steps, 15 iterations: return > 100),
    DQN on CartPole (10 iterations: return > 60), GRPO on a tiny Llama
    (31 iterations: the reward past max(4/32, 2 x the first)); then PPO at
    1,024 envs, its env steps/s."""
    out = {}
    t0 = time.perf_counter()
    algo = (rl.PPOConfig().environment("CartPole-v1")
            .training(num_envs=32, rollout_length=128, lr=3e-4,
                      entropy_coeff=0.01).debugging(seed=0).build())
    for _ in range(15):
        r = algo.train()
    out["ppo"] = {"return": r["episode_return_mean"],
                  "timesteps": r["timesteps_total"],
                  "s": time.perf_counter() - t0}
    if not (r["timesteps_total"] == 15 * 32 * 128
            and r["episode_return_mean"] > 100):
        raise AssertionError(f"PPO on the card did not learn: {r}")
    t0 = time.perf_counter()
    algo = (rl.DQNConfig().environment("CartPole-v1")
            .training(num_envs=8, steps_per_iteration=2048,
                      learning_starts=500, epsilon_decay_steps=20_000,
                      lr=1e-3).debugging(seed=0).build())
    for _ in range(10):
        r = algo.train()
    out["dqn"] = {"return": r["episode_return_mean"],
                  "buffer_size": r["buffer_size"],
                  "s": time.perf_counter() - t0}
    if not (r["buffer_size"] > 0 and r["episode_return_mean"] > 60):
        raise AssertionError(f"DQN on the card did not learn: {r}")
    t0 = time.perf_counter()
    cfg = rl.GRPOConfig()
    cfg.model = dataclasses.replace(
        llama.LLAMA_TINY, vocab_size=32, dim=32, n_layers=1, n_heads=2,
        n_kv_heads=2, mlp_dim=64, max_seq_len=32)
    cfg.reward_fn = lambda p, c: (c == 7).float().mean(-1)
    cfg.prompt_len, cfg.max_new_tokens = 4, 8
    cfg.lr, cfg.kl_coef, cfg.seed = 5e-3, 0.001, 0
    algo = rl.GRPO(config=cfg)
    first = algo.train()
    for _ in range(30):
        last = algo.train()
    gate = max(4 / 32, 2 * first["reward_mean"] + 1e-9)
    out["grpo_tiny"] = {"first": first["reward_mean"],
                        "last": last["reward_mean"], "gate": gate,
                        "kl": last["kl"], "s": time.perf_counter() - t0}
    if not (last["reward_mean"] > gate and last["kl"] >= 0):
        raise AssertionError(f"GRPO on the card did not learn: {first}, "
                             f"{last}")
    algo = (rl.PPOConfig().training(num_envs=1024, rollout_length=128)
            .debugging(seed=0).build())
    times = [algo.train()["time_this_iter_s"] for _ in range(3)]
    steps_per_s = [1024 * 128 / t for t in times]
    out["ppo_1024"] = {"iteration_s": times, "env_steps_per_s": steps_per_s}
    log(f"RL learning on the card: PPO CartPole return "
        f"{out['ppo']['return']:.1f} (gate 100) in {out['ppo']['s']:.1f} s; "
        f"DQN return {out['dqn']['return']:.1f} (gate 60) in "
        f"{out['dqn']['s']:.1f} s; GRPO tiny reward {out['grpo_tiny']['first']:.4f} "
        f"-> {out['grpo_tiny']['last']:.4f} (gate {gate:.4f}) in "
        f"{out['grpo_tiny']['s']:.1f} s; PPO at 1,024 envs: iterations "
        f"{[round(t, 3) for t in times]} s, "
        f"{[round(x) for x in steps_per_s]} env steps/s")
    return out


# --------------------------------------------------------------------------
# Phase 20: RLlib's continuous-control, offline and multi-agent algorithms
# --------------------------------------------------------------------------

# The CPU tests' sizes (tests/test_torch_sac_td3.py, test_torch_offline.py,
# test_torch_multi_agent.py).
RL20_OFF_POLICY = dict(num_envs=4, steps_per_iteration=6, learning_starts=12,
                       train_batch_size=8, buffer_capacity=16, hidden=(16,))
RL20_OFFLINE = dict(updates_per_iteration=4, train_batch_size=8,
                    hidden=(16,))
RL20_ITERS = 3     # the steps' graphs are captured in the first iteration
SMOKE_DIR = os.path.dirname(os.path.abspath(__file__))
# The JAX tests' Pendulum start states, as the [0, 1) draws the port's
# ``Pendulum.reset`` takes: their ``jax.random.key(seed)`` split chain, one
# (theta, theta_dot) pair a reset, for ``OfflineDataset.collect(seed=3)``
# (the datasets) and ``_rollout_return(seed=11)`` (the gates' rollouts).
# The port draws from a torch generator; these make its runs start where
# the JAX tests' do.  tests/test_torch_offline.py holds them to JAX.
RL20_JAX_RESETS = {
    3: (
        (0.10229838, 0.29604137), (0.04610789, 0.3541882),
        (0.43714142, 0.14291632), (0.8752407, 0.09012854),
        (0.5046551, 0.4205383), (0.27924812, 0.43506002),
        (0.3751278, 0.9308262), (0.109255075, 0.58848),
        (0.5227624, 0.27690923), (0.44899607, 0.69741833),
        (0.6520891, 0.8387649), (0.27342165, 0.38740945),
        (0.46809077, 0.10998571), (0.79461133, 0.66969466),
        (0.80854523, 0.84088576), (0.6223216, 0.6816188),
        (0.9004042, 0.45049393), (0.3686471, 0.51707923),
        (0.44829237, 0.16355026), (0.4701984, 0.40414798),
        (0.5434346, 0.6125823), (0.933691, 0.101795554),
    ),
    11: (
        (0.93330884, 0.2339338), (0.9200758, 0.4386847),
        (0.7804358, 0.52803004),
    ),
}


def _rl20_dataset(np, rl, rows=40):
    """The offline tests' small dataset: episodes of 8 rows, every other
    one cut by the time limit, the log's tail cut mid-episode."""
    rng = np.random.default_rng(0)
    done = np.zeros(rows, np.float32)
    done[7::8] = 1.0
    trunc = np.zeros(rows, np.float32)
    trunc[15::16] = 1.0
    return rl.OfflineDataset(
        obs=rng.normal(size=(rows, 3)).astype(np.float32),
        action=rng.uniform(-2, 2, (rows, 1)).astype(np.float32),
        reward=rng.uniform(-9, 0, rows).astype(np.float32),
        next_obs=rng.normal(size=(rows, 3)).astype(np.float32),
        done=done, truncated=trunc)


def _rl20_build(rl, name, device, dataset):
    if name in ("SAC", "TD3", "DDPG"):
        cfg = getattr(rl, name + "Config")().training(**RL20_OFF_POLICY)
    elif name == "MultiAgentPPO":
        cfg = rl.MultiAgentPPOConfig().training(
            num_epochs=2, num_minibatches=2, hidden=(16,)).env_runners(
            num_envs=4, rollout_length=4)
    else:
        cfg = getattr(rl, name + "Config")().training(**RL20_OFFLINE)
        cfg.dataset = dataset
    return cfg.debugging(seed=0).resources(device=device).build()


def _rl20_metric_diff(a, b) -> float:
    """The largest metric gap, relative above 1 (NaN equal to NaN)."""
    gaps = [0.0]
    for k, v in b.items():
        if k == "time_this_iter_s" or not isinstance(v, float):
            continue
        if math.isnan(v) and math.isnan(a[k]):
            continue
        gaps.append(abs(a[k] - v) / max(1.0, abs(v)))
    return max(gaps)


def rl20_parity_phase(torch, np, rl):
    """Each new algorithm at the CPU tests' sizes from seed 0 (the same
    CPU-drawn randomness): on the CPU, on the card with its steps as CUDA
    graphs (SAC, TD3, DDPG, CQL) and on the card eagerly, RL20_ITERS
    iterations each.  Card vs CPU: params, targets and metrics within
    RL_PARAM_TOL; graphs vs eager on the card: equal."""
    data = _rl20_dataset(np, rl)
    out = {}
    for name in ("SAC", "TD3", "DDPG", "BC", "CQL", "MARWIL",
                 "MultiAgentPPO"):
        algos, metrics = {}, {}
        for mode, dev in (("cpu", "cpu"), ("cuda", "cuda"),
                          ("eager", "cuda")):
            algo = _rl20_build(rl, name, dev, data)
            if mode == "eager":
                if getattr(algo, "_graphs", None) is None:
                    continue  # no graphs to hold against
                algo._graphs = None
            metrics[mode] = [algo.train() for _ in range(RL20_ITERS)]
            algos[mode] = algo
        torch.cuda.synchronize()
        trees = [k for k in ("params", "target_q", "target")
                 if hasattr(algos["cpu"], k)]
        p_diff = max(_max_diff(torch, getattr(algos["cuda"], k),
                               getattr(algos["cpu"], k)) for k in trees)
        m_diff = max(_rl20_metric_diff(a, b) for a, b in
                     zip(metrics["cuda"], metrics["cpu"]))
        row = {"param_max_diff": p_diff, "metric_max_diff": m_diff,
               "graphs": "eager" in algos}
        if "eager" in algos:
            row["graph_vs_eager_max_diff"] = max(
                _max_diff(torch, getattr(algos["cuda"], k),
                          getattr(algos["eager"], k)) for k in trees)
            row["graph_vs_eager_metric_diff"] = max(
                _rl20_metric_diff(a, b) for a, b in
                zip(metrics["cuda"], metrics["eager"]))
            row["graphs_captured"] = sorted(
                k for k, v in algos["cuda"]._graphs.items()
                if isinstance(v, torch.cuda.CUDAGraph))
        out[name] = row
        log(f"RL parity {name}: card vs CPU params within {p_diff:.3e}, "
            f"metrics within {m_diff:.3e}"
            + (f"; graphs {row['graphs_captured']} vs eager on the card: "
               f"params {row['graph_vs_eager_max_diff']:.3e}, metrics "
               f"{row['graph_vs_eager_metric_diff']:.3e}"
               if row["graphs"] else ""))
        if p_diff > RL_PARAM_TOL or m_diff > RL_PARAM_TOL or (
                row["graphs"] and (row["graph_vs_eager_max_diff"] != 0
                                   or row["graph_vs_eager_metric_diff"] != 0
                                   or not row["graphs_captured"])):
            raise AssertionError(f"RL parity {name}: {row}")
    return out


def _rl20_rollout_return(torch, np, env, act_fn):
    """The JAX tests' ``_rollout_return(env, act_fn, seed=11,
    episodes=3)`` on the port's env (on the CPU): the mean return of
    three episodes from the JAX tests' start states."""
    starts = RL20_JAX_RESETS[11]
    total = 0.0
    for start in starts:
        state, obs = env.reset(torch.tensor([start]))
        done = False
        while not done:
            a = np.array(act_fn(obs[0].numpy()), np.float32)
            state, obs, r, d = env.step(state, torch.from_numpy(a)[None])
            total += float(r[0])
            done = bool(d[0])
    return total / len(starts)


def _rl20_gate(out, name, t0, torch, value, gate, passed, **extra):
    torch.cuda.synchronize()
    row = {"s": time.perf_counter() - t0, "value": value, "gate": gate,
           "passed": bool(passed), **extra}
    out[name] = row
    rate = ", ".join(f"{k} {v:.1f}" for k, v in extra.items()
                     if k.endswith("_per_s"))
    log(f"RL learning {name}: {value:.2f} (gate {gate}) in {row['s']:.2f} s"
        f"{', ' + rate if rate else ''}")
    if not passed:
        raise AssertionError(f"{name} on the card did not learn: {row}")


def rl20_learning_phase(torch, np, rl, card):
    """Learning on the card at the JAX tests' settings and gates, seed 0:
    SAC (20 iterations: return > -900, alpha > 0; tests/test_rllib_sac_ma
    .py:20-39), TD3 (40 iterations at 4 envs: the last 5's mean > -400;
    tests/test_rllib_breadth.py:64-77), DDPG (25: > -800;
    tests/test_rllib_breadth2.py:38-51); the offline datasets, logged by
    the seed-0 SAC after 18 iterations (4,000 steps, test_rllib_offline.py
    :21-40) and after 15 (3,000 steps, test_rllib_breadth2.py:103-119),
    its deterministic action plus σ 0.35 noise, seed 3, from the JAX
    tests' start states (RL20_JAX_RESETS), checked as
    test_rllib_offline.py:56-65 checks it; then, on the JAX tests' own
    datasets (scripts/data), BC (26 iterations:
    last loss < 0.5 x first, rollout return > -700), CQL (cql_alpha 0.5,
    30: return > -700), MARWIL (beta 1, 12: return > random + 500);
    MultiAgentPPO (16 envs x 64 steps, 12: return > first + 15, each agent
    > first; tests/test_rllib_sac_ma.py:72-93).  The offline gates'
    rollouts start where the JAX tests' do."""
    out, t_all = {}, time.perf_counter()
    pend = rl.Pendulum()

    def off_policy(cfg, iters, snapshots=()):
        algo = cfg.debugging(seed=0).build()
        rets, snaps = [], {}
        for i in range(iters):
            r = algo.train()
            rets.append(r["episode_return_mean"])
            if i + 1 in snapshots:
                snap = type(cfg)().debugging(seed=0).build()
                snap.set_state(algo.get_state())
                snaps[i + 1] = snap
        return algo, r, rets, snaps

    t0 = time.perf_counter()
    sac, r, _, snaps = off_policy(
        rl.SACConfig().environment("Pendulum-v1").training(
            steps_per_iteration=256, train_batch_size=128,
            learning_starts=500), 20, snapshots=(15, 18))
    a = sac.compute_single_action(np.zeros(3, np.float32))
    steps = 20 * 256 * 8
    _rl20_gate(out, "SAC", t0, torch, r["episode_return_mean"], -900,
               r["episode_return_mean"] > -900 and r["alpha"] > 0
               and a.shape == (1,) and abs(float(a[0])) <= 2.0 + 1e-5,
               alpha=r["alpha"], updates=sac.opt_state["count"],
               env_steps_per_s=steps / (time.perf_counter() - t0))
    for name, iters, gate in (("TD3", 40, -400), ("DDPG", 25, -800)):
        t0 = time.perf_counter()
        algo, _, rets, _ = off_policy(
            getattr(rl, name + "Config")().environment("Pendulum-v1")
            .training(num_envs=4, steps_per_iteration=256,
                      learning_starts=500, train_batch_size=128), iters)
        achieved = float(np.nanmean(rets[-5:]))
        _rl20_gate(out, name, t0, torch, achieved, gate, achieved > gate,
                   updates=algo.opt_state[1]["count"],
                   actor_updates=algo.opt_state[0]["count"],
                   env_steps_per_s=iters * 256 * 4
                   / (time.perf_counter() - t0))

    def behavior(policy):
        def act(obs, rng):
            a = policy.compute_single_action(obs)
            return np.clip(a + rng.normal(0, 0.35, a.shape), -2.0, 2.0
                           ).astype(np.float32)
        return act

    t0 = time.perf_counter()
    logged = {n: rl.OfflineDataset.collect(
        pend, behavior(snaps[it]), num_steps=n, seed=3,
        reset_draws=np.array(RL20_JAX_RESETS[3], np.float32)[:, None])
        for it, n in ((18, 4000), (15, 3000))}
    ds = logged[4000]
    path = os.path.join(SMOKE_DIR, "smoke_out", "pendulum_4000.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    ds.save(path)
    back = rl.OfflineDataset.load(path)
    if not (len(ds) == 4000 and ds.obs.shape == (4000, 3)
            and ds.action.shape == (4000, 1) and ds.done.sum() >= 19
            and np.array_equal(back.obs, ds.obs)
            and np.array_equal(back.truncated, ds.truncated)):
        raise AssertionError(f"offline dataset: {len(ds)} rows, "
                             f"{ds.done.sum()} episode ends")
    # The learners' gates run on the JAX tests' own datasets, logged by
    # the JAX package (scripts/make_offline_fixtures.py): the port cannot
    # make JAX's draws, and those gates swing with the data (PERF.md §6,
    # scripts/offline_gate_sweep.py).
    data = {n: rl.OfflineDataset.load(os.path.join(
        SMOKE_DIR, "scripts", "data", f"pendulum_sac{it}_{n}.npz"))
        for it, n in ((18, 4000), (15, 3000))}
    out["datasets"] = {"s": time.perf_counter() - t0,
                       "logged_mean_reward": {
                           n: float(d.reward.mean())
                           for n, d in logged.items()},
                       "jax_mean_reward": {n: float(d.reward.mean())
                                           for n, d in data.items()}}
    log(f"RL offline datasets: 4,000 and 3,000 steps logged on the card "
        f"in {out['datasets']['s']:.2f} s (mean rewards "
        f"{out['datasets']['logged_mean_reward']}; the JAX tests' "
        f"{out['datasets']['jax_mean_reward']})")
    ds = data[4000]

    def offline(name, dataset, iters, **kw):
        cfg = getattr(rl, name + "Config")().environment(
            "Pendulum-v1").training(**kw)
        cfg.dataset = dataset
        algo = cfg.debugging(seed=0).build()
        ms = [algo.train() for _ in range(iters)]
        return algo, ms

    t0 = time.perf_counter()
    bc, ms = offline("BC", ds, 26)
    first, last = ms[0]["bc_loss"], ms[-1]["bc_loss"]
    ret = _rl20_rollout_return(torch, np, pend, bc.compute_single_action)
    _rl20_gate(out, "BC", t0, torch, ret, -700,
               last < 0.5 * first and ret > -700, first_loss=first,
               last_loss=last, updates_per_s=26 * 64
               / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    cql, ms = offline("CQL", ds, 30, cql_alpha=0.5)
    ret = _rl20_rollout_return(torch, np, pend, cql.compute_single_action)
    _rl20_gate(out, "CQL", t0, torch, ret, -700,
               ret > -700 and math.isfinite(ms[-1]["bellman"])
               and math.isfinite(ms[-1]["cql_penalty"]),
               bellman=ms[-1]["bellman"], cql_penalty=ms[-1]["cql_penalty"],
               updates_per_s=30 * 64 / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    marwil, ms = offline("MARWIL", data[3000], 12, updates_per_iteration=64,
                         train_batch_size=256, beta=1.0)
    rng = np.random.default_rng(5)
    rand_ret = _rl20_rollout_return(
        torch, np, pend,
        lambda o: rng.uniform(-2.0, 2.0, (1,)).astype(np.float32))
    ret = _rl20_rollout_return(torch, np, pend, marwil.compute_single_action)
    a = marwil.compute_single_action(np.zeros(3, np.float32))
    _, ms0 = offline("MARWIL", data[3000], 1, beta=0.0)
    _rl20_gate(out, "MARWIL", t0, torch, ret, rand_ret + 500.0,
               ret > rand_ret + 500.0 and math.isfinite(ms[-1]["total_loss"])
               and math.isfinite(ms[-1]["vf_loss"]) and a.shape == (1,)
               and bool(np.all(np.abs(a) <= 2.0))
               and math.isfinite(ms0[-1]["weighted_clone_loss"]),
               random_return=rand_ret, updates_per_s=12 * 64
               / (time.perf_counter() - t0))
    t0 = time.perf_counter()
    ma = (rl.MultiAgentPPOConfig().env_runners(num_envs=16, rollout_length=64)
          .debugging(seed=0).build())
    first = None
    for _ in range(12):
        r = ma.train()
        m = r["episode_return_mean"]
        if first is None and m == m:
            first = m
    from ray_tpu_torch.train.state import tree_leaves
    leaves = tree_leaves(ma.params)
    agents = [r[f"episode_return_mean/agent_{i}"] for i in range(2)]
    _rl20_gate(out, "MultiAgentPPO", t0, torch, r["episode_return_mean"],
               first + 15,
               r["episode_return_mean"] > first + 15
               and all(x > first for x in agents)
               and all(x.shape[0] == 2 for x in leaves)
               and not torch.equal(leaves[0][0], leaves[0][1]),
               first=first, agents=agents,
               env_steps_per_s=12 * 64 * 16 / (time.perf_counter() - t0))
    out["total_s"] = time.perf_counter() - t_all
    log(f"RL learning, phase 20: every gate passed in {out['total_s']:.1f} s "
        f"on {card}")
    return out


def grpo_kernel_rows(report, runs):
    """The kernels line's rows of K9f, K10 and K11 at GRPO's shape (their
    ``grpo`` entries), launches from the GRPO 1B run."""
    rows = {}
    for key, name in (("K9f", K9F), ("K10", K10), ("K11", K11)):
        sub = report[key]["grpo"]
        rows[key + " grpo"] = {
            "name": f"{name} (GRPO at LLAMA3_1B: B {GRPO_B} S "
                    f"{GRPO_P + GRPO_N} H 32 KVH 8 D 64)",
            **{k: report[key][k] for k in ("route", "source", "replaces")},
            **{k: sub[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "kernel_ms": sub["ms"], "launches": runs["launches"][name]}
    return rows


# --------------------------------------------------------------------------
# Phase 19: data-parallel training over torch.distributed
# --------------------------------------------------------------------------

EIGHT_B_ACCUM = 4                 # bench.py:1287: grad_accum on one card
EIGHT_B_B = EIGHT_B_ACCUM * 1     # bench.py:1288: batch = grad_accum x chips
ZERO_PARITY_TOL = 1e-4            # train parity's: flash kernels vs einsum


def collectives_phase(torch, tcoll, tmesh):
    """Every function of ``parallel/collectives.py`` on CUDA tensors over
    the NCCL process group of world size 1 (a dp=1 mesh, every axis the
    default group: each call goes through NCCL), each against what one
    member gets, and the quantized all-reduce against its formula on the
    same inputs."""
    import torch.distributed as dist

    mesh = tmesh.create_mesh(tmesh.MeshSpec(dp=1))
    if not (mesh.distributed and dist.get_backend() == "nccl"
            and mesh.group("dp") is dist.group.WORLD):
        raise AssertionError(f"collectives: mesh {mesh} on "
                             f"{dist.get_backend()}")
    g = torch.Generator(device="cuda").manual_seed(71)
    x = torch.randn((64, 48), generator=g, device="cuda")
    axis = ("dp", "fsdp")
    same = {
        "allreduce": tcoll.allreduce(x, axis, mesh=mesh),
        "allreduce_max": tcoll.allreduce(x, "dp", "max", mesh=mesh),
        "allreduce_min": tcoll.allreduce(x, "fsdp", "min", mesh=mesh),
        "allreduce_mean": tcoll.allreduce(x, axis, "mean", mesh=mesh),
        "allgather": tcoll.allgather(x, axis, mesh=mesh, tiled_axis=1),
        "reducescatter": tcoll.reducescatter(x, "dp", mesh=mesh),
        "broadcast": tcoll.broadcast(x, axis, 0, mesh=mesh),
        "all_to_all": tcoll.all_to_all(x, "dp", mesh=mesh, split_axis=0,
                                       concat_axis=1),
        "permute": tcoll.permute(x, axis, [(0, 0)], mesh=mesh),
        "shift": tcoll.shift(x, "dp", mesh=mesh),
        "send_recv": tcoll.send_recv(x, "dp", 0, 0, mesh=mesh),
        "dcn_allreduce_exact": tcoll.dcn_allreduce(x, "dp", mesh=mesh,
                                                   quantized=False),
        "group_allreduce": tcoll.init_collective_group(
            mesh, "dp", "smoke").allreduce(x),
    }
    tcoll.destroy_collective_group("smoke")
    bad = [k for k, v in same.items() if not torch.equal(v, x)]
    if bad or tcoll.axis_index(axis, mesh=mesh) != 0 \
            or tcoll.axis_size(axis, mesh=mesh) != 1:
        raise AssertionError(f"collectives at world size 1: {bad} differ")
    # The quantized all-reduce against its formula: one member's payload
    # quantised per chunk of 256 (scale = max(absmax / 127, 1e-8)) and
    # dequantised.
    q = tcoll.quantized_allreduce(x, axis, mesh=mesh)
    dq = tcoll.dcn_allreduce(x, "dp", mesh=mesh)
    flat = x.reshape(-1, 256)
    scale = (flat.abs().amax(1, keepdim=True)
             / torch.full((1,), 127.0, device="cuda")).clamp_min(1e-8)
    want = (torch.round(flat / scale).clamp(-127, 127) * scale
            ).reshape(x.shape)
    err = (q - want).abs().max().item()
    if not (torch.equal(q, want) and torch.equal(dq, want)):
        raise AssertionError(f"quantized all-reduce: {err} from its formula")
    quant_err = (q - x).abs().max().item()
    bytes_q = tcoll.allreduce_wire_bytes(x.numel(), axis_size=4,
                                         quantized=True)
    log(f"collectives (NCCL, world size 1, {len(same) + 4} calls): every "
        f"result equals its member's; quantized all-reduce equals its "
        f"formula (max |q - x| {quant_err:.3e}, {bytes_q} wire bytes a "
        f"member at 4 members)")
    return {"backend": dist.get_backend(), "checked": sorted(same)
            + ["axis_index", "axis_size", "quantized_allreduce",
               "dcn_allreduce"], "quant_max_abs_vs_input": quant_err}


def _equal_tree(torch, a, b) -> bool:
    if isinstance(a, dict):
        return all(_equal_tree(torch, a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return all(_equal_tree(torch, x, y) for x, y in zip(a, b))
    return torch.equal(a, b) if torch.is_tensor(a) else a == b


def zero_parity_phase(torch, llama, train, kernels):
    """ZeRO at world size 1 on the card: a small f32 Llama (S 256, "dots"
    remat: K9f, K10, K11) trained 3 steps through ``TorchTrainer`` over
    the NCCL group with ``zero_sharding`` off and on, for fp32 AdamW and
    ``adamw8bit`` (``shard_update`` with ZeRO).  Both run the
    data-parallel step, whose all-reduces (the grads', the token
    count's, the loss's and the norm's) go through NCCL: the ZeRO runs
    equal the replicated runs and the single-device step
    (``compile_train_step`` without a layout) bit for bit (losses, grad
    norms, params, states), and the single-device step on the CPU (which
    the CPU tests hold equal to ZeRO over gloo bit for bit) agrees within
    ZERO_PARITY_TOL."""
    cfg = llama.LlamaConfig(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                            n_kv_heads=2, mlp_dim=256, max_seq_len=256,
                            dtype=torch.float32, param_dtype=torch.float32)
    base = llama.init_params(torch.Generator().manual_seed(15), cfg,
                             device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 2, 256),
                           generator=torch.Generator().manual_seed(16),
                           dtype=torch.int32)
    out = {}
    loss_fn = lambda p, b: llama.loss_fn(p, b, cfg)  # noqa: E731

    def make_tx(opt, zero):
        return (train.adamw8bit(1e-3, warmup_steps=1, shard_update=zero)
                if opt == "adamw8bit" else
                train.default_optimizer(1e-3, warmup_steps=1))

    def single_device(opt, dev):
        """The single-device step: no layout, no collective."""
        tx = make_tx(opt, False)
        state = train.create_train_state(_clone_to(torch, base, dev), tx)
        step = train.compile_train_step(loss_fn, tx)
        hist = []
        for t in tokens:
            state, m = step(state, {"tokens": t.to(dev)})
            hist.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        return hist, state

    for opt in ("adamw", "adamw8bit"):
        hp, sp = single_device(opt, "cuda")
        hc, _ = single_device(opt, "cpu")
        torch.cuda.synchronize()
        runs = {}
        for zero in (False, True):
            params = _clone_to(torch, base, "cuda")
            trainer = train.TorchTrainer(
                init_params=lambda g, p=params: p, loss_fn=loss_fn,
                params_axes=llama.logical_axes(cfg),
                batch_axes={"tokens": ("batch", None)},
                optimizer=make_tx(opt, zero),
                scaling_config=train.ScalingConfig(
                    mesh_spec=train.MeshSpec(dp=1), devices=["cuda"]),
                run_config=train.RunConfig(report_every=1),
                trainer_config=train.TrainerConfig(zero_sharding=zero))
            trainer.state
            if trainer._layout is None:
                raise AssertionError("ZeRO parity: the trainer over the "
                                     "process group built no layout")
            reset_counts(kernels)
            res = trainer.fit(({"tokens": t} for t in tokens), num_steps=3)
            if res.error is not None:
                raise res.error
            torch.cuda.synchronize()
            runs[zero] = (res.metrics_history, trainer, read_counts(kernels))
        (hb, tb, cb), (hz, tz, cz) = runs[False], runs[True]
        want = {K9F: 2 * 2 * 3, K10: 2 * 3, K11: 2 * 3}
        launches = {k: cz[k] for k in want}
        curve = [[(m["loss"], m["grad_norm"]) for m in h] for h in (hz, hb)]
        exact = (curve[0] == curve[1] and _equal_tree(torch, tz.state.params,
                                          tb.state.params)
                 and _equal_tree(torch, tz.state.opt_state,
                                 tb.state.opt_state))
        plain_exact = (
            [(m["loss"], m["grad_norm"]) for m in hp] == curve[0]
            and _equal_tree(torch, sp.params, tz.state.params)
            and _equal_tree(torch, sp.opt_state, tz.state.opt_state))
        worst = {key: max(abs(a[key] - b[key]) / abs(b[key])
                          for a, b in zip(hz, hc))
                 for key in ("loss", "grad_norm")}
        if not (exact and plain_exact) or launches != want \
                or {k: cb[k] for k in want} != want:
            raise AssertionError(f"ZeRO parity ({opt}): bit-equal {exact}, "
                                 f"to the single-device step {plain_exact},"
                                 f" launches {launches} (want {want})")
        if max(worst.values()) > ZERO_PARITY_TOL:
            raise AssertionError(f"ZeRO parity ({opt}): card vs cpu {worst}")
        out[opt] = {"bit_equal": exact,
                    "bit_equal_single_device_step": plain_exact,
                    "launches": launches,
                    "cuda_vs_cpu_worst_rel": worst,
                    "losses": [m["loss"] for m in hz],
                    "opt_state_bytes": tz.opt_state_bytes()}
        log(f"ZeRO parity ({opt}, NCCL world size 1, f32, S=256, 3 steps):"
            f" ZeRO = replicated = the single-device step bit for bit "
            f"(losses "
            f"{[round(m['loss'], 6) for m in hz]}, params and states); "
            f"card vs cpu worst relative loss {worst['loss']:.2e}, "
            f"grad_norm {worst['grad_norm']:.2e}; launches {launches}")
        del runs, tb, tz, sp
    torch.cuda.empty_cache()
    return out


def eight_b_cfg(llama, torch):
    """bench.py's full-8B AdamW rung (bench.py:1252-1256)."""
    return llama.LlamaConfig(
        vocab_size=128_256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        mlp_dim=14336, max_seq_len=TRAIN_S, param_dtype=torch.bfloat16,
        remat_policy="full", loss_chunk=512)


def eight_b_memory_plan(cfg, params_by_leaf) -> dict:
    """Bytes the rung needs on one card: bf16 params and the bf16 grad
    accumulator (2 B/param each), the int8 states (2 B/param and an f32
    scale a 256-block for each of m and sqrt(v)), a microbatch's grads of
    the stacked layers before they are added in (2 B/param of the layers,
    plus the largest leaf's, which autograd stacks from them), and 2 GiB
    of activations and transients; beside it bench.py's JAX plan (6.1
    B/param + 2 GiB, bench.py:1264-1279)."""
    n = cfg.num_params()
    layer = n - 2 * cfg.vocab_size * cfg.dim - cfg.dim
    biggest = max(params_by_leaf)
    parts = {"params": 2 * n, "grad_accumulator": 2 * n,
             "int8_states": 2 * n + 2 * 4 * -(-n // 256),
             "microbatch_layer_grads": 2 * layer + 2 * biggest,
             "activations_transients": 2 * 2 ** 30}
    return {"params": n, "parts": parts, "need": sum(parts.values()),
            "bench_plan": int(6.1 * n) + 2 * 2 ** 30}


def train_8b_phase(torch, llama, train, kernels, card):
    """bench.py's full-8B AdamW rung (``_measure_8b_train``,
    bench.py:1240-1320) through the port on one card: LLAMA3_8B at full
    width and depth (128k vocabulary, bf16 params, "full" remat, loss
    chunks of 512), ``adamw8bit(1e-4, warmup_steps=10,
    shard_update=True)``, ``TrainerConfig(zero_sharding=True,
    grad_accum=4)`` and ``MeshSpec(dp=1, fsdp=1)`` over the NCCL group of
    world size 1, batches of 4 x 2048 from a seeded generator: the memory
    plan against ``mem_get_info`` (fails with the math when short; the
    model is never cut), 2 warm-up and 3 timed steps with K9f 256 and
    K10/K11 128 launches a step (4 microbatches x 32 layers; K9f twice:
    forward and recompute), one step's kernels by family under the
    profiler, tokens/s, MFU, optimizer bytes a param, peak memory, 4
    alternating pairs of the data-parallel and the single-device step
    (each timed alone), and the loss on the first batch falling."""
    cfg = eight_b_cfg(llama, torch)
    n = cfg.num_params()
    L, d, m = cfg.n_layers, cfg.dim, cfg.mlp_dim
    plan = eight_b_memory_plan(cfg, [L * d * m, cfg.vocab_size * d])
    free, total = torch.cuda.mem_get_info()
    plan.update(free=free, total=total)
    math_line = (", ".join(f"{k} {v / 2 ** 30:.2f}" for k, v in
                           plan["parts"].items())
                 + f" = {plan['need'] / 2 ** 30:.2f} GiB for {n:,} params "
                 f"(bench.py's plan {plan['bench_plan'] / 2 ** 30:.2f} GiB);"
                 f" free {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB")
    log(f"8B train memory plan: {math_line}")
    if free < plan["need"]:
        raise AssertionError(f"8B train: the card has too little memory "
                             f"free: {math_line}")
    want = {K9F: 2 * L * EIGHT_B_ACCUM, K10: L * EIGHT_B_ACCUM,
            K11: L * EIGHT_B_ACCUM}
    torch.cuda.reset_peak_memory_stats()
    trainer = train.TorchTrainer(
        init_params=lambda g: llama.init_params(g, cfg),
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        params_axes=llama.logical_axes(cfg),
        batch_axes={"tokens": ("batch", None)},
        optimizer=train.adamw8bit(1e-4, warmup_steps=10, shard_update=True),
        scaling_config=train.ScalingConfig(
            mesh_spec=train.MeshSpec(dp=1, fsdp=1)),
        run_config=train.RunConfig(report_every=1_000_000),
        trainer_config=train.TrainerConfig(zero_sharding=True,
                                           grad_accum=EIGHT_B_ACCUM))
    t0 = time.perf_counter()
    state = trainer.state
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if trainer._layout is None or not trainer._layout.zero:
        raise AssertionError("8B train: the step is not the data-parallel "
                             "ZeRO step")
    step = trainer._step_fn
    gen = torch.Generator().manual_seed(19)
    staged = [trainer.shard_batch({"tokens": torch.randint(
        0, cfg.vocab_size, (EIGHT_B_B, TRAIN_S), generator=gen,
        dtype=torch.int32)}) for _ in range(3)]
    torch.cuda.synchronize()
    per_step, losses = [], []

    def counted(batch):
        nonlocal state
        reset_counts(kernels)
        state, metrics = step(state, batch)
        counts = read_counts(kernels)
        per_step.append({k: counts[k] for k in want})
        losses.append(metrics["loss"])
        return metrics

    for i in range(2):
        counted(staged[i % len(staged)])
    float(losses[-1])
    t0 = time.perf_counter()
    timed = 3
    for i in range(timed):
        metrics = counted(staged[i % len(staged)])
    float(metrics["loss"])
    wall = time.perf_counter() - t0
    gnorm = float(metrics["grad_norm"])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    # The data-parallel step against the single-device step (no layout,
    # no collective) on the same state and batches, in alternating
    # order, each step timed alone: what the step's all-reduces over a
    # group of one cost.
    single = train.compile_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), trainer.tx,
        grad_accum=EIGHT_B_ACCUM)
    state, _ = single(state, staged[2])
    paired = {"data_parallel": [], "single_device": []}
    for i in range(4):
        order = [("data_parallel", step), ("single_device", single)]
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = fn(state, staged[i % len(staged)])
            float(m["loss"])
            paired[name].append((time.perf_counter() - t1) * 1e3)
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], staged[1])

    breakdown = _step_breakdown(torch, one_step)
    torch.cuda.synchronize()
    state = holder[0]
    if any(c != want for c in per_step):
        raise AssertionError(f"8B training: launches per step {per_step}, "
                             f"want {want}")
    if not all(math.isfinite(x) for x in losses) or not math.isfinite(gnorm):
        raise AssertionError(f"8B training: losses {losses}, grad norm "
                             f"{gnorm}")
    with torch.no_grad():
        end_loss = float(llama.loss_fn(state.params, staged[0], cfg)[0])
    if not end_loss < losses[0]:
        raise AssertionError(f"8B training: loss on the first batch "
                             f"{losses[0]} -> {end_loss}: not falling")
    opt = trainer.opt_state_bytes()
    tokens_per_s = EIGHT_B_B * TRAIN_S * timed / wall
    out = {"config": "bench.py _measure_8b_train (bench.py:1240-1320)",
           "card": card, "params_b": n / 1e9, "params": n,
           "optimizer": "adamw8bit(1e-4, warmup_steps=10, "
                        "shard_update=True)",
           "trainer": f"TrainerConfig(zero_sharding=True, grad_accum="
                      f"{EIGHT_B_ACCUM}), MeshSpec(dp=1, fsdp=1), NCCL "
                      f"world size 1",
           "batch": [EIGHT_B_B, TRAIN_S], "init_s": init_s,
           "tokens_per_s": tokens_per_s, "step_ms": wall / timed * 1e3,
           "mfu": 6 * n * tokens_per_s / BF16_FLOPS,
           "opt_state_bytes_per_device": opt["per_device"],
           "opt_state_bytes_global": opt["global"],
           "opt_state_bytes_per_param": opt["per_device"] / n,
           "dp_shards": train.zero.dp_shards(trainer.mesh),
           "peak_bytes": peak, "peak_gib": peak / 2 ** 30,
           "memory_plan": plan, "losses": losses,
           "end_loss_first_batch": end_loss, "grad_norm": gnorm,
           "launches_per_step": per_step, "want_per_step": want,
           "launches": {k: sum(c[k] for c in per_step) for k in want},
           "paired_step_ms": paired,
           "paired_median_ms": {k: statistics.median(v)
                                for k, v in paired.items()},
           "breakdown": breakdown}
    log(f"8B train ({card}; {n / 1e9:.3f} B params, {EIGHT_B_B} x {TRAIN_S}"
        f", adamw8bit ZeRO, grad_accum {EIGHT_B_ACCUM}): "
        f"{tokens_per_s:.1f} tokens/s, step {out['step_ms']:.1f} ms, MFU "
        f"{out['mfu']:.4f}; optimizer state {opt['per_device']:,} B a "
        f"device ({out['opt_state_bytes_per_param']:.4f} B/param, "
        f"dp_shards {out['dp_shards']}); peak {peak / 2 ** 30:.2f} GiB; "
        f"loss {losses[0]:.4f} -> first batch again {end_loss:.4f}; "
        f"launches per step {per_step[0]} (want {want}); init {init_s:.1f} s")
    med = out["paired_median_ms"]
    log(f"  paired, each step alone (4 pairs, alternating): data-parallel "
        f"step {med['data_parallel']:.1f} ms, single-device step "
        f"{med['single_device']:.1f} ms (median; "
        f"{[round(x, 1) for x in paired['data_parallel']]} and "
        f"{[round(x, 1) for x in paired['single_device']]})")
    if "error" in breakdown:
        log(f"  breakdown: not measured ({breakdown['error']})")
    else:
        out["device_idle_share"] = 1 - breakdown["kernel_ms_total"] / (
            wall / timed * 1e3)
        top = dict(list(breakdown["by_kernel"].items())[:6])
        log(f"  one step's kernels {breakdown['kernel_ms_total']:.1f} ms "
            f"(idle {out['device_idle_share']:.3f} of the step): flash "
            f"{breakdown['flash_share']:.3f} "
            f"({_fmt_breakdown(breakdown['flash_ms'])}), matrix products "
            f"{breakdown['gemm_ms']:.1f}, other {breakdown['other_ms']:.1f};"
            f" top: {_fmt_breakdown(top)}")
    del trainer, state, holder, staged
    torch.cuda.empty_cache()
    return out


def eight_b_kernel_rows(report, run):
    """The kernels line's rows of K9f, K10 and K11 at the 8B rung's shape
    (their ``8b`` entries), launches from the rung's 5 steps."""
    rows = {}
    for key, name in (("K9f", K9F), ("K10", K10), ("K11", K11)):
        sub = report[key]["8b"]
        rows[key + " 8b"] = {
            "name": f"{name} (the 8B train rung: B 1 S {TRAIN_S} H 32 "
                    f"KVH 8 D 128)",
            **{k: report[key][k] for k in ("route", "source", "replaces")},
            **{k: sub[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "kernel_ms": sub["ms"], "launches": run["launches"][name]}
    return rows


# --------------------------------------------------------------------------
# Phase 21: Mixtral, ViT and CLIP through the data-parallel step; expert
# parallelism's all-to-all op
# --------------------------------------------------------------------------

MIX21_CF = 0.5                    # (a): a capacity factor at which
                                  # assignments drop
MIX21_PAIRS = 4
A2A_CF = 4.0                      # (c): E / k, at which nothing drops
A2A_REPS = 3
# (b): f32 params, grads and AdamW's two f32 moments (16 B/param) and the
# activations and transients of phase 17's run (its peak was 62.41 GB
# over 50.64 GB of state: 12 GiB).
MIX21_TRANSIENTS = 12 * 2 ** 30


def _dp_trainer(train, init, loss, axes, batch_axes, lr, dev="cuda",
                report_every=1):
    """A ``TorchTrainer`` over ``MeshSpec(dp=1, ep=1)`` on the process
    group (NCCL at world size 1): it runs the data-parallel step."""
    return train.TorchTrainer(
        init_params=init, loss_fn=loss, params_axes=axes,
        batch_axes=batch_axes,
        optimizer=train.default_optimizer(lr, warmup_steps=1),
        scaling_config=train.ScalingConfig(
            mesh_spec=train.MeshSpec(dp=1, ep=1), devices=[dev]),
        run_config=train.RunConfig(report_every=report_every))


def mixtral_dp_parity_phase(torch, tm, train, kernels):
    """(a) phase 17's small f32 Mixtral at capacity factor 0.5 (drops)
    trained 3 steps through ``TorchTrainer`` with ``MeshSpec(dp=1, ep=1)``
    (the data-parallel step; the loss declares the ``"global"`` split, its
    aux summed over the NCCL group): equal to the single-device step on
    the card bit for bit (losses, ce and aux losses, grad norms, params),
    and to the single-device step on the CPU within ZERO_PARITY_TOL; K9f
    12, K10 and K11 6 counted from 0."""
    cfg = dataclasses.replace(
        tm.MIXTRAL_TINY, vocab_size=512, dim=256, n_heads=4, n_kv_heads=2,
        mlp_dim=256, max_seq_len=256, dtype=torch.float32, remat=True,
        capacity_factor=MIX21_CF)
    base = tm.init_params(torch.Generator().manual_seed(21), cfg,
                          device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (3, 2, 256),
                           generator=torch.Generator().manual_seed(22),
                           dtype=torch.int32)
    loss_fn = lambda p, b: tm.loss_fn(p, b, cfg)  # noqa: E731
    keys = ("loss", "ce_loss", "aux_loss", "grad_norm")
    params = _clone_to(torch, base, "cuda")
    trainer = _dp_trainer(train, lambda g, p=params: p, loss_fn,
                          tm.logical_axes(cfg), {"tokens": ("batch", None)},
                          1e-3)
    trainer.state
    if trainer._layout is None:
        raise AssertionError("Mixtral dp parity: no data-parallel layout")
    reset_counts(kernels)
    res = trainer.fit(({"tokens": t} for t in tokens), num_steps=3)
    torch.cuda.synchronize()
    counts = read_counts(kernels)
    if res.error is not None:
        raise res.error
    dp_hist = [{k: m[k] for k in keys} for m in res.metrics_history]

    def single_device(dev):
        tx = train.default_optimizer(1e-3, warmup_steps=1)
        state = train.create_train_state(_clone_to(torch, base, dev), tx)
        step = train.compile_train_step(loss_fn, tx)
        hist = []
        for t in tokens:
            state, m = step(state, {"tokens": t.to(dev)})
            hist.append({k: float(m[k]) for k in keys})
        return hist, state

    hp, sp = single_device("cuda")
    hc, _ = single_device("cpu")
    drop = _mixtral_drop_share(torch, tm, params, {"tokens": tokens[0].to(
        "cuda")}, cfg)
    want = {K9F: 2 * 2 * 3, K10: 2 * 3, K11: 2 * 3}
    launches = {k: counts[k] for k in want}
    exact = dp_hist == hp and _equal_tree(torch, trainer.state.params,
                                           sp.params)
    worst = {k: max(abs(a[k] - b[k]) / abs(b[k]) for a, b in
                    zip(dp_hist, hc)) for k in keys}
    if not exact or launches != want or max(worst.values()) > \
            ZERO_PARITY_TOL or not max(drop) > 0:
        raise AssertionError(
            f"Mixtral dp parity: bit-equal to the single-device step "
            f"{exact} ({dp_hist} vs {hp}), card vs cpu {worst}, launches "
            f"{launches} (want {want}), dropped share {drop}")
    log(f"Mixtral through the data-parallel step (f32, S=256, capacity "
        f"factor {MIX21_CF}, NCCL world size 1, 3 steps): equal to the "
        f"single-device step bit for bit (losses "
        f"{[round(m['loss'], 6) for m in dp_hist]}, params); card vs cpu "
        f"worst relative {worst}; dropped share by layer "
        f"{[round(x, 4) for x in drop]}; launches {launches}")
    out = {"bit_equal_single_device_step": exact, "launches": launches,
           "cuda_vs_cpu_worst_rel": worst, "history": dp_hist,
           "dropped_share_by_layer": drop}
    del trainer, sp, params
    torch.cuda.empty_cache()
    return out


def mixtral_8x7b_dp_phase(torch, tm, train, kernels, card):
    """(b) MIXTRAL_8X7B at full width cut to 2 layers (as phase 17; 1 if
    the memory plan does not fit, and said so; width never cut), f32
    params, bf16 compute, dense dispatch, trained through the
    data-parallel step (``MeshSpec(dp=1, ep=1)`` over NCCL) on phase 17's
    fixed 2 x 2048 batch: the memory plan against ``mem_get_info``, 3
    steps with K9f 4, K10 and K11 2 counted per step, then 4 alternating
    pairs of the data-parallel and the single-device step (each timed
    alone), tokens/s from the medians, the dropped share per layer, the
    peak memory, and a finite loss that falls."""
    layers = MIX_LAYERS
    cfg = dataclasses.replace(tm.MIXTRAL_8X7B, n_layers=layers)
    free, total = torch.cuda.mem_get_info()
    need = 16 * cfg.num_params() + MIX21_TRANSIENTS
    cut = None
    if free < need:
        layers = 1
        cfg = dataclasses.replace(tm.MIXTRAL_8X7B, n_layers=layers)
        cut = (f"2 layers need {need / 2 ** 30:.2f} GiB, "
               f"{free / 2 ** 30:.2f} free: cut to 1 layer")
        need = 16 * cfg.num_params() + MIX21_TRANSIENTS
        log(f"Mixtral 8x7B dp: {cut}")
    plan = {"bytes_per_param": 16, "params": cfg.num_params(),
            "transients": MIX21_TRANSIENTS, "need": need, "free": free,
            "total": total, "cut": cut}
    log(f"Mixtral 8x7B dp memory plan: 16 B/param x {cfg.num_params():,} + "
        f"{MIX21_TRANSIENTS / 2 ** 30:.0f} GiB = {need / 2 ** 30:.2f} GiB; "
        f"free {free / 2 ** 30:.2f} of {total / 2 ** 30:.2f} GiB")
    if free < need:
        raise AssertionError(f"Mixtral 8x7B dp: too little memory: {plan}")
    L = cfg.n_layers
    want = {K9F: 2 * L, K10: L, K11: L}
    loss_fn = lambda p, b: tm.loss_fn(p, b, cfg)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    trainer = _dp_trainer(train, lambda g: tm.init_params(g, cfg), loss_fn,
                          tm.logical_axes(cfg), {"tokens": ("batch", None)},
                          1e-4, report_every=1_000_000)
    t0 = time.perf_counter()
    state = trainer.state
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if trainer._layout is None:
        raise AssertionError("Mixtral 8x7B dp: no data-parallel layout")
    step = trainer._step_fn
    batch = trainer.shard_batch({"tokens": torch.randint(
        0, cfg.vocab_size, (MIX_B, TRAIN_S),
        generator=torch.Generator().manual_seed(13), dtype=torch.int32)})
    torch.cuda.synchronize()
    per_step, losses = [], []
    for _ in range(3):
        reset_counts(kernels)
        state, m = step(state, batch)
        counts = read_counts(kernels)
        per_step.append({k: counts[k] for k in want})
        losses.append(m["loss"])
    single = train.compile_train_step(loss_fn, trainer.tx)
    paired = {"data_parallel": [], "single_device": []}
    for i in range(MIX21_PAIRS):
        order = [("data_parallel", step), ("single_device", single)]
        for name, fn in (order if i % 2 == 0 else order[::-1]):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, m = fn(state, batch)
            losses.append(m["loss"])
            float(m["loss"])
            paired[name].append((time.perf_counter() - t1) * 1e3)
    losses = [float(x) for x in losses]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    drop = _mixtral_drop_share(torch, tm, state.params, batch, cfg)
    if any(c != want for c in per_step):
        raise AssertionError(f"Mixtral 8x7B dp: launches per step {per_step},"
                             f" want {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"Mixtral 8x7B dp: losses {losses}: not finite "
                             "and falling")
    med = {k: statistics.median(v) for k, v in paired.items()}
    tokens = MIX_B * TRAIN_S
    out = {"config": f"MIXTRAL_8X7B at {L} layers (ray_tpu/models/mixtral.py"
                     ":89), MeshSpec(dp=1, ep=1), NCCL world size 1",
           "card": card, "params": cfg.num_params(), "memory_plan": plan,
           "batch": [MIX_B, TRAIN_S], "init_s": init_s,
           "launches_per_step": per_step, "want_per_step": want,
           "paired_step_ms": paired, "paired_median_ms": med,
           "tokens_per_s": {k: tokens / (v / 1e3) for k, v in med.items()},
           "dropped_share_by_layer": drop, "peak_gb": peak_gb,
           "losses": losses}
    log(f"Mixtral 8x7B through the data-parallel step ({card}; {L} layers, "
        f"{MIX_B} x {TRAIN_S}): paired medians (each step alone, "
        f"{MIX21_PAIRS} alternating pairs) data-parallel "
        f"{med['data_parallel']:.1f} ms ({out['tokens_per_s']['data_parallel']:.0f}"
        f" tokens/s), single-device {med['single_device']:.1f} ms "
        f"({out['tokens_per_s']['single_device']:.0f} tokens/s); launches "
        f"per step {per_step[0]}; dropped share by layer "
        f"{[round(x, 4) for x in drop]}; peak {peak_gb:.2f} GB; losses "
        f"{[round(x, 4) for x in losses]}; init {init_s:.1f} s")
    del trainer, state, batch, step, single
    torch.cuda.empty_cache()
    return out


def moe_a2a_phase(torch, tm, tmoe, tmesh, card):
    """(c) ``moe_block_ep`` at MIXTRAL_8X7B's widths (8 experts of 4096 x
    14,336, top 2, bf16, scatter dispatch) on phase 17's 2 x 2048 tokens
    over the ep axis of a dp=1, ep=1 mesh (its two exchanges
    ``all_to_all_single`` on NCCL at world size 1), at capacity factor
    4.0 (no assignment drops): its output and aux equal ``moe_block``'s
    bit for bit (the same routing, buffers and products in the same
    order); each timed alone, ``A2A_REPS`` times, between CUDA events."""
    cfg = dataclasses.replace(tm.MIXTRAL_8X7B, n_layers=1,
                              capacity_factor=A2A_CF,
                              dispatch_mode="scatter")
    E, D, M = cfg.n_experts, cfg.dim, cfg.mlp_dim
    g = torch.Generator(device="cuda").manual_seed(23)

    def normal(shape, fan_in, dt):
        return (torch.randn(shape, generator=g, device="cuda")
                * fan_in ** -0.5).to(dt)

    moe = {"w_router": normal((D, E), D, torch.float32),
           "w_gate": normal((E, D, M), D, torch.bfloat16),
           "w_up": normal((E, D, M), D, torch.bfloat16),
           "w_down": normal((E, M, D), M, torch.bfloat16)}
    x = torch.randn((MIX_B, TRAIN_S, D), generator=g, device="cuda",
                    dtype=torch.bfloat16)
    mesh = tmesh.create_mesh(tmesh.MeshSpec(dp=1, ep=1))
    G = MIX_B * TRAIN_S
    C = tm.capacity(cfg, G)
    with torch.no_grad():
        keep = tm._route(x.reshape(G, D), moe, cfg, C)[3]
        dropped = int((keep == 0).sum())
        y0, a0 = tm.moe_block(x, moe, cfg)
        y1, a1 = tmoe.moe_block_ep(x, moe, cfg, mesh=mesh)
        err = (y1.float() - y0.float()).abs().max().item()
        exact = torch.equal(y0, y1) and torch.equal(a0, a1)
        times = {"moe_block": [], "moe_block_ep": []}
        for _ in range(A2A_REPS):
            for name, fn in (("moe_block", lambda: tm.moe_block(x, moe, cfg)),
                             ("moe_block_ep", lambda: tmoe.moe_block_ep(
                                 x, moe, cfg, mesh=mesh))):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end))
    if dropped or not exact:
        raise AssertionError(f"moe_block_ep vs moe_block: {dropped} dropped, "
                             f"max |dy| {err}, aux {float(a1)} vs {float(a0)}")
    med = {k: statistics.median(v) for k, v in times.items()}
    out = {"config": "MIXTRAL_8X7B's MoE layer (dim 4096, 8 experts of "
                     "14,336, top 2), bf16 experts, scatter dispatch, "
                     f"capacity factor {A2A_CF}",
           "card": card, "tokens": G, "capacity": C, "dropped": dropped,
           "bit_equal": exact, "max_abs_err": err, "aux": float(a0),
           "ms": times, "median_ms": med}
    log(f"moe_block_ep at 8x7B widths ({card}; {G} tokens, C {C}, nothing "
        f"dropped, ep=1 over NCCL): output and aux equal moe_block's bit "
        f"for bit; median moe_block {med['moe_block']:.2f} ms, "
        f"moe_block_ep {med['moe_block_ep']:.2f} ms ({A2A_REPS} each)")
    del moe, x, y0, y1
    torch.cuda.empty_cache()
    return out


def vit_clip_dp_phase(torch, tvit, tclip, train, kernels, card):
    """(d) ViT-L/16 and CLIP_L14_LIKE at full width and depth, 2 AdamW
    steps on a fixed batch of 64 images through the data-parallel step
    (``MeshSpec(dp=1, ep=1)`` over NCCL: ViT's loss declares the
    ``"rows"`` split, CLIP's the ``"global"`` one, its embeddings
    all-gathered over the group) and through the single-device step
    (phase 17's) from the same seeded init: losses, grad norms and params
    equal bit for bit; no kernel launched; images/s of the data-parallel
    step's second step."""
    gen = torch.Generator().manual_seed(24)
    vcfg, ccfg = tvit.VIT_L16, tclip.CLIP_L14_LIKE
    cases = {
        "vit_l16": (lambda g: tvit.init_params(g, vcfg),
                    _vit_loss(tvit, vcfg), tvit.logical_axes(vcfg),
                    {"images": _images_batch(torch, gen, FAMILY_B, vcfg),
                     "labels": torch.randint(0, vcfg.num_classes,
                                             (FAMILY_B,), generator=gen)}),
        "clip_l": (lambda g: tclip.init_params(g, ccfg),
                   _clip_loss(tclip, ccfg), tclip.logical_axes(ccfg),
                   {"images": _images_batch(torch, gen, FAMILY_B,
                                            ccfg.vision),
                    "tokens": torch.randint(1, ccfg.text.vocab_size,
                                            (FAMILY_B, ccfg.text.max_len),
                                            generator=gen)}),
    }
    rules = {"patch": None, "classes": None, "qkv": None, "proj": None}
    batch_axes = {"images": ("batch", None, None, None),
                  "labels": ("batch",), "tokens": ("batch", None)}
    out = {}
    for name, (init, loss, axes, batch) in cases.items():
        trainer = train.TorchTrainer(
            init_params=init, loss_fn=loss, params_axes=axes,
            batch_axes=batch_axes, rules=rules,
            optimizer=train.default_optimizer(1e-4, warmup_steps=1),
            scaling_config=train.ScalingConfig(
                mesh_spec=train.MeshSpec(dp=1, ep=1)),
            run_config=train.RunConfig(report_every=1_000_000))
        state = trainer.state
        if trainer._layout is None:
            raise AssertionError(f"{name} dp: no data-parallel layout")
        staged = trainer.shard_batch(batch)
        reset_counts(kernels)
        hist, wall = [], 0.0
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = trainer._step_fn(state, staged)
            hist.append((float(m["loss"]), float(m["grad_norm"])))
            wall = time.perf_counter() - t0
        launched = {k: v for k, v in read_counts(kernels).items() if v}
        tx = train.default_optimizer(1e-4, warmup_steps=1)
        gen_d = torch.Generator(device="cuda").manual_seed(trainer.seed)
        sstate = train.create_train_state(init(gen_d), tx)
        sstep = train.compile_train_step(loss, tx)
        shist = []
        for i in range(2):
            sstate, m = sstep(sstate, staged)
            shist.append((float(m["loss"]), float(m["grad_norm"])))
        exact = hist == shist and _equal_tree(torch, state.params,
                                               sstate.params)
        if not exact or launched or not all(math.isfinite(a)
                                            for a, _ in hist):
            raise AssertionError(f"{name} dp: {hist} vs single-device "
                                 f"{shist} (params equal {exact}), kernels "
                                 f"{launched}")
        out[name] = {"history": hist, "single_device_history": shist,
                     "bit_equal_single_device_step": exact,
                     "step_ms": wall * 1e3,
                     "images_per_s": FAMILY_B / wall, "card": card}
        log(f"{name} through the data-parallel step ({card}; batch "
            f"{FAMILY_B}, 2 steps): equal to the single-device step bit for "
            f"bit (losses {[round(a, 5) for a, _ in hist]}, params); second "
            f"step {wall * 1e3:.1f} ms, {FAMILY_B / wall:.1f} images/s")
        del trainer, state, sstate, staged, sstep
        torch.cuda.empty_cache()
    return out


def phase21(torch, tm, tvit, tclip, tmoe, tmesh, train, kernels, card):
    """Phase 21 inside phase 19's NCCL group, after the 8B rung."""
    t0 = time.perf_counter()
    out = {"mixtral_parity": mixtral_dp_parity_phase(torch, tm, train,
                                                     kernels)}
    gc.collect()
    torch.cuda.empty_cache()
    out["mixtral_8x7b"] = mixtral_8x7b_dp_phase(torch, tm, train, kernels,
                                                card)
    out["moe_a2a"] = moe_a2a_phase(torch, tm, tmoe, tmesh, card)
    out["vit_clip"] = vit_clip_dp_phase(torch, tvit, tclip, train, kernels,
                                        card)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 21: {out['seconds']:.1f} s")
    return out


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
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from ray_tpu_torch import rllib as rl
        from ray_tpu_torch import train
        from ray_tpu_torch.models import clip as tclip
        from ray_tpu_torch.models import hf_import as thf
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.models import mamba2 as tm
        from ray_tpu_torch.models import mixtral as tmix
        from ray_tpu_torch.models import quant
        from ray_tpu_torch.models import vit as tvit
        from ray_tpu_torch.ops import _build
        from ray_tpu_torch.ops import flash_attention as tfa
        from ray_tpu_torch.ops import fused_decode as tfd
        from ray_tpu_torch.ops import mamba_ssd as tssd
        from ray_tpu_torch.ops import moe_a2a as tmoe
        from ray_tpu_torch.ops import paged_attention as tpa
        from ray_tpu_torch.ops import ragged_paged_attention as trpa
        from ray_tpu_torch.parallel import collectives as tcoll
        from ray_tpu_torch.parallel import mesh as tmesh
        from ray_tpu_torch.serve import llm_engine as eng_mod
        from ray_tpu_torch.train import backend as tbackend
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
    hopper = hopper_check(_build)

    kernels = {"paged_decode_attention_partial":
               tpa.paged_decode_attention_partial,
               "paged_append": tpa.paged_append,
               "flash_forward": tfa.flash_forward,
               "ragged_paged_attention": trpa.ragged_paged_attention,
               "ragged_paged_append": trpa.ragged_paged_append,
               "paged_append_quantized": tpa.paged_append_quantized,
               "ragged_paged_append_quantized":
               trpa.ragged_paged_append_quantized,
               K7: tfd.fused_decode_layer, K8: trpa.fused_ragged_layer,
               K10: tfa.flash_backward_dq, K11: tfa.flash_backward_dkv,
               K12: tssd.ssd_forward, K13: tpa.paged_decode_attention}
    report = {}
    floor_ms = launch_floor_ms(torch)
    log(f"launch floor (an empty launch, timed as the kernels): "
        f"{floor_ms:.5f} ms")
    kernel_phase_k1(torch, F, tpa, report)
    kernel_phase_k2(torch, tpa, report, floor_ms)
    kernel_phase_k9(torch, F, tfa, report)
    kernel_phase_k10_k11(torch, F, tfa, report)
    kernel_phase_k4(torch, F, trpa, report)
    kernel_phase_k5(torch, trpa, report)
    torch.cuda.empty_cache()
    kernel_phase_k1(torch, F, tpa, report, int8=True)
    kernel_phase_k3(torch, tpa, report, floor_ms)
    kernel_phase_k4(torch, F, trpa, report, int8=True)
    torch.cuda.empty_cache()
    kernel_phase_k6(torch, trpa, report)
    torch.cuda.empty_cache()
    for int8 in (False, True):
        kernel_phase_k7(torch, llama, quant, tfd, tpa, trpa, report,
                        int8=int8)
        kernel_phase_k8(torch, llama, quant, trpa, report, int8=int8)
        torch.cuda.empty_cache()
    kernel_phase_k12(torch, tssd, tm, report)
    kernel_phase_k13(torch, F, tpa, report)
    kernel_phase_walk(torch, tpa, kernels, report)
    verify_rows_phase(torch, llama, quant, trpa, report)
    torch.cuda.empty_cache()
    parity = parity_phase(torch, llama, eng_mod)
    ragged_parity = ragged_parity_phase(torch, llama, eng_mod, trpa)
    int8_parity = int8_parity_phase(torch, llama, eng_mod, kernels)
    fused_parity = fused_parity_phase(torch, llama, quant, eng_mod, kernels)
    spec_lora_parity = spec_lora_parity_phase(torch, llama, eng_mod, kernels)
    params, init_s = init_8b(torch, llama)
    # Each path is driven with every launch counter at 0 just before it
    # and read just after: the bucketed path's K1, K2, K9f, the ragged
    # path's K4, K5, then on int8 pools the ragged path's K4 (int8), K6
    # and the bucketed path's K1 (int8), K3; then the fused path over int8
    # weights: K7 (int8 pools) and K3, K8 (int8 pools) and K6, and on
    # bf16 pools K7 and K2, K8 and K5.
    serving = serving_phase(torch, llama, eng_mod, kernels, card, params,
                            init_s)
    ragged = ragged_serving_phase(torch, llama, eng_mod, kernels, card,
                                  params)
    int8_ragged, int8_bucketed = int8_serving_phase(
        torch, llama, eng_mod, kernels, card, params)
    # Speculative decoding and LoRA at full width: the ragged path's K4 and
    # K5 on verify rows, a draft model's own pool and depth, adapter rows.
    spec_serving = spec_serving_phase(torch, llama, eng_mod, kernels, card,
                                      params)
    lora_serving = lora_serving_phase(torch, llama, eng_mod, kernels, card,
                                      params)
    # The dense (non-paged) path: K9f on its prefills, no paged kernel.
    dense_parity = dense_parity_phase(torch, llama, eng_mod, kernels)
    dense_serving = dense_serving_phase(
        torch, llama, eng_mod, kernels, card, params,
        serving["decode_tokens_per_s"])
    # The planes through LLMServer: K1, K2, K9f on the bucketed server,
    # K4, K5 on the ragged one, each counted from 0.
    planes = planes_phase(torch, llama, eng_mod, kernels, card, params,
                          serving)
    # KV page migration between 8B engines (K4, K5 on bf16 pools, K4 int8
    # and K6 on int8 ones, each counted from 0 over a probe), the
    # waterfall and the device plane.
    migration = migration_phase(torch, llama, eng_mod, kernels, card, params)
    # The HF import on the same weights: bit-exact leaves, phase 5's
    # streams from the imported tree (K1, K2, K9f counted from 0).
    hf = hf_import_phase(torch, llama, quant, thf, eng_mod, kernels, card,
                         params, serving, repo)
    del params
    torch.cuda.empty_cache()
    fused_bucketed, fused_ragged, fused_short = fused_serving_phase(
        torch, llama, quant, eng_mod, kernels, card)
    # Training: cuda-vs-cpu parity, then the headline BENCH_CFG path
    # (K9f, K10, K11 counted from 0 over its steps), then BENCH_1B_CFG.
    train_parity = train_parity_phase(torch, llama, train, kernels)
    headline = headline_train_phase(torch, llama, train, kernels,
                                    os.path.dirname(os.path.abspath(
                                        __file__)))
    train_1b = train_1b_phase(torch, llama, train, kernels)
    # int8 Adam states: the flash kernels at a GQA group of 5, cuda-vs-cpu
    # parity, then BENCH_2B_CFG (K9f, K10, K11 counted per step).
    kernel_phase_gqa(torch, F, tfa, report, "group5", B2_B, 20, 4, 31)
    adam8_parity = adam8_parity_phase(torch, llama, train, kernels)
    train_2b = train_2b_phase(torch, llama, train, kernels,
                              os.path.dirname(os.path.abspath(__file__)))
    # Mamba-2: cuda-vs-cpu parity, the small hybrid, then the 2.7B at full
    # width and depth (K12 counted from 0 over its steps); then K13's path.
    mamba_parity = mamba_parity_phase(torch, tm, train, kernels)
    jamba = jamba_phase(torch, tm, train, kernels)
    mamba_27b = mamba_27b_phase(torch, tm, train, kernels)
    k13_path = k13_path_phase(torch, tpa, kernels)
    # The other model families: the flash kernels at Mixtral 8x7B's
    # attention, cuda-vs-cpu parity, then Mixtral 8x7B at full width and 2
    # layers (K9f, K10, K11 counted per step), ViT-L/16 and CLIP-L.
    kernel_phase_gqa(torch, F, tfa, report, "group4", MIX_B, 32, 8, 41)
    mixtral_parity = mixtral_parity_phase(torch, tmix, train, kernels)
    mixtral = mixtral_8x7b_phase(torch, tmix, train, kernels, card)
    for key in ("K9f", "K10", "K11"):
        report[key]["group4"]["launches"] = sum(
            c[{"K9f": K9F, "K10": K10, "K11": K11}[key]]
            for c in mixtral["launches_per_step"][:-1])
    vit_clip_parity = vit_clip_parity_phase(torch, tvit, tclip, train,
                                            kernels)
    vit_clip = vit_clip_phase(torch, tvit, tclip, train, kernels, card)
    # RLlib: the flash kernels at GRPO's attention (head_dim 64), cuda-vs-
    # cpu parity (GRPO, PPO), GRPO at LLAMA3_1B (K9f, K10, K11 counted from
    # 0 each iteration), then learning on the card.
    kernel_phase_gqa(torch, F, tfa, report, "grpo", GRPO_B, 32, 8, 51,
                     S=GRPO_P + GRPO_N, D=64)
    rl_parity = rl_parity_phase(torch, llama, rl, kernels)
    grpo_1b = grpo_1b_phase(torch, llama, rl, kernels, card)
    rl_learning = rl_learning_phase(torch, llama, rl)
    # RLlib's continuous-control, offline and multi-agent algorithms: card
    # vs CPU and graphs vs eager at the CPU tests' sizes, then learning on
    # the card at the JAX tests' settings and gates.
    import numpy as np
    rl20_parity = rl20_parity_phase(torch, np, rl)
    rl20_learning = rl20_learning_phase(torch, np, rl, card)
    # Data-parallel training over torch.distributed: an NCCL group of world
    # size 1 (one card), the collectives on it, ZeRO against the replicated
    # layout, the flash kernels at the 8B rung's shape, then bench.py's
    # full-8B AdamW rung (K9f, K10, K11 counted per step), after every
    # earlier phase has freed its memory.
    gc.collect()
    torch.cuda.empty_cache()
    tbackend.init_process_group(0, 1)
    try:
        collectives = collectives_phase(torch, tcoll, tmesh)
        zero_parity = zero_parity_phase(torch, llama, train, kernels)
        kernel_phase_gqa(torch, F, tfa, report, "8b", 1, 32, 8, 61)
        gc.collect()
        torch.cuda.empty_cache()
        train_8b = train_8b_phase(torch, llama, train, kernels, card)
        # Mixtral, ViT and CLIP through the data-parallel step (the loss
        # splits, K9f, K10, K11 counted from 0), and moe_block_ep, after
        # the 8B rung has freed its memory.
        gc.collect()
        torch.cuda.empty_cache()
        p21 = phase21(torch, tmix, tvit, tclip, tmoe, tmesh, train, kernels,
                      card)
    finally:
        tbackend.shutdown()
    order = ("K1", "K2", "K9f", "K10", "K11", "K4", "K5", "K1i8", "K3",
             "K4i8", "K6", "K7", "K7i8", "K8", "K8i8", "K12", "K13")
    for key, name, run in (
            ("K1", "paged_decode_attention_partial", planes),
            ("K2", "paged_append", planes),
            ("K9f", "flash_forward", planes),
            ("K10", K10, headline),
            ("K11", K11, headline),
            ("K4", "ragged_paged_attention", planes),
            ("K5", "ragged_paged_append", planes),
            ("K1i8", "paged_decode_attention_partial" + INT8, int8_bucketed),
            ("K3", "paged_append_quantized", int8_bucketed),
            ("K4i8", "ragged_paged_attention" + INT8, int8_ragged),
            ("K6", "ragged_paged_append_quantized", int8_ragged),
            ("K7", K7, fused_short["bucketed"]),
            ("K7i8", K7 + INT8, fused_bucketed),
            ("K8", K8, fused_short["ragged"]),
            ("K8i8", K8 + INT8, fused_ragged),
            ("K12", K12, mamba_27b),
            ("K13", K13, k13_path)):
        report[key]["launches"] = run["launches"][name]
        report[key]["kernel_ms"] = report[key]["ms"]
    total_s = time.perf_counter() - t_all
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    report.update(grpo_kernel_rows(report, grpo_1b))
    report.update(eight_b_kernel_rows(report, train_8b))
    order += ("K9f grpo", "K10 grpo", "K11 grpo", "K9f 8b", "K10 8b",
              "K11 8b")
    line = {"kernels": [{k: report[key][k] for k in keys} for key in order]}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "cuda": torch.version.cuda, "build_s": build_s,
                   "total_s": total_s, "launch_floor_ms": floor_ms,
                   "kernels": report,
                   "hopper_sass": hopper, "parity": parity,
                   "ragged_parity": ragged_parity,
                   "int8_parity": int8_parity, "serving": serving,
                   "ragged_serving": ragged,
                   "int8_ragged_serving": int8_ragged,
                   "int8_bucketed_serving": int8_bucketed,
                   "fused_parity": fused_parity,
                   "spec_lora_parity": spec_lora_parity,
                   "spec_serving": spec_serving, "lora_serving": lora_serving,
                   "fused_bucketed_serving": fused_bucketed,
                   "fused_ragged_serving": fused_ragged,
                   "fused_bf16_pool_runs": fused_short,
                   "train_parity": train_parity, "train_headline": headline,
                   "train_1b": train_1b, "mamba_parity": mamba_parity,
                   "dense_parity": dense_parity,
                   "dense_serving": dense_serving,
                   "adam8_parity": adam8_parity, "train_2b": train_2b,
                   "jamba_tiny": jamba, "mamba2_2_7b": mamba_27b,
                   "k13_path": k13_path, "planes": planes,
                   "migration": migration, "hf_import": hf,
                   "mixtral_parity": mixtral_parity,
                   "mixtral_8x7b": mixtral,
                   "vit_clip_parity": vit_clip_parity,
                   "vit_clip": vit_clip, "rl_parity": rl_parity,
                   "grpo_1b": grpo_1b, "rl_learning": rl_learning,
                   "rl20_parity": rl20_parity,
                   "rl20_learning": rl20_learning,
                   "collectives": collectives, "zero_parity": zero_parity,
                   "train_8b": train_8b, "phase21": p21}, f,
                  indent=1, default=str)
    log(f"total {total_s:.1f} s; details in {args.out}")
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
