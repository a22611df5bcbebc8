"""Mamba-2 (SSD) and Jamba-style hybrids for training (port of
``ray_tpu/models/mamba2.py``).

Plain functions on tensors, as in the JAX package: parameters are a
nested dict with the JAX package's key names and stacked layouts
(``mamba.w_in [n_ssm, d, 2 di + 2 N + H]``, ``conv_w [n_ssm, di + 2 N,
K]``, ``a_log/dt_bias/d_skip [n_ssm, H]``, ``w_out [n_ssm, di, d]``,
``ln [n_ssm, d]``, ``ssm_norm [n_ssm, di]``; ``attn.attn.wq [n_attn, d,
heads, hd]`` ...), so ``bridge.params_from_jax`` is a pure copy.

Per SSM layer: in_proj → [z | x | B | C | dt] → depthwise causal conv on
(x, B, C) with silu → SSD(x·dt, A·dt, B, C) + D·x → RMSNorm · silu(z) →
out_proj, in ``cfg.dtype`` with the SSD and the selective parameters in
f32.  The SSD is ``ssd_chunked`` (torch einsums, the JAX package's XLA
path) unless ``cfg.use_pallas_ssd`` takes ``ops.mamba_ssd.ssd_pallas``,
whose forward is kernel K12 on the card.  ``attn_every=k`` makes every
k-th layer a Llama attention block (the port's ``llama._attn_block`` and
``rope_table``: K9f forward, K10/K11 backward on the card at S >= 256).
A homogeneous stack runs each layer under ``torch.utils.checkpoint`` when
``cfg.remat`` and gradients are on (the JAX ``jax.checkpoint`` inside its
layer scan: the whole layer is recomputed); a hybrid stack does not
rematerialise, as in the JAX package.  ``sequence_parallel`` raises
NotImplementedError: the JAX package does not support it for the SSM
scan either.  There is no decode path, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import rms_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    vocab_size: int = 50_288
    dim: int = 2560
    n_layers: int = 64
    d_state: int = 128
    expand: int = 2
    n_heads: int = 80          # head_dim = dim * expand / n_heads
    conv_kernel: int = 4
    chunk: int = 64            # SSD chunk length
    # The SSD chunk scan as one kernel (ops/mamba_ssd.py: K12 on the
    # card) instead of the einsum path with its per-chunk states.
    use_pallas_ssd: bool = False
    # Jamba-style hybrid: every k-th layer is attention (0 = pure SSM).
    attn_every: int = 0
    n_attn_heads: int = 20
    n_attn_kv_heads: int = 4
    rope_theta: float = 500_000.0
    max_seq_len: int = 8192
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    logits_soft_cap: Optional[float] = None
    sequence_parallel: bool = False  # not supported for SSM scan
    tie_embeddings: bool = True

    @property
    def d_inner(self) -> int:
        return self.dim * self.expand

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    def num_params(self) -> int:
        d, di, N = self.dim, self.d_inner, self.d_state
        in_proj = d * (2 * di + 2 * N + self.n_heads)
        conv = (di + 2 * N) * self.conv_kernel
        per_layer = in_proj + conv + 3 * self.n_heads + di * d + 2 * d
        return self.n_layers * per_layer + self.vocab_size * d + d


MAMBA2_2_7B = Mamba2Config()
MAMBA2_TINY = Mamba2Config(
    vocab_size=256, dim=64, n_layers=2, d_state=16, n_heads=4,
    conv_kernel=4, chunk=8, max_seq_len=128, remat=False,
)
JAMBA_TINY = dataclasses.replace(
    MAMBA2_TINY, attn_every=2, n_attn_heads=4, n_attn_kv_heads=2,
)

CONFIGS = {"mamba2-2.7b": MAMBA2_2_7B, "tiny": MAMBA2_TINY,
           "jamba-tiny": JAMBA_TINY}


def _unported(cfg: Mamba2Config) -> None:
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "Mamba2Config.sequence_parallel: the SSM scan has no sequence-"
            "parallel form (the JAX package does not support it either)")


# --- params ---------------------------------------------------------------

def _mamba_layer_axes() -> Params:
    return {
        "w_in": ("layers", "embed", None),
        "conv_w": ("layers", None, None),
        "a_log": ("layers", "heads"),
        "dt_bias": ("layers", "heads"),
        "d_skip": ("layers", "heads"),
        "w_out": ("layers", None, "embed"),
        "ln": ("layers", "embed"),
        "ssm_norm": ("layers", None),
    }


def logical_axes(cfg: Mamba2Config) -> Params:
    """The JAX package's logical axis names per leaf, kept as data: the
    port trains on one device and does not shard by them."""
    out: Params = {
        "tok_embed": ("vocab", "embed"),
        "mamba": _mamba_layer_axes(),
        "final_norm": ("embed",),
    }
    if cfg.attn_every:
        out["attn"] = {
            "attn": {
                "wq": ("layers", "embed", "heads", "head_dim"),
                "wk": ("layers", "embed", "kv_heads", "head_dim"),
                "wv": ("layers", "embed", "kv_heads", "head_dim"),
                "wo": ("layers", "heads", "head_dim", "embed"),
            },
            "ln": ("layers", "embed"),
        }
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    return out


def _layer_kinds(cfg: Mamba2Config):
    """kinds[i] = "attn" every attn_every-th layer (1-indexed), else "ssm"."""
    return [
        "attn" if cfg.attn_every and (i + 1) % cfg.attn_every == 0 else "ssm"
        for i in range(cfg.n_layers)
    ]


def init_params(generator: torch.Generator, cfg: Mamba2Config,
                device: DeviceLike = None) -> Params:
    """Random init from ``generator`` (on ``device``), the JAX package's
    tree, shapes and distributions: normal · fan_in^-0.5, A = -exp(a_log)
    with exp(a_log) ~ U(1, 8), softplus(dt_bias) ~ U(1e-3, 1e-1), D and
    the norms at one.  The draws differ from JAX's."""
    dev = resolve_device(device)
    pd = cfg.param_dtype
    d, di, N, H = cfg.dim, cfg.d_inner, cfg.d_state, cfg.n_heads
    kinds = _layer_kinds(cfg)
    n_ssm, n_attn = kinds.count("ssm"), kinds.count("attn")

    def norm_init(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev, dtype=pd)
        return t.mul_(fan_in ** -0.5)

    def uniform(shape, lo, hi):
        t = torch.rand(shape, generator=generator, device=dev, dtype=pd)
        return t.mul_(hi - lo).add_(lo)

    proj_out = 2 * di + 2 * N + H
    params: Params = {
        "tok_embed": norm_init((cfg.vocab_size, d), d),
        "mamba": {
            "w_in": norm_init((n_ssm, d, proj_out), d),
            "conv_w": norm_init((n_ssm, di + 2 * N, cfg.conv_kernel),
                                cfg.conv_kernel),
            "a_log": torch.log(uniform((n_ssm, H), 1.0, 8.0)),
            "dt_bias": torch.log(torch.expm1(uniform((n_ssm, H), 1e-3,
                                                     1e-1))),
            "d_skip": torch.ones((n_ssm, H), device=dev, dtype=pd),
            "w_out": norm_init((n_ssm, di, d), di),
            "ln": torch.ones((n_ssm, d), device=dev, dtype=pd),
            "ssm_norm": torch.ones((n_ssm, di), device=dev, dtype=pd),
        },
        "final_norm": torch.ones((d,), device=dev, dtype=pd),
    }
    if n_attn:
        ah, akvh = cfg.n_attn_heads, cfg.n_attn_kv_heads
        hd = d // ah
        params["attn"] = {
            "attn": {
                "wq": norm_init((n_attn, d, ah, hd), d),
                "wk": norm_init((n_attn, d, akvh, hd), d),
                "wv": norm_init((n_attn, d, akvh, hd), d),
                "wo": norm_init((n_attn, ah, hd, d), ah * hd),
            },
            "ln": torch.ones((n_attn, d), device=dev, dtype=pd),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm_init((d, cfg.vocab_size), d)
    return params


# --- SSD core -------------------------------------------------------------

def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """log_a [..., T] → [..., T, T] lower-triangular cumulative log-decay:
    out[i, j] = sum_{k=j+1..i} log_a[k] for i >= j, -inf above diagonal."""
    T = log_a.shape[-1]
    cum = torch.cumsum(log_a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    i = torch.arange(T, device=log_a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, torch.full_like(diff, -math.inf))


def ssd_chunked(
    x: torch.Tensor,       # [B, S, H, P]  (inputs, already scaled by dt)
    log_a: torch.Tensor,   # [B, S, H]     (per-step log decay = A*dt, <= 0)
    Bm: torch.Tensor,      # [B, S, N]     (input  projection, shared heads)
    Cm: torch.Tensor,      # [B, S, N]     (output projection, shared heads)
    chunk: int,
) -> torch.Tensor:
    """Chunked SSD: y[t] = C[t] · h[t], h[t] = a[t] h[t-1] + B[t] x[t].

    Returns y [B, S, H, P] f32, differentiable by autograd.  The JAX
    package propagates chunk states with ``lax.associative_scan``; here a
    loop over the chunks computes the same recurrence in order, which
    rounds differently (a few f32 ulps of the state)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32

    xc = x.reshape(B, nc, chunk, H, P).to(f32)
    la = log_a.reshape(B, nc, chunk, H).to(f32)
    Bc = Bm.reshape(B, nc, chunk, N).to(f32)
    Cc = Cm.reshape(B, nc, chunk, N).to(f32)

    # 1) Intra-chunk (quadratic in chunk, all matmuls):
    L = torch.exp(_segsum(la.permute(0, 1, 3, 2)))          # [B,nc,H,c,c]
    scores = torch.einsum("bzin,bzjn->bzij", Cc, Bc)        # [B,nc,c,c]
    y_intra = torch.einsum("bzhij,bzjhp->bzihp",
                           scores[:, :, None] * L, xc)

    # 2) Per-chunk final state: sum_j (decay j→end) B_j x_j^T
    total = torch.cumsum(la, dim=2)                         # [B,nc,c,H]
    decay_to_end = torch.exp(total[:, :, -1:, :] - total)   # [B,nc,c,H]
    states = torch.einsum("bzjn,bzjhp->bzhnp", Bc,
                          decay_to_end[..., None] * xc)     # [B,nc,H,N,P]

    # 3) Inter-chunk recurrence S_z = decay_z S_{z-1} + states_z, carried
    #    in order; prev[z] is the state entering chunk z.  One unbind per
    #    operand: indexing states[:, z] in the loop would make autograd
    #    build (zero-fill) and add a full [B, nc, H, N, P] gradient per
    #    chunk.
    chunk_decay = torch.exp(total[:, :, -1, :])             # [B,nc,H]
    st, dec = states.unbind(1), chunk_decay.unbind(1)
    prev = [torch.zeros_like(st[0])]
    for z in range(nc - 1):
        prev.append(st[z] + dec[z][..., None, None] * prev[-1])
    prev = torch.stack(prev, dim=1)                         # [B,nc,H,N,P]

    # 4) Contribution of the carried-in state to each position:
    decay_in = torch.exp(total)                             # decay start→i
    y_inter = torch.einsum("bzin,bzhnp->bzihp", Cc, prev) \
        * decay_in[..., None]
    return (y_intra + y_inter).reshape(B, S, H, P)


def _mamba_block(x: torch.Tensor, layer: Params,
                 cfg: Mamba2Config) -> torch.Tensor:
    """x [B, S, D] → [B, S, D]."""
    Bsz, S, _ = x.shape
    di, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.head_dim
    f32 = torch.float32

    proj = x @ layer["w_in"].to(cfg.dtype)
    z, xin, Bm, Cm, dt = torch.split(proj, [di, di, N, N, H], dim=-1)

    # Depthwise causal conv over (xin | B | C) — kernel K, silu activation;
    # the taps summed in order in cfg.dtype, as the JAX sum is.
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)              # [B,S,di+2N]
    K = cfg.conv_kernel
    padded = F.pad(conv_in, (0, 0, K - 1, 0))
    w = layer["conv_w"].to(cfg.dtype)                       # [di+2N, K]
    conv = padded[:, 0:S, :] * w[:, 0]
    for k in range(1, K):
        conv = conv + padded[:, k:k + S, :] * w[:, k]
    conv = F.silu(conv)
    xin, Bm, Cm = torch.split(conv, [di, N, N], dim=-1)

    # Selective params: dt per head (softplus), A < 0 scalar per head.
    dt = F.softplus(dt.to(f32) + layer["dt_bias"].to(f32))  # [B,S,H]
    a = -torch.exp(layer["a_log"].to(f32))                  # [H]
    log_a = a * dt                                          # [B,S,H], <= 0

    xh = xin.reshape(Bsz, S, H, P)
    xs = xh.to(f32) * dt[..., None]
    if cfg.use_pallas_ssd:
        from ray_tpu_torch.ops.mamba_ssd import ssd_pallas

        y = ssd_pallas(xs, log_a, Bm, Cm, cfg.chunk)
    else:
        y = ssd_chunked(xs, log_a, Bm, Cm, cfg.chunk)
    y = y + layer["d_skip"].to(f32)[None, None, :, None] * xh.to(f32)
    y = y.reshape(Bsz, S, di).to(cfg.dtype)
    y = rms_norm(y, layer["ssm_norm"], cfg.norm_eps)
    y = y * F.silu(z)
    return y @ layer["w_out"].to(cfg.dtype)


# --- forward --------------------------------------------------------------

def _attn_cfg(cfg: Mamba2Config) -> llama.LlamaConfig:
    """The Llama config a hybrid attention layer runs under: only the
    fields ``_qkv``/``_attn_block``/``rope_table`` read."""
    return dataclasses.replace(
        _ATTN_SHIM, dim=cfg.dim, n_heads=cfg.n_attn_heads,
        n_kv_heads=cfg.n_attn_kv_heads, dtype=cfg.dtype,
        logits_soft_cap=cfg.logits_soft_cap, rope_theta=cfg.rope_theta)


def _attn_layer(x, layer, cfg: Mamba2Config, sin, cos):
    normed = rms_norm(x, layer["ln"], cfg.norm_eps)
    return x + llama._attn_block(normed, layer, _attn_cfg(cfg), sin, cos,
                                 None)[0]


def _ssm_layer(x, layer, cfg: Mamba2Config):
    return x + _mamba_block(rms_norm(x, layer["ln"], cfg.norm_eps), layer,
                            cfg)


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: Mamba2Config,
    *,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (float32)."""
    _unported(cfg)
    kinds = _layer_kinds(cfg)
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    ssm = llama._layers(params["mamba"], kinds.count("ssm"))
    if not cfg.attn_every:
        # Homogeneous stack: each layer rematerialised, as the JAX scan
        # body runs under jax.checkpoint.
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in ssm:
            if remat:
                x = checkpoint(_ssm_layer, x, layer, cfg, use_reentrant=False)
            else:
                x = _ssm_layer(x, layer, cfg)
    else:
        # Hybrid: an unrolled loop indexing each stack, no remat (the JAX
        # package's hybrid path).
        if positions is None:
            positions = torch.arange(tokens.shape[1],
                                     device=tokens.device).expand(
                                         tokens.shape)
        sin, cos = llama.rope_table(_attn_cfg(cfg), positions)
        attn = llama._layers(params["attn"], kinds.count("attn"))
        si = ai = 0
        for kind in kinds:
            if kind == "ssm":
                x = _ssm_layer(x, ssm[si], cfg)
                si += 1
            else:
                x = _attn_layer(x, attn[ai], cfg, sin, cos)
                ai += 1

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(cfg.dtype)
    if cfg.logits_soft_cap:
        logits = cfg.logits_soft_cap * torch.tanh(logits
                                                  / cfg.logits_soft_cap)
    return logits.float()


def loss_fn(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: Mamba2Config,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    tokens = batch["tokens"]
    logits = forward(params, tokens, cfg)
    total, ntokens = llama.next_token_loss(logits, tokens,
                                           batch.get("loss_mask"))
    return total, {"loss": total, "ntokens": ntokens}


# Minimal config shim so llama attention blocks can be reused: only the
# fields _qkv/_attn_block/rope_table read.
_ATTN_SHIM = llama.LlamaConfig(
    vocab_size=1, dim=64, n_layers=1, n_heads=4, n_kv_heads=2, mlp_dim=1,
    max_seq_len=1, remat=False,
)
