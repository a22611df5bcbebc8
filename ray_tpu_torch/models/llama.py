"""Llama-3 family for training and serving (port of
``ray_tpu/models/llama.py``).

Plain functions on tensors, as in the JAX package: parameters are a
nested dict with the JAX package's key names and layouts
(``wq [L,d,H,hd]``, ``wk/wv [L,d,KVH,hd]``, ``wo [L,H,hd,d]``,
``w_gate/w_up [L,d,m]``, ``w_down [L,m,d]``, ``ln_* [L,d]``,
``tok_embed [V,d]``, ``lm_head [d,V]``), so ``bridge.params_from_jax``
is a pure copy.  Matmuls run in ``cfg.dtype``; norms, RoPE and softmax
in float32.

Training: ``forward_hidden`` (the backbone, with per-layer
rematerialisation under ``cfg.remat``: ``"dots"`` keeps the matmul
outputs and recomputes the rest, the flash kernel K9f included;
``"full"`` keeps nothing), ``forward``, ``next_token_loss``,
``chunked_next_token_loss`` (``cfg.loss_chunk``: never the whole
[B, S, V] logits) and ``loss_fn``, differentiable by autograd; attention
at S >= 256 on the card runs K9f forward and K10 + K11 backward
(``ops/flash_attention.py``).

Serving on a dense cache (``init_kv_cache``: k/v [L, slots, max_len,
KVH, D] and an int32 ``length`` per slot, written in place):
``prefill`` (every row full length), ``prefill_slot`` (one prompt into
one slot), ``prefill_batch`` (K prompts in one forward, scattered into
their slots), ``decode_slots`` (one step over every slot, lengths
advanced for the active ones) and ``decode_step``; prefill attention
goes through ``ops.attention`` (K9f on the card for buckets >= 256),
decode through the plain ``ops.attention.decode_attention``.  As in the
JAX package only ``prefill`` and ``prefill_batch`` dequantise int8
weights, so the dense engine refuses an int8 tree.

Serving on the paged path with a
bf16 (or f32) page pool, or with ``cfg.kv_int8`` an int8 pool plus one
f32 scale per page and kv head: ``prefill_batch_paged`` /
``prefill_slot_paged`` (prefill attention through ``ops.attention``,
which runs the flash kernel K9f on the card for buckets >= 256; int8
pools quantise whole pages on the way in), ``decode_slots_paged``
(kernel K1 per layer, kernel K2 once per step, K3 on int8 pools),
``prefill_chunk_paged`` (plain gather attention; bf16/f32 pools only, as
in the JAX package), the unified ragged step ``ragged_step_paged``
(kernel K4 per layer, kernel K5 once per step, K6 on int8 pools) and
``copy_page_paged`` (the prefix cache's copy-on-write split).

Weights may be int8 (w8a16, ``models/quant.py``): ``{"q", "scale"}``
leaves, dequantised one layer at a time inside the serving layer loops
(``_deq_layer``; the dense ``forward`` takes plain weights, as in the JAX
package), the fused ``wqkv``/``w_gateup`` operands of
``quant.fuse_for_decode``, and an int8 head whose scale multiplies the
logits.  With ``cfg.fused_decode`` the decode step runs each layer as one
fused kernel, K7 (``decode_slots_paged_fused``), and the ragged step as
K8; the prefills stay unfused, as in the JAX package.  With
``cfg.lora`` (an ``ops.segmented_lora.LoRAConfig``) ``ragged_step_paged``
takes per-token adapter deltas (``lora=``) and then runs unfused.
Tensor and sequence parallelism raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.ops.attention import (
    decode_attention,
    dot_product_attention,
)
from ray_tpu_torch.ops.fused_decode import fused_decode_layer
from ray_tpu_torch.ops.paged_attention import (
    NEG_INF,
    combine_with_self,
    paged_append,
    paged_append_quantized,
    paged_decode_attention_partial,
)
from ray_tpu_torch.ops.ragged_paged_attention import (
    fused_ragged_layer,
    ragged_paged_append,
    ragged_paged_append_quantized,
    ragged_paged_attention,
)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # Training (forward_hidden, loss_fn): per-layer rematerialisation
    # when gradients are taken ("dots": keep matmul outputs, recompute the
    # rest; "full": keep nothing), and the head-projection chunk along S
    # for the loss (0 = whole logits).  The serving path never reads them.
    remat: bool = True
    remat_policy: str = "dots"
    loss_chunk: int = 0
    logits_soft_cap: Optional[float] = None
    tie_embeddings: bool = False
    # Modes of later slices: setting any of them raises
    # NotImplementedError where the serving path would need them.
    sequence_parallel: bool = False
    sp_backend: str = "ring"
    tensor_parallel: bool = False
    dcn_quantized_allreduce: bool = True
    dcn_allreduce_chunk: int = 256
    # Llama-3.1 RoPE scaling (factor, low_freq_factor, high_freq_factor,
    # original_max_pos), None for unscaled RoPE.
    rope_scaling: Optional[Tuple[float, float, float, int]] = None
    kv_int8: bool = False
    fused_decode: bool = False
    # Multi-tenant LoRA: an ops.segmented_lora.LoRAConfig enables the
    # segmented adapter body of ragged_step_paged (serve/adapter_pool.py
    # holds the factors); None = base model only.
    lora: Optional[Any] = None

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def num_params(self) -> int:
        d, h = self.dim, self.head_dim
        attn = (d * self.n_heads * h + 2 * d * self.n_kv_heads * h
                + self.n_heads * h * d)
        mlp = 3 * d * self.mlp_dim
        per_layer = attn + mlp + 2 * d
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d


LLAMA3_8B = LlamaConfig()
LLAMA3_1B = LlamaConfig(dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                        mlp_dim=8192, vocab_size=128_256)
LLAMA_TINY = LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                         n_kv_heads=2, mlp_dim=128, max_seq_len=128,
                         remat=False)


def _unported(cfg: LlamaConfig) -> None:
    for field, slice_name, item in (
            ("tensor_parallel", "tensor parallelism", "item 6 part 3"),
            ("sequence_parallel", "sequence parallelism", "item 7")):
        if getattr(cfg, field):
            raise NotImplementedError(
                f"LlamaConfig.{field}: {slice_name} is not ported to "
                f"ray_tpu_torch yet (ROADMAP.md queue 1 {item})")


# --- params ---------------------------------------------------------------

def logical_axes(cfg: LlamaConfig) -> Params:
    """Tree of per-dimension logical axis names, mirroring
    ``init_params`` (the JAX package's, for ``parallel/sharding.py``)."""
    layer = {
        "attn": {
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
        },
        "mlp": {
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "ln_attn": ("layers", "embed"),
        "ln_mlp": ("layers", "embed"),
    }
    out: Params = {
        "tok_embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    return out


def init_params(generator: torch.Generator, cfg: LlamaConfig,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random init from ``generator`` (on ``device``) straight into
    ``dtype`` (default ``cfg.param_dtype``): the 8B initialises in bf16
    on the card without an f32 copy.  Same tree and scaling as the JAX
    package (normal * fan_in^-0.5, norms at one); the draws differ."""
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    d, h, kvh, hd, m = (cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        cfg.mlp_dim)
    L = cfg.n_layers

    def norm_init(shape, fan_in):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dt)
        return t.mul_(fan_in ** -0.5)

    params: Params = {
        "tok_embed": norm_init((cfg.vocab_size, d), d),
        "layers": {
            "attn": {
                "wq": norm_init((L, d, h, hd), d),
                "wk": norm_init((L, d, kvh, hd), d),
                "wv": norm_init((L, d, kvh, hd), d),
                "wo": norm_init((L, h, hd, d), h * hd),
            },
            "mlp": {
                "w_gate": norm_init((L, d, m), d),
                "w_up": norm_init((L, d, m), d),
                "w_down": norm_init((L, m, d), m),
            },
            "ln_attn": torch.ones((L, d), device=dev, dtype=dt),
            "ln_mlp": torch.ones((L, d), device=dev, dtype=dt),
        },
        "final_norm": torch.ones((d,), device=dev, dtype=dt),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = norm_init((d, cfg.vocab_size), d)
    return params


def _layers(stack: Params, n_layers: int):
    """Every layer's slice of a stacked layer tree (views), one unbind
    per leaf: a host-side ATen call per leaf and step, not per leaf and
    layer."""
    if isinstance(stack, dict):
        per_key = {k: _layers(v, n_layers) for k, v in stack.items()}
        return [{k: v[i] for k, v in per_key.items()}
                for i in range(n_layers)]
    return stack.unbind(0)


def _head(params: Params, cfg: LlamaConfig) -> torch.Tensor:
    return params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]


# --- building blocks ------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight.to(x.dtype)


def rope_table(cfg: LlamaConfig, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [B, S] → (sin, cos) each [B, S, head_dim//2], float32."""
    half = cfg.head_dim // 2
    dev = positions.device
    # A Python-scalar base: a device tensor made from it would be a
    # blocking host→device copy on every decode step.
    freqs = cfg.rope_theta ** (
        -torch.arange(half, dtype=torch.float32, device=dev) / half)
    if cfg.rope_scaling is not None:
        # Llama-3.1 frequency scaling (the "llama3" rope_type).
        factor, low_ff, high_ff, orig_max = cfg.rope_scaling
        wavelen = 2 * math.pi / freqs
        low_wl = orig_max / low_ff
        high_wl = orig_max / high_ff
        smooth = (orig_max / wavelen - low_ff) / (high_ff - low_ff)
        freqs = torch.where(
            wavelen > low_wl, freqs / factor,
            torch.where(wavelen < high_wl, freqs,
                        (1 - smooth) * freqs / factor + smooth * freqs))
    angles = positions[..., None].float() * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x [B, S, H, D]; rotate half-split pairs
    (x1, x2) = (x[..., :half], x[..., half:]) — not interleaved."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _proj(x: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """x [..., d] @ w [d, *out] → [..., *out] (einsum "bsd,dhk->bshk")."""
    out_shape = w.shape[1:]
    y = x @ w.to(dt).reshape(w.shape[0], -1)
    return y.reshape(*x.shape[:-1], *out_shape)


def _qkv(x, layer, cfg: LlamaConfig, sin, cos):
    """Shared q/k/v projection + RoPE (prefill and decode)."""
    a = layer["attn"]
    dt = cfg.dtype
    if "wqkv" in a:
        # A fused serving artifact (quant.fuse_for_decode): one matmul.
        H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        lead = x.shape[:-1]
        qkv = _proj(x, a["wqkv"], dt)
        q = qkv[..., :H * hd].reshape(*lead, H, hd)
        k = qkv[..., H * hd:(H + KVH) * hd].reshape(*lead, KVH, hd)
        # v is a column slice of qkv: the kernels take contiguous rows.
        v = qkv[..., (H + KVH) * hd:].reshape(*lead, KVH, hd).contiguous()
    else:
        q = _proj(x, a["wq"], dt)
        k = _proj(x, a["wk"], dt)
        v = _proj(x, a["wv"], dt)
    return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v


def _attn_block(x, layer, cfg: LlamaConfig, sin, cos, segment_ids):
    """Returns (out, (k, v)) — k/v for cache population during prefill."""
    q, k, v = _qkv(x, layer, cfg, sin, cos)
    out = dot_product_attention(q, k, v, causal=True,
                                segment_ids=segment_ids,
                                logits_soft_cap=cfg.logits_soft_cap)
    wo = layer["attn"]["wo"]
    out = out.reshape(*out.shape[:2], -1) @ wo.to(cfg.dtype).reshape(
        -1, wo.shape[-1])
    return out, (k, v)


def _mlp_block(x, layer, cfg: LlamaConfig):
    m = layer["mlp"]
    dt = cfg.dtype
    if "w_gateup" in m:  # fused serving artifact (quant.fuse_for_decode)
        gate, up = (x @ m["w_gateup"].to(dt)).chunk(2, dim=-1)
    else:
        gate = x @ m["w_gate"].to(dt)
        up = x @ m["w_up"].to(dt)
    return (F.silu(gate) * up) @ m["w_down"].to(dt)


# --- int8 weights (w8a16, models/quant.py) ---------------------------------

def _is_qdict(node) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"q", "scale"}


def _deq_layer(layer, dtype: torch.dtype):
    """Dequantise one layer's int8 leaves INSIDE the layer loop, so only
    one layer ever exists in ``dtype`` (the 8B's whole tree would be 16
    GB in bf16).  Identity for unquantised layers."""
    def walk(node):
        if _is_qdict(node):
            return node["q"].to(dtype) * node["scale"].to(dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(layer)


def _head_matmul(x, head, cfg: LlamaConfig):
    """Logits projection x [..., d] @ head [d, V].  For an int8 head the
    per-OUTPUT-channel scale [1, V] multiplies the matmul RESULT, so the
    operand is a bare int8 → dtype convert."""
    if not _is_qdict(head):
        return x @ head.to(cfg.dtype)
    out = x @ head["q"].to(cfg.dtype)
    return out.float() * head["scale"][0].float()


# --- forward --------------------------------------------------------------

def _layer_fn(cfg: LlamaConfig, x, layer, sin, cos, segment_ids):
    h = x + _attn_block(rms_norm(x, layer["ln_attn"], cfg.norm_eps), layer,
                        cfg, sin, cos, segment_ids)[0]
    return h + _mlp_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps), layer,
                          cfg)


def _dots_policy(ctx, op, *args, **kwargs):
    """Keep matmuls with no batch dims (``x [B,S,d] @ w [d,n]`` reaches ATen
    as ``mm``), what ``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable`` keeps; recompute the rest.
    Attention's products sit inside the flash Function or batched einsums
    (``bmm``), so they are recomputed, as in the JAX package."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_kwargs(cfg: LlamaConfig) -> Dict[str, Any]:
    if cfg.remat_policy == "full":
        return {}
    return {"context_fn": lambda: create_selective_checkpoint_contexts(
        _dots_policy)}


def forward_hidden(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                   *, positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Any]:
    """Backbone only: tokens [B, S] → (hidden [B, S, D], head [D, V]).
    The head projection is left to the caller so the loss can run it
    chunked.  With ``cfg.remat`` and gradients enabled each layer runs
    under ``torch.utils.checkpoint`` (non-reentrant): ``"dots"`` keeps
    the matmul outputs and recomputes the rest in the backward, the
    flash forward included; ``"full"`` recomputes the whole layer."""
    if cfg.sequence_parallel:
        _unported(cfg)
    if cfg.remat_policy not in ("dots", "full"):
        raise ValueError(
            f"remat_policy must be 'dots' or 'full', got {cfg.remat_policy!r}"
        )
    if positions is None:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)
    sin, cos = rope_table(cfg, positions)
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    kwargs = _remat_kwargs(cfg) if remat else {}
    for layer in _layers(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_layer_fn, cfg, x, layer, sin, cos, segment_ids,
                           use_reentrant=False, **kwargs)
        else:
            x = _layer_fn(cfg, x, layer, sin, cos, segment_ids)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, _head(params, cfg)


def forward(params: Params, tokens: torch.Tensor, cfg: LlamaConfig, *,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (float32)."""
    x, head = forward_hidden(params, tokens, cfg, positions=positions,
                             segment_ids=segment_ids)
    return _head_matmul(x, head, cfg).float()


# --- training loss ----------------------------------------------------------

def _nll(logits: torch.Tensor, targets: torch.Tensor, z_loss: float
         ) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - tgt
    if z_loss:
        nll = nll + z_loss * logz ** 2
    return nll


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor,
                    loss_mask: Optional[torch.Tensor] = None, *,
                    z_loss: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shifted next-token masked cross-entropy.  logits [B, S, V], tokens
    [B, S] → (mean_nll, ntokens)."""
    nll = _nll(logits[:, :-1], tokens[:, 1:], z_loss)
    if loss_mask is None:
        mask = torch.ones_like(nll)
    else:
        mask = loss_mask[:, 1:].to(nll.dtype)
    total = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return total, mask.sum()


def chunked_next_token_loss(x: torch.Tensor, head: torch.Tensor,
                            tokens: torch.Tensor,
                            loss_mask: Optional[torch.Tensor] = None, *,
                            chunk: int = 512, z_loss: float = 0.0
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy with the head projection chunked over the sequence
    axis: only [B, chunk, V] logits exist at a time, and with gradients
    enabled each chunk runs under ``torch.utils.checkpoint`` so the
    backward recomputes them.  The sequence is padded to a chunk multiple
    (padding masked out); chunks are summed in order, as the JAX scan
    does."""
    x = x[:, :-1]
    targets = tokens[:, 1:].long()
    B, S1, _ = x.shape
    mask = (torch.ones((B, S1), dtype=torch.float32, device=x.device)
            if loss_mask is None else loss_mask[:, 1:].float())
    pad = (-S1) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    hd = head.to(x.dtype)

    def body(xi, ti, mi):
        return (_nll((xi @ hd).float(), ti, z_loss) * mi).sum()

    grad = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S1 + pad, chunk):
        xi, ti, mi = x[:, c:c + chunk], targets[:, c:c + chunk], \
            mask[:, c:c + chunk]
        part = (checkpoint(body, xi, ti, mi, use_reentrant=False) if grad
                else body(xi, ti, mi))
        tot = tot + part
        cnt = cnt + mi.sum()
    return tot / cnt.clamp_min(1.0), cnt


def loss_fn(params: Params, batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig, *, z_loss: float = 0.0
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy.  batch: tokens [B, S], optional
    loss_mask [B, S] and segment_ids [B, S]."""
    tokens = batch["tokens"]
    # The full sequence runs (S stays block-divisible for the flash
    # kernels) and the logits shift, not the inputs.
    if cfg.loss_chunk:
        x, head = forward_hidden(params, tokens, cfg,
                                 segment_ids=batch.get("segment_ids"))
        total, ntokens = chunked_next_token_loss(
            x, head, tokens, batch.get("loss_mask"), chunk=cfg.loss_chunk,
            z_loss=z_loss)
    else:
        logits = forward(params, tokens, cfg,
                         segment_ids=batch.get("segment_ids"))
        total, ntokens = next_token_loss(logits, tokens,
                                         batch.get("loss_mask"),
                                         z_loss=z_loss)
    return total, {"loss": total, "ntokens": ntokens}


# --- dense KV cache serving -------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Dense cache: k/v [L, batch, max_len, KVH, D] in ``cfg.dtype`` and
    the valid length of each row, int32 [batch]."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _prefill_layers(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                    write, deq: bool) -> torch.Tensor:
    """The prefill forward over tokens [K, S]: each layer's k/v
    [K, S, KVH, D] go to ``write(layer_index, k, v)``; returns the final
    normed hidden [K, S, D].  ``deq`` dequantises int8 layers (only
    ``prefill`` and ``prefill_batch`` do, as in the JAX package)."""
    _unported(cfg)
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)[None, :]
    sin, cos = rope_table(cfg, positions)
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    for i, layer in enumerate(_layers(params["layers"], cfg.n_layers)):
        if deq:
            layer = _deq_layer(layer, cfg.dtype)
        normed = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
        out, (k, v) = _attn_block(normed, layer, cfg, sin, cos, None)
        h = x + out
        x = h + _mlp_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps),
                           layer, cfg)
        write(i, k, v)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def prefill(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
            cache: Dict[str, torch.Tensor]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt through the model, filling the cache in place.
    tokens [B, S] (every row uses the full S) → (logits at the last
    position [B, V] f32, cache) with ``length = S`` for every row."""
    B, S = tokens.shape

    def write(i, k, v):
        cache["k"][i, :, :S] = k
        cache["v"][i, :, :S] = v

    x = _prefill_layers(params, tokens, cfg, write, deq=True)
    logits = x[:, -1] @ _head(params, cfg).to(cfg.dtype)
    cache["length"] = torch.full((B,), S, dtype=torch.int32,
                                 device=tokens.device)
    return logits.float(), cache


def prefill_slot(params: Params, tokens: torch.Tensor, true_len, slot,
                 cfg: LlamaConfig, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill ONE sequence into one slot: tokens [S] right-padded to a
    bucket; k/v land in ``cache[:, slot, :S]`` and ``length[slot] =
    true_len``.  Returns (logits at true_len - 1 [V] f32, cache).
    Causality keeps the padding invisible to the real positions."""
    S = tokens.shape[0]
    dev = tokens.device
    slot = torch.as_tensor(slot, device=dev).reshape(1).long()
    true_len = torch.as_tensor(true_len, device=dev).reshape(())

    def write(i, k, v):
        cache["k"][i, slot, :S] = k
        cache["v"][i, slot, :S] = v

    x = _prefill_layers(params, tokens[None], cfg, write, deq=False)
    logits = x[0, true_len.long() - 1] @ _head(params, cfg).to(cfg.dtype)
    cache["length"][slot] = true_len.to(torch.int32)
    return logits.float(), cache


def prefill_batch(params: Params, tokens: torch.Tensor,
                  true_lens: torch.Tensor, slots: torch.Tensor,
                  cfg: LlamaConfig, cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill K sequences in ONE batched forward: tokens [K, S],
    true_lens [K], slots [K] → (logits at each row's true_len - 1
    [K, V] f32, cache).  Whole [:S] rows scatter into their slots;
    duplicate slot ids (admission padding rows) write identical
    values."""
    S = tokens.shape[1]
    slots = slots.long()

    def write(i, k, v):
        cache["k"][i, slots, :S] = k
        cache["v"][i, slots, :S] = v

    x = _prefill_layers(params, tokens, cfg, write, deq=True)
    rows = torch.arange(tokens.shape[0], device=tokens.device)
    logits = _head_matmul(x[rows, true_lens.long() - 1], _head(params, cfg),
                          cfg)
    cache["length"][slots] = true_lens.to(torch.int32)
    return logits.float(), cache


def _write_rows(pool: torch.Tensor, idx: torch.Tensor,
                new: torch.Tensor) -> None:
    """pool [B, S_max, KVH, D][b, idx[b]] = new[b], in place; a row
    whose idx is past S_max writes nothing (the JAX scatter drops it)
    and no host sync decides that."""
    rows = torch.arange(pool.shape[0], device=pool.device)
    at = idx.clamp(max=pool.shape[1] - 1).long()
    keep = (idx < pool.shape[1])[:, None, None]
    pool[rows, at] = torch.where(keep, new.to(pool.dtype), pool[rows, at])


def decode_slots(params: Params, tokens: torch.Tensor, active: torch.Tensor,
                 cfg: LlamaConfig, cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over ALL slots: tokens [slots] int32, active
    [slots] bool → (logits [slots, V] f32, cache).  Every row's new k/v
    is written at its length, inactive rows too, but only active rows
    advance their length, so an inactive row's write is overwritten
    before anything attends to it."""
    _unported(cfg)
    lengths = cache["length"]
    new_len = torch.where(active, lengths + 1, lengths)
    sin, cos = rope_table(cfg, lengths[:, None])
    x = params["tok_embed"][tokens[:, None].long()].to(cfg.dtype)
    B = tokens.shape[0]
    for i, layer in enumerate(_layers(params["layers"], cfg.n_layers)):
        normed = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
        q, k, v = _qkv(normed, layer, cfg, sin, cos)
        kc, vc = cache["k"][i], cache["v"][i]
        _write_rows(kc, lengths, k[:, 0])
        _write_rows(vc, lengths, v[:, 0])
        out = decode_attention(q, kc, vc, new_len,
                               logits_soft_cap=cfg.logits_soft_cap)
        wo = layer["attn"]["wo"]
        out = out.reshape(B, 1, -1) @ wo.to(cfg.dtype).reshape(
            -1, wo.shape[-1])
        h = x + out
        x = h + _mlp_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps),
                           layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, 0] @ _head(params, cfg).to(cfg.dtype)
    cache["length"] = new_len
    return logits.float(), cache


def decode_step(params: Params, tokens: torch.Tensor, cfg: LlamaConfig,
                cache: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step of every row: tokens [B] → (logits [B, V] f32,
    cache), each length advanced by one."""
    active = torch.ones(tokens.shape, dtype=torch.bool, device=tokens.device)
    return decode_slots(params, tokens, active, cfg, cache)


# --- paged serving --------------------------------------------------------

def _quant_pages(pages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., n_pages, page, D] values → (int8 pages, [..., n_pages] f32
    per-page absmax scales): the int8 pool's write-side quantiser for
    whole pages.  The absmax runs over the whole page, a prompt's bucket
    padding included, as in the JAX package."""
    x = pages.float()
    amax = x.abs().amax(dim=(-2, -1))
    scale = (amax / torch.full_like(amax, 127.0)).clamp(min=1e-8)
    q = torch.round(x / scale[..., None, None]).clamp(-127, 127)
    return q.to(torch.int8), scale


def _scale_kwargs(cache: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The attention kernels' ``k_scales``/``v_scales`` arguments for an
    int8 cache; nothing for a bf16/f32 one."""
    if "k_scale" not in cache:
        return {}
    return {"k_scales": cache["k_scale"], "v_scales": cache["v_scale"]}


def init_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                     device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Page-pool cache: k/v [L, KVH, P+1, page, D] in ``cfg.dtype``
    (kv-head-major per layer, the paged kernels' layout).  The LAST
    physical page is a scratch page: OOB sentinel writes (inactive
    slots, chunk-ladder overshoot — sentinel value == num_pages) land
    there instead of on a live page.

    With ``cfg.kv_int8`` the pools are int8 plus one f32 scale per
    physical page per kv head (``k_scale``/``v_scale`` [L, P+1, KVH, 1],
    page-major), all zeros: the pool takes half the bytes of bf16."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, cfg.n_kv_heads, num_pages + 1, page_size,
             cfg.head_dim)
    if cfg.kv_int8:
        sshape = (cfg.n_layers, num_pages + 1, cfg.n_kv_heads, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=dev),
                "v": torch.zeros(shape, dtype=torch.int8, device=dev),
                "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=dev),
                "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                       device=dev)}
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def copy_page_paged(cache: Dict[str, torch.Tensor], src, dst
                    ) -> Dict[str, torch.Tensor]:
    """Duplicate ONE physical page src → dst across every layer, in
    place: k/v (page axis 2) and, for int8 pools, the per-page scales
    (page axis 1).  The prefix cache's copy-on-write split: the only KV
    write that may target a shared page (the last-token re-run of an
    exact full-prompt hit) goes to the copy, never the cached
    original."""
    src, dst = int(src), int(dst)
    for key in ("k", "v"):
        cache[key][:, :, dst] = cache[key][:, :, src]
    for key in ("k_scale", "v_scale"):
        if key in cache:
            cache[key][:, dst] = cache[key][:, src]
    return cache


def prefill_batch_paged(params: Params, tokens: torch.Tensor,
                        true_lens: torch.Tensor, pages_rows: torch.Tensor,
                        cfg: LlamaConfig, cache: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched prefill into the PAGE POOL: one [K, S] forward; each
    layer's k/v land in the rows' pages (pages_rows [K, >= S // page]).
    Rows own disjoint pages (padding duplicates write identical data).
    The pool is updated in place; int8 pools quantise each page whole
    (``_quant_pages``) and store its scale.  Returns (logits at each
    row's true_len - 1 [K, V] f32, cache)."""
    _unported(cfg)
    K, S = tokens.shape
    page = cache["k"].shape[3]
    npg = S // page
    positions = torch.arange(S, device=tokens.device)[None, :]
    sin, cos = rope_table(cfg, positions)
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    page_ids = pages_rows[:, :npg].reshape(K * npg).long()
    KVH, D = cfg.n_kv_heads, cfg.head_dim
    quantized = "k_scale" in cache
    for i, layer in enumerate(_layers(params["layers"], cfg.n_layers)):
        layer = _deq_layer(layer, cfg.dtype)
        normed = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
        out, (k, v) = _attn_block(normed, layer, cfg, sin, cos, None)
        h = x + out
        x = h + _mlp_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps),
                           layer, cfg)
        # [K, S, KVH, D] → [KVH, K * S/page, page, D]
        for key, new in (("k", k), ("v", v)):
            pages = new.permute(2, 0, 1, 3).reshape(KVH, K * npg, page, D)
            if quantized:
                pages, scale = _quant_pages(pages)
                # [KVH, pages] → page-major [pages, KVH, 1]
                cache[key + "_scale"][i][page_ids] = scale.T[..., None]
            cache[key][i][:, page_ids] = pages.to(cache[key].dtype)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    rows = torch.arange(K, device=tokens.device)
    last = x[rows, true_lens.long() - 1]
    logits = _head_matmul(last, _head(params, cfg), cfg)
    return logits.float(), cache


def prefill_slot_paged(params: Params, tokens: torch.Tensor,
                       true_len: torch.Tensor, pages: torch.Tensor,
                       cfg: LlamaConfig, cache: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill ONE sequence into its PAGES: tokens [S] (a multiple of
    the page size), pages [S // page] → (logits at true_len-1 [V],
    cache)."""
    logits, cache = prefill_batch_paged(
        params, tokens[None], torch.as_tensor(true_len).reshape(1),
        pages[None], cfg, cache)
    return logits[0], cache


def decode_slots_paged(params: Params, tokens: torch.Tensor,
                       active: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, cfg: LlamaConfig,
                       cache: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                  torch.Tensor]:
    """One decode step over all slots against the page pool.

    tokens [slots], active [slots] bool, block_tables [slots, maxp]
    int32, lengths [slots] int32 → (logits [slots, V] f32, cache,
    new_lengths).  The new token's k/v go to page
    block_tables[b, lengths[b] // page] at offset lengths[b] % page.

    Deferred append, as in the JAX package: inside the layer loop the
    pools are read-only — K1 returns flash partials over past tokens
    and the current token's self-attention folds in from the fresh k/v
    (combine_with_self); after the loop ONE K2 launch appends every
    layer's new row, in place.  On int8 pools K1 reads the page scales,
    the self term uses the unquantised fresh k/v, and K3 takes K2's
    place.  With ``cfg.fused_decode`` the layers run as K7
    (``decode_slots_paged_fused``)."""
    _unported(cfg)
    if cfg.fused_decode:
        return decode_slots_paged_fused(params, tokens, active, block_tables,
                                        lengths, cfg, cache)
    scales = _scale_kwargs(cache)
    new_len = torch.where(active, lengths + 1, lengths)
    sin, cos = rope_table(cfg, lengths[:, None])
    x = params["tok_embed"][tokens[:, None].long()].to(cfg.dtype)
    B = tokens.shape[0]
    k_news, v_news = [], []
    for i, layer in enumerate(_layers(params["layers"], cfg.n_layers)):
        layer = _deq_layer(layer, cfg.dtype)
        normed = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
        q, k, v = _qkv(normed, layer, cfg, sin, cos)
        k1, v1 = k[:, 0], v[:, 0]  # [B, KVH, D]
        acc, m, l = paged_decode_attention_partial(
            q[:, 0], cache["k"], cache["v"], i, block_tables, lengths,
            soft_cap=cfg.logits_soft_cap, **scales)
        out = combine_with_self(q[:, 0], k1, v1, acc, m, l,
                                soft_cap=cfg.logits_soft_cap)
        wo = layer["attn"]["wo"]
        out = out.reshape(B, -1) @ wo.to(cfg.dtype).reshape(-1, wo.shape[-1])
        h = x + out[:, None]
        x = h + _mlp_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps),
                           layer, cfg)
        k_news.append(k1)
        v_news.append(v1)
    _append_decode_rows(cache, k_news, v_news, active, block_tables, lengths)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _head_matmul(x[:, 0], _head(params, cfg), cfg)
    return logits.float(), cache, new_len


def _append_decode_rows(cache, k_news, v_news, active, block_tables,
                        lengths) -> None:
    """The decode step's deferred append: every layer's new row of each
    slot goes to page block_tables[b, lengths[b] // page] at offset
    lengths[b] % page in ONE K2 launch (K3 on int8 pools), in place.
    Inactive slots must not write to live pages (theirs may already
    belong to another request): they go to the scratch page."""
    page = cache["k"].shape[3]
    scratch = cache["k"].shape[2] - 1  # physical scratch page
    maxp = block_tables.shape[1]
    slot_page = torch.clamp(lengths // page, max=maxp - 1).long()
    pids = torch.gather(block_tables, 1, slot_page[:, None])[:, 0]
    pids = torch.where(active, pids, torch.full_like(pids, scratch))
    offs = (lengths % page).to(torch.int32)
    if "k_scale" in cache:
        paged_append_quantized(cache["k"], cache["v"], cache["k_scale"],
                               cache["v_scale"], torch.stack(k_news),
                               torch.stack(v_news), pids.to(torch.int32),
                               offs)
    else:
        paged_append(cache["k"], cache["v"],
                     torch.stack(k_news).to(cache["k"].dtype),
                     torch.stack(v_news).to(cache["v"].dtype),
                     pids.to(torch.int32), offs)


def decode_slots_paged_fused(params: Params, tokens: torch.Tensor,
                             active: torch.Tensor,
                             block_tables: torch.Tensor,
                             lengths: torch.Tensor, cfg: LlamaConfig,
                             cache: Dict[str, torch.Tensor]
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                                        torch.Tensor]:
    """``decode_slots_paged`` with one fused kernel per layer (K7,
    ``ops/fused_decode.fused_decode_layer``).  Same contract and same
    deferred append: the pools are read-only in the layer loop, each
    layer's k/v rows ride out of the loop, one K2 (K3 on int8 pools)
    after it appends them all.  On CUDA tensors every layer launches K7
    or raises."""
    _unported(cfg)
    new_len = torch.where(active, lengths + 1, lengths)
    sin, cos = rope_table(cfg, lengths[:, None])
    sin, cos = sin[:, 0], cos[:, 0]                       # [B, hd // 2]
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)  # [B, D]
    k_news, v_news = [], []
    for i, layer in enumerate(_layers(params["layers"], cfg.n_layers)):
        x, k1, v1 = fused_decode_layer(
            x, layer, cache["k"], cache["v"], i, block_tables,
            lengths, sin, cos, eps=cfg.norm_eps, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, soft_cap=cfg.logits_soft_cap,
            k_scales=cache.get("k_scale"), v_scales=cache.get("v_scale"))
        k_news.append(k1)
        v_news.append(v1)
    _append_decode_rows(cache, k_news, v_news, active, block_tables, lengths)
    x = rms_norm(x[:, None], params["final_norm"], cfg.norm_eps)
    logits = _head_matmul(x[:, 0], _head(params, cfg), cfg)
    return logits.float(), cache, new_len


def prefill_chunk_paged(params: Params, tokens: torch.Tensor,
                        start: torch.Tensor, chunk_lens: torch.Tensor,
                        pages_rows: torch.Tensor, cfg: LlamaConfig,
                        cache: Dict[str, torch.Tensor]
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One CHUNK of an incremental prefill: tokens [K, C] are the next C
    prompt tokens of K sequences at absolute positions start[k] ..
    start[k] + C - 1 (``chunk_lens`` [K] true counts; short tails are
    right-padded).  Each layer writes the chunk's k/v into the rows'
    pages (pages_rows [K, maxp]) in place, then attends over every
    cached position <= its own (plain gather attention, as in the JAX
    package: no kernel).  Padding tokens write the scratch page.
    Returns (logits at each row's last true token [K, V] f32, cache).
    int8 pools raise, as in the JAX package: a per-token scatter cannot
    grow a page's scale."""
    _unported(cfg)
    if "k_scale" in cache:
        raise NotImplementedError(
            "chunked prefill with kv_int8 pools: per-token scatters "
            "would need page-scale growth on the gather path; admit "
            "long prompts via batched prefill (raise "
            "prefill_chunk_tokens) or serve with bf16 KV")
    K, C = tokens.shape
    page = cache["k"].shape[3]
    scratch = cache["k"].shape[2] - 1
    maxp = pages_rows.shape[1]
    D, KVH = cfg.head_dim, cfg.n_kv_heads
    group = cfg.n_heads // KVH
    ctx = maxp * page
    dev = tokens.device
    positions = start.long()[:, None] + torch.arange(C, device=dev)[None, :]
    sin, cos = rope_table(cfg, positions)
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    kpos = torch.arange(ctx, device=dev)
    mask = kpos[None, None, :] <= positions[:, :, None]   # causal over cache
    pr = pages_rows.long()
    pid = torch.gather(pr, 1, (positions // page).clamp(max=maxp - 1))
    in_chunk = (torch.arange(C, device=dev)[None, :]
                < chunk_lens.long()[:, None])
    pid = torch.where(in_chunk, pid, torch.full_like(pid, scratch))
    off = positions % page
    for i, layer in enumerate(_layers(params["layers"], cfg.n_layers)):
        layer = _deq_layer(layer, cfg.dtype)
        normed = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
        q, k, v = _qkv(normed, layer, cfg, sin, cos)   # [K, C, H/KVH, D]
        kp, vp = cache["k"][i], cache["v"][i]          # [KVH, P, page, D]
        kp[:, pid, off] = k.permute(2, 0, 1, 3).to(kp.dtype)
        vp[:, pid, off] = v.permute(2, 0, 1, 3).to(vp.dtype)
        kk = kp[:, pr].permute(1, 2, 3, 0, 4).reshape(K, ctx, KVH, D)
        vv = vp[:, pr].permute(1, 2, 3, 0, 4).reshape(K, ctx, KVH, D)
        kk = kk.repeat_interleave(group, dim=2).float()
        vv = vv.repeat_interleave(group, dim=2).float()
        s = torch.einsum("kchd,kshd->khcs", q.float(), kk) * (D ** -0.5)
        if cfg.logits_soft_cap is not None:
            s = cfg.logits_soft_cap * torch.tanh(s / cfg.logits_soft_cap)
        s = torch.where(mask[:, None], s, NEG_INF)
        probs = torch.softmax(s, dim=-1)
        out = torch.einsum("khcs,kshd->kchd", probs, vv).to(cfg.dtype)
        wo = layer["attn"]["wo"]
        out = out.reshape(K, C, -1) @ wo.to(cfg.dtype).reshape(
            -1, wo.shape[-1])
        h = x + out
        x = h + _mlp_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps),
                           layer, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    last = x[torch.arange(K, device=dev), (chunk_lens.long() - 1).clamp(min=0)]
    logits = _head_matmul(last, _head(params, cfg), cfg)
    return logits.float(), cache


def _ragged_lora_layer(x, layer, stk, tok_adapter, lora_scale,
                       cfg: LlamaConfig, cache, i, sin, cos, row_slot,
                       row_start, row_len, row_off, block_tables,
                       max_row_tokens, scales):
    """One layer of the segmented-LoRA ragged body: the base body's ops
    and cast points with each targeted projection's per-token delta
    added (qkv jointly, before RoPE).  A delta of the scratch page is
    exactly 0.0 and x + 0.0 is exact, so null rows keep the base bytes.
    Returns (x, k [T, KVH, hd], v)."""
    from ray_tpu_torch.ops.segmented_lora import segmented_lora_delta

    layer = _deq_layer(layer, cfg.dtype)
    dt = cfg.dtype
    T = x.shape[0]
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def delta(name, inp):
        if name not in stk:
            return None
        return segmented_lora_delta(inp, stk[name]["a"], stk[name]["b"],
                                    tok_adapter, lora_scale, dt)

    normed = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
    a = layer["attn"]
    x1 = normed[None]
    dqkv = delta("qkv", normed)                     # joint, before RoPE
    if "wqkv" in a:
        qkv = _proj(x1, a["wqkv"], dt)
        if dqkv is not None:
            qkv = qkv + dqkv[None]
        q = qkv[..., :H * hd].reshape(1, T, H, hd)
        k = qkv[..., H * hd:(H + KVH) * hd].reshape(1, T, KVH, hd)
        # v is a column slice of qkv: the kernels take contiguous rows.
        v = qkv[..., (H + KVH) * hd:].reshape(1, T, KVH, hd).contiguous()
    else:
        q = _proj(x1, a["wq"], dt)
        k = _proj(x1, a["wk"], dt)
        v = _proj(x1, a["wv"], dt)
        if dqkv is not None:
            dq, dk, dv = dqkv.split([H * hd, KVH * hd, KVH * hd], dim=-1)
            q = q + dq.reshape(1, T, H, hd)
            k = k + dk.reshape(1, T, KVH, hd)
            v = v + dv.reshape(1, T, KVH, hd)
    q, k1, v1 = apply_rope(q, sin, cos)[0], apply_rope(k, sin, cos)[0], v[0]
    out = ragged_paged_attention(
        q, k1, v1, cache["k"], cache["v"], i, row_slot, row_start, row_len,
        row_off, block_tables, soft_cap=cfg.logits_soft_cap,
        max_row_tokens=max_row_tokens, **scales)    # [T, H, hd] f32
    attn_f = out.to(dt).reshape(T, -1)              # the base cast point
    wo = a["wo"]
    o = attn_f @ wo.to(dt).reshape(-1, wo.shape[-1])
    do = delta("o", attn_f)
    if do is not None:
        o = o + do
    h = x + o
    xm = rms_norm(h, layer["ln_mlp"], cfg.norm_eps)
    m = layer["mlp"]
    if "w_gateup" in m:
        gate, up = (xm @ m["w_gateup"].to(dt)).chunk(2, dim=-1)
    else:
        gate = xm @ m["w_gate"].to(dt)
        up = xm @ m["w_up"].to(dt)
    dg, du = delta("gate", xm), delta("up", xm)
    if dg is not None:
        gate = gate + dg
    if du is not None:
        up = up + du
    act = F.silu(gate) * up
    down = act @ m["w_down"].to(dt)
    dd = delta("down", act)
    if dd is not None:
        down = down + dd
    return h + down, k1, v1


def ragged_step_paged(params: Params, tokens: torch.Tensor,
                      tok_pos: torch.Tensor, row_slot: torch.Tensor,
                      row_start: torch.Tensor, row_len: torch.Tensor,
                      row_off: torch.Tensor, block_tables: torch.Tensor,
                      cfg: LlamaConfig, cache: Dict[str, torch.Tensor], *,
                      max_row_tokens: Optional[int] = None,
                      lora: Optional[Any] = None,
                      logit_idx: Optional[torch.Tensor] = None):
    """One unified serving step over a ragged batch mixing prefill
    chunks (row_len > 1) and decode rows (row_len == 1).

    tokens/tok_pos [T] (the flat buffer and each token's absolute
    position), rows [R] (slot, start, len, off; len 0 = padding),
    block_tables [slots, maxp], all int32.  Every packed token attends to
    its slot's pooled past plus the causal prefix of its own row (kernel
    K4 per layer); the pools stay read-only in the layer loop and ONE K5
    launch after it appends every layer's fresh k/v, in place.  On int8
    pools K4 reads the page scales and K6 takes K5's place.

    Returns (logits [R, V] f32 at each row's last fresh token, cache);
    padding rows return garbage logits.  With ``logit_idx`` [Tv] it
    returns (logits [R, V], logits [Tv, V] at those buffer positions,
    cache), from one gather + norm + head matmul, so the first R rows
    equal the call without it.  With ``cfg.fused_decode`` each layer
    runs as one fused kernel (K8, ``fused_ragged_layer``); the append
    after the loop and ``logit_idx`` are the same.

    ``lora`` is an optional ``(stacks, tok_adapter, scale)`` triple
    (``ops/segmented_lora``): per-token segmented adapter deltas are
    added at every targeted projection, qkv before RoPE.  That body
    keeps the base body's ops and cast points, so a token whose adapter
    index gathers the pool's zero scratch page gets the base body's
    bytes.  It always runs unfused, even under ``cfg.fused_decode``."""
    _unported(cfg)
    quantized = "k_scale" in cache
    scales = _scale_kwargs(cache)
    T = tokens.shape[0]
    dt = cfg.dtype
    sin, cos = rope_table(cfg, tok_pos[None])      # [1, T, hd // 2]
    x = params["tok_embed"][tokens.long()].to(dt)   # [T, d]
    k_news, v_news = [], []
    layers = _layers(params["layers"], cfg.n_layers)
    if lora is not None:
        stacks, tok_adapter, lora_scale = lora
        stks = _layers(stacks, cfg.n_layers)
    for i, layer in enumerate(layers):
        if lora is not None:
            x, k1, v1 = _ragged_lora_layer(
                x, layer, stks[i], tok_adapter, lora_scale, cfg, cache, i,
                sin, cos, row_slot, row_start, row_len, row_off,
                block_tables, max_row_tokens, scales)
            k_news.append(k1)
            v_news.append(v1)
            continue
        if cfg.fused_decode:
            x, k1, v1 = fused_ragged_layer(
                x, layer, cache["k"], cache["v"], i, row_slot,
                row_start, row_len, row_off, block_tables, sin[0], cos[0],
                eps=cfg.norm_eps, n_heads=cfg.n_heads,
                n_kv_heads=cfg.n_kv_heads, soft_cap=cfg.logits_soft_cap,
                max_row_tokens=max_row_tokens, **scales)
            k_news.append(k1)
            v_news.append(v1)
            continue
        layer = _deq_layer(layer, cfg.dtype)
        normed = rms_norm(x, layer["ln_attn"], cfg.norm_eps)
        q, k, v = _qkv(normed[None], layer, cfg, sin, cos)
        q, k1, v1 = q[0], k[0], v[0]                # [T, H or KVH, hd]
        out = ragged_paged_attention(
            q, k1, v1, cache["k"], cache["v"], i, row_slot, row_start,
            row_len, row_off, block_tables, soft_cap=cfg.logits_soft_cap,
            max_row_tokens=max_row_tokens, **scales)  # [T, H, hd] f32
        # Round the f32 attention output to cfg.dtype BEFORE the o-proj:
        # the cast point of the prefill and decode paths.
        wo = layer["attn"]["wo"]
        out = out.to(dt).reshape(T, -1) @ wo.to(dt).reshape(-1, wo.shape[-1])
        h = x + out
        x = h + _mlp_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps),
                           layer, cfg)
        k_news.append(k1)
        v_news.append(v1)
    if quantized:
        ragged_paged_append_quantized(
            cache["k"], cache["v"], cache["k_scale"], cache["v_scale"],
            torch.stack(k_news), torch.stack(v_news), row_slot, row_start,
            row_len, row_off, block_tables, max_row_tokens=max_row_tokens)
    else:
        ragged_paged_append(cache["k"], cache["v"],
                            torch.stack(k_news).to(cache["k"].dtype),
                            torch.stack(v_news).to(cache["v"].dtype),
                            row_slot, row_start, row_len, row_off,
                            block_tables, max_row_tokens=max_row_tokens)
    last = (row_off.long() + row_len.long().clamp(min=1) - 1).clamp(0, T - 1)
    head = _head(params, cfg)
    if logit_idx is None:
        x = rms_norm(x[last], params["final_norm"], cfg.norm_eps)
        return _head_matmul(x, head, cfg).float(), cache
    R = row_slot.shape[0]
    sel = torch.cat([last, logit_idx.long().clamp(0, T - 1)])
    x = rms_norm(x[sel], params["final_norm"], cfg.norm_eps)
    logits = _head_matmul(x, head, cfg).float()
    return logits[:R], logits[R:], cache
