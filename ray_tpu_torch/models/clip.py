"""CLIP: a dual-encoder contrastive vision-language model for training
(port of ``ray_tpu/models/clip.py``).

Plain functions on tensors, as in the JAX package: ``{"vision": a ViT
tree (models/vit.py), "text": {tok_embed, pos_embed, layers, ln_f_*},
"img_proj" [d_v, p], "txt_proj" [d_t, p], "logit_scale" (0-d)}`` with
the JAX package's key names and layouts, so ``bridge.params_from_jax``
is a pure copy.

The image tower is ``vit.encode``; the text tower is a stack of the
same pre-norm blocks, causal, features taken at each sequence's EOT
(the first position of its largest id), without rematerialisation as
in the JAX package.  ``forward`` projects and L2-normalises both (f32,
norm + 1e-8); ``contrastive_loss`` is the symmetric InfoNCE over the
batch.  Text attention is causal at S 77, below the flash kernel's S >=
256, so CLIP launches no kernel.

Over ranks the negatives are the global batch's.  ``contrastive_loss
(axis_name=...)`` is the JAX package's explicit form (local queries
against the keys all-gathered over the axis, labels offset by the
member's index, the mean over the axis), on the calling rank of a mesh.
Inside the data-parallel step the plain form declares the ``"global"``
split (``parallel/loss_split.py``) and returns this member's share of
the global-batch InfoNCE, which GSPMD computes for the JAX trainer.
Either way the keys go through ``allgather_grad``, so the negatives'
grads flow back to the members that own them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import vit as vit_lib
from ray_tpu_torch.models.llama import _layers
from ray_tpu_torch.parallel import collectives as C
from ray_tpu_torch.parallel import loss_split
from ray_tpu_torch.parallel.mesh import AxisName, Mesh, create_mesh

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49_408
    max_len: int = 77
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    vision: vit_lib.ViTConfig = dataclasses.field(
        default_factory=lambda: dataclasses.replace(
            vit_lib.VIT_L16, num_classes=0
        )
    )
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    proj_dim: int = 768
    logit_scale_init: float = 2.6592  # ln(1/0.07), the CLIP paper value


CLIP_L14_LIKE = CLIPConfig()
CLIP_TINY = CLIPConfig(
    vision=dataclasses.replace(vit_lib.VIT_TINY, num_classes=0),
    text=CLIPTextConfig(vocab_size=256, max_len=16, dim=64, n_layers=2,
                        n_heads=4, mlp_dim=128),
    proj_dim=32,
)

CONFIGS = {"clip-l": CLIP_L14_LIKE, "tiny": CLIP_TINY}


def logical_axes(cfg: CLIPConfig) -> Params:
    """The JAX package's logical axis names per leaf, which lay the
    params out over a mesh (``TorchTrainer(params_axes=...)``)."""
    t = {
        "tok_embed": ("vocab", "embed"),
        "pos_embed": ("seq", "embed"),
        "layers": vit_lib._layer_axes(),
        "ln_f_scale": ("embed",), "ln_f_bias": ("embed",),
    }
    return {
        "vision": vit_lib.logical_axes(cfg.vision),
        "text": t,
        "img_proj": ("embed", "proj"),
        "txt_proj": ("embed", "proj"),
        "logit_scale": (),
    }


def init_params(generator: torch.Generator, cfg: CLIPConfig,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random init from ``generator`` (on ``device``) into ``dtype``
    (default the text config's ``param_dtype``): the JAX package's tree
    and scaling; the draws differ."""
    dev = resolve_device(device)
    tc = cfg.text
    dt = dtype or tc.param_dtype
    D = tc.dim

    def trunc(shape, fan_in):
        return vit_lib.trunc_normal(generator, shape, fan_in, dev, dt)

    vision = vit_lib.init_params(generator, cfg.vision, dev, dtype)
    text: Params = {
        "tok_embed": trunc((tc.vocab_size, D), D),
        "pos_embed": trunc((tc.max_len, D), D),
        "layers": vit_lib.encoder_layers(generator, tc.n_layers, D,
                                         tc.n_heads, tc.mlp_dim, dev, dt),
        "ln_f_scale": torch.ones((D,), device=dev, dtype=dt),
        "ln_f_bias": torch.zeros((D,), device=dev, dtype=dt),
    }
    return {
        "vision": vision,
        "text": text,
        "img_proj": trunc((cfg.vision.dim, cfg.proj_dim), cfg.vision.dim),
        "txt_proj": trunc((D, cfg.proj_dim), D),
        "logit_scale": torch.tensor(cfg.logit_scale_init, device=dev,
                                    dtype=dt),
    }


def _text_layer(tc: CLIPTextConfig, x: torch.Tensor,
                layer: Params) -> torch.Tensor:
    return vit_lib.encoder_block(x, layer, tc.n_heads, tc.norm_eps, tc.dtype,
                                 causal=True)


def encode_text(params: Params, tokens: torch.Tensor,
                cfg: CLIPConfig) -> torch.Tensor:
    """(B, S) token ids → (B, D) features taken at each sequence's EOT
    position (CLIP convention: the highest token id marks EOT; the first
    one if it repeats)."""
    tc = cfg.text
    tp = params["text"]
    x = tp["tok_embed"][tokens.long()].to(tc.dtype)
    x = x + tp["pos_embed"].to(tc.dtype)[None, :tokens.shape[1]]
    for layer in _layers(tp["layers"], tc.n_layers):
        x = _text_layer(tc, x, layer)
    x = vit_lib.layer_norm(x, tp["ln_f_scale"], tp["ln_f_bias"], tc.norm_eps)
    eot = tokens.argmax(dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), eot]


def encode_image(params: Params, images: torch.Tensor,
                 cfg: CLIPConfig) -> torch.Tensor:
    return vit_lib.encode(params["vision"], images, cfg.vision)


def forward(params: Params, images: torch.Tensor, tokens: torch.Tensor,
            cfg: CLIPConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (img_emb, txt_emb), both L2-normalised (B, proj_dim) float32."""
    img = encode_image(params, images, cfg).float()
    txt = encode_text(params, tokens, cfg).float()
    img = img @ params["img_proj"].float()
    txt = txt @ params["txt_proj"].float()
    img = img / (torch.linalg.vector_norm(img, dim=-1, keepdim=True) + 1e-8)
    txt = txt / (torch.linalg.vector_norm(txt, dim=-1, keepdim=True) + 1e-8)
    return img, txt


def _info_nce(img, txt, all_img, all_txt, offset, scale):
    """Local queries against the keys of every member, both directions."""
    labels = offset + torch.arange(img.shape[0], device=img.device)

    def nll(logits):
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, labels[:, None]).mean()

    return 0.5 * (nll(scale * (img @ all_txt.T))
                  + nll(scale * (txt @ all_img.T)))


def contrastive_loss(params: Params, images: torch.Tensor,
                     tokens: torch.Tensor, cfg: CLIPConfig,
                     axis_name: Optional[AxisName] = None, *,
                     mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Symmetric InfoNCE at the scale exp(``logit_scale``).

    With ``axis_name``: the JAX explicit form on this rank of ``mesh``
    (default: the data-parallel step's mesh, else the default process
    group's ``create_mesh()``; a world of one rank without one): the
    embeddings are all-gathered over the axis so that the negatives span
    the global batch, and the loss is the mean over the axis, whose
    backward hands each member its share.  Without it: the batch's loss,
    or inside the data-parallel step this member's share of the global
    batch's (the ``"global"`` split; with one member, the batch's loss
    through a one-rank all-gather)."""
    img, txt = forward(params, images, tokens, cfg)
    scale = torch.exp(params["logit_scale"].float())
    if axis_name is not None:
        if mesh is None:
            group = loss_split.current()
            mesh = group.mesh if group is not None else create_mesh()
        all_img = C.allgather_grad(img, axis_name, mesh=mesh)
        all_txt = C.allgather_grad(txt, axis_name, mesh=mesh)
        offset = mesh.axis_index(axis_name) * img.shape[0]
        loss = _info_nce(img, txt, all_img, all_txt, offset, scale)
        return C.reduce_from(loss, axis_name, mesh=mesh) / \
            mesh.axis_size(axis_name)
    group = loss_split.declare("global")
    if group is None:
        return _info_nce(img, txt, img, txt, 0, scale)
    loss = _info_nce(img, txt, group.gather_grad(img),
                     group.gather_grad(txt), group.index * img.shape[0],
                     scale)
    return loss * (img.shape[0] / group.rows)
