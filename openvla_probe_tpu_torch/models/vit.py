"""Vision Transformers (DINOv2 / SigLIP) for the port (counterpart of ``openvla_probe_tpu/models/vit.py``).

timm parameter layout (fused qkv, LayerScale gamma vectors, token order
[cls, reg, patches]), layer-stacked ``[L, ...]`` leaves and a Python loop over
the blocks. Features are the patch tokens of the second-to-last block, no
final norm, prefix tokens dropped (the reference's get_intermediate_layers(-2)
contract). Attention is the tower kernel (``ops.attention.vit_flash_attention``)
on every device, as the JAX package runs it under its kernel gate, or, with
``flash_attn=False`` (training: the kernel has no backward), the plain
attention of the JAX package's XLA branch; ``remat`` recomputes each block in
the backward pass. On the
int8 route "wi8" (the ``pallas*`` tiers: the JAX package's tower kernel gates
on) a block whose linears are per-channel int8 runs LN1 + qkv, proj +
LayerScale + residual, and the whole MLP half each as one fused w8a8 kernel
(``ops.vit_mlp``); grouped-int4 linears (bits=4 weights) stand the fused
kernels down, as in the JAX package, and go through ``matmul_t``: an MLP half
with an int4 fc1 and an int8 fc2 (SigLIP's ungroupable mlp dim) runs unfused.
On the route "w8a8" (the ``turbo`` tier: the tower kernel gates off) every
block runs the unfused chain, each int8 linear through ``w8a8_matmul``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_plain, vit_flash_attention
from ..ops.linear import index_layer, is_int8_per_channel, matmul_t
from ..ops.vit_mlp import fused_ln_w8a8, fused_mlp_residual

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    mlp_dim: int = 4096
    use_cls_token: bool = True
    num_register_tokens: int = 0
    no_embed_class: bool = False     # timm: prefix tokens get NO pos embed (dinov2-reg)
    use_layerscale: bool = False
    pre_norm: bool = False           # CLIP-style LN before blocks
    patch_bias: bool = True
    act: str = "gelu"                # gelu | gelu_tanh | quick_gelu
    layer_norm_eps: float = 1e-6
    dtype: torch.dtype = torch.float32
    attn_scores_dtype: torch.dtype = torch.float32  # bf16 = turbo (the tower kernel's scores are fp32)
    # the int8 linears' route: "wi8" (the fused tower kernels where a pair of
    # leaves is int8, wi8_matmul otherwise) or "w8a8" (unfused, w8a8_matmul);
    # the JAX package's OVLA_PALLAS_VITLIN / _VITMLP / _MATMUL gates
    int8_matmul: str = "wi8"
    # the tower kernel (the JAX package's OVLA_PALLAS_VITATTN); off, the plain
    # attention its training runs
    flash_attn: bool = True
    # recompute each block in backward (under grad)
    remat: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.use_cls_token else 0) + self.num_register_tokens

    @staticmethod
    def dinov2_vit_l(**kw) -> "ViTConfig":
        """vit_large_patch14_reg4_dinov2.lvd142m"""
        d = dict(hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
                 use_cls_token=True, num_register_tokens=4, no_embed_class=True,
                 use_layerscale=True, act="gelu")
        d.update(kw)
        return ViTConfig(**d)

    @staticmethod
    def siglip_so400m(**kw) -> "ViTConfig":
        """vit_so400m_patch14_siglip_224"""
        d = dict(hidden_size=1152, num_layers=27, num_heads=16, mlp_dim=4304,
                 use_cls_token=False, num_register_tokens=0, act="gelu_tanh")
        d.update(kw)
        return ViTConfig(**d)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        d = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                 num_heads=2, mlp_dim=64, use_cls_token=True)
        d.update(kw)
        return ViTConfig(**d)


def _act(x: torch.Tensor, kind: str) -> torch.Tensor:
    xf = x.float()
    if kind == "gelu":
        y = F.gelu(xf, approximate="none")     # exact erf GELU (DINOv2)
    elif kind == "gelu_tanh":
        y = F.gelu(xf, approximate="tanh")     # SigLIP
    elif kind == "quick_gelu":
        y = xf * torch.sigmoid(1.702 * xf)
    else:
        raise ValueError(f"unknown act {kind}")
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm in fp32 math, cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def patchify(pixels: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, 3, H, W] -> [B, N, 3*p*p], flattened channel-major then kernel rows,
    then cols (the conv weight's [D, 3, p, p] -> [D, 3*p*p] order)."""
    B = pixels.shape[0]
    p, g = cfg.patch_size, cfg.grid
    x = pixels.reshape(B, 3, g, p, g, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, g * g, 3 * p * p)


def embed_patches(params: Params, cfg: ViTConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Patch-embed as one matmul (not conv2d: cuDNN convolutions default to TF32)."""
    w = params["patch_embed"]["weight"]           # [D, 3*p*p]
    out = matmul_t(patchify(pixels.to(w.dtype), cfg), w)
    if cfg.patch_bias:
        out = out + params["patch_embed"]["bias"]
    return out


def _block(cfg: ViTConfig, bp: Params, x: torch.Tensor, B: int, N: int) -> torch.Tensor:
    """One transformer block over flat [B*N, D] activations. On the "wi8"
    route, per-channel int8 qkv + proj leaves take `fused_ln_w8a8` and int8
    fc1 + fc2 leaves take `fused_mlp_residual` (the JAX package's routes under
    its kernel gates); the rest, and every leaf on the "w8a8" route, the
    unfused chain through `matmul_t`."""
    H, Dh = cfg.num_heads, cfg.head_dim
    D = x.shape[-1]
    eps = cfg.layer_norm_eps
    route = cfg.int8_matmul

    def fusable(*names):
        return route == "wi8" and all(is_int8_per_channel(bp[n]) for n in names)

    fused_linears = fusable("qkv_w", "proj_w")
    if fused_linears:
        qkv = fused_ln_w8a8(x, bp["qkv_w"], bp["qkv_b"],
                            ln=(bp["norm1_scale"], bp["norm1_bias"]), eps=eps)
    else:
        h = layer_norm(x, bp["norm1_scale"], bp["norm1_bias"], eps)
        qkv = matmul_t(h, bp["qkv_w"], route) + bp["qkv_b"]      # [B*N, 3D]
    # q/k/v stay strided views of qkv: the kernel reads them in place
    q, k, v = (t.reshape(B, N, H, Dh) for t in qkv.split(D, dim=-1))
    if cfg.flash_attn:
        attn = vit_flash_attention(q, k, v)
    else:   # the JAX block's XLA branch: no mask
        attn = attention_plain(q, k, v, q.new_zeros(()), cfg.attn_scores_dtype)
    attn = attn.reshape(B * N, D)
    if fused_linears:
        x = fused_ln_w8a8(attn, bp["proj_w"], bp["proj_b"], res=x,
                          ls=bp["ls1"] if cfg.use_layerscale else None)
    else:
        attn = matmul_t(attn, bp["proj_w"], route) + bp["proj_b"]
        if cfg.use_layerscale:
            attn = attn * bp["ls1"]
        x = x + attn
    if fusable("fc1_w", "fc2_w"):
        ls2 = bp["ls2"] if cfg.use_layerscale else torch.ones((D,), dtype=x.dtype, device=x.device)
        return fused_mlp_residual(x, bp["norm2_scale"], bp["norm2_bias"], bp["fc1_w"],
                                  bp["fc1_b"], bp["fc2_w"], bp["fc2_b"], ls2, eps=eps,
                                  act=cfg.act)
    h = layer_norm(x, bp["norm2_scale"], bp["norm2_bias"], eps)
    h = _act(matmul_t(h, bp["fc1_w"], route) + bp["fc1_b"], cfg.act)
    h = matmul_t(h, bp["fc2_w"], route) + bp["fc2_b"]
    if cfg.use_layerscale:
        h = h * bp["ls2"]
    return x + h


def assemble_tokens(params: Params, cfg: ViTConfig, patches: torch.Tensor) -> torch.Tensor:
    """Prefix tokens + positional embedding (timm conventions).

    no_embed_class (dinov2-reg4): pos added to patches only, [cls, reg]
    prepended with no pos. Otherwise pos covers [cls?, patches] and register
    tokens (if any) are inserted after cls without pos (HF Dinov2WithRegisters)."""
    B, _, D = patches.shape
    pos = params["pos_embed"]
    if cfg.no_embed_class:
        x = patches + pos
        prefix = []
        if cfg.use_cls_token:
            prefix.append(params["cls_token"].expand(B, 1, D))
        if cfg.num_register_tokens:
            prefix.append(params["reg_token"].expand(B, cfg.num_register_tokens, D))
        return torch.cat(prefix + [x], dim=1) if prefix else x
    if cfg.use_cls_token:
        x = torch.cat([params["cls_token"].expand(B, 1, D), patches], dim=1) + pos
        if cfg.num_register_tokens:
            reg = params["reg_token"].expand(B, cfg.num_register_tokens, D)
            x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
        return x
    return patches + pos


def forward_features(
    params: Params,
    cfg: ViTConfig,
    pixels: torch.Tensor,
    layer_index: int = -2,
) -> torch.Tensor:
    """[B, 3, H, W] -> patch features [B, N, D] of block `layer_index`'s output
    (default the second-to-last: blocks 0..L-2 run), prefix tokens dropped,
    no final norm."""
    x = assemble_tokens(params, cfg, embed_patches(params, cfg, pixels))
    if cfg.pre_norm:
        x = layer_norm(x, params["norm_pre_scale"], params["norm_pre_bias"], cfg.layer_norm_eps)
    B, N, D = x.shape
    blocks = params["blocks"]
    x2 = x.reshape(B * N, D)
    remat = cfg.remat and torch.is_grad_enabled()
    for li in range(layer_index % cfg.num_layers + 1):
        bp = index_layer(blocks, li)
        x2 = checkpoint(_block, cfg, bp, x2, B, N, use_reentrant=False) if remat else \
            _block(cfg, bp, x2, B, N)
    return x2.reshape(B, N, D)[:, cfg.num_prefix_tokens:, :]
