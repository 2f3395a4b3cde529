"""Vision Transformers (DINOv2, SigLIP, CLIP, ImageNet ViT-L) for the port (counterpart of ``openvla_probe_tpu/models/vit.py``).

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
block runs the unfused chain, each int8 linear through ``w8a8_matmul``. A
leaf wrapped for LoRA or multi-LoRA is not a per-channel int8 leaf, so its
pair stands the fused kernels down on either route and runs the unfused
chain, its base on the route (the JAX package's rule: it fuses a leaf only
where ``is_quantized`` holds).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_plain, vit_flash_attention
from ..ops.vit_mlp import fused_ln_w8a8, fused_mlp_residual
from ..parallel import tensor_parallel as tp

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
    def clip_vit_l(**kw) -> "ViTConfig":
        """vit_large_patch14_clip_224 (quick_gelu override, pre-norm, no patch bias)"""
        d = dict(hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
                 use_cls_token=True, pre_norm=True, patch_bias=False, act="quick_gelu")
        d.update(kw)
        return ViTConfig(**d)

    @staticmethod
    def in1k_vit_l(**kw) -> "ViTConfig":
        """vit_large_patch16_224.augreg_in21k_ft_in1k"""
        d = dict(patch_size=16, hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
                 use_cls_token=True, act="gelu")
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
    out = tp.matmul(patchify(pixels.to(w.dtype), cfg), w)
    if cfg.patch_bias:
        out = out + params["patch_embed"]["bias"]
    return out


def _block(cfg: ViTConfig, bp: Params, x: torch.Tensor, B: int, N: int) -> torch.Tensor:
    """One transformer block over flat [B*N, D] activations. On the "wi8"
    route, per-channel int8 qkv + proj leaves take `fused_ln_w8a8` and int8
    fc1 + fc2 leaves take `fused_mlp_residual` (the JAX package's routes under
    its kernel gates); the rest, and every leaf on the "w8a8" route, the
    unfused chain through `matmul_t`."""
    bp = dict(bp)
    Dh = cfg.head_dim
    D = x.shape[-1]
    eps = cfg.layer_norm_eps
    route = cfg.int8_matmul

    def fusable(*names):
        if route != "wi8" or not all(tp.int8_form(bp[n]) for n in names):
            return False
        # the fused kernels take no shard: a tp-placed pair is gathered whole first
        bp.update({n: tp.whole(bp[n]) for n in names})
        return True

    fused_linears = fusable("qkv_w", "proj_w")
    if fused_linears:
        qkv = fused_ln_w8a8(x, bp["qkv_w"], bp["qkv_b"],
                            ln=(bp["norm1_scale"], bp["norm1_bias"]), eps=eps)
    else:
        h = layer_norm(x, bp["norm1_scale"], bp["norm1_bias"], eps)
        # [B*N, 3D], or under tp this rank's heads of each of q, k and v
        qkv = tp.matmul(h, bp["qkv_w"], route) + tp.col_slice(bp["qkv_b"], bp["qkv_w"])
    # q/k/v stay strided views of qkv: the kernel reads them in place
    q, k, v = (t.reshape(B, N, -1, Dh) for t in qkv.split(qkv.shape[-1] // 3, dim=-1))
    if cfg.flash_attn:
        attn = vit_flash_attention(q, k, v)
    else:   # the JAX block's XLA branch: no mask
        attn = attention_plain(q, k, v, q.new_zeros(()), cfg.attn_scores_dtype)
    attn = tp.input_for(attn.reshape(B * N, -1), bp["proj_w"], bp["qkv_w"])
    if fused_linears:
        x = fused_ln_w8a8(attn, bp["proj_w"], bp["proj_b"], res=x,
                          ls=bp["ls1"] if cfg.use_layerscale else None)
    else:
        attn = tp.matmul(attn, bp["proj_w"], route) + bp["proj_b"]
        if cfg.use_layerscale:
            attn = attn * bp["ls1"]
        x = x + attn
    if fusable("fc1_w", "fc2_w"):
        ls2 = bp["ls2"] if cfg.use_layerscale else torch.ones((D,), dtype=x.dtype, device=x.device)
        return fused_mlp_residual(x, bp["norm2_scale"], bp["norm2_bias"], bp["fc1_w"],
                                  bp["fc1_b"], bp["fc2_w"], bp["fc2_b"], ls2, eps=eps,
                                  act=cfg.act)
    h = layer_norm(x, bp["norm2_scale"], bp["norm2_bias"], eps)
    h = _act(tp.matmul(h, bp["fc1_w"], route) + tp.col_slice(bp["fc1_b"], bp["fc1_w"]), cfg.act)
    h = tp.matmul(tp.input_for(h, bp["fc2_w"], bp["fc1_w"]), bp["fc2_w"], route) + bp["fc2_b"]
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
        bp = tp.index_layer(blocks, li)
        x2 = checkpoint(_block, cfg, bp, x2, B, N, use_reentrant=False) if remat else \
            _block(cfg, bp, x2, B, N)
    return x2.reshape(B, N, D)[:, cfg.num_prefix_tokens:, :]


_TIMM_BLOCK_KEYS = {
    "norm1.weight": "norm1_scale",
    "norm1.bias": "norm1_bias",
    "attn.qkv.weight": "qkv_w",
    "attn.qkv.bias": "qkv_b",
    "attn.proj.weight": "proj_w",
    "attn.proj.bias": "proj_b",
    "norm2.weight": "norm2_scale",
    "norm2.bias": "norm2_bias",
    "mlp.fc1.weight": "fc1_w",
    "mlp.fc1.bias": "fc1_b",
    "mlp.fc2.weight": "fc2_w",
    "mlp.fc2.bias": "fc2_b",
    "ls1.gamma": "ls1",
    "ls2.gamma": "ls2",
    # the HF export renames LayerScale gamma -> scale_factor
    "ls1.scale_factor": "ls1",
    "ls2.scale_factor": "ls2",
}


def params_from_timm(state, cfg: ViTConfig, prefix: str = "", device="cuda") -> Params:
    """A timm VisionTransformer state (name -> tensor or numpy array) -> the
    layer-stacked tree on `device` in ``cfg.dtype``, one layer of one leaf on
    the host at a time (`safetensors_io.stack`)."""
    from .safetensors_io import stack, to_tensor

    if cfg.num_register_tokens and not cfg.no_embed_class and cfg.use_cls_token:
        # timm's reg-token models put pos_embed over [cls, reg, patches]; this
        # config family implements the HF Dinov2WithRegisters layout (pos over
        # [cls, patches], registers inserted after): a timm checkpoint would
        # load with a silently wrong pos table
        raise NotImplementedError(
            "timm import for register tokens with no_embed_class=False is a "
            "positional-embedding layout mismatch; use no_embed_class=True "
            "(timm dinov2-reg convention) or the HF import path"
        )

    def get(k):
        return to_tensor(state[prefix + k]).to(device=device, dtype=cfg.dtype)

    blocks: Params = {}
    for timm_key, ours in _TIMM_BLOCK_KEYS.items():
        if f"{prefix}blocks.0.{timm_key}" not in state:
            continue
        blocks[ours] = stack(lambda i, k=timm_key: state[f"{prefix}blocks.{i}.{k}"],
                             cfg.num_layers, cfg.dtype, device)
    p: Params = {
        "patch_embed": {"weight": get("patch_embed.proj.weight").reshape(cfg.hidden_size, -1)},
        "pos_embed": get("pos_embed"),
        "blocks": blocks,
    }
    if cfg.patch_bias:
        p["patch_embed"]["bias"] = get("patch_embed.proj.bias")
    if cfg.use_cls_token:
        p["cls_token"] = get("cls_token")
    if cfg.num_register_tokens:
        p["reg_token"] = get("reg_token")
    if cfg.pre_norm:
        p["norm_pre_scale"] = get("norm_pre.weight")
        p["norm_pre_bias"] = get("norm_pre.bias")
    return p
