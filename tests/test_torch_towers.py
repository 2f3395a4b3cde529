"""The CLIP ViT-L and ImageNet ViT-L towers (`ViTConfig.clip_vit_l`,
`ViTConfig.in1k_vit_l`) and the catalog ids over them, against the JAX
package on the CPU at tiny width (the configs' own flags: CLIP's pre-norm,
patch without bias and quick GELU; ImageNet's 16-pixel patches).

The JAX side runs with its kernels in interpret mode (OVLA_PALLAS=1,
OVLA_PALLAS_INTERPRET=1, monkeypatch only), as
``tests/test_torch_vit_llama.py``; the int8 towers on the pallas tier's
route under ``test_torch_pallas_tier._JaxKernelsOn`` (the fused LayerNorm /
MLP kernels, interpreted). Tolerances: fp32 atol 1e-4 (the same fp32 sums in
another order through a few blocks); int8 towers 2e-3 of the largest |want|
(the activation codes of a LayerNorm summed in another order may sit one
step apart at a rounding tie).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import catalog as jcat
from openvla_probe_tpu.models import vit as jvit
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import catalog as tcat
from openvla_probe_tpu_torch.models import vit as tvit
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_pallas_tier import _JaxKernelsOn

ATOL = 1e-4
TINY = dict(hidden_size=32, num_layers=3, num_heads=2, mlp_dim=64)
TOWERS = {
    "clip": (jvit.ViTConfig.clip_vit_l(image_size=28, **TINY), 28),
    "clip336": (jvit.ViTConfig.clip_vit_l(image_size=42, **TINY), 42),   # 9 patches + CLS
    "in1k": (jvit.ViTConfig.in1k_vit_l(image_size=32, **TINY), 32),      # 16-pixel patches
}


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("OVLA_PALLAS", "1")
    monkeypatch.setenv("OVLA_PALLAS_INTERPRET", "1")


def _params(jcfg, seed):
    """Random tower weights with non-trivial norms and biases."""
    params = jvit.init_params(jcfg, jax.random.key(seed))
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + 0.1 * r.normal(size=a.shape).astype(np.float32),
                        params)


def _tcfg(jcfg):
    return tvit.ViTConfig(**convert._fields(jcfg, tvit.ViTConfig))


@pytest.mark.parametrize("name", list(TOWERS))
def test_tower_configs_match_jax(name):
    jcfg, _ = TOWERS[name]
    tcfg = _tcfg(jcfg)
    full = {"clip": tvit.ViTConfig.clip_vit_l, "clip336": tvit.ViTConfig.clip_vit_l,
            "in1k": tvit.ViTConfig.in1k_vit_l}[name]
    assert tcfg == full(image_size=jcfg.image_size, **TINY)
    assert (tcfg.pre_norm, tcfg.patch_bias, tcfg.act, tcfg.patch_size) == \
        (jcfg.pre_norm, jcfg.patch_bias, jcfg.act, jcfg.patch_size)


@pytest.mark.parametrize("name", list(TOWERS))
def test_forward_features_match_jax(name, jax_kernels):
    jcfg, hw = TOWERS[name]
    tcfg = _tcfg(jcfg)
    params = _params(jcfg, 1)
    tparams = convert._convert(params, convert.vit_param_spec(tcfg), "", torch.device("cpu"))
    pixels = np.random.default_rng(2).normal(size=(2, 3, hw, hw)).astype(np.float32)
    want = np.asarray(jvit.forward_features(jax.tree.map(jnp.asarray, params), jcfg,
                                            jnp.asarray(pixels)))
    got = tvit.forward_features(tparams, tcfg, torch.from_numpy(pixels))
    assert got.shape == want.shape == (2, jcfg.num_patches, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("name", ["clip", "in1k"])
def test_int8_tower_on_the_pallas_route_matches_jax(name):
    """TURBO_QUANT_SUFFIXES int8 linears on the wi8 route: each block's LN1 +
    qkv, proj and MLP halves as the fused w8a8 kernels (their plain
    versions here; quick GELU inside the fused MLP for CLIP)."""
    jcfg, hw = TOWERS[name]
    tcfg = _tcfg(jcfg)
    params = jlin.quantize_params(_params(jcfg, 3), suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8)
    tparams = convert._convert(jax.tree.map(np.asarray, params),
                               convert._quantized_spec(convert.vit_param_spec(tcfg),
                                                       tlin.TURBO_QUANT_SUFFIXES, 8),
                               "", torch.device("cpu"))
    pixels = np.random.default_rng(4).normal(size=(2, 3, hw, hw)).astype(np.float32)
    with _JaxKernelsOn():
        want = np.asarray(jvit.forward_features(jax.tree.map(jnp.asarray, params), jcfg,
                                                jnp.asarray(pixels)))
    got = tvit.forward_features(tparams, tcfg, torch.from_numpy(pixels))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-3 * np.abs(want).max())


def test_clip_params_from_timm_match_jax():
    """A timm CLIP state (norm_pre, no patch bias) as the JAX package reads it."""
    jcfg, _ = TOWERS["clip"]
    tcfg = _tcfg(jcfg)
    r = np.random.default_rng(5)
    D, F, L, p = 32, 64, 3, 14
    state = {"patch_embed.proj.weight": r.normal(size=(D, 3, p, p)),
             "pos_embed": r.normal(size=(1, 5, D)), "cls_token": r.normal(size=(1, 1, D)),
             "norm_pre.weight": r.normal(size=D), "norm_pre.bias": r.normal(size=D)}
    shapes = {"norm1.weight": (D,), "norm1.bias": (D,), "attn.qkv.weight": (3 * D, D),
              "attn.qkv.bias": (3 * D,), "attn.proj.weight": (D, D), "attn.proj.bias": (D,),
              "norm2.weight": (D,), "norm2.bias": (D,), "mlp.fc1.weight": (F, D),
              "mlp.fc1.bias": (F,), "mlp.fc2.weight": (D, F), "mlp.fc2.bias": (D,)}
    for i in range(L):
        for k, s in shapes.items():
            state[f"blocks.{i}.{k}"] = r.normal(size=s)
    state = {k: v.astype(np.float32) for k, v in state.items()}
    want = jvit.params_from_timm(state, jcfg)
    got = tvit.params_from_timm(state, tcfg, device="cpu")
    assert "bias" not in got["patch_embed"] and "norm_pre_scale" in got
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        node = got
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf), err_msg=str(path))


@pytest.mark.parametrize("vision_id", ["clip-vit-l", "clip-vit-l-336px", "in1k-vit-l",
                                       "dinoclip-vit-l-336px"])
def test_catalog_towers_match_jax(vision_id):
    """The ids resolve to config_from_jax of the JAX entries (full width):
    CLIP ViT-L/14 at 224 and 336 px (257 and 577 tokens at Dh 64), the
    ImageNet ViT-L/16 (197), and the DINOv2 + CLIP pair at 336 px."""
    tcfg, timg, _ = tcat.build_vlm_config(vision_id, "llama2-7b-pure", "gelu-mlp", "letterbox")
    jcfg, jimg, _ = jcat.build_vlm_config(vision_id, "llama2-7b-pure", "gelu-mlp", "letterbox")
    assert tcfg == convert.config_from_jax(jcfg)
    assert [tuple(s.input_size) for s in timg.specs] == [tuple(s.input_size) for s in jimg.specs]
    tokens = {"clip-vit-l": [257], "clip-vit-l-336px": [577], "in1k-vit-l": [197],
              "dinoclip-vit-l-336px": [577, 577]}[vision_id]
    assert [v.num_patches + v.num_prefix_tokens - v.num_register_tokens
            for v in tcfg.vision] == tokens
    assert all(v.head_dim == 64 for v in tcfg.vision)
