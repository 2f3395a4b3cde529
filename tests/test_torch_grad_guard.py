"""Kernel wrappers refuse to cut gradients, on every device.

A kernel wrapper fills its output outside autograd, so while autograd
records, an input that requires grad makes every wrapper raise (naming the
differentiable route), here on the CPU as on the card; under
``torch.no_grad()`` the same call runs. ``vlm.forward`` trains with
``flash_attn=False`` (the plain attention, the JAX package's training route)
and raises with the flash kernels on. ``vit_flash_attention`` takes any
token count: at N = 1100 it matches the JAX kernel in interpret mode within
1e-5 (the same fp32 function, sums in another order). Under grad, the routes
of mix leaves and of grouped-int4 leaves on the w8a8 route carry their STE:
a mix leaf's int4 copy (M <= 32) and a grouped-int4 leaf off the kernel gate
at decode M take ``w4a8_grouped`` with the ``w4a8_dx`` backward, a mix
leaf's int8 copy (M > 32) the w8a8 STE, and grouped int4 above M = 32 the
requant route's STE.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvla_probe_tpu.ops import attention as jattn
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vlm
from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import decode_attention as tdec
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.ops import rmsnorm_quant as trmsq
from openvla_probe_tpu_torch.ops import vit_mlp as tmlp
from openvla_probe_tpu_torch.training import lora
from openvla_probe_tpu_torch.training.train_state import tree_leaves
from openvla_probe_tpu_torch.training.train_step import cross_entropy_loss


def _r(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


def _calls():
    """name -> (function, a maker of its args); the first float argument is the one
    that requires grad."""
    B, T, H, D = 1, 6, 2, 8
    valid = torch.ones((B, T), dtype=torch.int32)
    w8 = tlin.quantize_weight(_r(16, 32) * 0.05)
    w4 = tlin.quantize_weight_int4(_r(128, 128) * 0.05)
    nib = tlin.quantize_weight_nibble(_r(16, 32) * 0.05)
    kq = torch.randint(-127, 128, (2, B, T, H * D), dtype=torch.int8)
    ks = torch.rand((2, B, T, H)) + 0.1
    kq4 = kq[0].reshape(B, T, H, D)
    fc1, fc2 = tlin.quantize_weight(_r(64, 32) * 0.05), tlin.quantize_weight(_r(32, 64) * 0.05)
    return {
        "flash_attention": (tattn.flash_attention,
                            lambda x: (x(B, T, H, D), _r(B, T, H, D), _r(B, T, H, D), valid)),
        "flash_attention_blockwise": (tattn.flash_attention_blockwise,
                                      lambda x: (x(B, T, H, D), _r(B, T, H, D), _r(B, T, H, D),
                                                 valid)),
        "vit_flash_attention": (tattn.vit_flash_attention,
                                lambda x: (x(B, T, H, D), _r(B, T, H, D), _r(B, T, H, D))),
        "decode_attention": (tattn.decode_attention,
                             lambda x: (x(B, 1, H, D), _r(B, T, H, D), _r(B, T, H, D), valid, 3)),
        "decode_flash_attention": (tdec.decode_flash_attention,
                                   lambda x: (x(B, 1, H, D), _r(B, T, H, D), _r(B, T, H, D),
                                              _r(B, 2, H, D), _r(B, 2, H, D), valid,
                                              torch.ones((B, 2), dtype=torch.int32))),
        "stacked_decode_attention_i8": (tdec.stacked_decode_attention_i8,
                                        lambda x: (x(B, 1, H, D), kq, ks, kq, ks, valid, 1)),
        "wi8_matmul": (tlin.wi8_matmul, lambda x: (x(4, 32), w8["q"], w8["s"])),
        "w8a8_matmul": (tlin.w8a8_matmul, lambda x: (x(4, 32), w8)),
        "nib_hi_dot": (tlin.nib_hi_dot, lambda x: (x(4, 32), nib["hi"], nib["s"])),
        "w4a8_matmul": (tlin.w4a8_matmul, lambda x: (x(4, 128), w4["q"], w4["s"])),
        "w4a8_dx": (tlin.w4a8_dx, lambda x: (x(4, 128), w4["q"], w4["s"])),
        "w4a8_requant": (tlin.w4a8_requant, lambda x: (x(4, 128), w4["q"], w4["s"])),
        "w4a8_grouped": (tlin.w4a8_grouped, lambda x: (x(4, 128), w4["q"], w4["s"])),
        "split_attention_i8": (tdec.split_attention_i8,
                               lambda x: (x(B, 1, H, D), kq4, ks[0], kq4, ks[0], _r(B, 2, H, D),
                                          _r(B, 2, H, D), valid,
                                          torch.ones((B, 2), dtype=torch.int32))),
        "rms_norm_quant": (trmsq.rms_norm_quant, lambda x: (x(4, 32), torch.ones(32), 1e-5)),
        "fused_ln_w8a8": (tmlp.fused_ln_w8a8, lambda x: (x(4, 32), w8, torch.zeros(16))),
        "fused_mlp_residual": (tmlp.fused_mlp_residual,
                               lambda x: (x(4, 32), torch.ones(32), torch.zeros(32), fc1,
                                          torch.zeros(64), fc2, torch.zeros(32), torch.ones(32))),
    }


@pytest.mark.parametrize("name", list(_calls()))
def test_wrapper_raises_under_grad_and_runs_without(name):
    fn, build = _calls()[name]
    args = build(lambda *shape: _r(*shape).requires_grad_(True))
    with pytest.raises(RuntimeError, match=f"{name.split('_attention')[0]}.*requires grad"):
        fn(*args)
    with torch.no_grad():
        out = fn(*args)
    assert not (out[0] if isinstance(out, tuple) else out).requires_grad
    fn(*build(_r))                      # no input requires grad: the call runs under grad mode


@pytest.mark.parametrize("M", [24, 40])
@pytest.mark.parametrize("form", ["mix", "int4"])
def test_slice4_routes_carry_their_ste(form, M):
    """matmul_t under grad: the kernel forward (its plain version here) and
    the stated dx for each route of a mix leaf and of grouped int4 on w8a8."""
    w = _r(128, 256, seed=1) * 0.05
    leaf = tlin.quantize_weight_mixed(w) if form == "mix" else tlin.quantize_weight_int4(w)
    q4, s4 = (leaf["q4"], leaf["s4"]) if form == "mix" else (leaf["q"], leaf["s"])
    x = _r(M, 256, seed=2).requires_grad_(True)
    g = _r(M, 128, seed=3)
    y = tlin.matmul_t(x, leaf, "w8a8")
    (dx,) = torch.autograd.grad(y, x, g)
    x0 = x.detach()
    if M <= tlin.NIB_HI_M_MAX:
        assert torch.equal(y, tlin.w4a8_grouped_plain(x0, q4, s4))
        assert torch.equal(dx, tlin.w4a8_dx(g, q4, s4))
    elif form == "mix":
        assert torch.equal(y, tlin.w8a8_matmul_plain(x0, tlin.int8_copy(leaf)))
        assert torch.equal(dx, tlin._int8_ste_dx(g, leaf["q"], leaf["s"]))
    else:
        assert torch.equal(y, tlin.w4a8_requant_plain(x0, q4, s4))
        assert torch.equal(dx, tlin._int8_ste_dx(g, *tlin.requant_int4_to_int8(q4, s4)))


def test_a_scale_that_requires_grad_raises_too():
    w = tlin.quantize_weight(_r(16, 32) * 0.05)
    w = {"q": w["q"], "s": w["s"].requires_grad_(True)}
    with pytest.raises(RuntimeError, match="w8a8_matmul_ste"):
        tlin.w8a8_matmul(_r(4, 32), w)


def test_vit_flash_attention_takes_more_than_1024_tokens():
    """N = 1100 on the CPU (the card's kernel loops over key chunks of 1024)
    against the JAX kernel in interpret mode."""
    B, N, H, D = 1, 1100, 2, 64
    q, k, v = (_r(B, N, H, D, seed=i) for i in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jattn.vit_flash_attention(
            jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), interpret=True))
    got = tattn.vit_flash_attention(q, k, v)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# --- vlm.forward under grad ---------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = vlm.VLMConfig.tiny()
    params = convert.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    T = 64                     # 1 + 4 patches + 63 = 68 >= 64: the prefill flash gate
    ids = torch.from_numpy(rng.integers(3, cfg.llm.vocab_size, (2, T)))
    ids[:, 0] = 1
    labels = torch.full((2, T), -100)
    labels[:, -9:-1] = ids[:, -9:-1]
    batch = dict(input_ids=ids, attn_mask=torch.ones((2, T), dtype=torch.int64),
                 pixel_values=_r(2, 6, 28, 28), labels=labels)
    return cfg, params, lora.LoRAConfig(r=4), batch


def _flash(cfg, llm: bool, vision: bool):
    return dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, flash_attn=llm),
        vision=tuple(dataclasses.replace(v, flash_attn=vision) for v in cfg.vision))


def _loss(cfg, params, lcfg, adapters, batch):
    leaves = [t.requires_grad_(True) for t in tree_leaves(adapters)]
    out = vlm.forward(lora.attach_lora(params, adapters, lcfg), cfg, **batch)
    return cross_entropy_loss(out["logits"], out["labels"]), out["logits"], leaves


def test_forward_trains_with_the_plain_attention(tiny):
    cfg, params, lcfg, batch = tiny
    adapters = lora.init_lora_params(params, lcfg, torch.Generator().manual_seed(1))
    loss, logits, leaves = _loss(_flash(cfg, False, False), params, lcfg, adapters, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    assert sum(int(bool((g != 0).any())) for g in grads) >= len(grads) // 2   # the B factors
    with torch.no_grad():    # the flash kernels' function, the same within fp32 rounding
        flash = vlm.forward(lora.attach_lora(params, adapters, lcfg), cfg, **batch)["logits"]
    assert cfg.llm.flash_attn and all(v.flash_attn for v in cfg.vision)
    torch.testing.assert_close(logits.detach(), flash, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("llm,vision,kernel", [(True, False, "flash_attention"),
                                               (False, True, "vit_flash_attention")])
def test_forward_with_a_flash_kernel_raises_under_grad(tiny, llm, vision, kernel):
    cfg, params, lcfg, batch = tiny
    adapters = lora.init_lora_params(params, lcfg, torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match=f"{kernel}.*flash_attn=False"):
        _loss(_flash(cfg, llm, vision), params, lcfg, adapters, batch)
