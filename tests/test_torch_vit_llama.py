"""Port towers, projector and Llama trunk vs the JAX package on the CPU, at
tiny fp32 sizes, with the JAX kernels engaged in interpret mode
(OVLA_PALLAS=1, OVLA_PALLAS_INTERPRET=1, set through monkeypatch only).

Tolerance: fp32 atol 1e-4 (the same fp32 sums taken in another order, through
a few layers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import projector as jproj
from openvla_probe_tpu.models import vit as jvit
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import projector as tproj
from openvla_probe_tpu_torch.models import vit as tvit

ATOL = 1e-4


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("OVLA_PALLAS", "1")
    monkeypatch.setenv("OVLA_PALLAS_INTERPRET", "1")


def _tree(params, spec):
    return convert._convert(jax.tree.map(np.asarray, params), spec, "", torch.device("cpu"))


@pytest.mark.parametrize("jcfg", [
    jvit.ViTConfig.tiny(num_register_tokens=2, no_embed_class=True, use_layerscale=True),
    jvit.ViTConfig.tiny(use_cls_token=False, act="gelu_tanh"),
    jvit.ViTConfig.tiny(num_register_tokens=2, no_embed_class=False, use_layerscale=True),
], ids=["dinov2-reg", "siglip", "hf-dinov2-reg"])
def test_forward_features_matches_jax(jcfg, jax_kernels):
    params = jvit.init_params(jcfg, jax.random.key(1))
    # non-trivial norms and biases, so every leaf is exercised
    r = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: a + 0.1 * r.normal(size=a.shape).astype(np.float32), params)
    tcfg = tvit.ViTConfig(**convert._fields(jcfg, tvit.ViTConfig))
    pixels = np.random.default_rng(0).normal(size=(2, 3, 28, 28)).astype(np.float32)
    want = np.asarray(jvit.forward_features(params, jcfg, jnp.asarray(pixels)))
    got = tvit.forward_features(_tree(params, convert.vit_param_spec(tcfg)), tcfg,
                                torch.from_numpy(pixels))
    assert got.shape == want.shape == (2, jcfg.num_patches, jcfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


@pytest.mark.parametrize("arch", ["fused-gelu-mlp", "gelu-mlp", "linear"])
def test_projector_matches_jax(arch):
    params = jproj.init_params(arch, 24, 16, jax.random.key(2))
    x = np.random.default_rng(1).normal(size=(2, 4, 24)).astype(np.float32)
    want = np.asarray(jproj.forward(params, arch, jnp.asarray(x)))
    got = tproj.forward(_tree(params, convert.projector_param_spec(arch, 24, 16, torch.float32)),
                        arch, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.fixture(scope="module")
def trunk():
    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig(**convert._fields(jcfg, tllama.LlamaConfig))
    params = jllama.init_params(jcfg, jax.random.key(3))
    return jcfg, tcfg, params, _tree(params, convert.llama_param_spec(tcfg))


def _prompt(B, T, D, seed):
    r = np.random.default_rng(seed)
    x = r.normal(size=(B, T, D)).astype(np.float32)
    am = np.ones((B, T), np.int32)
    am[1, T - 9:] = 0          # right-padded row
    return x, am


def test_forward_uncached_matches_jax(trunk, jax_kernels):
    jcfg, tcfg, jp, tp = trunk
    B, T = 2, 68               # T >= 64: the flash kernel gate engages on both sides
    x, am = _prompt(B, T, jcfg.hidden_size, 4)
    pos = np.broadcast_to(np.arange(T), (B, T))
    want = jllama.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(am), jnp.asarray(pos))
    got = tllama.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(am),
                         torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)


def test_cached_prefill_and_decode_step_match_jax(trunk, jax_kernels):
    """Cached prefill at a zero offset (flash kernel) into an S-slot stacked
    cache, then one decode step written at slot T with RoPE position mm_len."""
    jcfg, tcfg, jp, tp = trunk
    B, T, S = 2, 68, 71
    x, am = _prompt(B, T, jcfg.hidden_size, 5)
    am_S = np.pad(am, ((0, 0), (0, S - T)))
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    jcache = jllama.KVCache.zeros(jcfg, B, S)
    want = jllama.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(am_S), jnp.asarray(pos),
                          cache=jcache, cache_index=jnp.int32(0), static_zero_offset=True)
    tcache = tllama.KVCache.zeros(tcfg, B, S)
    got = tllama.forward(tp, tcfg, torch.from_numpy(x), torch.from_numpy(am_S),
                         torch.from_numpy(pos), cache=tcache, cache_index=0,
                         static_zero_offset=True)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(want["cache"].k), atol=ATOL)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(want["cache"].v), atol=ATOL)

    mm_len = am.sum(1)
    e = np.random.default_rng(6).normal(size=(B, 1, jcfg.hidden_size)).astype(np.float32)
    slots = np.arange(S)[None]
    valid = ((slots < mm_len[:, None]) | (slots == T)).astype(np.int32)
    step_pos = mm_len[:, None].astype(np.int64)
    want2 = jllama.forward(jp, jcfg, jnp.asarray(e), jnp.asarray(valid), jnp.asarray(step_pos),
                           cache=want["cache"], cache_index=jnp.int32(T))
    got2 = tllama.forward(tp, tcfg, torch.from_numpy(e), torch.from_numpy(valid),
                          torch.from_numpy(step_pos), cache=tcache, cache_index=T)
    np.testing.assert_allclose(got2["logits"].numpy(), np.asarray(want2["logits"]), atol=ATOL)
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(want2["cache"].k), atol=ATOL)


def test_bf16_norm_and_rope_match_jax():
    """RMSNorm casts to bf16 BEFORE the weight multiply; RoPE rotates in fp32."""
    r = np.random.default_rng(7)
    x = jnp.asarray(r.normal(size=(2, 5, 64)), jnp.bfloat16)
    w = jnp.asarray(1 + 0.1 * r.normal(size=(64,)), jnp.bfloat16)
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    tw = torch.from_numpy(np.array(w.astype(jnp.float32))).bfloat16()
    want = np.asarray(jllama.rms_norm(x, w, 1e-5).astype(jnp.float32))
    got = tllama.rms_norm(tx, tw, 1e-5).float().numpy()
    np.testing.assert_array_equal(got, want)

    jcfg = jllama.LlamaConfig.tiny()
    tcfg = tllama.LlamaConfig(**convert._fields(jcfg, tllama.LlamaConfig))
    pos = np.arange(10)[None] + np.array([[0], [37]])
    jcos, jsin = jllama.rope_tables(jcfg, jnp.asarray(pos))
    tcos, tsin = tllama.rope_tables(tcfg, torch.from_numpy(pos))
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-6)
