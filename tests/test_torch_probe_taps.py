"""The probe taps (`collect_hidden_states`) of the port against the JAX package,
on the CPU at `VLMConfig.tiny()` sizes.

* `llama.forward` (uncached: pooled over attn_mask[:, :T]; cached: over ones;
  either with a `pool_mask`), `llama.prefill` (over attn_mask, or a
  `pool_mask`) and `vlm.forward` (multimodal and text-only): hidden_pooled
  [B, L+1, D] fp32 = [embeddings, layers 1..L-1, the final-normed last layer],
  each a masked mean over T, within 1e-5 + 1e-5 |want| of the JAX package's
  (fp32 throughout; the same sums in another order). The remat training
  path (`remat`, under grad) gives the same tap and passes gradients through
  it.
* `predict_action_from_image` with `collect_hidden_states=True` on every ported
  tier and weight form (parity, pallas, pallas_kv8, turbo over int8 weights,
  pallas over grouped int4, turbo over nibble weights), with the JAX kernels
  as the tier's own test file runs them: hidden_pooled pooled over
  [BOS | patches | prompt] without the trailing 29871, within the tier's
  tolerance of the JAX package's, relative to each layer's largest pooled
  value (TIERS: parity fp32 1e-5, found 2.2e-7; pallas and pallas_kv8 1e-3,
  their logits tolerance, found 1.3e-5; turbo, int4 and nibble 1e-2, found
  1.6e-3 to 2.3e-3: their activations are quantized at every linear, so an
  activation code at a rounding edge may land one step apart between the
  frameworks); the action tokens equal with the tap on and off, and equal to
  the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_int4 import int4_vlm
from tests.test_torch_pallas_tier import _JaxKernelsOn, _img_cfg
from tests.test_torch_turbo import jax_turbo

A = 7
P = 64            # T = 1 + 4 patches + 63 = 68 >= 64: the prefill flash gate engages
MODULE_TOL = 1e-5
# tier -> (serving tier, weight bits, init seed, vocab, hidden_pooled tolerance); the seeds
# and vocabularies of each tier's own test file, whose token checks they keep
TIERS = {
    "parity": ("parity", None, 0, 512, 1e-5),
    "pallas": ("pallas", 8, 0, 512, 1e-3),
    "pallas_kv8": ("pallas_kv8", 8, 0, 512, 1e-3),
    "turbo": ("turbo", 8, 5, 512, 1e-2),
    "pallas_int4": ("pallas", 4, 3, 400, 1e-2),
    "turbo_nibble": ("turbo", "nibble", 11, 512, 1e-2),
}


class _Parity:
    """The parity tier's JAX kernels: OVLA_PALLAS=1 in interpret mode."""

    def __enter__(self):
        self.mp = pytest.MonkeyPatch()
        self.mp.setenv("OVLA_PALLAS", "1")
        self.mp.setenv("OVLA_PALLAS_INTERPRET", "1")
        return self

    def __exit__(self, *exc):
        self.mp.undo()


def _jax_context(name: str):
    if name == "parity":
        return _Parity()
    if name == "turbo":
        return jax_turbo()
    if name == "turbo_nibble":
        return jax_turbo(rmsq=False)
    return _JaxKernelsOn()


def _inputs(vocab: int, B=3, seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (B, 40, 40, 3), dtype=np.uint8)
    plen = np.array([20, 35, 9][:B], np.int32)
    ids = np.zeros((B, P), np.int32)
    for b in range(B):
        ids[b, 0] = 1
        ids[b, 1:plen[b] - 1] = r.integers(3, vocab, plen[b] - 2)
        ids[b, plen[b] - 1] = 29871 % vocab
    q01 = r.uniform(-2, 0, A).astype(np.float32)
    q99 = r.uniform(0.5, 2, A).astype(np.float32)
    mask = np.array([True] * (A - 1) + [False])
    return img, ids, plen, q01, q99, mask


@pytest.fixture(scope="module")
def runs():
    """tier -> (JAX result, port result with the tap, port result without it,
    port config) of one serving call, computed once a tier."""
    cache = {}
    return lambda name: cache[name] if name in cache else cache.setdefault(name, _run(name))


def _run(name: str):
    tier, bits, seed, vocab, _ = TIERS[name]
    base = int4_vlm() if bits == 4 else jvlm.VLMConfig.tiny()
    serving = jvla.VLAServingConfig.for_tier(base, tier, action_dim=A, prompt_pad_len=P,
                                             codec_vocab_size=vocab)
    params = jvlm.init_params(serving.vlm, jax.random.key(seed))
    if bits is not None:
        params = jlin.quantize_params(params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=bits)
    tserving = convert.config_from_jax(serving)
    kw = {} if bits is None else dict(quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=bits)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu", **kw)
    img, ids, plen, q01, q99, mask = _inputs(vocab)
    with _jax_context(name):
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            collect_hidden_states=True)
        want = jax.tree.map(np.asarray, want)
    got, plain = (
        {k: v.numpy() for k, v in tvla.predict_action_from_image(
            tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
            collect_hidden_states=tap, device="cpu").items()}
        for tap in (True, False))
    return want, got, plain, tserving


def _close_by_layer(got: np.ndarray, want: np.ndarray, tol: float) -> float:
    """Each layer's pooled values within tol of that layer's largest |want|;
    returns the largest such ratio."""
    scale = np.abs(want).max(axis=(0, 2), keepdims=True)
    ratio = (np.abs(got - want) / np.maximum(scale, 1e-30)).max()
    assert ratio <= tol, ratio
    return float(ratio)


# --- predict_action_from_image on every tier -----------------------------------------------

@pytest.mark.parametrize("name", list(TIERS))
def test_hidden_pooled_matches_jax(runs, name):
    want, got, _, tserving = runs(name)
    L, D = tserving.vlm.llm.num_hidden_layers, tserving.vlm.llm.hidden_size
    assert got["hidden_pooled"].shape == (3, L + 1, D) == want["hidden_pooled"].shape
    assert got["hidden_pooled"].dtype == np.float32
    assert np.isfinite(got["hidden_pooled"]).all()
    _close_by_layer(got["hidden_pooled"], want["hidden_pooled"], TIERS[name][4])


@pytest.mark.parametrize("name", list(TIERS))
def test_the_tap_leaves_the_action_tokens(runs, name):
    want, got, plain, _ = runs(name)
    assert "hidden_pooled" not in plain
    np.testing.assert_array_equal(got["action_tokens"], plain["action_tokens"])
    np.testing.assert_array_equal(got["actions"], plain["actions"])
    np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])


def test_the_pool_leaves_out_the_trailing_empty_token(runs):
    """The embeddings' entry is the mean over [BOS | patches | prompt] without the
    trailing 29871: pooled again here from the port's own spliced embeddings."""
    _, got, _, tserving = runs("parity")
    tier, bits, seed, vocab, _ = TIERS["parity"]
    serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), tier, action_dim=A,
                                             prompt_pad_len=P, codec_vocab_size=vocab)
    params = convert.params_from_jax(
        jax.tree.map(np.asarray, jvlm.init_params(serving.vlm, jax.random.key(seed))),
        tserving.vlm, device="cpu")
    img, ids, plen, *_ = _inputs(vocab)
    pixels = timage.apply_image_transform(torch.from_numpy(img), _img_cfg(timage))
    prompt_mask = (torch.arange(P)[None] < torch.from_numpy(plen)[:, None]).int()
    mm = tvlm.build_multimodal_inputs(params, tserving.vlm, torch.from_numpy(ids).long(),
                                      prompt_mask, pixels)
    n = 1 + tserving.vlm.num_patches + plen - 2          # mm_len - 1
    for b in range(3):
        want = mm["inputs_embeds"][b, :n[b]].float().mean(0).numpy()
        np.testing.assert_allclose(got["hidden_pooled"][b, 0], want, rtol=1e-5, atol=1e-6)


# --- the trunk and the VLM forward ----------------------------------------------------------

@pytest.fixture(scope="module")
def trunk():
    cfg = jvlm.VLMConfig.tiny()
    params = jvlm.init_params(cfg, jax.random.key(7))
    tcfg = convert.config_from_jax(cfg)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    return cfg, params, tcfg, tparams


def _trunk_inputs(D, B=3, T=70, seed=1):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(B, T, D)) * 0.5).astype(np.float32)
    am = np.ones((B, T), np.int32)
    am[1, T - 9:] = 0
    am[2, T - 30:] = 0
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    pool = (np.arange(T)[None] < am.sum(1)[:, None] - 1).astype(np.int32)
    return x, am, pos, pool


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("with_pool_mask", [False, True])
def test_llama_forward_tap_matches_jax(trunk, cached, with_pool_mask):
    cfg, params, tcfg, tparams = trunk
    x, am, pos, pool = _trunk_inputs(cfg.llm.hidden_size)
    B, T, _ = x.shape
    S = T + 8
    amS = np.pad(am, ((0, 0), (0, S - T))) if cached else am
    pm = pool if with_pool_mask else None
    with _Parity():
        jkw = dict(cache=jllama.KVCache.zeros(cfg.llm, B, S, dtype=jnp.float32),
                   cache_index=jnp.int32(0), static_zero_offset=True) if cached else {}
        want = jllama.forward(params["llm"], cfg.llm, jnp.asarray(x), jnp.asarray(amS),
                              jnp.asarray(pos), collect_hidden_states=True,
                              pool_mask=None if pm is None else jnp.asarray(pm),
                              compute_logits=False, **jkw)
    tkw = dict(cache=tllama.KVCache.zeros(tcfg.llm, B, S, dtype=torch.float32),
               cache_index=0, static_zero_offset=True) if cached else {}
    got = tllama.forward(tparams["llm"], tcfg.llm, torch.from_numpy(x), torch.from_numpy(amS),
                         torch.from_numpy(pos), collect_hidden_states=True,
                         pool_mask=None if pm is None else torch.from_numpy(pm),
                         compute_logits=False, **tkw)
    hp = got["hidden_pooled"].numpy()
    assert hp.shape == (B, tcfg.llm.num_hidden_layers + 1, tcfg.llm.hidden_size)
    np.testing.assert_allclose(hp, np.asarray(want["hidden_pooled"]), rtol=MODULE_TOL,
                               atol=MODULE_TOL)
    # the last entry pools the final-normed output; the first the embeddings
    w = (torch.from_numpy(pm).float() if pm is not None else
         torch.ones((B, T)) if cached else torch.from_numpy(am).float())
    last = (got["last_hidden_state"] * w[..., None]).sum(1) / w.sum(1, keepdim=True).clamp(min=1)
    np.testing.assert_allclose(hp[:, -1], last.numpy(), rtol=1e-5, atol=1e-6)
    first = (torch.from_numpy(x) * w[..., None]).sum(1) / w.sum(1, keepdim=True).clamp(min=1)
    np.testing.assert_allclose(hp[:, 0], first.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_pool_mask", [False, True])
def test_llama_prefill_tap_matches_jax(trunk, with_pool_mask):
    cfg, params, tcfg, tparams = trunk
    x, am, pos, pool = _trunk_inputs(cfg.llm.hidden_size, seed=2)
    pm = pool if with_pool_mask else None
    with _Parity():
        want = jllama.prefill(params["llm"], cfg.llm, jnp.asarray(x), jnp.asarray(am),
                              jnp.asarray(pos), collect_hidden_states=True,
                              pool_mask=None if pm is None else jnp.asarray(pm))
    got = tllama.prefill(tparams["llm"], tcfg.llm, torch.from_numpy(x), torch.from_numpy(am),
                         torch.from_numpy(pos), collect_hidden_states=True,
                         pool_mask=None if pm is None else torch.from_numpy(pm))
    np.testing.assert_allclose(got["hidden_pooled"].numpy(), np.asarray(want["hidden_pooled"]),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(got["kv"].k.numpy(), np.asarray(want["kv"].k), atol=1e-5)
    assert "hidden_pooled" not in tllama.prefill(tparams["llm"], tcfg.llm, torch.from_numpy(x),
                                                 torch.from_numpy(am), torch.from_numpy(pos))


@pytest.mark.parametrize("case", ["multimodal", "text_only"])
def test_vlm_forward_tap_matches_jax(trunk, case):
    cfg, params, tcfg, tparams = trunk
    r = np.random.default_rng(4)
    B, T = 3, 64
    ids = r.integers(3, cfg.llm.vocab_size, (B, T)).astype(np.int32)
    ids[:, 0] = 1
    lens = np.array([64, 40, 57])
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    px = None if case == "text_only" else r.normal(size=(B, 6, 28, 28)).astype(np.float32)
    with _Parity():
        want = jvlm.forward(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                            None if px is None else jnp.asarray(px), collect_hidden_states=True)
    got = tvlm.forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                       None if px is None else torch.from_numpy(px), collect_hidden_states=True)
    np.testing.assert_allclose(got["hidden_pooled"].numpy(), np.asarray(want["hidden_pooled"]),
                               rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=1e-4)


def test_remat_training_path_keeps_the_tap(trunk):
    """Under grad with remat on (the trainer's setting) the tap equals the
    forward's without remat, and gradients flow through it to the embeddings."""
    _, _, tcfg, tparams = trunk
    x, am, pos, _ = _trunk_inputs(tcfg.llm.hidden_size, seed=3)
    outs, grads = [], []
    for remat in (True, False):
        c = dataclasses.replace(tcfg.llm, remat=remat, flash_attn=False)
        xe = torch.from_numpy(x).requires_grad_(True)
        with torch.enable_grad():
            hp = tllama.forward(tparams["llm"], c, xe, torch.from_numpy(am),
                                torch.from_numpy(pos), collect_hidden_states=True,
                                compute_logits=False)["hidden_pooled"]
            (hp[:, 1:-1] ** 2).sum().backward()
        outs.append(hp.detach())
        grads.append(xe.grad)
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-7)
    assert grads[0].abs().sum() > 0
