"""The port's `turbo` tier (w8a8 int8 linears, the fused RMSNorm -> int8
kernel, the stacked-cache decode at bf16 scores) vs the JAX package, on the
CPU at tiny sizes.

The JAX side runs as its `turbo` tier is held to: OVLA_PALLAS=1 with
OVLA_PALLAS_MATMUL, OVLA_PALLAS_VITLIN and OVLA_PALLAS_VITMLP at 0 and
OVLA_PALLAS_RMSQ at 1, every Pallas kernel interpreted (OVLA_PALLAS_INTERPRET=1
inside ``force_tpu_interpret_mode()``), its wi8 gate ``_use_pallas`` left as
it is (closed on the CPU, which is what the fused norm needs); the env is
restored afterwards (monkeypatch).

* w8a8_matmul_plain vs ``_w8a8_dot``: the same codes and integer sums, so fp32
  outputs within 1e-6 relative and bf16 within one rounding step; given the
  same codes, the prequant branch of the JAX ``matmul_t`` bit for bit.
* rms_norm_quant_plain vs ``rms_norm_quant(interpret=True)``: codes within
  one step; scales within two fp32 ulps at fp32 (the rsqrt of a variance
summed in another order), within one bf16 step at
  bf16 (XLA elides the kernel's bf16 round trip of the normed value inside
  its fusion, which PyTorch rounds op by op: the amax element may differ by
  that step).
* The fused-norm gate vs ``_norm_maybe_quant``: the same decision at M = 8
  and 9, with a float consumer, with nibble leaves, on the wi8 route.
* The decode attention at bf16 scores vs the JAX XLA branch at Tq = 1.
* End to end (`turbo`, int8 TURBO_QUANT_SUFFIXES weights, B = 3, P = 64 so
  T = 68 and the prefill flash gate engages): tokens and actions equal, first
  logits and margins within 2e-2. Every linear quantizes its activations, so
  the known one-bf16-step RoPE differences (ROADMAP Queue 3) move activation
  codes at rounding ties and add up layer by layer, as on the int4 tier: found
  5.7e-3 (logits) and 3.9e-3 (margins). Random-weight margins are small, so
  token equality is margin-limited: at this seed every token's margin is at
  least 7.7 times its difference (smallest margin 6.2e-3).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import openvla_probe_tpu.ops.linear
import openvla_probe_tpu.ops.rmsnorm_quant
from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu.ops import rmsnorm_quant as jrmsq
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.ops import rmsnorm_quant as trmsq

from tests.test_torch_pallas_tier import _img_cfg, _inputs

VOCAB = 512
A = 7
P = 64
ATOL = 2e-2       # logits and margins (module docstring)
SEED = 5          # margins at least 7.7x their difference (module docstring)
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def jax_turbo(rmsq: bool = True):
    """The JAX configuration the port's turbo paths are held to (module docstring)."""
    env = {"OVLA_PALLAS": "1", "OVLA_PALLAS_INTERPRET": "1", "OVLA_PALLAS_MATMUL": "0",
           "OVLA_PALLAS_VITLIN": "0", "OVLA_PALLAS_VITMLP": "0",
           "OVLA_PALLAS_RMSQ": "1" if rmsq else "0"}
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for k, v in env.items():
            mp.setenv(k, v)
        yield mp


def _pair(arr, dtype):
    j = jnp.asarray(arr, JNP_DT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH_DT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _qw(rng, n, k):
    w = jlin.quantize_weight(jnp.asarray(rng.normal(0, 0.05, (n, k)), jnp.float32))
    return w, {"q": torch.from_numpy(np.array(w["q"])), "s": torch.from_numpy(np.array(w["s"]))}


# --- w8a8 ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("bfloat16", 8e-3)])
@pytest.mark.parametrize("M,K,N", [(5, 96, 40), (24, 80, 136), (40, 208, 264)],
                         ids=["small", "K%32", "N%128"])
def test_w8a8_plain_matches_jax(dtype, rtol, M, K, N):
    """K = 80 and 208 are not multiples of 32 (the kernel's zero-filled k
    tail), N = 136 and 264 not of 128 (its column tail)."""
    r = np.random.default_rng(M + K + N)
    jx, tx = _pair(r.normal(size=(M, K)), dtype)
    jw, tw = _qw(r, N, K)
    want = jlin._w8a8_dot(jx, jw["q"], jw["s"])
    _build.reset_launch_counts()
    got = tlin.w8a8_matmul(tx, tw)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}     # the CPU takes the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prequant_branch_bit_identical(dtype):
    """Codes and scales handed over by the fused norm: the JAX matmul_t's
    prequant branch and the port's on the same codes, bit for bit."""
    r = np.random.default_rng(3)
    M, K, N = 12, 64, 48
    codes = r.integers(-127, 128, (2, M // 2, K)).astype(np.int8)
    sx = r.uniform(1e-3, 2e-2, (2, M // 2, 1)).astype(np.float32)
    jw, tw = _qw(r, N, K)
    want = jlin.matmul_t(jlin.PrequantActivation(jnp.asarray(codes), jnp.asarray(sx),
                                                 JNP_DT[dtype]), jw)
    x = tlin.PrequantActivation(torch.from_numpy(codes), torch.from_numpy(sx), TORCH_DT[dtype])
    got = tlin.matmul_t(x, tw, "w8a8")
    assert got.dtype == TORCH_DT[dtype] and got.shape == (2, M // 2, N)
    np.testing.assert_array_equal(_np(got), _np(want))
    with pytest.raises(TypeError, match="per-channel int8"):
        tlin.matmul_t(x, torch.zeros((N, K)))


def test_matmul_t_int8_routes():
    """A per-channel int8 leaf takes the route the config names."""
    r = np.random.default_rng(4)
    _, tw = _qw(r, 32, 64)
    x = torch.from_numpy(r.normal(size=(2, 3, 64)).astype(np.float32))
    x2 = x.reshape(6, 64)
    np.testing.assert_array_equal(tlin.matmul_t(x, tw, "w8a8").reshape(6, 32).numpy(),
                                  tlin.w8a8_matmul_plain(x2, tw).numpy())
    np.testing.assert_array_equal(tlin.matmul_t(x, tw).reshape(6, 32).numpy(),
                                  tlin.wi8_matmul_plain(x2, tw["q"], tw["s"]).numpy())
    with pytest.raises(ValueError, match="int8_matmul"):
        tlin.matmul_t(x, tw, "int8")


# --- the fused RMSNorm -> int8 kernel --------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [("float32", 4e-7), ("bfloat16", 2 ** -8)])
@pytest.mark.parametrize("M", [3, 300])
def test_rms_norm_quant_plain_matches_jax_kernel(dtype, rtol, M):
    r = np.random.default_rng(M)
    D = 256
    jx, tx = _pair(r.normal(size=(M, D)) * r.uniform(0.1, 3, (M, 1)), dtype)
    jw, tw = _pair(1 + 0.2 * r.normal(size=(D,)), dtype)
    jq, js = jrmsq.rms_norm_quant(jx, jw, 1e-5, interpret=True)
    tq, ts = trmsq.rms_norm_quant(tx, tw, 1e-5)
    assert tq.dtype == torch.int8 and tq.shape == (M, D) and ts.shape == (M, 1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=rtol, atol=0)
    assert np.abs(tq.numpy().astype(int) - np.asarray(jq).astype(int)).max() <= 1


def _leaf(kind, rng, n, k):
    if kind == "int8":
        return _qw(rng, n, k)
    w = rng.normal(0, 0.05, (n, k)).astype(np.float32)
    if kind == "float":
        return jnp.asarray(w), torch.from_numpy(w)
    return (jlin.quantize_weight_nibble(jnp.asarray(w)),
            tlin.quantize_weight_nibble(torch.from_numpy(w)))


@pytest.mark.parametrize("case,M,kinds,route", [
    ("M=8", 8, ("int8", "int8"), "w8a8"),
    ("M=9", 9, ("int8", "int8"), "w8a8"),
    ("float consumer", 12, ("int8", "float"), "w8a8"),
    ("nibble", 12, ("nibble", "nibble"), "w8a8"),
    ("wi8 route", 12, ("int8", "int8"), "wi8"),
])
def test_norm_gate_matches_jax(case, M, kinds, route):
    """The port's `_norm_maybe_quant` fuses exactly where the JAX package's
    does (OVLA_PALLAS_RMSQ=1; the wi8 route is its wi8 gate open), and then
    hands over the same codes and scales."""
    r = np.random.default_rng(M)
    D = 64
    x = r.normal(size=(M, 1, D)).astype(np.float32)
    wn = (1 + 0.1 * r.normal(size=(D,))).astype(np.float32)
    leaves = [_leaf(k, r, 32, D) for k in kinds]
    jcfg = jllama.LlamaConfig.tiny(hidden_size=D)
    tcfg = tllama.LlamaConfig.tiny(hidden_size=D, int8_matmul=route, fused_rmsq=True)
    with jax_turbo() as mp:
        if route == "wi8":
            mp.setattr(openvla_probe_tpu.ops.linear, "_use_pallas", lambda: True)
        want = jllama._norm_maybe_quant(jcfg, jnp.asarray(x), jnp.asarray(wn),
                                        tuple(j for j, _ in leaves))
    got = tllama._norm_maybe_quant(tcfg, torch.from_numpy(x), torch.from_numpy(wn),
                                   tuple(t for _, t in leaves))
    fused = isinstance(want, jlin.PrequantActivation)
    assert isinstance(got, tlin.PrequantActivation) == fused == (case == "M=9")
    if fused:
        np.testing.assert_array_equal(got.q8.numpy(), np.asarray(want.q8))
        np.testing.assert_allclose(got.sx.numpy(), np.asarray(want.sx), rtol=2e-7)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


# --- decode attention at bf16 scores ----------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_bf16_scores_match_jax_xla_attention(dtype):
    """One decode query at bf16 scores (the turbo stacked decode): the JAX
    package's XLA branch at Tq = 1 (llama.py:225-229), held as the kernel is
    held to the plain version (attention.compare_bf16_scores; measured: bf16
    bit-equal, fp32 within 9e-8)."""
    B, S, H, Dh, slot = 2, 23, 3, 16, 19
    r = np.random.default_rng(9)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(r.normal(size=(B, t, H, Dh)), dtype)
                                    for t in (1, S, S))
    valid = np.ones((B, S), np.int32)
    valid[1, 9:16] = 0
    valid[:, slot + 1:] = 0
    mask = jllama.make_causal_mask(jnp.asarray(valid), 1, S, offset=slot)
    want = jllama.attention(jq, jk, jv, mask, scores_dtype=jnp.bfloat16)
    got = tattn.decode_attention(tq, tk, tv, torch.from_numpy(valid), slot, torch.bfloat16)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, 1, H, Dh)
    fp32 = tattn.decode_attention(tq, tk, tv, torch.from_numpy(valid), slot)
    tattn.compare_bf16_scores(got, torch.tensor(_np(want)), fp32)


# --- end to end ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), "turbo", action_dim=A,
                                             prompt_pad_len=P, codec_vocab_size=VOCAB)
    params = jlin.quantize_params(jvlm.init_params(serving.vlm, jax.random.key(SEED)),
                                  suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8)
    tserving = convert.config_from_jax(serving)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu", quant_suffixes=tlin.TURBO_QUANT_SUFFIXES)
    return serving, params, tserving, tparams


def count_calls(mp, module, names, counts):
    """Count the calls of `module`'s functions `names` into `counts`."""
    for name in names:
        fn = getattr(module, name)

        def counted(*a, fn=fn, name=name, **kw):
            counts[name] = counts.get(name, 0) + 1
            return fn(*a, **kw)

        mp.setattr(module, name, counted)


@pytest.fixture(scope="module")
def both(models):
    serving, params, tserving, tparams = models
    img, ids, plen, q01, q99, mask = _inputs()
    jax_calls, routes = {}, {}
    with jax_turbo() as mp:
        count_calls(mp, openvla_probe_tpu.ops.rmsnorm_quant, ["rms_norm_quant"], jax_calls)
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
        want = jax.tree.map(np.asarray, want)
    with pytest.MonkeyPatch.context() as mp:
        count_calls(mp, tlin, ["w8a8_matmul", "wi8_matmul"], routes)
        count_calls(mp, tllama, ["rms_norm_quant"], routes)
        _build.reset_launch_counts()
        got = tvla.predict_action_from_image(
            tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
            return_first_logits=True, device="cpu")
    return want, {k: v.numpy() for k, v in got.items()}, routes, jax_calls


def test_action_tokens_and_actions_equal(both):
    want, got, _, _ = both
    assert got["action_tokens"].shape == (3, A)
    assert len(np.unique(want["action_tokens"])) > 1
    np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
    np.testing.assert_array_equal(got["normalized_actions"], want["normalized_actions"])
    np.testing.assert_array_equal(got["actions"], want["actions"])


@pytest.mark.parametrize("key", ["first_logits", "logit_margins"])
def test_logits_and_margins_close(both, key):
    want, got, _, _ = both
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def test_routes_per_call(both, models):
    """The routes one call takes, as chip_smoke.py counts them at 7B: every
    linear on w8a8 (towers 4 per block, trunk 7 per layer and pass, lm_head
    once per token), the fused norm at both sites of every layer of the
    prefill (a decode step's B = 3 rows are too few to fuse; at B = 24 they
    fuse too); the JAX side fused its norms too. The CPU launches no kernel."""
    _, _, routes, jax_calls = both
    c = models[2].vlm
    L, passes = c.llm.num_hidden_layers, A
    blocks = sum(v.num_layers - 1 for v in c.vision)
    assert routes == {"w8a8_matmul": 4 * blocks + 7 * L * passes + A,
                      "rms_norm_quant": 2 * L}
    assert jax_calls["rms_norm_quant"] > 0
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}


def test_config_for_tier_matches_jax(models):
    serving, _, tserving, _ = models
    t = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo", action_dim=A,
                                       prompt_pad_len=P, codec_vocab_size=VOCAB)
    assert t == tserving
    assert (t.tier, t.decode_impl) == ("turbo", "stacked")
    assert (t.vlm.llm.int8_matmul, t.vlm.llm.fused_rmsq) == ("w8a8", True)
    assert [v.int8_matmul for v in t.vlm.vision] == ["w8a8", "w8a8"]
    assert t.vlm.llm.attn_scores_dtype == torch.bfloat16
    pallas = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "pallas")
    assert (pallas.vlm.llm.int8_matmul, pallas.vlm.llm.fused_rmsq) == ("wi8", False)
    assert convert.config_from_jax(jvla.VLAServingConfig.for_tier(
        jvlm.VLMConfig.openvla_7b(), "turbo", prompt_pad_len=32)) == \
        tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.openvla_7b(), "turbo", prompt_pad_len=32)


def test_stacked_decode_steps_match_jax(models):
    """The trunk alone on the stacked cache: prefill (flash, fused norms),
    then 3 teacher-forced decode steps at bf16 scores; each step's logits."""
    serving, params, tserving, tparams = models
    jcfg, tcfg = serving.vlm.llm, tserving.vlm.llm
    B, T, S = 2, 68, 71
    r = np.random.default_rng(5)
    x = r.normal(size=(B, T, jcfg.hidden_size)).astype(np.float32)
    am = np.zeros((B, S), np.int32)
    am[0, :T], am[1, :T - 9] = 1, 1
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    toks = np.array([[3, 77, 5], [9, 200, 31]], np.int32)
    tcache = tllama.KVCache.zeros(tcfg, B, S, dtype=torch.float32)
    tllama.forward(tparams["llm"], tcfg, torch.from_numpy(x), torch.from_numpy(am),
                   torch.from_numpy(pos), cache=tcache, cache_index=0, compute_logits=False,
                   static_zero_offset=True)
    with jax_turbo():
        jcache = jllama.forward(params["llm"], jcfg, jnp.asarray(x), jnp.asarray(am),
                                jnp.asarray(pos), cache=jllama.KVCache.zeros(jcfg, B, S),
                                cache_index=jnp.int32(0), compute_logits=False,
                                static_zero_offset=True)["cache"]
        for t in range(toks.shape[1]):
            am[:, T + t] = 1
            p = am[:, :T].sum(1, keepdims=True) + t
            jout = jllama.forward(params["llm"], jcfg,
                                  jllama.embed_tokens(params["llm"], jnp.asarray(toks[:, t:t + 1])),
                                  jnp.asarray(am), jnp.asarray(p), cache=jcache,
                                  cache_index=jnp.int32(T + t))
            jcache = jout["cache"]
            tout = tllama.forward(tparams["llm"], tcfg,
                                  tllama.embed_tokens(tparams["llm"],
                                                      torch.from_numpy(toks[:, t:t + 1]).long()),
                                  torch.from_numpy(am), torch.from_numpy(p), cache=tcache,
                                  cache_index=T + t)
            np.testing.assert_allclose(tout["logits"].numpy(), np.asarray(jout["logits"]),
                                       atol=ATOL, err_msg=f"step {t}")


def _rmsq_with_r_moved(x, w, ulps, round_trip=True, rnd=torch.round):
    """rms_norm_quant's arithmetic with each row's reciprocal RMS moved by
    `ulps[row]` ulps: what a kernel summing in another order may give, or,
    with `round_trip` off or another rounding, a faulty one."""
    from openvla_probe_tpu_torch.ops import rmsnorm_quant as trmsq

    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
    r = torch.cat([trmsq._nudge(r[i:i + 1], int(k)) for i, k in enumerate(ulps)])
    h = xf * r
    h = (h.to(x.dtype) * w.to(x.dtype)) if round_trip else h * w.float()
    s = torch.clamp(h.float().abs().amax(-1, keepdim=True) / 127, min=1e-8)
    return torch.clamp(rnd(h.float() / s), -127, 127).to(torch.int8), s


def test_compare_rms_norm_quant_takes_moved_r_and_refuses_faults():
    """compare_rms_norm_quant, which holds the CUDA kernel to its plain
    version: rows whose reciprocal RMS moved by up to 6 ulps are reproduced
    and pass; no bf16 round trip, truncation, or r 200 ulps off are refused."""
    from openvla_probe_tpu_torch.ops import rmsnorm_quant as trmsq

    g = torch.Generator().manual_seed(0)
    M, D = 400, 1024
    x = (torch.randn((M, D), generator=g) * 2).bfloat16()
    w = (1 + 0.2 * torch.randn((D,), generator=g)).bfloat16()
    want = trmsq.rms_norm_quant_plain(x, w, 1e-5)
    moved = torch.randint(-6, 7, (M,), generator=g)
    stats = trmsq.compare_rms_norm_quant(x, w, 1e-5, _rmsq_with_r_moved(x, w, moved), want)
    assert stats["rows_differing"] > 0 and stats["max_r_ulps"] <= 6
    for faulty in (_rmsq_with_r_moved(x, w, moved, round_trip=False),
                   _rmsq_with_r_moved(x, w, moved, rnd=torch.trunc),
                   _rmsq_with_r_moved(x, w, torch.full((M,), 200))):
        with pytest.raises(AssertionError):
            trmsq.compare_rms_norm_quant(x, w, 1e-5, faulty, want)
