"""The port's grouped-int4 (w4a8) pieces and the `pallas` tier over int4
weights vs the JAX package, on the CPU at tiny sizes.

* quantize_weight_int4 / quantize_params(bits=4): codes and scales
  bit-identical to the JAX package's (codes compared unpacked), the int8
  fallback for an in-dim with no group included; the packed layout round-trips
  every code; params_from_jax packs the JAX s4 leaves and emit_codes=True int8
  codes alike.
* The requant route (``_w4a8_dot_requant``): its int8 codes and scales
  bit-identical to the JAX package's (caught on their way into ``_w8a8_dot``),
  then the port's w8a8 kernel (``w8a8_matmul``; its plain version here).
* Function level: w4a8_matmul_plain vs ``_w4a8_pallas_matmul(interpret=True)``
  within fp32 1e-6 relative (the same codes and integer sums, XLA may contract
  the fold's multiply-add into one FMA) and bf16 one rounding step;
  w8a8_matmul_plain vs ``_w8a8_dot`` equal up to that last rounding.
* Dispatch: grouped-int4 leaves take the kernel where N and gsz are multiples
  of 128, the requant route otherwise.
* End to end (`pallas` tier, TURBO_QUANT_SUFFIXES at bits=4): tokens and
  actions equal to the JAX package's, first logits and margins within 2e-2
  (found: 1.0e-2 and 7.7e-3), frozen K/V within 1e-2 (found: 3.7e-3). The
  int8 tier's trunk linears are weight-only; here every linear quantizes its
  activations, so the known one-step differences upstream (XLA rounds the
  bf16 RoPE at other places: K of layer 0 one bf16 step apart, V within an
  fp32 ulp) move activation codes by one step at rounding ties, and those
  steps add up layer by layer. The config makes the JAX package's interpret-mode
  dispatch equal its chip dispatch: every int4 in-dim is a multiple of 128,
  the vocab (400) is not (``lm_head`` takes requant), SigLIP's mlp dim (208)
  is not (its fc1 takes requant, its fc2 falls back to int8 and
  ``wi8_matmul``), and ``down_proj`` and DINOv2's fc2 have two groups.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import vit as jvit
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_pallas_tier import _JaxKernelsOn, _img_cfg

VOCAB = 400
A = 7
P = 64          # T = 1 + 4 patches + 63 = 68 >= 64: the prefill flash gate engages
ATOL = 2e-2       # logits and margins (module docstring)
KV_ATOL = 1e-2
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _pair(arr, dtype):
    j = jnp.asarray(arr, JNP_DT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH_DT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _int4_pair(rng, n, k):
    """One N(0, 0.05) weight quantized to grouped int4 by each side."""
    w = rng.normal(0, 0.05, (n, k)).astype(np.float32)
    return jlin.quantize_weight_int4(jnp.asarray(w)), tlin.quantize_weight_int4(torch.from_numpy(w))


def int4_vlm():
    """The e2e configuration (module docstring): two-layer Llama of width
    128 (2 heads of 64, intermediate 256, vocab 400), DINOv2-like and
    SigLIP-like towers of width 128 with mlp dims 256 and 208."""
    return jvlm.VLMConfig(
        llm=jllama.LlamaConfig.tiny(vocab_size=VOCAB, hidden_size=128, intermediate_size=256,
                                    num_hidden_layers=2, num_attention_heads=2,
                                    num_key_value_heads=2),
        vision=(jvit.ViTConfig.tiny(hidden_size=128, num_heads=2, mlp_dim=256,
                                    num_register_tokens=2, no_embed_class=True,
                                    use_layerscale=True),
                jvit.ViTConfig.tiny(hidden_size=128, num_heads=2, mlp_dim=208,
                                    use_cls_token=False, act="gelu_tanh")))


# --- quantization ------------------------------------------------------------------


def test_pack_unpack_round_trip():
    codes = torch.arange(-8, 8, dtype=torch.int8).repeat(3).reshape(2, 24)
    packed = tlin.pack_int4(codes)
    assert packed.dtype == torch.uint8 and packed.shape == (2, 12)
    assert torch.equal(tlin.unpack_int4(packed), codes)
    # byte j: code 2j in the low nibble, code 2j + 1 in the high nibble, two's complement
    assert tlin.pack_int4(torch.tensor([1, -1, 7, -7], dtype=torch.int8)).tolist() == [0xF1, 0x97]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(40, 256), (3, 24, 64), (16, 384)])
def test_quantize_weight_int4_bit_identical(dtype, shape):
    w = np.random.default_rng(0).normal(0, 0.02, shape)
    w[..., 0, :] = 0.0                       # an all-zero channel: the 1e-8 scale floor
    jw, tw = _pair(w, dtype)
    want = jlin.quantize_weight_int4(jw, emit_codes=True)
    got = tlin.quantize_weight_int4(tw)
    assert got["q"].dtype == torch.uint8 and got["s"].dtype == torch.float32
    assert tlin.is_grouped_int4(got) and not tlin.is_int8_per_channel(got)
    np.testing.assert_array_equal(tlin.unpack_int4(got["q"]).numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(tlin.dequantize_weight(got, torch.float32).numpy(),
                                  _np(jlin.dequantize_weight(want, jnp.float32)))


@pytest.fixture(scope="module")
def int4_params():
    cfg = int4_vlm()
    return cfg, convert.config_from_jax(cfg), jvlm.init_params(cfg, jax.random.key(0))


def test_quantize_params_int4_bit_identical(int4_params):
    """bits=4 over TURBO_QUANT_SUFFIXES: grouped int4 everywhere but SigLIP's
    fc2 (in-dim 208, no group), which falls back to per-channel int8."""
    _, tcfg, params = int4_params
    want = _flat(jax.tree.map(np.asarray, jlin.quantize_params(
        params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=4, emit_codes=True)))
    fparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    got = _flat(tlin.quantize_params(fparams, suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=4))
    assert got.keys() == want.keys()
    packed = [k for k, v in got.items() if v.dtype == torch.uint8]
    assert len(packed) == 8 + 4 + 3 and "/vision/siglip/blocks/fc2_w/q" not in packed
    assert got["/vision/siglip/blocks/fc2_w/q"].dtype == torch.int8
    for k in want:
        g = tlin.unpack_int4(got[k]) if k in packed else got[k]
        np.testing.assert_array_equal(g.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("codes", [False, True], ids=["s4", "emit_codes"])
def test_params_from_jax_int4(int4_params, codes):
    """The JAX s4 leaves and its int8 codes both convert to the packed layout."""
    _, tcfg, params = int4_params
    tree = jax.tree.map(np.asarray, jlin.quantize_params(
        params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=4, emit_codes=codes))
    assert (tree["llm"]["layers"]["q_proj"]["q"].dtype.name == "int8") == codes
    got = _flat(convert.params_from_jax(tree, tcfg, device="cpu",
                                        quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=4))
    want = _flat(tree)
    assert got.keys() == want.keys()
    for k in want:
        g = tlin.unpack_int4(got[k]) if got[k].dtype == torch.uint8 else got[k]
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k], dtype=g.numpy().dtype),
                                      err_msg=k)
    with pytest.raises(ValueError):   # int4 codes where the layout has int8 leaves
        convert.params_from_jax(tree, tcfg, device="cpu",
                                quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=8)


@pytest.mark.parametrize("name", ["int4_vlm", "openvla_7b"])
def test_int4_layout_matches_jax(name):
    """vlm_param_spec(bits=4) is the layout of the JAX package's
    quantize_params(..., TURBO_QUANT_SUFFIXES, bits=4), the codes' last dim
    halved by the packing (shapes only)."""
    jcfg = int4_vlm() if name == "int4_vlm" else jvlm.VLMConfig.openvla_7b()
    shapes = _flat(jax.eval_shape(lambda k: jlin.quantize_params(
        jvlm.init_params(jcfg, k), suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=4,
        emit_codes=True), jax.random.key(0)))
    spec = _flat(convert.vlm_param_spec(convert.config_from_jax(jcfg),
                                        tlin.TURBO_QUANT_SUFFIXES, bits=4))
    assert spec.keys() == shapes.keys()
    n_int4 = 0
    for k, s in shapes.items():
        want = tuple(s.shape)
        if spec[k].dtype == torch.uint8:
            want = (*want[:-1], want[-1] // 2)
            n_int4 += 1
        else:
            assert str(spec[k].dtype).removeprefix("torch.") == np.dtype(s.dtype).name, k
        assert spec[k].shape == want, k
    assert n_int4 == 8 + 4 + 3


def test_init_params_int4(int4_params):
    _, tcfg, _ = int4_params
    got = _flat(convert.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                                    quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=4))
    spec = _flat(convert.vlm_param_spec(tcfg, tlin.TURBO_QUANT_SUFFIXES, bits=4))
    assert got.keys() == spec.keys()
    for k, leaf in spec.items():
        assert tuple(got[k].shape) == leaf.shape and got[k].dtype == leaf.dtype, k
    w = {"q": got["/llm/layers/down_proj/q"], "s": got["/llm/layers/down_proj/s"]}
    codes = tlin.unpack_int4(w["q"])
    assert codes.abs().amax(-1).eq(7).all()                 # absmax per (group, channel)
    assert abs(tlin.dequantize_weight(w, torch.float32).std().item() - 0.02) < 2e-3


def test_other_bits_raise():
    with pytest.raises(ValueError):
        tlin.quantize_params({"q_proj": torch.zeros(2, 2)}, bits=3)
    with pytest.raises(NotImplementedError, match="Queue 1"):
        convert.vlm_param_spec(convert.config_from_jax(int4_vlm()), tlin.TURBO_QUANT_SUFFIXES,
                               bits="mix")


# --- the requant route, w8a8, and the w4a8 kernel's plain version ------------------------


@pytest.mark.parametrize("gsz_dim", [(256, 128), (64, 64)], ids=["G2", "tiny-group"])
def test_requant_codes_bit_identical(gsz_dim, monkeypatch):
    """_w4a8_dot_requant's int8 codes and scales, caught on their way into
    _w8a8_dot, equal requant_int4_to_int8's; the outputs equal too."""
    K, N = gsz_dim
    r = np.random.default_rng(21)
    jw, tw = _int4_pair(r, N, K)
    x = r.normal(size=(5, K)).astype(np.float32)
    seen = {}
    orig = jlin._w8a8_dot

    def capture(x2, q8, s8):
        seen.update(q8=np.asarray(q8), s8=np.asarray(s8))
        return orig(x2, q8, s8)

    monkeypatch.setattr(jlin, "_w8a8_dot", capture)
    want = jlin._w4a8_dot_requant(jnp.asarray(x), jw["q"], jw["s"])
    q8, s8 = tlin.requant_int4_to_int8(tw["q"], tw["s"])
    assert q8.dtype == torch.int8 and q8.shape == (N, K)
    np.testing.assert_array_equal(q8.numpy(), seen["q8"])
    np.testing.assert_array_equal(s8.numpy(), seen["s8"])
    np.testing.assert_array_equal(tlin.w4a8_dot_requant(torch.from_numpy(x), tw["q"], tw["s"]).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("bfloat16", 8e-3)])
@pytest.mark.parametrize("M", [1, 24, 40])
def test_w8a8_dot_plain_matches_jax(dtype, rtol, M):
    r = np.random.default_rng(M + 100)
    K, N = 96, 40
    jx, tx = _pair(r.normal(size=(M, K)), dtype)
    w = jlin.quantize_weight(jnp.asarray(r.normal(0, 0.05, (N, K)), jnp.float32))
    want = jlin._w8a8_dot(jx, w["q"], w["s"])
    got = tlin.w8a8_matmul(tx, {"q": torch.from_numpy(np.array(w["q"])),
                                "s": torch.from_numpy(np.array(w["s"]))})
    assert got.dtype == TORCH_DT[dtype] and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("bfloat16", 8e-3)])
@pytest.mark.parametrize("M", [1, 24, 40])
def test_w4a8_plain_matches_jax_kernel(dtype, rtol, M):
    r = np.random.default_rng(M)
    K, N = 384, 256                           # G = 3 groups of 128, N two 128-column tiles
    jx, tx = _pair(r.normal(size=(M, K)), dtype)
    jw, tw = _int4_pair(r, N, K)
    with pltpu.force_tpu_interpret_mode():
        want = jlin._w4a8_pallas_matmul(jx, jw["q"], jw["s"], interpret=True)
    _build.reset_launch_counts()
    got = tlin.w4a8_matmul(tx, tw["q"], tw["s"])
    assert got.dtype == TORCH_DT[dtype] and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}     # the CPU takes the plain version


@pytest.mark.parametrize("N,K,route", [
    (256, 256, "w4a8_matmul"),          # N and gsz multiples of 128: the kernel
    (200, 256, "w4a8_dot_requant"),     # N % 128 != 0
    (256, 64, "w4a8_dot_requant"),      # gsz = 64 % 128 != 0
])
def test_matmul_t_grouped_int4_dispatch(monkeypatch, N, K, route):
    """The route matmul_t picks, and its result equal to the JAX package's
    route on the chip on the same leaf: its matmul_t under the kernel gate
    for the kernel, ``_w4a8_dot_requant`` otherwise (in interpret mode the JAX
    dispatch would keep gsz = 64 on the kernel)."""
    r = np.random.default_rng(N + K)
    jw, tw = _int4_pair(r, N, K)
    x = r.normal(size=(2, 3, K)).astype(np.float32)
    taken = []
    for name in ("w4a8_matmul", "w4a8_dot_requant"):
        fn = getattr(tlin, name)
        monkeypatch.setattr(tlin, name, lambda *a, fn=fn, name=name: taken.append(name) or fn(*a))
    got = tlin.matmul_t(torch.from_numpy(x), tw)
    assert taken == [route] and got.shape == (2, 3, N)
    if route == "w4a8_matmul":
        with _JaxKernelsOn():
            want = jlin.matmul_t(jnp.asarray(x), jw)
    else:
        want = jlin._w4a8_dot_requant(jnp.asarray(x.reshape(6, K)), jw["q"], jw["s"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(2, 3, N), rtol=1e-6,
                               atol=1e-6)


def test_matmul_t_raises_on_unpacked_int4_codes():
    """The JAX package's emit_codes=True int8 codes are not a port leaf
    (params_from_jax packs them): matmul_t raises instead of misreading them."""
    q = torch.zeros((1, 5, 4), dtype=torch.int8)
    with pytest.raises(NotImplementedError):
        tlin.matmul_t(torch.randn(3, 4), {"q": q, "s": torch.ones(5, 1)})


# --- end to end -----------------------------------------------------------------------


def _inputs(B=3, seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (B, 40, 40, 3), dtype=np.uint8)
    plen = np.array([20, 35, 9][:B], np.int32)
    ids = np.zeros((B, P), np.int32)
    for b in range(B):
        ids[b, 0] = 1
        ids[b, 1:plen[b] - 1] = r.integers(3, VOCAB, plen[b] - 2)
        ids[b, plen[b] - 1] = 29871 % VOCAB
    q01 = r.uniform(-2, 0, A).astype(np.float32)
    q99 = r.uniform(0.5, 2, A).astype(np.float32)
    mask = np.array([True] * (A - 1) + [False])
    return img, ids, plen, q01, q99, mask


@pytest.fixture(scope="module")
def models():
    jcfg = int4_vlm()
    serving = jvla.VLAServingConfig.for_tier(jcfg, "pallas", action_dim=A, prompt_pad_len=P,
                                             codec_vocab_size=VOCAB)
    # random-weight margins are small (0.001-0.01 at the closest token) against
    # this path's port-vs-JAX logit differences (<= 0.01), so token equality is
    # margin-limited: at this seed every token's margin is at least 3.8 times
    # its difference, and the tokens take 11 values
    params = jlin.quantize_params(jvlm.init_params(serving.vlm, jax.random.key(3)),
                                  suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=4)
    tserving = convert.config_from_jax(serving)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu", quant_suffixes=tlin.TURBO_QUANT_SUFFIXES,
                                      bits=4)
    return serving, params, tserving, tparams


@pytest.fixture(scope="module")
def both(models):
    serving, params, tserving, tparams = models
    img, ids, plen, q01, q99, mask = _inputs()
    with _JaxKernelsOn():
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
        want = jax.tree.map(np.asarray, want)
    routes = {"w4a8_matmul": 0, "w4a8_dot_requant": 0, "w4a8_requant": 0, "w8a8_matmul": 0,
              "wi8_matmul": 0}
    with pytest.MonkeyPatch.context() as mp:
        for name in routes:
            fn = getattr(tlin, name)

            def counted(*a, fn=fn, name=name):
                routes[name] += 1
                return fn(*a)

            mp.setattr(tlin, name, counted)
        _build.reset_launch_counts()
        got = tvla.predict_action_from_image(
            tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
            return_first_logits=True, device="cpu")
    return want, {k: v.numpy() for k, v in got.items()}, routes


def test_action_tokens_and_actions_equal(both):
    want, got, _ = both
    assert got["action_tokens"].shape == (3, A)
    # random weights can make greedy decoding repeat one token, which would
    # make equality a weak check: these take several values
    assert len(np.unique(want["action_tokens"])) > 1
    np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
    np.testing.assert_array_equal(got["normalized_actions"], want["normalized_actions"])
    np.testing.assert_array_equal(got["actions"], want["actions"])


@pytest.mark.parametrize("key", ["first_logits", "logit_margins"])
def test_logits_and_margins_close(both, key):
    want, got, _ = both
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def test_routes_per_call(both, models):
    """The routes one call takes, as chip_smoke.py counts them at 7B: every
    int4 linear but lm_head and SigLIP's fc1/fc2 on the kernel; the requant
    route's product on its own kernel, w4a8_requant (no library GEMM, no
    w8a8_matmul call)."""
    _, _, routes = both
    c = models[2].vlm
    L, A1 = c.llm.num_hidden_layers, A - 1
    dino, siglip = (v.num_layers - 1 for v in c.vision)     # blocks 0..L-2 run
    assert routes == {"w4a8_matmul": 4 * dino + 2 * siglip + 7 * L * (1 + A1),
                      "w4a8_dot_requant": siglip + 1 + A1, "w4a8_requant": siglip + 1 + A1,
                      "w8a8_matmul": 0,
                      "wi8_matmul": siglip}
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}


def test_prefill_and_greedy_decode_match_jax(models):
    """The trunk alone over int4 weights: frozen-KV prefill then 4 split
    decode steps; the frozen K/V pair and the tokens."""
    serving, params, tserving, tparams = models
    jcfg, tcfg = serving.vlm.llm, tserving.vlm.llm
    B, T = 2, 68
    r = np.random.default_rng(5)
    x = r.normal(size=(B, T, jcfg.hidden_size)).astype(np.float32)
    am = np.ones((B, T), np.int32)
    am[1, T - 9:] = 0
    pos = np.broadcast_to(np.arange(T), (B, T)).copy()
    mm_len = am.sum(1).astype(np.int32)
    first = np.array([3, 77], np.int32)
    with _JaxKernelsOn():
        jout = jllama.prefill(params["llm"], jcfg, jnp.asarray(x), jnp.asarray(am), jnp.asarray(pos))
        jtoks, jmargins = jllama.greedy_decode(params["llm"], jcfg, jout["kv"], jnp.asarray(am),
                                               jnp.asarray(first), jnp.asarray(mm_len), 4)
    tout = tllama.prefill(tparams["llm"], tcfg, torch.from_numpy(x), torch.from_numpy(am),
                          torch.from_numpy(pos))
    np.testing.assert_allclose(tout["kv"].k.numpy(), np.asarray(jout["kv"].k), atol=KV_ATOL)
    np.testing.assert_allclose(tout["kv"].v.numpy(), np.asarray(jout["kv"].v), atol=KV_ATOL)
    ttoks, tmargins = tllama.greedy_decode(tparams["llm"], tcfg, tout["kv"], torch.from_numpy(am),
                                           torch.from_numpy(first).long(),
                                           torch.from_numpy(mm_len).long(), 4)
    assert len(np.unique(np.asarray(jtoks))) > 1
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(tmargins.numpy(), np.asarray(jmargins), atol=ATOL)

