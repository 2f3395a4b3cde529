"""The port's nibble weights (the JAX package's bench default) and the `turbo`
tier over them vs the JAX package, on the CPU at tiny sizes.

* quantize_weight_nibble / quantize_params(bits="nibble"): planes and scales
  bit-identical to the JAX package's (planes compared unpacked), the Llama
  trunk and lm_head as planes, the towers int8; params_from_jax packs the JAX
  s4 planes and its emit_codes=True int8 codes alike.
* The reconstruct 16·hi + lo + 8 is exact on all 255 codes and equal to the
  JAX ``nibble_reconstruct_q8``.
* nib_hi_dot_plain vs ``_nib_hi_dot``, bit for bit (the same codes, exact
  integer sums, the same fp32 operations in the same order).
* Dispatch (``_nib_matmul``): M = 32 takes the hi plane, M = 33 the exact
  codes through w8a8, bit-equal there to the int8 leaf of the same weights.
* End to end (`turbo` over nibble weights, B = 3, P = 64, the JAX side as in
  tests/test_torch_turbo.py without the fused norm, which nibble leaves stand
  down): tokens and actions equal, first logits and margins within 2e-2
  (found 4.5e-3 and 5.6e-3, for the reasons given there). At this seed every
  token's margin is at least 5.2 times its difference (smallest 6.5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_pallas_tier import _img_cfg, _inputs
from tests.test_torch_turbo import _np, _pair, count_calls, jax_turbo

VOCAB = 512
A = 7
P = 64
ATOL = 2e-2
SEED = 11         # margins at least 5.2x their difference (module docstring)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _nib_pair(rng, n, k):
    w = rng.normal(0, 0.05, (n, k)).astype(np.float32)
    return (jlin.quantize_weight_nibble(jnp.asarray(w)),
            tlin.quantize_weight_nibble(torch.from_numpy(w)))


# --- quantization -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(40, 96), (3, 24, 64)])
def test_quantize_weight_nibble_bit_identical(dtype, shape):
    w = np.random.default_rng(0).normal(0, 0.02, shape)
    w[..., 0, :] = 0.0                       # an all-zero channel: the 1e-8 scale floor
    jw, tw = _pair(w, dtype)
    want = jlin.quantize_weight_nibble(jw, emit_codes=True)
    got = tlin.quantize_weight_nibble(tw)
    assert tlin.is_nibble_quant(got) and not tlin.is_quantized(got)
    assert got["hi"].dtype == got["lo"].dtype == torch.uint8
    assert got["hi"].shape == (*shape[:-1], shape[-1] // 2)
    for plane in ("hi", "lo"):
        np.testing.assert_array_equal(tlin.unpack_int4(got[plane]).numpy(), np.asarray(want[plane]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(tlin.dequantize_weight(got, torch.float32).numpy(),
                                  _np(jlin.dequantize_weight(want, jnp.float32)))


def test_reconstruct_exact_on_all_codes():
    """One channel whose int8 codes are every value of [-127, 127]: the planes
    give them back exactly, as the JAX reconstruct does (its intermediate
    16·hi + lo wraps in int8 for q8 <= -121, and the + 8 wraps back)."""
    codes = np.arange(-127, 128, dtype=np.float32)
    w = np.concatenate([codes, np.zeros(1, np.float32)])[None]          # [1, 256], s = 1
    got = tlin.quantize_weight_nibble(torch.from_numpy(w))
    q8 = tlin.nibble_reconstruct_q8(got)
    assert q8.dtype == torch.int8
    np.testing.assert_array_equal(q8[0, :255].numpy(), codes.astype(np.int8))
    jw = jlin.quantize_weight_nibble(jnp.asarray(w))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jlin.nibble_reconstruct_q8(jw)))
    np.testing.assert_array_equal(q8.numpy(), tlin.quantize_weight(torch.from_numpy(w))["q"].numpy())


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jvlm.VLMConfig.tiny()
    return cfg, convert.config_from_jax(cfg), jvlm.init_params(cfg, jax.random.key(0))


def test_quantize_params_nibble_bit_identical(tiny_params):
    """bits="nibble" over TURBO_QUANT_SUFFIXES: planes for the 7 trunk leaves
    and lm_head, per-channel int8 for the 4 tower leaves of each tower."""
    _, tcfg, params = tiny_params
    want = _flat(jax.tree.map(np.asarray, jlin.quantize_params(
        params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits="nibble", emit_codes=True)))
    fparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    got = _flat(tlin.quantize_params(fparams, suffixes=tlin.TURBO_QUANT_SUFFIXES, bits="nibble"))
    assert got.keys() == want.keys()
    packed = [k for k, v in got.items() if v.dtype == torch.uint8]
    assert len(packed) == 2 * 8 and all(k.startswith("/llm/") for k in packed)
    assert got["/vision/siglip/blocks/fc2_w/q"].dtype == torch.int8
    for k in want:
        g = tlin.unpack_int4(got[k]) if k in packed else got[k]
        np.testing.assert_array_equal(g.numpy(), want[k], err_msg=k)


@pytest.mark.parametrize("codes", [False, True], ids=["s4", "emit_codes"])
def test_params_from_jax_nibble(tiny_params, codes):
    """The JAX s4 planes and its int8 codes both convert to the packed layout."""
    _, tcfg, params = tiny_params
    tree = jax.tree.map(np.asarray, jlin.quantize_params(
        params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits="nibble", emit_codes=codes))
    assert (tree["llm"]["lm_head"]["hi"].dtype.name == "int8") == codes
    got = _flat(convert.params_from_jax(tree, tcfg, device="cpu",
                                        quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits="nibble"))
    want = _flat(tree)
    assert got.keys() == want.keys()
    for k in want:
        g = tlin.unpack_int4(got[k]) if got[k].dtype == torch.uint8 else got[k]
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k], dtype=g.numpy().dtype),
                                      err_msg=k)
    with pytest.raises(KeyError):   # nibble planes where the layout has int8 leaves
        convert.params_from_jax(tree, tcfg, device="cpu",
                                quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits=8)


@pytest.mark.parametrize("name", ["tiny", "openvla_7b"])
def test_nibble_layout_matches_jax(name):
    """vlm_param_spec(bits="nibble") is the layout of the JAX package's
    quantize_params(..., TURBO_QUANT_SUFFIXES, bits="nibble"), the planes'
    last dim halved by the packing (shapes only)."""
    jcfg = getattr(jvlm.VLMConfig, name)()
    shapes = _flat(jax.eval_shape(lambda k: jlin.quantize_params(
        jvlm.init_params(jcfg, k), suffixes=jlin.TURBO_QUANT_SUFFIXES, bits="nibble",
        emit_codes=True), jax.random.key(0)))
    spec = _flat(convert.vlm_param_spec(convert.config_from_jax(jcfg),
                                        tlin.TURBO_QUANT_SUFFIXES, bits="nibble"))
    assert spec.keys() == shapes.keys()
    for k, s in shapes.items():
        want = tuple(s.shape)
        if spec[k].dtype == torch.uint8:
            want = (*want[:-1], want[-1] // 2)
        else:
            assert str(spec[k].dtype).removeprefix("torch.") == np.dtype(s.dtype).name, k
        assert spec[k].shape == want, k


def test_init_params_nibble(tiny_params):
    _, tcfg, _ = tiny_params
    got = _flat(convert.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                                    quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits="nibble"))
    spec = _flat(convert.vlm_param_spec(tcfg, tlin.TURBO_QUANT_SUFFIXES, bits="nibble"))
    assert got.keys() == spec.keys()
    for k, leaf in spec.items():
        assert tuple(got[k].shape) == leaf.shape and got[k].dtype == leaf.dtype, k
    w = {p: got[f"/llm/layers/down_proj/{p}"] for p in ("hi", "lo", "s")}
    for p in ("hi", "lo"):
        codes = tlin.unpack_int4(w[p])
        assert codes.min() == -8 and codes.max() == 7
    assert tlin.nibble_reconstruct_q8(w).abs().amax(-1).eq(127).all()   # absmax per channel
    assert abs(tlin.dequantize_weight(w, torch.float32).std().item() - 0.02) < 2e-3


# --- the products -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", [(1, 96, 40), (24, 64, 136), (32, 256, 48)])
def test_nib_hi_dot_plain_matches_jax(dtype, M, K, N):
    r = np.random.default_rng(M + K)
    jx, tx = _pair(r.normal(size=(M, K)), dtype)
    jw, tw = _nib_pair(r, N, K)
    want = jlin._nib_hi_dot(jx, jw["hi"], jw["s"])
    _build.reset_launch_counts()
    got = tlin.nib_hi_dot(tx, tw["hi"], tw["s"])
    assert got.dtype == _np_dtype(dtype) and got.shape == (M, N)
    np.testing.assert_array_equal(_np(got), _np(want))
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}


def _np_dtype(dtype):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]


@pytest.mark.parametrize("M,route", [(32, "nib_hi_dot"), (33, "w8a8_matmul")])
def test_nib_matmul_dispatch(monkeypatch, M, route):
    """matmul_t on a nibble leaf takes the hi plane up to M = 32 (decode and
    the first token's lm_head at B = 24) and the exact codes above, each
    equal to the JAX ``_nib_matmul`` at that M; above, it equals the int8
    leaf of the same weights bit for bit, whatever the int8 route."""
    r = np.random.default_rng(M)
    K, N = 64, 40
    w = r.normal(0, 0.05, (N, K)).astype(np.float32)
    jw, tw = jlin.quantize_weight_nibble(jnp.asarray(w)), tlin.quantize_weight_nibble(torch.from_numpy(w))
    x = r.normal(size=(M, K)).astype(np.float32)
    taken = {}
    count_calls(monkeypatch, tlin, ["nib_hi_dot", "w8a8_matmul"], taken)
    got = tlin.matmul_t(torch.from_numpy(x), tw)
    assert taken == {route: 1}
    np.testing.assert_array_equal(got.numpy(), np.asarray(jlin._nib_matmul(jnp.asarray(x), jw)))
    if route == "w8a8_matmul":
        int8 = tlin.quantize_weight(torch.from_numpy(w))
        np.testing.assert_array_equal(got.numpy(),
                                      tlin.matmul_t(torch.from_numpy(x), int8, "w8a8").numpy())
        codes, sx = tlin.quantize_rows(torch.from_numpy(x))
        with pytest.raises(TypeError, match="nibble"):    # the fused norm never feeds planes
            tlin.w8a8_matmul(tlin.PrequantActivation(codes, sx, torch.float32), tw)


# --- end to end -----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), "turbo", action_dim=A,
                                             prompt_pad_len=P, codec_vocab_size=VOCAB)
    params = jlin.quantize_params(jvlm.init_params(serving.vlm, jax.random.key(SEED)),
                                  suffixes=jlin.TURBO_QUANT_SUFFIXES, bits="nibble")
    tserving = convert.config_from_jax(serving)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu", quant_suffixes=tlin.TURBO_QUANT_SUFFIXES,
                                      bits="nibble")
    return serving, params, tserving, tparams


@pytest.fixture(scope="module")
def both(models):
    serving, params, tserving, tparams = models
    img, ids, plen, q01, q99, mask = _inputs()
    with jax_turbo(rmsq=False):
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
        want = jax.tree.map(np.asarray, want)
    routes = {}
    with pytest.MonkeyPatch.context() as mp:
        count_calls(mp, tlin, ["w8a8_matmul", "nib_hi_dot", "wi8_matmul"], routes)
        count_calls(mp, tllama, ["rms_norm_quant"], routes)
        _build.reset_launch_counts()
        got = tvla.predict_action_from_image(
            tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
            return_first_logits=True, device="cpu")
    return want, {k: v.numpy() for k, v in got.items()}, routes


def test_action_tokens_and_actions_equal(both):
    want, got, _ = both
    assert got["action_tokens"].shape == (3, A)
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
    """As chip_smoke.py counts them at 7B: the towers' int8 linears and the
    prefill's nibble linears on w8a8, the decode steps' and every lm_head on
    the hi plane, no fused norm (nibble leaves stand it down)."""
    _, _, routes = both
    c = models[2].vlm
    L, A1 = c.llm.num_hidden_layers, A - 1
    blocks = sum(v.num_layers - 1 for v in c.vision)
    assert routes == {"w8a8_matmul": 4 * blocks + 7 * L, "nib_hi_dot": 7 * L * A1 + A}
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}
