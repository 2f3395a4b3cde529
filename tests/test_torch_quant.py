"""The port's int8 serving-tier pieces vs the JAX package, on the CPU.

* quantize_weight / quantize_params(TURBO_QUANT_SUFFIXES): codes and scales
  bit-identical to the JAX package's; the quantized parameter layout is the
  JAX pytree's, and params_from_jax / init_params make it.
* The plain versions of the four kernels of the `pallas` tier vs the JAX
  Pallas kernels run in interpret mode (``force_tpu_interpret_mode`` for the
  wi8 matmul, ``interpret=True`` for the others):
  - wi8_matmul: products are exact in both (bf16(q) is exact) and the sums
    are fp32 in another order, so fp32 outputs within 1e-5 relative and bf16
    outputs within one bf16 rounding step (rtol 8e-3).
  - fused_ln_w8a8 / fused_mlp_residual: the activation codes within one
    step of the JAX package's (the fp32 LayerNorm sums run in another order,
    so a value at a rounding edge may land one code apart), and outputs
    within 2e-2 relative + 2e-2 absolute: one code step moves an output by
    at most 127 · sx · s, about 1 % of the output's scale here.
  - decode_flash_attention: fp32 1e-5, bf16 2e-2 (as the other attention
    kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvla_probe_tpu.models import vit as jvit
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import decode_attention as jdec
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu.ops import vit_mlp as jmlp
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import decode_attention as tdec
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.ops import vit_mlp as tmlp

JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(arr: np.ndarray, dtype: str):
    """The same values on both sides (rounded to `dtype` once, by JAX)."""
    j = jnp.asarray(arr, JNP_DT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH_DT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _qw(rng, n, k, dtype="float32"):
    """A per-channel int8 leaf quantized by JAX from N(0, 0.05) weights, and the port's copy."""
    w = jlin.quantize_weight(jnp.asarray(rng.normal(0, 0.05, (n, k)), JNP_DT[dtype]))
    jw = {"q": w["q"], "s": w["s"]}
    tw = {"q": torch.from_numpy(np.array(w["q"])), "s": torch.from_numpy(np.array(w["s"]))}
    return jw, tw


# --- quantization ----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(40, 96), (3, 64, 48)])
def test_quantize_weight_bit_identical(dtype, shape):
    w = np.random.default_rng(0).normal(0, 0.02, shape)
    w[..., 0, :] = 0.0                       # an all-zero channel: the 1e-8 scale floor
    jw, tw = _pair(w, dtype)
    want = jlin.quantize_weight(jw)
    got = tlin.quantize_weight(tw)
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.fixture(scope="module")
def tiny_params():
    cfg = jvlm.VLMConfig.tiny()
    return cfg, convert.config_from_jax(cfg), jvlm.init_params(cfg, jax.random.key(0))


def test_quantize_params_turbo_bit_identical(tiny_params):
    jcfg, tcfg, params = tiny_params
    want = _flat(jax.tree.map(np.asarray, jlin.quantize_params(
        params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8)))
    fparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    got = _flat(tlin.quantize_params(fparams, suffixes=tlin.TURBO_QUANT_SUFFIXES))
    assert got.keys() == want.keys()
    assert sum(k.endswith("/q") for k in got) == 8 + 2 * 4     # trunk + lm_head, 4 per tower
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert tlin.TURBO_QUANT_SUFFIXES == jlin.TURBO_QUANT_SUFFIXES


def test_quantize_params_other_bits_raise():
    """bits=3 raises; mix (ported since) gives the dual leaf."""
    with pytest.raises(ValueError, match="bits must be"):
        tlin.quantize_params({"q_proj": torch.zeros(2, 2)}, bits=3)
    got = tlin.quantize_params({"q_proj": torch.ones(2, 2)}, bits="mix")
    assert tlin.is_mixed_quant(got["q_proj"])


@pytest.mark.parametrize("name", ["tiny", "openvla_7b"])
def test_quantized_layout_matches_jax(name):
    """vlm_param_spec(quant_suffixes) is the layout of the JAX package's
    quantize_params(..., TURBO_QUANT_SUFFIXES, bits=8) (shapes only)."""
    jcfg = getattr(jvlm.VLMConfig, name)()
    shapes = _flat(jax.eval_shape(lambda k: jlin.quantize_params(
        jvlm.init_params(jcfg, k), suffixes=jlin.TURBO_QUANT_SUFFIXES), jax.random.key(0)))
    spec = _flat(convert.vlm_param_spec(convert.config_from_jax(jcfg),
                                        tlin.TURBO_QUANT_SUFFIXES))
    assert spec.keys() == shapes.keys()
    for k, s in shapes.items():
        assert spec[k].shape == tuple(s.shape), k
        assert str(spec[k].dtype).removeprefix("torch.") == np.dtype(s.dtype).name, k


def test_params_from_jax_quantized(tiny_params):
    jcfg, tcfg, params = tiny_params
    tree = jax.tree.map(np.asarray, jlin.quantize_params(params, suffixes=jlin.TURBO_QUANT_SUFFIXES))
    got = _flat(convert.params_from_jax(tree, tcfg, device="cpu",
                                        quant_suffixes=tlin.TURBO_QUANT_SUFFIXES))
    want = _flat(tree)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    # an int8 leaf where the layout has a float one, and the other way round
    with pytest.raises(NotImplementedError, match="quant_suffixes"):
        convert.params_from_jax(tree, tcfg, device="cpu")
    with pytest.raises(ValueError):
        convert.params_from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu",
                                quant_suffixes=tlin.TURBO_QUANT_SUFFIXES)


def test_init_params_quantized(tiny_params):
    _, tcfg, _ = tiny_params
    got = _flat(convert.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu",
                                    quant_suffixes=tlin.TURBO_QUANT_SUFFIXES))
    spec = _flat(convert.vlm_param_spec(tcfg, tlin.TURBO_QUANT_SUFFIXES))
    assert got.keys() == spec.keys()
    for k, leaf in spec.items():
        assert tuple(got[k].shape) == leaf.shape and got[k].dtype == leaf.dtype, k
    q, s = got["/llm/layers/gate_proj/q"], got["/llm/layers/gate_proj/s"]
    assert q.abs().amax(-1).eq(127).all()                  # absmax quantization per channel
    w = tlin.dequantize_weight({"q": q, "s": s}, torch.float32)
    assert abs(w.std().item() - 0.02) < 2e-3


# --- Queue 2 row 7: the weight-only int8 matmul ------------------------------------


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 8e-3)])
@pytest.mark.parametrize("M", [5, 40])
def test_wi8_plain_matches_jax_kernel(dtype, rtol, M):
    r = np.random.default_rng(M)
    K, N = 96, 80
    jx, tx = _pair(r.normal(size=(M, K)), dtype)
    jw, tw = _qw(r, N, K)
    with pltpu.force_tpu_interpret_mode():
        want = jlin._wi8_matmul_2d(jx, jw["q"], jw["s"])
    got = tlin.wi8_matmul(tx, tw["q"], tw["s"])
    assert got.dtype == TORCH_DT[dtype] and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=1e-6)


def test_matmul_t_int8_leaf_flattens_leading_dims():
    r = np.random.default_rng(3)
    _, tw = _qw(r, 24, 32)
    x = torch.from_numpy(r.normal(size=(2, 5, 32)).astype(np.float32))
    got = tlin.matmul_t(x, tw)
    want = tlin.wi8_matmul_plain(x.reshape(10, 32), tw["q"], tw["s"]).reshape(2, 5, 24)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# --- Queue 2 rows 10 and 11: the fused int8 tower kernels -----------------------------


def _codes_close(jh, th):
    """Activation codes of the same LN output on both sides, within one step."""
    jq, _ = jmlp._quantize_rows(jnp.asarray(jh).astype(jnp.float32))
    tq, _ = tmlp.quantize_rows(th.float())
    diff = np.abs(np.asarray(jq, np.int32) - tq.numpy().astype(np.int32))
    assert diff.max() <= 1
    return (diff > 0).mean()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["ln", "res_ls", "res"])
def test_fused_ln_w8a8_plain_matches_jax_kernel(dtype, form):
    r = np.random.default_rng(11)
    M, K, N = 37, 48, 80
    jx, tx = _pair(r.normal(size=(M, K)), dtype)
    jw, tw = _qw(r, N, K)
    jb, tb = _pair(r.normal(0, 0.1, N), dtype)
    kw_j, kw_t = {}, {}
    if form == "ln":
        (js, ts), (jbi, tbi) = _pair(1 + 0.1 * r.normal(size=K), dtype), _pair(0.1 * r.normal(size=K), dtype)
        kw_j["ln"], kw_t["ln"] = (js, jbi), (ts, tbi)
        _codes_close(jvit.layer_norm(jx, js, jbi, 1e-6), tmlp._layer_norm_f32(tx, ts, tbi, 1e-6).to(tx.dtype))
    else:
        kw_j["res"], kw_t["res"] = _pair(r.normal(size=(M, N)), dtype)
        if form == "res_ls":
            kw_j["ls"], kw_t["ls"] = _pair(r.normal(size=N), dtype)
    want = jmlp.fused_ln_w8a8(jx, jw, jb, interpret=True, **kw_j)
    got = tmlp.fused_ln_w8a8(tx, tw, tb, **kw_t)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    if form != "ln":   # no LayerNorm: the same codes and integer sums; XLA may round
        # the fp32 epilogue once differently (1 ulp), then one bf16 step
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6 if dtype == "float32" else 8e-3,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["gelu_tanh", "gelu"])
@pytest.mark.parametrize("layerscale", [True, False])
def test_fused_mlp_plain_matches_jax_kernel(dtype, act, layerscale):
    r = np.random.default_rng(12)
    M, D, Fd = 37, 32, 80                      # F = 80: no multiple of 32
    jx, tx = _pair(r.normal(size=(M, D)), dtype)
    (js, ts), (jbi, tbi) = _pair(1 + 0.1 * r.normal(size=D), dtype), _pair(0.1 * r.normal(size=D), dtype)
    jw1, tw1 = _qw(r, Fd, D)
    jw2, tw2 = _qw(r, D, Fd)
    (jb1, tb1), (jb2, tb2) = _pair(r.normal(0, 0.1, Fd), dtype), _pair(r.normal(0, 0.1, D), dtype)
    jls, tls = _pair(r.normal(size=D) if layerscale else np.ones(D), dtype)
    want = jmlp.fused_mlp_residual(jx, js, jbi, jw1, jb1, jw2, jb2, jls, act=act, interpret=True)
    got = tmlp.fused_mlp_residual(tx, ts, tbi, tw1, tb1, tw2, tb2, tls, act=act)
    assert got.dtype == TORCH_DT[dtype] and got.shape == (M, D)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)
    _codes_close(jvit.layer_norm(jx, js, jbi, 1e-6), tmlp._layer_norm_f32(tx, ts, tbi, 1e-6).to(tx.dtype))


def test_int8_dot_is_exact():
    """The plain versions' integer sums: float64 products of int8 codes are
    exact, where fp32 would round past 2**24."""
    codes = torch.full((2, 4304), 127, dtype=torch.int8)
    q = torch.full((3, 4304), -127, dtype=torch.int8)
    assert tmlp.int8_dot(codes, q).eq(float(np.float32(-127 * 127 * 4304))).all()
    assert tmlp.int8_dot(codes[:, :5], q[:, :5]).eq(-127 * 127 * 5).all()


# --- Queue 2 row 4: the frozen-KV decode kernel -----------------------------------------


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_decode_split_plain_matches_jax_kernel(dtype, tol):
    r = np.random.default_rng(13)
    B, T, A, H, Dh = 2, 21, 6, 3, 16
    jq, tq = _pair(r.normal(size=(B, 1, H, Dh)), dtype)
    (jkp, tkp), (jvp, tvp) = _pair(r.normal(size=(B, T, H, Dh)), dtype), _pair(r.normal(size=(B, T, H, Dh)), dtype)
    (jkd, tkd), (jvd, tvd) = _pair(r.normal(size=(B, A, H, Dh)), dtype), _pair(r.normal(size=(B, A, H, Dh)), dtype)
    pre = np.ones((B, T), np.int32)
    pre[1, 12:] = 0                             # right-padded prompt
    dec = np.zeros((B, A), np.int32)
    dec[:, :3] = 1                              # decode step 2: slots 0..2 written
    want = jdec.decode_flash_attention(jq, jkp, jvp, jkd, jvd, jnp.asarray(pre), jnp.asarray(dec),
                                       interpret=True)
    _build.reset_launch_counts()
    got = tdec.decode_flash_attention(tq, tkp, tvp, tkd, tvd, torch.from_numpy(pre),
                                      torch.from_numpy(dec))
    assert got.dtype == TORCH_DT[dtype] and got.shape == (B, 1, H, Dh)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}     # the CPU takes the plain version
