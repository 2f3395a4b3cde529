"""Mix weights (int8 + grouped-int4 copies of the decode stream) and grouped
int4 off the kernel gate on the port's `turbo` tier vs the JAX package, on the
CPU at tiny sizes, with inputs made from seeded numpy generators.

The JAX side runs in `tests.test_torch_turbo.jax_turbo` with
OVLA_PALLAS_W4A8=0 too: under OVLA_PALLAS=1 in interpret mode its
``_use_pallas_w4a8`` would otherwise send int4 leaves to the Pallas kernel
instead of ``_w4a8_dot_grouped`` (mix leaves never consult it).

* ``quantize_weight_mixed`` and ``quantize_params(bits="mix")``: codes and
  scales bit for bit (int4 codes compared unpacked), the ungroupable in-dim
  collapsing to one int8 leaf, the towers single-copy int8 (mirrors
  tests/test_mixed_quant.py); ``params_from_jax`` packs mix trees from s4
  and from emit_codes=True int8 codes; ``init_params(bits="mix")`` gives
  the layout.
* ``w4a8_grouped_plain`` vs ``_w4a8_dot_grouped``: the same codes and exact
  int32 group sums; fp32 within 1e-6 relative (the group fold's sum order:
  XLA's einsum order is unspecified; found 1.2e-7), bf16 within one rounding
  step (2^-7 relative).
* Which copy each M reads (ROADMAP Queue 3's hazard), spied in both
  packages on the same speculative call: the verify trunk (M = B·(T + A))
  the int8 copy, the greedy lm_head at M = B·A the int4 copy exactly when
  B·A <= 32 (B = 3: 21; B = 5: 35), every continuation step (M = B) the int4
  copy; on grouped-int4 leaves the requant route above M = 32 and the
  grouped dot at and below it.
* The fused-norm gate on mix leaves: at M <= 32 the norm stays plain (the
  int4 copy takes float activations), above it the consumers take the int8
  copy's codes (JAX ``_norm_maybe_quant``).
* End to end, `turbo` over bits=4 and bits="mix": first logits and margins
  within 2e-2, action tokens equal where the margins allow
  (tests/test_torch_turbo_kv8.py::assert_tokens). Found at the seeds below:
  int4 first-logit gap 4.3e-3, 15 of 21 tokens compared; mix 5.2e-3, 14 of
  21; every one of the 21 equal in both (a sweep of seeds 0-6: 4-20 compared
  a seed, all 21 equal at 13 of the 14 runs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvla_probe_tpu.ops.linear as jlin
from openvla_probe_tpu.models import llama as jllama
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_openvla import _ovla_env, clean_ovla_env  # noqa: F401 (autouse)
from tests.test_torch_pallas_tier import _img_cfg
from tests.test_torch_probe_taps import _inputs
from tests.test_torch_turbo import jax_turbo
from tests.test_torch_turbo_kv8 import assert_tokens

VOCAB = 512
A = 7
P = 64
ATOL = 2e-2
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SEEDS = {4: 3, "mix": 5}
COMPARED = {4: 15, "mix": 14}    # tokens compared at those seeds, of 21 (module docstring)


def jax_turbo_w4():
    """jax_turbo with the Pallas w4a8 gate closed (module docstring)."""
    ctx = jax_turbo()

    class _Ctx:
        def __enter__(self):
            mp = ctx.__enter__()
            mp.setenv("OVLA_PALLAS_W4A8", "0")
            return mp

        def __exit__(self, *exc):
            return ctx.__exit__(*exc)

    return _Ctx()


def _codes(x):
    """An int4 / int8 JAX array as int8 numpy codes."""
    return np.asarray(jnp.asarray(x).astype(jnp.int8))


# --- quantization ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,gsz", [((64, 128), 32), ((40, 256), 128), ((2, 24, 96), 32),
                                       ((16, 48), 32)], ids=["g32", "g128", "stacked", "collapse"])
def test_quantize_weight_mixed_bit_identical(dtype, shape, gsz):
    w = np.random.default_rng(sum(shape)).normal(0, 0.05, shape)
    jw = jnp.asarray(w, JNP_DT[dtype])
    want = jlin.quantize_weight_mixed(jw, group_size=gsz)
    got = tlin.quantize_weight_mixed(torch.from_numpy(np.array(jw.astype(jnp.float32)))
                                     .to(TORCH_DT[dtype]), group_size=gsz)
    assert set(got) == set(want)
    assert tlin.is_mixed_quant(got) == jlin.is_mixed_quant(want)
    np.testing.assert_array_equal(got["q"].numpy(), _codes(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    if "q4" in want:
        np.testing.assert_array_equal(tlin.unpack_int4(got["q4"]).numpy(), _codes(want["q4"]))
        np.testing.assert_array_equal(got["s4"].numpy(), np.asarray(want["s4"]))
        assert not tlin.is_grouped_int4(got) and not tlin.is_int8_per_channel(got)


@pytest.fixture(scope="module")
def mix_tree():
    cfg = jvlm.VLMConfig.tiny()
    params = jvlm.init_params(cfg, jax.random.key(2))
    return cfg, params, jlin.quantize_params(params, suffixes=jlin.TURBO_QUANT_SUFFIXES,
                                             bits="mix")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def test_quantize_params_mix_bit_identical(mix_tree):
    cfg, params, want = mix_tree
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                      convert.config_from_jax(cfg), device="cpu")
    got = _flat(tlin.quantize_params(tparams, suffixes=tlin.TURBO_QUANT_SUFFIXES, bits="mix"))
    want = _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        g = tlin.unpack_int4(got[k]) if got[k].dtype == torch.uint8 else got[k]
        np.testing.assert_array_equal(g.numpy(), _codes(want[k]) if k.endswith(("/q", "/q4"))
                                      else np.asarray(want[k]), err_msg=k)
    # the decode stream dual-copy, the towers single-copy int8
    assert sum(k.endswith("/q4") for k in got) == 8
    assert sum(k.endswith("/q") for k in got) == 8 + 2 * 4


@pytest.mark.parametrize("codes", [False, True], ids=["s4", "emit_codes"])
def test_params_from_jax_mix(mix_tree, codes):
    cfg, params, _ = mix_tree
    q = jlin.quantize_params(params, suffixes=jlin.TURBO_QUANT_SUFFIXES, bits="mix",
                             emit_codes=codes)
    tcfg = convert.config_from_jax(cfg)
    got = convert.params_from_jax(jax.tree.map(np.asarray, q), tcfg, device="cpu",
                                  quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits="mix")
    leaf, jleaf = got["llm"]["layers"]["down_proj"], q["llm"]["layers"]["down_proj"]
    assert tlin.is_mixed_quant(leaf)
    np.testing.assert_array_equal(tlin.unpack_int4(leaf["q4"]).numpy(), _codes(jleaf["q4"]))
    np.testing.assert_array_equal(leaf["q"].numpy(), _codes(jleaf["q"]))
    assert tlin.is_int8_per_channel(got["vision"]["dino"]["blocks"]["fc1_w"])
    spec = convert.vlm_param_spec(tcfg, tlin.TURBO_QUANT_SUFFIXES, "mix")
    init = convert.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                               quant_suffixes=tlin.TURBO_QUANT_SUFFIXES, bits="mix")
    fi, fs = _flat(init), _flat(spec)
    for k, leaf in fs.items():
        assert tuple(fi[k].shape) == leaf.shape and fi[k].dtype == leaf.dtype, k


# --- the grouped product --------------------------------------------------------------


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("bfloat16", 2.0 ** -7)])
@pytest.mark.parametrize("M,K,N,gsz", [(3, 256, 40, 128), (5, 96, 24, 32), (24, 512, 64, 256),
                                       (32, 1152, 136, 128)])
def test_w4a8_grouped_plain_matches_jax(dtype, rtol, M, K, N, gsz):
    r = np.random.default_rng(M + K + N)
    G = K // gsz
    jx = jnp.asarray(r.normal(size=(M, K)), JNP_DT[dtype])
    codes = r.integers(-7, 8, (G, N, gsz)).astype(np.int8)
    s = (r.random((N, G)) * 2e-3 + 2e-3).astype(np.float32)
    want = jlin._w4a8_dot_grouped(jx, jnp.asarray(codes).astype(jnp.int4), jnp.asarray(s))
    _build.reset_launch_counts()
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(TORCH_DT[dtype])
    got = tlin.w4a8_grouped(tx, tlin.pack_int4(torch.from_numpy(codes)), torch.from_numpy(s))
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}     # the CPU takes the plain version
    assert got.dtype == TORCH_DT[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=1e-7)


def test_w4a8_grouped_columns_do_not_depend_on_n():
    """A column's output is the same in any leaf it sits in (the fusion's promise)."""
    r = np.random.default_rng(0)
    x = torch.from_numpy(r.normal(size=(4, 256)).astype(np.float32)).bfloat16()
    codes = torch.from_numpy(r.integers(-7, 8, (2, 48, 128)).astype(np.int8))
    s = torch.from_numpy((r.random((48, 2)) * 1e-2).astype(np.float32))
    whole = tlin.w4a8_grouped_plain(x, tlin.pack_int4(codes), s)
    part = tlin.w4a8_grouped_plain(x, tlin.pack_int4(codes[:, 8:24].contiguous()),
                                   s[8:24].contiguous())
    assert torch.equal(whole[:, 8:24], part)


@pytest.mark.parametrize("M", [8, 32, 33])
def test_matmul_t_mix_reads_one_copy(M):
    """M <= 32: the int4 copy through w4a8_grouped; above: the int8 copy
    through w8a8_matmul (tests/test_mixed_quant.py::test_mixed_matmul_dispatch_by_m)."""
    r = np.random.default_rng(M)
    w = r.normal(size=(48, 64)).astype(np.float32)
    mw = tlin.quantize_weight_mixed(torch.from_numpy(w), group_size=32)
    x = torch.from_numpy(r.normal(size=(M, 64)).astype(np.float32)).bfloat16()
    got = tlin.matmul_t(x, mw, "wi8")     # any route
    if M <= 32:
        want = tlin.w4a8_grouped_plain(x, mw["q4"], mw["s4"])
    else:
        want = tlin.w8a8_matmul_plain(x, {"q": mw["q"], "s": mw["s"]})
    assert torch.equal(got, want)
    jw = jlin.quantize_weight_mixed(jnp.asarray(w), group_size=32)
    jwant = jlin.matmul_t(jnp.asarray(x.float().numpy(), jnp.bfloat16), jw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jwant.astype(jnp.float32)),
                               rtol=2.0 ** -7, atol=1e-6)


@pytest.mark.parametrize("M", [9, 32, 33])
def test_fused_norm_gate_on_mix_leaves(M):
    """JAX ``_norm_maybe_quant``: a mix consumer counts as w8a8 only above
    M = 32, where it reads its int8 copy."""
    cfg = tvla.turbo_routes(tvlm.VLMConfig.tiny().turbo()).llm
    r = np.random.default_rng(M)
    w = tlin.quantize_weight_mixed(torch.from_numpy(r.normal(size=(64, 64)).astype(np.float32)))
    x = torch.from_numpy(r.normal(size=(1, M, 64)).astype(np.float32))
    h = tllama._norm_maybe_quant(cfg, x, torch.ones(64), (w, w))
    fused = isinstance(h, tlin.PrequantActivation)
    assert fused == (M > 32)
    with jax_turbo_w4():
        jh = jllama._norm_maybe_quant(jllama.LlamaConfig.tiny(), jnp.asarray(x.numpy()),
                                      jnp.ones(64), (jlin.quantize_weight_mixed(
                                          jnp.asarray(r.normal(size=(64, 64)))),))
    assert isinstance(jh, jlin.PrequantActivation) == fused


# --- the route each M reads, on one speculative call ----------------------------------


# the trunk's (K, N): q/k/v/o, gate/up, down, lm_head of LlamaConfig.tiny (the towers'
# are (32, 96), (32, 32), (32, 64), (64, 32))
TRUNK_KN = {(64, 64), (64, 128), (128, 64), (64, VOCAB)}


class _Spy:
    """Records (M, copy) of every trunk product through the named routes of
    `module`: 'int4' (the grouped dot), 'int8' (w8a8 on an int8 copy) or
    'requant'."""

    def __init__(self, mp, module, names):
        self.seen = set()
        for name, tag in zip(names, ("int4", "int8", "requant")):
            real = getattr(module, name)

            def spy(x2, *a, real=real, tag=tag):
                n = (a[0]["s"] if isinstance(a[0], dict) else a[1]).shape[0]
                if (int(x2.shape[-1]), int(n)) in TRUNK_KN:
                    self.seen.add((int(x2.shape[0]), tag))
                return real(x2, *a)

            mp.setattr(module, name, spy)


def _build_tier(bits, seed):
    with clean_ovla_env():
        serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), "turbo", action_dim=A,
                                                 prompt_pad_len=P, codec_vocab_size=VOCAB)
        params = jlin.quantize_params(jvlm.init_params(serving.vlm, jax.random.key(seed)),
                                      suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=bits)
        tserving = convert.config_from_jax(serving)
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                          device="cpu", quant_suffixes=tlin.TURBO_QUANT_SUFFIXES,
                                          bits=bits)
    return serving, params, tserving, tparams


@pytest.fixture(scope="module")
def tiers():
    cache = {}
    return lambda bits: cache[bits] if bits in cache else cache.setdefault(
        bits, _build_tier(bits, SEEDS[bits]))


@pytest.mark.parametrize("bits", ["mix", 4])
@pytest.mark.parametrize("B", [3, 5])
def test_copy_of_each_m(tiers, bits, B):
    serving, params, tserving, tparams = tiers(bits)
    img, ids, plen, q01, q99, mask = _inputs(VOCAB)
    r = np.random.default_rng(B)
    rows = r.integers(0, 3, B)
    wrong = r.integers(0, VOCAB, (B, A)).astype(np.int32)
    T = 1 + serving.vlm.num_patches + P - 1
    with pytest.MonkeyPatch.context() as mp, jax_turbo_w4():
        jspy = _Spy(mp, jlin, ("_w4a8_dot_grouped", "_w8a8_matmul", "_w4a8_dot_requant"))
        pixels = jimage.apply_image_transform(jnp.asarray(img[rows]), _img_cfg(jimage)).astype(
            serving.vlm.llm.dtype)
        jout = jax.tree.map(np.asarray, jvla.predict_action_speculative_core(
            params, serving, pixels, jnp.asarray(ids[rows]), jnp.asarray(plen[rows]),
            jnp.asarray(wrong), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask)))
    with pytest.MonkeyPatch.context() as mp:
        tspy = _Spy(mp, tlin, ("w4a8_grouped_ste", "w8a8_matmul_ste", "w4a8_dot_requant"))
        tout = tvla.predict_action_speculative_from_image(
            tparams, tserving, img[rows], _img_cfg(timage), ids[rows], plen[rows], wrong, q01,
            q99, mask, device="cpu")
    big = "int8" if bits == "mix" else "requant"
    greedy = "int4" if B * A <= tlin.NIB_HI_M_MAX else big
    assert tspy.seen == {(B * (T + A), big), (B * A, greedy), (B, "int4")}, tspy.seen
    assert jspy.seen == tspy.seen
    assert int(tout["n_accepted"].min()) < A - 1     # the continuation ran
    np.testing.assert_array_equal(tout["n_accepted"].numpy(), jout["n_accepted"])


# --- end to end ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def e2e(tiers):
    cache = {}

    def run(bits):
        if bits in cache:
            return cache[bits]
        serving, params, tserving, tparams = tiers(bits)
        img, ids, plen, q01, q99, mask = _inputs(VOCAB)
        with jax_turbo_w4():
            want = jax.tree.map(np.asarray, jvla.predict_action_from_image(
                params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
                jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
                return_first_logits=True))
        got = tvla.predict_action_from_image(tparams, tserving, img, _img_cfg(timage), ids,
                                             plen, q01, q99, mask, return_first_logits=True,
                                             device="cpu")
        cache[bits] = (want, {k: v.numpy() for k, v in got.items()})
        return cache[bits]

    return run


@pytest.mark.parametrize("bits", ["mix", 4])
def test_turbo_tokens_match_jax(e2e, bits):
    want, got = e2e(bits)
    gap = np.abs(got["first_logits"] - want["first_logits"]).max()
    assert len(np.unique(want["action_tokens"])) > 1
    n = assert_tokens(got["action_tokens"], want["action_tokens"], want["logit_margins"], gap)
    assert n >= COMPARED[bits], n


@pytest.mark.parametrize("key", ["first_logits", "logit_margins"])
@pytest.mark.parametrize("bits", ["mix", 4])
def test_turbo_logits_and_margins_close(e2e, bits, key):
    want, got = e2e(bits)
    np.testing.assert_allclose(got[key], want[key], atol=ATOL)


# --- random_params_like -------------------------------------------------------------------


@pytest.mark.parametrize("bits", [8, 4, "mix", "nibble"])
def test_random_params_like(bits):
    tcfg = tvlm.VLMConfig.tiny()
    spec = convert.vlm_param_spec(tcfg, tlin.TURBO_QUANT_SUFFIXES, bits)
    g = torch.Generator().manual_seed(0)
    got = tlin.random_params_like(spec, g, device="cpu")
    eager = tlin.random_params_like_eager_int4(spec, torch.Generator().manual_seed(0),
                                               device="cpu")
    fg, fs, fe = _flat(got), _flat(spec), _flat(eager)
    for k, leaf in fs.items():
        t = fg[k]
        assert tuple(t.shape) == leaf.shape and t.dtype == leaf.dtype, k
        assert torch.equal(t, fe[k]), k
        name = k.rsplit("/", 1)[1]
        if t.dtype == torch.int8:
            assert int(t.min()) >= -127 and int(t.max()) <= 127, k
        elif t.dtype == torch.uint8:
            codes = tlin.unpack_int4(t)
            lo = -8 if name in ("hi", "lo") else -7
            assert int(codes.min()) == lo and int(codes.max()) == 7, k
        elif name == "s":
            assert float(t.min()) >= 0.02 * 4 / 127 and float(t.max()) <= 2 * 0.02 * 4 / 127, k
        elif name == "s4":
            assert float(t.min()) >= 0.02 * 3.2 / 7 and float(t.max()) <= 2 * 0.02 * 3.2 / 7, k
        else:
            assert t.is_floating_point(), k
            assert abs(t.float().std().item() - 0.02) < 5e-3 or t.numel() < 64, k
    assert any(tlin.is_mixed_quant(v) for v in got["llm"]["layers"].values()) == (bits == "mix")
