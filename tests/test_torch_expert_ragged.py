"""The grouped expert product (`ops.expert_ragged`) against the JAX package's
``models/moe.py::_expert_ragged`` (``lax.ragged_dot_general``, XLA on the
CPU), in its four weight forms, on the CPU (the plain version).

Tolerances: fp32 1e-5 relative to the largest |want| (the same fp32 products
summed in another order); bf16 x within one bf16 step of JAX's output at the
largest |want| (one rounding of fp32 sums taken in another order); the LoRA
form within two such steps (the base, the delta and their bf16 sum are three
roundings). Rows past the groups' sum are 0 on both sides.
"""

import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import moe as jmoe
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import expert_ragged as texr
from openvla_probe_tpu_torch.ops import linear as tlin

JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SIZES = {
    "even": [6, 6, 6, 6],
    "empty": [0, 9, 0, 15],        # empty experts, first and in the middle
    "one_row": [1, 1, 20, 2],      # one-row groups
    "decode": [2, 2, 3, 1, 0, 4, 2, 2],   # 16 rows over 8 experts, one empty
}


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(TORCH_DT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _case(seed, sizes, I=64, O=40, dtype="float32"):
    """x, a float expert stack, the group sizes and each row's expert (the
    JAX function's e_row)."""
    r = np.random.default_rng(seed)
    E, M = len(sizes), sum(sizes)
    x = jnp.asarray(r.normal(size=(M, I)), JNP_DT[dtype])
    w = jnp.asarray(r.normal(size=(E, O, I)) * 0.1, jnp.float32)
    gs = np.asarray(sizes, np.int32)
    e_row = np.repeat(np.arange(E), sizes).astype(np.int32)
    return x, w, gs, e_row


def _call_both(x, jw, tw, gs, e_row, dtype):
    want = jmoe._expert_ragged(x, jw, jnp.asarray(gs), jnp.asarray(e_row))
    _build.reset_launch_counts()
    got = texr.expert_ragged(_t(x, dtype), tw, torch.from_numpy(gs))
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}    # the CPU takes the plain version
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    return _np(got), _np(want)


def _close(got, want, dtype, steps=1):
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=steps * 2.0 ** -8 * 2 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_float_form_matches_jax(dtype, sizes):
    """fp32 / bf16 weights (cast to x's dtype), the product in fp32."""
    x, w, gs, e_row = _case(1, SIZES[sizes], dtype=dtype)
    jw = w.astype(JNP_DT[dtype])
    got, want = _call_both(x, jw, _t(jw, dtype), gs, e_row, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_int8_form_matches_jax(dtype, sizes):
    """Weight-only int8: codes widened to x's dtype, fp32 sums, · s[e_row]."""
    x, w, gs, e_row = _case(2, SIZES[sizes], dtype=dtype)
    jq = jlin.quantize_weight(w)
    tq = {"q": torch.from_numpy(np.array(jq["q"])), "s": torch.from_numpy(np.array(jq["s"]))}
    got, want = _call_both(x, jq, tq, gs, e_row, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", ["even", "empty"])
def test_int4_form_matches_jax(dtype, sizes):
    """Grouped int4 (group 32 over I = 64): dequantized to x's dtype, then
    the float form; the JAX codes packed into the port's layout."""
    x, w, gs, e_row = _case(3, SIZES[sizes], dtype=dtype)
    jq = jlin.quantize_weight_int4(w, group_size=32)
    codes = np.array(jnp.asarray(jq["q"]).astype(jnp.int8))
    tq = {"q": tlin.pack_int4(torch.from_numpy(codes)), "s": torch.from_numpy(np.array(jq["s"]))}
    assert tlin.is_grouped_int4(tq)
    got, want = _call_both(x, jq, tq, gs, e_row, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", ["float", "int8"])
def test_lora_form_matches_jax(dtype, base):
    """Streamed LoRA over a float or int8 base: base + (x Aᵀ) Bᵀ, each
    product grouped."""
    x, w, gs, e_row = _case(4, SIZES["empty"], dtype=dtype)
    r = np.random.default_rng(5)
    A = r.normal(size=(4, 8, 64)).astype(np.float32) * 0.1
    B = r.normal(size=(4, 40, 8)).astype(np.float32) * 0.1
    if base == "int8":
        jb = jlin.quantize_weight(w)
        tb = {"q": torch.from_numpy(np.array(jb["q"])), "s": torch.from_numpy(np.array(jb["s"]))}
    else:
        jb, tb = w.astype(JNP_DT[dtype]), _t(w.astype(JNP_DT[dtype]), dtype)
    jw = {"base": jb, "A": jnp.asarray(A), "B": jnp.asarray(B)}
    tw = {"base": tb, "A": torch.from_numpy(A), "B": torch.from_numpy(B)}
    got, want = _call_both(x, jw, tw, gs, e_row, dtype)
    _close(got, want, dtype, steps=2)


def test_rows_past_the_groups_are_zero():
    """ragged_dot's rule: rows past the group sizes' sum come out 0."""
    x, w, gs, e_row = _case(6, [3, 0, 5])
    x = jnp.concatenate([x, jnp.ones((4, 64), jnp.float32)])
    e_row = np.concatenate([e_row, np.zeros(4, np.int32)])
    got, want = _call_both(x, w, _t(w), gs, e_row, "float32")
    np.testing.assert_array_equal(got[8:], 0.0)
    np.testing.assert_array_equal(want[8:], 0.0)
    _close(got, want, "float32")


def test_nibble_experts_raise():
    """The JAX package's _expert_ragged has no nibble form: the port names it."""
    x = torch.zeros(4, 64)
    w = tlin.quantize_weight_nibble(torch.randn(2, 8, 64))
    with pytest.raises(NotImplementedError, match="nibble"):
        texr.expert_ragged(x, w, torch.tensor([2, 2], dtype=torch.int32))


@pytest.mark.parametrize("x_dtype,w_dtype,I,O,want", [
    (torch.bfloat16, torch.bfloat16, 4096, 14336, True),    # Mixtral gate / up
    (torch.bfloat16, torch.int8, 14336, 4096, True),        # Mixtral down, int8
    (torch.bfloat16, torch.bfloat16, 64, 8, True),          # a LoRA rank of 8
    (torch.float32, torch.float32, 4096, 14336, False),     # fp32 x: the scalar route
    (torch.float32, torch.int8, 64, 128, False),
    (torch.bfloat16, torch.bfloat16, 60, 128, False),       # I not a multiple of 8
    (torch.bfloat16, torch.int8, 64, 12, False),            # O not a multiple of 8
    (torch.bfloat16, torch.int8, 200, 136, False),          # int8 codes: I % 16 != 0 (TMA rows)
    (torch.bfloat16, torch.int8, 24, 64, False),
    (torch.bfloat16, torch.int8, 208, 136, True),
    (torch.bfloat16, torch.bfloat16, 200, 136, True),       # bf16 weights: I % 8 == 0 is enough
    (torch.bfloat16, torch.bfloat16, 24, 64, True),
])
def test_ragged_mma_eligible(x_dtype, w_dtype, I, O, want):
    """The tensor-core route's declared rule (meta tensors: no data)."""
    x = torch.empty((16, I), dtype=x_dtype, device="meta")
    w = torch.empty((8, O, I), dtype=w_dtype, device="meta")
    assert texr.ragged_mma_eligible(x, w) is want


def test_ragged_mma_eligible_needs_alignment():
    """A weight stack 16-byte aligned on the tensor cores, one off it not."""
    buf = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    assert texr.ragged_mma_eligible(x, buf[:-1].view(2, 8, 64))
    assert not texr.ragged_mma_eligible(x, buf[1:].view(2, 8, 64))


@pytest.mark.parametrize("M,want", [(1, False), (16, False), (64, False), (65, True),
                                    (4608, True)])
def test_route_by_rows(M, want):
    """The wrapper's choice between the two tensor-core routes, from M alone:
    the split-K decode route up to DECODE_ROWS = 64 rows, the persistent wgmma
    route above; the wrapper takes it from `ragged_prefill_route`."""
    assert texr.ragged_prefill_route(M) is want
    assert "ragged_prefill_route(M)" in inspect.getsource(texr._ragged)


def _csrc(name):
    return (Path(texr.__file__).parent / "csrc" / name).read_text()


def test_decode_rows_match_the_kernel_source():
    """DECODE_ROWS mirrors the launcher's limit of the decode route."""
    m = re.search(r"constexpr int kDecodeRows = (\d+);", _csrc("expert_ragged.cu"))
    assert int(m.group(1)) == texr.DECODE_ROWS


def test_widening_is_wi8_matmuls():
    """expert_ragged.cu widens codes with wi8_matmul.cu's widen2, character for
    character, so the all-256-codes check of test_torch_kernel_arith_oneshot
    covers it."""
    def body(src):
        i = src.index("__device__ __forceinline__ uint32_t widen2(uint32_t w) {")
        return src[i:src.index("\n}\n", i)]
    assert body(_csrc("expert_ragged.cu")) == body(_csrc("wi8_matmul.cu"))


def test_backward_fp16_widening_is_exact_for_all_codes():
    """expert_ragged_bwd.cu's widen2h: (c ^ 0x80) | 0x6400 read as fp16 is
    1024 + c + 128, and one fp16 subtraction of 1152 (round to nearest, as
    __hsub2) gives every code c in -128..127 exactly; both byte pairs of a
    word (selectors 0x5140 and 0x7362)."""
    codes = np.arange(-128, 128, dtype=np.int16)
    bits = (0x6400 | ((codes ^ 0x80) & 0xFF)).astype(np.uint16)
    got = bits.view(np.float16) - np.float16(1152)
    assert got.dtype == np.float16
    assert np.array_equal(got.astype(np.float32), codes.astype(np.float32))
    src = _csrc("expert_ragged_bwd.cu")
    body = src[src.index("uint32_t widen2h(uint32_t w) {"):]
    body = body[:body.index("\n}\n")]
    assert "__byte_perm(w ^ 0x80808080u, 0x64646464u, SEL)" in body
    assert "__floats2half2_rn(1152.f, 1152.f)" in body
    for sel in ("0x5140", "0x7362"):
        assert f"widen2h<{sel}>" in src


def test_backward_tiles_match_the_kernel_source():
    """DX_STAGE and DW_TILE mirror the backward's stage depth and tile rows."""
    src = _csrc("expert_ragged_bwd.cu")
    assert int(re.search(r"constexpr int kBK = (\d+);", src).group(1)) == texr.DX_STAGE
    assert int(re.search(r"constexpr int kBM = (\d+);", src).group(1)) == texr.DW_TILE


@pytest.mark.parametrize("M,O,I,codes,want", [
    (5120, 14336, 4096, True, (128, 1)),    # the int8 base's dx, gate / up
    (5120, 4096, 14336, True, (128, 1)),    # down
    (5120, 14336, 32, False, (64, 7)),      # dy · B at F: 40 tiles, split 7 ways
    (5120, 4096, 32, False, (64, 7)),       # dy · B at D
    (5120, 32, 4096, False, (128, 1)),      # dt · A: 1280 tiles, one k step
    (5120, 32, 14336, False, (128, 1)),
    (5120, 4096, 8, False, (64, 7)),        # r = 8
    (5120, 4096, 64, False, (64, 7)),       # r = 64: the widest 64-column tile
    (5120, 4096, 72, False, (128, 7)),      # past 64: a 128-column tile
    (16768, 256, 32, False, (64, 2)),       # 131 tiles: split (as deep as 4 stages allow)
    (16769, 256, 32, False, (64, 1)),       # 132 tiles fill the card: one pass
    (64, 8, 1024, False, (128, 1)),         # O = 8: one stage, never split
    (64, 1024, 16, True, (128, 8)),         # codes keep the 128-column tile
])
def test_dx_tiling(M, O, I, codes, want):
    """`dx_tiling` at moe_train's shapes and at its boundaries: 64 columns
    only for bf16 weights up to I = 64, a split below DX_FULL_TILES tiles
    into at most half the stages."""
    assert texr.dx_tiling(M, O, I, codes) == want


def test_dx_tiling_is_a_pure_function_of_the_shapes():
    """Over a grid of shapes: the same answer twice, splits of at least two
    stages each, one pass wherever the tiles reach DX_FULL_TILES, and the
    launch argument order the wrapper passes."""
    for M in (1, 64, 127, 128, 129, 5120, 16768, 16769):
        for O in (8, 64, 72, 256, 4096, 14336):
            for I in (8, 16, 32, 64, 72, 4096):
                for codes in (False, True):
                    tile_n, splits = texr.dx_tiling(M, O, I, codes)
                    assert (tile_n, splits) == texr.dx_tiling(M, O, I, codes)
                    assert tile_n == (128 if codes or I > 64 else 64)
                    tiles = -(-M // 128) * -(-I // tile_n)
                    assert splits >= 1
                    assert splits == 1 or (tiles < texr.DX_FULL_TILES
                                           and 2 * splits <= -(-O // texr.DX_STAGE))
    assert "dx_tiling(M, O, I, bool(int8))" in inspect.getsource(texr.expert_ragged_dx)


@pytest.mark.parametrize("O,I,want", [
    (14336, 32, (False, 64)),    # dB: 128 channels of dy x r
    (4096, 32, (False, 64)),
    (32, 4096, (True, 64)),      # dA: its transpose, 128 channels of x x r
    (32, 14336, (True, 64)),
    (14336, 4096, (False, 128)),  # a full stack's gate / up gradient
    (4096, 14336, (True, 128)),   # down's: the transpose
    (8, 512, (True, 64)),
    (64, 64, (False, 64)),
    (72, 72, (False, 128)),
])
def test_dw_tiling(O, I, want):
    """`dw_tiling`: the wider operand's 128 channels a tile, the other side's
    64 (up to 64) or 128 columns; dW's transpose where O < I."""
    assert texr.dw_tiling(O, I) == want


@pytest.mark.parametrize("M,O,I,want", [
    (5120, 14336, 32, 1728),   # 112 tiles: 3 chunks
    (5120, 32, 14336, 1728),   # dA: the same tiles, transposed
    (5120, 4096, 32, 576),     # 32 tiles: 9 chunks
    (5120, 32, 4096, 576),
    (5120, 14336, 4096, 5120),   # a full stack: 3584 tiles, one pass
    (5120, 8, 512, 128),       # 4 tiles: 40 chunks, as many as 128-row tiles allow
    (100, 8, 8, 100),          # one 128-row tile: never split
])
def test_dw_split_rows_at_the_new_tiles(M, O, I, want):
    """`dw_split_rows` over `dw_tiling`'s tile count: a multiple of the
    64-row stage below M, M itself for one pass."""
    rows = texr.dw_split_rows(M, O, I)
    assert rows == want
    assert rows >= M or rows % texr.DW_ROW_STEP == 0
    assert rows == texr.dw_split_rows(M, O, I)


@pytest.mark.parametrize("dy_dtype,w_dtype,O,I,want", [
    (torch.bfloat16, torch.int8, 14336, 4096, True),    # the int8 base's dx
    (torch.bfloat16, torch.int8, 4096, 14336, True),
    (torch.bfloat16, torch.bfloat16, 14336, 32, True),  # dy · B
    (torch.bfloat16, torch.bfloat16, 32, 4096, True),   # dt · A
    (torch.bfloat16, torch.bfloat16, 4096, 8, True),    # r = 8
    (torch.bfloat16, torch.bfloat16, 8, 1024, True),    # O = 8: dy's 16-byte rows
    (torch.bfloat16, torch.int8, 64, 16, True),         # codes: I % 16 (the map's rows)
    (torch.bfloat16, torch.int8, 64, 24, False),
    (torch.bfloat16, torch.bfloat16, 64, 24, True),     # bf16: I % 8 is enough
    (torch.bfloat16, torch.bfloat16, 12, 64, False),    # O off 8
    (torch.bfloat16, torch.bfloat16, 64, 20, False),    # I off 8
    (torch.float32, torch.float32, 64, 64, False),      # fp32: the scalar route
])
def test_ragged_dx_mma_eligible(dy_dtype, w_dtype, O, I, want):
    """dx's tensor-core rule, what its TMA maps need (meta tensors)."""
    dy = torch.empty((16, O), dtype=dy_dtype, device="meta")
    w = torch.empty((8, O, I), dtype=w_dtype, device="meta")
    assert texr.ragged_dx_mma_eligible(dy, w) is want


@pytest.mark.parametrize("dtype,O,I,want", [
    (torch.bfloat16, 14336, 32, True), (torch.bfloat16, 32, 14336, True),
    (torch.bfloat16, 8, 512, True), (torch.bfloat16, 136, 200, True),
    (torch.bfloat16, 12, 64, False), (torch.bfloat16, 64, 20, False),
    (torch.float32, 64, 64, False),
])
def test_ragged_dw_mma_eligible(dtype, O, I, want):
    """dW's tensor-core rule: bf16, O and I multiples of 8 (meta tensors)."""
    dy = torch.empty((16, O), dtype=dtype, device="meta")
    x = torch.empty((16, I), dtype=dtype, device="meta")
    assert texr.ragged_dw_mma_eligible(dy, x) is want


def _two_fp16_terms(v: torch.Tensor):
    """csrc build_terms on fp32 v [rows, 64] (one stage of a row): the
    power of two 2^k a row, v' = v · 2^k, hi = fp16(v'), lo = fp16(v' - hi),
    and inv = 2^-k."""
    mx = v.abs().amax(dim=1)
    e = torch.clamp((mx.view(torch.int32) >> 23) & 0xFF, min=15)
    sc = ((268 - e) << 23).view(torch.float32)
    inv = ((e - 14) << 23).view(torch.float32)
    x = v * sc[:, None]
    hi = x.half()
    lo = (x - hi.float()).half()
    return x, hi, lo, inv


def test_two_fp16_terms_carry_the_scaled_cotangent():
    """The int8 dx's operand A: per row and stage a power of two puts max |v|
    in [2^14, 2^15) (no fp16 overflow; capped where max |v| < 2^-112), the
    scaling is exact both ways, and
    hi + lo is within 2^-22 of |v'| of v' (fp16 subnormals: within 2^-25),
    across binades, signs, zero rows and rows of mixed magnitudes."""
    r = np.random.default_rng(23)
    dy = torch.from_numpy(r.normal(size=(4096, 64)).astype(np.float32)).bfloat16().float()
    s = torch.from_numpy((r.uniform(0.5, 1.5, size=(4096, 64)) * 2.0 ** r.integers(
        -30, 20, size=(4096, 1))).astype(np.float32))
    v = dy * s
    v[0] = 0.0                                   # a row past O (scales 0)
    v[1, :32] *= 2.0 ** -40                      # mixed magnitudes in one row
    v[2] = torch.tensor([2.0 ** -120] * 64)      # near the bottom of fp32's range
    x, hi, lo, inv = _two_fp16_terms(v)
    big, mx = x.abs().amax(dim=1), v.abs().amax(dim=1)
    scaled = mx >= 2.0 ** -112                   # below it the power of two is capped (row 2)
    assert bool(((big >= 2.0 ** 14) & (big < 2.0 ** 15))[scaled].all())
    assert int(scaled.sum()) == v.shape[0] - 2 and bool((big[~scaled] < 2.0 ** 15).all())
    assert torch.isfinite(hi.float()).all() and torch.isfinite(lo.float()).all()
    assert torch.equal(x * inv[:, None], v)      # 2^k and 2^-k exact
    err = (x.double() - hi.double() - lo.double()).abs()
    bound = torch.maximum(x.double().abs() * 2.0 ** -22, torch.full_like(err, 2.0 ** -25))
    assert bool((err <= bound).all())
    src = _csrc("expert_ragged_bwd.cu")
    body = src[src.index("void build_terms("):]
    body = body[:body.index("\n}\n")]
    assert "__fmul_rn(d.x, sv.x), __fmul_rn(d.y, sv.y)" in body     # v = fp32(dy · s)
    assert "__fsub_rn(x0, fh.x), __fsub_rn(x1, fh.y)" in body       # v' - hi, not contracted
    assert "(268u - e) << 23" in body and "(e - 14u) << 23" in body


def _exact_case(seed, sizes, M):
    """Small integer x and codes and power-of-two scales: every output is
    exact in bf16, so the plain version is the correctly rounded value."""
    r = np.random.default_rng(seed)
    E = len(sizes)
    x = torch.from_numpy(r.integers(-3, 4, size=(M, 16)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(r.integers(-3, 4, size=(E, 24, 16)).astype(np.int8))
    s = torch.from_numpy(2.0 ** r.integers(-4, 2, size=(E, 24))).float()
    return x, w, s, torch.tensor(sizes, dtype=torch.int32)


def test_misrounded_counts_outputs_off_the_rounded_value():
    """The fp64 count: 0 for the correctly rounded result, one for each output
    moved by one bf16 step or more; rows past the groups' sum not counted."""
    x, w, s, gs = _exact_case(7, [5, 0, 9], M=17)
    want = texr.expert_ragged_plain(x, w, s, gs)
    assert texr.misrounded(want, x, w, s, gs) == 0
    bits = want.clone().view(torch.int16)
    bits[2, 3] += 1        # one step from its value
    bits[10, 0] -= 3
    bits[15, 7] += 40      # a row past the sum: not counted
    assert texr.misrounded(bits.view(torch.bfloat16), x, w, s, gs) == 2
    assert texr.misrounded(want, x, w.float().bfloat16(), None, gs) > 0   # scales left out


def test_misrounded_takes_half_a_step_as_rounded():
    """An output within half a bf16 step of the reference counts as rounded,
    one past it as misrounded, at every binade (a [1, 1] product x · w)."""
    for v in (1.0, 3.0, 200.0, 0.015625):
        ref = v * (1 + 2.0 ** -9)   # less than half a bf16 step above v
        x = torch.tensor([[ref]], dtype=torch.float64)
        w = torch.ones((1, 1, 1), dtype=torch.float64)
        gs = torch.tensor([1], dtype=torch.int32)
        near = torch.tensor([[v]], dtype=torch.bfloat16)
        far = near.view(torch.int16).add(1).view(torch.bfloat16)
        assert texr.misrounded(near, x, w, None, gs) == 0
        assert texr.misrounded(far, x, w, None, gs) == 1

