"""The arithmetic of the fused int8 tower kernels, rehearsed on the CPU.

``fused_ln_w8a8`` and ``fused_mlp_residual`` (``ops/csrc/vit_mlp.cu``) are
pre-passes (``ln_quant_rows`` / ``quant_rows`` in ``ops/csrc/int8_mma.cuh``)
and GEMMs on the int8 wgmma core (``ops/csrc/int8_wgmma.cuh``) with fused
epilogue functors. They run only on the card; what they assume is checked
here in plain torch and numpy:

- The epilogue functors, emulated step by step in numpy float32 (each step
  one rounding, then one rounding to T): EpiAffine (scales, bias, optional
  LayerScale, optional residual) equals `vit_mlp.fused_ln_w8a8_from_codes`
  and, with x as the residual, `vit_mlp.mlp_out_from_codes`; fc1's EpiAffine
  (scales, bias) followed by the quantize pass's ActRT (the activation in
  fp32, rounded to T) equals `vit_mlp.mlp_hidden_from_codes`, bit for bit in
  bf16 and fp32. The negative controls, forms with a rounding fewer (the
  scale and the bias in one FMA, LayerScale applied before the bias sum is
  rounded to T, the residual added to y before y's rounding to T), differ.
- ``ln_quant_rows`` emulated with its block's sum order (each thread's
  4-vectors in turn, the warp's xor butterfly, the warps in order) gives
  codes within one step of the plain version's, and differs on at most one
  code in a thousand; its negative control, h not rounded to T before the
  row max and the codes, differs on far more and is refused by that rule.
- g's row maximum, taken over F's 128-column tiles in any order, and so its
  scale and codes, equal `linear.quantize_rows` on whole rows.
- fc2's K tail at F = 4304 (33 chunks of 128 and 80), zero-filled past K as
  TMA fills a box, gives the plain int32 sums, chunk by chunk in int32.
- The staged epilogue's index map: the fragments of m64nN (weight rows
  r0, r0 + 8 of each warp, activation rows 8 j + 2 t4 + e & 1), their head
  values written into a warpgroup's [32 rows][64 + 16 / sizeof(T)] buffer
  and read back as 16-byte vectors of output rows, put every output of a
  tile at its own [m, n] once, rows past M and columns past N untouched; the
  transposed buffer map is refused; the fragment writes of a warp fall in 32
  distinct banks.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.ops import vit_mlp as tmlp

DTYPES = [torch.float32, torch.bfloat16]


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _rt(x, dtype) -> np.ndarray:
    """Round float32 values to `dtype` and back (rt<T>)."""
    return torch.from_numpy(_f32(x)).to(dtype).float().numpy()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _codes_and_leaf(seed, M, K, N):
    r = np.random.default_rng(seed)
    codes = torch.from_numpy(r.integers(-127, 128, (M, K)).astype(np.int8))
    sx = torch.from_numpy((r.random((M, 1)) * 0.02 + 1e-3).astype(np.float32))
    w = tlin.quantize_weight(torch.from_numpy(r.standard_normal((N, K)).astype(np.float32) * 0.02))
    return r, codes, sx, w


def _acc(codes, w) -> np.ndarray:
    return codes.numpy().astype(np.int64) @ w["q"].numpy().astype(np.int64).T


def _scaled(acc, sx, s, dtype):
    """y = rt((f32(acc) · s_x) · s), each product rounded once."""
    return _rt((_f32(acc) * _f32(sx)) * _f32(s)[None], dtype)


def _affine(acc, sx, s, b, dtype, ls=None, rowop=None):
    """EpiAffine: y = rt(y + b); [y = rt(y · ls)]; [out = rt(rowop + y)]."""
    y = _rt(_scaled(acc, sx, s, dtype) + _f32(b)[None], dtype)
    if ls is not None:
        y = _rt(y * _f32(ls)[None], dtype)
    if rowop is not None:
        y = _rt(_f32(rowop) + y, dtype)
    return y


def _act_np(y, act):
    return F.gelu(torch.from_numpy(y), approximate="tanh" if act == "gelu_tanh" else "none").numpy() \
        if act != "quick_gelu" else (torch.from_numpy(y) * torch.sigmoid(1.702 * torch.from_numpy(y))).numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_ls", [False, True])
@pytest.mark.parametrize("with_res", [False, True])
def test_affine_epilogue_equals_fused_ln_w8a8_from_codes(dtype, with_ls, with_res):
    r, codes, sx, w = _codes_and_leaf(1, 24, 256, 96)
    b = torch.from_numpy(r.standard_normal(96).astype(np.float32) * 0.1).to(dtype)
    ls = torch.from_numpy(r.standard_normal(96).astype(np.float32)).to(dtype) if with_ls else None
    res = torch.from_numpy(r.standard_normal((24, 96)).astype(np.float32)).to(dtype) \
        if with_res else None
    got = _affine(_acc(codes, w), sx.numpy(), w["s"].numpy(), _np(b), dtype,
                  None if ls is None else _np(ls), None if res is None else _np(res))
    want = tmlp.fused_ln_w8a8_from_codes(codes, sx, w, b, res, ls, dtype)
    assert torch.equal(torch.from_numpy(got).to(dtype), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", tmlp.ACTS)
def test_fc1_epilogue_then_activation_equals_mlp_hidden_from_codes(dtype, act):
    r, codes, sx, w = _codes_and_leaf(2, 24, 256, 160)
    b = torch.from_numpy(r.standard_normal(160).astype(np.float32) * 0.1).to(dtype)
    y = _rt(_scaled(_acc(codes, w), sx.numpy(), w["s"].numpy(), dtype) + _np(b)[None], dtype)
    got = _rt(_act_np(y, act), dtype)
    want = tmlp.mlp_hidden_from_codes(codes, sx, w, b, act, dtype)
    assert torch.equal(torch.from_numpy(got).to(dtype), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layerscale", [False, True])
def test_fc2_epilogue_equals_mlp_out_from_codes(dtype, layerscale):
    """fc2 is EpiAffine with LayerScale ls2 (ones where the tower has none)
    and x as the row operand."""
    r, codes, sx, w = _codes_and_leaf(3, 24, 320, 64)
    x = torch.from_numpy(r.standard_normal((24, 64)).astype(np.float32)).to(dtype)
    b2 = torch.from_numpy(r.standard_normal(64).astype(np.float32) * 0.1).to(dtype)
    ls2 = torch.from_numpy(r.standard_normal(64).astype(np.float32)).to(dtype) if layerscale \
        else torch.ones(64, dtype=dtype)
    got = _affine(_acc(codes, w), sx.numpy(), w["s"].numpy(), _np(b2), dtype, _np(ls2), _np(x))
    want = tmlp.mlp_out_from_codes(x, codes, sx, w, b2, ls2)
    assert torch.equal(torch.from_numpy(got).to(dtype), want)


@pytest.mark.parametrize("form", ["scale_bias_fma", "ls_before_rounding", "residual_unrounded_y"])
def test_one_rounding_forms_of_the_epilogue_differ(form):
    """bf16, DINOv2's proj form (LayerScale and residual): each form with one
    rounding fewer than the function moves some outputs."""
    dtype = torch.bfloat16
    r, codes, sx, w = _codes_and_leaf(4, 64, 512, 128)
    b, ls, res = (_rt(r.standard_normal(shape).astype(np.float32) * sc, dtype)
                  for shape, sc in ((128, 0.1), (128, 1.0), ((64, 128), 1.0)))
    acc, s = _acc(codes, w), w["s"].numpy()
    a = _f32(acc) * _f32(sx.numpy())
    want = tmlp.fused_ln_w8a8_from_codes(codes, sx, w, torch.from_numpy(b).to(dtype),
                                         torch.from_numpy(res).to(dtype),
                                         torch.from_numpy(ls).to(dtype), dtype)
    y0 = _scaled(acc, sx.numpy(), s, dtype)
    if form == "scale_bias_fma":        # rt(a · s + b), one rounding for the product and the sum
        y = _rt(_f32(np.float64(a) * np.float64(s)[None] + np.float64(b)[None]), dtype)
        out = _rt(res + _rt(y * ls[None], dtype), dtype)
    elif form == "ls_before_rounding":  # (y0 + b) not rounded to T before the LayerScale
        out = _rt(res + _rt((y0 + b[None]) * ls[None], dtype), dtype)
    else:                               # y · ls not rounded to T before the residual
        out = _rt(res + _rt(y0 + b[None], dtype) * ls[None], dtype)
    assert torch.equal(torch.from_numpy(_affine(acc, sx.numpy(), s, b, dtype, ls, res)).to(dtype),
                       want)
    assert not torch.equal(torch.from_numpy(out).to(dtype), want)


# --- the LayerNorm pre-pass ----------------------------------------------------------

THREADS = 128


def _block_sum(parts: np.ndarray) -> np.ndarray:
    """parts [M, 128] float32 (each thread's partial): the warp's xor butterfly
    (16, 8, 4, 2, 1), then the 4 warps' sums added in warp order."""
    v = _f32(parts).reshape(parts.shape[0], 4, 32)
    lanes = np.arange(32)
    for w in (16, 8, 4, 2, 1):
        v = _f32(v + v[:, :, lanes ^ w])
    t = v[:, 0, 0]
    for w in range(1, 4):
        t = _f32(t + v[:, w, 0])
    return t


def _thread_sum(vals: np.ndarray) -> np.ndarray:
    """vals [M, K] float32 -> [M, 128]: thread tid adds its elements
    k = 4 tid + 512 i + j in turn (i, then j)."""
    M, K = vals.shape
    acc = np.zeros((M, THREADS), dtype=np.float32)
    for base in range(0, K, 4 * THREADS):
        for j in range(4):
            ks = base + 4 * np.arange(THREADS) + j
            ok = ks < K
            acc[:, ok] = _f32(acc[:, ok] + vals[:, ks[ok]])
    return acc


def _ln_quant_rows(x, sc, bi, eps, dtype, round_h=True):
    """ln_quant_rows_kernel on the CPU: (codes int8 [M, K], s_x [M, 1])."""
    x, sc, bi = _f32(x), _f32(sc), _f32(bi)
    K = x.shape[1]
    mean = _f32(_block_sum(_thread_sum(x)) / np.float32(K))[:, None]
    d = _f32(x - mean)
    var = _f32(_block_sum(_thread_sum(_f32(d * d))) / np.float32(K))
    rstd = _f32(1.0 / np.sqrt(np.float64(_f32(var + np.float32(eps)))))[:, None]
    h = _f32(_f32(_f32(d * rstd) * sc[None]) + bi[None])
    if round_h:
        h = _rt(h, dtype)
    s = np.maximum(_f32(np.abs(h).max(-1, keepdims=True) / np.float32(127)), np.float32(1e-8))
    codes = np.clip(np.rint(_f32(h / s)), -127, 127).astype(np.int8)
    return codes, s


def _ln_inputs(seed, M, K, dtype):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((M, K)).astype(np.float32) * 2 + 0.5).to(dtype)
    sc = torch.from_numpy(1 + 0.1 * r.standard_normal(K).astype(np.float32)).to(dtype)
    bi = torch.from_numpy(0.1 * r.standard_normal(K).astype(np.float32)).to(dtype)
    return x, sc, bi


def _plain_ln_codes(x, sc, bi, eps=1e-6):
    h = tmlp._layer_norm_f32(x, sc, bi, eps).to(x.dtype)
    return tlin.quantize_rows(h.float())[0].numpy()


def _ln_codes_hold(got: np.ndarray, want: np.ndarray) -> bool:
    """Within one code step, and at most one code in a thousand apart (the
    fp32 sums run in another order, which moves h only at a rounding tie of T)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(diff.max()) <= 1 and float((diff > 0).mean()) <= 1e-3


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K", [1024, 1152])
def test_ln_pre_pass_within_one_code_step_of_the_plain_version(dtype, K):
    x, sc, bi = _ln_inputs(5, 96, K, dtype)
    codes, _ = _ln_quant_rows(_np(x), _np(sc), _np(bi), 1e-6, dtype)
    assert _ln_codes_hold(codes, _plain_ln_codes(x, sc, bi))


def test_ln_not_rounded_to_t_before_the_max_is_refused():
    dtype = torch.bfloat16
    x, sc, bi = _ln_inputs(6, 96, 1024, dtype)
    want = _plain_ln_codes(x, sc, bi)
    codes, _ = _ln_quant_rows(_np(x), _np(sc), _np(bi), 1e-6, dtype)
    assert _ln_codes_hold(codes, want)
    unrounded, _ = _ln_quant_rows(_np(x), _np(sc), _np(bi), 1e-6, dtype, round_h=False)
    assert not _ln_codes_hold(unrounded, want)


def test_ln_pre_pass_sum_order_is_each_threads_vectors_in_turn():
    """The emulated order really is the kernel's: thread 0 holds k = 0..3,
    512..515, ...; a row of ones sums to K in any order, a row with one
    large value at k = 513 lands in thread 0's partial."""
    ones = np.ones((1, 1152), dtype=np.float32)
    assert _block_sum(_thread_sum(ones))[0] == 1152
    row = np.zeros((1, 1152), dtype=np.float32)
    row[0, 513] = 7.0
    assert _thread_sum(row)[0, 0] == 7.0 and _thread_sum(row)[0, 1:].sum() == 0


# --- g's row scale and fc2's K tail -------------------------------------------------


@pytest.mark.parametrize("F_", [4096, 4304, 8208])
def test_g_row_max_is_the_same_under_any_order_of_f_tiles(F_):
    r = np.random.default_rng(7)
    g = torch.from_numpy(r.standard_normal((8, F_)).astype(np.float32)).bfloat16().float()
    gn = g.numpy()
    tiles = [gn[:, i:i + 128] for i in range(0, F_, 128)]
    want_codes, want_sx = tlin.quantize_rows(g)
    for seed in range(3):
        order = np.random.default_rng(seed).permutation(len(tiles))
        amax = np.zeros((8, 1), dtype=np.float32)
        for i in order:
            amax = np.maximum(amax, np.abs(tiles[i]).max(-1, keepdims=True))
        sx = np.maximum(_f32(amax / np.float32(127)), np.float32(1e-8))
        assert np.array_equal(sx, want_sx.numpy())
        codes = np.clip(np.rint(_f32(gn / sx)), -127, 127).astype(np.int8)
        assert np.array_equal(codes, want_codes.numpy())


def _chunked_int32(codes: np.ndarray, q: np.ndarray, K: int, fill_codes, fill_q) -> np.ndarray:
    """Σ over 128-deep chunks in chunk order, in int32, each operand's box past
    K filled by `fill_*` (TMA fills zeros)."""
    chunks = -(-K // 128)
    pad = chunks * 128 - K
    a = np.concatenate([codes, fill_codes(codes.shape[0], pad)], 1).astype(np.int32)
    b = np.concatenate([q, fill_q(q.shape[0], pad)], 1).astype(np.int32)
    acc = np.zeros((codes.shape[0], q.shape[0]), dtype=np.int32)
    for c in range(chunks):
        part = a[:, 128 * c:128 * (c + 1)] @ b[:, 128 * c:128 * (c + 1)].T
        assert np.abs(part).max() < 2 ** 31
        acc = (acc + part).astype(np.int32)
    return acc


def test_fc2_k_tail_zero_filled_at_f_4304_gives_the_plain_sums():
    K = 4304
    assert K % 128 == 80
    r = np.random.default_rng(8)
    codes = r.integers(-127, 128, (16, K)).astype(np.int8)
    q = r.integers(-127, 128, (24, K)).astype(np.int8)
    want = tlin.int8_dot(torch.from_numpy(codes), torch.from_numpy(q)).numpy()
    zeros = lambda m, n: np.zeros((m, n), dtype=np.int8)
    junk = lambda m, n: np.full((m, n), 101, dtype=np.int8)
    assert np.array_equal(_chunked_int32(codes, q, K, zeros, zeros).astype(np.float32), want)
    # one operand's zeros are enough; junk in both boxes adds to the sums
    assert np.array_equal(_chunked_int32(codes, q, K, zeros, junk).astype(np.float32), want)
    assert not np.array_equal(_chunked_int32(codes, q, K, junk, junk).astype(np.float32), want)


# --- the staged epilogue's index map --------------------------------------------------

STG_ROWS = 32


def _stage_tile(M, N, n0, m0, BM, dtype, transposed=False):
    """Every output the staged epilogue writes for the tile at (n0, m0): a dict
    (m, n) -> the (n, m) of the accumulator it came from, and the word
    addresses of each warp's buffer writes (T values, a row pitch of
    64 + 16 / sizeof(T) elements; thread wt stores the 16-byte vectors
    i = wt + 128 k: row i / VR, columns (i % VR) · V ..)."""
    esize = torch.finfo(dtype).bits // 8
    V = 16 // esize
    PT, VR = 64 + V, 64 // V
    written, banks = {}, []
    for wg in range(2):
        for R in range(BM // STG_ROWS):
            buf = {}
            for warp in range(4):
                for jj in range(STG_ROWS // 8):
                    for e in range(4):
                        words = []
                        for lane in range(32):
                            g8, t4 = lane >> 2, lane & 3
                            j = R * (STG_ROWS // 8) + jj
                            n = n0 + wg * 64 + warp * 16 + g8 + 8 * (e >> 1)
                            m = m0 + 8 * j + 2 * t4 + (e & 1)
                            ml, nl = 8 * jj + 2 * t4 + (e & 1), warp * 16 + g8 + 8 * (e >> 1)
                            idx = nl * PT + ml if transposed else ml * PT + nl
                            buf[idx] = (n, m)
                            words.append(idx * esize // 4)
                        banks.append(words)
            for wt in range(128):
                for k in range(STG_ROWS * VR // 128):
                    i = wt + 128 * k
                    rl, cv = divmod(i, VR)
                    m, nb = m0 + R * STG_ROWS + rl, n0 + wg * 64 + cv * V
                    if m >= M or nb >= N:
                        continue
                    for v in range(V):
                        if nb + v < N:
                            assert (m, nb + v) not in written
                            written[(m, nb + v)] = buf.get(rl * PT + cv * V + v)
    return written, banks


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("BM", [128, 256])
@pytest.mark.parametrize("N", [200, 36])
def test_staged_epilogue_puts_every_output_at_its_own_index(dtype, BM, N):
    """The last tiles of a ragged edge: rows past M, columns past N inside the
    128-row weight tile (N = 200: 72 of 128 weight rows valid; N = 36, no
    multiple of 8: the stores element by element)."""
    M = BM + 37
    for n0 in range(0, N, 128):
        written, _ = _stage_tile(M, N, n0, BM, BM, dtype)
        want = {(m, n): (n, m) for m in range(BM, M) for n in range(n0, min(N, n0 + 128))}
        assert written == want


def test_transposed_buffer_map_is_refused():
    written, _ = _stage_tile(256, 256, 128, 0, 256, torch.bfloat16, transposed=True)
    assert any(src != (n, m) for (m, n), src in written.items())


@pytest.mark.parametrize("dtype", DTYPES)
def test_staged_fragment_writes_hit_distinct_banks(dtype):
    """Each warp's write of one (jj, e) accumulator slot: 32 lanes, 2- or
    4-byte elements, no two lanes on one bank unless on one 4-byte word."""
    _, banks = _stage_tile(256, 256, 0, 0, 256, dtype)
    for words in banks:
        by_bank = {}
        for w in words:
            by_bank.setdefault(w % 32, set()).add(w)
        assert all(len(ws) == 1 for ws in by_bank.values())



# --- the bf16x2 steps ------------------------------------------------------------------


def _round_bits(x: np.ndarray, bits: int) -> np.ndarray:
    """float64 values rounded to `bits` significant bits, to nearest even."""
    m, e = np.frexp(x)
    return np.ldexp(np.rint(np.ldexp(m, bits)), e - bits)


def test_bf16x2_steps_equal_rounding_the_fp32_result():
    """EpiAffine's bf16 path adds and multiplies bf16 values with add.bf16x2 /
    mul.bf16x2, which round the exact result once to bf16; the plain version
    rounds the fp32 result to bf16. The two agree because fp32's 24 bits hold
    the exact product of two 8-bit significands and at least 2 · 8 + 2 bits
    of any sum (a double rounding through 18 or more bits is exact): checked
    on random pairs with exponents up to 2^±20 apart (their float64 sums
    exact) and on exact ties. The negative control, a sum rounded through 10
    bits first, lands on other values."""
    r = np.random.default_rng(10)
    n = 400_000
    a = _round_bits(r.standard_normal(n) * np.exp2(r.integers(-20, 21, n)), 8)
    b = _round_bits(r.standard_normal(n) * np.exp2(r.integers(-20, 21, n)), 8)
    ties = _round_bits(r.standard_normal(4096), 8)
    a, b = np.concatenate([a, ties]), np.concatenate([b, ties * np.exp2(-9)])
    for exact in (a + b, a * b):   # exact in float64
        once = _round_bits(exact, 8)
        assert np.array_equal(once, torch.from_numpy(exact).to(torch.bfloat16).double().numpy())
        via_fp32 = torch.from_numpy(exact.astype(np.float32)).to(torch.bfloat16).double().numpy()
        assert np.array_equal(via_fp32, once)
    assert not np.array_equal(_round_bits(_round_bits(a + b, 10), 8), _round_bits(a + b, 8))
