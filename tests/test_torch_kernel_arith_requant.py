"""The arithmetic of the int4 requant route's kernel and of the redesigned
``rms_norm_quant``, rehearsed on the CPU.

``w4a8_requant`` (``ops/csrc/w8a8_matmul.cu`` ``ovla_w4a8_requant``, the int4
form ``W::kInt4`` of ``ops/csrc/int8_wgmma.cuh`` and ``ops/csrc/int8_decode.cuh``)
and ``rms_norm_quant`` (``ops/csrc/rmsnorm_quant.cu``) run only on the card;
what they assume is checked here in plain torch and numpy against the JAX
package on the CPU:

- The requant loader, step by step: the packed codes as TMA boxes of the
  3-D map [G][N][gsz / 2] (a whole 128-deep chunk of one group in the
  64-byte swizzle where gsz is a multiple of 128, else one 32-deep k step
  of a group a box, unswizzled; rows past N and groups past G zero-filled,
  a step past K not loaded and left stale), the
  ldmatrix fragments of the wgmma route (64-row warpgroup slabs) and of the
  decode route (n8 tiles), each row's r = s / (s8 + 1e-30) per group, its
  16-entry table built by four lanes and gathered by shuffles, the nibbles
  looked up with byte permutes: paired with the pre-pass's permuted
  activation codes, every chunk's integer sum equals the activation codes
  times the int8 codes that JAX ``_w4a8_dot_requant`` hands to
  ``_w8a8_dot`` (captured), and the epilogue on the in-kernel s8 gives its
  output bit for bit. Cases: exact ties (q4 · r = k + 1/2), rows whose
  scales all sit at the 1e-8 floor, rows of zero scales (the + 1e-30 guard:
  r = 0, not 0 / 0), codes ±7 and -8, G = 9 and 32, gsz = 32, 64, 96 and
  128, N not a multiple of 32 or 128.
- The table lookup equals the arithmetic for every nibble in every position,
  and the kernel's constants are the float32 roundings of 7/127 and 1e-30.
- The one-rounding forms are refused: a reciprocal-multiply r (s · (1 / d))
  and a product rounded once with the division (q · s / d in float64, then
  rounded) give other codes on the same data.
- ``rms_norm_quant``'s reduction order (each thread's vectors in turn, the
  warp's xor butterfly, the warps in order; 16-byte vectors or one element,
  128 threads or more for long rows): every element in one slot, and the
  rows held to JAX ``rms_norm_quant(..., interpret=True)`` by
  ``compare_rms_norm_quant``; its negative control (the product x · r not
  rounded to the activation type before the weight multiply) is refused.
  Its codes from h · (1 / s), the IEEE quotients of a vector taken where one
  lies within 2^-14 of a half-integer, rounded by a magic-number add and read
  off the low byte, no clip: equal to clip(rint(h / s)) on rows of exact ties
  and near-ties; without the exact quotient near a tie, refused.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu.ops import rmsnorm_quant as jrmsq
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.ops import rmsnorm_quant as trmsq

from tests.test_torch_kernel_arith_int8 import (_byte_perm, _codes_of, _ldmatrix_x4, _permute,
                                                _slots, _swizzle)

CHUNK, STEP = 128, 32
F32 = np.float32
S8_C, TINY = F32(7.0 / 127.0), F32(1e-30)


# --- the requant arithmetic --------------------------------------------------------


def _s8(s: np.ndarray) -> np.ndarray:
    """s8 = f32(max_g s) · f32(7/127), one rounding."""
    return (s.max(axis=-1) * S8_C).astype(F32)


def _r(s: np.ndarray) -> np.ndarray:
    """r [N, G] = s / (s8 + 1e-30), each op rounded once (IEEE)."""
    return (s / (_s8(s) + TINY)[:, None]).astype(F32)


def _code(q, r) -> np.ndarray:
    """clip(rint(f32(q) · r), -127, 127): __float2int_rn (half to even), clamped."""
    prod = np.asarray(q, F32) * np.asarray(r, F32)
    return np.clip(np.rint(prod), -127, 127).astype(np.int64)


def _lut(r: float):
    """int8_mma.cuh requant_lut: lane t4 computes word t4 (entries 4 t4 .. 4 t4 + 3,
    q4 = v - 16 · (v >= 8)); the shuffles hand every lane all four words."""
    return _lut_of(float(F32(r)))


@functools.lru_cache(maxsize=None)
def _lut_of(r: float):
    words = []
    for t4 in range(4):
        q0 = 4 * t4 if t4 < 2 else 4 * t4 - 16
        c = [int(_code(q0 + i, r)) & 0xFF for i in range(4)]
        words.append(np.uint32(c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24)))
    return words


def _requant(p, T):
    """int8_mma.cuh requant: 8 packed nibbles -> two words of int8 codes in k order."""
    p = np.uint32(p)

    def lut4(sel, half):
        a, b = _byte_perm(T[0], T[1], int(sel)), _byte_perm(T[2], T[3], int(sel))
        k = _byte_perm(np.uint32(0), np.uint32(0xFFFFFFFF), int(half))
        return (a & ~k) | (b & k)

    sel, half = p & np.uint32(0x77777777), (p >> np.uint32(1)) & np.uint32(0x44444444)
    return lut4(sel, half), lut4(sel >> np.uint32(16), half >> np.uint32(16))


def test_constants_are_the_float32_roundings():
    assert S8_C == np.float32(np.float64(7.0) / np.float64(127.0))
    assert TINY == np.float32(np.float64(1e-30)) and TINY > 0
    # the plain version's requant multiplies by the same constant
    s = torch.tensor([[0.37, 0.11]], dtype=torch.float32)
    assert tlin.requant_int4_to_int8(tlin.pack_int4(torch.zeros((2, 1, 2), dtype=torch.int8)),
                                     s)[1].item() == _s8(s.numpy())[0]


@pytest.mark.parametrize("r", [0.0, 0.5, 1.5, 2.5, 17.25, 18.142857, 1.0 / 3.0, 7.999999])
def test_table_lookup_equals_the_arithmetic_for_every_nibble(r):
    """Every nibble value 0..15 at each of the 8 positions of a word."""
    T = _lut(F32(r))
    for v in range(16):
        for pos in range(8):
            others = (np.arange(8) * 5 + v) % 16
            nib = [int(others[i]) if i != pos else v for i in range(8)]
            p = sum(n << (4 * i) for i, n in enumerate(nib))
            w0, w1 = _requant(p, T)
            got = np.concatenate([_codes_of(w0).ravel(), _codes_of(w1).ravel()])
            want = _code([n - 16 * (n >= 8) for n in nib], F32(r))
            assert np.array_equal(got, want), (r, v, pos)


def _leaf(seed, G, N, gsz, cases=True):
    """Codes in [-8, 7] with +-7 rows, and scales with the rehearsed cases:
    rows at the 1e-8 floor, rows of zero scales, rows whose r hits exact ties."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-8, 8, size=(G, N, gsz)).astype(np.int8)
    s = (rng.random((N, G)) * 2e-3 + 2e-3).astype(F32)
    if cases:
        codes[:, 1::7] = np.where(rng.random((G, len(range(1, N, 7)), gsz)) < 0.5, 7, -7)
        s[2::11] = F32(1e-8)                                   # the scale floor
        s[3::13] = F32(0)                                      # 0 / (0 + 1e-30) = 0
        for n in range(4, N, 9):                               # r = k + 1/2 exactly: ties
            s8, top = F32(s[n].max()) * S8_C, int(s[n].argmax())
            for g in range(G):
                t = F32(s8 * F32(0.5 + g % 5))
                if g != top and t / (s8 + TINY) == F32(0.5 + g % 5):
                    s[n, g] = t
    return codes, s


def _jax_requant(codes, s, x):
    """JAX _w4a8_dot_requant's output, and the int8 codes and scales it hands
    to _w8a8_dot."""
    seen = {}
    orig = jlin._w8a8_dot

    def capture(x2, q8, s8):
        seen.update(q8=np.asarray(q8), s8=np.asarray(s8))
        return orig(x2, q8, s8)

    jlin._w8a8_dot = capture
    try:
        out = np.asarray(jlin._w4a8_dot_requant(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(s)))
    finally:
        jlin._w8a8_dot = orig
    return out, seen["q8"], seen["s8"]


def _box(packed: np.ndarray, k: int, n0: int, rows: int, K: int, rng, width=16) -> np.ndarray:
    """The TMA box at k: [rows][width bytes] of group k // gsz at byte
    (k % gsz) / 2 (16 bytes: one 32-deep k step; 64: a whole chunk), rows
    past N zero; a step past K is not loaded, so the stage keeps stale bytes."""
    G, N, half = packed.shape
    if k >= K:
        return rng.integers(0, 256, size=(rows, width), dtype=np.uint8)
    g, off = k // (2 * half), (k % (2 * half)) // 2
    out = np.zeros((rows, width), dtype=np.uint8)
    hi = min(N, n0 + rows)
    out[:hi - n0] = packed[g, n0:hi, off:off + width]
    return out


def _stage(packed, gsz, K, c, n0, rows, rng):
    """A stage's int4 tile and the ldmatrix row address of (row n, k step kk):
    gsz a multiple of 128, the chunk as one box [rows][64 bytes] in the 64-byte
    swizzle (a nibble plane's layout); else four boxes [rows][16 bytes] at
    rows · 16 · kk, unswizzled."""
    if gsz % CHUNK == 0:
        smem = _swizzle(rows, 64, _box(packed, c * CHUNK, n0, rows, K, rng, 64))
        return smem, lambda n, kk: n * 64 + ((kk ^ ((n >> 1) & 3)) << 4)
    smem = np.concatenate([_box(packed, c * CHUNK + STEP * kk, n0, rows, K, rng).ravel()
                           for kk in range(4)])
    return smem, lambda n, kk: kk * rows * 16 + n * 16


def _row_r(r: np.ndarray, n: int, k: int, gsz: int) -> float:
    """The loader's r of row n for the group holding k: 0 past N and past K."""
    N, G = r.shape
    return F32(r[n, k // gsz]) if n < N and k // gsz < G else F32(0)


def _wgmma_chunk(packed, r, gsz, K, c, n0, rng):
    """The int4 wgmma loader's register A over one chunk for the tile's 128
    rows: the stage's tile (`_stage`), per warpgroup wg and warp the ldmatrix
    of matrix kk = lane >> 3 at row n and each row's table. Returns the k
    slots [128 rows][128] of the fragments (the pre-pass's k order)."""
    smem, at = _stage(packed, gsz, K, c, n0, 128, rng)
    out = np.zeros((128, CHUNK), dtype=np.int64)
    for wg in range(2):
        for warp in range(4):
            ph = []
            for h in range(2):
                def addr(L, h=h):
                    return at(wg * 64 + warp * 16 + 8 * h + (L & 7), L >> 3)
                ph.append(_ldmatrix_x4(smem, addr))
            for kk in range(4):
                regs = []
                for L in range(32):
                    pair = []
                    for h in range(2):
                        n = n0 + wg * 64 + warp * 16 + 8 * h + L // 4
                        table = _lut(_row_r(r, n, c * CHUNK + STEP * kk, gsz))
                        pair.append(_requant(ph[h][L, kk], table))
                    regs.append(tuple(pair))
                row0 = wg * 64 + warp * 16
                out[row0:row0 + 16, STEP * kk:STEP * kk + STEP] = _slots(regs, 16)
    return out


def _decode_chunk(packed, r, gsz, K, c, n0, rng):
    """The int4 decode route's B fragments over one chunk for a block's 32
    columns: the stage's tile (`_stage`), per n8 tile j the ldmatrix of matrix
    kk = lane >> 3 at row j · 8 + (lane & 7) and column j · 8 + g8's table.
    Returns the k slots [32 columns][128]."""
    smem, at = _stage(packed, gsz, K, c, n0, 32, rng)
    out = np.zeros((32, CHUNK), dtype=np.int64)
    for j in range(4):
        def addr(L, j=j):
            return at(j * 8 + (L & 7), L >> 3)
        ph = _ldmatrix_x4(smem, addr)
        for kk in range(4):
            k = c * CHUNK + STEP * kk
            regs = [_requant(ph[L, kk], _lut(_row_r(r, n0 + j * 8 + L // 4, k, gsz)))
                    for L in range(32)]
            b = _slots([(tuple(int(v) for v in regs[L]),) for L in range(32)], 8)   # [8][32]
            out[j * 8:j * 8 + 8, STEP * kk:STEP * kk + STEP] = b
    return out


@pytest.mark.parametrize("route", ["wgmma", "decode"])
@pytest.mark.parametrize("G,N,gsz", [(9, 200, 32), (9, 136, 64), (9, 40, 96), (2, 200, 128),
                                     (32, 72, 128)], ids=lambda v: str(v))
def test_requant_loader_gives_jax_codes_and_output(route, G, N, gsz):
    """The loader's fragments over every chunk and weight tile, paired with
    the pre-pass's permuted activation codes: each integer sum equals the
    activation codes times JAX's requantized codes; the epilogue on the
    kernel's s8 equals JAX's output bit for bit (fp32 x)."""
    K = G * gsz
    codes, s = _leaf(G * 1000 + N + gsz, G, N, gsz)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(5, K)).astype(F32)
    want, q8, s8 = _jax_requant(codes, s, x)
    assert np.array_equal(_s8(s), s8)
    act, sx = (t.numpy() for t in tlin.quantize_rows(torch.from_numpy(x)))
    stored = _permute(np.pad(act, ((0, 0), (0, -K % CHUNK))).astype(np.int64))
    packed = tlin.pack_int4(torch.from_numpy(codes)).numpy()
    r = _r(s)
    tile, chunk = (128, _wgmma_chunk) if route == "wgmma" else (32, _decode_chunk)
    acc = np.zeros((5, N), dtype=np.int64)
    for n0 in range(0, N, tile):
        for c in range(-(-K // CHUNK)):
            a = chunk(packed, r, gsz, K, c, n0, rng)               # [tile][128] slots
            part = stored[:, c * CHUNK:(c + 1) * CHUNK] @ a.T       # [5][tile]
            hi = min(N, n0 + tile)
            acc[:, n0:hi] += part[:, :hi - n0]
            assert not part[:, hi - n0:].any()                      # rows past N hold 0
    assert np.array_equal(acc, act.astype(np.int64) @ q8.astype(np.int64).T)
    out = ((acc.astype(F32) * sx) * _s8(s)[None, :]).astype(F32)
    assert np.array_equal(out, want)


def test_the_cases_are_in_the_data():
    """The rehearsed leaf holds exact ties, floor rows, zero rows and codes ±7, -8."""
    codes, s = _leaf(5, 9, 200, 32)
    r = _r(s)
    prod = codes.astype(F32) * r.T[:, :, None]
    assert (np.abs(prod - np.floor(prod) - F32(0.5)) == 0).sum() > 50      # k + 1/2 exactly
    assert (s == F32(1e-8)).all(axis=1).any() and (s == 0).all(axis=1).any()
    assert (r[(s == 0).all(axis=1)] == 0).all()                            # the guard
    assert {-8, -7, 7} <= set(np.unique(codes).tolist())


def _near_tie_scales(smax):
    """Scales s <= smax whose r = s / (s8 + 1e-30) puts q · r within a few ulps
    of a half-integer for q = 3, 5, 7: where the rounding steps show."""
    d = F32(F32(smax * S8_C) + TINY)
    out = []
    for q in (3, 5, 7):
        for k in range(int(18 * q)):
            base = F32((k + 0.5) / q * float(d))
            for off in range(-3, 4):
                t = base
                for _ in range(abs(off)):
                    t = np.nextafter(t, F32(np.inf) if off > 0 else F32(-np.inf))
                if t <= smax:
                    out.append(t)
    return np.array(out, dtype=F32)


def test_one_rounding_forms_are_refused():
    """Rows of near-tie scales (every nibble value in each group): the
    kernel's two roundings give JAX's codes; a reciprocal-multiply r and the
    product rounded once with the division give other codes."""
    G, gsz, smax = 32, 32, F32(2e-3)
    ties = _near_tie_scales(smax)
    N = -(-len(ties) // (G - 1) // 8) * 8
    rest = np.full(N * (G - 1), smax / 2, dtype=F32)
    rest[:len(ties)] = ties
    s = np.concatenate([np.full((N, 1), smax, dtype=F32), rest.reshape(N, G - 1)], axis=1)
    codes = np.broadcast_to(np.tile(np.arange(-8, 8, dtype=np.int8), gsz // 16), (G, N, gsz)).copy()
    x = np.random.default_rng(3).normal(size=(1, G * gsz)).astype(F32)
    _, q8, _ = _jax_requant(codes, s, x)
    want = q8.reshape(N, G, gsz)
    d = (_s8(s) + TINY)[:, None]
    q = np.moveaxis(codes, 0, 1).astype(np.float64)                        # [N, G, gsz]
    forms = {"kernel": _code(q, _r(s)[:, :, None]),
             "reciprocal": _code(q, (s * (F32(1) / d).astype(F32)).astype(F32)[:, :, None]),
             "one_rounding": np.clip(np.rint((q * s[:, :, None].astype(np.float64)
                                              / d[:, :, None].astype(np.float64)).astype(F32)),
                                     -127, 127).astype(np.int64)}
    apart = {k: int((v != want).sum()) for k, v in forms.items()}
    assert apart["kernel"] == 0 and apart["reciprocal"] > 0 and apart["one_rounding"] > 0, apart


# --- rms_norm_quant ------------------------------------------------------------------


def _rmsq_layout(M: int, D: int, V: int, sms: int = 132):
    """rmsnorm_quant.cu's launch rule (run_v): 128 threads with S = 1, 2, 4
    or 8 vectors; rows longer than 1024 vectors, or fewer rows than SMs, up
    to 512 threads with the fewest S; thread t's vector j starts at
    (j · threads + t) · V."""
    vecs = -(-D // V)
    threads, S = 128, 1
    while S < 8 and threads * S < vecs:
        S *= 2
    if threads * S < vecs or M < sms:
        threads, S = -(-vecs // 32) * 32, 1
        while threads > 512 and S < 8:
            S *= 2
            threads = -(-(-(-vecs // S)) // 32) * 32
        assert threads <= 512
    return threads, S


def _rmsq_kernel(x: torch.Tensor, w: torch.Tensor, eps: float, V: int, launch_M: int):
    """The kernel's arithmetic in numpy float32 on the rows of x, laid out as
    a launch of launch_M rows lays them out: the row sum of squares in its
    order, r = 1 / sqrt(var + eps) correctly rounded, h = rt(rt(x · r) · w),
    the absmax, s and the codes."""
    M, D = x.shape
    threads, S = _rmsq_layout(launch_M, D, V)
    xf = x.float().numpy()
    slot = np.zeros(D, dtype=np.int64)
    codes = np.zeros((M, D), dtype=np.int8)
    sx = np.zeros((M, 1), dtype=F32)
    for t in range(threads):
        for j in range(S):
            d0 = (j * threads + t) * V
            slot[d0:min(D, d0 + V)] += 1
    assert (slot == 1).all()                                  # every element in one slot
    for m in range(M):
        part = np.zeros(threads, dtype=F32)
        for t in range(threads):
            acc = F32(0)
            for j in range(S):
                d0 = (j * threads + t) * V
                for d in range(d0, min(D, d0 + V)):
                    acc = F32(acc + F32(xf[m, d] * xf[m, d]))
            part[t] = acc
        warps = []
        for w0 in range(0, threads, 32):
            v = part[w0:w0 + 32].copy()
            for o in (16, 8, 4, 2, 1):
                v = (v + v[np.arange(32) ^ o]).astype(F32)
            warps.append(v[0])
        ss = warps[0]
        for v in warps[1:]:
            ss = F32(ss + v)
        r = F32(F32(1) / np.sqrt(F32(F32(ss / F32(D)) + F32(eps))))
        h = (torch.from_numpy((xf[m] * r).astype(F32)).to(x.dtype).float()
             * w.to(x.dtype).float()).to(x.dtype).float().numpy()
        s = max(F32(np.abs(h).max() / F32(127)), F32(1e-8))
        codes[m] = _quant_fast(h, s, V)
        sx[m, 0] = s
    return torch.from_numpy(codes), torch.from_numpy(sx)


BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,D,dtype,V,launch_M", [
    (6, 4096, BF16, 8, 6912),     # prefill rows: 128 threads x 4 vectors
    (6, 4096, BF16, 8, 24),       # decode rows (fewer than the SMs): 512 threads x 1
    (5, 128, BF16, 8, 24), (5, 4095, BF16, 1, 24), (4, 12288, BF16, 8, 6912),
    (5, 4096, FP32, 4, 6912), (5, 999, FP32, 1, 24)])
def test_rmsq_reduction_order_holds_to_jax(M, D, dtype, V, launch_M):
    rng = np.random.default_rng(D + M + launch_M)
    x = torch.from_numpy((rng.normal(size=(M, D)) * 2).astype(F32)).to(dtype)
    w = torch.from_numpy((1 + 0.2 * rng.normal(size=(D,))).astype(F32)).to(dtype)
    got = _rmsq_kernel(x, w, 1e-5, V, launch_M)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jq, js = jrmsq.rms_norm_quant(jnp.asarray(x.float().numpy(), jdt),
                                  jnp.asarray(w.float().numpy(), jdt), 1e-5, interpret=True)
    want = (torch.from_numpy(np.asarray(jq)), torch.from_numpy(np.asarray(js)))
    stats = trmsq.compare_rms_norm_quant(x, w, 1e-5, got, want)
    assert stats["max_code_step"] <= 1


def test_rmsq_missing_round_trip_is_refused():
    """The product x · r left unrounded before the weight multiply (a fault
    the rule must catch) is reproduced by no r within 16 ulps."""
    rng = np.random.default_rng(9)
    M, D = 8, 4096
    x = torch.from_numpy((rng.normal(size=(M, D)) * 2).astype(F32)).bfloat16()
    w = torch.from_numpy((1 + 0.2 * rng.normal(size=(D,))).astype(F32)).bfloat16()
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-5)
    bad = tlin.quantize_rows((xf * r * w.float()).bfloat16().float())
    with pytest.raises(AssertionError):
        trmsq.compare_rms_norm_quant(x, w, 1e-5, bad, trmsq.rms_norm_quant_plain(x, w, 1e-5))


MAGIC = F32(12582912.0)


def _quant_fast(h: np.ndarray, s: np.float32, V: int = 8, fallback: bool = True) -> np.ndarray:
    """rmsnorm_quant.cu quant_codes in float32, over vectors of V: t = h ·
    fl(1 / s); where one of a vector's t lies within 2^-14 of a half-integer,
    the IEEE quotients h / s for the whole vector; rounded by adding 1.5 ·
    2^23 and reading the code off the low byte; no clip (|h / s| < 127.5)."""
    inv = F32(F32(1) / s)
    t = (h * inv).astype(F32)
    tm = (t + MAGIC).astype(F32)
    frac = np.abs((t - (tm - MAGIC).astype(F32)).astype(F32))
    near = frac > F32(0.5) - F32(2.0 ** -14)
    if h.size % V == 0:
        near = np.repeat(near.reshape(-1, V).any(axis=1), V)
    if fallback:
        tm = np.where(near, ((h / s).astype(F32) + MAGIC).astype(F32), tm)
    return (tm.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)


def _bf16(a) -> np.ndarray:
    return torch.from_numpy(np.asarray(a, F32)).bfloat16().float().numpy()


def test_rmsq_fast_quantization_equals_the_ieee_quotient():
    """Rows of bf16 h: random, with amax = 127 · 2^e (s = 2^e: every
    (k + 1/2) · 2^e an exact tie), and h at and beside (k + 1/2) · s; the
    fast form gives clip(rint(h / s)) on every one; without the exact
    quotient near a tie it does not."""
    rng = np.random.default_rng(13)
    rows = [_bf16(rng.normal(size=4096) * 3) for _ in range(16)]
    for e in (-3, 0, 5):
        k = rng.integers(-127, 127, size=4096) + 0.5
        rows.append(np.concatenate([[F32(127 * 2.0 ** e)], _bf16(k * 2.0 ** e)[1:]]).astype(F32))
    for seed in range(8):
        amax = _bf16(rng.random() * 10 + 0.1)
        s = max(F32(F32(amax) / F32(127)), F32(1e-8))
        k = rng.integers(-127, 127, size=4096) + 0.5
        near = _bf16(k * s)                                    # the bf16 values nearest the ties
        rows.append(np.concatenate([[amax], np.clip(near, -amax, amax)[1:]]).astype(F32))
    apart_without = 0
    for h in rows:
        amax = np.abs(h).max()
        s = max(F32(F32(amax) / F32(127)), F32(1e-8))
        want = np.clip(np.rint((h / s).astype(F32)), -127, 127).astype(np.int64)
        assert np.array_equal(_quant_fast(h, s), want)
        apart_without += int((_quant_fast(h, s, fallback=False) != want).sum())
        assert np.abs((h / s).astype(F32)).max() < 127.5                # the clip is the identity
    assert apart_without > 0
