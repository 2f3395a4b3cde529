"""The row-parallel int8 product at tp = 2 in one process, on the CPU, against
the JAX package's ``_w8a8_dot`` (openvla_probe_tpu/ops/linear.py:413), and the
arithmetic and index maps of its card kernels (csrc/w8a8_matmul.cu) rehearsed
in numpy.

* The chain as ``parallel.tensor_parallel._row_exact`` runs it, each rank's K
  half from the real placement (`sharding.place_leaf`: zero codes appended to
  a half that is not a multiple of 16): `w8a8_row_absmax` on each half, their
  max (the MAX all-reduce), the scale, `w8a8_quant_given` with the pad,
  `w8a8_matmul_i32` on each half, their int32 sum (the SUM all-reduce), then
  `w8a8_epilogue`: bit-equal to ``_w8a8_dot`` on the same numpy inputs, in
  bf16 with K = 4304 (2152 a rank, padded to 2160), in fp32, and over a
  nibble leaf (``_w8a8_dot`` on ``nibble_reconstruct_q8``, the JAX package's
  prefill route for one). The integer sums are exact and every other step is
  the same rounding in the same order, so no tolerance.
* `_row_exact` itself, its two ranks as two threads whose all-reduces meet at
  a barrier (no process group): bit-equal to ``_w8a8_dot``, the local absmax
  taken by `w8a8_row_absmax` once a rank.
* The codes kernel's rounding (the IEEE quotient clipped, then rounded half
  to even by adding 1.5 · 2^23 and read from the low byte) equals
  clip(rint(v / s), -127, 127) on random rows, ties and odd scales; rounding
  half up (the negative control) does not.
* The unit and vector maps: every code written once, loads inside the row and
  aligned under the route rule; the nibble k order of the 16-code unit's two
  8-byte stores equals ``int8_mma.cuh::stored_offset``; the absmax over bit
  patterns equals ``amax`` (NaN, -0 and inf included); the epilogue's 2-D grid
  writes every output once, its tiles strided past the grid's 65535 columns.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch.ops import linear as lin
from openvla_probe_tpu_torch.parallel import distributed as D
from openvla_probe_tpu_torch.parallel import mesh as tmesh
from openvla_probe_tpu_torch.parallel import sharding as tsharding
from openvla_probe_tpu_torch.parallel import tensor_parallel as tp
from test_torch_kernel_arith_int8 import _stored_offset

TP = 2
KMAGIC = np.float32(12582912.0)   # 1.5 · 2^23


def _jax_pair(arr: np.ndarray, dtype: str):
    """The same values on both sides, rounded to `dtype` once by JAX."""
    j = jnp.asarray(arr, getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(getattr(torch, dtype))


def _place(leaf: dict, rank: int) -> dict:
    mesh = tmesh.Mesh({"tp": TP}, rank=rank)
    spec = tsharding.shard_params({"o_proj": leaf}, mesh, "tp", "llm/layers")["o_proj"]
    placed = tsharding.place_leaf("llm/layers/o_proj", leaf, spec, mesh)
    assert tp.tp_role(placed) == "row"
    return placed


def _to_torch(out) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(out).astype(jnp.float32)))


CASES = {   # name: (M, K, N, dtype, nibble)
    "bf16_siglip_fc2": (13, 4304, 48, "bfloat16", False),
    "fp32": (9, 2048, 40, "float32", False),
    "nibble": (21, 1024, 32, "bfloat16", True),
}


def _case(name: str):
    M, K, N, dtype, nibble = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    x_np = (rng.standard_normal((M, K)) * 3).astype(np.float32)
    x_np[1] = 0.0                       # a row of zeros: its scale clamps to 1e-8
    x_np[2, :K // 2] *= 1e-3            # one half far below the other: the max decides
    w_np = (rng.standard_normal((N, K)) * 0.05).astype(np.float32)
    xj, xt = _jax_pair(x_np, dtype)
    wj = jnp.asarray(w_np)
    if nibble:
        jw = jlin.quantize_weight_nibble(wj)
        want = jlin._w8a8_dot(xj, jlin.nibble_reconstruct_q8(jw), jw["s"])
        leaf = lin.quantize_weight_nibble(torch.from_numpy(w_np))
    else:
        jw = jlin.quantize_weight(wj)
        want = jlin._w8a8_dot(xj, jw["q"], jw["s"])
        leaf = {k: torch.from_numpy(np.array(jw[k])) for k in ("q", "s")}
    return xt, leaf, _to_torch(want), nibble


@pytest.mark.parametrize("name", sorted(CASES))
def test_row_parallel_chain_equals_jax_w8a8_dot(name):
    xt, leaf, want, nibble = _case(name)
    K = xt.shape[1]
    k_loc = K // TP
    locals_ = [_place(leaf, r)["local"] for r in range(TP)]
    k_pad = locals_[0]["q"].shape[-1] if "q" in locals_[0] else 2 * locals_[0]["hi"].shape[-1]
    if name == "bf16_siglip_fc2":
        assert (k_loc, k_pad) == (2152, 2160)
    halves = [xt[:, r * k_loc:(r + 1) * k_loc].contiguous() for r in range(TP)]
    amax = torch.maximum(*[lin.w8a8_row_absmax(h) for h in halves])
    assert torch.equal(amax, xt.abs().amax(-1, keepdim=True).float())
    sx = torch.clamp(lin.div127(amax), min=1e-8)
    assert float(sx[1]) == np.float32(1e-8)
    acc = sum(lin.w8a8_matmul_i32(lin.w8a8_quant_given(h, sx, k_pad, nibble=nibble), loc)
              for h, loc in zip(halves, locals_))
    assert acc.dtype == torch.int32
    out = lin.w8a8_epilogue(acc, sx, locals_[0]["s"], xt.dtype)
    assert out.dtype == xt.dtype
    assert torch.equal(out.float(), want)


def test_row_exact_on_two_threads_equals_jax_w8a8_dot(monkeypatch):
    """`_row_exact` on both ranks, the collectives met by a barrier: every
    rank's output is ``_w8a8_dot``'s, with one absmax launch a rank."""
    xt, leaf, want, _ = _case("bf16_siglip_fc2")
    barrier = threading.Barrier(TP, timeout=60)
    posted = {}

    def all_reduce(t, op, rank):
        posted[(op, rank)] = t.clone()
        barrier.wait()
        parts = [posted[(op, r)] for r in range(TP)]
        red = torch.maximum(*parts) if op == "max" else sum(parts)
        barrier.wait()
        return t.copy_(red)

    calls = []
    real_absmax = lin.w8a8_row_absmax

    def absmax(x):
        calls.append(threading.get_ident())
        return real_absmax(x)

    monkeypatch.setattr(D, "all_reduce", all_reduce)
    monkeypatch.setattr(tp, "tp_coord", lambda w: (w["mesh"].coord("tp"), TP,
                                                   w["mesh"].coord("tp")))
    monkeypatch.setattr(lin, "w8a8_row_absmax", absmax)
    outs = [None] * TP

    def rank(r):
        outs[r] = tp.matmul(xt, _place(leaf, r), "w8a8")

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(TP)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(calls) == TP and len(set(calls)) == TP
    for out in outs:
        assert torch.equal(out.float(), want)


# --- the codes kernel's arithmetic (given_codes) ------------------------------------------


def _given_codes(v: np.ndarray, s: np.float32, rounding: str = "magic") -> np.ndarray:
    """w8a8_matmul.cu::given_codes: the IEEE quotient v / s clipped to ±127,
    rounded half to even by adding 1.5 · 2^23 and read from the low byte of
    the sum's bits; `rounding` "half_up" (floor(q + 1/2)) is the negative
    control."""
    with np.errstate(over="ignore"):
        q = np.clip(v.astype(np.float32) / np.float32(s), np.float32(-127), np.float32(127))
    if rounding == "half_up":
        return np.floor(q + np.float32(0.5)).astype(np.int8)
    bits = (q + KMAGIC).astype(np.float32).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


def _plain_codes(v: np.ndarray, s: np.float32) -> np.ndarray:
    with np.errstate(over="ignore"):
        q = np.rint(v.astype(np.float32) / np.float32(s))
    return np.clip(q, -127, 127).astype(np.int8)


def _ties(rng, n: int, s: np.float32) -> np.ndarray:
    """Values (j + 1/2) · s, |j| <= 126, exact for a power-of-two s."""
    j = rng.integers(-127, 127, n).astype(np.float32) + np.float32(0.5)
    return (j * np.float32(s)).astype(np.float32)


@pytest.mark.parametrize("scale", ["row_max", "odd", "tiny_clamped", "subnormal", "huge"])
def test_given_codes_equal_the_quotient(scale):
    rng = np.random.default_rng(7)
    v = (rng.standard_normal(4096) * 3).astype(np.float32)
    s = {"row_max": np.float32(np.abs(v).max()) / np.float32(127),
         "odd": np.float32(0.0123456789),       # |v / s| far past 127: the clip decides
         "tiny_clamped": np.float32(1e-8),
         "subnormal": np.float32(1e-39),
         "huge": np.float32(3e38)}[scale]
    if scale in ("tiny_clamped", "subnormal"):
        v[:2048] = 0.0
        v[2048:] = (v[2048:] * np.float32(1e-9)).astype(np.float32)
    if scale in ("row_max", "odd"):
        v = np.concatenate([v, _ties(rng, 4096, np.float32(2.0 ** -5)) * (s / 2.0 ** -5)])
    assert np.array_equal(_given_codes(v, s), _plain_codes(v, s))


def test_given_codes_round_exact_ties_to_even():
    """At exact ties (j + 1/2) · 2^-5 the magic-number sum rounds to even as
    jnp.round does; rounding half up (the negative control) does not."""
    rng = np.random.default_rng(11)
    s = np.float32(2.0 ** -5)
    v = _ties(rng, 1 << 14, s)
    assert np.array_equal(_given_codes(v, s), _plain_codes(v, s))
    assert (_given_codes(v, s, "half_up") != _plain_codes(v, s)).sum() > 1000


# --- the unit and vector maps --------------------------------------------------------------


def _row_threads(M: int, units: int) -> int:
    """w8a8_matmul.cu::row_threads."""
    cap = 512 if M <= 64 else 128
    return min(cap, -(-units // 32) * 32)


@pytest.mark.parametrize("M,Kv,Kp,bf16", [(6912, 5504, 5504, True), (24, 2048, 2048, True),
                                          (6144, 2152, 2160, True), (6264, 512, 512, True),
                                          (3, 44, 48, True), (1, 4, 16, True),
                                          (7, 2152, 2160, False), (70000, 12, 16, True)])
def test_quant_given_units_cover_the_row(M, Kv, Kp, bf16):
    """Each thread's 16-code units [k, k + 16) cover [0, Kp) once; every
    VW-value load lies wholly inside [0, Kv) and, under the route rule (bf16:
    16-byte loads where Kv % 8 = 0, else 8-byte; fp32 16-byte), is aligned to
    its width in every row; codes past Kv are zero words."""
    elt = 2 if bf16 else 4
    vw = 8 if bf16 and Kv % 8 == 0 else 4
    thr = _row_threads(M, Kp // 16)
    assert thr % 32 == 0 and thr <= 512
    written = np.zeros(Kp, np.int32)
    loaded = np.zeros(Kv, np.int32)
    for tid in range(thr):
        for k in range(16 * tid, Kp, 16 * thr):
            written[k:k + 16] += 1
            for j in range(16 // vw):
                if k + vw * j < Kv:
                    assert k + vw * (j + 1) <= Kv
                    loaded[k + vw * j:k + vw * (j + 1)] += 1
                    for row in (0, 1, M - 1):   # row starts: row · Kv elements in
                        assert ((row * Kv + k + vw * j) * elt) % (vw * elt) == 0
    assert (written == 1).all() and (loaded == 1).all()


def test_perm_unit_stores_are_stored_offset():
    """A 16-code unit at k stores codes k..k+3, k+8..k+11 at (k & ~31) + 8h
    and k+4..k+7, k+12..k+15 at (k & ~31) + 16 + 8h (h = (k / 16) & 1): the
    packed fragments' k order of int8_mma.cuh::stored_offset, each byte once."""
    Kp = 96
    codes = np.arange(Kp, dtype=np.int32)
    want = np.empty_like(codes)
    for k in range(0, Kp, 4):
        want[_stored_offset(k):_stored_offset(k) + 4] = codes[k:k + 4]
    got = np.full_like(codes, -1)
    for k in range(0, Kp, 16):
        w = [codes[k + 4 * i:k + 4 * i + 4] for i in range(4)]
        b = (k & ~31) + 8 * ((k >> 4) & 1)
        for off, word in ((b, w[0]), (b + 4, w[2]), (b + 16, w[1]), (b + 20, w[3])):
            assert (got[off:off + 4] == -1).all()
            got[off:off + 4] = word
    assert np.array_equal(got, want)


def _absmax_bits(x: torch.Tensor) -> np.ndarray:
    """w8a8_matmul.cu::row_absmax_kernel: the max of the sign-cleared bit
    patterns (bf16: two to a 32-bit word, __vmaxu2), as fp32."""
    if x.dtype == torch.bfloat16:
        h = x.view(torch.int16).numpy().view(np.uint16).astype(np.uint32) & 0x7FFF
        return (h.max(axis=-1) << 16).astype(np.uint32).view(np.float32)
    b = x.numpy().view(np.uint32) & 0x7FFFFFFF
    return b.max(axis=-1).view(np.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_absmax_over_bit_patterns_equals_amax(dtype):
    g = torch.Generator().manual_seed(5)
    x = (torch.randn(6, 40, generator=g) * 4).to(dtype)
    x[1] = -0.0
    x[2, 7] = float("-inf")
    x[3, 9] = float("nan")
    x[4] = -x[4].abs()
    want = lin.w8a8_row_absmax_plain(x)[:, 0].numpy()
    got = _absmax_bits(x)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    assert np.array_equal(got[keep].view(np.uint32), want[keep].view(np.uint32))
    assert torch.equal(lin.w8a8_row_absmax(x)[keep], lin.w8a8_row_absmax_plain(x)[keep])


@pytest.mark.parametrize("M,N,max_tiles", [(6912, 4096, 65535), (24, 4096, 65535),
                                           (6264, 1024, 65535), (6144, 1152, 65535),
                                           (5, 13, 65535), (9, 1, 65535), (3, 3000, 4)])
def test_epilogue_grid_writes_each_output_once(M, N, max_tiles):
    """Blocks of 8 rows (grid.x) by 256 columns (grid.y, at most `max_tiles`:
    65535 on the card; a block's later tiles 256 · gridDim.y columns on), a
    thread the 8 outputs n .. n + 7 of its row; past N none (N % 8 != 0: the
    element route)."""
    rows, tiles = 8, -(-N // 256)
    gy = min(tiles, max_tiles)
    written = np.zeros((min(M, 16), N), np.int32)   # the first two row blocks
    for bx in range(-(-min(M, 16) // rows)):
        for by in range(gy):
            for ty in range(rows):
                m = bx * rows + ty
                if m >= M:
                    continue
                for tx in range(32):
                    for n in range(8 * (by * 32 + tx), N, 256 * gy):
                        if N % 8 == 0:
                            assert (m * N + n) % 8 == 0 and n + 8 <= N   # 16-byte vectors
                        written[m, n:min(n + 8, N)] += 1
    assert (written == 1).all()
    assert -(-M // rows) <= 2 ** 31 - 1


@pytest.mark.parametrize("name", ["w8a8_row_absmax", "w8a8_quant_given"])
def test_row_parallel_steps_raise_under_grad_and_run_without(name):
    """The row-parallel steps serve: under grad an input that requires grad
    raises (the kernels have no backward), on every device; without grad
    the plain version's output."""
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(2)).requires_grad_(True)
    sx = torch.full((4, 1), 0.02)
    fn = {"w8a8_row_absmax": lambda t: lin.w8a8_row_absmax(t),
          "w8a8_quant_given": lambda t: lin.w8a8_quant_given(t, sx, 32)}[name]
    plain = {"w8a8_row_absmax": lambda t: lin.w8a8_row_absmax_plain(t),
             "w8a8_quant_given": lambda t: lin.w8a8_quant_given_plain(t, sx, 32)}[name]
    with pytest.raises(RuntimeError, match=f"{name}: an input requires grad"):
        fn(x)
    with torch.no_grad():
        assert torch.equal(fn(x), plain(x))
