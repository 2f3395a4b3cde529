"""The arithmetic of the one-shot flash kernel's two passes and of the
wi8_matmul kernel's widening, fragment orders and split-K fold, rehearsed on
the CPU.

The CUDA kernels run only on the card; what they assume is checked here in
plain torch and numpy:

- flash_prefill (``ops/csrc/flash_prefill.cu``) keeps the one-shot function
  (scale after the fp32 dot, the whole row's max, p = exp(s - m), l over the
  unrounded p, P rounded to bf16 once for PV) with two passes over a 64-row
  group's key tiles: the row max first, then the same scores again for p, l
  and PV. It shares the blockwise kernel's causal tile skip and its guard (a
  group skips a tile only once every row has seen a valid key). A tile-by-tile
  emulation, with and without the skip, is bit-equal between the two and
  agrees with `attention.flash_attention_plain` to fp32 rounding; skipping
  without the guard, an online softmax (P rounded against a running max,
  then rescaled) and fp32 P are refused.
- wi8_matmul (``ops/csrc/wi8_matmul.cu``) widens int8 codes to bf16 with a
  byte permutation and one bf16 subtraction, exact for all 256 codes; its
  wgmma route reads the codes of its register fragments in x's k order from
  a tile with the 64-byte swizzle; its decode route gives both mma.sync
  operands the same permuted k (4 consecutive k a thread) and sums its
  split-K partials in a fixed warp order, each warp on stages of its own.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import linear as tlin

NEG_INF = float(np.float32(tattn.NEG_INF))
TILE = ROWS = 64
INT_MAX = 2 ** 31 - 1


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


# --- the one-shot flash kernel ------------------------------------------------------


def _visits(valid_b, first, last, Tq, qw, j, offset, causal, guard=True):
    """attention_common.cuh::visits (first = INT_MAX and last = -1 where the
    batch row has no valid key); `guard=False` drops its first condition."""
    if qw >= Tq:
        return False
    if not causal or (guard and first > qw + offset):
        return True
    k0 = j * TILE
    if k0 > min(min(qw + ROWS, Tq) - 1 + offset, last):
        return False
    return k0 <= first or bool((valid_b[k0:k0 + TILE] > 0).any())


def _scores_full(q, k):
    """The fp32 scores of every (query, key) pair, (q . k) * scale: one
    function, so a tile recomputed in pass 2 has pass 1's bits, as the
    kernel's same wgmma sequence does."""
    scale = tattn._scale(q.shape[-1])
    return torch.matmul(q.permute(0, 2, 1, 3).float(),
                        k.permute(0, 2, 3, 1).float()) * scale          # [B, H, Tq, Tk]


def _masked(s, valid_b, q0, k0, Tq, Tk, offset, causal):
    """A [H, 64, 64] score tile from rows q0 and keys k0 of one batch row, the
    kernel's mask applied: masked keys NEG_INF, keys at or past Tk -inf (rows
    past Tq are zero queries)."""
    H = s.shape[0]
    tile = torch.zeros((H, ROWS, TILE))
    nq, nk = min(ROWS, Tq - q0), min(TILE, Tk - k0)
    tile[:, :nq, :nk] = s[:, q0:q0 + nq, k0:k0 + nk]
    ok = torch.zeros(TILE, dtype=torch.bool)
    ok[:nk] = valid_b[k0:k0 + nk] > 0
    mask = ok[None, :].expand(ROWS, TILE)
    if causal:
        mask = mask & (torch.arange(k0, k0 + TILE)[None, :]
                       <= torch.arange(q0, q0 + ROWS)[:, None] + offset)
    tile = torch.where(mask[None], tile, torch.tensor(NEG_INF))
    tile[..., nk:] = -float("inf")
    return tile


def _oneshot_tiles(q, k, v, valid, offset=0, causal=True, skip=False, guard=True,
                   online=False):
    """flash_prefill.cu's tensor-core kernel, one 64-row group and one 64-key
    tile at a time, in fp32; returns the output before its cast, [B, Tq, H,
    Dh]. Pass 1: the row max over the tiles the group visits; pass 2: p =
    exp(s - m), l += sum p, o += bf16(p) V. With `skip`, the causal tile skip
    (and `guard`). With `online`, one pass of an online softmax instead: P
    rounded to bf16 against the running max, o and l rescaled."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    S = _scores_full(q, k)
    vh = v.permute(0, 2, 1, 3).float()
    out = torch.zeros((B, H, Tq, Dh))
    n_tiles = -(-Tk // TILE)
    for b in range(B):
        keys = torch.nonzero(valid[b] > 0).flatten().tolist()
        first, last = (keys[0], keys[-1]) if keys else (INT_MAX, -1)
        for q0 in range(0, Tq, ROWS):
            tiles = [j for j in range(n_tiles) if not skip
                     or _visits(valid[b], first, last, Tq, q0, j, offset, causal, guard)]
            m = torch.full((H, ROWS, 1), NEG_INF)
            l = torch.zeros((H, ROWS, 1))
            o = torch.zeros((H, ROWS, Dh))
            if not online:
                for j in tiles:
                    s = _masked(S[b], valid[b], q0, j * TILE, Tq, Tk, offset, causal)
                    m = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            for j in tiles:
                s = _masked(S[b], valid[b], q0, j * TILE, Tq, Tk, offset, causal)
                vt = torch.zeros((H, TILE, Dh))
                vt[:, :min(TILE, Tk - j * TILE)] = vh[b, :, j * TILE:(j + 1) * TILE]
                if online:
                    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                    corr = torch.exp(m - m_new)
                    l, o, m = l * corr, o * corr, m_new
                p = torch.exp(s - m)
                l = l + p.sum(dim=-1, keepdim=True)
                o = o + torch.matmul(_bf16(p), vt)
            n = min(ROWS, Tq - q0)
            out[b, :, q0:q0 + n] = (o / torch.clamp(l, min=1e-30))[:, :n]
    return out.permute(0, 2, 1, 3)


def _plain_fp32(q, k, v, valid, offset=0, causal=True):
    """`flash_attention_plain`'s arithmetic without its last cast."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    s = _scores_full(q, k)
    ok = (valid > 0)[:, None, None, :]
    if causal:
        ok = ok & (torch.arange(Tk)[None, :] <= torch.arange(Tq)[:, None] + offset)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = torch.matmul(_bf16(p), v.permute(0, 2, 1, 3).float())
    return (pv / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)).permute(0, 2, 1, 3)


def _attn_inputs(seed, B, Tq, Tk, H=2, Dh=64):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=(B, t, H, Dh)).astype(np.float32)).bfloat16()
            for t in (Tq, Tk, Tk)]


CASES = {
    # name: (Tq, Tk, offset, causal, valid-mask edit)
    "causal": (192, 192, 0, True, None),
    "prefill_ragged_tk": (160, 167, 0, True, "tail"),     # the serving shape's S = T + A
    "offset": (70, 300, 230, True, None),
    "right_padded_rows": (200, 200, 0, True, "pad"),
    "fully_masked_rows": (192, 192, 0, True, (0, 70)),
    "not_causal": (64, 256, 0, False, (64, 128)),
}


def _case(name, seed=1):
    Tq, Tk, offset, causal, edit = CASES[name]
    q, k, v = _attn_inputs(seed, 2, Tq, Tk)
    valid = torch.ones((2, Tk), dtype=torch.int32)
    if edit == "tail":
        valid[:, Tq:] = 0
        valid[0, Tq - 9:] = 0
    elif edit == "pad":
        valid[0, Tk - 70:] = 0
    elif edit is not None:
        valid[-1, edit[0]:edit[1]] = 0
    return q, k, v, valid, offset, causal


@pytest.mark.parametrize("case", list(CASES))
def test_two_passes_keep_the_one_shot_function(case):
    """The skip changes no bit; the two passes agree with the plain version to
    fp32 rounding before the cast, and meet the chip check after it."""
    q, k, v, valid, offset, causal = _case(case)
    full = _oneshot_tiles(q, k, v, valid, offset, causal)
    assert torch.equal(_oneshot_tiles(q, k, v, valid, offset, causal, skip=True), full)
    torch.testing.assert_close(full, _plain_fp32(q, k, v, valid, offset, causal),
                               rtol=1e-5, atol=1e-5)
    tattn.compare_oneshot(full.to(torch.bfloat16),
                          tattn.flash_attention_plain(q, k, v, valid, offset, causal))


def test_the_guard_keeps_fully_masked_rows_and_the_skip_without_it_does_not():
    """Rows 0..69 of the last batch row see no valid key: with the guard their
    groups visit every tile and they keep the mean of V over Tk; skipping
    without it drops them to zero (negative control)."""
    q, k, v, valid, offset, causal = _case("fully_masked_rows")
    full = _oneshot_tiles(q, k, v, valid, offset, causal)
    mean_v = v[-1].float().mean(0).bfloat16()
    tattn.compare_oneshot(full[-1, :70].to(torch.bfloat16), mean_v[None].expand(70, -1, -1))
    unguarded = _oneshot_tiles(q, k, v, valid, offset, causal, skip=True, guard=False)
    assert not torch.equal(unguarded[-1, :64], full[-1, :64])
    assert torch.equal(unguarded[-1, 70:], full[-1, 70:])   # rows that saw a valid key
    assert torch.equal(unguarded[0], full[0])


@pytest.mark.parametrize("case", ["causal", "prefill_ragged_tk"])
def test_the_check_refuses_an_online_softmax_and_fp32_p(case):
    """Negative controls of attention.compare_oneshot: P rounded against a
    running max and rescaled, and fp32 P (the blockwise class), on inputs the
    two-pass emulation passes with (also under the card's oneshot_slack).
    Each of the check's two conditions refuses them alone: an element more
    than one bf16 step plus the slack off, and more than 2 % of the elements
    apart at all (9-36 % here)."""
    q, k, v, valid, offset, causal = _case(case)
    want = tattn.flash_attention_plain(q, k, v, valid, offset, causal)
    slack = tattn.oneshot_slack(q, k, v, valid, offset, causal)
    two_pass = _oneshot_tiles(q, k, v, valid, offset, causal).to(torch.bfloat16)
    tattn.compare_oneshot(two_pass, want)
    tattn.compare_oneshot(two_pass, want, slack=slack)
    online = _oneshot_tiles(q, k, v, valid, offset, causal, online=True).to(torch.bfloat16)
    fp32_p = tattn.flash_attention_blockwise_plain(q, k, v, valid, offset, causal)
    for other in (online, fp32_p):
        with pytest.raises(AssertionError, match="bf16 step off"):
            tattn.compare_oneshot(other, want, max_share=1.0, slack=slack)
        with pytest.raises(AssertionError, match="elements apart"):
            tattn.compare_oneshot(other, want, slack=torch.full_like(slack, 1e9))


# --- wi8_matmul: the widening -----------------------------------------------------


def _byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """__byte_perm(x, y, sel): byte i of the result is byte (sel >> 4 i) & 7
    of the 8 bytes x0..x3, y0..y3."""
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    src += [np.full_like(x, (y >> (8 * i)) & 0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _halves(w: np.ndarray) -> np.ndarray:
    """A uint32 word as its two bf16 halves in float32, the low half first."""
    return np.stack([((w & 0xFFFF) << 16).view(np.float32),
                     (w & 0xFFFF0000).view(np.float32)], axis=-1)


def _widen2(w: np.ndarray, sel: int) -> np.ndarray:
    """wi8_matmul.cu::widen2: lo = 128 + (c & 0x7F), hi = 128 or 256, lo - hi
    in bf16 (the subtraction rounds to bf16: `_bf16` of its fp32 value)."""
    a = _byte_perm(w.astype(np.uint32), 0x43434343, sel)
    diff = _halves(a & np.uint32(0xFF7FFF7F)) - _halves(a & np.uint32(0xFF80FF80))
    return _bf16(torch.from_numpy(diff)).numpy()


def test_widening_is_exact_for_every_code():
    """All 256 codes at every byte position, with the selectors of the low
    (0x5140) and the high (0x7362) pair."""
    codes = np.arange(-128, 128)
    u = (codes & 0xFF).astype(np.uint32)
    for pos in range(4):
        w = u << np.uint32(8 * pos)
        sel, half = (0x5140, 0) if pos < 2 else (0x7362, 2)
        assert np.array_equal(_widen2(w, sel)[:, pos - half], codes.astype(np.float32))
    r = np.random.default_rng(0)
    c4 = r.integers(-128, 128, size=(1000, 4))
    w = sum((c4[:, i] & 0xFF).astype(np.uint32) << np.uint32(8 * i) for i in range(4))
    got = np.concatenate([_widen2(w, 0x5140), _widen2(w, 0x7362)], axis=-1)
    assert np.array_equal(got, c4.astype(np.float32))


def test_a_single_bias_of_128_is_not_exact_in_bf16():
    """Negative control: without the sign split, the bias trick of fp16 (the
    word 0x43 | (c + 128) is 128 + (c + 128) for c + 128 < 128; minus 256) is
    wrong for every c > 0: bf16's 7 fraction bits cannot hold c + 128."""
    codes = np.arange(-128, 128)
    bits = (0x4300 | ((codes & 0xFF) ^ 0x80)).astype(np.uint32)
    got = _bf16(torch.from_numpy(_halves(bits)[:, 0] - np.float32(256))).numpy()
    wrong = codes[got != codes]
    assert wrong.size > 0 and np.array_equal(wrong, np.arange(1, 128))


# --- wi8_matmul: fragment orders ------------------------------------------------------


def _swizzled(tile: np.ndarray, row_bytes: int) -> np.ndarray:
    """The bytes of a [rows][row_bytes] tile as TMA writes it with the
    64-byte (row_bytes 64) or 128-byte (row_bytes 128) swizzle: 16-byte chunk
    c of row r at c ^ ((r >> 1) & 3), or c ^ (r & 7)."""
    out = np.zeros(tile.nbytes, dtype=np.uint8)
    flat = tile.view(np.uint8).reshape(tile.shape[0], row_bytes)
    for r in range(tile.shape[0]):
        for c in range(row_bytes // 16):
            pos = c ^ ((r >> 1) & 3) if row_bytes == 64 else c ^ (r & 7)
            out[r * row_bytes + 16 * pos:r * row_bytes + 16 * pos + 16] = flat[r, 16 * c:16 * c + 16]
    return out


def _code_at(r: int, k: int) -> int:
    """wi8_matmul.cu::code_at."""
    return r * 64 + ((((k >> 4) ^ (r >> 1)) & 3) << 4) + (k & 15)


def _wgmma_a(smem: np.ndarray, kk: int, consecutive: bool = False) -> np.ndarray:
    """The 64 x 16 A operand of k16 step kk that the wgmma route's 128 threads
    of one warpgroup hold (register i of thread (warp, g, t4): rows
    16 warp + g (+ 8 for registers 1, 3), k slots 2 t4, 2 t4 + 1 (+ 8 for
    registers 2, 3)), loaded as the kernel does; `consecutive`: the 4 codes at
    4 t4 of the row instead (the order an ldmatrix word gives)."""
    a = np.zeros((64, 16), dtype=np.int64)
    for warp in range(4):
        for g in range(8):
            for t4 in range(4):
                r0 = warp * 16 + g
                for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
                    r = r0 + dr
                    if consecutive:
                        k = kk * 16 + 4 * t4 + (dk // 4)
                    else:
                        k = kk * 16 + 2 * t4 + dk
                    pair = smem[_code_at(r, k):_code_at(r, k) + 2].view(np.int8)
                    a[r, 2 * t4 + dk:2 * t4 + dk + 2] = pair
    return a


def test_wgmma_fragments_hold_the_codes_in_x_k_order():
    """Each thread's 16-bit loads from the swizzled tile put code (row, k) at
    the A operand's (row, k), for every k16 step: the natural k order that x,
    wgmma's shared-memory operand, is read in; four consecutive codes a thread
    (an ldmatrix word) would pair codes with the wrong x (negative control)."""
    r = np.random.default_rng(1)
    codes = r.integers(-128, 128, size=(64, 64)).astype(np.int8)
    x = r.integers(-100, 101, size=(64, 32))          # exact in bf16
    smem = _swizzled(codes, 64)
    got = sum(_wgmma_a(smem, kk) @ x[16 * kk:16 * kk + 16] for kk in range(4))
    for kk in range(4):
        assert np.array_equal(_wgmma_a(smem, kk), codes[:, 16 * kk:16 * kk + 16])
    assert np.array_equal(got, codes.astype(np.int64) @ x)
    wrong = sum(_wgmma_a(smem, kk, consecutive=True) @ x[16 * kk:16 * kk + 16] for kk in range(4))
    assert not np.array_equal(wrong, codes.astype(np.int64) @ x)


def _decode_step(xs: np.ndarray, qs: np.ndarray, i: int, x_natural: np.ndarray = None):
    """One m16n8k16 step i of the decode route for m16 tile 0 and n8 tile 0,
    from the swizzled stage bytes (x: two [32 rows][64 bf16] boxes, 128-byte
    swizzle; codes [32 n][128 bytes], 128-byte swizzle), loaded as the kernel
    does: thread (g, t4) takes k = 16 i + 4 t4 .. + 3 of its x rows and its
    weight column, the first two at slots 2 t4, 2 t4 + 1, the last two at
    2 t4 + 8, 2 t4 + 9. Returns the [16, 8] product of the fragments (mma's
    D = A B over the 16 slots). `x_natural`: x [rows, k] to take at slot j
    from k = 16 i + j instead (negative control)."""
    a = np.zeros((16, 16))
    b = np.zeros((16, 8))
    for g in range(8):
        for t4 in range(4):
            slots = [2 * t4, 2 * t4 + 1, 2 * t4 + 8, 2 * t4 + 9]
            for h in range(2):
                row = g + 8 * h
                chunk = 2 * (i % 4) + (t4 >> 1)
                off = (i // 4) * 32 * 128 + row * 128 + ((chunk ^ (row & 7)) << 4) + 8 * (t4 & 1)
                vals = (xs[off:off + 8].view(np.uint16).astype(np.uint32) << 16).view(np.float32)
                if x_natural is not None:
                    vals = x_natural[row, [16 * i + j for j in slots]]
                a[row, slots] = vals
            n = g
            w = qs[n * 128 + ((i ^ (n & 7)) << 4) + 4 * t4:][:4].view(np.int8)
            b[slots, n] = w
    return a @ b


def test_decode_fragments_pair_each_x_with_its_code():
    """Both operands take the same permuted k in the same slots, so the sum of
    the steps is x · qᵀ (integer x: exact); x in its natural slot order
    against the permuted codes is not (negative control)."""
    r = np.random.default_rng(2)
    x = r.integers(-100, 101, size=(32, 128)).astype(np.float32)
    codes = r.integers(-128, 128, size=(32, 128)).astype(np.int8)
    xb = torch.from_numpy(x).bfloat16().view(torch.int16).numpy().view(np.uint16)
    xs = np.concatenate([_swizzled(np.ascontiguousarray(xb[:, 64 * h:64 * h + 64]), 128)
                         for h in range(2)])
    qs = _swizzled(codes, 128)
    want = x[:16] @ codes[:8].T.astype(np.float32)
    assert np.array_equal(sum(_decode_step(xs, qs, i) for i in range(8)), want)
    wrong = sum(_decode_step(xs, qs, i, x_natural=x) for i in range(8))
    assert not np.array_equal(wrong, want)


# --- wi8_matmul: the decode route's split-K fold and its stages ------------------------


def _decode_constants():
    src = (Path(tlin.__file__).parent / "csrc" / "wi8_matmul.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kDWarps", "kDSlots", "kDBK"))


def _split_k(x, q, s, order=None):
    """The decode route's sums in float32: chunk c of 128 k to warp c % 8,
    each warp adding its chunks' fp32 partial products in chunk order, then the
    warps' partials added in `order` (the kernel's: 0..7), times s. Returns
    the fp32 result before the cast."""
    warps, _, chunk = _decode_constants()
    xf, qf = x.float().numpy(), q.float().numpy()
    parts = np.zeros((warps, x.shape[0], q.shape[0]), dtype=np.float32)
    for c in range(-(-x.shape[1] // chunk)):
        ks = slice(c * chunk, (c + 1) * chunk)
        parts[c % warps] += (xf[:, ks].astype(np.float64) @ qf[:, ks].T).astype(np.float32)
    acc = np.zeros(parts.shape[1:], dtype=np.float32)
    for w in (order if order is not None else range(warps)):
        acc = acc + parts[w]
    return torch.from_numpy(acc * s.numpy()[None, :])


@pytest.mark.parametrize("K", [4096, 4304])
def test_decode_fold_meets_the_check_and_its_order_is_fixed(K):
    """The fixed-order fold of the split-K partials meets lin.compare_wi8 (M =
    24, a decode step; K = 4304 ends in a partial chunk); the same partials
    folded in another warp order (as atomics would, by arrival) give other
    bits, so the kernel's order is what makes a launch repeatable."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(24, K)).astype(np.float32)).bfloat16()
    q = torch.from_numpy(r.integers(-127, 128, size=(192, K)).astype(np.int8))
    s = torch.from_numpy((r.random(192) * 1e-3 + 1e-3).astype(np.float32))
    got = _split_k(x, q, s)
    tlin.compare_wi8(got.to(torch.bfloat16), tlin.wi8_matmul_plain(x, q, s))
    assert torch.equal(_split_k(x, q, s), got)
    assert not torch.equal(_split_k(x, q, s, order=range(7, -1, -1)), got)


def _play_ring(KT, slots, warps, seed):
    """Play the decode route's stages on mbarrier semantics, one step of one
    actor at a time in a random order: the producer (chunk c into slot
    c % slots: wait on its "empty" parity, issue the load), the loads (land in
    any order, completing the slot's "full" phase), and the consumer warps
    (warp c % warps takes chunk c: wait on "full" with the chunk's parity,
    read, arrive on "empty"). A wait on parity P passes once the barrier's
    phase of parity P has completed, so it passes at once on a barrier that
    has completed no phase yet for P = 1. Returns the faults: each read of a
    slot that did not hold the chunk waited for, and "deadlock" if every actor
    came to wait on what no other could complete."""
    rng = np.random.default_rng(seed)
    full, empty, held = [0] * slots, [0] * slots, [None] * slots
    in_flight, wrong = [], []

    def passes(bar, slot, parity):
        return bar[slot] % 2 != parity

    def producer():
        for c in range(KT):
            slot = c % slots
            yield lambda: passes(empty, slot, ((c // slots) & 1) ^ 1)
            in_flight.append(c)

    def consumer(w):
        for c in range(w, KT, warps):
            slot = c % slots
            yield lambda: passes(full, slot, (c // slots) & 1)
            if held[slot] != c:
                wrong.append((c, held[slot]))
            empty[slot] += 1

    actors = {name: gen for name, gen in
              [("producer", producer()), *((w, consumer(w)) for w in range(warps))]}
    conds = {}
    for name in list(actors):
        try:
            conds[name] = next(actors[name])
        except StopIteration:
            del actors[name]
    while actors or in_flight:
        ready = [name for name in actors if conds[name]()]
        choices = ready + (["land"] if in_flight else [])
        if not choices:
            return [*wrong, "deadlock"]
        pick = choices[rng.integers(len(choices))]
        if pick == "land":
            c = in_flight.pop(rng.integers(len(in_flight)))
            held[c % slots] = c
            full[c % slots] += 1
            continue
        try:
            conds[pick] = next(actors[pick])
        except StopIteration:
            del actors[pick]
    return wrong


def test_decode_stages_of_each_warp_never_read_early():
    """Each warp's chunks go to stages of its own (slots a multiple of the
    warps): a warp waits on a slot's phase only after consuming its previous
    use, so no wait passes a whole phase ahead; K = 4096 and 11008 (32 and
    86 chunks). A ring whose slots do not divide among the warps (12 for 8)
    lets a warp's wait pass before its chunk lands, or stalls (negative
    control)."""
    warps, per_warp, chunk = _decode_constants()
    for K in (4096, 11008):
        for seed in range(10):
            assert _play_ring(K // chunk, warps * per_warp, warps, seed) == []
    assert any(_play_ring(4096 // chunk, 12, warps, seed) for seed in range(20))
