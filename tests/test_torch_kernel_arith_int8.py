"""The arithmetic of the int8 GEMMs' wgmma route and split-K decode route,
rehearsed on the CPU.

The CUDA kernels (``ops/csrc/w8a8_matmul.cu``, ``ops/csrc/nib_hi_dot.cu`` and
their shared ``ops/csrc/int8_decode.cuh``) run only on the card; what they
assume is checked here in plain torch and numpy:

- ``rebuild`` (``int8_mma.cuh``) turns one packed word of each nibble plane
  into the 8 exact int8 codes 16·hi + lo + 8 in k order: emulated on every
  (hi, lo) byte pair it equals `linear.nibble_reconstruct_q8`.
- The fragments: ldmatrix and the TMA swizzles emulated on byte tiles, each
  route's register fragments (wgmma's register operand A built from rebuilt
  nibble codes; mma.sync's A and B at decode from int8 codes, the hi plane
  widened, or both planes rebuilt) pair every weight code with its own
  activation code, given the k order each route's activation codes come in
  (natural for int8 weights, the pre-pass's ``stored_offset`` order for
  packed ones). The negative control: natural-order codes against the
  packed-weight fragments give another sum.
- The split-K decode route gives chunk c to warp c % 8, in stage
  (c % 8) · 2 + (c / 8) % 2: every chunk exactly once, ragged counts a warp
  at K = 11008 and 4304; played out on mbarrier parity semantics with random
  interleavings, no warp reads a stage before its chunk lands, and a warp
  that released its stage before reading it would. The wgmma route's ring
  on its persistent grid (int8 leaves: each warpgroup releases the stage of
  the group before, after wgmma_wait<1>, and a tile's last stage after
  wgmma_wait<0>; the nibble loader its own stage after wgmma_wait<0>)
  likewise, over several tiles, with the negative control of releasing the
  stage whose group is still in flight.
- The fp32 epilogues, each step rounded once in numpy float32, equal
  `linear.w8a8_matmul_plain` and `linear.nib_hi_dot_plain` bit for bit;
  contracting the correction's product into the sum with one rounding (an
  FMA) differs on rows whose code sums are large, and so does multiplying
  by s_x · s at once.
- The int32 bounds at the largest K.
"""

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import linear as tlin

WARPS, SLOTS, CHUNK = 8, 2, 128


# --- rebuild ---------------------------------------------------------------------


def _bytes_of(words: np.ndarray, i: int) -> np.ndarray:
    return (words >> np.uint32(8 * i)) & np.uint32(0xFF)


def _byte_perm(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(a, b, sel) with selector nibbles < 8."""
    out = np.zeros_like(a)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= _bytes_of(a if src < 4 else b, src % 4) << np.uint32(8 * i)
    return out


def _rebuild(ph: np.ndarray, pl: np.ndarray):
    """int8_mma.cuh::rebuild on uint32 words (8 packed codes of each plane)."""
    ph, pl = ph.astype(np.uint32), pl.astype(np.uint32)
    ev = ((ph & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | ((pl & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808))
    od = (ph & np.uint32(0xF0F0F0F0)) | (((pl >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) ^ np.uint32(0x08080808))
    return _byte_perm(ev, od, 0x5140), _byte_perm(ev, od, 0x7362)


def _widen(w: np.ndarray):
    """int8_mma.cuh::widen on uint32 words of 8 packed codes of one plane."""
    w = w.astype(np.uint32)
    a, b = w & np.uint32(0x0F0F0F0F), (w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)
    lo, hi = _byte_perm(a, b, 0x5140), _byte_perm(a, b, 0x7362)
    m = np.uint32(0x08080808)
    # __vsub4(v ^ 8, 8) bytewise: (v ^ 8) - 8 modulo 256 per byte (+ 248 is - 8 mod 256)
    sub = lambda v: sum((((_bytes_of(v ^ m, i) + np.uint32(248)) & np.uint32(0xFF)) << np.uint32(8 * i))
                        for i in range(4))
    return sub(lo).astype(np.uint32), sub(hi).astype(np.uint32)


def _codes_of(words) -> np.ndarray:
    """uint32 words -> their 4 bytes as int8 codes, byte 0 first."""
    a = np.ascontiguousarray(np.asarray(words, dtype="<u4"))
    return a.reshape(-1).view(np.int8).reshape(*a.shape, 4)


def _words_of(packed: np.ndarray) -> np.ndarray:
    """uint8 [..., 4 n] -> uint32 [..., n], byte 0 the least significant."""
    return np.ascontiguousarray(packed).view("<u4")


def test_rebuild_equals_nibble_reconstruct_for_every_byte_pair():
    """All 256 x 256 (hi byte, lo byte) pairs, in every byte position of a
    word: the two rebuilt words hold the 8 codes 16·hi + lo + 8 in k order."""
    hb, lb = np.meshgrid(np.arange(256, dtype=np.uint8), np.arange(256, dtype=np.uint8),
                         indexing="ij")
    for shift in range(4):   # the pair at byte `shift` of each word, other bytes varied
        hi = np.roll(np.stack([hb.ravel(), lb.ravel(), hb.ravel()[::-1], lb.ravel()[::-1]], -1),
                     shift, axis=-1).copy()
        lo = np.roll(np.stack([lb.ravel(), hb.ravel(), lb.ravel()[::-1], hb.ravel()[::-1]], -1),
                     shift, axis=-1).copy()
        w0, w1 = _rebuild(_words_of(hi)[:, 0], _words_of(lo)[:, 0])
        got = np.concatenate([_codes_of(w0), _codes_of(w1)], axis=-1)          # [65536, 8]
        want = tlin.nibble_reconstruct_q8({"hi": torch.from_numpy(hi), "lo": torch.from_numpy(lo),
                                           "s": torch.ones(hi.shape[0])}).numpy()
        assert np.array_equal(got, want)


def test_widen_equals_the_unpacked_hi_plane():
    r = np.random.default_rng(3)
    packed = r.integers(0, 256, size=(64, 4), dtype=np.uint8)
    lo, hi = _widen(_words_of(packed)[:, 0])
    got = np.concatenate([_codes_of(lo), _codes_of(hi)], axis=-1)
    assert np.array_equal(got, tlin.unpack_int4(torch.from_numpy(packed)).numpy())


# --- fragments: ldmatrix over TMA-swizzled tiles ----------------------------------


def _swizzle(rows: int, row_bytes: int, data: np.ndarray) -> np.ndarray:
    """A TMA box [rows][row_bytes] as the 128- or 64-byte swizzle stores it
    (hopper.cuh): 16-byte chunk c of row r at chunk c ^ (r % 8) for 128-byte
    rows, c ^ ((r >> 1) % 4) for 64-byte rows."""
    out = np.zeros(rows * row_bytes, dtype=np.uint8)
    for r in range(rows):
        for c in range(row_bytes // 16):
            sc = c ^ (r % 8) if row_bytes == 128 else c ^ ((r >> 1) % 4)
            out[r * row_bytes + 16 * sc:r * row_bytes + 16 * sc + 16] = data[r, 16 * c:16 * c + 16]
    return out


def _ldmatrix_x4(smem: np.ndarray, addr) -> np.ndarray:
    """ldmatrix.x4 .b16: lane L gives the 16-byte row address `addr(L)` of
    row L % 8 of matrix L // 8; returns regs [32 lanes][4] uint32: lane L
    gets bytes 4 (L % 4) .. + 3 of row L // 4 of each matrix."""
    rows = np.stack([smem[addr(L):addr(L) + 16] for L in range(32)])   # [32][16]
    regs = np.zeros((32, 4), dtype=np.uint32)
    for L in range(32):
        for i in range(4):
            regs[L, i] = _words_of(rows[8 * i + L // 4, 4 * (L % 4):4 * (L % 4) + 4].copy())[0]
    return regs


def _stored_offset(k: int) -> int:
    """int8_mma.cuh::stored_offset (k a multiple of 4)."""
    c4 = (k & 31) >> 2
    return (k & ~31) + 4 * ((4 + (c4 >> 1)) if c4 & 1 else (c4 >> 1))


def _permute(codes: np.ndarray) -> np.ndarray:
    """The pre-pass's PERM store: natural k -> stored_offset(k)."""
    out = np.empty_like(codes)
    for k in range(0, codes.shape[-1], 4):
        out[..., _stored_offset(k):_stored_offset(k) + 4] = codes[..., k:k + 4]
    return out


def _slots(regs_by_lane, rows: int) -> np.ndarray:
    """The k slots of a 32-deep step from an m16n8k32 / wgmma 8-bit fragment:
    lane (g8, t4)'s register pair (first, second) covers slots 4 t4 .. + 3
    and 16 + 4 t4 .. + 3 of its row g8 (+ 8 h for A's second pair)."""
    out = np.zeros((rows, 32), dtype=np.int64)
    for L in range(32):
        g8, t4 = L // 4, L % 4
        for h, (first, second) in enumerate(regs_by_lane[L]):
            out[g8 + 8 * h, 4 * t4:4 * t4 + 4] = _codes_of(np.uint32(first))
            out[g8 + 8 * h, 16 + 4 * t4:20 + 4 * t4] = _codes_of(np.uint32(second))
    return out


def _nibble_planes(seed, rows, K):
    r = np.random.default_rng(seed)
    q8 = r.integers(-127, 128, size=(rows, K))
    q8[:, 0] = 127   # s = 1: the codes are the weights
    w = tlin.quantize_weight_nibble(torch.from_numpy(q8.astype(np.float32)))
    assert np.array_equal(tlin.nibble_reconstruct_q8(w).numpy(), q8)
    return q8, w["hi"].numpy(), w["lo"].numpy()


def _wgmma_nibble_fragments(hi: np.ndarray, lo: np.ndarray, warp: int, kk: int):
    """w8a8_matmul.cu's nibble loader for one warp of one warpgroup (weight
    rows 16 warp .. 16 warp + 15 of a 64-row slab), k32 step kk of a chunk:
    the two planes' [64 n][64 bytes] tiles 64-byte swizzled, ldmatrix at
    n * 64 + (((lane >> 3) ^ ((n >> 1) & 3)) << 4), rebuilt into
    f[kk][0..3] (rows g8: registers 0, 2; rows g8 + 8: 1, 3)."""
    sh, sl = _swizzle(64, 64, hi), _swizzle(64, 64, lo)
    ph, pl = [], []
    for h in range(2):
        def addr(L, h=h):
            n = warp * 16 + 8 * h + (L & 7)
            return n * 64 + (((L >> 3) ^ ((n >> 1) & 3)) << 4)
        ph.append(_ldmatrix_x4(sh, addr))
        pl.append(_ldmatrix_x4(sl, addr))
    f = []
    for L in range(32):
        r0 = _rebuild(ph[0][L, kk], pl[0][L, kk])   # f[kk][0], f[kk][2]
        r1 = _rebuild(ph[1][L, kk], pl[1][L, kk])   # f[kk][1], f[kk][3]
        f.append((r0, r1))
    return f


def test_wgmma_nibble_fragments_pair_with_permuted_activations():
    """Register operand A from rebuilt nibble codes against shared-memory
    operand B holding the pre-pass's permuted activation codes (K-major rows
    of 128 codes): the sum over a 128-deep chunk is the natural-order dot;
    natural-order activation codes against the same fragments are not."""
    q8, hi, lo = _nibble_planes(11, 64, CHUNK)
    r = np.random.default_rng(12)
    act = r.integers(-127, 128, size=(24, CHUNK))
    stored = _permute(act)
    want = q8 @ act.T
    for warp in range(4):
        got = np.zeros((16, act.shape[0]), dtype=np.int64)
        bad = np.zeros_like(got)
        for kk in range(4):
            a_slots = _slots(_wgmma_nibble_fragments(hi, lo, warp, kk), 16)
            got += a_slots @ stored[:, 32 * kk:32 * kk + 32].T
            bad += a_slots @ act[:, 32 * kk:32 * kk + 32].T
        assert np.array_equal(got, want[16 * warp:16 * warp + 16])
        assert not np.array_equal(bad, want[16 * warp:16 * warp + 16])


def _decode_a_slots(act_tile: np.ndarray, kk: int):
    """int8_decode.cuh's A fragments: activation codes [32 rows][128 bytes]
    128-byte swizzled, ldmatrix at row * 128 + (((2 kk + (lane >> 4)) ^
    (row & 7)) << 4), row = mt * 16 + (lane & 15)."""
    s = _swizzle(32, 128, act_tile.astype(np.int8).view(np.uint8))
    out = []
    for mt in range(2):
        def addr(L, mt=mt):
            row = mt * 16 + (L & 15)
            return row * 128 + (((2 * kk + (L >> 4)) ^ (row & 7)) << 4)
        a = _ldmatrix_x4(s, addr)
        out.append(_slots([((a[L, 0], a[L, 2]), (a[L, 1], a[L, 3])) for L in range(32)], 16))
    return np.concatenate(out)   # [32 rows][32 slots]


def _decode_b_slots(kind: str, w_tiles, j: int, kk: int):
    """int8_decode.cuh's B fragments of n8 tile j in k32 step kk: int8
    [32 n][128 bytes] (128-byte swizzle, two ldmatrix a tile, registers
    chunk 2 kk and 2 kk + 1), or packed planes [32 n][64 bytes] (64-byte
    swizzle, one ldmatrix a plane, widened / rebuilt)."""
    regs = []
    if kind == "int8":
        s = _swizzle(32, 128, w_tiles[0].astype(np.int8).view(np.uint8))
        ws = []
        for h in range(2):
            def addr(L, h=h):
                n = j * 8 + (L & 7)
                return n * 128 + ((((L >> 3) + 4 * h) ^ (n & 7)) << 4)
            ws.append(_ldmatrix_x4(s, addr))
        b = np.concatenate(ws, axis=1)   # [32][8]: chunk i
        regs = [(b[L, 2 * kk], b[L, 2 * kk + 1]) for L in range(32)]
    else:
        def addr(L):
            n = j * 8 + (L & 7)
            return n * 64 + (((L >> 3) ^ ((n >> 1) & 3)) << 4)
        ph = _ldmatrix_x4(_swizzle(32, 64, w_tiles[0]), addr)
        if kind == "hi":
            regs = [_widen(ph[L, kk]) for L in range(32)]
        else:
            pl = _ldmatrix_x4(_swizzle(32, 64, w_tiles[1]), addr)
            regs = [_rebuild(ph[L, kk], pl[L, kk]) for L in range(32)]
    # B's fragment: lane (g8, t4) holds column g8's slots; one row per column
    return _slots([(tuple(int(v) for v in regs[L]),) for L in range(32)], 8).T   # [32 slots][8]


@pytest.mark.parametrize("kind", ["int8", "nibble", "hi"])
def test_decode_fragments_pair_every_code_with_its_own(kind):
    """mma.sync m16n8k32 at decode, a 128-deep chunk of a 32 x 32 block: the
    sum over the fragments' k slots equals the natural dot with the weights'
    codes (int8: the codes themselves; nibble: the rebuilt codes; hi: the hi
    plane's), the activation codes in natural order for int8 and in the
    pre-pass's order for packed weights; the packed routes on natural-order
    codes give another sum."""
    r = np.random.default_rng(21)
    act = r.integers(-127, 128, size=(32, CHUNK))
    q8, hi, lo = _nibble_planes(22, 32, CHUNK)
    wcodes = {"int8": q8, "nibble": q8, "hi": tlin.unpack_int4(torch.from_numpy(hi)).numpy()}[kind]
    tiles = (q8,) if kind == "int8" else (hi, lo)
    stored = act if kind == "int8" else _permute(act)
    want = act @ wcodes.T.astype(np.int64)
    got = np.zeros((32, 32), dtype=np.int64)
    bad = np.zeros_like(got)
    for kk in range(4):
        a = _decode_a_slots(stored, kk)
        a_nat = _decode_a_slots(act, kk)
        for j in range(4):
            b = _decode_b_slots(kind, tiles, j, kk)
            got[:, 8 * j:8 * j + 8] += a @ b
            bad[:, 8 * j:8 * j + 8] += a_nat @ b
    assert np.array_equal(got, want)
    if kind != "int8":
        assert not np.array_equal(bad, want)


# --- the split-K decode route's chunks and rings ---------------------------------


def _warp_chunks(K: int):
    KC = -(-K // CHUNK)
    return {w: [w + WARPS * r for r in range(KC) if w + WARPS * r < KC] for w in range(WARPS)}


@pytest.mark.parametrize("K,counts", [(4096, {4}), (11008, {10, 11}), (4304, {4, 5}),
                                      (48, {0, 1})])
def test_split_k_covers_every_chunk_once(K, counts):
    chunks = _warp_chunks(K)
    flat = sorted(c for cs in chunks.values() for c in cs)
    assert flat == list(range(-(-K // CHUNK)))
    assert {len(cs) for cs in chunks.values()} == counts


def _play(actors: dict, in_flight: list, held: list, full: list, rng) -> bool:
    """Step actors (generators yielding wait conditions) and landing loads in
    a random order; False on a deadlock."""
    live = {name: [gen, next(gen)] for name, gen in actors.items()}
    while live or in_flight:
        ready = [n for n, (_, cond) in live.items() if cond()]
        choices = ready + (["land"] if in_flight else [])
        if not choices:
            return False
        pick = choices[rng.integers(len(choices))]
        if pick == "land":
            slot, c = in_flight.pop(rng.integers(len(in_flight)))
            held[slot] = c
            full[slot] += 1
            continue
        try:
            live[pick][1] = next(live[pick][0])
        except StopIteration:
            del live[pick]
    return True


def _passes(bar, slot, parity):
    """mbarrier try_wait.parity: passes once the phase of that parity is done."""
    return bar[slot] % 2 != parity


def _play_decode(K, seed, early_release=False):
    """int8_decode.cuh's ring: the producer thread fills chunk c into warp
    c % 8's stage (c / 8) % 2 after waiting on its "empty" parity; warp w
    waits on "full" with its own parity, reads the stage, then (lane 0)
    arrives on "empty" (before the read, with `early_release`). Returns the
    reads that found another chunk in the stage, or "deadlock"."""
    rng = np.random.default_rng(seed)
    KC, stages = -(-K // CHUNK), WARPS * SLOTS
    full, empty, held, in_flight, wrong = [0] * stages, [0] * stages, [None] * stages, [], []

    def producer():
        for c in range(KC):
            r, slot = c // WARPS, (c % WARPS) * SLOTS + (c // WARPS) % SLOTS
            yield lambda slot=slot, r=r: _passes(empty, slot, ((r // SLOTS) & 1) ^ 1)
            in_flight.append((slot, c))

    def consumer(w):
        for r, c in enumerate(_warp_chunks(K)[w]):
            slot = w * SLOTS + r % SLOTS
            yield lambda slot=slot, r=r: _passes(full, slot, (r // SLOTS) & 1)
            if early_release:
                empty[slot] += 1
                yield lambda: True
            if held[slot] != c:
                wrong.append((w, c, held[slot]))
            if not early_release:
                empty[slot] += 1

    ok = _play({"producer": producer(), **{w: consumer(w) for w in range(WARPS)}},
               in_flight, held, full, rng)
    return wrong if ok else [*wrong, "deadlock"]


@pytest.mark.parametrize("K", [4096, 11008, 4304])
def test_decode_warps_never_read_a_stage_before_its_chunk_lands(K):
    for seed in range(10):
        assert _play_decode(K, seed) == []


def test_releasing_a_stage_before_reading_it_lets_the_next_chunk_in():
    assert any(_play_decode(11008, seed, early_release=True) for seed in range(20))


def _play_wgmma_ring(K, stages, seed, tiles=1, nibble=False, release_current=False):
    """w8a8_matmul.cu's wgmma ring on its persistent grid: one producer
    thread fills chunk g (the block's g-th over its `tiles` tiles) into stage
    g % S; two consumer warpgroups (the stage's "empty" barrier counts 2)
    wait on "full" and start the chunk's group, whose reads of the stage
    happen at any time until the group completes. int8 leaves: wgmma_wait<1>
    completes every group but the newest, then the warpgroup releases the
    stage of chunk g - 1 within the tile, and after the tile's last group
    (wgmma_wait<0>) that group's stage. The nibble loader: wgmma_wait<0>,
    then the chunk's own stage. With `release_current` the int8 form
    releases the stage of the group still in flight (the negative control)."""
    rng = np.random.default_rng(seed)
    KC = -(-K // CHUNK)
    full, empty, held, in_flight, wrong = [0] * stages, [0] * stages, [None] * stages, [], []
    arrivals = [0] * stages

    def producer():
        for g in range(KC * tiles):
            slot = g % stages
            yield lambda slot=slot, g=g: _passes(empty, slot, ((g // stages) & 1) ^ 1)
            in_flight.append((slot, g))

    def release(slot):
        arrivals[slot] += 1
        if arrivals[slot] == 2:
            arrivals[slot] = 0
            empty[slot] += 1

    def consumer(wg):
        pending = []   # groups started whose reads of their stage have not happened yet

        def read(slot, g):
            if held[slot] != g:
                wrong.append((wg, g, held[slot]))

        def complete(keep):   # wgmma_wait<keep>: every group but the `keep` newest has read
            while len(pending) > keep:
                read(*pending.pop(0))

        g = 0
        for _ in range(tiles):
            for c in range(KC):
                slot = g % stages
                yield lambda slot=slot, g=g: _passes(full, slot, (g // stages) & 1)
                if rng.random() < 0.5:       # the group reads its stage at once, or later
                    read(slot, g)
                else:
                    pending.append((slot, g))
                yield lambda: True            # other actors run while the group is in flight
                if nibble:
                    complete(0)
                    release(slot)
                else:
                    complete(1 if pending and pending[-1][1] == g else 0)
                    if release_current:
                        release(slot)
                    elif c > 0:
                        release((g - 1) % stages)
                g += 1
            if not nibble:
                complete(0)
                if not release_current:
                    release((g - 1) % stages)   # the tile's last stage

    ok = _play({"producer": producer(), "wg0": consumer(0), "wg1": consumer(1)},
               in_flight, held, full, rng)
    return wrong if ok else [*wrong, "deadlock"]


@pytest.mark.parametrize("nibble,stages", [(False, 4), (True, 5)])
@pytest.mark.parametrize("K,tiles", [(1152, 3), (4096, 1), (4096, 2), (4304, 3)])
def test_wgmma_ring_releases_a_stage_only_after_its_group(K, tiles, nibble, stages):
    for seed in range(10):
        assert _play_wgmma_ring(K, stages, seed, tiles, nibble) == []


def test_releasing_the_stage_of_the_group_in_flight_is_refused():
    assert any(_play_wgmma_ring(4096, 4, seed, 2, release_current=True) for seed in range(20))


# --- epilogues ----------------------------------------------------------------------


def _f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _w8a8_epilogue(acc, sx, s, fused_scales=False):
    """(f32(acc) · s_x) · s, each product rounded once; `fused_scales`:
    f32(acc) · (s_x · s)."""
    a = _f32(acc)
    if fused_scales:
        return a * (_f32(sx) * _f32(s)[None])
    return (a * _f32(sx)) * _f32(s)[None]


def _nib_hi_epilogue(acc, rowsum, sx, s, fma=False):
    """((f32(acc) · 16 + f32(rowsum) · 7.5) · s_x) · s, each step rounded
    once; `fma`: the correction's product contracted into the sum, one
    rounding for f32(rowsum) · 7.5 + f32(acc) · 16."""
    a16 = _f32(acc) * np.float32(16)
    if fma:
        v = _f32(np.float64(_f32(rowsum)) * 7.5 + np.float64(a16))
    else:
        v = a16 + _f32(rowsum) * np.float32(7.5)
    return (v * _f32(sx)) * _f32(s)[None]


def _operands(seed, M, K, N, dtype):
    """x in `dtype`, an int8 leaf, and x's codes and scales as the pre-pass makes them."""
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.standard_normal((M, K)).astype(np.float32)).to(dtype)
    w = tlin.quantize_weight(torch.from_numpy(r.standard_normal((N, K)).astype(np.float32) * 0.02))
    codes, sx = tlin.quantize_rows(x.float())
    return x, w, codes.numpy().astype(np.int64), sx.numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_w8a8_epilogue_equals_the_plain_version(dtype):
    x, w, codes, sx = _operands(31, 16, 512, 64, dtype)
    acc = codes @ w["q"].numpy().astype(np.int64).T
    steps = _w8a8_epilogue(acc, sx, w["s"].numpy())
    assert torch.equal(torch.from_numpy(steps).to(dtype), tlin.w8a8_matmul_plain(x, w))
    # the negative control, in fp32 before the cast: one rounding fewer moves some outputs
    assert not np.array_equal(_w8a8_epilogue(acc, sx, w["s"].numpy(), fused_scales=True), steps)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nib_hi_epilogue_equals_the_plain_version(dtype):
    x, _, codes, sx = _operands(32, 16, 512, 64, dtype)
    w = tlin.quantize_weight_nibble(torch.from_numpy(np.random.default_rng(33).standard_normal(
        (64, 512)).astype(np.float32)))
    acc = codes @ tlin.unpack_int4(w["hi"]).numpy().astype(np.int64).T
    rowsum = codes.sum(-1, keepdims=True)
    got = torch.from_numpy(_nib_hi_epilogue(acc, rowsum, sx, w["s"].numpy())).to(dtype)
    assert torch.equal(got, tlin.nib_hi_dot_plain(x, w["hi"], w["s"]))


def test_an_fma_in_the_hi_epilogue_differs_where_row_sums_are_large():
    """Rows of codes near 127 at K = 11008 (x integer with a 127 in each row,
    so s_x = 1 and the codes are x) against hi codes of mean ~2.5: |rowsum| ·
    15 passes 2²⁴, so f32(rowsum) · 7.5 rounds (odd row sums), and the sums
    reach 2²⁵, where the one-rounding FMA form lands on other bits for some
    outputs; the step-by-step form stays equal to the plain version."""
    K, M, N = 11008, 64, 32
    r = np.random.default_rng(34)
    codes = r.integers(96, 128, size=(M, K))
    codes[:, 0] = 127
    x = torch.from_numpy(codes.astype(np.float32))
    q8 = r.integers(16, 80, size=(N, K))
    q8[:, 0] = 127
    w = tlin.quantize_weight_nibble(torch.from_numpy(q8.astype(np.float32)))
    assert np.array_equal(tlin.nibble_reconstruct_q8(w).numpy(), q8)
    sx = np.ones((M, 1), dtype=np.float32)
    rowsum = codes.sum(-1, keepdims=True)
    assert np.abs(rowsum).max() * 15 > 2 ** 24
    acc = codes @ tlin.unpack_int4(w["hi"]).numpy().astype(np.int64).T
    want = tlin.nib_hi_dot_plain(x, w["hi"], w["s"])
    assert torch.equal(torch.from_numpy(_nib_hi_epilogue(acc, rowsum, sx, w["s"].numpy())), want)
    fma = torch.from_numpy(_nib_hi_epilogue(acc, rowsum, sx, w["s"].numpy(), fma=True))
    assert not torch.equal(fma, want)


def test_int32_bounds_at_the_largest_k():
    """|Σ x8 · q8| <= 127² · K and |Σ x8 · hi| <= 127 · 8 · K stay below 2³¹
    at the largest K of the main paths (11008) and up to K = 133,000; the
    row sums below 2²⁴, so f32(rowsum) is exact."""
    K = 11008
    assert 127 * 127 * K < 2 ** 31 and 127 * 127 * 133_000 < 2 ** 31
    assert 127 * 8 * K < 2 ** 31 and 127 * K < 2 ** 24
    codes = np.full((1, K), 127, dtype=np.int64)
    assert int((codes @ np.full((K, 1), 127)).max()) == 127 * 127 * K
    assert int((codes @ np.full((K, 1), -8)).min()) == -127 * 8 * K
