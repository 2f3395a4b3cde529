"""The arithmetic of ``w4a8_grouped``'s cluster kernel, rehearsed on the CPU.

``ops/csrc/w4a8_grouped.cu`` runs only on the card. It gives each 32 x 32
output tile to a cluster of two CTAs: rank r takes the chunks of fold classes
4r .. 4r + 3 (chunk c is in class c % 8), warp w of a CTA folds class
4r + w % 4 over the tile's column half w / 4, every class's fp32 sums go to a
slot of rank 1's shared memory (rank 0's by distributed shared memory), where
rank 1 adds the 8 in class order, and a persistent grid of clusters walks the
tiles, each class's stages counted across tiles.
What it assumes is checked here in numpy, with inputs made by numpy from a
seed:

- the tile split and fold order, played lane by lane (each lane's
  accumulator elements, the fragments' k slots against the pre-pass's
  ``stored_offset`` order, each segment's exact int32 sum folded in float32
  at the segment ends the kernel takes, the 8 classes added in class order),
  equal ``linear.w4a8_grouped_plain`` bit for bit at group sizes
  32, 64, 128 and 256, M = 1, 24 and 32, N not a multiple of the tile width;
  adding the classes in rank-major order with each rank's sum formed apart
  (the negative control) is not;
- column independence: a column's output is the same in a leaf of any width
  and at any tile, rank split and number of clusters;
- the rings: the producer's stages and parities (class c % 4 of the rank, its
  (i · nc + c / 8)-th chunk; the first tile's first stages issued without a
  wait) and the consumers' agree across tiles, every chunk is read from its
  own stage exactly once under random interleavings of the producer, the
  eight warps (two a class) and the two ranks'
  handshake (rank 1 reads rank 0's sums of the same tile; rank 0 writes the
  next tile's only after rank 1 has read); without the release barrier rank
  0 overwrites a tile's sums before rank 1 reads them (the negative control).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import linear as tlin

SRC = (Path(tlin.__file__).parent / "csrc" / "w4a8_grouped.cu").read_text()
BM, BN, CHUNK, CLASSES, RANKS, SLOTS = (
    int(re.search(rf"constexpr int {n} = (\d+);", SRC).group(1))
    for n in ("kBM", "kBN", "kChunk", "kClasses", "kRanks", "kSlots"))
LOCAL = CLASSES // RANKS
F32 = np.float32


def stored_offset(k: np.ndarray) -> np.ndarray:
    """int8_mma.cuh's stored_offset for k a multiple of 4: where the pre-pass
    stores the activation codes k .. k + 3 of each 32-code block."""
    c4 = (k & 31) >> 2
    return (k & ~31) + 4 * np.where(c4 & 1, 4 + (c4 >> 1), c4 >> 1)


def stored_codes(codes: np.ndarray) -> np.ndarray:
    """The pre-pass's [M, K] row in stored_offset order."""
    out = np.zeros_like(codes)
    for k in range(0, codes.shape[1], 4):
        o = int(stored_offset(np.array(k)))
        out[:, o:o + 4] = codes[:, k:k + 4]
    return out


def fragment_codes(w: np.ndarray) -> np.ndarray:
    """The int4 codes [N, 32] of one k32 step as mma.sync's B fragment slots:
    lane (g8, t4) widens 8 consecutive codes 8 t4 .. 8 t4 + 7 of channel g8
    into b0 (slots 4 t4 .. 4 t4 + 3) and b1 (slots 16 + 4 t4 .. + 3)."""
    out = np.zeros_like(w)
    for t4 in range(4):
        out[:, 4 * t4:4 * t4 + 4] = w[:, 8 * t4:8 * t4 + 4]
        out[:, 16 + 4 * t4:16 + 4 * t4 + 4] = w[:, 8 * t4 + 4:8 * t4 + 8]
    return out


def lane_elements(half: int):
    """A warp's accumulator elements, lane by lane: (row, col) index arrays of
    the tile over (lane, mt, j, e) (m16 tile mt, this half's n8 tile j at tile
    column (2 half + j) · 8, C fragment element e at row g8 + 8 (e >> 1) and
    column 2 t4 + (e & 1)); a bijection onto the half's 32 x 16 elements."""
    rows, cols = [], []
    for lane in range(32):
        g8, t4 = lane >> 2, lane & 3
        for mt in range(2):
            for j in range(2):
                for e in range(4):
                    rows.append(mt * 16 + g8 + 8 * (e >> 1))
                    cols.append((2 * half + j) * 8 + 2 * t4 + (e & 1))
    return np.array(rows), np.array(cols)


def warp_fold(stored, w, s, p, half, K, gsz):
    """One warp's fp32 sums, lane by lane: class p's chunks in order, each
    k32 step's products over the fragment slots (stored activation codes
    against the widened B slots), a fold at each segment end (one group a
    chunk: after the chunk; else where (k + 32) % gsz == 0 or at the chunk's
    last step), acc + f32(int32) · s in float32."""
    KC = -(-K // CHUNK)
    one_group = gsz % CHUNK == 0
    rows, cols = lane_elements(half)
    assert len(set(zip(rows.tolist(), cols.tolist()))) == 32 * 16
    acc = np.zeros(rows.shape, dtype=np.int64)
    facc = np.zeros(rows.shape, dtype=F32)

    def fold(g):
        nonlocal acc, facc
        facc = (facc + (acc.astype(F32) * s[cols, g]).astype(F32)).astype(F32)
        acc = np.zeros_like(acc)

    for c in range(p, KC, CLASSES):
        steps = min(4, (K - c * CHUNK) // 32)
        for kk in range(steps):
            k = c * CHUNK + 32 * kk
            prod = stored[:, k:k + 32] @ fragment_codes(w[:, k:k + 32]).T   # [32 rows][32 cols]
            acc += prod[rows, cols]
            if not one_group and ((k + 32) % gsz == 0 or kk == steps - 1):
                fold(k // gsz)
        if one_group:
            fold(c * CHUNK // gsz)
    tile = np.zeros((BM, BN), dtype=F32)
    tile[rows, cols] = facc
    return tile[:, half * (BN // 2):(half + 1) * (BN // 2)]


def kernel_grouped(x: np.ndarray, codes: np.ndarray, s: np.ndarray, nclusters: int,
                   rank_major: bool = False) -> np.ndarray:
    """The kernel's function played tile by tile: x [M, K] float32, codes
    [G, N, gsz] int, s [N, G] -> out [M, N] float32 (before the cast)."""
    M, K = x.shape
    G, N, gsz = codes.shape
    xq, sx = (t.numpy() for t in tlin.quantize_rows(torch.from_numpy(x)))
    w = codes.transpose(1, 0, 2).reshape(N, K)
    nt = -(-N // BN)
    tiles = nt * -(-M // BM)
    out = np.zeros((M, N), dtype=F32)
    for ci in range(nclusters):
        for t in range(ci, tiles, nclusters):
            n0, m0 = (t % nt) * BN, (t // nt) * BM
            st = np.zeros((BM, K), dtype=np.int64)                 # rows past M: zero-filled
            rows = min(BM, M - m0)
            st[:rows] = stored_codes(xq[m0:m0 + rows].astype(np.int64))
            wt = np.zeros((BN, K), dtype=np.int64)                 # columns past N: zero-filled
            st_s = np.zeros((BN, G), dtype=F32)
            cols = min(BN, N - n0)
            wt[:cols], st_s[:cols] = w[n0:n0 + cols], s[n0:n0 + cols]
            parts = {(p, h): warp_fold(st, wt, st_s, p, h, K, gsz)
                     for p in range(CLASSES) for h in range(2)}
            sums = [np.concatenate([parts[(p, 0)], parts[(p, 1)]], axis=1) for p in range(CLASSES)]
            if rank_major:   # each rank's classes summed apart, then the two added
                r0, r1 = sums[0], sums[LOCAL]
                for p in range(1, LOCAL):
                    r0, r1 = F32(r0 + sums[p]), F32(r1 + sums[LOCAL + p])
                total = F32(r0 + r1)
            else:            # rank 1 adds the 8 classes' slots in class order
                total = sums[0]
                for p in range(1, CLASSES):
                    total = (total + sums[p]).astype(F32)
            tile = (total[:rows] * sx[m0:m0 + rows].reshape(rows, 1)).astype(F32)
            out[m0:m0 + rows, n0:n0 + cols] = tile[:, :cols]
    return out


def _leaf(seed, M, N, G, gsz, scale_spread=1.0):
    r = np.random.default_rng(seed)
    x = r.normal(size=(M, G * gsz)).astype(F32)
    codes = r.integers(-8, 8, (G, N, gsz))
    s = (r.random((N, G)) * 2e-3 * scale_spread + 2e-3).astype(F32)
    return x, codes, s


def _plain(x, codes, s):
    return tlin.w4a8_grouped_plain(torch.from_numpy(x), tlin.pack_int4(
        torch.from_numpy(codes.astype(np.int8))), torch.from_numpy(s)).numpy()


@pytest.mark.parametrize("gsz", [32, 64, 128, 256])
@pytest.mark.parametrize("M,N", [(1, 40), (24, 72), (32, 8)])
def test_tile_split_and_fold_order_equal_the_plain_version(gsz, M, N):
    """The cluster kernel played lane by lane equals w4a8_grouped_plain bit
    for bit (fp32 x, so the cast is the identity), K of 9 groups: the chunks
    of each class, the segment ends, the chain."""
    x, codes, s = _leaf(gsz + M + N, M, N, 9 if gsz < 256 else 5, gsz, scale_spread=50.0)
    got = kernel_grouped(x, codes, s, nclusters=2)
    assert np.array_equal(got, _plain(x, codes, s))


def test_rank_major_sums_are_another_function():
    """The negative control: each rank's four classes summed apart and the two
    ranks' sums added (a split-K combine) is not the stated order."""
    x, codes, s = _leaf(5, 24, 32, 16, 64, scale_spread=1e4)
    want = _plain(x, codes, s)
    assert np.array_equal(kernel_grouped(x, codes, s, 1), want)
    assert not np.array_equal(kernel_grouped(x, codes, s, 1, rank_major=True), want)


def test_columns_do_not_depend_on_the_tile_or_the_grid():
    """A column's output is the same in a leaf of any width (its tile and its
    place in the tile move) and on any number of clusters."""
    x, codes, s = _leaf(6, 24, 88, 6, 128)
    whole = kernel_grouped(x, codes, s, nclusters=3)
    for a, b, nc in ((8, 48, 1), (40, 88, 2), (0, 8, 5)):
        part = kernel_grouped(x, np.ascontiguousarray(codes[:, a:b]), s[a:b], nclusters=nc)
        assert np.array_equal(whole[:, a:b], part)


# --- the rings and the chain's handshake, on mbarrier parity semantics ----------------


class Barrier:
    """An mbarrier: `count` arrivals complete a phase; a wait on parity P
    passes once the phase of parity P has completed, i.e. while the current
    phase's parity is not P (a fresh barrier passes a wait on parity 1)."""

    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self):
        self.pending -= 1
        if self.pending == 0:
            self.phase, self.pending = self.phase + 1, self.count

    def passes(self, parity):
        return (self.phase & 1) != parity


class NamedBarrier:
    """bar.sync over `count` warps: a warp passes once every warp of its
    generation has arrived."""

    def __init__(self, count):
        self.count, self.arrived, self.gen = count, 0, 0

    def arrive(self):
        self.arrived += 1
        gen = self.gen
        if self.arrived == self.count:
            self.arrived, self.gen = 0, self.gen + 1
        return gen

    def passed(self, gen):
        return self.gen > gen


def simulate(K, tiles_per_cluster, seed, release_wait=True, max_steps=4 * 10 ** 5):
    """Both ranks of one cluster over its tiles: each rank's producer thread
    (the first tile's first SLOTS chunks of each class without a wait, then
    every other chunk in order once its stage is free) and eight consumer
    warps as generators stepped in a random order. Returns (stage reads as
    (rank, tile, chunk, what the stage held), rank 1's reads of rank 0's
    class slots as (tile, what the slot held))."""
    rng = np.random.default_rng(seed)
    KC = -(-K // CHUNK)
    warps = 2 * LOCAL
    reads, slot_reads = [], []
    full = {r: [Barrier(1) for _ in range(LOCAL * SLOTS)] for r in range(RANKS)}
    empty = {r: [Barrier(2) for _ in range(LOCAL * SLOTS)] for r in range(RANKS)}
    stage = {r: [None] * (LOCAL * SLOTS) for r in range(RANKS)}
    xfull, xfree = Barrier(warps), Barrier(warps)   # one arrival a warp
    bar1 = NamedBarrier(warps)                      # rank 1's named barrier
    part = [None] * warps                           # rank 1's slots of rank 0's sums

    def producer(rank):
        for i in range(tiles_per_cluster):
            for c in range(KC):
                if (c % CLASSES) // LOCAL != rank:
                    continue
                p = c % CLASSES
                nc = (KC - 1 - p) // CLASSES + 1
                u = i * nc + c // CLASSES
                slot = (c % LOCAL) * SLOTS + u % SLOTS
                if i > 0 or c // CLASSES >= SLOTS:   # the first round's stages start free
                    while not empty[rank][slot].passes(((u // SLOTS) & 1) ^ 1):
                        yield
                stage[rank][slot] = (i, c)
                full[rank][slot].arrive()   # the TMA's completion
                yield

    def consumer(rank, warp):
        l = warp % LOCAL
        p = LOCAL * rank + l
        nc = (KC - 1 - p) // CLASSES + 1 if KC > p else 0
        for i in range(tiles_per_cluster):
            for rr in range(nc):
                c, u = p + CLASSES * rr, i * nc + rr
                slot = l * SLOTS + u % SLOTS
                while not full[rank][slot].passes((u // SLOTS) & 1):
                    yield
                reads.append((rank, i, c, stage[rank][slot]))
                yield
                empty[rank][slot].arrive()
                yield
            if rank == 0:                       # this class's sums into rank 1's slot
                if release_wait and i > 0:
                    while not xfree.passes((i - 1) & 1):
                        yield
                part[warp] = i
                yield
                xfull.arrive()
            else:                               # rank 1: its own in, then rank 0's, then read
                gen = bar1.arrive()
                while not bar1.passed(gen):
                    yield
                while not xfull.passes(i & 1):
                    yield
                yield                           # the loads issue after the wait
                slot_reads.extend((i, part[w]) for w in range(warps))
                gen = bar1.arrive()
                while not bar1.passed(gen):
                    yield
                if i + 1 < tiles_per_cluster:
                    xfree.arrive()
            yield

    actors = [producer(r) for r in range(RANKS)] + [consumer(r, w) for r in range(RANKS)
                                                    for w in range(warps)]
    steps = 0
    while actors:
        k = int(rng.integers(len(actors)))
        try:
            next(actors[k])
        except StopIteration:
            actors.pop(k)
        steps += 1
        assert steps < max_steps, "deadlock"
    return reads, slot_reads


@pytest.mark.parametrize("K,tiles", [(4096, 3), (11008, 2), (128 * 5, 4), (96, 3)])
def test_rings_and_chain_over_several_tiles(K, tiles):
    """Every chunk of every tile is read once, from a stage that holds it; rank
    1 reads each tile's sums from rank 0 of the same tile."""
    KC = -(-K // CHUNK)
    for seed in range(6):
        reads, slot_reads = simulate(K, tiles, seed)
        for rank, i, c, held in reads:
            assert held == (i, c)
        got = sorted((i, c) for rank, i, c, _ in reads)
        assert got == sorted(2 * [(i, c) for i in range(tiles) for c in range(KC)])   # 2 warps
        assert all(i == held for i, held in slot_reads)
        assert len(slot_reads) == tiles * (2 * LOCAL) ** 2


def test_without_the_release_rank_0_overwrites_the_sums():
    """The negative control: rank 0 writing the next tile's sums without waiting
    for rank 1's release; some interleaving has rank 1 read a later tile's (or
    wait on a phase that has aliased, for ever)."""
    bad = 0
    for seed in range(40):
        try:
            _, slot_reads = simulate(128 * 5, 4, seed, release_wait=False, max_steps=3 * 10 ** 4)
        except AssertionError:     # or the phases alias and rank 1 waits for ever
            bad += 1
            continue
        bad += any(i != held for i, held in slot_reads)
        if bad:
            break
    assert bad > 0
