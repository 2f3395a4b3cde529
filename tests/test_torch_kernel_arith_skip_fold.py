"""The arithmetic of the blockwise flash kernel's tile skip and of the w4a8
GEMM's group fold, rehearsed on the CPU.

The CUDA kernels run only on the card; what they assume is checked here in
plain torch and numpy:

- flash_blockwise (``ops/csrc/flash_blockwise.cu``) skips, under the causal
  mask, a 64-key tile that lies above the diagonal of every row of its
  64 query rows, past the batch row's last valid key, or whose keys are all
  invalid, but only where every one of those rows has seen a valid key
  before the tile (decided from the mask: the first valid key at or below
  the first row's diagonal). A row that has seen one gets
  p = exp(NEG_INF - m) = 0 and a correction of 1 from such a tile, so the
  skip leaves its bits as they are; a row that has seen none counts the
  tile's masked keys at p = 1 (the mean of V over Tk), so without that
  condition the skip would change it. A tile-by-tile fp32 emulation of the
  kernel's online softmax, with and without the skip, shows both.
- w4a8_matmul (``ops/csrc/w4a8_matmul.cu``) converts each group's exact int32
  sum to fp32 with a magic number and folds it as
  ``acc = fadd_rn(acc, fmul_rn(f32(p), s))`` in group order: emulated in
  numpy float32 it must equal `linear.w4a8_matmul_plain` bit for bit, while
  an FMA-contracted fold or the groups summed out of order must not. Both
  its routes widen the packed codes in registers (8 consecutive codes of a
  row a thread) and take the activation codes in the permuted order of the
  pre-pass (``int8_mma.cuh`` stored_offset), which the fragments pair back
  with the right codes; its decode route splits the groups across warps in
  waves, each warp writing its group's terms t = f32(p) · s, folded into the
  outputs in group order. A wave spans no more chunks than the decode ring
  has stages (or is one warp walking its own chunks): played out on mbarrier
  parity semantics, no warp then reads a stage before its chunk lands, while
  eight groups of 256 a wave do.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import linear as tlin

NEG_INF = np.float32(tattn.NEG_INF)
TILE, ROWS = 64, 64


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _blockwise_tiles(q, k, v, valid, offset=0, causal=True, skip=False, guard=True):
    """flash_blockwise.cu's tensor-core kernel, one 64-row query block and one
    64-key tile at a time, in fp32: s = (q . k) * scale, masked keys NEG_INF
    and keys past Tk -inf, an online max / sum rescale, p = hi + lo through
    PV, out = o / max(l, 1e-30) in q's dtype. With `skip`, the kernel's rule,
    decided from the mask alone: under the causal mask, when (with `guard`)
    the batch row's first valid key lies at or below the diagonal of the
    block's first row, so that every row of the block has seen a valid key
    before any tile it skips, a tile wholly above the diagonal of the block's
    last row or past the last valid key is skipped, and so is a tile with no
    valid key after the first valid one."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    scale = tattn._scale(Dh)
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    out = torch.zeros((B, H, Tq, Dh))
    n_tiles = -(-Tk // TILE)
    for b in range(B):
        keys_ok = torch.nonzero(valid[b] > 0).flatten().tolist()
        first, last = (keys_ok[0], keys_ok[-1]) if keys_ok else (None, -1)
        for q0 in range(0, Tq, ROWS):
            rows = torch.arange(q0, q0 + ROWS)
            qb = torch.zeros((H, ROWS, Dh))
            qb[:, :min(ROWS, Tq - q0)] = qh[b, :, q0:q0 + ROWS]
            q_last = min(q0 + ROWS, Tq) - 1
            m = torch.full((H, ROWS, 1), float(NEG_INF))
            l = torch.zeros((H, ROWS, 1))
            o = torch.zeros((H, ROWS, Dh))
            for j in range(n_tiles):
                k0 = j * TILE
                keys = torch.arange(k0, k0 + TILE)
                ok = torch.zeros(TILE, dtype=torch.bool)
                ok[:min(TILE, Tk - k0)] = valid[b, k0:k0 + TILE] > 0
                seen = first is not None and first <= q0 + offset
                after_first = k0 > (first if first is not None else -1)
                if skip and causal and (seen or not guard) and (
                        k0 > min(q_last + offset, last) or (after_first and not bool(ok.any()))):
                    continue
                kt = torch.zeros((H, TILE, Dh))
                vt = torch.zeros((H, TILE, Dh))
                kt[:, :min(TILE, Tk - k0)] = kh[b, :, k0:k0 + TILE]
                vt[:, :min(TILE, Tk - k0)] = vh[b, :, k0:k0 + TILE]
                s = torch.matmul(qb, kt.transpose(-1, -2)) * scale
                mask = ok[None, :].expand(ROWS, TILE)
                if causal:
                    mask = mask & (keys[None, :] <= rows[:, None] + offset)
                s = torch.where(mask[None], s, torch.tensor(float(NEG_INF)))
                s[..., max(0, Tk - k0):] = -float("inf")
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                corr = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * corr + p.sum(dim=-1, keepdim=True)
                hi = _bf16(p)
                o = o * corr + torch.matmul(hi, vt) + torch.matmul(_bf16(p - hi), vt)
                m = m_new
            n = min(ROWS, Tq - q0)
            out[b, :, q0:q0 + n] = (o / torch.clamp(l, min=1e-30))[:, :n]
    return out.to(q.dtype).permute(0, 2, 1, 3)


def _attn_inputs(seed, B, Tq, Tk, H=2, Dh=64):
    r = np.random.default_rng(seed)
    return [torch.from_numpy(r.normal(size=(B, t, H, Dh)).astype(np.float32)).bfloat16()
            for t in (Tq, Tk, Tk)]


CASES = {
    # name: (Tq, Tk, offset, valid-mask edit)
    "causal": (192, 192, 0, None),
    "ragged_tk_offset": (70, 300, 230, None),
    "invalid_tile_in_the_middle": (256, 256, 0, (128, 192)),
    "right_padded_rows": (200, 200, 0, "pad"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tile_skip_leaves_every_row_bit_equal(case):
    """With the guard, skipping changes no bit of any row; and the emulation
    meets the chip check (compare_blockwise against the plain version)."""
    Tq, Tk, offset, edit = CASES[case]
    q, k, v = _attn_inputs(1, 2, Tq, Tk)
    valid = torch.ones((2, Tk), dtype=torch.int32)
    if edit == "pad":
        valid[0, Tk - 70:] = 0
    elif edit is not None:
        valid[:, edit[0]:edit[1]] = 0
    full = _blockwise_tiles(q, k, v, valid, offset)
    skipped = _blockwise_tiles(q, k, v, valid, offset, skip=True)
    assert torch.equal(skipped, full)
    tattn.compare_blockwise(full, tattn.flash_attention_blockwise_plain(q, k, v, valid, offset))


def test_the_guard_keeps_fully_masked_rows_and_the_skip_without_it_does_not():
    """Rows 0..69 see no valid key (offset 0): with the guard their blocks
    visit every tile and they keep the mean of V over Tk; skipping without it
    averages rows 0..63 over the first tile only (negative control)."""
    Tq = Tk = 192
    q, k, v = _attn_inputs(2, 1, Tq, Tk)
    valid = torch.ones((1, Tk), dtype=torch.int32)
    valid[0, :70] = 0
    full = _blockwise_tiles(q, k, v, valid)
    assert torch.equal(_blockwise_tiles(q, k, v, valid, skip=True), full)
    mean_v = v[0].float().mean(0).bfloat16()
    tattn.compare_blockwise(full[0, :70], mean_v[None].expand(70, -1, -1))
    unguarded = _blockwise_tiles(q, k, v, valid, skip=True, guard=False)
    assert not torch.equal(unguarded[0, :64], full[0, :64])
    assert torch.equal(unguarded[0, 70:], full[0, 70:])   # rows that saw a valid key


def test_no_skip_without_the_causal_mask():
    """causal=False: the rule skips nothing, even a tile of invalid keys."""
    q, k, v = _attn_inputs(3, 1, 64, 256)
    valid = torch.ones((1, 256), dtype=torch.int32)
    valid[0, 64:128] = 0
    a = _blockwise_tiles(q, k, v, valid, causal=False)
    assert torch.equal(_blockwise_tiles(q, k, v, valid, causal=False, skip=True), a)
    tattn.compare_blockwise(a, tattn.flash_attention_blockwise_plain(q, k, v, valid,
                                                                      causal=False))


# --- the w4a8 group fold ----------------------------------------------------------


def _magic_f32(p: np.ndarray) -> np.ndarray:
    """__int_as_float(p + 0x4B400000) - 12582912.f, in float32."""
    bits = (p.astype(np.int64) + 0x4B400000).astype(np.uint32)
    return bits.view(np.float32) - np.float32(12582912.0)


def test_magic_conversion_is_exact_below_2_to_the_22():
    """|p| <= 127 * 8 * 4096 = 4,161,536 (the launcher caps gsz at 4096) is
    below 2^22, where the magic-number conversion is exact."""
    bound = 127 * 8 * 4096
    assert bound < 2 ** 22
    r = np.random.default_rng(0)
    p = np.concatenate([np.arange(-70000, 70000), r.integers(-bound, bound + 1, 200000),
                        np.array([bound, -bound, 2 ** 22 - 1, -2 ** 22])]).astype(np.int32)
    assert np.array_equal(_magic_f32(p), p.astype(np.float32))
    assert _magic_f32(np.array([2 ** 23], dtype=np.int32))[0] != np.float32(2 ** 23)


def _fold_operands(seed, dtype, M=8, K=1024, N=256):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(r.normal(size=(M, K)).astype(np.float32)).to(dtype)
    w = tlin.quantize_weight_int4(torch.from_numpy(r.normal(size=(N, K)).astype(np.float32)))
    codes, sx = tlin.quantize_rows(x.float())
    G = w["q"].shape[0]
    wc = tlin.unpack_int4(w["q"]).numpy().astype(np.int64)                 # [G, N, gsz]
    a = codes.numpy().astype(np.int64).reshape(M, G, -1)
    p = np.einsum("mgk,gnk->gmn", a, wc).astype(np.int32)                  # exact sums
    return x, w, p, w["s"].numpy().astype(np.float32), sx.numpy().astype(np.float32)


def _fold(p, s, sx, dtype, order=None, fma=False):
    acc = np.zeros(p.shape[1:], dtype=np.float32)
    for g in (order if order is not None else range(p.shape[0])):
        f = _magic_f32(p[g])
        if fma:   # one rounding: the exact product plus acc, rounded once
            acc = (f.astype(np.float64) * s[:, g].astype(np.float64) + acc).astype(np.float32)
        else:
            acc = acc + f * s[:, g]            # float32: each operation rounds
    return torch.from_numpy(acc * sx.reshape(-1, 1)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_fold_equals_the_plain_version_bit_for_bit(seed, dtype):
    x, w, p, s, sx = _fold_operands(seed, dtype)
    want = tlin.w4a8_matmul_plain(x, w["q"], w["s"])
    assert torch.equal(_fold(p, s, sx, dtype), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_an_fma_fold_or_another_group_order_is_refused(seed):
    """fp32 x (an fp32 output: a bf16 output rounds most of the fold's last
    bits away, so the chip check's bf16 shapes would pass a faulty fold on
    some elements only)."""
    x, w, p, s, sx = _fold_operands(seed, torch.float32)
    want = tlin.w4a8_matmul_plain(x, w["q"], w["s"])
    assert not torch.equal(_fold(p, s, sx, torch.float32, fma=True), want)
    reverse = range(p.shape[0] - 1, -1, -1)
    assert not torch.equal(_fold(p, s, sx, torch.float32, order=reverse), want)


def _decode_waves(p, s, sx, dtype, warps=8, wave_order=None):
    """The decode route's fold: waves of `warps` groups, each group's terms
    t = fmul(f32(p), s[:, g]) written by its own warp, then folded into the
    outputs as acc = fadd(acc, t) in group order (`wave_order`: the order of
    the wave's terms, for a negative control)."""
    G = p.shape[0]
    acc = np.zeros(p.shape[1:], dtype=np.float32)
    for g0 in range(0, G, warps):
        groups = list(range(g0, min(G, g0 + warps)))
        terms = {g: _magic_f32(p[g]) * s[:, g] for g in groups}
        for g in (wave_order(groups) if wave_order else groups):
            acc = acc + terms[g]
    return torch.from_numpy(acc * sx.reshape(-1, 1)).to(dtype)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_terms_folded_in_group_order_equal_the_plain_version(seed):
    """K = 1408: 11 groups, a full wave of 8 and a partial one of 3."""
    for dtype in (torch.bfloat16, torch.float32):
        x, w, p, s, sx = _fold_operands(seed, dtype, K=1408)
        want = tlin.w4a8_matmul_plain(x, w["q"], w["s"])
        assert torch.equal(_decode_waves(p, s, sx, dtype), want)
    # negative control: the wave's terms folded as its warps finish (here last first)
    got = _decode_waves(p, s, sx, torch.float32, wave_order=lambda gs: gs[::-1])
    assert not torch.equal(got, want)


def _widen(words: np.ndarray) -> np.ndarray:
    """ops/csrc/int8_mma.cuh::widen on uint32 words of 8 packed codes: the two
    words lo (codes 0..3) and hi (codes 4..7) as 8 int8 codes in k order."""
    w = words.astype(np.uint32)
    a, b = w & 0x0F0F0F0F, (w >> 4) & 0x0F0F0F0F
    out = []
    for sel in ((0, 4, 1, 5), (2, 6, 3, 7)):   # __byte_perm(a, b, 0x5140 / 0x7362)
        for src in sel:
            byte = ((a if src < 4 else b) >> (8 * (src % 4))) & 0xFF
            out.append((((byte ^ 8) - 8) & 0xFF).astype(np.uint8).view(np.int8))   # __vsub4
    return np.stack(out, axis=-1)


def test_widening_is_exact_for_every_code_and_keeps_the_packed_order():
    """Every byte value at every position widens to its two codes; words of
    `linear.pack_int4` codes widen back to the codes in order (the order both
    routes' fragments take, matched by the pre-pass's permuted activations)."""
    v = np.arange(256, dtype=np.uint32)
    for byte in range(4):
        got = _widen(v << (8 * byte))[:, 2 * byte:2 * byte + 2].astype(np.int32)
        want = np.stack([((v & 15) ^ 8).astype(np.int32) - 8,
                         (((v >> 4) & 15) ^ 8).astype(np.int32) - 8], axis=-1)
        assert np.array_equal(got, want)
    r = np.random.default_rng(5)
    codes = torch.from_numpy(r.integers(-8, 8, size=(3, 16, 128), dtype=np.int8))
    packed = tlin.pack_int4(codes).numpy()
    words = packed.reshape(3, 16, 16, 4).astype(np.uint32)
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    assert np.array_equal(_widen(words).reshape(3, 16, 128), codes.numpy())


def _stored_offset(k: int) -> int:
    """int8_mma.cuh::stored_offset (k a multiple of 4)."""
    c4 = (k & 31) >> 2
    return (k & ~31) + 4 * ((4 + (c4 >> 1)) if c4 & 1 else (c4 >> 1))


def test_fragments_pair_the_permuted_codes_with_their_weights():
    """The m16n8k32 fragment layout (mma.sync, and wgmma's register operand):
    thread t4's registers take k at 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4
    + 3 of a 32-deep step, on one operand the stored positions of the
    activation codes, on the other the widened weight codes 8 t4 .. 8 t4 + 3
    and 8 t4 + 4 .. 8 t4 + 7 of one packed word; with the pre-pass's
    permutation each activation code meets its own weight code, so the dot is
    the natural one."""
    r = np.random.default_rng(6)
    act = r.integers(-127, 128, size=32)
    wcodes = r.integers(-8, 8, size=32)
    stored = np.zeros(32, dtype=np.int64)
    for k in range(0, 32, 4):
        stored[_stored_offset(k):_stored_offset(k) + 4] = act[k:k + 4]
    dot = 0
    for t4 in range(4):
        a_regs = np.concatenate([stored[4 * t4:4 * t4 + 4], stored[16 + 4 * t4:20 + 4 * t4]])
        b_regs = wcodes[8 * t4:8 * t4 + 8]    # lo word: codes 8 t4.., hi word: 8 t4 + 4..
        dot += int((a_regs * b_regs).sum())
    assert dot == int((act * wcodes).sum())


def _decode_ring_constants():
    src = (Path(tlin.__file__).parent / "csrc" / "w4a8_matmul.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kDStages", "kDWarps"))


def _decode_wave(cpg: int, stages: int, warps: int) -> int:
    """Groups per wave of the decode route (w4a8_matmul.cu, W): the wave's
    chunks fit in the ring, or one warp walks its own chunks in order."""
    return min(warps, max(1, stages // cpg))


def _play_decode_ring(K, gsz, wave, seed, stages, warps):
    """Play the decode route's ring on mbarrier semantics, one step of one
    actor at a time in a random order: the producer (wait on the slot's
    "empty" parity, issue the chunk's load), the loads (land in any order,
    completing the slot's "full" phase), and the consumer warps (per wave,
    wait on "full" with the chunk's parity, read the slot, arrive on "empty",
    then the wave's barrier). A wait on parity P passes once the barrier's
    phase of parity P has completed, so it passes at once on a barrier that
    has completed no phase yet for P = 1. Returns the faults: each read of a
    slot that did not hold the chunk the warp waited for, and "deadlock" if
    every actor came to wait on what no other could complete."""
    rng = np.random.default_rng(seed)
    KC, CPG, G = K // 128, gsz // 128, K // gsz
    full, empty, held = [0] * stages, [0] * stages, [None] * stages
    in_flight, arrived, wrong = [], {}, []

    def passes(bar, slot, parity):
        return bar[slot] % 2 != parity

    def producer():
        for c in range(KC):
            slot = c % stages
            yield lambda: passes(empty, slot, ((c // stages) & 1) ^ 1)
            in_flight.append(c)

    def consumer(w):
        for v, g0 in enumerate(range(0, G, wave)):
            g = g0 + w
            if w < wave and g < G:
                for c in range(g * CPG, (g + 1) * CPG):
                    slot = c % stages
                    yield lambda: passes(full, slot, (c // stages) & 1)
                    if held[slot] != c:
                        wrong.append((c, held[slot]))
                    empty[slot] += 1
            arrived[v] = arrived.get(v, 0) + 1
            yield lambda: arrived[v] == warps

    actors = {name: [gen, next(gen)] for name, gen in
              [("producer", producer()), *((w, consumer(w)) for w in range(warps))]}
    while actors or in_flight:
        ready = [name for name, (_, cond) in actors.items() if cond()]
        choices = ready + (["land"] if in_flight else [])
        if not choices:
            return [*wrong, "deadlock"]
        pick = choices[rng.integers(len(choices))]
        if pick == "land":
            c = in_flight.pop(rng.integers(len(in_flight)))
            held[c % stages] = c
            full[c % stages] += 1
            continue
        try:
            actors[pick][1] = next(actors[pick][0])
        except StopIteration:
            del actors[pick]
    return wrong


@pytest.mark.parametrize("gsz", [128, 256, 384, 512, 1024, 2048, 4096])
def test_decode_waves_never_read_a_stage_before_its_chunk_lands(gsz):
    stages, warps = _decode_ring_constants()
    K = gsz * max(2, 4096 // gsz)
    wave = _decode_wave(gsz // 128, stages, warps)
    for seed in range(20):
        assert _play_decode_ring(K, gsz, wave, seed, stages, warps) == []


def test_a_wave_wider_than_the_ring_reads_a_stage_early():
    """Negative control: eight groups of 256 per wave span 16 chunks of a
    12-stage ring, so a warp's parity wait on its chunk 12 passes before
    chunk 0 has landed in the slot."""
    stages, warps = _decode_ring_constants()
    assert stages < warps * 2
    wrong = [_play_decode_ring(2048, 256, warps, seed, stages, warps) for seed in range(20)]
    assert any(wrong)
