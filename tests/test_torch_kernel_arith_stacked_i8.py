"""The arithmetic of row 5's ring route, rehearsed on the CPU.

``ops/csrc/stacked_decode_i8.cu`` runs only on the card. Its ring route
streams each (batch row, kv head)'s int8 K rows, then V rows, in 16-row
chunks through each warp's ring of stages, turns the codes into fp16 operands
by byte permutes (no int -> float conversion), computes q·k and (p·vs)·V on the
tensor cores with the fp32 operands as three fp16 terms scaled by a power of
two, factors each key's scale out of its dot, reads only the slots up to the
query (``n_keys``) and splits a row's keys across a cluster by the decode
attentions' rule. What it assumes is checked here in plain torch and numpy,
with inputs made by numpy from a seed:

- the code conversion: the byte permute of ``c ^ 0x80`` under fp16's 0x64 and
  the subtraction of 1152 give every int8 value exactly, in each byte
  position and each selector the kernel uses; bf16, with 7 stored significand
  bits, cannot hold c + 128 (the negative control);
- the fragment orders: a lane's ldmatrix word of a K row stands for the mma's
  k = 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9 and q' is laid out in the same order; the
  ldmatrix.trans word of V, split by byte permutes, is the A fragment of V^T
  at dims 16U + 2g and 16U + 2g + 1; the (head, term) columns of B for n_rep
  1, 2, 4 and 8: played lane by lane, the products equal K·q and V^T·P exactly
  on integer data;
- three fp16 terms of x · 2^E, with 2^E bringing the largest |x| into
  [2^14, 2^15), hold x to 2^-39 of that largest value (a term below fp16's
  least subnormal is lost);
- the whole route (the factored key scale, the three-term splits of q' and of
  p·vs, the joint max over a cluster, the partial sums in warp and rank order)
  equals ``stacked_decode_attention_i8_plain`` to fp32 rounding at the 7B
  head dim, n_rep 1, 2, 4 and 8, cluster sizes 1, 2 and 4;
- the ``n = slot + 1`` cut: reading only the slots up to the query gives the
  plain version's output over all S whenever the later slots are masked, and
  the ``llama.decode_step_stacked_i8`` step passes exactly that;
- a row masked everywhere takes p = 1 at all S slots (the ring's and the rest
  after it): the mean of V;
- the route rule and the serving wave: ``stacked_ring_eligible`` takes bf16
  at Dh = 128 and nothing else, and 6 CTAs of the serving shape fit an SM.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import decode_attention as tdec

NEG_INF = float(np.float32(tattn.NEG_INF))
SRC = (Path(tdec.__file__).parent / "csrc" / "stacked_decode_i8.cu").read_text()
COMMON = (Path(tdec.__file__).parent / "csrc" / "decode_common.cuh").read_text()
WARP_STAGES, PITCH_PAD, RING_MAX_KEYS = (
    int(re.search(rf"constexpr int {n} = [^;]*?(\d+);", SRC).group(1))
    for n in ("kWarpStages", "kPitch", "kRingMaxKeys"))
ROWS, THREADS, MIN_BLOCKS = (
    int(re.search(rf"constexpr int {n} = (\d+);", COMMON).group(1))
    for n in ("kRows", "kThreads", "kMinBlocksPerSm"))
WARPS, DH = THREADS // 32, 128
PITCH = DH + PITCH_PAD


# --- the kernel's pieces, as numpy / torch -----------------------------------------------

def byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays (selector nibbles 0-3: x's
    bytes, 4-7: y's)."""
    x = x.astype(np.uint64)
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [np.uint64((y >> (8 * i)) & 0xFF)
                                                      for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0x7] << np.uint64(8 * i)
    return out.astype(np.uint32)


def codes_h2(wx: np.ndarray, sel: int) -> np.ndarray:
    """The kernel's codes_h2: two fp16 values (as float32, [..., 2] low half
    first) of the bytes `sel` of wx = w ^ 0x80808080."""
    h = byte_perm(wx, 0x64646464, sel)
    halves = np.stack([h & 0xFFFF, h >> 16], axis=-1).astype(np.uint16).view(np.float16)
    return (halves - np.float16(1152.0)).astype(np.float32)   # __hsub2: exact here


def words(codes: np.ndarray) -> np.ndarray:
    """int8 [..., 4k] -> little-endian uint32 words [..., k]."""
    return np.ascontiguousarray(codes.astype(np.int8)).view(np.uint32)


def pow2_for(mx: float):
    """2^E with mx · 2^E in [2^14, 2^15) for a normal mx > 0, else 1 (E clamped
    to [-113, 100]); returns (2^E, 2^-E)."""
    mx = np.float32(mx)
    e = int((mx.view(np.uint32) >> 23) & 0xFF) - 127
    E = 14 - e if (mx > 0 and e > -127) else 0
    E = max(-113, min(100, E))
    return np.float32(2.0 ** E), np.float32(2.0 ** -E)


def h_terms(x: torch.Tensor):
    """The kernel's h_term: x as three fp16 terms, t0 + t1 + t2."""
    x = x.float()
    t0 = x.half().float()
    r = x - t0
    t1 = r.half().float()
    t2 = (r - t1).half().float()
    return t0, t1, t2


def keys_per_cta(n: int, cs: int) -> int:
    return -(-(-(-n // cs)) // ROWS) * ROWS


def cluster_size(pairs: int, sms: int = 132) -> int:
    for cs in (1, 2):
        if 8 * pairs * cs >= 7 * sms:
            return cs
    return 4


def smem_bytes(n: int, cs: int, nrep: int) -> int:
    per, nt = keys_per_cta(n, cs), (3 * nrep + 7) // 8
    union = max(WARPS * WARP_STAGES * ROWS * PITCH, WARPS * 8 * nt * DH * 4)
    return (union + WARPS * WARP_STAGES * 8
            + 4 * ((2 + nrep) * per + WARPS * (2 * nrep + 1) + 2 * nrep + nrep * DH)
            + 2 * 3 * nrep * (DH + per) + per)


def ring_route(q, kq, ks, vq, vs, valid, n: int, cs: int) -> torch.Tensor:
    """The ring route of one layer ([B, S, Hkv·Dh] codes, [B, S, Hkv] scales), in
    fp32 before the cast: per (b, kv head), per CTA of the cluster, the kernel's
    scaled three-term q', the dots of exact products summed in fp64 (the tensor
    cores' fp32 sums in another order), the factored key scale, the joint max,
    p·vs in three fp16 terms scaled by the CTA's power of two, partial sums
    added in rank order, a masked row's tail and l = S."""
    B, _, H, Dh = q.shape
    S = kq.shape[1]
    Hkv = kq.shape[2] // Dh
    nrep = H // Hkv
    scale = np.float32(tattn._scale(Dh))
    out = torch.zeros((B, H, Dh), dtype=torch.float32)
    per = keys_per_cta(n, cs)
    for b in range(B):
        for kvh in range(Hkv):
            K = kq[b, :, kvh * Dh:(kvh + 1) * Dh].double()        # [S, Dh] codes
            V = vq[b, :, kvh * Dh:(kvh + 1) * Dh].double()
            qs = q[b, 0, kvh * nrep:(kvh + 1) * nrep].float() * float(scale)   # [nrep, Dh]
            # q' terms, per head its own power of two
            dots = torch.zeros((nrep, S), dtype=torch.float32)
            for r in range(nrep):
                p2, inv = pow2_for(qs[r].abs().max().item())
                terms = h_terms(qs[r] * float(p2))
                d = sum((K @ t.double()) for t in terms)            # exact products
                dots[r] = d.float() * float(inv)
            s = dots * ks[b, :, kvh][None]
            ok = (valid[b] > 0) & (torch.arange(S) < n)
            s = torch.where(ok[None], s, torch.tensor(NEG_INF))
            ranges = [(min(n, c * per), min(n, c * per + per)) for c in range(cs)]
            m = torch.stack([s[:, k0:k1].amax(-1) if k1 > k0 else
                             torch.full((nrep,), -float("inf")) for k0, k1 in ranges]).amax(0)
            masked = not bool(m[0] > NEG_INF)
            o_ctas, l_ctas = [], []
            for rank, (k0, k1) in enumerate(ranges):
                p = torch.exp(s[:, k0:k1] - m[:, None])             # [nrep, keys]
                vmax = vs[b, k0:k1, kvh].max().item() if k1 > k0 else 0.0
                p2v, invv = pow2_for(vmax)
                x = (p * vs[b, k0:k1, kvh][None]).float() * float(p2v)
                o = sum(t.double() @ V[k0:k1] for t in h_terms(x)).float() * float(invv)
                if masked:   # the slots past the ring's, p = 1 each, a CTA's share
                    tail = [c for c in range(n + rank, S, cs)]
                    if tail:
                        o = o + (V[tail].float() * vs[b, tail, kvh][:, None]).sum(0)[None]
                o_ctas.append(o)
                l_ctas.append(p.sum(-1))
            o = sum(o_ctas)
            l = torch.full((nrep,), float(S)) if masked else sum(l_ctas)
            out[b, kvh * nrep:(kvh + 1) * nrep] = o / torch.clamp(l, min=1e-30)[:, None]
    return out[:, None]


def _case(seed, B, S, H, Hkv, valid_len, dtype=torch.bfloat16, masked_row=False):
    r = np.random.default_rng(seed)
    kq = torch.from_numpy(r.integers(-127, 128, (2, B, S, Hkv * DH)).astype(np.int8))
    vq = torch.from_numpy(r.integers(-127, 128, (2, B, S, Hkv * DH)).astype(np.int8))
    ks = torch.from_numpy(r.uniform(1e-3, 2e-2, (2, B, S, Hkv)).astype(np.float32))
    vs = torch.from_numpy(r.uniform(1e-3, 2e-2, (2, B, S, Hkv)).astype(np.float32))
    q = torch.from_numpy(r.normal(size=(B, 1, H, DH)).astype(np.float32)).to(dtype)
    lens = r.integers(valid_len - 12, valid_len + 1, B)
    valid = torch.from_numpy((np.arange(S)[None] < lens[:, None]).astype(np.int32))
    if masked_row:
        valid[-1] = 0
    return q, kq, ks, vq, vs, valid


# --- the code conversion ------------------------------------------------------------------

@pytest.mark.parametrize("sel,pos", [(0x4140, (0, 1)), (0x4342, (2, 3)), (0x4240, (0, 2)),
                                     (0x4341, (1, 3))])
def test_every_int8_code_becomes_its_exact_fp16_value(sel, pos):
    codes = np.arange(-128, 128, dtype=np.int64)
    for slot in range(4):                       # each code in each byte of the word
        quad = np.random.default_rng(slot).integers(-128, 128, (256, 4))
        quad[:, slot] = codes
        w = words(quad.reshape(-1)).reshape(256)
        got = codes_h2(w ^ np.uint32(0x80808080), sel)
        np.testing.assert_array_equal(got, quad[:, list(pos)].astype(np.float32))


def test_bf16_cannot_hold_a_biased_code_the_negative_control():
    """bf16's magic number 0x4300 (= 128) with the biased code c + 128 as its
    low byte: past 128 the byte's top bit lands in the exponent, so the value is
    not 128 + (c + 128) (129 of the 256 codes come out right, 128 of them by
    the mantissa and c = 0 by chance). fp16's 0x64 has the room."""
    u = np.arange(256, dtype=np.uint32)
    as_f32 = ((np.uint32(0x4300) | u) << 16).view(np.float32)
    wrong = as_f32 - 256.0 != u.astype(np.float32) - 128.0
    assert wrong[129:].all() and not wrong[:129].any()


# --- the fragment orders ------------------------------------------------------------------

def _ldsm(tile_bytes: np.ndarray, rows, units) -> np.ndarray:
    """ldmatrix.x4 (non-trans) over an int8 tile [16, 128]: matrix i = rows
    rows[i] .. + 7 at 16-byte unit units[i]; lane L gets, of each matrix, row L / 4's
    word L % 4. Returns [32, 4] uint32."""
    out = np.zeros((32, 4), dtype=np.uint32)
    for i in range(4):
        for lane in range(32):
            row = rows[i] + lane // 4
            seg = tile_bytes[row, 16 * units[i]:16 * units[i] + 16]
            out[lane, i] = words(seg)[lane % 4]
    return out


def _ldsm_trans(tile_bytes: np.ndarray, rows, units) -> np.ndarray:
    """ldmatrix.x4.trans on 16-bit elements: lane L gets, of each matrix, the
    elements (row 2(L % 4), column L / 4) and (row 2(L % 4) + 1, column L / 4),
    the first in the low half; a 16-bit element is 2 int8 codes."""
    out = np.zeros((32, 4), dtype=np.uint32)
    for i in range(4):
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            col = 16 * units[i] + 2 * g
            lo = tile_bytes[rows[i] + 2 * t4, col:col + 2]
            hi = tile_bytes[rows[i] + 2 * t4 + 1, col:col + 2]
            out[lane, i] = words(np.concatenate([lo, hi]))[0]
    return out


def _mma(a_frag, b_frag) -> np.ndarray:
    """m16n8k16 from the 32 lanes' fragments (values, not bits): a_frag
    [32, 4, 2] (a0..a3, low half first), b_frag [32, 2, 2]; returns D [16, 8]."""
    A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, t4 = lane // 4, lane % 4
        for reg, (row, col) in enumerate(((g, 2 * t4), (g + 8, 2 * t4), (g, 2 * t4 + 8),
                                          (g + 8, 2 * t4 + 8))):
            A[row, col:col + 2] = a_frag[lane, reg]
        Bm[2 * t4:2 * t4 + 2, g] = b_frag[lane, 0]
        Bm[2 * t4 + 8:2 * t4 + 10, g] = b_frag[lane, 1]
    return A @ Bm


@pytest.mark.parametrize("nrep", [1, 2, 4, 8])
def test_k_fragments_and_q_columns_give_k_dot_q(nrep):
    """One 16-key chunk played lane by lane as the K loop does: the words from
    ldmatrix, their codes as the A fragment, q' (integers here) in the same
    k order as B's columns (head r, term t in column 3r + t): each head's dot
    is the sum of its three columns, K · q exactly."""
    r = np.random.default_rng(nrep)
    tile = r.integers(-128, 128, (16, DH)).astype(np.int8)
    qt = r.integers(-50, 50, (nrep, 3, DH)).astype(np.float64)    # [head, term, dim]
    nt_tiles = (3 * nrep + 7) // 8
    D = np.zeros((16, 8 * nt_tiles))
    for p in range(4):
        mats = _ldsm(tile, rows=(0, 8, 0, 8), units=(2 * p, 2 * p, 2 * p + 1, 2 * p + 1))
        for h in range(2):
            U = 2 * p + h
            w_g, w_g8 = mats[:, 2 * h], mats[:, 2 * h + 1]
            a = np.stack([codes_h2(w_g ^ np.uint32(0x80808080), 0x4140),
                          codes_h2(w_g8 ^ np.uint32(0x80808080), 0x4140),
                          codes_h2(w_g ^ np.uint32(0x80808080), 0x4342),
                          codes_h2(w_g8 ^ np.uint32(0x80808080), 0x4342)], axis=1)
            for nt in range(nt_tiles):
                b = np.zeros((32, 2, 2))
                for lane in range(32):
                    g, t4 = lane // 4, lane % 4
                    c = nt * 8 + g
                    if c // 3 < nrep:
                        dims = 16 * U + 4 * t4 + np.arange(4)
                        b[lane] = qt[c // 3, c % 3, dims].reshape(2, 2)
                D[:, 8 * nt:8 * nt + 8] += _mma(a, b)
    want = tile.astype(np.float64) @ qt.sum(1).T                  # [16 keys, nrep]
    got = np.stack([D[:, 3 * h:3 * h + 3].sum(1) for h in range(nrep)], axis=1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nrep", [1, 4])
def test_v_trans_fragments_give_v_transposed_times_p(nrep):
    """One V chunk played lane by lane as the P·V loop does: ldmatrix.trans
    words split by byte permutes into V^T's A fragment at dims 16U + 2g (row g)
    and 16U + 2g + 1 (row g + 8), B from (p·vs) terms by key 2t4, 2t4 + 1,
    2t4 + 8, 2t4 + 9: the accumulators, stored as the kernel stores them,
    equal V^T · X exactly."""
    r = np.random.default_rng(10 + nrep)
    tile = r.integers(-128, 128, (16, DH)).astype(np.int8)
    xt = r.integers(-40, 40, (nrep, 3, 16)).astype(np.float64)   # [head, term, key]
    nt_tiles = (3 * nrep + 7) // 8
    part = np.zeros((8 * nt_tiles, DH))                          # [column, dim]
    for p in range(4):
        mats = _ldsm_trans(tile, rows=(0, 8, 0, 8), units=(2 * p, 2 * p, 2 * p + 1, 2 * p + 1))
        for h in range(2):
            U = 2 * p + h
            x0, x1 = (mats[:, 2 * h + i] ^ np.uint32(0x80808080) for i in range(2))
            a = np.stack([codes_h2(x0, 0x4240), codes_h2(x0, 0x4341),
                          codes_h2(x1, 0x4240), codes_h2(x1, 0x4341)], axis=1)
            for nt in range(nt_tiles):
                b = np.zeros((32, 2, 2))
                for lane in range(32):
                    g, t4 = lane // 4, lane % 4
                    c = nt * 8 + g
                    if c // 3 < nrep:
                        keys = [2 * t4, 2 * t4 + 1, 2 * t4 + 8, 2 * t4 + 9]
                        b[lane] = xt[c // 3, c % 3, keys].reshape(2, 2)
                D = _mma(a, b)
                for lane in range(32):       # the kernel's store of c0..c3
                    g, t4 = lane // 4, lane % 4
                    col = nt * 8 + 2 * t4
                    part[col, 16 * U + 2 * g] = D[g, 2 * t4]
                    part[col + 1, 16 * U + 2 * g] = D[g, 2 * t4 + 1]
                    part[col, 16 * U + 2 * g + 1] = D[g + 8, 2 * t4]
                    part[col + 1, 16 * U + 2 * g + 1] = D[g + 8, 2 * t4 + 1]
    want = xt.sum(1) @ tile.astype(np.float64)                   # [nrep, dims]
    got = np.stack([part[3 * h:3 * h + 3].sum(0) for h in range(nrep)])
    np.testing.assert_array_equal(got, want)


# --- three scaled fp16 terms ----------------------------------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_three_scaled_fp16_terms_hold_an_fp32_value(seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy((r.normal(size=4096) * 10.0 ** r.uniform(-6, 3, 4096))
                         .astype(np.float32))
    p2, inv = pow2_for(x.abs().max().item())
    assert 2 ** 14 <= x.abs().max().item() * p2 < 2 ** 15
    t0, t1, t2 = h_terms(x * float(p2))
    back = ((t0.double() + t1.double()) + t2.double()) * float(inv)
    err = (back - x.double()).abs()
    assert err.max().item() <= x.abs().max().item() * 2.0 ** -39
    big = x.abs() * float(p2) >= 0.5                       # above fp16's reach, exactly
    assert torch.equal(back[big], x.double()[big])


def test_pow2_for_edges():
    assert pow2_for(0.0) == (1.0, 1.0)
    assert pow2_for(1e-45)[0] == 1.0                       # subnormal: no scaling
    assert pow2_for(3.0e38)[0] == np.float32(2.0 ** -113)  # clamped, still a normal float
    p2, inv = pow2_for(np.float32(2.0 ** -90))
    assert p2 == np.float32(2.0 ** 100) and inv == np.float32(2.0 ** -100)


# --- the whole route against the plain version ------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,valid_len,slot,cs", [
    (2, 320, 4, 4, 288, 291, 1),    # serving's slots at n_rep 1, the query at decode step 3
    (2, 320, 2, 2, 288, 293, 4),    # one-row-like clusters: ranges of 80, 80, 80, 54
    (2, 96, 8, 4, 60, 70, 2),       # n_rep 2
    (1, 64, 8, 2, 40, 45, 1),       # n_rep 4
    (1, 64, 8, 1, 20, 63, 2),       # n_rep 8, every slot read
])
def test_the_ring_route_equals_the_plain_version(B, S, H, Hkv, valid_len, slot, cs):
    q, kq, ks, vq, vs, valid = _case(B * S + H, B, S, H, Hkv, valid_len)
    valid[:, valid_len:slot + 1] = 1                       # the generated slots up to the query
    n = slot + 1
    got = ring_route(q, kq[1], ks[1], vq[1], vs[1], valid, n, cs)
    want = tdec.stacked_decode_attention_i8_plain(q.float(), kq, ks, vq, vs, valid, 1)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
    # and the bf16 output stays within the chip check's 2e-2 (in fact one bf16 step)
    plain_bf16 = tdec.stacked_decode_attention_i8_plain(q, kq, ks, vq, vs, valid, 1)
    assert (got.bfloat16().float() - plain_bf16.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("cs", [1, 2, 4])
def test_reading_the_slots_up_to_the_query_is_the_whole_cache_s_function(cs):
    """n = slot + 1: the plain version over all S, where the later slots are
    masked, equals the plain version cut at n and the ring route at n."""
    q, kq, ks, vq, vs, valid = _case(5, 3, 320, 4, 4, 288)
    slot = 290
    valid[:, 288:slot + 1] = 1
    full = tdec.stacked_decode_attention_i8_plain(q.float(), kq, ks, vq, vs, valid, 0)
    cut = tdec.stacked_decode_attention_i8_plain(q.float(), kq, ks, vq, vs, valid, 0, slot + 1)
    assert torch.equal(full, cut)
    torch.testing.assert_close(ring_route(q, kq[0], ks[0], vq[0], vs[0], valid, slot + 1, cs),
                               full, atol=2e-6, rtol=1e-5)


@pytest.mark.parametrize("cs", [1, 2, 4])
def test_a_row_masked_everywhere_is_the_mean_of_all_of_v(cs):
    q, kq, ks, vq, vs, valid = _case(6, 2, 96, 2, 2, 60, masked_row=True)
    n = 70
    got = ring_route(q, kq[0], ks[0], vq[0], vs[0], valid, n, cs)
    want = tdec.stacked_decode_attention_i8_plain(q.float(), kq, ks, vq, vs, valid, 0, n)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=1e-5)
    mean_v = (vq[0, -1].reshape(96, 2, DH).float() * vs[0, -1][..., None]).mean(0)
    torch.testing.assert_close(got[-1, 0], mean_v, atol=1e-6, rtol=1e-5)


def test_the_decode_step_passes_the_slots_up_to_its_own():
    from openvla_probe_tpu_torch.models import llama
    src = Path(llama.__file__).read_text()
    body = src[src.index("def decode_step_stacked_i8"):src.index("def embed_tokens")]
    assert "n_keys=slot + 1" in body


# --- the route rule and the serving wave ---------------------------------------------------

def test_the_ring_rule_takes_bf16_at_dh_128_only():
    def q(dtype, dh):
        return torch.zeros((1, 1, 2, dh), dtype=dtype)
    assert tdec.stacked_ring_eligible(q(torch.bfloat16, 128), 320)
    assert tdec.stacked_ring_eligible(q(torch.bfloat16, 128), RING_MAX_KEYS)
    assert not tdec.stacked_ring_eligible(q(torch.bfloat16, 128), RING_MAX_KEYS + 1)
    assert tdec.STACKED_RING_MAX_KEYS == RING_MAX_KEYS
    for dtype, dh in ((torch.float32, 128), (torch.bfloat16, 64), (torch.bfloat16, 16)):
        assert not tdec.stacked_ring_eligible(q(dtype, dh), 320)


def test_the_serving_shape_runs_in_one_wave_of_single_cta_clusters():
    """768 (b, kv head) pairs at B = 24: one CTA each (the cluster rule), six
    CTAs an SM by shared memory (227 KB, 1 KB reserved per block) at every
    decode step (n = 289 .. 294), so 132 SMs hold all 768 at once."""
    assert cluster_size(24 * 32) == 1 and MIN_BLOCKS == 6
    for n in range(289, 295):
        assert 6 * (smem_bytes(n, 1, 1) + 1024) <= 232448
    assert 132 * 6 >= 24 * 32
    assert cluster_size(32) == 4 and cluster_size(64) == 2 and cluster_size(128) == 1
    assert smem_bytes(RING_MAX_KEYS, 1, 8) <= 232448
