"""The arithmetic of row 13's ring route, rehearsed on the CPU.

``ops/csrc/split_attention_i8.cu`` runs only on the card. Its ring route
streams each (batch row, kv head)'s int8 prefill K rows, then V rows, in
16-key chunks through each warp's stages, turns the codes into fp16 operands
by byte permutes, computes q·k with q's int8 codes and p·V with p's int8 codes
on the fp16 tensor cores (one column of B a query head: the GQA heads in one
pass), moves each warp's fp32 sums into int32 every 1024 keys, and splits a
row's keys across a cluster whose CTAs share the joint max, the joint sum and
pf's joint max before any p code is made. What it assumes is checked here in
numpy and torch, with inputs made by numpy from a seed:

- the fp16 codes: the byte permute of ``c ^ 0x80`` under fp16's 0x64 and the
  subtraction of 1152 give every int8 code exactly at each selector the
  route uses (K: 0x4140, 0x4342; V: 0x4240, 0x4341);
- the fragments: K's ldmatrix words against q's code columns give each key's
  exact integer dot for every head of n_rep 1, 2, 4, 8 (V's transposed
  fragments against p's code columns likewise); a head's score read back from
  its C fragment column by the kernel's shuffle;
- exactness: a 128-deep q·k and 1024 keys of p·V summed in fp32 stay exact
  integers (at the worst codes, ±127), the warps' chunk split never gives a
  warp more than 1024 keys of a row of up to 4095, and 2048 keys summed in
  fp32 without the hand-off are not exact (the negative control);
- pf's max over the cluster gives the whole row's p codes; each CTA's own max
  gives other codes (the negative control);
- the whole route (the kernel's key ranges, thread, warp and rank orders of
  the sums, exact integer dots, the decode slots on rank 0) lies within
  ``compare_split_attention_i8`` at n_rep 1, 2, 4, 8 and cluster sizes 1, 2
  and 4, in bf16 and fp32 scores, with a row masked everywhere but BOS;
- the route rule and the shared memory: ``split_ring_eligible`` takes bf16 at
  Dh = 128 with n_rep 1, 2, 4, 8 and nothing else; six CTAs of the serving
  shape fit an SM, and the largest shape (T + A = 4096, n_rep 8, one CTA)
  fits a CTA.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import decode_attention as tdec
from openvla_probe_tpu_torch.ops import linear as tlin

SRC = (Path(tdec.__file__).parent / "csrc" / "split_attention_i8.cu").read_text()
COMMON = (Path(tdec.__file__).parent / "csrc" / "decode_common.cuh").read_text()
WARP_STAGES, PITCH_PAD, HANDOFF = (
    int(re.search(rf"constexpr int {n} = [^;]*?(\d+);", SRC).group(1))
    for n in ("kWarpStages", "kPitch", "kHandoff"))
ROWS, THREADS, MIN_BLOCKS = (
    int(re.search(rf"constexpr int {n} = (\d+);", COMMON).group(1))
    for n in ("kRows", "kThreads", "kMinBlocksPerSm"))
WARPS, DH = THREADS // 32, 128
F32 = np.float32


# --- the kernel's pieces -------------------------------------------------------------

def byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays (selector nibbles 0-3:
    x's bytes, 4-7: y's)."""
    x = x.astype(np.uint64)
    src = [(x >> np.uint64(8 * i)) & np.uint64(0xFF) for i in range(4)] + [
        np.uint64((y >> (8 * i)) & 0xFF) for i in range(4)]
    out = np.zeros_like(x)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0x7] << np.uint64(8 * i)
    return out.astype(np.uint32)


def codes_h2(wx: np.ndarray, sel: int) -> np.ndarray:
    """decode_common.cuh's codes_h2: two fp16 values (as float32, [..., 2] low
    half first) of the bytes `sel` of wx = w ^ 0x80808080."""
    h = byte_perm(wx, 0x64646464, sel)
    halves = np.stack([h & 0xFFFF, h >> 16], axis=-1).astype(np.uint16).view(np.float16)
    return (halves - np.float16(1152.0)).astype(F32)


def words(codes: np.ndarray) -> np.ndarray:
    """int8 [..., 4k] -> little-endian uint32 words [..., k]."""
    return np.ascontiguousarray(codes.astype(np.int8)).view(np.uint32)


def keys_per_cta(n: int, cs: int) -> int:
    return -(-(-(-n // cs)) // ROWS) * ROWS


def warp_keys(n: int, warp: int) -> int:
    """Keys a warp of a CTA owning n keys streams: chunks warp, warp + 4, ..."""
    nch = -(-n // ROWS)
    return sum(min(ROWS, n - ROWS * j) for j in range(warp, nch, WARPS))


def code(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / s), -127, 127)


def tree32(v: np.ndarray) -> np.ndarray:
    """A warp's xor-shuffle sum over its 32 lanes (axis 0), fp32: every lane
    ends with the same value; lane 0's is returned."""
    v = v.astype(F32).copy()
    for o in (16, 8, 4, 2, 1):
        v = (v + v[np.arange(32) ^ o]).astype(F32)
    return v[0]


def block_sum(per_thread: np.ndarray) -> np.ndarray:
    """reduce_heads' sum over a CTA's 128 threads (axis 0): each warp's tree,
    then the warps in order, in fp32."""
    w = [tree32(per_thread[32 * i:32 * i + 32]) for i in range(WARPS)]
    out = w[0]
    for x in w[1:]:
        out = (out + x).astype(F32)
    return out


def ring_route(q, kq, ks, vq, vs, kd, vd, pre, dec, scores_dtype, cs, own_pf_max=False):
    """The ring route's function in the kernel's order, in numpy float32: per
    (b, kv head), per CTA of the cluster (keys [rank · per, ...), rank 0 with
    the decode slots): q's codes, the exact dots, the rounded scores, the
    joint max, expf sums by thread (keys tid, tid + 128, ...), warp trees,
    warps and ranks in order, p = e / l, pf = p · s_v and its joint max (or,
    with `own_pf_max`, each CTA's own: another function), the exact p · V of
    the codes, the decode segment on rank 0 in slot order."""
    B, _, H, Dh = q.shape
    T, Hkv, A = kq.shape[1], kq.shape[2], kd.shape[1]
    nrep = H // Hkv
    scale = F32(tattn._scale(Dh))
    sbf = scores_dtype == torch.bfloat16
    rs = (lambda x: torch.from_numpy(np.asarray(x, F32)).bfloat16().float().numpy()) if sbf \
        else (lambda x: np.asarray(x, F32))
    bf = lambda x: torch.from_numpy(np.asarray(x, F32)).bfloat16().float().numpy()
    neg = F32(tattn.NEG_INF)
    qn, kqn, ksn, vqn, vsn = (t.float().numpy() for t in (q, kq, ks, vq, vs))
    kdn, vdn, pren, decn = kd.float().numpy(), vd.float().numpy(), pre.numpy(), dec.numpy()
    per = keys_per_cta(T, cs)
    out = np.zeros((B, H, Dh), dtype=F32)
    for b in range(B):
        for kvh in range(Hkv):
            heads = range(kvh * nrep, kvh * nrep + nrep)
            qf = qn[b, 0, list(heads)]                                     # [nrep, Dh]
            sq = np.array([F32(F32(max(np.abs(x).max(), F32(1e-8))) / F32(127)) for x in qf], F32)
            qc = np.clip(np.round(qf / sq[:, None]), -127, 127)
            ctas = []
            for rank in range(cs):
                k0 = min(T, rank * per)
                k1 = min(T, k0 + per)
                dots = (kqn[b, k0:k1, kvh].astype(np.int64) @ qc.T.astype(np.int64)).astype(F32)
                v = ((dots * sq) .astype(F32) * ksn[b, k0:k1, kvh, None]).astype(F32)
                mask = np.where(pren[b, k0:k1, None] > 0, F32(0), neg)
                s = rs((v * scale).astype(F32) + mask)                     # [n, nrep]
                d = np.zeros((0, nrep), F32)
                if rank == 0:
                    d = np.zeros((A, nrep), F32)
                    for sl in range(A):
                        kv = kdn[b, sl, kvh]
                        lanes = np.zeros((32, nrep), F32)
                        for i in range(4):
                            lanes = (lanes + (qf[:, 4 * np.arange(32) + i].T
                                              * kv[4 * np.arange(32) + i, None]).astype(F32)).astype(F32)
                        acc = tree32(lanes)
                        dm = np.where(decn[b, sl] > 0, F32(0), neg)
                        d[sl] = rs((rs(acc) * scale).astype(F32) + dm)
                ctas.append(dict(k0=k0, s=s, d=d))
            m = np.full(nrep, -np.inf, F32)
            for c in ctas:
                for x in (c["s"], c["d"]):
                    if len(x):
                        m = np.maximum(m, x.max(0))
            l = np.zeros(nrep, F32)
            for c in ctas:
                th = np.zeros((THREADS, nrep), F32)
                for x in (c["s"], c["d"]):
                    e = np.exp((x - m).astype(F32)).astype(F32)
                    c["e" if x is c["s"] else "ed"] = e
                    for i in range(len(x)):
                        th[i % THREADS] = (th[i % THREADS] + e[i]).astype(F32)
                l = (l + block_sum(th)).astype(F32)
            pm = np.zeros(nrep, F32)
            for c in ctas:
                c["pf"] = ((c["e"] / l).astype(F32) * vsn[b, c["k0"]:c["k0"] + len(c["e"]), kvh,
                                                            None]).astype(F32)
                c["pm"] = np.abs(c["pf"]).max(0) if len(c["pf"]) else np.zeros(nrep, F32)
                pm = np.maximum(pm, c["pm"])
            tot = np.zeros((nrep, Dh), np.int64)
            for c in ctas:
                own = np.maximum(c["pm"], F32(1e-12)) if own_pf_max else np.maximum(pm, F32(1e-12))
                sp = (own / F32(127)).astype(F32)
                c["sp"] = sp
                pc = np.clip(np.round(c["pf"] / sp), -127, 127).astype(np.int64)   # [n, nrep]
                tot += pc.T @ vqn[b, c["k0"]:c["k0"] + len(pc), kvh].astype(np.int64)
            sp = ctas[0]["sp"] if not own_pf_max else None
            dec_out = np.zeros((nrep, Dh), F32)
            pd = bf((ctas[0]["ed"] / l).astype(F32))                        # [A, nrep]
            for sl in range(A):
                dec_out = (dec_out + (pd[sl, :, None] * vdn[b, sl, kvh][None])).astype(F32)
            if own_pf_max:   # each CTA's codes times its own s_p
                pre_out = np.zeros((nrep, Dh), F32)
                for c in ctas:
                    pc = np.clip(np.round(c["pf"] / c["sp"]), -127, 127).astype(np.int64)
                    part = (pc.T @ vqn[b, c["k0"]:c["k0"] + len(pc), kvh].astype(np.int64))
                    pre_out = (pre_out + (part.astype(F32) * c["sp"][:, None])).astype(F32)
            else:
                pre_out = (tot.astype(F32) * sp[:, None]).astype(F32)
            out[b, list(heads)] = (pre_out + dec_out).astype(F32)
    return torch.from_numpy(out)[:, None].to(q.dtype)


def split_inputs(seed, B, T, A, H, Hkv, dtype=torch.bfloat16, bos_row=True):
    r = np.random.default_rng(seed)
    kq, vq = (torch.from_numpy(r.integers(-127, 128, (B, T, Hkv, DH)).astype(np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy((r.random((B, T, Hkv)) * 0.02 + 0.005).astype(F32))
              for _ in range(2))
    q = torch.from_numpy(r.normal(size=(B, 1, H, DH)).astype(F32)).to(dtype)
    kd, vd = (torch.from_numpy(r.normal(size=(B, A, Hkv, DH)).astype(F32)).to(dtype)
              for _ in range(2))
    pre = torch.from_numpy((r.random((B, T)) > 0.2).astype(np.int32))
    pre[:, 0] = 1
    if bos_row and B > 1:
        pre[1, 1:] = 0                       # a row masked everywhere but BOS
    dec = torch.ones((B, A), dtype=torch.int32)
    dec[:, A // 2 + 1:] = 0
    return q, kq, ks, vq, vs, kd, vd, pre, dec


# --- the codes and the fragments -----------------------------------------------------

@pytest.mark.parametrize("sel", [0x4140, 0x4342, 0x4240, 0x4341])
def test_every_int8_code_becomes_its_exact_fp16_value(sel):
    c = np.arange(-128, 128).reshape(64, 4).astype(np.int8)
    w = words(c)[:, 0] ^ np.uint32(0x80808080)
    got = codes_h2(w, sel)
    lo, hi = sel & 0xF, (sel >> 8) & 0xF
    assert np.array_equal(got[:, 0], c[:, lo].astype(F32))
    assert np.array_equal(got[:, 1], c[:, hi].astype(F32))


@pytest.mark.parametrize("nrep", [1, 2, 4, 8])
def test_k_fragments_and_q_code_columns_give_every_heads_dot(nrep):
    """A 16-key chunk: lane (g, t4)'s ldmatrix words of K rows g and g + 8
    (dims 16U + 4t4 .. + 3) as the fragment's k = 2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9,
    q's fp16 codes at the same dims in column g (head g); C's column r, read by
    the kernel's shuffle from lane (g & ~3) | r / 2, element r % 2 (+ 2 for key
    g + 8), is head r's exact dot."""
    r = np.random.default_rng(nrep)
    K = r.integers(-127, 128, (ROWS, DH)).astype(np.int8)
    qc = r.integers(-127, 128, (nrep, DH))
    want = K.astype(np.int64) @ qc.T
    C = np.zeros((ROWS, 8), np.int64)                      # the mma's C over the 8 units
    for U in range(8):
        Afr = np.zeros((ROWS, 16), np.int64)
        Bfr = np.zeros((16, 8), np.int64)
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            for row in (g, g + 8):
                wx = words(K[row, 16 * U + 4 * t4:16 * U + 4 * t4 + 4])[0] ^ np.uint32(0x80808080)
                a01, a23 = codes_h2(np.array([wx]), 0x4140)[0], codes_h2(np.array([wx]), 0x4342)[0]
                Afr[row, 2 * t4:2 * t4 + 2] = a01
                Afr[row, 2 * t4 + 8:2 * t4 + 10] = a23
            if g < nrep:
                Bfr[2 * t4:2 * t4 + 2, g] = qc[g, 16 * U + 4 * t4:16 * U + 4 * t4 + 2]
                Bfr[2 * t4 + 8:2 * t4 + 10, g] = qc[g, 16 * U + 4 * t4 + 2:16 * U + 4 * t4 + 4]
        C += Afr @ Bfr
    for head in range(nrep):
        src_t4, e = head // 2, head % 2                     # the shuffle's source lane and element
        for g in range(8):
            assert C[g, 2 * src_t4 + e] == want[g, head]
            assert C[g + 8, 2 * src_t4 + e] == want[g + 8, head]


@pytest.mark.parametrize("nrep", [1, 8])
def test_v_trans_fragments_against_p_code_columns_give_p_v(nrep):
    """V's ldmatrix.trans words split by the V selectors (0x4240, 0x4341) as
    the A fragment of V^T at dims 16U + 2g, 16U + 2g + 1; p's codes at keys
    2t4, 2t4 + 1, 2t4 + 8, 2t4 + 9 in column g: C = V^T · P exactly."""
    r = np.random.default_rng(10 + nrep)
    V = r.integers(-127, 128, (ROWS, DH)).astype(np.int8)     # [keys][dims]
    P = r.integers(-127, 128, (ROWS, nrep))
    want = V.astype(np.int64).T @ P                            # [dims][heads]
    for U in range(8):
        Afr = np.zeros((16, 16), np.int64)                    # rows: g -> 16U + 2g, g + 8 -> + 1
        Bfr = np.zeros((16, 8), np.int64)
        for lane in range(32):
            g, t4 = lane // 4, lane % 4
            # trans word: keys 2t4, 2t4 + 1 (16-bit elements), each the byte pair of dims
            # 16U + 2g, 16U + 2g + 1
            for kk, keys in ((0, (2 * t4, 2 * t4 + 1)), (1, (2 * t4 + 8, 2 * t4 + 9))):
                b = [V[keys[0], 16 * U + 2 * g], V[keys[0], 16 * U + 2 * g + 1],
                     V[keys[1], 16 * U + 2 * g], V[keys[1], 16 * U + 2 * g + 1]]
                wx = words(np.array(b, np.int8))[0] ^ np.uint32(0x80808080)
                even = codes_h2(np.array([wx]), 0x4240)[0]     # dim 16U + 2g: fragment row g
                odd = codes_h2(np.array([wx]), 0x4341)[0]      # dim 16U + 2g + 1: row g + 8
                Afr[g, 2 * t4 + 8 * kk:2 * t4 + 8 * kk + 2] = even
                Afr[g + 8, 2 * t4 + 8 * kk:2 * t4 + 8 * kk + 2] = odd
            if g < nrep:
                Bfr[2 * t4:2 * t4 + 2, g] = P[2 * t4:2 * t4 + 2, g]
                Bfr[2 * t4 + 8:2 * t4 + 10, g] = P[2 * t4 + 8:2 * t4 + 10, g]
        C = Afr @ Bfr
        for g in range(8):
            assert np.array_equal(C[g, :nrep], want[16 * U + 2 * g])
            assert np.array_equal(C[g + 8, :nrep], want[16 * U + 2 * g + 1])


# --- exactness ----------------------------------------------------------------------------

def _fp32_sum_of_chunks(prod: np.ndarray, handoff: int):
    """A warp's mma accumulation: each 16-key chunk's sum added to an fp32
    accumulator, moved into int64 every `handoff` chunks (0: never)."""
    acc, ints = F32(0), 0
    for c in range(0, len(prod), ROWS):
        acc = F32(acc + F32(prod[c:c + ROWS].sum()))
        if handoff and (c // ROWS + 1) % handoff == 0:
            ints, acc = ints + int(acc), F32(0)
    return ints + int(acc)


def test_integer_dots_in_fp32_stay_exact_with_the_hand_off():
    assert DH * 127 * 127 < 2 ** 24                      # q · k: a 128-deep dot
    assert HANDOFF * ROWS * 127 * 127 < 2 ** 24          # p · V between hand-offs
    r = np.random.default_rng(0)
    worst = np.full(4096, 127 * 127, np.int64)
    mixed = r.integers(-127, 128, 4096) * 127
    for prod in (worst, mixed, -worst):
        assert _fp32_sum_of_chunks(prod[:1024], HANDOFF) == prod[:1024].sum()
        assert _fp32_sum_of_chunks(prod, HANDOFF) == prod.sum()
    # the negative control: 2048 keys of large products summed in fp32 alone
    big = r.integers(120, 128, 2048) * r.integers(120, 128, 2048)
    assert _fp32_sum_of_chunks(big, 0) != big.sum()
    assert _fp32_sum_of_chunks(big, HANDOFF) == big.sum()


@pytest.mark.parametrize("cs", [1, 2, 4])
def test_no_warp_streams_more_than_1024_keys(cs):
    for T in (1, 15, 288, 1024, 4080, 4095):
        per = keys_per_cta(T, cs)
        for rank in range(cs):
            n = max(0, min(T, min(T, rank * per) + per) - min(T, rank * per))
            for warp in range(WARPS):
                assert warp_keys(n, warp) <= HANDOFF * ROWS


# --- the cluster's pf max -------------------------------------------------------------------

@pytest.mark.parametrize("cs", [2, 4])
def test_the_clusters_pf_max_gives_the_whole_rows_codes(cs):
    r = np.random.default_rng(cs)
    pf = torch.from_numpy((r.random(300) ** 4 * 1e-2).astype(F32))
    whole = code(pf, tlin.div127(torch.clamp(pf.abs().max(), min=1e-12)))
    per = keys_per_cta(300, cs)
    parts = [pf[i:i + per] for i in range(0, 300, per)]
    joint = max(p.abs().max() for p in parts)
    got = torch.cat([code(p, tlin.div127(torch.clamp(joint, min=1e-12))) for p in parts])
    assert torch.equal(got, whole)
    own = torch.cat([code(p, tlin.div127(torch.clamp(p.abs().max(), min=1e-12))) for p in parts])
    assert not torch.equal(own, whole)                   # each CTA's own max: other codes


# --- the whole route -------------------------------------------------------------------------

@pytest.mark.parametrize("scores", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nrep,cs", [(1, 1), (2, 2), (4, 4), (8, 1), (1, 4), (8, 2)])
def test_the_ring_route_lies_within_the_stated_tolerance(nrep, cs, scores):
    B, T, A, Hkv = 2, 77, 6, 2
    args = split_inputs(20 + nrep + cs, B, T, A, Hkv * nrep, Hkv)
    got = ring_route(*args, scores, cs)
    tdec.compare_split_attention_i8(got, *args, scores)


def test_each_ctas_own_pf_max_is_another_function():
    """The negative control: at four CTAs, p codes quantized against each
    CTA's own pf max move outputs past the stated tolerance."""
    found = False
    for seed in range(6):
        args = split_inputs(40 + seed, 2, 160, 3, 2, 2, bos_row=False)
        got = ring_route(*args, torch.bfloat16, 4, own_pf_max=True)
        try:
            tdec.compare_split_attention_i8(got, *args, torch.bfloat16)
        except AssertionError:
            found = True
            break
    assert found


# --- the rule and the shared memory ----------------------------------------------------------

def smem_bytes(T: int, A: int, cs: int, nrep: int) -> int:
    """split_attention_i8.cu's smem_bytes."""
    per = keys_per_cta(T, cs)
    ring = WARPS * WARP_STAGES * ROWS * (DH + PITCH_PAD)
    return (ring + WARPS * WARP_STAGES * 8
            + 4 * ((WARPS + 2) * nrep * DH + 2 * per + nrep * (per + A) + WARPS * (nrep + 1)
                   + 4 * nrep)
            + 2 * nrep * DH + per)


def test_the_ring_rule_and_its_shared_memory():
    bf = torch.zeros((1, 1, 8, 128), dtype=torch.bfloat16)
    assert all(tdec.split_ring_eligible(bf, n) for n in (1, 2, 4, 8))
    assert not tdec.split_ring_eligible(bf, 3)
    assert not tdec.split_ring_eligible(bf.float(), 1)
    assert not tdec.split_ring_eligible(torch.zeros((1, 1, 8, 64), dtype=torch.bfloat16), 1)
    assert MIN_BLOCKS * smem_bytes(288, 6, 1, 1) <= 228 * 1024 - MIN_BLOCKS * 1024
    worst = max(smem_bytes(T, 4096 - T, 1, 8) for T in (1, 16, 2048, 4079, 4080, 4095))
    assert worst <= 227 * 1024
