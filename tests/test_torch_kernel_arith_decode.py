"""The arithmetic of the decode attentions' ring route, rehearsed on the CPU.

``ops/csrc/decode_common.cuh`` runs only on the card. It splits the keys of a
(batch, head) across a cluster of CTAs, streams each CTA's K rows then V rows
in 16-row chunks through each warp's own ring of stages, computes q·k and P·V
on the tensor cores with the fp32 operands (the split decode's scaled q and
unrounded p) as three bf16 terms, and shares the exact joint max and sum
through distributed shared memory. What it assumes is checked here in plain
torch, with inputs made by numpy from a seed:

- the key ranges of the CTAs cover the keys once, whole chunks each, a CTA
  possibly owning no key, and a chunk may straddle the prefill / generated
  boundary of the split decode (each row is its own copy);
- decode_attention's ring reads only the keys up to the query's position:
  past it the plain version's P is exactly 0 in every row that has a valid
  key, and a row with none (p = 1 at each of the S keys) takes the rest
  after the ring;
- the cluster rule: one CTA a (b, h) at serving (768 CTAs in one wave) and
  for generate's 8 rows, 2 or 4 for fewer rows;
- each warp's ring: its chunk u is in its stage when it is read, no stage is
  refilled before it is read, and its first V chunks are in flight before the
  softmax;
- three bf16 terms hold an fp32 value exactly (q·scale, p) down to 2^-100;
- the split result (each CTA's scores, the exchanged max, the sums and the
  partial P·V added in rank order) equals ``decode_flash_attention_plain`` and
  ``decode_attention_plain`` to fp32 rounding, in both score modes, at several
  cluster sizes and with ragged ranges;
- for ``decode_attention``, the bf16 P formed from the joint m and l is the
  plain version's P;
- the route: ``attention.decode_ring_eligible`` takes the main paths' layer
  slices of the stacked bf16 buffers and leaves fp32, other head dims,
  unaligned rows, empty segments and more than 4096 keys to the scalar
  kernels;
- negative control: P rounded against one CTA's own max and sum and rescaled
  at the combine (flash decoding) is not what the plain version computes: at
  generate's S = 352 with unit-normal inputs it moves 47-52 % of the bf16
  outputs by one or two bf16 steps (up to 2e-3), 85x or more the summed
  distance of the kernel's arithmetic, which moves at most 1.2 % of them by
  one step (a sum taken in another order landing at a rounding tie).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import decode_attention as tdec

NEG_INF = float(np.float32(tattn.NEG_INF))
SRC = (Path(tattn.__file__).parent / "csrc" / "decode_common.cuh").read_text()
ROWS, WARP_STAGES, THREADS, MIN_BLOCKS = (
    int(re.search(rf"constexpr int {n} = (\d+);", SRC).group(1))
    for n in ("kRows", "kWarpStages", "kThreads", "kMinBlocksPerSm"))
WARPS = THREADS // 32


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def keys_per_cta(S: int, cs: int) -> int:
    """decode_common.cuh::keys_per_cta: ceil(S / cs) rounded up to whole stages."""
    return -(-(-(-S // cs)) // ROWS) * ROWS


def key_ranges(S: int, cs: int):
    per = keys_per_cta(S, cs)
    return [(min(S, r * per), min(S, r * per + per)) for r in range(cs)]


def ring_keys(S: int, offset: int) -> int:
    """decode_common.cuh::ring_keys for decode_attention: the keys up to the
    query's position."""
    return 0 if offset < 0 else offset + 1 if offset < S else S


def ring_smem_bytes(S: int, cs: int, D: int = 128) -> int:
    """decode_common.cuh::ring_smem_bytes: every warp's stages of 16 rows at a
    pitch of 2 D + 16 bytes, their barriers, the combine's vector, the
    reductions' slots and the CTA's scores."""
    stages = WARPS * WARP_STAGES
    return stages * ROWS * (2 * D + 16) + 8 * stages + 4 * (D + WARPS + 4 + keys_per_cta(S, cs))


def per_sm(S: int, cs: int) -> int:
    """CTAs an SM holds by shared memory (228 KB, 1 KB reserved a CTA) and threads."""
    return min(2048 // THREADS, 233472 // (ring_smem_bytes(S, cs) + 1024))


def cluster_size(pairs: int, sms: int = 132) -> int:
    """decode_common.cuh::cluster_size, its rule read from the source: the
    fewest of 1, 2, 4 CTAs a (b, h) that set 7/8 of the SMs to work."""
    m = re.search(r"if \((\d+) \* pairs \* cs >= (\d+) \* sms\) return cs;", SRC)
    den, num = int(m.group(1)), int(m.group(2))
    for cs in (1, 2):
        if den * pairs * cs >= num * sms:
            return cs
    return 4


def bf16_terms(x: torch.Tensor):
    """decode_common.cuh::bf16_term 0, 1, 2 of fp32 `x`."""
    t0 = x.to(torch.bfloat16)
    r = x - t0.float()
    t1 = r.to(torch.bfloat16)
    t2 = (r - t1.float()).to(torch.bfloat16)
    return t0.float(), t1.float(), t2.float()


def _rand(seed, shape):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(size=shape).astype(np.float32)).bfloat16()


# --- the kernel's arithmetic ---------------------------------------------------------


def ring_decode(q, k, v, ok, mode: str, cs: int, own_softmax: bool = False, keys=None,
                tail: bool = True):
    """The ring route's function on fp32 copies of bf16 inputs: q [B, H, D], k/v
    [B, S, H, D], ok [B, S] (the kernel's mask). The ring reads keys [0, keys)
    (all S by default). Each CTA's keys are scored, the cluster's max taken,
    p = exp(s - m) and the CTAs' sums formed; the split decode ("split") adds
    the partial P·V and the sums in rank order and divides at the end (p never
    rounded); decode_attention ("fp32" / "bf16" scores) rounds P = bf16(p / l)
    against the joint l before P·V, and in a row with no valid key among the
    ring's (every score the masked one) takes l = S and, with `tail`, adds
    bf16(1 / S) v_c for the keys past the ring's. With `own_softmax` (the
    negative control) each CTA rounds P against its own max and sum and the
    combine rescales by l_r exp(m_r - m) / l. Returns the fp32 output
    [B, H, D] and P [B, H, keys]."""
    D, S = q.shape[-1], k.shape[1]
    n = S if keys is None else keys
    scale = tattn._scale(D)
    # q' (split) in three bf16 terms, each dotted with K, the term columns added in order
    terms = bf16_terms(q * scale) if mode == "split" else (q,)
    dots = [torch.einsum("bhd,bshd->bhs", t, k) for t in terms]
    dots = sum(dots[1:], dots[0])
    okb = ok[:, None, :]
    if mode == "split":
        s = torch.where(okb, dots, torch.tensor(NEG_INF))
    elif mode == "fp32":
        s = dots * scale + torch.where(okb, torch.tensor(0.0), torch.tensor(NEG_INF))
    else:
        s = torch.where(okb, _bf16(_bf16(dots) * scale), _bf16(torch.tensor(NEG_INF)))
    s = s[..., :n]
    ranges = [(k0, k1) for k0, k1 in key_ranges(n, cs) if k1 > k0]
    m_r = [s[..., k0:k1].amax(-1, keepdim=True) for k0, k1 in ranges]
    m = torch.stack(m_r).amax(0)
    p = torch.exp(s - m)
    l_r = [p[..., k0:k1].sum(-1, keepdim=True) for k0, k1 in ranges]
    l = sum(l_r[1:], l_r[0])                                  # rank order
    masked = _bf16(torch.tensor(NEG_INF)) if mode == "bf16" else torch.tensor(NEG_INF)
    masked_row = ~(m > masked) if mode != "split" else torch.zeros_like(m, dtype=torch.bool)
    l = torch.where(masked_row, torch.tensor(float(S)), l)
    P = torch.empty_like(p)
    out = torch.zeros_like(q)
    for (k0, k1), mr, lr in zip(ranges, m_r, l_r):
        if mode == "split":
            P[..., k0:k1] = p[..., k0:k1]       # as three bf16 terms on the tensor cores
        elif own_softmax:
            P[..., k0:k1] = _bf16(torch.exp(s[..., k0:k1] - mr) / lr)
        else:
            P[..., k0:k1] = _bf16(p[..., k0:k1] / l)
        pt = bf16_terms(P[..., k0:k1]) if mode == "split" else (P[..., k0:k1],)
        parts = [torch.einsum("bhs,bshd->bhd", t, v[:, k0:k1]) for t in pt]
        part = sum(parts[1:], parts[0])
        if own_softmax:
            part = part * (lr * torch.exp(mr - m) / l)
        out = out + part                                      # rank order
    if tail and n < S:
        rest = torch.einsum("bhs,bshd->bhd", _bf16(torch.full_like(m, 1.0 / S)).expand(
            *m.shape[:2], S - n), v[:, n:])
        out = out + torch.where(masked_row, rest, torch.zeros_like(rest))
    if mode == "split":
        out = out / torch.clamp(l, min=1e-30)
    return out, P


def _decode_case(seed, B, S, H, D, slot, bos_only_row=True, masked_row=False):
    q = _rand(seed, (B, 1, H, D))
    k, v = _rand(seed + 1, (B, S, H, D)), _rand(seed + 2, (B, S, H, D))
    valid = torch.ones((B, S), dtype=torch.int32)
    valid[0, max(1, slot - 12):max(1, slot - 4)] = 0     # a padded prompt
    if bos_only_row:
        valid[-1, 1:] = 0                                  # every key masked but BOS
    if masked_row:
        valid[0] = 0                                       # every key masked
    ok = (valid > 0) & (torch.arange(S) <= slot)[None]
    return q, k, v, valid, ok


def _bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 step at |x| (2^-133 at 0)."""
    e = torch.floor(torch.log2(x.abs().clamp(min=2.0 ** -126)))
    return torch.pow(2.0, e - 7)


# --- key ranges, stages and the ring ------------------------------------------------


@pytest.mark.parametrize("S", [1, 5, 16, 37, 294, 295, 352, 4096])
@pytest.mark.parametrize("cs", [1, 2, 4])
def test_key_ranges_cover_every_key_once_in_whole_stages(S, cs):
    ranges = key_ranges(S, cs)
    covered = [c for k0, k1 in ranges for c in range(k0, k1)]
    assert covered == list(range(S))
    assert all(k0 % ROWS == 0 for k0, k1 in ranges if k1 > k0)
    if S == 37 and cs == 4:
        assert [k1 - k0 for k0, k1 in ranges] == [16, 16, 5, 0]   # a CTA with no key


def test_the_cluster_rule_and_the_serving_wave():
    """Serving (768 pairs, S = 295) and generate at 8 rows (256 pairs): one CTA
    a (b, h); generate at 4, 2 and 1 rows: 1, 2 and 4 (the measured best, PERF.md
    §6). Serving's 768 CTAs fit the card in one wave, 6 an SM, which the
    launch bounds ask for; split over a cluster they would not."""
    assert [cluster_size(b * 32) for b in (24, 8, 4, 2, 1)] == [1, 1, 1, 2, 4]
    assert per_sm(295, 1) >= MIN_BLOCKS and 24 * 32 <= 132 * per_sm(295, 1)
    assert 24 * 32 * 2 > 132 * per_sm(295, 2)


@pytest.mark.parametrize("seed", range(4))
def test_three_bf16_terms_hold_an_fp32_value_exactly(seed):
    r = np.random.default_rng(seed)
    x = torch.from_numpy(np.concatenate([
        r.normal(size=4096) * tattn._scale(128),            # q' = q * scale
        np.exp(-r.exponential(8.0, size=4096)),              # p = exp(s - m) in (0, 1]
        r.uniform(-1, 1, size=4096) * 2.0 ** r.integers(-60, 60, size=4096)]).astype(np.float32))
    t0, t1, t2 = bf16_terms(x)
    y = (t0 + t1) + t2
    normal = x.abs() >= 2.0 ** -100      # below, the third term leaves bf16's normal range
    assert torch.equal(y[normal], x[normal])
    assert bool(((y - x).abs() <= 2.0 ** -126).all())        # a p that small weighs nothing
    assert not torch.equal(t0 + t1, x)                       # two terms are not enough


@pytest.mark.parametrize("T,A,cs", [(283, 6, 1), (283, 6, 4), (288, 6, 1), (21, 6, 2)])
def test_a_stage_may_straddle_the_prefill_generated_boundary(T, A, cs):
    """Each row of a stage is copied from its own segment: the rows the ring
    gathers, stage by stage, are [Kp; Kd] in key order."""
    kp, kd = torch.arange(T), 10_000 + torch.arange(A)
    want = torch.cat([kp, kd])
    straddles = 0
    for k0, k1 in key_ranges(T + A, cs):
        for r0 in range(k0, k1, ROWS):
            rows = range(r0, min(r0 + ROWS, k1))
            got = torch.stack([kp[c] if c < T else kd[c - T] for c in rows])
            assert torch.equal(got, want[r0:r0 + len(rows)])
            straddles += rows[0] < T <= rows[-1]
    assert straddles == (T % ROWS != 0 and T // ROWS * ROWS < T + A)


@pytest.mark.parametrize("n", [1, 5, 16, 17, 80, 96, 176, 295])
def test_each_warp_ring_never_reads_a_stage_early_and_v_is_in_flight_under_the_softmax(n):
    """Warp w owns chunks w, w + 4, ... of the CTA's keys: its K chunks, then
    its V chunks, u = 0, 1, ... through its own WARP_STAGES stages. It issues
    u = 0 .. WARP_STAGES - 1, then u + WARP_STAGES once it has read u. Its read
    of u waits on stage u % WARP_STAGES at phase (u // WARP_STAGES) & 1: the
    stage must hold u, landed, its barrier having completed exactly
    u // WARP_STAGES + 1 phases."""
    nch = -(-n // ROWS)
    owned = []
    for w in range(WARPS):
        nk = -(-(nch - w) // WARPS) if nch > w else 0
        total = 2 * nk
        in_stage, phases, issued = {}, [0] * WARP_STAGES, []

        def issue(u):
            st = u % WARP_STAGES
            assert st not in in_stage or in_stage[st] == u - WARP_STAGES, "refilled before read"
            in_stage[st] = u
            phases[st] += 1
            issued.append(u)

        for u in range(min(WARP_STAGES, total)):
            issue(u)
        v_before_softmax = sum(1 for i in issued if i >= nk) if nk == 0 else None
        for u in range(total):
            st = u % WARP_STAGES
            assert in_stage.get(st) == u and phases[st] == u // WARP_STAGES + 1
            if u + WARP_STAGES < total:
                issue(u + WARP_STAGES)
            if u == nk - 1:
                v_before_softmax = sum(1 for i in issued if i >= nk)
        assert issued == list(range(total))
        assert v_before_softmax == min(WARP_STAGES, nk)
        owned += [w + WARPS * i for i in range(nk)]
    assert sorted(owned) == list(range(nch))


# --- the split result equals the plain versions ------------------------------------


@pytest.mark.parametrize("T,A,cs", [(288, 6, 1), (288, 6, 4), (283, 6, 2), (283, 6, 4),
                                    (21, 6, 4), (5, 1, 2)])
def test_split_decode_matches_the_plain_version(T, A, cs):
    """decode_split_attention: one max over both segments across the cluster, p
    never rounded, the sums and partial P·V added in rank order at the
    combine: decode_flash_attention_plain to fp32 rounding (fp32 inputs
    holding bf16 values, so neither side rounds the output)."""
    B, H, D = 3, 2, 128
    q, kp, vp = _rand(1, (B, 1, H, D)), _rand(2, (B, T, H, D)), _rand(3, (B, T, H, D))
    kd, vd = _rand(4, (B, A, H, D)), _rand(5, (B, A, H, D))
    pre = torch.ones((B, T), dtype=torch.int32)
    pre[0, max(1, T - 7):] = 0
    pre[-1, 1:] = 0                                   # every key masked but BOS
    dec = torch.zeros((B, A), dtype=torch.int32)
    dec[:-1, :min(3, A)] = 1
    want = tdec.decode_flash_attention_plain(q.float(), kp.float(), vp.float(), kd.float(),
                                             vd.float(), pre, dec)[:, 0]
    ok = torch.cat([pre, dec], 1) > 0
    got, _ = ring_decode(q[:, 0].float(), torch.cat([kp, kd], 1).float(),
                         torch.cat([vp, vd], 1).float(), ok, "split", cs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[-1], vp[-1, 0].float(), rtol=0, atol=0)


@pytest.mark.parametrize("scores", ["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,slot,cs", [(2, 295, 2, 291, 1), (2, 295, 2, 291, 4),
                                          (2, 352, 2, 335, 4), (2, 352, 2, 335, 2),
                                          (2, 37, 3, 30, 4), (2, 352, 2, 100, 1),
                                          (2, 352, 2, 100, 4)])
def test_decode_attention_matches_the_plain_version(scores, B, S, H, slot, cs):
    """decode_attention over the keys up to the slot: P = bf16(p / l) against
    the joint m and l, fp32 P·V: decode_attention_plain (bf16 inputs, bf16
    out) on all but the rare output whose fp32 sum, taken in another order,
    lands at a bf16 rounding tie (at most one bf16 step there); and P equal
    to the plain version's P but where p / l lands at a tie."""
    D = 128
    q, k, v, valid, ok = _decode_case(10 + cs, B, S, H, D, slot)
    sd = torch.bfloat16 if scores == "bf16" else torch.float32
    want = tattn.decode_attention_plain(q, k, v, valid, slot, sd)[:, 0].float()
    n = ring_keys(S, slot)
    got, P = ring_decode(q[:, 0].float(), k.float(), v.float(), ok, scores, cs, keys=n)
    got = _bf16(got)
    d = (got - want).abs()
    assert bool((d <= _bf16_step(want)).all()), d.max()
    assert (d > 0).float().mean().item() <= 0.01
    # the plain version's P: softmax of its scores in fp32, cast to bf16 (attention_plain)
    mask = torch.where(ok, torch.tensor(0.0), torch.tensor(NEG_INF))[:, None]
    sc = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), k.float()).to(sd)
    sc = (sc * tattn._scale(D) + mask.to(sd)).to(sd)
    p_plain = torch.softmax(sc.float(), dim=-1).to(torch.bfloat16).float()
    assert not bool(p_plain[..., n:].any())               # the keys the ring leaves out
    p_plain = p_plain[..., :n]
    dp = (P - p_plain).abs()
    assert bool((dp <= _bf16_step(p_plain)).all())
    assert (dp > 0).float().mean().item() <= 1e-3
    torch.testing.assert_close(got[-1], v[-1, 0].float(), rtol=0, atol=0)   # BOS only


@pytest.mark.parametrize("S,offset", [(1, 0), (37, 0), (37, 15), (37, 16), (295, 291),
                                      (352, 320), (352, 351), (352, 400), (40, -1)])
@pytest.mark.parametrize("cs", [1, 2, 4])
def test_the_ring_reads_the_keys_up_to_the_query_in_whole_stages(S, offset, cs):
    """decode_attention's ring covers keys [0, min(S, offset + 1)) once, whole
    chunks each, split over the cluster; a query before the first key reads
    none."""
    n = ring_keys(S, offset)
    assert n == max(0, min(S, offset + 1))
    covered = [c for k0, k1 in key_ranges(n, cs) for c in range(k0, k1)]
    assert covered == list(range(n))
    assert all(k0 % ROWS == 0 for k0, k1 in key_ranges(n, cs) if k1 > k0)


@pytest.mark.parametrize("scores", ["fp32", "bf16"])
@pytest.mark.parametrize("S,slot,cs", [(352, 335, 1), (352, 335, 4), (352, 100, 2),
                                       (37, 30, 4)])
def test_a_row_masked_everywhere_takes_every_key(scores, S, slot, cs):
    """A row with no valid key up to the slot: every score is the masked one, so
    the plain version's P is bf16(1 / S) at each of the S keys (the mean of V,
    keys past the slot included). The ring's keys with l = S, then the rest,
    give it within one bf16 step; the ring's keys alone (no tail) do not."""
    B, H, D = 2, 2, 128
    q, k, v, valid, ok = _decode_case(60 + cs, B, S, H, D, slot, bos_only_row=False,
                                      masked_row=True)
    sd = torch.bfloat16 if scores == "bf16" else torch.float32
    want = tattn.decode_attention_plain(q, k, v, valid, slot, sd)[:, 0].float()
    n = ring_keys(S, slot)
    args = (q[:, 0].float(), k.float(), v.float(), ok, scores, cs)
    got = _bf16(ring_decode(*args, keys=n)[0])
    assert bool(((got - want).abs() <= _bf16_step(want)).all())
    torch.testing.assert_close(got[0], _bf16(_bf16(torch.tensor(1.0 / S)) * v[0].float().sum(0)),
                               rtol=0, atol=float(_bf16_step(want[0]).max()))
    no_tail = _bf16(ring_decode(*args, keys=n, tail=False)[0])
    assert (no_tail[0] - want[0]).abs().max().item() > 10 * _bf16_step(want[0]).max().item()


@pytest.mark.parametrize("scores", ["fp32", "bf16"])
@pytest.mark.parametrize("cs", [2, 4])
def test_rounding_p_per_cta_and_rescaling_at_the_combine_is_another_function(scores, cs):
    """Negative control: flash decoding's combine (each CTA rounds P against
    its own max and sum; the partials are rescaled by l_r exp(m_r - m) / l) is
    not decode_attention's function: at generate's S = 352 it moves about
    half the outputs off the plain version's (at least 1 % asserted), 10x or
    more the summed distance of the joint-m-and-l arithmetic (measured: 85x
    and more), which is off only where a sum lands at a rounding tie."""
    B, S, H, D, slot = 4, 352, 4, 128, 335
    q, k, v, valid, ok = _decode_case(40 + cs, B, S, H, D, slot, bos_only_row=False)
    sd = torch.bfloat16 if scores == "bf16" else torch.float32
    want = tattn.decode_attention_plain(q, k, v, valid, slot, sd)[:, 0].float()
    args = (q[:, 0].float(), k.float(), v.float(), ok, scores, cs)
    joint = (_bf16(ring_decode(*args)[0]) - want).abs()
    own = (_bf16(ring_decode(*args, own_softmax=True)[0]) - want).abs()
    assert own.sum().item() >= 10 * max(joint.sum().item(), 1e-12), (own.sum(), joint.sum())
    assert (own > 0).float().mean().item() >= 0.01


# --- the route ------------------------------------------------------------------------


def test_the_ring_route_takes_the_main_paths_layer_slices_and_nothing_unaligned():
    """attention.decode_ring_eligible, the rule both wrappers route by before a
    launch: one layer's bf16 [B, S, 32, 128] slice of the stacked buffers (the
    serving and generate decodes) qualifies; fp32, Dh = 72 and rows off a
    16-byte boundary take the scalar route."""
    stacked = torch.zeros((2, 3, 40, 4, 128), dtype=torch.bfloat16)    # [L, B, S, H, Dh]
    q = torch.zeros((3, 1, 4, 128), dtype=torch.bfloat16)
    k, v = stacked[1], stacked[0, :, :37]
    assert tattn.decode_ring_eligible(q, k, v)
    assert not tattn.decode_ring_eligible(q.float(), k.float(), v.float())
    q72 = torch.zeros((3, 1, 4, 72), dtype=torch.bfloat16)
    assert not tattn.decode_ring_eligible(q72, k[..., :72], v[..., :72])
    flat = torch.zeros((3 * 40 * 4 * 128 + 4,), dtype=torch.bfloat16)
    off = flat[4:].view(3, 40, 4, 128)                                  # 8-byte offset
    assert not tattn.decode_ring_eligible(q, k, off)


@pytest.mark.parametrize("segments,takes", [
    ((295,), True), ((4096,), True), ((4097,), False), ((0,), False),
    ((288, 6), True), ((4090, 6), True), ((4091, 6), False), ((288, 0), False),
    ((0, 6), False)])
def test_the_ring_rule_states_the_key_counts_its_launchers_take(segments, takes):
    """decode_ring_eligible holds the whole of the ring launchers' rule: each
    key segment (decode_attention's one, the split decode's prefill and
    generated keys) at least one key, all of them at most 4096 (a split call
    with no generated key goes to the scalar kernel, which refuses it too)."""
    q = torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16)
    kv = [t for n in segments for t in [torch.zeros((1, n, 2, 128), dtype=torch.bfloat16)] * 2]
    assert tattn.decode_ring_eligible(q, *kv) == takes
