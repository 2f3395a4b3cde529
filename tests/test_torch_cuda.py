"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card. The file imports
neither JAX nor the JAX package, so it also runs where only PyTorch is
installed: ``python -m pytest --noconftest tests/test_torch_cuda.py``.

Tolerances: fp32 inputs 1e-5 (the same fp32 sums in another order); bf16
inputs 2e-2 compared in fp32 (about 2 bf16 ulps at |x| <= 1); flash_prefill
by attention.compare_oneshot (fp32 within 1e-5; bf16 every element within
one bf16 step plus attention.oneshot_slack, the reach of P's rounding to
bf16 when the scores are summed in another order, and at most max(16, 2 %)
of the elements apart). The int8
kernels: wi8_matmul by linear.compare_wi8 (exact products, fp32 sums in
another order, then one bf16 rounding: bf16 every element within one bf16
step and at most max(16, 2 %) apart, fp32 within 1e-4 + 1e-4 |want|); the
fused w8a8 kernels' activation codes within one
step of the plain version's (the fp32 LayerNorm sums run in another order)
and their outputs bit-equal to the plain version's on the kernels' own codes
(equal codes give equal int32 sums and the same epilogue); without a
LayerNorm, bit-equal to the plain version; each call launching exactly its
pre-passes and GEMMs, at the towers' shapes in bf16 and fp32, both routes'
edges (M = 1, 64, 65, 257), N tails and F = 8208. w4a8_matmul: bit-equal to its
plain version (the same activation codes, exact integer sums, the same fold
order and roundings). stacked_decode_attention_i8 (the ring route for bf16 at
Dh = 128, the scalar route otherwise, counted apart): fp32 1e-5, bf16 2e-2,
as the other attention kernels. w8a8_matmul and nib_hi_dot: bit-equal to their
plain versions (the same activation codes, exact integer sums, the same
epilogue roundings in the same order), the nibble loader bit-equal to the
int8 loader on the same codes. w4a8_requant: bit-equal to its plain version
(the requant in PyTorch, then w8a8_matmul_plain: the same int8 codes and row
scales, rebuilt in the kernel's loader). rms_norm_quant: ops.rmsnorm_quant's
compare_rms_norm_quant (codes within one step; every row that differs
reproduced bit for bit by the plain arithmetic with the reciprocal RMS moved
by at most 16 ulps: the fp32 row sums run in another order). decode_attention at bf16 scores: within 4e-3 of the bf16-score
plain version and on average at most a tenth as far from it as from the
fp32-score plain version (attention.compare_bf16_scores). flash_blockwise:
attention.compare_blockwise (fp32 within 1e-5; bf16 every element within one
bf16 step of the plain version and at most max(16, 2 %) of the elements
apart), which the one-shot class (P rounded to bf16) fails on the same inputs.
vit_attention (bf16 on the tensor-core route, the scalar route otherwise,
each launch counted under its route's name): attention.compare_blockwise too.
The decode attentions take their ring route for bf16 at Dh = 128 (counted as
decode_attention / decode_split_attention) and the scalar route otherwise
(``*_scalar``), with the tolerances above, at shapes whose cluster splits
leave ragged key ranges, a CTA with no key, a prefill / generated boundary
inside a 16-key chunk, a query far before the last key (decode_attention's
ring reads the keys up to it), a row whose keys are all masked but BOS (its
output is V's first row) and a row masked everywhere (the mean of all of V),
at the cluster rule and at each cluster size (tools/kernel_ab.py's
``cluster_launchers``). expert_ragged (the tensor-core routes for bf16 x with
O a multiple of 8 and I a multiple of 16 for int8 codes or of 8 for bf16
weights, the prefill route above 64 rows and the decode route at or below;
the scalar route otherwise, counted apart): by
expert_ragged.compare_expert_ragged, every element within one bf16 step of
the plain version (fp32 within 1e-5 of the largest |want|); the LoRA form
within two steps (three roundings); two runs bit-equal.
"""

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import decode_attention as tdec
from openvla_probe_tpu_torch.ops import expert_ragged as texr
from openvla_probe_tpu_torch.ops import linear as tlin
from openvla_probe_tpu_torch.ops import vit_mlp as tmlp
from openvla_probe_tpu_torch.tools import kernel_ab

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _rand(seed, shape, dtype, device):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.normal(size=shape).astype(np.float32)).to(device, dtype)


def _prefill_route(dtype, dh):
    return ("flash_prefill" if dtype == torch.bfloat16 and dh in (64, 128)
            else "flash_prefill_scalar")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,tq,tk,H,dh,offset", [
    (2, 40, 47, 3, 128, 0),     # Tq not a multiple of the row block, Tk past one tile
    (1, 70, 70, 2, 64, 0),
    (1, 33, 1024, 1, 128, 0),   # the longest one-shot key row (largest shared memory)
    (2, 5, 130, 1, 72, 125),    # causal offset; Dh = 72 takes the scalar kernel
    (2, 40, 300, 2, 128, 260),  # causal offset on the tensor-core route, ragged Tk
    (2, 288, 295, 2, 128, 0),   # the serving prefill's Tq | Tk (stacked cache S = T + A)
    (2, 320, 320, 2, 128, 0),   # score_short's
])
def test_flash_prefill_kernel_matches_plain(cuda, dtype, B, tq, tk, H, dh, offset):
    """bf16 at Dh 64 / 128 takes the tensor-core route (flash_prefill), held by
    attention.compare_oneshot with its oneshot_slack; fp32 and other head dims
    the scalar route (flash_prefill_scalar), fp32 within 1e-5. Query rows 0..1
    of the last batch row see no valid key at offset 0 and give the mean of V
    over the Tk keys."""
    q = _rand(0, (B, tq, H, dh), dtype, cuda)
    k = _rand(1, (B, tk, H, dh), dtype, cuda)
    v = _rand(2, (B, tk, H, dh), dtype, cuda)
    valid = torch.ones((B, tk), dtype=torch.int32, device=cuda)
    valid[0, tk - 4:] = 0
    valid[-1, :2] = 0           # with offset 0: query rows 0..1 fully masked
    got = _count(_prefill_route(dtype, dh),
                 lambda: tattn.flash_attention(q, k, v, valid, offset=offset))
    want = tattn.flash_attention_plain(q, k, v, valid, offset=offset)
    tattn.compare_oneshot(got, want, slack=tattn.oneshot_slack(q, k, v, valid, offset))
    if offset == 0:
        mean_v = v[-1].float().mean(0).to(dtype)
        tattn.compare_oneshot(got[-1, :2], mean_v[None].expand(2, H, dh))


def test_flash_prefill_routes_by_the_declared_rule(cuda):
    """bf16 calls outside the tensor-core rule (Dh 72, rows not 16-byte
    aligned) take the scalar kernel, counted apart; the tensor-core launcher
    refuses them itself (no fallback inside it)."""
    valid = torch.ones((2, 50), dtype=torch.int32, device=cuda)
    for q in (_rand(60, (2, 50, 2, 72), torch.bfloat16, cuda),
              _rand(61, (2 * 50 * 2 * 64 + 4,), torch.bfloat16, cuda)[4:].view(2, 50, 2, 64)):
        assert not tattn.prefill_mma_eligible(q, q, q)
        got = _count("flash_prefill_scalar", lambda: tattn.flash_attention(q, q, q, valid))
        tattn.compare_oneshot(got, tattn.flash_attention_plain(q, q, q, valid),
                              slack=tattn.oneshot_slack(q, q, q, valid))
        with pytest.raises(RuntimeError, match="flash_prefill"):
            tattn._launch_flash("flash_prefill", q, q, q, valid, 0, True)


def _vit_route(dtype):
    return "vit_attention" if dtype == torch.bfloat16 else "vit_attention_scalar"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,dh", [
    (2, 261, 3, 64), (2, 256, 2, 72), (1, 13, 2, 16),
    (3, 1, 2, 64), (2, 65, 2, 64), (2, 257, 2, 72),   # ragged: one key, a key past a tile
    (1, 100, 2, 8), (1, 70, 1, 128),
])
def test_vit_kernel_matches_plain(cuda, dtype, B, N, H, dh):
    """bf16 takes the tensor-core route and is held by attention.compare_blockwise
    (every element within one bf16 step, at most max(16, 2 %) apart); fp32 takes
    the scalar route, within 1e-5."""
    qkv = _rand(3, (B * N, 3 * H * dh), dtype, cuda)
    q, k, v = (t.reshape(B, N, H, dh) for t in qkv.split(H * dh, dim=-1))  # strided views
    got = _count(_vit_route(dtype), lambda: tattn.vit_flash_attention(q, k, v))
    tattn.compare_blockwise(got, tattn.vit_flash_attention_plain(q, k, v), kernel="vit_attention")


def test_vit_routes_by_the_declared_rule(cuda):
    """bf16 calls outside the tensor-core rule (Dh not a multiple of 8, rows
    not 16-byte aligned) take the scalar kernel, counted apart."""
    q = _rand(50, (2, 40, 2, 12), torch.bfloat16, cuda)
    got = _count("vit_attention_scalar", lambda: tattn.vit_flash_attention(q, q, q))
    tattn.compare_blockwise(got, tattn.vit_flash_attention_plain(q, q, q), kernel="vit_attention")
    qkv = _rand(51, (2 * 40 * 2 * 64 + 4,), torch.bfloat16, cuda)
    q = qkv[4:].view(2, 40, 2, 64)              # 8-byte offset: not 16-byte aligned
    assert not tattn.vit_mma_eligible(q, q, q)
    got = _count("vit_attention_scalar", lambda: tattn.vit_flash_attention(q, q, q))
    tattn.compare_blockwise(got, tattn.vit_flash_attention_plain(q, q, q), kernel="vit_attention")


def _decode_route(kernel, dtype, dh):
    """The route a decode attention takes (attention.decode_ring_eligible on
    aligned rows): the ring kernel for bf16 at Dh = 128, the scalar kernel
    for the rest, each counted under its own name."""
    return kernel if dtype == torch.bfloat16 and dh == 128 else f"{kernel}_scalar"


# (B, S, H, Dh, slot): B * H decides the cluster (1 CTA a (b, h) from 116 pairs on 132 SMs, 2
# from 58, else 4); S = 295 and 352 are no multiple of the 16-key chunk
DECODE_SHAPES = [
    (3, 295, 4, 128, 290),      # 12 pairs: 4 CTAs of 80, 80, 80, 55 keys
    (24, 295, 32, 128, 291),    # the serving decode: one CTA a (b, h)
    (8, 352, 32, 128, 335),     # generate's: one CTA a (b, h)
    (1, 352, 32, 128, 335),     # generate's single row: 4 CTAs of 96, 96, 96, 64 keys
    (2, 37, 16, 128, 30),       # 4 CTAs of 16, 16, 5 and no key
    (8, 352, 32, 128, 100),     # the query far before the last key: the ring reads 101 keys
    (1, 352, 32, 128, 40),      # the same over a 4-CTA cluster: 16, 16, 9 and no key
    (2, 37, 2, 72, 30),         # Dh = 72: the scalar route
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,dh,slot", DECODE_SHAPES)
def test_decode_kernel_matches_plain(cuda, dtype, tol, B, S, H, dh, slot):
    q = _rand(4, (B, 1, H, dh), dtype, cuda)
    cache_k = _rand(5, (2, B, S, H, dh), dtype, cuda)   # one layer of a stacked cache
    cache_v = _rand(6, (2, B, S, H, dh), dtype, cuda)
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[0, slot - 12:slot - 4] = 0      # a padded prompt
    valid[-1, 1:] = 0                     # every key masked but BOS (the only row where B = 1)
    got = _count(_decode_route("decode_attention", dtype, dh),
                 lambda: tattn.decode_attention(q, cache_k[1], cache_v[1], valid, slot))
    want = tattn.decode_attention_plain(q, cache_k[1], cache_v[1], valid, slot)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got[-1].float(), cache_v[1][-1, :1].float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("scores", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,slot", [(8, 352, 32, 335), (1, 352, 32, 335), (1, 352, 32, 40),
                                        (2, 37, 16, 30)])
def test_decode_row_masked_everywhere_is_the_mean_of_v(cuda, scores, B, S, H, slot):
    """A row with no valid key up to the slot: every key of the S has p = 1, so
    the output is the mean of all of V, keys past the slot included (the ring
    reads those after its own, at every cluster size)."""
    dh = 128
    q = _rand(80, (B, 1, H, dh), torch.bfloat16, cuda)
    k, v = _rand(81, (B, S, H, dh), torch.bfloat16, cuda), _rand(82, (B, S, H, dh), torch.bfloat16, cuda)
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[-1] = 0
    args = (q, k, v, valid, slot, scores)
    got = _count("decode_attention", lambda: tattn.decode_attention(*args))
    want = tattn.decode_attention_plain(*args)
    if scores == torch.bfloat16:
        tattn.compare_bf16_scores(got, want, tattn.decode_attention_plain(*args[:-1]))
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(got[-1].float(), v[-1].float().mean(0, keepdim=True), atol=2e-2,
                               rtol=0)


@pytest.mark.parametrize("kernel", ["decode_attention", "decode_split_attention"])
@pytest.mark.parametrize("B", [1, 3, 24])
def test_decode_cluster_sizes_agree(cuda, kernel, B):
    """The ring launchers at 1, 2 and 4 CTAs a (b, h) (their ``_cs`` entries,
    which time the cluster rule) compute the rule's function: within 2e-2 of
    the plain version, a query at slot 291 of 295 keys (the split decode: 288
    prefill keys, 6 generated); any other size is refused."""
    H, dh = 32, 128
    q = _rand(90, (B, 1, H, dh), torch.bfloat16, cuda)
    k, v = _rand(91, (B, 295, H, dh), torch.bfloat16, cuda), _rand(92, (B, 295, H, dh), torch.bfloat16, cuda)
    valid = torch.ones((B, 295), dtype=torch.int32, device=cuda)
    valid[0, 280:288] = 0
    if kernel == "decode_attention":
        args = (q, k, v, valid, 291, 0)
        call, want = kernel_ab.call_decode_attention, tattn.decode_attention_plain(*args[:-1])
    else:
        args = (q, k[:, :288], v[:, :288], k[:, 288:294], v[:, 288:294],
                valid[:, :288].contiguous(), valid[:, 288:294].contiguous())
        call, want = kernel_ab.call_decode_split, tdec.decode_flash_attention_plain(*args)
    for cs, fn in kernel_ab.cluster_launchers(kernel, sizes=(1, 2, 4, 3)).items():
        if cs == 3:
            with pytest.raises(RuntimeError, match="failed to launch"):
                call(fn, *args)
            continue
        torch.testing.assert_close(call(fn, *args).float(), want.float(), atol=2e-2, rtol=2e-2)


def test_decode_routes_by_the_declared_rule(cuda):
    """bf16 at Dh = 128 with rows off 16-byte alignment takes the scalar
    kernels, counted apart; the ring launchers refuse fp32, other head dims
    and unaligned rows themselves (no fallback inside them)."""
    B, S, H, dh, slot = 2, 40, 2, 128, 35
    k, v = (_rand(seed, (B * S * H * dh + 4,), torch.bfloat16, cuda)[4:].view(B, S, H, dh)
            for seed in (70, 72))                 # 8-byte offsets: not 16-byte aligned
    q = _rand(71, (B, 1, H, dh), torch.bfloat16, cuda)
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    assert not tattn.decode_ring_eligible(q, k, v)
    ka, va = (_rand(seed, (B, S, H, dh), torch.bfloat16, cuda) for seed in (73, 74))
    empty = (q, ka, va, ka[:, :0], va[:, :0], valid, valid[:, :0].contiguous())
    assert not tattn.decode_ring_eligible(*empty[:5])      # no generated key: not the ring's
    before = dict(_build.KERNEL_LAUNCHES)
    with pytest.raises((RuntimeError, ValueError)):
        tdec.decode_flash_attention(*empty)
    assert _build.KERNEL_LAUNCHES == before
    got = _count("decode_attention_scalar", lambda: tattn.decode_attention(q, k, v, valid, slot))
    torch.testing.assert_close(got.float(),
                               tattn.decode_attention_plain(q, k, v, valid, slot).float(),
                               atol=2e-2, rtol=2e-2)
    pre, dec = valid[:, :S - 6].contiguous(), valid[:, :6].contiguous()
    args = (q, k[:, :S - 6], v[:, :S - 6], k[:, S - 6:], v[:, S - 6:], pre, dec)
    got = _count("decode_split_attention_scalar", lambda: tdec.decode_flash_attention(*args))
    torch.testing.assert_close(got.float(), tdec.decode_flash_attention_plain(*args).float(),
                               atol=2e-2, rtol=2e-2)
    out = torch.empty_like(q)
    for qq, kk, dd in ((q.float(), k.float(), dh), (q, k, dh), (q[..., :72], k[..., :72], 72)):
        err = _build.launcher("decode_attention")(
            qq.data_ptr(), kk.data_ptr(), kk.data_ptr(), out.data_ptr(), valid.data_ptr(), B, H, S,
            dd, qq.stride(0), kk.stride(0), kk.stride(1), kk.stride(0), kk.stride(1),
            tattn._scale(dd), slot, 0, int(qq.dtype == torch.bfloat16), _build.stream_ptr(q))
        assert err != 0, (qq.dtype, dd)
    err = _build.launcher("decode_split_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k.data_ptr(), v.data_ptr(), pre.data_ptr(),
        dec.data_ptr(), out.data_ptr(), B, H, S - 6, 6, dh, q.stride(0), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        tattn._scale(dh), 1, _build.stream_ptr(q))
    assert err != 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,tq,tk,H,dh,offset", [
    (2, 40, 1100, 3, 128, 1060),   # ragged last query and key tiles, causal offset
    (1, 130, 1025, 2, 64, 0),      # one key past the one-shot kernel; Dh = 64
    (1, 33, 2048, 1, 128, 2015),   # the Llama position limit
    (2, 5, 1300, 1, 72, 1295),     # Dh = 72 takes the scalar kernel
])
def test_flash_blockwise_kernel_matches_plain(cuda, dtype, B, tq, tk, H, dh, offset):
    q = _rand(40, (B, tq, H, dh), dtype, cuda)
    k = _rand(41, (B, tk, H, dh), dtype, cuda)
    v = _rand(42, (B, tk, H, dh), dtype, cuda)
    valid = torch.ones((B, tk), dtype=torch.int32, device=cuda)
    valid[0, tk - 4:] = 0
    valid[-1, :70] = 0          # a whole masked key tile first; with offset 0, fully masked rows
    got = _count("flash_blockwise", lambda: tattn.flash_attention(q, k, v, valid, offset=offset))
    want = tattn.flash_attention_blockwise_plain(q, k, v, valid, offset=offset)
    tattn.compare_blockwise(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["masked_rows_beside_others", "not_causal", "large_offset",
                                  "right_padded_rows"])
def test_flash_blockwise_tile_skip_cases(cuda, dtype, case):
    """The cases of the key-tile skip (bf16; fp32 takes the scalar kernel): a
    query block whose first rows see no valid key beside rows that do (they
    must get the mean of V over Tk, so the block visits every tile);
    causal=False (nothing skipped); Tq < Tk at a large offset (every tile at or
    below the diagonal); and the score_long case, Tq = Tk = 1088 with
    right-padded rows (the tiles past a row's last valid key skipped)."""
    B, H, dh, causal, offset = 2, 2, 128, True, 0
    tq = tk = 1100
    valid = torch.ones((B, tk), dtype=torch.int32, device=cuda)
    if case == "masked_rows_beside_others":
        valid[-1, :70] = 0      # rows 0..69 of the last batch row see no valid key
    elif case == "not_causal":
        tq, causal = 64, False
        valid[0, 500:] = 0
    elif case == "large_offset":
        tq, tk, offset = 40, 2048, 2000
        valid = torch.ones((B, tk), dtype=torch.int32, device=cuda)
    else:
        tq = tk = 1088
        valid = (torch.arange(tk, device=cuda)[None]
                 < torch.tensor([[1000], [1088]], device=cuda)).int()
    q = _rand(50, (B, tq, H, dh), dtype, cuda)
    k = _rand(51, (B, tk, H, dh), dtype, cuda)
    v = _rand(52, (B, tk, H, dh), dtype, cuda)
    got = _count("flash_blockwise", lambda: tattn.flash_attention_blockwise(
        q, k, v, valid, offset=offset, causal=causal))
    want = tattn.flash_attention_blockwise_plain(q, k, v, valid, offset=offset, causal=causal)
    tattn.compare_blockwise(got, want)
    if case == "masked_rows_beside_others":   # the mean of V over the Tk keys
        mean_v = v[-1].float().mean(0).to(dtype).float()
        tattn.compare_blockwise(got[-1, :70], mean_v[None].expand(70, H, dh).to(dtype))


def test_flash_blockwise_check_refuses_the_one_shot_class(cuda):
    """Negative control: on the inputs the kernel passes with, the one-shot
    function (P rounded to bf16 before PV) fails the same check."""
    B, tq, tk, H, dh = 2, 64, 1100, 4, 128
    q, k, v = (_rand(43 + i, (B, tq if i == 0 else tk, H, dh), torch.bfloat16, cuda)
               for i in range(3))
    valid = torch.ones((B, tk), dtype=torch.int32, device=cuda)
    valid[1, 1000:] = 0
    want = tattn.flash_attention_blockwise_plain(q, k, v, valid, offset=tk - tq)
    got = _count("flash_blockwise", lambda: tattn.flash_attention(q, k, v, valid, offset=tk - tq))
    tattn.compare_blockwise(got, want)
    with pytest.raises(AssertionError, match="blockwise"):
        tattn.compare_blockwise(tattn.flash_attention_plain(q, k, v, valid, offset=tk - tq), want)


def test_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        tattn.vit_flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tattn.vit_flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="kv_valid"):
        tattn.flash_attention(q, q, q, torch.ones((1, 9), device=cuda))
    k = torch.zeros((1, 1100, 2, 8), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="flash_blockwise"):
        tattn.flash_attention(q.half(), k, k, torch.ones((1, 1100), device=cuda))
    k = torch.zeros((1, 1100, 2, 256), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        tattn.flash_attention(k[:, :8], k, k, torch.ones((1, 1100), device=cuda))


def _codes(seed, shape, device):
    r = np.random.default_rng(seed)
    return torch.from_numpy(r.integers(-127, 128, shape).astype(np.int8)).to(device)


def _int8_leaf(seed, n, k, device):
    """Per-channel int8 weights quantized from N(0, 0.02), as the tiers make them."""
    return tlin.quantize_weight(_rand(seed, (n, k), torch.float32, device) * 0.02)


def _count(name, fn):
    before = _build.KERNEL_LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.KERNEL_LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [
    (24, 4096, 4096),       # a decode step's product (the mma.sync route)
    (24, 4096, 32064),      # lm_head: N not a multiple of 128
    (6264, 1152, 1000),     # M and N past the 256-row / 128-column tiles
    (100, 80, 136),         # M > 64 with K past one 64-deep stage
    (5, 48, 40),            # K not a multiple of the staging depth
    (64, 4096, 4096),       # the last M of the mma.sync route
    (65, 4096, 4096),       # the first of the wgmma route
    (6144, 4304, 1152),     # SigLIP's fc2: K = 4304 ends in a partial k tile
])
def test_wi8_kernel_matches_plain(cuda, dtype, M, K, N):
    """bf16 takes the tensor-core kernel (wi8_matmul), fp32 the scalar one
    (wi8_matmul_scalar); both held by linear.compare_wi8."""
    x = _rand(7, (M, K), dtype, cuda)
    q = _codes(8, (N, K), cuda)
    s = _rand(9, (N,), torch.float32, cuda).abs() * 1e-3 + 1e-4
    route = "wi8_matmul" if dtype == torch.bfloat16 else "wi8_matmul_scalar"
    got = _count(route, lambda: tlin.wi8_matmul(x, q, s))
    assert got.dtype == dtype and got.shape == (M, N)
    tlin.compare_wi8(got, tlin.wi8_matmul_plain(x, q, s))


FUSED_LN_SHAPES = [
    (6264, 1024, 3072, "ln"),       # DINOv2 qkv entry
    (6264, 1024, 1024, "res_ls"),   # DINOv2 proj exit
    (6144, 1152, 3456, "ln"),       # SigLIP qkv entry
    (6144, 1152, 1152, "res"),      # SigLIP proj exit
    (37, 48, 80, "ln"),
    (1, 1024, 3072, "ln"),          # one row: the decode route
    (64, 1024, 1024, "res_ls"),     # the last M of the decode route
    (65, 1152, 1152, "res"),        # the first of the wgmma route
    (257, 1152, 3456, "ln"),        # a 256-row tile and one row past it
    (300, 64, 200, "res_ls"),       # an N tail inside a 128-row weight tile
    (100, 64, 36, "res"),           # N no multiple of 8: the stores element by element
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,form", FUSED_LN_SHAPES)
def test_fused_ln_w8a8_kernel_matches_plain(cuda, dtype, M, K, N, form):
    x = _rand(10, (M, K), dtype, cuda)
    w = _int8_leaf(11, N, K, cuda)
    b = _rand(12, (N,), dtype, cuda) * 0.1
    kw = {}
    if form == "ln":
        kw["ln"] = (1 + 0.1 * _rand(13, (K,), dtype, cuda), 0.1 * _rand(14, (K,), dtype, cuda))
    else:
        kw["res"] = _rand(15, (M, N), dtype, cuda)
        if form == "res_ls":
            kw["ls"] = _rand(16, (N,), dtype, cuda)
    got, _ = _count("fused_ln_w8a8", lambda: tmlp.compare_ln_w8a8(x, w, b, **kw))
    want = tmlp.fused_ln_w8a8_plain(x, w, b, **kw)
    assert got.dtype == dtype and got.shape == (M, N)
    if form != "ln":
        assert torch.equal(got, want)


FUSED_MLP_SHAPES = [
    (torch.bfloat16, 6264, 1024, 4096, "gelu_tanh", True),    # DINOv2 (turbo act), LayerScale
    (torch.bfloat16, 6144, 1152, 4304, "gelu_tanh", False),   # SigLIP: F = 16 * 269
    (torch.float32, 6264, 1024, 4096, "gelu_tanh", True),     # both towers in fp32
    (torch.float32, 6144, 1152, 4304, "gelu_tanh", False),
    (torch.bfloat16, 37, 32, 80, "gelu", True),
    (torch.float32, 37, 32, 80, "gelu", True),                # fp32 (the tiny towers)
    (torch.bfloat16, 1, 1024, 4096, "gelu_tanh", True),       # one row: the decode route
    (torch.bfloat16, 64, 1152, 4304, "gelu_tanh", False),     # the decode route's last M
    (torch.bfloat16, 65, 1024, 4096, "quick_gelu", True),     # the wgmma route's first M
    (torch.bfloat16, 257, 1024, 4096, "gelu", True),
    (torch.bfloat16, 257, 1024, 8208, "gelu_tanh", True),     # F past the earlier 8192 limit
    (torch.float32, 300, 64, 8208, "gelu_tanh", True),
]


@pytest.mark.parametrize("dtype,M,D,F,act,layerscale", FUSED_MLP_SHAPES)
def test_fused_mlp_kernel_matches_plain(cuda, dtype, M, D, F, act, layerscale):
    x = _rand(17, (M, D), dtype, cuda)
    ln_s, ln_b = 1 + 0.1 * _rand(18, (D,), dtype, cuda), 0.1 * _rand(19, (D,), dtype, cuda)
    fc1, fc2 = _int8_leaf(20, F, D, cuda), _int8_leaf(21, D, F, cuda)
    b1, b2 = 0.1 * _rand(22, (F,), dtype, cuda), 0.1 * _rand(23, (D,), dtype, cuda)
    ls2 = _rand(24, (D,), dtype, cuda) if layerscale else torch.ones(D, dtype=dtype, device=cuda)
    args = (x, ln_s, ln_b, fc1, b1, fc2, b2, ls2)
    got, _ = _count("fused_mlp_residual", lambda: tmlp.compare_mlp_residual(*args, act=act))
    assert got.dtype == dtype and got.shape == (M, D)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,T,A,H,dh", [
    (3, 288, 6, 4, 128),        # 4 CTAs of 80, 80, 80, 54 keys; T at a chunk's start
    (24, 288, 6, 32, 128),      # the serving decode: one CTA a (b, h), T at a chunk's start
    (2, 283, 6, 32, 128),       # 2 CTAs; the prefill / generated boundary inside a chunk
    (2, 21, 6, 3, 16),          # Dh = 16: the scalar route
])
def test_decode_split_kernel_matches_plain(cuda, dtype, tol, B, T, A, H, dh):
    q = _rand(25, (B, 1, H, dh), dtype, cuda)
    kp, vp = _rand(26, (2, B, T, H, dh), dtype, cuda), _rand(27, (2, B, T, H, dh), dtype, cuda)
    kd, vd = _rand(28, (2, B, A, H, dh), dtype, cuda), _rand(29, (2, B, A, H, dh), dtype, cuda)
    pre = torch.ones((B, T), dtype=torch.int32, device=cuda)
    pre[0, T - 7:] = 0                      # a right-padded prompt
    pre[-1, 1:] = 0                         # the last row: every key masked but BOS
    dec = torch.zeros((B, A), dtype=torch.int32, device=cuda)
    dec[:-1, :3] = 1                        # decode step 2
    args = (q, kp[1], vp[1], kd[1], vd[1], pre, dec)   # one layer of the stacked buffers
    got = _count(_decode_route("decode_split_attention", dtype, dh),
                 lambda: tdec.decode_flash_attention(*args))
    want = tdec.decode_flash_attention_plain(*args)
    assert got.dtype == dtype and got.shape == (B, 1, H, dh)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(got[-1].float(), vp[1][-1, :1].float(), atol=tol, rtol=tol)


def test_fused_tower_calls_launch_their_pre_passes_and_gemms(cuda):
    """Every main-path form of the fused tower kernels, and one row (the
    decode route): one fused_ln_w8a8 call launches its pre-pass and its GEMM
    once; one fused_mlp_residual call its two pre-passes and two GEMMs once;
    nothing else (no fallback, no other kernel)."""
    g = torch.Generator(device=cuda).manual_seed(11)
    for name, (M, K, N, form, _) in kernel_ab.ln_w8a8_forms().items():
        for m in (M, 1):
            x = torch.randn((m, K), generator=g, device=cuda).bfloat16()
            w = tlin.quantize_weight(torch.randn((N, K), generator=g, device=cuda) * 0.02)
            b = torch.zeros(N, dtype=torch.bfloat16, device=cuda)
            kw = ({"ln": (torch.ones(K, dtype=x.dtype, device=cuda), b[:1].expand(K).contiguous())}
                  if form == "ln" else {"res": torch.zeros((m, N), dtype=x.dtype, device=cuda)})
            assert _launch_diff(lambda: tmlp.fused_ln_w8a8(x, w, b, **kw)) == {
                "fused_ln_w8a8_quant_rows": 1, "fused_ln_w8a8": 1}, (name, m)
    for name, (M, D, F, _, _) in kernel_ab.mlp_towers().items():
        for m in (M, 1):
            x = torch.randn((m, D), generator=g, device=cuda).bfloat16()
            ones, zd, zf = (torch.ones(D, dtype=x.dtype, device=cuda),
                            torch.zeros(D, dtype=x.dtype, device=cuda),
                            torch.zeros(F, dtype=x.dtype, device=cuda))
            fc1 = tlin.quantize_weight(torch.randn((F, D), generator=g, device=cuda) * 0.02)
            fc2 = tlin.quantize_weight(torch.randn((D, F), generator=g, device=cuda) * 0.02)
            assert _launch_diff(lambda: tmlp.fused_mlp_residual(
                x, ones, zd, fc1, zf, fc2, zd, ones)) == {
                "fused_mlp_ln_quant_rows": 1, "fused_mlp_fc1": 1, "fused_mlp_quant_rows": 1,
                "fused_mlp_residual": 1}, (name, m)


def test_fused_tower_launchers_refuse_what_they_cannot_take(cuda):
    """The C launchers return cudaErrorInvalidValue (1), launching nothing,
    without the code buffers the pre-passes write (the earlier kernels took
    null ones) or for an x off 16-byte alignment; the wrappers raise first."""
    x = torch.zeros((4 * 64 + 8,), dtype=torch.bfloat16, device=cuda)
    w = {"q": torch.zeros((8, 64), dtype=torch.int8, device=cuda), "s": torch.ones(8, device=cuda)}
    b = torch.zeros(8, dtype=torch.bfloat16, device=cuda)
    out = torch.empty((4, 8), dtype=torch.bfloat16, device=cuda)
    codes = torch.empty((4, 64), dtype=torch.int8, device=cuda)
    sx = torch.empty(4, device=cuda)
    fn = _build.launcher("fused_ln_w8a8")
    args = [x.data_ptr(), None, None, w["q"].data_ptr(), w["s"].data_ptr(), b.data_ptr(), None,
            None, out.data_ptr(), 4, 64, 8, 1e-6, codes.data_ptr(), sx.data_ptr(), 1,
            _build.stream_ptr(x)]
    assert fn(*args[:13], None, None, *args[15:]) == 1
    assert fn(x[1:].data_ptr(), *args[1:]) == 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        tmlp.fused_ln_w8a8(x[4:4 + 4 * 64].view(4, 64), w, b)


def test_int8_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 40), dtype=torch.bfloat16, device=cuda)
    q = torch.zeros((8, 40), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        tlin.wi8_matmul(x, q, torch.ones(8, device=cuda))
    x = torch.zeros((4, 32), dtype=torch.float16, device=cuda)
    w = {"q": torch.zeros((8, 32), dtype=torch.int8, device=cuda), "s": torch.ones(8, device=cuda)}
    with pytest.raises(TypeError):
        tmlp.fused_ln_w8a8(x, w, torch.zeros(8, dtype=torch.float16, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N,gsz", [
    (5, 256, 128, 128),         # small M, two groups
    (24, 4096, 4096, 128),      # a decode step's product: 32 groups
    (24, 512, 384, 256),        # two 256-wide groups (two chunks per group)
    (100, 384, 256, 128),       # M > 64 past one 128-row tile
    (6264, 1024, 1024, 128),    # DINOv2 proj: M past the last tile
    (64, 1024, 512, 128),       # the last M of the decode route
    (65, 1024, 512, 128),       # the first M of the wgmma route
    (128, 1024, 512, 128),      # one whole 128-row tile
    (200, 1024, 256, 256),      # wgmma route, 256-wide groups (two chunks per group)
    (24, 11008, 4096, 128),     # down_proj at decode: 86 groups
    (2560, 11008, 4096, 128),   # down_proj in a train step
    (6912, 4096, 11008, 128),   # gate/up at prefill
    (24, 4096, 4096, 256),      # decode, 2 chunks a group: waves of 6 groups in the ring
    (24, 2048, 2048, 512),      # decode, 4 chunks a group: waves of 3
    (64, 4096, 4096, 512),
    (8, 4096, 1024, 1024),      # decode, 8 chunks a group: one warp a wave
    (24, 4096, 512, 2048),      # decode, a group longer than the ring
    (24, 12288, 256, 128),      # an fp32 row of 48 KB: the pre-pass reads it twice
    (100, 12288, 256, 128),
])
def test_w4a8_kernel_bit_equal_to_plain(cuda, dtype, M, K, N, gsz):
    x = _rand(30, (M, K), dtype, cuda)
    w = tlin.quantize_weight_int4(_rand(31, (N, K), torch.float32, cuda) * 0.02, group_size=gsz)
    got = _count("w4a8_matmul", lambda: tlin.w4a8_matmul(x, w["q"], w["s"]))
    want = tlin.w4a8_matmul_plain(x, w["q"], w["s"])
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S,H,Hkv,dh,n", [
    (3, 320, 4, 4, 128, None),   # the 7B slot count and head dim: 12 pairs, 4-CTA clusters
    (24, 320, 32, 32, 128, 292), # the serving decode at step 4: slots up to the query only
    (2, 320, 8, 2, 128, 291),    # GQA n_rep = 4 on the ring route
    (1, 320, 16, 2, 128, 300),   # n_rep = 8, 2 pairs
    (9, 100, 16, 8, 128, 77),    # n_rep = 2, 72 pairs: 2-CTA clusters
    (2, 40, 4, 2, 16, None),     # GQA n_rep = 2, tiny heads
    (2, 100, 8, 1, 64, 60),      # n_rep = 8
    (1, 33, 2, 2, 32, None),
])
def test_stacked_decode_kernel_matches_plain(cuda, dtype, tol, B, S, H, Hkv, dh, n):
    """Both routes (the ring kernel for bf16 at Dh = 128, the scalar kernel for
    the rest, counted apart) against the plain version, with the slots past
    `n` read by neither; the last row masked everywhere (the mean of V over
    all S) and the first with a padded prompt."""
    L, li = 3, 1
    r = np.random.default_rng(32)
    kq, vq = (torch.from_numpy(r.integers(-127, 128, (L, B, S, Hkv * dh)).astype(np.int8)).to(cuda)
              for _ in range(2))
    ks, vs = (torch.from_numpy(r.uniform(1e-3, 2e-2, (L, B, S, Hkv)).astype(np.float32)).to(cuda)
              for _ in range(2))
    q = _rand(33, (B, 1, H, dh), dtype, cuda)
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    last = S if n is None else n
    valid[:, last:] = 0                    # the slots past the query are masked
    valid[0, last // 2:last - 3] = 0       # a padded prompt before the generated slots
    if B > 1:
        valid[-1] = 0                      # a row masked everywhere
    args = (q, kq, ks, vq, vs, valid, li, n)
    route = _decode_route("stacked_decode_attention_i8", dtype, dh)
    got = _count(route, lambda: tdec.stacked_decode_attention_i8(*args))
    want = tdec.stacked_decode_attention_i8_plain(*args)
    assert got.dtype == dtype and got.shape == (B, 1, H, dh)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)
    assert torch.equal(want, tdec.stacked_decode_attention_i8_plain(*args[:-1]))


@pytest.mark.parametrize("cs", [1, 2, 4])
def test_stacked_ring_at_each_cluster_size(cuda, cs):
    """The ring route's launcher at 1, 2 and 4 CTAs a (b, kv head) (uncounted),
    at the serving slots with ragged key ranges, against the plain version."""
    B, S, H, n = 3, 320, 4, 293
    r = np.random.default_rng(40 + cs)
    kq, vq = (torch.from_numpy(r.integers(-127, 128, (1, B, S, H * 128)).astype(np.int8)).to(cuda)
              for _ in range(2))
    ks, vs = (torch.from_numpy(r.uniform(1e-3, 2e-2, (1, B, S, H)).astype(np.float32)).to(cuda)
              for _ in range(2))
    q = _rand(41, (B, 1, H, 128), torch.bfloat16, cuda)
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[:, n:] = 0
    valid[-1] = 0
    out = torch.empty_like(q)
    fn = kernel_ab.cluster_launchers("stacked_decode_attention_i8")[cs]
    _build.check(fn(q.data_ptr(), kq[0].data_ptr(), ks[0].data_ptr(), vq[0].data_ptr(),
                    vs[0].data_ptr(), valid.data_ptr(), out.data_ptr(), B, H, H, S, 128, n,
                    tattn._scale(128), 1, _build.stream_ptr(q)), "stacked_decode_attention_i8")
    torch.cuda.synchronize()
    want = tdec.stacked_decode_attention_i8_plain(q, kq, ks, vq, vs, valid, 0, n)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2, rtol=2e-2)


def test_stacked_ring_launcher_refuses_what_it_does_not_take(cuda):
    q32 = torch.zeros((2, 1, 2, 128), device=cuda)
    kq = torch.zeros((1, 2, 8, 256), dtype=torch.int8, device=cuda)
    ks = torch.ones((1, 2, 8, 2), device=cuda)
    valid = torch.ones((2, 8), dtype=torch.int32, device=cuda)
    fn = _build.launcher("stacked_decode_attention_i8")
    for q, n, bf16 in ((q32, 8, 0), (q32.bfloat16(), 0, 1), (q32.bfloat16(), 9, 1)):
        err = fn(q.data_ptr(), kq.data_ptr(), ks.data_ptr(), kq.data_ptr(), ks.data_ptr(),
                 valid.data_ptr(), q.data_ptr(), 2, 2, 2, 8, 128, n, 0.1, bf16,
                 _build.stream_ptr(q))
        assert err != 0


def test_new_kernels_fail_loudly_on_bad_shapes(cuda):
    x = torch.zeros((4, 256), dtype=torch.bfloat16, device=cuda)
    w = tlin.quantize_weight_int4(torch.ones((200, 256), device=cuda))
    with pytest.raises(ValueError, match="multiples of 128"):      # N = 200
        tlin.w4a8_matmul(x, w["q"], w["s"])
    # the launcher itself refuses what the wrapper would not pass, and the
    # wrapper's check turns its error code into an exception
    scratch = torch.empty((4, 256), dtype=torch.int8, device=cuda)
    err = _build.launcher("w4a8_matmul")(
        x.data_ptr(), w["q"].data_ptr(), w["s"].data_ptr(), x.data_ptr(), scratch.data_ptr(),
        scratch.data_ptr(), 4, 200, 256, 128, 1, _build.stream_ptr(x))
    with pytest.raises(RuntimeError, match="w4a8_matmul"):
        _build.check(err, "w4a8_matmul")
    q = torch.zeros((2, 1, 2, 72), dtype=torch.bfloat16, device=cuda)
    kq = torch.zeros((1, 2, 8, 144), dtype=torch.int8, device=cuda)
    ks = torch.ones((1, 2, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="head dim 72"):
        tdec.stacked_decode_attention_i8(q, kq, ks, kq, ks, torch.ones((2, 8), device=cuda), 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dh,slot", [*[s for s in DECODE_SHAPES if s[3] == 128],
                                          (4, 37, 8, 72, 30)])
def test_decode_kernel_bf16_scores_match_plain(cuda, dtype, B, S, H, dh, slot):
    """The turbo stacked decode's bf16 scores, held to the bf16-score plain
    version (attention.compare_bf16_scores)."""
    q = _rand(34, (B, 1, H, dh), dtype, cuda)
    cache_k, cache_v = _rand(35, (2, B, S, H, dh), dtype, cuda), _rand(36, (2, B, S, H, dh), dtype, cuda)
    valid = torch.ones((B, S), dtype=torch.int32, device=cuda)
    valid[0, slot - 12:slot - 4] = 0
    args = (q, cache_k[1], cache_v[1], valid, slot)
    got = _count(_decode_route("decode_attention", dtype, dh),
                 lambda: tattn.decode_attention(*args, torch.bfloat16))
    tattn.compare_bf16_scores(got, tattn.decode_attention_plain(*args, torch.bfloat16),
                              tattn.decode_attention_plain(*args, torch.float32))


W8A8_SHAPES = [
    (24, 4096, 4096),       # a turbo decode step's product (the split-K decode route)
    (24, 4096, 32064),      # lm_head: N = 64 * 501, not a multiple of 128
    (6144, 1152, 4304),     # SigLIP fc1: N = 16 * 269
    (6144, 4304, 1152),     # SigLIP fc2: K = 4304 not a multiple of 32 (zero-filled k tail)
    (100, 80, 136),         # M > 64 past one tile, K and N tails
    (5, 48, 40),
    (1, 4096, 4096),        # one row (the decode route's first row block, 31 rows zero-filled)
    (64, 4096, 4096),       # the last M of the decode route (two row blocks)
    (65, 4096, 4096),       # the first M of the wgmma route
    (2560, 4096, 4096),     # a train_int8 step's rows
    (6264, 1024, 1024),     # DINOv2: M past the last 256-row tile
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", W8A8_SHAPES)
def test_w8a8_kernel_bit_equal_to_plain(cuda, dtype, M, K, N):
    x = _rand(37, (M, K), dtype, cuda)
    w = _int8_leaf(38, N, K, cuda)
    pre_passes = _build.KERNEL_LAUNCHES["w8a8_quant_rows"]
    got = _count("w8a8_matmul", lambda: tlin.w8a8_matmul(x, w))
    want = tlin.w8a8_matmul_plain(x, w)
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, want)
    codes, sx = tlin.quantize_rows(x.float())          # the prequant entry, on the same codes
    pre = tlin.PrequantActivation(codes, sx, dtype)
    assert torch.equal(_count("w8a8_matmul", lambda: tlin.w8a8_matmul(pre, w)), want)
    assert _build.KERNEL_LAUNCHES["w8a8_quant_rows"] == pre_passes + 1   # none for prequant


@pytest.mark.parametrize("M,K,N", [(6912, 4096, 4096), (40, 11008, 264), (33, 64, 40),
                                   (1, 4096, 4096), (32, 4096, 4096), (64, 4096, 4096),
                                   (65, 4096, 4096), (2560, 4096, 4096), (200, 96, 136)])
def test_w8a8_nibble_loader_bit_equal_to_int8(cuda, M, K, N):
    """The nibble loader (wgmma above M = 64, the split-K decode route at and
    below; M = 32 / 33 is nib_matmul's NIB_HI_M_MAX edge): the planes' codes
    rebuilt in the loader give the int8 leaf's output bit for bit."""
    x = _rand(39, (M, K), torch.bfloat16, cuda)
    wf = _rand(40, (N, K), torch.float32, cuda) * 0.02
    nib, int8 = tlin.quantize_weight_nibble(wf), tlin.quantize_weight(wf)
    got = _count("w8a8_matmul", lambda: tlin.w8a8_matmul(x, nib))
    assert torch.equal(got, tlin.w8a8_matmul(x, int8))
    assert torch.equal(got, tlin.w8a8_matmul_plain(x, nib))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(24, 4096, 4096), (24, 11008, 4096), (32, 4096, 32064),
                                   (5, 96, 40), (1, 4096, 4096), (33, 4096, 4096),
                                   (65, 96, 40), (2560, 4096, 4096)])
def test_nib_hi_dot_kernel_bit_equal_to_plain(cuda, dtype, M, K, N):
    x = _rand(41, (M, K), dtype, cuda)
    w = tlin.quantize_weight_nibble(_rand(42, (N, K), torch.float32, cuda) * 0.02)
    got = _count("nib_hi_dot", lambda: tlin.nib_hi_dot(x, w["hi"], w["s"]))
    want = tlin.nib_hi_dot_plain(x, w["hi"], w["s"])
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, want)


def _launch_diff(fn) -> dict:
    before = dict(_build.KERNEL_LAUNCHES)
    fn()
    torch.cuda.synchronize()
    return {k: n - before[k] for k, n in _build.KERNEL_LAUNCHES.items() if n != before[k]}


def test_int8_gemms_take_their_routes_at_every_main_path_shape(cuda):
    """Every (M, K, N) the turbo, turbo_nibble and train_int8 paths give
    w8a8_matmul, in each entry the shape takes (bf16 x, the fused norm's
    codes, nibble planes), and every turbo_nibble decode shape of nib_hi_dot:
    one launch of the kernel and one of its pre-pass (none on the prequant
    entry) and nothing else: no other route exists, and no call falls back."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for (M, K, N), n in kernel_ab.w8a8_shapes().items():
        x = torch.randn((M, K), generator=g, device=cuda).bfloat16()
        w = tlin.quantize_weight(torch.randn((N, K), generator=g, device=cuda) * 0.02)
        assert _launch_diff(lambda: tlin.w8a8_matmul(x, w)) == {"w8a8_matmul": 1,
                                                               "w8a8_quant_rows": 1}
        if n["turbo_pre"]:
            pre = tlin.PrequantActivation(*tlin.quantize_rows(x.float()), x.dtype)
            assert _launch_diff(lambda: tlin.w8a8_matmul(pre, w)) == {"w8a8_matmul": 1}
        if n["nibble_prefill"]:
            nib = kernel_ab.nibble_of(w)
            assert _launch_diff(lambda: tlin.w8a8_matmul(x, nib)) == {"w8a8_matmul": 1,
                                                                     "w8a8_quant_rows": 1}
    for (M, K, N) in kernel_ab.nib_hi_shapes():
        x = torch.randn((M, K), generator=g, device=cuda).bfloat16()
        w = tlin.quantize_weight_nibble(torch.randn((N, K), generator=g, device=cuda) * 0.02)
        assert _launch_diff(lambda: tlin.nib_hi_dot(x, w["hi"], w["s"])) == {
            "nib_hi_dot": 1, "nib_hi_quant_rows": 1}


def test_int8_gemm_launchers_refuse_what_their_tensor_maps_cannot_take(cuda):
    """The C launchers return cudaErrorInvalidValue (1), launching nothing,
    for a pointer off the 16-byte alignment the TMA maps need, and the
    wrappers check it before the launch."""
    x = torch.zeros((4, 64 + 16), dtype=torch.bfloat16, device=cuda)[:, 8:].contiguous()
    w = {"q": torch.zeros((8, 64), dtype=torch.int8, device=cuda), "s": torch.ones(8, device=cuda)}
    codes = torch.empty(4 * 64 + 1, dtype=torch.int8, device=cuda)
    sx = torch.empty(4, device=cuda)
    out = torch.empty((4, 8), dtype=torch.bfloat16, device=cuda)
    fn = _build.launcher("w8a8_matmul")
    assert fn(x.data_ptr(), codes[1:].data_ptr(), sx.data_ptr(), w["q"].data_ptr(), 0,
              w["s"].data_ptr(), out.data_ptr(), 4, 8, 64, 2, 1, _build.stream_ptr(x)) == 1
    rowsum = torch.empty(4, dtype=torch.int32, device=cuda)
    hi = torch.zeros((8 * 32 + 1,), dtype=torch.uint8, device=cuda)
    assert _build.launcher("nib_hi_dot")(
        x.data_ptr(), hi[1:].data_ptr(), w["s"].data_ptr(), out.data_ptr(), codes.data_ptr(),
        sx.data_ptr(), rowsum.data_ptr(), 4, 8, 64, 1, _build.stream_ptr(x)) == 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        tlin.w8a8_matmul(tlin.PrequantActivation(codes[1:].view(4, 64), sx[:, None], x.dtype), w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D", [(6912, 4096), (24, 4096), (37, 64), (1, 4096), (24, 128),
                                 (24, 4095), (6912, 999), (5, 12288)])
def test_rms_norm_quant_kernel_matches_plain(cuda, dtype, M, D):
    from openvla_probe_tpu_torch.ops import rmsnorm_quant as trmsq

    x = _rand(43, (M, D), dtype, cuda) * 3
    w = 1 + 0.2 * _rand(44, (D,), dtype, cuda)
    q, sx = _count("rms_norm_quant", lambda: trmsq.rms_norm_quant(x, w, 1e-5))
    wq, wsx = trmsq.rms_norm_quant_plain(x, w, 1e-5)
    assert q.dtype == torch.int8 and q.shape == (M, D) and sx.shape == (M, 1)
    trmsq.compare_rms_norm_quant(x, w, 1e-5, (q, sx), (wq, wsx))


# --- the int4 requant route: w4a8_requant, bit for bit -------------------------------

REQUANT_SHAPES = [
    (24, 32064, 32, 128),      # lm_head at decode (the split-K route)
    (6144, 4304, 9, 128),      # SigLIP fc1 (the wgmma route; N = 4304 not a multiple of 32)
    (2560, 32064, 32, 128),    # lm_head in a train_int4 step
    *[(M, N, 32, 128) for M in (1, 24, 64, 65) for N in (200, 4304)],   # the routes' edge
    (24, 200, 9, 32), (100, 136, 9, 64), (5, 40, 9, 96), (200, 200, 3, 96),   # group sizes
]


# what the caching allocator may add to a call's allocations: it hands out a
# cached block whole where less than 1 MiB of it would be left over
ALLOC_SLACK = 3 << 20


def _int4_groups(seed, G, N, gsz, device):
    """Codes in [-8, 7] packed; scales with a fifth of the rows at the 1e-8 floor."""
    r = np.random.default_rng(seed)
    codes = torch.from_numpy(r.integers(-8, 8, (G, N, gsz)).astype(np.int8))
    s = torch.from_numpy((r.random((N, G)) * 2e-3 + 2e-3).astype(np.float32))
    s[: N // 5] = 1e-8
    return tlin.pack_int4(codes).to(device), s.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,G,gsz", REQUANT_SHAPES)
def test_w4a8_requant_kernel_bit_equal_to_plain(cuda, dtype, M, N, G, gsz):
    """One pre-pass and one GEMM launch a call, nothing allocated but the
    output and the pre-pass's codes and scales (within the allocator's slack;
    an [N, K] int8 copy, past that slack at the 7B shapes, would show), and
    the output of the requant in PyTorch, then w8a8_matmul_plain, bit for bit."""
    K = G * gsz
    x = _rand(50, (M, K), dtype, cuda)
    q, s = _int4_groups(51, G, N, gsz, cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = dict(_build.KERNEL_LAUNCHES)
    got = tlin.w4a8_requant(x, q, s)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in _build.KERNEL_LAUNCHES.items() if n != before[k]}
    assert launched == {"w4a8_requant_quant_rows": 1, "w4a8_requant": 1}
    rise = torch.cuda.max_memory_allocated() - base - got.numel() * got.element_size()
    assert rise <= M * K + 4 * M + ALLOC_SLACK, rise
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, tlin.w4a8_requant_plain(x, q, s))


def test_w4a8_requant_refuses_what_it_does_not_take(cuda):
    """A group size that is not a multiple of 32 raises (no ported leaf has
    one); the launcher refuses a pointer off 16-byte alignment."""
    x = torch.zeros((4, 96), dtype=torch.bfloat16, device=cuda)
    q, s = _int4_groups(52, 2, 8, 48, cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        tlin.w4a8_requant(x, q, s)
    q, s = _int4_groups(53, 3, 8, 32, cuda)
    raw = torch.zeros(q.numel() + 1, dtype=torch.uint8, device=cuda)
    codes = torch.empty((4, 96), dtype=torch.int8, device=cuda)
    sx = torch.empty(4, device=cuda)
    out = torch.empty((4, 8), dtype=torch.bfloat16, device=cuda)
    assert _build.launcher("w4a8_requant")(
        x.data_ptr(), codes.data_ptr(), sx.data_ptr(), raw[1:].data_ptr(), s.data_ptr(),
        out.data_ptr(), 4, 8, 3, 32, 1, _build.stream_ptr(x)) == 1


@pytest.mark.parametrize("M", [24, 96])
def test_requant_route_alone_under_grad_matches_the_cpu(cuda, M):
    """w4a8_dot_requant called under grad: the kernel forward, dx through the
    requantized codes' bf16 dequantized weight, as on the CPU."""
    q, s = _int4_groups(54, 2, 200, 128, "cpu")
    x = _rand(55, (M, 256), torch.float32, "cpu")
    gout = _rand(56, (M, 200), torch.float32, "cpu")

    def run(dev):
        xx = x.to(dev).requires_grad_(True)
        out = tlin.w4a8_dot_requant(xx, q.to(dev), s.to(dev))
        (dx,) = torch.autograd.grad((out * gout.to(dev)).sum(), xx)
        return out.detach().cpu(), dx.cpu()

    before = _build.KERNEL_LAUNCHES["w4a8_requant"]
    (out, dx), (want_out, want_dx) = run(cuda), run("cpu")
    assert _build.KERNEL_LAUNCHES["w4a8_requant"] == before + 1
    assert torch.equal(out, want_out)
    torch.testing.assert_close(dx, want_dx, atol=1e-5 * want_dx.abs().max().item(), rtol=0)


def test_turbo_wrappers_raise_on_inputs_the_kernels_do_not_take(cuda):
    x = torch.zeros((4, 40), dtype=torch.bfloat16, device=cuda)
    w = {"q": torch.zeros((8, 40), dtype=torch.int8, device=cuda), "s": torch.ones(8, device=cuda)}
    with pytest.raises(ValueError, match="multiple of 16"):
        tlin.w8a8_matmul(x, w)
    x = torch.zeros((4, 48), dtype=torch.bfloat16, device=cuda)
    nib = tlin.quantize_weight_nibble(torch.ones((8, 48), device=cuda))
    with pytest.raises(ValueError, match="multiple of 32"):
        tlin.nib_hi_dot(x, nib["hi"], nib["s"])
    with pytest.raises(ValueError, match="multiple of 32"):
        tlin.w8a8_matmul(torch.zeros((40, 48), dtype=torch.bfloat16, device=cuda), nib)


# --- training: the w4a8 STE backward (Queue 2 row 9), the STEs, ViT past 1024 --------
#
# w4a8_dx: linear.compare_w4a8_dx (fp32 within 1e-5 of the largest output;
# bf16 every element within one bf16 step and at most 2 % of them apart: the
# same bf16 products summed in fp32 in another order). The STE Functions:
# their forwards are the bit-equal kernels, their backwards library products
# (w4a8_dx where its rule says so), so card grads are within 1e-5 of the CPU's
# relative to the largest (fp32 sums in another order).


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,G,gsz", [
    (2560, 4096, 32, 128),     # q/k/v/o at the 7B QLoRA shape
    (300, 11008, 4, 128),      # gate/up's N, a ragged M, a slice of the groups
    (77, 256, 3, 256),         # gsz 256: two column tiles per group
    (1, 128, 1, 128),
    (100, 4096, 86, 128),      # down_proj's 86 groups, a ragged M
    (2500, 256, 2, 128),       # M past 128-row tiles, ragged
    (1, 4096, 5, 128),
    (130, 128, 3, 128),        # N = 128: two chunks, shallower than the ring
])
def test_w4a8_dx_kernel_matches_plain(cuda, dtype, M, N, G, gsz):
    g = _rand(40, (M, N), dtype, cuda)
    w = tlin.quantize_weight_int4(_rand(41, (N, G * gsz), torch.float32, cuda) * 0.02,
                                  group_size=gsz)
    got = _count("w4a8_dx", lambda: tlin.w4a8_dx(g, w["q"], w["s"]))
    assert got.dtype == dtype and got.shape == (M, G * gsz)
    tlin.compare_w4a8_dx(got, tlin.w4a8_dx_plain(g, w["q"], w["s"]))


def test_w4a8_dx_outside_the_kernel_rule_takes_the_dequant_product(cuda):
    g = _rand(42, (40, 200), torch.bfloat16, cuda)     # N = 200: no 128 tile
    w = tlin.quantize_weight_int4(_rand(43, (200, 256), torch.float32, cuda) * 0.02)
    before = _build.KERNEL_LAUNCHES["w4a8_dx"]
    got = tlin.w4a8_dx(g, w["q"], w["s"])
    assert _build.KERNEL_LAUNCHES["w4a8_dx"] == before
    torch.testing.assert_close(got, tlin.w4a8_dx_xla(g, w["q"], w["s"]), atol=0, rtol=0)


def _route_leaf(route, cuda):
    r = _rand(44, (384, 256), torch.float32, "cpu") * 0.02
    if route == "int4_kernel":
        return tlin.quantize_weight_int4(r), "wi8"
    if route == "int4_requant":
        return tlin.quantize_weight_int4(r[:200]), "wi8"
    if route == "w8a8":
        return tlin.quantize_weight(r), "w8a8"
    return tlin.quantize_weight_nibble(r), "w8a8"


@pytest.mark.parametrize("route", ["int4_kernel", "int4_requant", "w8a8", "nibble"])
@pytest.mark.parametrize("M", [24, 96])
def test_ste_grads_on_the_card_match_the_cpu(cuda, route, M):
    w, int8_route = _route_leaf(route, cuda)
    wd = {k: v.to(cuda) for k, v in w.items()}
    x = _rand(45, (M, 256), torch.float32, "cpu")
    gout = _rand(46, (M, w["s"].shape[0]), torch.float32, "cpu")

    def grad(xx, ww):
        xx = xx.clone().requires_grad_(True)
        (dx,) = torch.autograd.grad((tlin.matmul_t(xx, ww, int8_route) * gout.to(xx.device)).sum(),
                                    xx)
        return dx

    got, want = grad(x.to(cuda), wd).cpu(), grad(x, w)
    torch.testing.assert_close(got, want, atol=1e-5 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1370, 2100])
def test_vit_kernel_past_1024_tokens(cuda, dtype, N):
    """DINOv2-L at 518 px (37 x 37 patches + CLS = 1370 tokens) and 2100: the
    flash kernel streams any N; the scalar kernel takes key chunks of at most
    1024 with the online rescale."""
    B, H, dh = 2, 2, 64
    qkv = _rand(47, (B * N, 3 * H * dh), dtype, cuda)
    q, k, v = (t.reshape(B, N, H, dh) for t in qkv.split(H * dh, dim=-1))
    got = _count(_vit_route(dtype), lambda: tattn.vit_flash_attention(q, k, v))
    tattn.compare_blockwise(got, tattn.vit_flash_attention_plain(q, k, v), kernel="vit_attention")


def test_wrappers_refuse_grad_on_the_card(cuda):
    x = _rand(48, (32, 128), torch.bfloat16, cuda).requires_grad_(True)
    w = tlin.quantize_weight_int4(_rand(49, (128, 128), torch.float32, cuda) * 0.02)
    with pytest.raises(RuntimeError, match="w4a8_matmul_ste"):
        tlin.w4a8_matmul(x, w["q"], w["s"])
    with torch.no_grad():
        tlin.w4a8_matmul(x, w["q"], w["s"])


# --- w4a8_grouped and split_attention_i8 ----------------------------------------------------

GROUPED_SHAPES = [
    (24, 4096, 32, 128), (24, 32064, 32, 128), (24, 4096, 86, 128),    # the 7B decode shapes
    (24, 11008, 32, 128),
    (1, 200, 2, 128), (32, 136, 9, 32), (33, 40, 3, 64), (5, 200, 9, 96),  # edges, group sizes
    (70, 136, 4, 256), (24, 8, 1, 32),
    (32, 4104, 3, 128),    # N past a tile edge, fewer chunks than fold classes
    (70, 32064, 5, 64),    # three row blocks of lm_head's tiles: clusters walk several tiles
    (1, 40, 13, 32),       # one row, 13 chunks of 32-deep groups
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N,G,gsz", GROUPED_SHAPES)
def test_w4a8_grouped_kernel_bit_equal_to_plain(cuda, dtype, M, N, G, gsz):
    """One pre-pass and one GEMM launch a call and the plain version's output
    bit for bit (the same codes, exact group sums, the same fp32 fold order)."""
    x = _rand(60, (M, G * gsz), dtype, cuda)
    q, s = _int4_groups(61, G, N, gsz, cuda)
    before = dict(_build.KERNEL_LAUNCHES)
    got = tlin.w4a8_grouped(x, q, s)
    torch.cuda.synchronize()
    launched = {k: n - before[k] for k, n in _build.KERNEL_LAUNCHES.items() if n != before[k]}
    assert launched == {"w4a8_grouped_quant_rows": 1, "w4a8_grouped": 1}
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, tlin.w4a8_grouped_plain(x, q, s))


def test_w4a8_grouped_columns_do_not_depend_on_n_on_the_card(cuda):
    """A column's output is the same in a fused leaf (fuse_serving_params)."""
    x = _rand(62, (24, 512), torch.bfloat16, cuda)
    q, s = _int4_groups(63, 4, 96, 128, cuda)
    whole = tlin.w4a8_grouped(x, q, s)
    part = tlin.w4a8_grouped(x, q[:, 32:64].contiguous(), s[32:64].contiguous())
    assert torch.equal(whole[:, 32:64], part)


def test_w4a8_grouped_refuses_what_it_does_not_take(cuda):
    x = torch.zeros((4, 96), dtype=torch.bfloat16, device=cuda)
    q, s = _int4_groups(64, 2, 8, 48, cuda)
    with pytest.raises(ValueError, match="multiple of 32"):
        tlin.w4a8_grouped(x, q, s)
    q, s = _int4_groups(65, 3, 8, 32, cuda)
    raw = torch.zeros(q.numel() + 1, dtype=torch.uint8, device=cuda)
    codes = torch.empty((4, 96), dtype=torch.int8, device=cuda)
    sx = torch.empty(4, device=cuda)
    out = torch.empty((4, 8), dtype=torch.bfloat16, device=cuda)
    assert _build.launcher("w4a8_grouped")(
        x.data_ptr(), codes.data_ptr(), sx.data_ptr(), raw[1:].data_ptr(), s.data_ptr(),
        out.data_ptr(), 4, 8, 3, 32, 1, _build.stream_ptr(x)) == 1


def _split_i8_inputs(seed, B, T, A, H, Hkv, Dh, dtype, device):
    r = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed)
    kq, vq = (torch.randint(-127, 128, (B, T, Hkv, Dh), generator=g, dtype=torch.int8)
              .to(device) for _ in range(2))
    ks, vs = (torch.from_numpy((r.random((B, T, Hkv)) * 0.02 + 0.005).astype(np.float32))
              .to(device) for _ in range(2))
    q = _rand(seed + 1, (B, 1, H, Dh), dtype, device)
    kd, vd = (_rand(seed + 2 + i, (B, A, Hkv, Dh), dtype, device) for i in range(2))
    pre = torch.from_numpy((r.random((B, T)) > 0.2).astype(np.int32)).to(device)
    pre[:, 0] = 1
    if B > 1:
        pre[1, 1:] = 0                                  # a row with BOS alone
    dec = torch.ones((B, A), dtype=torch.int32, device=device)
    dec[:, A // 2 + 1:] = 0
    return q, kq, ks, vq, vs, kd, vd, pre, dec


@pytest.mark.parametrize("scores", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,A,H,Hkv,Dh", [
    (24, 288, 6, 32, 32, 128),      # the turbo_kv8 serving shape
    (2, 40, 3, 4, 2, 16), (3, 100, 7, 8, 1, 64), (2, 33, 1, 4, 4, 16), (1, 4000, 96, 2, 2, 256),
])
def test_split_attention_i8_kernel_matches_plain(cuda, dtype, scores, B, T, A, H, Hkv, Dh):
    """decode_attention.compare_split_attention_i8 (module docstring of that
    file): within two code steps of the row's s_p plus one output step. bf16
    at Dh = 128 (n_rep 1, 2, 4, 8) takes the ring route, everything else the
    scalar route, each counted under its own name."""
    args = _split_i8_inputs(70, B, T, A, H, Hkv, Dh, dtype, cuda)
    route = ("split_attention_i8" if dtype == torch.bfloat16 and Dh == 128
             and H // Hkv in (1, 2, 4, 8) else "split_attention_i8_scalar")
    got = _count(route, lambda: tdec.split_attention_i8(*args, scores))
    assert got.dtype == dtype and got.shape == (B, 1, H, Dh)
    tdec.compare_split_attention_i8(got, *args, scores)


@pytest.mark.parametrize("scores", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,A,H,Hkv", [
    (24, 291, 6, 32, 32),     # T not a multiple of the 16-key chunk
    (2, 4090, 6, 32, 4),      # T + A = 4096 at n_rep 8: the ring's largest shared memory
    (1, 3000, 1096, 16, 8),   # a decode segment of 1096 slots, one row: a cluster of 4
    (3, 1500, 7, 8, 4),       # GQA (n_rep 2), a warp past 1024 keys (int32 hand-off)
    (1, 288, 6, 32, 32),      # one row (the cluster rule: 4 CTAs a (b, kv head))
    (4, 17, 1, 8, 2),         # n_rep 4, a CTA of one chunk and a ragged one
])
def test_split_attention_i8_ring_edges(cuda, scores, B, T, A, H, Hkv):
    """The ring route's edges (bf16 at Dh = 128), every row of the second batch
    row masked but BOS, held by compare_split_attention_i8."""
    args = _split_i8_inputs(75, B, T, A, H, Hkv, 128, torch.bfloat16, cuda)
    got = _count("split_attention_i8", lambda: tdec.split_attention_i8(*args, scores))
    tdec.compare_split_attention_i8(got, *args, scores)


@pytest.mark.parametrize("cs,B,T,A,H,Hkv", [
    (1, 3, 293, 6, 16, 8), (2, 3, 293, 6, 16, 8), (4, 3, 293, 6, 16, 8),   # ragged key ranges
    (1, 2, 4090, 6, 32, 4),   # one CTA: n_rep 8 over 4090 keys, 64 chunks a warp (the hand-off)
    (4, 1, 1, 4095, 8, 1),    # one prefill key, 4095 decode slots: CTAs 1-3 own no key
])
def test_split_ring_at_each_cluster_size(cuda, cs, B, T, A, H, Hkv):
    """The ring launcher at 1, 2 and 4 CTAs a (b, kv head) (uncounted), ragged
    key ranges and GQA, against compare_split_attention_i8; 3 is refused."""
    args = _split_i8_inputs(76 + cs, B, T, A, H, Hkv, 128, torch.bfloat16, cuda)
    fn = kernel_ab.cluster_launchers("split_attention_i8", sizes=(cs, 3))
    with pytest.raises(RuntimeError, match="failed to launch"):
        kernel_ab.call_split_i8(fn[3], *args)
    got = kernel_ab.call_split_i8(fn[cs], *args)
    torch.cuda.synchronize()
    tdec.compare_split_attention_i8(got, *args, torch.bfloat16)


def test_split_ring_launcher_refuses_what_it_does_not_take(cuda):
    """fp32 q, Dh other than 128, n_rep 3 and T + A past 4096: the ring
    launcher refuses them itself (the wrapper sends them to the scalar route)."""
    for dtype, H, Hkv, Dh, T in ((torch.float32, 4, 2, 128, 40), (torch.bfloat16, 4, 2, 64, 40),
                                 (torch.bfloat16, 6, 2, 128, 40),
                                 (torch.bfloat16, 4, 2, 128, 4093)):
        args = _split_i8_inputs(80, 2, T, 4, H, Hkv, Dh, dtype, cuda)
        with pytest.raises(RuntimeError, match="failed to launch"):
            kernel_ab.call_split_i8(_build.launcher("split_attention_i8"), *args)


def test_split_attention_i8_refuses_what_it_does_not_take(cuda):
    args = _split_i8_inputs(71, 2, 40, 3, 4, 2, 18, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        tdec.split_attention_i8(*args, torch.bfloat16)
    args = _split_i8_inputs(72, 2, 40, 3, 4, 2, 16, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tdec.split_attention_i8(args[0], args[1].transpose(1, 2).contiguous().transpose(1, 2),
                                *args[2:], torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        tdec.split_attention_i8(args[0].half(), *args[1:5], args[5].half(), args[6].half(),
                                *args[7:], torch.bfloat16)


# --- expert_ragged: the grouped expert product of the MoE trunk ---------------------------


def _ragged_inputs(seed, sizes, I, O, dtype, int8, device, M=None):
    """Expert-sorted rows x [M, I] (M = sum(sizes) unless given: rows past the
    groups' sum), an expert stack [E, O, I] of x's dtype or int8 codes with
    positive scales, int32 group sizes."""
    r = np.random.default_rng(seed)
    E = len(sizes)
    M = sum(sizes) if M is None else M
    x = torch.from_numpy(r.normal(size=(M, I)).astype(np.float32)).to(device, dtype)
    if int8:
        w = torch.from_numpy(r.integers(-127, 128, size=(E, O, I), dtype=np.int8)).to(device)
        s = torch.from_numpy((r.uniform(0.5, 1.5, size=(E, O)) * 1e-3).astype(np.float32)).to(device)
    else:
        w = torch.from_numpy((r.normal(size=(E, O, I)) * 0.05).astype(np.float32)).to(device, dtype)
        s = None
    gs = torch.tensor(sizes, dtype=torch.int32, device=device)
    return x, w, s, gs


def _ragged_leaf(w, s):
    return w if s is None else {"q": w, "s": s}


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("sizes,I,O", [
    ([576] * 8, 4096, 1024),                 # a prefill's even split (9 row tiles an expert)
    ([700, 0, 3, 1, 129, 64, 65, 190], 1024, 512),   # skewed, an empty expert, one-row groups
    ([2, 2, 3, 1, 0, 4, 2, 2], 4096, 2048),  # decode: 16 rows over 8 experts
    ([5, 9, 0, 30], 208, 136),               # I and O past a k chunk and a 128-column tile
])
def test_expert_ragged_matches_plain(cuda, int8, sizes, I, O):
    """The tensor-core route against the plain version: every element within
    one bf16 step (compare_expert_ragged), one launch counted."""
    x, w, s, gs = _ragged_inputs(90 + len(sizes) + I, sizes, I, O, torch.bfloat16, int8, cuda)
    assert texr.ragged_mma_eligible(x, w)
    got = _count("expert_ragged", lambda: texr.expert_ragged(x, _ragged_leaf(w, s), gs))
    want = texr.expert_ragged_plain(x, w, s, gs)
    texr.compare_expert_ragged(got, want)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_expert_ragged_rows_past_the_groups_are_zero(cuda, int8):
    """Rows past the sum of the group sizes come out 0 (ragged_dot's rule),
    on both routes."""
    for dtype, I in ((torch.bfloat16, 64), (torch.float32, 64)):
        x, w, s, gs = _ragged_inputs(95, [3, 0, 70], I, 24, dtype, int8, cuda, M=200)
        kernel = "expert_ragged" if dtype == torch.bfloat16 else "expert_ragged_scalar"
        got = _count(kernel, lambda: texr.expert_ragged(x, _ragged_leaf(w, s), gs))
        assert torch.all(got[73:] == 0)
        texr.compare_expert_ragged(got, texr.expert_ragged_plain(x, w, s, gs))


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
@pytest.mark.parametrize("dtype,I,O", [
    (torch.float32, 64, 128),     # the tiny MoE trunk's fp32 shapes
    (torch.float32, 4096, 640),
    (torch.bfloat16, 20, 24),     # I not a multiple of 8: the rule refuses the tensor cores
    (torch.bfloat16, 64, 12),     # O not a multiple of 8
])
def test_expert_ragged_scalar_route(cuda, int8, dtype, I, O):
    """fp32 x and the shapes the tensor-core rule refuses take the scalar
    route, counted as expert_ragged_scalar: fp32 within 1e-5 of the largest
    |want|, bf16 within one bf16 step."""
    x, w, s, gs = _ragged_inputs(97 + I, [7, 0, 1, 40], I, O, dtype, int8, cuda)
    assert not texr.ragged_mma_eligible(x, w)
    got = _count("expert_ragged_scalar", lambda: texr.expert_ragged(x, _ragged_leaf(w, s), gs))
    texr.compare_expert_ragged(got, texr.expert_ragged_plain(x, w, s, gs))


def test_expert_ragged_int4_and_lora_forms(cuda):
    """Grouped int4 (dequantized, then the bf16 launch) and streamed LoRA
    (the base plus two launches) on the card against the same forms on the
    CPU: int4 within one bf16 step; LoRA within two steps at the largest
    |want| (the base and the delta are each one rounding, then their bf16
    sum is another)."""
    x, w, _, gs = _ragged_inputs(99, [40, 0, 3, 85], 256, 128, torch.bfloat16, False, cuda)
    w4 = tlin.quantize_weight_int4(w)
    r = np.random.default_rng(100)
    lora = {"base": w, "A": torch.from_numpy(r.normal(size=(4, 8, 256)).astype(np.float32) * 0.1),
            "B": torch.from_numpy(r.normal(size=(4, 128, 8)).astype(np.float32) * 0.1)}
    for leaf, launches in ((w4, 1), (lora, 3)):
        on_card = {k: v.to(cuda) for k, v in leaf.items()}
        before = _build.KERNEL_LAUNCHES["expert_ragged"]
        got = texr.expert_ragged(x, on_card, gs)
        torch.cuda.synchronize()
        assert _build.KERNEL_LAUNCHES["expert_ragged"] == before + launches
        want = texr.expert_ragged(x.cpu(), {k: v.cpu() for k, v in leaf.items()}, gs.cpu())
        if launches == 1:
            texr.compare_expert_ragged(got.cpu(), want)
        else:
            d = (got.cpu().float() - want.float()).abs().max().item()
            assert d <= 2 ** -6 * want.float().abs().max().item(), d


def test_expert_ragged_launcher_refuses_what_it_does_not_take(cuda):
    """The tensor-core launcher refuses O not a multiple of 8, int8 codes with
    I not a multiple of 16, bf16 weights with I not a multiple of 8, no
    experts, int8 codes without scales and the decode route above
    DECODE_ROWS rows, on either route where the route is free; the wrapper
    raises on a bad group-size dtype."""
    x, w, s, gs = _ragged_inputs(101, [4, 4], 64, 64, torch.bfloat16, True, cuda)
    out = torch.empty(8, 64, dtype=torch.bfloat16, device=cuda)
    fn = _build.launcher("expert_ragged")
    stream = _build.stream_ptr(x)
    base = (x.data_ptr(), w.data_ptr(), s.data_ptr(), gs.data_ptr(), out.data_ptr())
    for prefill in (0, 1):
        for M, O, I, E, int8, s_ptr in (
                (8, 60, 64, 2, 1, s.data_ptr()), (8, 64, 60, 2, 1, s.data_ptr()),
                (8, 64, 56, 2, 1, s.data_ptr()), (8, 64, 60, 2, 0, None),
                (8, 64, 64, 0, 1, s.data_ptr()), (8, 64, 64, 2, 1, None)):
            assert fn(base[0], base[1], s_ptr, base[3], base[4], M, O, I, E, int8, prefill,
                      stream) != 0
    assert fn(*base, texr.DECODE_ROWS + 1, 64, 64, 2, 1, 0, stream) != 0
    with pytest.raises(TypeError, match="int32"):
        texr.expert_ragged(x, {"q": w, "s": s}, gs.long())


def test_expert_ragged_int8_with_i_off_16_takes_the_scalar_route(cuda):
    """int8 codes at I = 200 (a multiple of 8, not of 16: the TMA map needs
    16-byte rows of codes) take the scalar route by the rule, within one bf16
    step of the plain version; bf16 weights at the same I take the
    tensor-core route."""
    for int8, kernel in ((True, "expert_ragged_scalar"), (False, "expert_ragged")):
        x, w, s, gs = _ragged_inputs(102, [5, 9, 0, 30], 200, 136, torch.bfloat16, int8, cuda)
        assert texr.ragged_mma_eligible(x, w) is not int8
        got = _count(kernel, lambda: texr.expert_ragged(x, _ragged_leaf(w, s), gs))
        texr.compare_expert_ragged(got, texr.expert_ragged_plain(x, w, s, gs))


def test_expert_ragged_decode_rows_match_the_kernel(cuda):
    """The wrapper's route rule mirrors the launcher's limit of the decode route."""
    assert _build.load("expert_ragged").ovla_expert_ragged_decode_rows() == texr.DECODE_ROWS


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M", [64, 65], ids=["decode_64", "prefill_65"])
def test_expert_ragged_route_boundary(cuda, int8, M):
    """M = 64 (the last on the decode route) and 65 (the first on the
    prefill route), a group of 64 rows at M = 64 (both m16 tiles of two row
    blocks) and one expert past a 64-row group at 65, rows past the sum 0."""
    sizes = [64, 0, 0, 0] if M == 64 else [1, 0, 60, 2]
    x, w, s, gs = _ragged_inputs(103 + M, sizes, 1024, 520, torch.bfloat16, int8, cuda, M=M)
    got = _count("expert_ragged", lambda: texr.expert_ragged(x, _ragged_leaf(w, s), gs))
    texr.compare_expert_ragged(got, texr.expert_ragged_plain(x, w, s, gs))
    assert torch.all(got[sum(sizes):] == 0)


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_expert_ragged_one_expert_holds_every_row(cuda, int8):
    """One expert holds all 4608 rows of a prefill, the other seven are
    empty; and at a decode step all 16 rows."""
    for M, O in ((4608, 1024), (16, 2048)):
        sizes = [0, 0, 0, M, 0, 0, 0, 0]
        x, w, s, gs = _ragged_inputs(104 + M, sizes, 4096, O, torch.bfloat16, int8, cuda)
        got = _count("expert_ragged", lambda: texr.expert_ragged(x, _ragged_leaf(w, s), gs))
        texr.compare_expert_ragged(got, texr.expert_ragged_plain(x, w, s, gs))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("M,sizes", [(1200, [300, 129, 0, 700]), (16, [2, 9, 0, 5])],
                         ids=["prefill", "decode"])
def test_expert_ragged_two_runs_give_the_same_bits(cuda, int8, M, sizes):
    """No atomics and a fixed summation order on both routes: two launches on
    the same inputs give equal bits."""
    x, w, s, gs = _ragged_inputs(105 + M, sizes, 4096, 1024, torch.bfloat16, int8, cuda)
    first = texr.expert_ragged(x, _ragged_leaf(w, s), gs)
    second = texr.expert_ragged(x, _ragged_leaf(w, s), gs)
    torch.cuda.synchronize()
    assert torch.equal(first, second)



# --- expert_ragged's backward: dx and dW --------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("sizes,O,I,M", [
    ([640] * 8, 1024, 512, None),                  # an even split, 5 row tiles an expert
    ([700, 0, 3, 1, 129, 64, 65, 190], 512, 1024, None),   # skewed, empty, one-row groups
    ([0, 0, 0, 1000, 0, 0, 0, 0], 2048, 256, None),        # one expert holds every row
    ([5, 9, 0, 30], 136, 208, 300),                # O and I off the tiles, rows past the sum
    ([50, 40, 0, 38], 32, 512, None),              # a LoRA dt · A (K = r = 32)
    ([50, 40, 0, 38], 512, 16, None),              # a LoRA dy · B at r = 16 (N off the tile)
])
def test_expert_ragged_dx_matches_plain(cuda, int8, sizes, O, I, M):
    """dx on the tensor cores against expert_ragged_dx_plain by
    compare_expert_ragged's rule (every element within one bf16 step, the
    int8 form's scaled weights exact as three bf16 terms); rows past the sum
    0; one launch counted; two runs bit-equal."""
    if int8 and I % 16:
        pytest.skip("int8 codes need I % 16 == 0 on the tensor-core route")
    dy, _, _, gs = _ragged_inputs(110 + O + I, sizes, O, 0, torch.bfloat16, False, cuda, M=M)
    _, w, s, _ = _ragged_inputs(111 + O, sizes, I, O, torch.bfloat16, int8, cuda, M=M)
    assert texr.ragged_dx_mma_eligible(dy, w)
    got = _count("expert_ragged_dx", lambda: texr.expert_ragged_dx(dy, w, s, gs))
    texr.compare_expert_ragged(got, texr.expert_ragged_dx_plain(dy, w, s, gs))
    assert torch.all(got[sum(sizes):] == 0)
    assert torch.equal(got, texr.expert_ragged_dx(dy, w, s, gs))


@pytest.mark.parametrize("sizes,O,I,M", [
    ([640] * 8, 32, 1024, None),                   # a LoRA dA: split rows, fp32 partials
    ([640] * 8, 1024, 32, None),                   # a LoRA dB
    ([0, 0, 0, 5120, 0, 0, 0, 0], 8, 512, None),   # one expert holds every row, r = 8
    ([700, 0, 3, 1, 129, 64, 65, 190], 512, 8, 1300),   # skewed, rows past the sum
    ([300, 129, 0, 700], 1024, 1024, None),        # a float stack: one pass
    ([5, 9, 0, 30], 136, 200, None),               # O and I off the tiles
])
def test_expert_ragged_dw_matches_plain(cuda, sizes, O, I, M):
    """dW on the tensor cores against expert_ragged_dw_plain by
    compare_expert_ragged's rule; an empty expert's dW written 0; one launch
    counted (the reduce grid of a split included); two runs bit-equal."""
    M = sum(sizes) if M is None else M
    dy, _, _, gs = _ragged_inputs(120 + O, sizes, O, 0, torch.bfloat16, False, cuda, M=M)
    x, _, _, _ = _ragged_inputs(121 + I, sizes, I, 0, torch.bfloat16, False, cuda, M=M)
    assert texr.ragged_dw_mma_eligible(dy, x)
    got = _count("expert_ragged_dw", lambda: texr.expert_ragged_dw(dy, x, gs, len(sizes)))
    texr.compare_expert_ragged(got, texr.expert_ragged_dw_plain(dy, x, gs, len(sizes)))
    for e, n in enumerate(sizes):
        if n == 0:
            assert torch.all(got[e] == 0)
    assert torch.equal(got, texr.expert_ragged_dw(dy, x, gs, len(sizes)))


@pytest.mark.parametrize("sizes,O,I,M,want", [
    ([4192] * 4, 256, 32, None, (64, 2)),          # dy · B, 131 tiles: the contraction split
    ([4192] * 3 + [4193], 256, 32, None, (64, 1)),   # 132 tiles: one pass
    ([700, 0, 3, 1, 900, 1500, 700, 304], 1024, 16, None, (64, 8)),   # r = 16
    ([700, 0, 3, 1, 900, 1500, 700, 304], 1024, 64, None, (64, 8)),   # r = 64
    ([1, 0, 300, 1, 77], 512, 32, 400, (64, 4)),     # one-row experts, rows past the sum
    ([1, 0, 300, 1, 77], 512, 1024, 400, (128, 4)),
    ([700, 0, 3, 1, 900, 1500, 700, 304], 8, 1024, None, (128, 1)),   # O = 8: one stage
])
def test_expert_ragged_dx_new_tilings(cuda, sizes, O, I, M, want):
    """bf16 dx at `dx_tiling`'s boundaries and narrow shapes: the split-K
    switch of dy · B, r = 16 and 64 (64-column tiles), experts of one row,
    O = 8; held to the plain version, rows past the sum 0, one launch
    counted, two runs bit-equal."""
    M = sum(sizes) if M is None else M
    dy, _, _, gs = _ragged_inputs(160 + O + I, sizes, O, 0, torch.bfloat16, False, cuda, M=M)
    _, w, _, _ = _ragged_inputs(161 + I, sizes, I, O, torch.bfloat16, False, cuda, M=M)
    assert texr.dx_tiling(M, O, I, False) == want
    got = _count("expert_ragged_dx", lambda: texr.expert_ragged_dx(dy, w, None, gs))
    texr.compare_expert_ragged(got, texr.expert_ragged_dx_plain(dy, w, None, gs))
    assert torch.all(got[sum(sizes):] == 0)
    assert torch.equal(got, texr.expert_ragged_dx(dy, w, None, gs))


@pytest.mark.parametrize("sizes,O,I,M", [
    ([700, 0, 3, 1, 900, 1500, 700, 304], 1024, 16, None),   # dB at r = 16
    ([700, 0, 3, 1, 900, 1500, 700, 304], 64, 1024, None),   # dA at r = 64: transposed
    ([1, 0, 300, 1, 77], 32, 512, 400),            # one-row experts, rows past the sum
    ([1, 0, 300, 1, 77], 512, 32, 400),
    ([300, 129, 0, 700], 256, 1024, None),         # a float stack, transposed (O < I)
    ([300, 129, 0, 700], 72, 136, None),           # 128-column tiles off both edges
])
def test_expert_ragged_dw_new_tilings(cuda, sizes, O, I, M):
    """dW over `dw_tiling`'s tiles (64 or 128 columns of the narrow side, dW's
    transpose where O < I) and `dw_split_rows`' pieces: held to the plain
    version, empty experts 0, one launch counted, two runs bit-equal."""
    M = sum(sizes) if M is None else M
    dy, _, _, gs = _ragged_inputs(170 + O, sizes, O, 0, torch.bfloat16, False, cuda, M=M)
    x, _, _, _ = _ragged_inputs(171 + I, sizes, I, 0, torch.bfloat16, False, cuda, M=M)
    got = _count("expert_ragged_dw", lambda: texr.expert_ragged_dw(dy, x, gs, len(sizes)))
    texr.compare_expert_ragged(got, texr.expert_ragged_dw_plain(dy, x, gs, len(sizes)))
    for e, n in enumerate(sizes):
        if n == 0:
            assert torch.all(got[e] == 0)
    assert torch.equal(got, texr.expert_ragged_dw(dy, x, gs, len(sizes)))


@pytest.mark.parametrize("route,O,I", [
    ("dx int8", 2048, 1024), ("dx bf16 128 columns", 2048, 1024),
    ("dx bf16 64 columns, split", 2048, 32), ("dx bf16 one k step", 32, 2048),
    ("dW 64 columns, split", 2048, 32), ("dW transposed, split", 32, 2048),
    ("dW 128 columns", 1024, 512),
])
def test_expert_ragged_bwd_routes_two_runs_give_the_same_bits(cuda, route, O, I):
    """No atomics and a fixed summation order on every route of the
    backward (the split ones' reduce grids included): two launches on the
    same inputs give equal bits."""
    sizes = [640, 512, 0, 768, 1, 640, 700, 355]
    dy, _, _, gs = _ragged_inputs(180 + O, sizes, O, 0, torch.bfloat16, False, cuda)
    if route.startswith("dx"):
        _, w, s, _ = _ragged_inputs(181 + I, sizes, I, O, torch.bfloat16, "int8" in route, cuda)
        runs = [texr.expert_ragged_dx(dy, w, s, gs) for _ in range(2)]
    else:
        x, _, _, _ = _ragged_inputs(182 + I, sizes, I, 0, torch.bfloat16, False, cuda)
        runs = [texr.expert_ragged_dw(dy, x, gs, len(sizes)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("dtype,O,I", [(torch.float32, 64, 128), (torch.float32, 128, 8),
                                       (torch.bfloat16, 20, 24)])
def test_expert_ragged_bwd_scalar_routes(cuda, dtype, O, I):
    """fp32 and the shapes the tensor-core rules refuse take the scalar
    routes, counted apart: fp32 within 1e-5 of the largest |want|, bf16
    within one bf16 step."""
    sizes = [7, 0, 1, 40]
    dy, _, _, gs = _ragged_inputs(130 + O, sizes, O, 0, dtype, False, cuda, M=50)
    x, w, s, _ = _ragged_inputs(131 + I, sizes, I, O, dtype, dtype == torch.float32, cuda, M=50)
    assert not texr.ragged_dx_mma_eligible(dy, w)
    got = _count("expert_ragged_dx_scalar", lambda: texr.expert_ragged_dx(dy, w, s, gs))
    texr.compare_expert_ragged(got, texr.expert_ragged_dx_plain(dy, w, s, gs))
    assert not texr.ragged_dw_mma_eligible(dy, x)
    got = _count("expert_ragged_dw_scalar", lambda: texr.expert_ragged_dw(dy, x, gs, 4))
    texr.compare_expert_ragged(got, texr.expert_ragged_dw_plain(dy, x, gs, 4))


def test_expert_ragged_lora_backward_on_the_card(cuda):
    """Autograd through the LoRA form over int8 codes on the card: 3
    expert_ragged, then 3 expert_ragged_dx and 2 expert_ragged_dw; dx and the
    adapters' gradients against the same graph on the CPU (the plain
    versions): dx within two bf16 steps at the largest |want| (base and
    adapter contributions added in bf16), dA and dB within 1e-2 in norm
    (each rounds to bf16 before the fp32 master takes it)."""
    x, q, s, gs = _ragged_inputs(140, [300, 0, 129, 211], 512, 1024, torch.bfloat16, True, cuda)
    r = np.random.default_rng(141)
    A = torch.from_numpy(r.normal(size=(4, 32, 512)).astype(np.float32) * 0.05)
    B = torch.from_numpy(r.normal(size=(4, 1024, 32)).astype(np.float32) * 0.05)
    dy = torch.from_numpy(r.normal(size=(640, 1024)).astype(np.float32)).bfloat16()

    def grads(dev):
        xa = x.to(dev).requires_grad_(True)
        a, b = A.to(dev).requires_grad_(True), B.to(dev).requires_grad_(True)
        y = texr.expert_ragged(xa, {"base": {"q": q.to(dev), "s": s.to(dev)}, "A": a, "B": b},
                               gs.to(dev))
        return torch.autograd.grad(y, [xa, a, b], dy.to(dev))

    _build.reset_launch_counts()
    got = grads(cuda)
    torch.cuda.synchronize()
    launches = {k: n for k, n in _build.KERNEL_LAUNCHES.items() if n}
    assert launches == {"expert_ragged": 3, "expert_ragged_dx": 3, "expert_ragged_dw": 2}
    want = grads("cpu")
    d = (got[0].cpu().float() - want[0].float()).abs().max().item()
    assert d <= 2 ** -6 * want[0].float().abs().max().item(), d
    for g, w_ in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        assert (g.cpu() - w_).norm() <= 1e-2 * w_.norm()


def test_expert_ragged_bwd_launches_from_a_fresh_thread(cuda):
    """Autograd runs the backward on a thread of its own, where nothing may
    have touched the card yet: after the libraries are loaded and used on
    this thread, dx and dW launch from a new thread (the launchers make a
    runtime call, which makes the device's context current there, before
    the driver encodes their tensor maps)."""
    import threading

    sizes = [300, 0, 129, 211]
    dy, _, _, gs = _ragged_inputs(190, sizes, 1024, 0, torch.bfloat16, False, cuda)
    x, w, _, _ = _ragged_inputs(191, sizes, 32, 1024, torch.bfloat16, False, cuda)
    want_dx = texr.expert_ragged_dx(dy, w, None, gs)
    want_dw = texr.expert_ragged_dw(dy, x, gs, len(sizes))
    got, errors = {}, []

    def run():
        try:
            got["dx"] = texr.expert_ragged_dx(dy, w, None, gs)
            got["dw"] = texr.expert_ragged_dw(dy, x, gs, len(sizes))
            torch.cuda.synchronize()
        except RuntimeError as e:   # reported below, with the thread's result
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and not errors, errors
    assert torch.equal(got["dx"], want_dx) and torch.equal(got["dw"], want_dw)


def test_expert_ragged_bwd_launchers_refuse_what_they_do_not_take(cuda):
    """dx refuses O off 8, int8 codes with I off 16, no experts, codes
    without scales, a tile other than 128 columns (or 64 for bf16), and a
    split without its workspace; dW refuses I off 8, a split without its
    workspace or with rows off the 64-row stage."""
    dy, w, s, gs = _ragged_inputs(150, [4, 4], 64, 64, torch.bfloat16, True, cuda)
    out = torch.empty(8, 64, dtype=torch.bfloat16, device=cuda)
    dx = _build.launcher("expert_ragged_dx")
    st = _build.stream_ptr(dy)
    p = (dy.data_ptr(), w.data_ptr(), s.data_ptr(), gs.data_ptr(), out.data_ptr())
    for M, O, I, E, int8, s_ptr, tile_n, splits in (
            (8, 60, 64, 2, 1, p[2], 128, 1), (8, 64, 56, 2, 1, p[2], 128, 1),
            (8, 64, 64, 0, 1, p[2], 128, 1), (8, 64, 64, 2, 1, None, 128, 1),
            (8, 64, 64, 2, 1, p[2], 64, 1), (8, 64, 64, 2, 0, None, 96, 1),
            (8, 64, 64, 2, 0, None, 64, 2), (8, 64, 64, 2, 0, None, 64, 0)):
        assert dx(p[0], p[1], s_ptr, p[3], None, p[4], M, O, I, E, int8, tile_n, splits,
                  st) != 0
    dw = _build.launcher("expert_ragged_dw")
    wsp = torch.empty(1 << 16, dtype=torch.float32, device=cuda)
    q = (dy.data_ptr(), dy.data_ptr(), gs.data_ptr())
    assert dw(*q, None, out.data_ptr(), 8, 64, 60, 2, 8, st) != 0
    assert dw(*q, None, out.data_ptr(), 128, 64, 64, 2, 64, st) != 0
    assert dw(*q, wsp.data_ptr(), out.data_ptr(), 128, 64, 64, 2, 32, st) != 0


# --- tensor maps encoded on a thread that never touched the card ---------------------------

# the launches that encode a TMA tensor map before any CUDA runtime call on their thread, and
# so were refused on a fresh thread until hopper.cuh's encode bound the device's primary
# context itself (measured on an H100: where the wrapper's own PyTorch work on the card, a
# transpose or a zero fill, or the launcher's pre-pass kernel, or its cudaFuncSetAttribute
# as expert_ragged_bwd.cu's, comes first, it binds the context on the way)
ENCODE_FIRST = ("flash_prefill", "flash_blockwise", "wi8_matmul", "w8a8_matmul",
                "w8a8_matmul_i32")


def _tma_calls(dev):
    """kernel -> a call of its wrapper on a route that encodes tensor maps."""
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = rnd(128, 256).bfloat16()
    w8 = tlin.quantize_weight(rnd(256, 256))
    w4 = tlin.quantize_weight_int4(rnd(256, 256), 128)
    nib = tlin.quantize_weight_nibble(rnd(256, 256))
    codes, sx = tlin.quantize_rows(x.float())
    pre = tlin.PrequantActivation(codes, sx, torch.bfloat16)
    q, k, v = (rnd(1, 128, 2, 128).bfloat16() for _ in range(3))
    valid = torch.ones(1, 128, dtype=torch.int32, device=dev)
    ql, kl, vl = (rnd(1, 1100, 2, 128).bfloat16() for _ in range(3))
    valid_l = torch.ones(1, 1100, dtype=torch.int32, device=dev)
    gs = torch.tensor([40, 0, 60, 28], dtype=torch.int32, device=dev)
    we, xe, dy = rnd(4, 64, 256).bfloat16(), x, rnd(128, 64).bfloat16()
    return {
        "flash_prefill": lambda: tattn.flash_attention(q, k, v, valid),
        "flash_blockwise": lambda: tattn.flash_attention_blockwise(ql, kl, vl, valid_l),
        "wi8_matmul": lambda: tlin.wi8_matmul(x, w8["q"], w8["s"]),
        "w8a8_matmul": lambda: tlin.w8a8_matmul(pre, w8),
        "w8a8_matmul_i32": lambda: tlin.w8a8_matmul_i32(codes, w8),
        "w4a8_matmul": lambda: tlin.w4a8_matmul(x, w4["q"], w4["s"]),
        "w4a8_dx": lambda: tlin.w4a8_dx(x, w4["q"], w4["s"]),
        "w4a8_requant": lambda: tlin.w4a8_requant(x, w4["q"], w4["s"]),
        "w4a8_grouped": lambda: tlin.w4a8_grouped(x[:8].contiguous(), w4["q"], w4["s"]),
        "nib_hi_dot": lambda: tlin.nib_hi_dot(x[:8].contiguous(), nib["hi"], nib["s"]),
        "fused_ln_w8a8": lambda: tmlp.fused_ln_w8a8(
            x, w8, rnd(256).bfloat16(), ln=(torch.ones(256, device=dev).bfloat16(),
                                           torch.zeros(256, device=dev).bfloat16())),
        "expert_ragged": lambda: texr.expert_ragged(xe, we, gs),
        "expert_ragged_dx": lambda: texr.expert_ragged_dx(dy, we, None, gs),
        "expert_ragged_dw": lambda: texr.expert_ragged_dw(dy, xe, gs, 4),
    }


def _build_without_bind(out_dir: str, kernels) -> dict:
    """The sources of `kernels` built with hopper.cuh's context bind left out
    (-DOVLA_NO_CONTEXT_BIND): source -> library path."""
    import subprocess

    nvcc = _build._nvcc()
    srcs = sorted({_build.KERNELS[k][0] for k in kernels})
    procs = {}
    for src in srcs:
        lib = f"{out_dir}/lib{src[:-3]}.so"
        procs[src] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-DOVLA_NO_CONTEXT_BIND", "-I", str(_build.CSRC), "-o",
             lib, str(_build.CSRC / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for src, (lib, p) in procs.items():
        log = p.communicate()[0]
        assert p.returncode == 0, log[-3000:]
    return {src: lib for src, (lib, _) in procs.items()}


def _launch_on_a_fresh_thread(variant: dict = None, index: int = 0) -> dict:
    """In this process: inputs made on this thread on card `index`, then
    every `_tma_calls` launch from a new thread; kernel -> "ok" or the error
    (an output on another card is an error too). `variant` (source ->
    library) replaces those libraries' launchers first."""
    import ctypes
    import threading

    dev = torch.device("cuda", index)
    _build.load("w8a8_matmul")
    if variant:
        for src, path in variant.items():
            lib = ctypes.CDLL(path)
            for s, sym, argtypes in _build.KERNELS.values():
                if s == src:
                    fn = getattr(lib, sym)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _build._loaded[src] = lib
        _build._launchers.clear()
    calls = _tma_calls(dev)
    torch.cuda.synchronize()
    res = {}

    def body():
        for name, fn in calls.items():
            try:
                out = fn()
                torch.cuda.synchronize(dev)
                outs = out if isinstance(out, (tuple, list)) else (out,)
                on = {t.device for t in outs if isinstance(t, torch.Tensor)}
                res[name] = "ok" if on == {dev} else f"output on {on}"
            except RuntimeError as e:
                res[name] = str(e)[:200]

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    return res


def _in_a_fresh_process(variant=None, index: int = 0) -> dict:
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        return pool.submit(_launch_on_a_fresh_thread, variant, index).result(timeout=900)


def test_tma_launchers_from_a_fresh_thread_and_process(cuda, tmp_path):
    """Every TMA launcher launches from a thread that never touched the card,
    in this process and in a freshly spawned one (hopper.cuh's encode binds
    the device's primary context first); built without that bind, the
    launchers that encode before any runtime call of their own
    (ENCODE_FIRST) are refused there, the others not."""
    calls = set(_tma_calls(cuda))
    for res in (_launch_on_a_fresh_thread(), _in_a_fresh_process()):
        assert set(res) == calls, res
        assert all(r == "ok" for r in res.values()), {k: r for k, r in res.items() if r != "ok"}
    res = _in_a_fresh_process(_build_without_bind(str(tmp_path), calls))
    refused = {k for k, r in res.items() if r != "ok"}
    assert refused == set(ENCODE_FIRST), res


def test_tma_launchers_from_a_fresh_thread_on_a_second_card(cuda):
    """Every TMA launcher launches from a fresh thread whose tensors are on
    cuda:1, in this process and in a freshly spawned one: a new thread's
    current device is 0, so encode binds the primary context of the card
    that holds the tensor, and `_build.stream_ptr` makes that card current
    for the launch (run where the machine has two cards or more)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second card")
    calls = set(_tma_calls(cuda))
    for res in (_launch_on_a_fresh_thread(index=1), _in_a_fresh_process(index=1)):
        assert set(res) == calls, res
        assert all(r == "ok" for r in res.values()), {k: r for k, r in res.items() if r != "ok"}


# --- the row-parallel w8a8 product (slice 6a) ------------------------------------------------


@pytest.mark.parametrize("M,K,N,k_pad,nibble,dtype,n_epi", [
    (24, 2048, 4096, 2048, False, torch.bfloat16, 4096),     # o_proj at tp = 2, decode
    (65, 5504, 512, 5504, False, torch.bfloat16, 509),       # down_proj's K, the wgmma route's edge
    (64, 512, 1024, 512, False, torch.bfloat16, 1024),       # the split-K route's edge
    (300, 2152, 1152, 2160, False, torch.bfloat16, 1149),    # SigLIP fc2 at tp = 2, padded
    (7, 2152, 64, 2160, False, torch.float32, 61),
    (70, 1028, 64, 1040, False, torch.float32, 64),          # fp32 rows, K % 8 = 4
    (37, 2148, 96, 2160, False, torch.bfloat16, 93),         # bf16 K % 8 = 4: 8-byte loads
    (1, 2048, 64, 2048, False, torch.bfloat16, 64),          # one row
    (70000, 48, 16, 48, False, torch.bfloat16, 13),          # M past 65535
    (200, 1024, 256, 1024, True, torch.bfloat16, 256),       # nibble planes, packed k order
    (9, 1024, 256, 1024, True, torch.bfloat16, 250)])
def test_row_parallel_w8a8_kernels_bit_equal(cuda, M, K, N, k_pad, nibble, dtype, n_epi):
    """w8a8_row_absmax, w8a8_quant_given, w8a8_matmul_i32 and w8a8_epilogue
    each bit-equal to their plain versions (a nibble leaf's codes compared
    through its int32 sums: the card stores them in the packed k order), one
    row all zeros (its scale clamps to 1e-8), the epilogue also over the
    first `n_epi` columns (N % 8 != 0: its element route), the four composed
    equal to w8a8_matmul_plain over the unpadded weight, one launch each."""
    x = (_rand(400 + M, (M, K), torch.float32, cuda) * 3).to(dtype)
    x[M // 2] = 0
    w = tlin.quantize_weight(_rand(401 + M, (N, K), torch.float32, cuda))
    leaf = tlin.quantize_weight_nibble(tlin.dequantize_weight(w, torch.float32)) if nibble else {
        "q": torch.nn.functional.pad(w["q"], (0, k_pad - K)), "s": w["s"]}
    before = dict(_build.KERNEL_LAUNCHES)
    amax = tlin.w8a8_row_absmax(x)
    sx = torch.clamp(tlin.div127(amax), min=1e-8)
    codes = tlin.w8a8_quant_given(x, sx, k_pad, nibble=nibble)
    acc = tlin.w8a8_matmul_i32(codes, leaf)
    out = tlin.w8a8_epilogue(acc, sx, leaf["s"], dtype)
    torch.cuda.synchronize()
    for name in ("w8a8_row_absmax", "w8a8_quant_given", "w8a8_matmul_i32", "w8a8_epilogue"):
        assert _build.KERNEL_LAUNCHES[name] == before[name] + 1, name
    assert torch.equal(amax, tlin.w8a8_row_absmax_plain(x))
    assert float(sx[M // 2]) == np.float32(1e-8)
    want_codes = tlin.w8a8_quant_given_plain(x, sx, k_pad)
    if not nibble:
        assert torch.equal(codes, want_codes)
    assert torch.equal(acc, tlin.w8a8_matmul_i32_plain(want_codes, leaf))
    assert torch.equal(out, tlin.w8a8_epilogue_plain(acc, sx, leaf["s"], dtype))
    whole = leaf if nibble else {"q": leaf["q"][:, :K].contiguous(), "s": leaf["s"]}
    assert torch.equal(out, tlin.w8a8_matmul_plain(x, whole))
    acc_n, s_n = acc[:, :n_epi].contiguous(), leaf["s"][:n_epi].contiguous()
    assert torch.equal(tlin.w8a8_epilogue(acc_n, sx, s_n, dtype),
                       tlin.w8a8_epilogue_plain(acc_n, sx, s_n, dtype))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K", [4, 12, 2152, 5504])
def test_row_absmax_bit_equal_on_edge_values(cuda, dtype, K):
    """w8a8_row_absmax against x.abs().amax(-1): rows of -0, of negatives
    only, with -inf, with a NaN (which propagates, as in amax), and rows of
    every magnitude, at K % 8 = 4 and 0."""
    x = (_rand(900 + K, (9, K), torch.float32, cuda) * 5).to(dtype)
    x[0] = -0.0
    x[1] = -x[1].abs()
    x[2, K // 2] = float("-inf")
    x[3, K - 1] = float("nan")
    x[4] *= 1e-30
    got, want = tlin.w8a8_row_absmax(x), tlin.w8a8_row_absmax_plain(x)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    keep = ~torch.isnan(want)
    assert torch.equal(got[keep], want[keep])
    assert float(got[0]) == 0.0 and not torch.signbit(got[0])


def test_row_parallel_w8a8_launchers_refuse_what_they_do_not_take(cuda):
    """The pre-pass refuses K off 4, a pad below K or off 16 (32 and equal to
    K for nibble codes); the absmax K off 4 and no rows; the GEMM K off 16
    and N off 8; the wrappers raise before any launch."""
    x = torch.ones(4, 48, dtype=torch.bfloat16, device=cuda)
    sx = torch.ones(4, 1, device=cuda)
    for k_pad, nibble in ((40, False), (50, False), (64, True)):
        with pytest.raises(ValueError, match="k_pad"):
            tlin.w8a8_quant_given(x, sx, k_pad, nibble=nibble)
    codes = torch.zeros(4, 40, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        tlin.w8a8_matmul_i32(codes, {"q": torch.zeros(8, 40, dtype=torch.int8, device=cuda),
                                     "s": torch.ones(8, device=cuda)})
    with pytest.raises(ValueError, match="multiple of 4"):
        tlin.w8a8_row_absmax(x[:, :46].contiguous())
    pre = _build.launcher("w8a8_quant_given")
    st = _build.stream_ptr(x)
    out = torch.empty(4, 48, dtype=torch.int8, device=cuda)
    assert pre(x.data_ptr(), sx.data_ptr(), out.data_ptr(), 4, 46, 48, 1, 0, st) != 0
    amax = torch.empty(4, 1, device=cuda)
    absmax = _build.launcher("w8a8_row_absmax")
    assert absmax(x.data_ptr(), amax.data_ptr(), 4, 46, 1, st) != 0
    assert absmax(x.data_ptr(), amax.data_ptr(), 0, 48, 1, st) != 0
    gemm = _build.launcher("w8a8_matmul_i32")
    acc = torch.empty(4, 12, dtype=torch.int32, device=cuda)
    q = torch.zeros(12, 48, dtype=torch.int8, device=cuda)
    codes = torch.zeros(4, 48, dtype=torch.int8, device=cuda)
    assert gemm(codes.data_ptr(), q.data_ptr(), None, acc.data_ptr(), 4, 12, 48, st) != 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_row_parallel_chain_at_a_local_k_off_4_on_two_threads(cuda, dtype, monkeypatch):
    """The row-parallel w8a8 product at a local K of 538 (SigLIP fc2 at
    tp = 8; here K = 1076 at tp = 2 on two threads whose all-reduces meet at
    a barrier): the activation columns zero-padded to 540 before the two
    pre-pass kernels, each of the four kernels launched once a rank, and
    every rank's output bit-equal to `w8a8_matmul_plain` over the unpadded
    weight."""
    import threading

    from openvla_probe_tpu_torch.parallel import distributed as tdist
    from openvla_probe_tpu_torch.parallel import mesh as tmesh
    from openvla_probe_tpu_torch.parallel import sharding as tsharding
    from openvla_probe_tpu_torch.parallel import tensor_parallel as tp

    barrier, posted = threading.Barrier(2, timeout=60), {}

    def all_reduce(t, op, rank, tag="all_reduce"):
        posted[(op, rank)] = t.clone()
        barrier.wait()
        red = torch.maximum(posted[(op, 0)], posted[(op, 1)]) if op == "max" else \
            posted[(op, 0)] + posted[(op, 1)]
        barrier.wait()
        return t.copy_(red)

    monkeypatch.setattr(tdist, "all_reduce", all_reduce)
    monkeypatch.setattr(tp, "tp_coord", lambda w: (w["mesh"].coord("tp"), 2,
                                                   w["mesh"].coord("tp")))
    M, K, N = 333, 1076, 1152
    x = _rand(11, (M, K), dtype, cuda) * 3
    x[1] = 0
    leaf = {k: v.cpu() for k, v in
            tlin.quantize_weight(_rand(12, (N, K), torch.float32, cuda) * 0.02).items()}
    want = tlin.w8a8_matmul_plain(x, {k: v.to(cuda) for k, v in leaf.items()})
    placed = []
    for r in range(2):
        mesh = tmesh.Mesh({"tp": 2}, rank=r)
        spec = tsharding.shard_params({"o_proj": leaf}, mesh, "tp", "llm/layers")["o_proj"]
        p = tsharding.place_leaf("llm/layers/o_proj", leaf, spec, mesh)
        p["local"] = {k: v.to(cuda) for k, v in p["local"].items()}
        placed.append(p)
    assert placed[0]["k_valid"] == 538 and tp.tp_role(placed[0]) == "row"
    outs = [None, None]

    def rank(r):
        with torch.no_grad():
            outs[r] = tp.matmul(x[:, 538 * r:538 * (r + 1)], placed[r], "w8a8")

    _build.reset_launch_counts()
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    torch.cuda.synchronize()
    for name in ("w8a8_row_absmax", "w8a8_quant_given", "w8a8_matmul_i32", "w8a8_epilogue"):
        assert _build.KERNEL_LAUNCHES[name] == 2, name
    for out in outs:
        assert torch.equal(out, want)
