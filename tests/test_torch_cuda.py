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
``cluster_launchers``).
"""

import numpy as np
import pytest
import torch

from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import decode_attention as tdec
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
