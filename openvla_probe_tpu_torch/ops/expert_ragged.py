"""The grouped expert product of the sparse-MoE trunk (counterpart of
``openvla_probe_tpu/models/moe.py::_expert_ragged``, which is
``lax.ragged_dot_general``).

``expert_ragged(x, w, group_sizes)`` computes ``y[m] = x[m] · w[e(m)]ᵀ`` for
rows x ``[M, I]`` sorted by expert (``group_sizes[e]`` rows of expert e, in
expert order; rows past their sum come out 0) against an expert stack
``[E, O, I]``, in the four weight forms of the JAX function (whose per-row
expert ids ``e_row`` the port does not need: the kernel and its plain version
find each row's expert from the group sizes):

* bf16 / fp32 weights: cast to x's dtype, the product in fp32, one cast to
  x's dtype;
* weight-only int8 ``{"q" [E, O, I], "s" fp32 [E, O]}`` (a mix leaf's int8
  copy too): the codes widened to x's dtype (exact), the product in fp32,
  then ``acc · s[e(m), o]``, then one cast;
* grouped int4: dequantized to x's dtype in PyTorch, then the float form
  (the JAX "footprint form");
* streamed LoRA ``{"base", "A" [E, r, I], "B" [E, O, r]}``: the base, plus
  two more launches of the same kernel (x · Aᵀ, then · Bᵀ).

On the card each weight tensor is one launch of ``csrc/expert_ragged.cu``:
the tensor-core routes (``expert_ragged``) where `ragged_mma_eligible` holds,
the scalar route (``expert_ragged_scalar``, counted apart) otherwise. Of the
two tensor-core routes the wrapper picks one from M alone
(`ragged_prefill_route`): wgmma on a persistent grid above `DECODE_ROWS`
rows, the split-K weight stream at or below it; both count as
``expert_ragged``. The group sizes stay on the device (int32): the kernel
reads them itself, so no product waits on the card. `expert_ragged_plain` is
the function on a CPU tensor (a loop over experts, which reads the group
sizes on the host); `misrounded` counts a result's outputs off the correctly
rounded value of an fp64 reference.

Under grad each weight tensor's product is `_ExpertRaggedFn`, whose backward
is two more kernels of ``csrc/expert_ragged_bwd.cu`` (the counterpart of
XLA's transpose of ``ragged_dot_general``), wgmma fed by TMA on a persistent
grid:

* `expert_ragged_dx`: dx [M, I] = dy[m] · w[e(m)], for codes
  (dy[m] ⊙ s[e(m)]) · q[e(m)] (the fp32 scaled cotangent as two fp16 terms,
  scaled by a power of two a row and stage, against the codes widened once
  a stage), fp32 sums, one cast to dy's dtype; tiled by `dx_tiling` (the
  contraction split across CTAs where the tiles alone leave the card short:
  a LoRA dy · B);
* `expert_ragged_dw`: dW [E, O, I] = Σ over expert e's rows of dy[m]ᵀ x[m],
  fp32 sums, one cast to x's dtype; only for a float weight that requires
  grad (a LoRA factor, or a float stack under full fine-tuning); tiled by
  `dw_tiling` (128 channels of the wider operand x 64 or 128 of the other),
  the rows split by `dw_split_rows`.

int8 codes and their scales take no gradient (the dense STEs' rule: the
quantized base is frozen). The LoRA form's three products are three
Functions, whose backwards autograd composes. `expert_ragged_dx_plain` and
`expert_ragged_dw_plain` are their functions on a CPU tensor.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from . import _build
from .linear import (_within_one_bf16_step, dequantize_weight, int8_copy, is_grouped_int4,
                     is_int8_per_channel, is_lora_wrapped, is_mixed_quant, is_nibble_quant)

_NO_VJP = "it is the backward of the grouped expert product and has no backward of its own"

# the most rows the decode route takes (csrc/expert_ragged.cu's kDecodeRows)
DECODE_ROWS = 64


def ragged_mma_eligible(x: torch.Tensor, w: torch.Tensor) -> bool:
    """The tensor-core routes' rule: bf16 x, bf16 weights or int8 codes, the
    out-dim O a multiple of 8, the in-dim I a multiple of 16 for int8 codes
    or of 8 for bf16 weights (the TMA maps' 16-byte rows of x and of the
    weights), x and w 16-byte aligned. Everything else takes the scalar
    route."""
    I, O = x.shape[-1], w.shape[-2]
    return (x.dtype == torch.bfloat16 and w.dtype in (torch.bfloat16, torch.int8)
            and I % (16 if w.dtype == torch.int8 else 8) == 0 and O % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def ragged_prefill_route(M: int) -> bool:
    """The tensor-core route for M rows: the wgmma route on a persistent grid
    above DECODE_ROWS (a prefill), the split-K weight stream at or below it
    (a decode step's 2·B rows)."""
    return M > DECODE_ROWS


def expert_ragged_plain(x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """The kernel's function for one weight tensor: w [E, O, I] in x's dtype
    (s None) or int8 codes with scales s fp32 [E, O]. Each expert's rows
    times its weights in fp32 (full fp32, no TF32), then ``· s[e]`` for
    codes, one cast to x's dtype; rows past the groups' sum 0. A loop over
    experts that reads the group sizes on the host."""
    M, O = x.shape[0], w.shape[1]
    acc = torch.zeros((M, O), dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        n = max(0, min(int(n), M - start))
        if n:
            rows = torch.matmul(x[start:start + n].float(), w[e].float().t())
            acc[start:start + n] = rows if s is None else rows * s[e]
        start += n
    return acc.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
           group_sizes: torch.Tensor) -> None:
    E, O, I = w.shape
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"expert_ragged: x must be bf16 or fp32, got {x.dtype}")
    if w.dtype not in (x.dtype, torch.int8) or (w.dtype == torch.int8) != (s is not None):
        raise TypeError(f"expert_ragged: weights must be {x.dtype}, or int8 codes with scales")
    named = {"x": (x, (x.shape[0], I)), "w": (w, (E, O, I)), "group_sizes": (group_sizes, (E,))}
    if s is not None:
        named["s"] = (s, (E, O))
    for name, (t, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"expert_ragged: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"expert_ragged: {name} must be contiguous on {x.device}")
    if group_sizes.dtype != torch.int32 or (s is not None and s.dtype != torch.float32):
        raise TypeError("expert_ragged: group_sizes must be int32 and scales fp32")


def _ragged(x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
            group_sizes: torch.Tensor) -> torch.Tensor:
    """One launch over one weight tensor (float in x's dtype, or int8 codes
    with scales), or the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return expert_ragged_plain(x, w, s, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"expert_ragged: unsupported device {x.device}")
    _check(x, w, s, group_sizes)
    M, I = x.shape
    E, O = w.shape[:2]
    out = torch.empty((M, O), dtype=x.dtype, device=x.device)
    if M == 0:
        return out
    int8 = int(w.dtype == torch.int8)
    ptrs = (x.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
            group_sizes.data_ptr(), out.data_ptr(), M, O, I, E)
    if ragged_mma_eligible(x, w):
        kernel = "expert_ragged"
        err = _build.launcher(kernel)(*ptrs, int8, int(ragged_prefill_route(M)),
                                      _build.stream_ptr(x))
    else:
        kernel = "expert_ragged_scalar"
        err = _build.launcher(kernel)(*ptrs, int(x.dtype == torch.bfloat16), int8,
                                      _build.stream_ptr(x))
    _build.check(err, kernel)
    _build.KERNEL_LAUNCHES[kernel] += 1
    return out


class _ExpertRaggedFn(torch.autograd.Function):
    """One weight tensor's grouped product under grad: the forward launch;
    backward dx by `expert_ragged_dx` and, for a float weight that requires
    grad, dW by `expert_ragged_dw`. Codes and scales get None (frozen)."""

    @staticmethod
    def forward(ctx, x, w, s, group_sizes):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w, s, group_sizes)
        return _ragged(x, w, s, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, s, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dx = expert_ragged_dx(dy, w, s, group_sizes) if ctx.needs_input_grad[0] else None
        dw = (expert_ragged_dw(dy, x, group_sizes, w.shape[0])
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None, None


def _product(x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
             group_sizes: torch.Tensor) -> torch.Tensor:
    """One weight tensor's product: `_ExpertRaggedFn` where autograd records
    and an input requires grad, else the launch."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, w, s)):
        return _ExpertRaggedFn.apply(x, w, s, group_sizes)
    return _ragged(x, w, s, group_sizes)


# --- the backward: dx and dW --------------------------------------------------------

# the backward's tiles (csrc/expert_ragged_bwd.cu): 128 rows of dy (dx) or channels of the
# wider operand (dW) a tile, the contraction in stages of DX_STAGE; where the output's tiles
# alone leave the card short, the contraction is cut into chunks across CTAs so that about
# DW_TARGET_BLOCKS items have work (dW: even when one expert holds every row)
DW_TILE = 128
DX_STAGE = 64      # csrc kBK, ovla_expert_ragged_bwd_stage()
DX_FULL_TILES = 132   # dx tiles that fill the card's SMs without a split
DW_TARGET_BLOCKS = 264
DW_ROW_STEP = 64   # a chunk is a whole number of the kernel's 64-row stages


def expert_ragged_dx_plain(dy: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
                           group_sizes: torch.Tensor) -> torch.Tensor:
    """dx [M, I] of the product `expert_ragged_plain` computes: each expert's
    rows of dy [M, O] (for codes ``dy · s[e]`` in fp32, as XLA's transpose
    scales the fp32 cotangent) times w[e] [O, I] in fp32 (full fp32, no
    TF32), one cast to dy's dtype; rows past the groups' sum 0. A loop over
    experts that reads the group sizes on the host."""
    M, I = dy.shape[0], w.shape[2]
    acc = torch.zeros((M, I), dtype=torch.float32, device=dy.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        n = max(0, min(int(n), M - start))
        if n:
            a = dy[start:start + n].float()
            acc[start:start + n] = torch.matmul(a if s is None else a * s[e], w[e].float())
        start += n
    return acc.to(dy.dtype)


def expert_ragged_dw_plain(dy: torch.Tensor, x: torch.Tensor, group_sizes: torch.Tensor,
                           E: int) -> torch.Tensor:
    """dW [E, O, I]: for each expert the sum over its rows of dy[m]ᵀ x[m]
    (dy [M, O], x [M, I]) in fp32, one cast to x's dtype; an expert with no
    rows 0, rows past the groups' sum in no sum. A loop over experts that
    reads the group sizes on the host."""
    M, O, I = dy.shape[0], dy.shape[1], x.shape[1]
    acc = torch.zeros((E, O, I), dtype=torch.float32, device=dy.device)
    start = 0
    for e, n in enumerate(group_sizes.tolist()):
        n = max(0, min(int(n), M - start))
        if n:
            acc[e] = torch.matmul(dy[start:start + n].float().t(), x[start:start + n].float())
        start += n
    return acc.to(x.dtype)


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def ragged_dx_mma_eligible(dy: torch.Tensor, w: torch.Tensor) -> bool:
    """`expert_ragged_dx`'s tensor-core rule, what its TMA maps need: bf16 dy,
    bf16 weights or int8 codes, O a multiple of 8 (dy's rows a multiple of
    16 bytes), I a multiple of 16 for codes or of 8 for bf16 (the weights'),
    dy and w 16-byte aligned. Everything else takes
    ``expert_ragged_dx_scalar``."""
    O, I = w.shape[-2], w.shape[-1]
    return (dy.dtype == torch.bfloat16 and w.dtype in (torch.bfloat16, torch.int8)
            and O % 8 == 0 and I % (16 if w.dtype == torch.int8 else 8) == 0
            and _aligned(dy, w))


def ragged_dw_mma_eligible(dy: torch.Tensor, x: torch.Tensor) -> bool:
    """`expert_ragged_dw`'s tensor-core rule, what its TMA maps need: bf16 dy
    and x, O and I multiples of 8 (rows a multiple of 16 bytes), both
    16-byte aligned. Everything else takes ``expert_ragged_dw_scalar``."""
    return (dy.dtype == torch.bfloat16 and x.dtype == torch.bfloat16
            and dy.shape[-1] % 8 == 0 and x.shape[-1] % 8 == 0 and _aligned(dy, x))


def dx_tiling(M: int, O: int, I: int, codes: bool) -> Tuple[int, int]:
    """(tile_n, splits) of `expert_ragged_dx`'s tensor-core route, a pure
    function of the shapes (so two calls sum in the same order): tiles of
    128 rows x tile_n columns of I, tile_n = 64 for bf16 weights with I <= 64
    (a LoRA dy · B, N = r), else 128 (int8 codes always); the contraction O
    in one pass (splits = 1) where ceil(M / 128) row tiles x the column tiles
    reach DX_FULL_TILES, else cut into `splits` chunks (at least two stages
    each) for about DW_TARGET_BLOCKS items, whose fp32 partials a second grid
    adds in chunk order."""
    tile_n = 128 if codes or I > 64 else 64
    tiles = -(-M // DW_TILE) * -(-I // tile_n)
    if tiles >= DX_FULL_TILES:
        return tile_n, 1
    return tile_n, max(1, min(-(-DW_TARGET_BLOCKS // tiles), -(-O // DX_STAGE) // 2))


def dw_tiling(O: int, I: int) -> Tuple[bool, int]:
    """(transposed, tile_n) of `expert_ragged_dw`'s tensor-core route
    (csrc's ovla_expert_ragged_dw picks the same): tiles of 128 channels of
    the wider operand (dy where O >= I; x where O < I, dW's transpose
    computed and stored transposed) x tile_n of the other, 64 where that side
    is <= 64 (a LoRA factor's r), else 128."""
    transposed = O < I
    return transposed, 64 if min(O, I) <= 64 else 128


def dw_split_rows(M: int, O: int, I: int) -> int:
    """The rows of one chunk of dW's split (a pure function of the shapes, so
    two calls sum in the same order): M, one pass written straight to dW,
    where the output's tiles (`dw_tiling`) alone give DW_TARGET_BLOCKS
    blocks; else the fewest chunks (a multiple of DW_ROW_STEP rows each) that
    do, each chunk's fp32 partials added in chunk order by a second pass."""
    _, tile_n = dw_tiling(O, I)
    tiles = -(-max(O, I) // DW_TILE) * -(-min(O, I) // tile_n)
    chunks = min(-(-DW_TARGET_BLOCKS // tiles), -(-M // DW_TILE))
    if chunks <= 1:
        return M
    return -(-M // (chunks * DW_ROW_STEP)) * DW_ROW_STEP


def _check_bwd(kernel: str, named: dict, device) -> None:
    for name, (t, shape) in named.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} must be {shape}, got {tuple(t.shape)}")
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous on {device}")


def expert_ragged_dx(dy: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
                     group_sizes: torch.Tensor) -> torch.Tensor:
    """dx [M, I] of one weight tensor's grouped product (the function of
    `expert_ragged_dx_plain`): dy [M, O] bf16 or fp32, w [E, O, I] in dy's
    dtype or int8 codes with s fp32 [E, O], group_sizes int32 [E] on dy's
    device. On the card the tensor-core route where `ragged_dx_mma_eligible`
    holds (``expert_ragged_dx``, tiled by `dx_tiling`: with splits > 1 a
    second grid adds the chunks' fp32 partials in chunk order; one count a
    call), ``expert_ragged_dx_scalar`` otherwise. No atomics: two runs give
    the same bits."""
    _build.no_grad_guard("expert_ragged_dx", _NO_VJP, dy, w)
    if dy.device.type == "cpu":
        return expert_ragged_dx_plain(dy, w, s, group_sizes)
    if dy.device.type != "cuda":
        raise ValueError(f"expert_ragged_dx: unsupported device {dy.device}")
    E, O, I = w.shape
    M = dy.shape[0]
    if dy.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"expert_ragged_dx: dy must be bf16 or fp32, got {dy.dtype}")
    if w.dtype not in (dy.dtype, torch.int8) or (w.dtype == torch.int8) != (s is not None):
        raise TypeError(f"expert_ragged_dx: weights must be {dy.dtype}, or int8 codes with scales")
    named = {"dy": (dy, (M, O)), "w": (w, (E, O, I)), "group_sizes": (group_sizes, (E,))}
    if s is not None:
        named["s"] = (s, (E, O))
    _check_bwd("expert_ragged_dx", named, dy.device)
    if group_sizes.dtype != torch.int32 or (s is not None and s.dtype != torch.float32):
        raise TypeError("expert_ragged_dx: group_sizes must be int32 and scales fp32")
    dx = torch.empty((M, I), dtype=dy.dtype, device=dy.device)
    if M == 0:
        return dx
    int8 = int(w.dtype == torch.int8)
    heads = (dy.data_ptr(), w.data_ptr(), None if s is None else s.data_ptr(),
             group_sizes.data_ptr())
    if ragged_dx_mma_eligible(dy, w):
        kernel = "expert_ragged_dx"
        tile_n, splits = dx_tiling(M, O, I, bool(int8))
        ws = (torch.empty(splits * M * I, dtype=torch.float32, device=dy.device)
              if splits > 1 else None)
        err = _build.launcher(kernel)(*heads, None if ws is None else ws.data_ptr(),
                                      dx.data_ptr(), M, O, I, E, int8, tile_n, splits,
                                      _build.stream_ptr(dy))
    else:
        kernel = "expert_ragged_dx_scalar"
        err = _build.launcher(kernel)(*heads, dx.data_ptr(), M, O, I, E,
                                      int(dy.dtype == torch.bfloat16), int8,
                                      _build.stream_ptr(dy))
    _build.check(err, kernel)
    _build.KERNEL_LAUNCHES[kernel] += 1
    return dx


def expert_ragged_dw(dy: torch.Tensor, x: torch.Tensor, group_sizes: torch.Tensor,
                     E: int) -> torch.Tensor:
    """dW [E, O, I] of one float weight tensor's grouped product (the
    function of `expert_ragged_dw_plain`): dy [M, O] and x [M, I] in one
    dtype (bf16 or fp32), group_sizes int32 [E] on their device. On the card
    the tensor-core route where `ragged_dw_mma_eligible` holds
    (``expert_ragged_dw``: with `dw_split_rows` below M, a second grid adds
    the chunks' fp32 partials in chunk order; one count a call),
    ``expert_ragged_dw_scalar`` otherwise. No atomics: two runs give the same
    bits."""
    _build.no_grad_guard("expert_ragged_dw", _NO_VJP, dy, x)
    if dy.device.type == "cpu":
        return expert_ragged_dw_plain(dy, x, group_sizes, E)
    if dy.device.type != "cuda":
        raise ValueError(f"expert_ragged_dw: unsupported device {dy.device}")
    M, O, I = dy.shape[0], dy.shape[1], x.shape[1]
    if dy.dtype not in (torch.bfloat16, torch.float32) or x.dtype != dy.dtype:
        raise TypeError(f"expert_ragged_dw: dy and x must share bf16 or fp32, got "
                        f"{dy.dtype}, {x.dtype}")
    _check_bwd("expert_ragged_dw", {"dy": (dy, (M, O)), "x": (x, (M, I)),
                                    "group_sizes": (group_sizes, (E,))}, dy.device)
    if group_sizes.dtype != torch.int32:
        raise TypeError("expert_ragged_dw: group_sizes must be int32")
    dw = torch.empty((E, O, I), dtype=x.dtype, device=x.device)
    if M == 0:
        return dw.zero_()
    if ragged_dw_mma_eligible(dy, x):
        kernel = "expert_ragged_dw"
        rows = dw_split_rows(M, O, I)
        ws = None
        if rows < M:   # the chunks' fp32 partials: at most one per chunk and one per expert
            ws = torch.empty((-(-M // rows) + E) * O * I, dtype=torch.float32, device=x.device)
        err = _build.launcher(kernel)(dy.data_ptr(), x.data_ptr(), group_sizes.data_ptr(),
                                      None if ws is None else ws.data_ptr(), dw.data_ptr(),
                                      M, O, I, E, rows, _build.stream_ptr(x))
    else:
        kernel = "expert_ragged_dw_scalar"
        err = _build.launcher(kernel)(dy.data_ptr(), x.data_ptr(), group_sizes.data_ptr(),
                                      dw.data_ptr(), M, O, I, E, int(x.dtype == torch.bfloat16),
                                      _build.stream_ptr(x))
    _build.check(err, kernel)
    _build.KERNEL_LAUNCHES[kernel] += 1
    return dw


def expert_ragged(x: torch.Tensor, w: Any, group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped product of expert-sorted rows x [M, I] with an expert-stacked
    weight leaf (the module docstring's four forms) -> [M, O] in x's dtype;
    `group_sizes` int32 [E] on x's device."""
    if is_lora_wrapped(w):
        y = expert_ragged(x, w["base"], group_sizes)
        t = _product(x, w["A"].to(x.dtype).contiguous(), None, group_sizes)
        return y + _product(t, w["B"].to(x.dtype).contiguous(), None, group_sizes)
    if is_nibble_quant(w):
        raise NotImplementedError(
            "expert_ragged: nibble-plane expert leaves have no form in the JAX package's "
            "_expert_ragged (quantize MoE trunks with bits=8, 4 or 'mix')")
    if is_grouped_int4(w):
        return _product(x, dequantize_weight(w, x.dtype), None, group_sizes)
    if is_mixed_quant(w):
        w = int8_copy(w)
    if is_int8_per_channel(w):
        return _product(x, w["q"], w["s"], group_sizes)
    if isinstance(w, dict):
        raise NotImplementedError(f"expert_ragged: an expert leaf of keys {sorted(w)}")
    return _product(x, w.to(x.dtype), None, group_sizes)


def compare_expert_ragged(got: torch.Tensor, want: torch.Tensor, max_share: float = 2e-2) -> dict:
    """Hold a kernel output `got` to `expert_ragged_plain`'s `want`: the same
    exact products (bf16 x bf16, or bf16 x a widened code) summed in fp32 in
    another order, times the same scale, one rounding. bf16: every element
    within one bf16 step of want (the step floored at 1/1024 of the largest
    |want|), at most max(16, max_share of them) apart; fp32 (the scalar
    route): within 1e-5 of the largest |want| (`linear._within_one_bf16_step`).
    Raises AssertionError; returns the distances."""
    return _within_one_bf16_step(got, want, 1 / 1024, max_share, "expert_ragged")


def _off_rounding(out: torch.Tensor, ref: torch.Tensor) -> int:
    """Outputs of a bf16 result more than half a bf16 step from an fp64
    reference (a bf16 value nearer to it exists; a tie counts as rounded)."""
    # |ref| in [2^(p-1), 2^p): bf16 steps of 2^(p-8) there, half a step 2^(p-9)
    half = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 9)
    d = (out.double() - ref).abs()
    return int(torch.where(ref == 0, d > 0, d > half).sum())


def misrounded(out: torch.Tensor, x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
               group_sizes: torch.Tensor) -> int:
    """The outputs of a bf16 result `out` of the kernel's function that are
    not the correctly rounded value: against an fp64 reference computed one
    expert at a time (x · w[e]ᵀ [· s[e]], exact to far below a bf16 step), an
    output counts where it lies more than half a bf16 step from the
    reference. Rows past the groups' sum are not counted."""
    M, n_off, start = x.shape[0], 0, 0
    for e, n in enumerate(group_sizes.tolist()):
        n = max(0, min(int(n), M - start))
        if n:
            ref = torch.matmul(x[start:start + n].double(), w[e].double().t())
            if s is not None:
                ref = ref * s[e].double()
            n_off += _off_rounding(out[start:start + n], ref)
        start += n
    return n_off


def misrounded_dx(dx: torch.Tensor, dy: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
                  group_sizes: torch.Tensor) -> int:
    """`misrounded` for a bf16 dx of `expert_ragged_dx`'s function: the fp64
    reference (dy[m] [· s[e]]) · w[e] one expert at a time, the scaled
    cotangent rounded to fp32 first as the function takes it."""
    M, n_off, start = dy.shape[0], 0, 0
    for e, n in enumerate(group_sizes.tolist()):
        n = max(0, min(int(n), M - start))
        if n:
            a = dy[start:start + n].float()
            a = (a if s is None else a * s[e]).double()
            n_off += _off_rounding(dx[start:start + n], torch.matmul(a, w[e].double()))
        start += n
    return n_off
