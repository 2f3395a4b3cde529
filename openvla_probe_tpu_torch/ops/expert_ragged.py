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
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from . import _build
from .linear import (_within_one_bf16_step, dequantize_weight, int8_copy, is_grouped_int4,
                     is_int8_per_channel, is_lora_wrapped, is_mixed_quant, is_nibble_quant)

_NO_VJP = ("the grouped expert product has no backward: MoE training (the router's aux loss, "
           "the grouped product's gradients) is ROADMAP Queue 1 item 13")


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
    _build.no_grad_guard("expert_ragged", _NO_VJP, x, w)
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


def expert_ragged(x: torch.Tensor, w: Any, group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped product of expert-sorted rows x [M, I] with an expert-stacked
    weight leaf (the module docstring's four forms) -> [M, O] in x's dtype;
    `group_sizes` int32 [E] on x's device."""
    if is_lora_wrapped(w):
        y = expert_ragged(x, w["base"], group_sizes)
        t = _ragged(x, w["A"].to(x.dtype).contiguous(), None, group_sizes)
        return y + _ragged(t, w["B"].to(x.dtype).contiguous(), None, group_sizes)
    if is_nibble_quant(w):
        raise NotImplementedError(
            "expert_ragged: nibble-plane expert leaves have no form in the JAX package's "
            "_expert_ragged (quantize MoE trunks with bits=8, 4 or 'mix')")
    if is_grouped_int4(w):
        return _ragged(x, dequantize_weight(w, x.dtype), None, group_sizes)
    if is_mixed_quant(w):
        w = int8_copy(w)
    if is_int8_per_channel(w):
        return _ragged(x, w["q"], w["s"], group_sizes)
    if isinstance(w, dict):
        raise NotImplementedError(f"expert_ragged: an expert leaf of keys {sorted(w)}")
    return _ragged(x, w.to(x.dtype), None, group_sizes)


def compare_expert_ragged(got: torch.Tensor, want: torch.Tensor, max_share: float = 2e-2) -> dict:
    """Hold a kernel output `got` to `expert_ragged_plain`'s `want`: the same
    exact products (bf16 x bf16, or bf16 x a widened code) summed in fp32 in
    another order, times the same scale, one rounding. bf16: every element
    within one bf16 step of want (the step floored at 1/1024 of the largest
    |want|), at most max(16, max_share of them) apart; fp32 (the scalar
    route): within 1e-5 of the largest |want| (`linear._within_one_bf16_step`).
    Raises AssertionError; returns the distances."""
    return _within_one_bf16_step(got, want, 1 / 1024, max_share, "expert_ragged")


def misrounded(out: torch.Tensor, x: torch.Tensor, w: torch.Tensor, s: Optional[torch.Tensor],
               group_sizes: torch.Tensor) -> int:
    """The outputs of a bf16 result `out` of the kernel's function that are
    not the correctly rounded value: against an fp64 reference computed one
    expert at a time (x · w[e]ᵀ [· s[e]], exact to far below a bf16 step), an
    output counts where it lies more than half a bf16 step from the
    reference (a bf16 value nearer to it exists; a tie counts as rounded).
    Rows past the groups' sum are not counted."""
    M, n_off, start = x.shape[0], 0, 0
    for e, n in enumerate(group_sizes.tolist()):
        n = max(0, min(int(n), M - start))
        if n:
            ref = torch.matmul(x[start:start + n].double(), w[e].double().t())
            if s is not None:
                ref = ref * s[e].double()
            # |ref| in [2^(p-1), 2^p): bf16 steps of 2^(p-8) there, half a step 2^(p-9)
            half = torch.ldexp(torch.ones_like(ref), torch.frexp(ref).exponent - 9)
            d = (out[start:start + n].double() - ref).abs()
            n_off += int(torch.where(ref == 0, d > 0, d > half).sum())
        start += n
    return n_off
