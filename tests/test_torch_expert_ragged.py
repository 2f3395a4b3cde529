"""The grouped expert product (`ops.expert_ragged`) against the JAX package's
``models/moe.py::_expert_ragged`` (``lax.ragged_dot_general``, XLA on the
CPU), in its four weight forms, on the CPU (the plain version).

Tolerances: fp32 1e-5 relative to the largest |want| (the same fp32 products
summed in another order); bf16 x within one bf16 step of JAX's output at the
largest |want| (one rounding of fp32 sums taken in another order); the LoRA
form within two such steps (the base, the delta and their bf16 sum are three
roundings). Rows past the groups' sum are 0 on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import moe as jmoe
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import expert_ragged as texr
from openvla_probe_tpu_torch.ops import linear as tlin

JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SIZES = {
    "even": [6, 6, 6, 6],
    "empty": [0, 9, 0, 15],        # empty experts, first and in the middle
    "one_row": [1, 1, 20, 2],      # one-row groups
    "decode": [2, 2, 3, 1, 0, 4, 2, 2],   # 16 rows over 8 experts, one empty
}


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(TORCH_DT[dtype])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _case(seed, sizes, I=64, O=40, dtype="float32"):
    """x, a float expert stack, the group sizes and each row's expert (the
    JAX function's e_row)."""
    r = np.random.default_rng(seed)
    E, M = len(sizes), sum(sizes)
    x = jnp.asarray(r.normal(size=(M, I)), JNP_DT[dtype])
    w = jnp.asarray(r.normal(size=(E, O, I)) * 0.1, jnp.float32)
    gs = np.asarray(sizes, np.int32)
    e_row = np.repeat(np.arange(E), sizes).astype(np.int32)
    return x, w, gs, e_row


def _call_both(x, jw, tw, gs, e_row, dtype):
    want = jmoe._expert_ragged(x, jw, jnp.asarray(gs), jnp.asarray(e_row))
    _build.reset_launch_counts()
    got = texr.expert_ragged(_t(x, dtype), tw, torch.from_numpy(gs))
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}    # the CPU takes the plain version
    assert got.dtype == TORCH_DT[dtype] and got.shape == want.shape
    return _np(got), _np(want)


def _close(got, want, dtype, steps=1):
    scale = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=steps * 2.0 ** -8 * 2 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_float_form_matches_jax(dtype, sizes):
    """fp32 / bf16 weights (cast to x's dtype), the product in fp32."""
    x, w, gs, e_row = _case(1, SIZES[sizes], dtype=dtype)
    jw = w.astype(JNP_DT[dtype])
    got, want = _call_both(x, jw, _t(jw, dtype), gs, e_row, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", list(SIZES), ids=list(SIZES))
def test_int8_form_matches_jax(dtype, sizes):
    """Weight-only int8: codes widened to x's dtype, fp32 sums, · s[e_row]."""
    x, w, gs, e_row = _case(2, SIZES[sizes], dtype=dtype)
    jq = jlin.quantize_weight(w)
    tq = {"q": torch.from_numpy(np.array(jq["q"])), "s": torch.from_numpy(np.array(jq["s"]))}
    got, want = _call_both(x, jq, tq, gs, e_row, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes", ["even", "empty"])
def test_int4_form_matches_jax(dtype, sizes):
    """Grouped int4 (group 32 over I = 64): dequantized to x's dtype, then
    the float form; the JAX codes packed into the port's layout."""
    x, w, gs, e_row = _case(3, SIZES[sizes], dtype=dtype)
    jq = jlin.quantize_weight_int4(w, group_size=32)
    codes = np.array(jnp.asarray(jq["q"]).astype(jnp.int8))
    tq = {"q": tlin.pack_int4(torch.from_numpy(codes)), "s": torch.from_numpy(np.array(jq["s"]))}
    assert tlin.is_grouped_int4(tq)
    got, want = _call_both(x, jq, tq, gs, e_row, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("base", ["float", "int8"])
def test_lora_form_matches_jax(dtype, base):
    """Streamed LoRA over a float or int8 base: base + (x Aᵀ) Bᵀ, each
    product grouped."""
    x, w, gs, e_row = _case(4, SIZES["empty"], dtype=dtype)
    r = np.random.default_rng(5)
    A = r.normal(size=(4, 8, 64)).astype(np.float32) * 0.1
    B = r.normal(size=(4, 40, 8)).astype(np.float32) * 0.1
    if base == "int8":
        jb = jlin.quantize_weight(w)
        tb = {"q": torch.from_numpy(np.array(jb["q"])), "s": torch.from_numpy(np.array(jb["s"]))}
    else:
        jb, tb = w.astype(JNP_DT[dtype]), _t(w.astype(JNP_DT[dtype]), dtype)
    jw = {"base": jb, "A": jnp.asarray(A), "B": jnp.asarray(B)}
    tw = {"base": tb, "A": torch.from_numpy(A), "B": torch.from_numpy(B)}
    got, want = _call_both(x, jw, tw, gs, e_row, dtype)
    _close(got, want, dtype, steps=2)


def test_rows_past_the_groups_are_zero():
    """ragged_dot's rule: rows past the group sizes' sum come out 0."""
    x, w, gs, e_row = _case(6, [3, 0, 5])
    x = jnp.concatenate([x, jnp.ones((4, 64), jnp.float32)])
    e_row = np.concatenate([e_row, np.zeros(4, np.int32)])
    got, want = _call_both(x, w, _t(w), gs, e_row, "float32")
    np.testing.assert_array_equal(got[8:], 0.0)
    np.testing.assert_array_equal(want[8:], 0.0)
    _close(got, want, "float32")


def test_nibble_experts_raise():
    """The JAX package's _expert_ragged has no nibble form: the port names it."""
    x = torch.zeros(4, 64)
    w = tlin.quantize_weight_nibble(torch.randn(2, 8, 64))
    with pytest.raises(NotImplementedError, match="nibble"):
        texr.expert_ragged(x, w, torch.tensor([2, 2], dtype=torch.int32))


def test_grad_raises():
    """No backward (MoE training is a later slice): an input under grad raises."""
    x = torch.zeros(4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="item 13"):
        texr.expert_ragged(x, torch.zeros(2, 8, 8), torch.tensor([2, 2], dtype=torch.int32))


@pytest.mark.parametrize("x_dtype,w_dtype,I,O,want", [
    (torch.bfloat16, torch.bfloat16, 4096, 14336, True),    # Mixtral gate / up
    (torch.bfloat16, torch.int8, 14336, 4096, True),        # Mixtral down, int8
    (torch.bfloat16, torch.bfloat16, 64, 8, True),          # a LoRA rank of 8
    (torch.float32, torch.float32, 4096, 14336, False),     # fp32 x: the scalar route
    (torch.float32, torch.int8, 64, 128, False),
    (torch.bfloat16, torch.bfloat16, 60, 128, False),       # I not a multiple of 8
    (torch.bfloat16, torch.int8, 64, 12, False),            # O not a multiple of 8
])
def test_ragged_mma_eligible(x_dtype, w_dtype, I, O, want):
    """The tensor-core route's declared rule (meta tensors: no data)."""
    x = torch.empty((16, I), dtype=x_dtype, device="meta")
    w = torch.empty((8, O, I), dtype=w_dtype, device="meta")
    assert texr.ragged_mma_eligible(x, w) is want


def test_ragged_mma_eligible_needs_alignment():
    """A weight stack 16-byte aligned on the tensor cores, one off it not."""
    buf = torch.zeros(2 * 8 * 64 + 1, dtype=torch.bfloat16)
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    assert texr.ragged_mma_eligible(x, buf[:-1].view(2, 8, 64))
    assert not texr.ragged_mma_eligible(x, buf[1:].view(2, 8, 64))
