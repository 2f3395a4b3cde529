"""The STE backward of the grouped-int4 products (Queue 2 row 9,
``w4a8_dx``) and the port's straight-through autograd Functions vs the JAX
package, on the CPU at tiny sizes.

* ``w4a8_dx_plain`` vs ``_w4a8_dx_pallas(interpret=True)`` at gsz 128: the
  same bf16(g · s) products summed in fp32 in another order, held by
  ``linear.compare_w4a8_dx`` (fp32 within 1e-5 of the largest output; bf16
  one bf16 step, on at most 2 % of the elements).
* The XLA form (``_w4a8_dx_xla``: bf16 dequantized weight, one product)
  where gsz is 64, off the kernel's rule: within 1e-5 of the largest output.
* ``torch.autograd.grad`` through ``matmul_t`` vs ``jax.grad`` through the JAX
  ``matmul_t`` on four routes: grouped int4 under the kernel gate (JAX:
  ``OVLA_PALLAS=1``, ``OVLA_PALLAS_INTERPRET=1`` inside
  ``force_tpu_interpret_mode()``; N = 256: the kernel forward and the dx
  kernel), the same gate where N = 200 has no 128 tile (the requant forward,
  the bf16-dequant dx), per-channel int8 on w8a8 and nibble planes (JAX: no
  ``OVLA_*`` set) at decode M (the hi plane) and prefill M (the rebuilt int8
  codes); and the requant route called alone, whose STE dequantizes the
  requantized int8 codes. The forwards within 1e-5 relative (fp32: the same
  codes and integer sums; XLA may fuse the fold), dx within 1e-5 of its
  largest element (the same bf16 products, fp32 sums in another order); the
  frozen weights take no gradient.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch.ops import _build
from openvla_probe_tpu_torch.ops import linear as tlin

GATE = {"OVLA_PALLAS": "1", "OVLA_PALLAS_INTERPRET": "1"}


@contextlib.contextmanager
def jax_env(env):
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for k in [k for k in os.environ if k.startswith("OVLA_")]:
            mp.delenv(k)
        for k, v in env.items():
            mp.setenv(k, v)
        yield


def _int4_pair(rng, n, k, gsz=128):
    w = rng.normal(0, 0.05, (n, k)).astype(np.float32)
    return (jlin.quantize_weight_int4(jnp.asarray(w), group_size=gsz),
            tlin.quantize_weight_int4(torch.from_numpy(w), group_size=gsz))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.array(
        jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,K", [(40, 256, 384), (7, 128, 256)])
def test_plain_matches_jax_kernel(dtype, M, N, K):
    rng = np.random.default_rng(M + N)
    jw, tw = _int4_pair(rng, N, K)
    g = rng.normal(size=(M, N)).astype(np.float32)
    jg = jnp.asarray(g, dtype)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(getattr(torch, dtype))
    with jax_env(GATE):
        want = jlin._w4a8_dx_pallas(jg, jw["q"], jw["s"], interpret=True)
    got = tlin.w4a8_dx(tg, tw["q"], tw["s"])
    assert got.dtype == tg.dtype and got.shape == (M, K)
    tlin.compare_w4a8_dx(got, torch.from_numpy(_np(want)).to(got.dtype))
    torch.testing.assert_close(got, tlin.w4a8_dx_plain(tg, tw["q"], tw["s"]), atol=0, rtol=0)


@pytest.mark.parametrize("M,N,K", [(9, 128, 192), (33, 200, 128)])
def test_xla_form_where_the_kernel_rule_fails(M, N, K):
    """gsz 64 (and N = 200, no 128 tile): the bf16-dequant product."""
    rng = np.random.default_rng(K)
    jw, tw = _int4_pair(rng, N, K, gsz=64)
    g = rng.normal(size=(M, N)).astype(np.float32)
    want = _np(jlin._w4a8_dx_xla(jnp.asarray(g), jw["q"], jw["s"]))
    _build.reset_launch_counts()
    got = tlin.w4a8_dx(torch.from_numpy(g), tw["q"], tw["s"]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(got, tlin.w4a8_dx_xla(torch.from_numpy(g), tw["q"],
                                                        tw["s"]).numpy())
    assert set(_build.KERNEL_LAUNCHES.values()) == {0}


def _weights(route, rng):
    """(jax leaf, port leaf, the port's int8 route, JAX env) of one route."""
    if route in ("int4_kernel", "int4_requant"):
        jw, tw = _int4_pair(rng, 256 if route == "int4_kernel" else 200, 256)
        return jw, tw, "wi8", GATE
    w = rng.normal(0, 0.05, (136, 256)).astype(np.float32)
    if route == "w8a8":
        jw = jlin.quantize_weight(jnp.asarray(w))
        return jw, {k: torch.from_numpy(np.array(v)) for k, v in jw.items()}, "w8a8", {}
    jw = jlin.quantize_weight_nibble(jnp.asarray(w), emit_codes=True)
    tw = tlin.quantize_weight_nibble(torch.from_numpy(w))
    np.testing.assert_array_equal(tlin.unpack_int4(tw["hi"]).numpy(), np.asarray(jw["hi"]))
    return jlin.quantize_weight_nibble(jnp.asarray(w)), tw, "w8a8", {}


@pytest.mark.parametrize("route", ["int4_kernel", "int4_requant", "w8a8", "nibble"])
@pytest.mark.parametrize("M", [8, 40])
def test_grad_through_matmul_t_matches_jax(route, M):
    rng = np.random.default_rng(M)
    jw, tw, int8_route, env = _weights(route, rng)
    x = rng.normal(size=(M, 256)).astype(np.float32)
    gout = rng.normal(size=(M, tw["s"].shape[0])).astype(np.float32)
    with jax_env(env):
        jy, jvjp = jax.vjp(lambda a: jlin.matmul_t(a, jw), jnp.asarray(x))
        (jdx,) = jvjp(jnp.asarray(gout))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = tlin.matmul_t(tx, tw, int8_route)
    (tdx,) = torch.autograd.grad(ty, tx, torch.from_numpy(gout))
    want_y, want_dx = _np(jy), _np(jdx)
    np.testing.assert_allclose(ty.detach().numpy(), want_y, rtol=1e-5,
                               atol=1e-6 * np.abs(want_y).max())
    np.testing.assert_allclose(tdx.numpy(), want_dx, atol=1e-5 * np.abs(want_dx).max(), rtol=0)
    assert all(not t.requires_grad for t in tw.values())


def test_requant_route_alone_dequantizes_the_int8_codes():
    """``w4a8_dot_requant`` under grad: the w8a8 STE over the requantized
    codes q8 · s8 (the JAX ``_w4a8_dot_requant``), not the int4 codes."""
    rng = np.random.default_rng(3)
    jw, tw = _int4_pair(rng, 200, 256)
    x = rng.normal(size=(12, 256)).astype(np.float32)
    gout = rng.normal(size=(12, 200)).astype(np.float32)
    _, jvjp = jax.vjp(lambda a: jlin._w4a8_dot_requant(a, jw["q"], jw["s"]), jnp.asarray(x))
    want = _np(jvjp(jnp.asarray(gout))[0])
    tx = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(tlin.w4a8_dot_requant(tx, tw["q"], tw["s"]), tx,
                                 torch.from_numpy(gout))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=0)
    int4_dx = tlin.w4a8_dx_xla(torch.from_numpy(gout), tw["q"], tw["s"]).numpy()
    assert np.abs(int4_dx - want).max() > 1e-3 * np.abs(want).max()   # a different function


def test_lora_wrapper_over_int4_trains_the_adapters():
    """A streamed-LoRA wrapper over a grouped-int4 base: the adapters get the
    gradients of ``base(x) + (x Aᵀ) Bᵀ``, the base none."""
    rng = np.random.default_rng(4)
    _, tw = _int4_pair(rng, 128, 128)
    A = torch.from_numpy(rng.normal(size=(4, 128)).astype(np.float32)).requires_grad_(True)
    B = torch.from_numpy(rng.normal(size=(128, 4)).astype(np.float32)).requires_grad_(True)
    x = torch.from_numpy(rng.normal(size=(10, 128)).astype(np.float32)).requires_grad_(True)
    y = tlin.matmul_t(x, {"base": tw, "A": A, "B": B})
    gA, gB, gx = torch.autograd.grad(y.square().sum(), (A, B, x))
    gy = 2 * y.detach()
    torch.testing.assert_close(gB, gy.T @ (x.detach() @ A.detach().T))
    torch.testing.assert_close(gA, (gy @ B.detach()).T @ x.detach())
    torch.testing.assert_close(gx, tlin.w4a8_dx(gy, tw["q"], tw["s"]) + gy @ B.detach() @ A.detach())
    with pytest.raises(TypeError, match="PrequantActivation"):
        codes, sx = tlin.quantize_rows(x.detach())
        tlin.matmul_t(tlin.PrequantActivation(codes, sx, torch.float32), {"base": tw, "A": A, "B": B})
