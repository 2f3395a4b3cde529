"""Verified speculative decode of the port against the JAX package's on the
tiers whose every linear quantizes its activations (turbo over int8 and
nibble weights, pallas over grouped int4), on the CPU at tiny sizes: the
checks of test_torch_speculative.py (four drafts, the taps, the verify
logits), whose module docstring states the tolerances and the margins, and
the route each M takes on nibble weights.

* Nibble routes, seen by spying on both packages' nibble dispatch: the
  verify trunk at M = B·(T + A) reads the exact int8 codes, the lm_head of
  the verify's greedy tokens at M = B·A reads the hi plane exactly when
  B·A <= 32 (B = 3: M = 21; B = 5: M = 35), every continuation step (M = B)
  the hi plane. Both packages make the same choices (ROADMAP Queue 3's
  hazard: on nibble weights the verify and the sequential decode read
  different weight grids).
"""

import numpy as np
import pytest

import openvla_probe_tpu.ops.linear as jlin
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_openvla import _ovla_env  # noqa: F401 (autouse)
from tests.test_torch_probe_taps import TIERS, _inputs
from tests.test_torch_speculative import (A, DRAFTS, P, _build, _jax_spec, _port_spec,
                                          check_spec_core, check_spec_tap, check_verify_logits,
                                          runs)  # noqa: F401 (module-scoped fixture)

QUANT_TIERS = ("turbo", "pallas_int4", "turbo_nibble")


@pytest.mark.parametrize("kind", DRAFTS)
@pytest.mark.parametrize("name", QUANT_TIERS)
def test_spec_core_matches_jax(runs, name, kind):
    check_spec_core(runs, name, kind)


@pytest.mark.parametrize("name", QUANT_TIERS)
def test_spec_tap_matches_jax_and_the_core(runs, name):
    check_spec_tap(runs, name)


@pytest.mark.parametrize("name", QUANT_TIERS)
def test_verify_logits_match_jax(runs, name):
    check_verify_logits(runs, name)


class _JaxNibbleSpy:
    """Records (M, plane) of every JAX nibble dot: 'hi' where `_nib_hi_dot`
    ran inside `_nib_matmul`, else 'exact' (the int8 reconstruction)."""

    def __init__(self, mp):
        self.seen = set()
        real_matmul, real_hi = jlin._nib_matmul, jlin._nib_hi_dot
        hi_calls = []

        def hi(*a, **kw):
            hi_calls.append(1)
            return real_hi(*a, **kw)

        def nib(x2, w, *a):
            n = len(hi_calls)
            out = real_matmul(x2, w, *a)
            self.seen.add((int(x2.shape[0]), "hi" if len(hi_calls) > n else "exact"))
            return out

        mp.setattr(jlin, "_nib_hi_dot", hi)
        mp.setattr(jlin, "_nib_matmul", nib)


class _PortNibbleSpy:
    """The same record from the port's `nib_matmul` and its two routes."""

    def __init__(self, mp):
        self.seen = set()
        real_matmul, real_hi = tlin.nib_matmul, tlin.nib_hi_dot_ste
        hi_calls = []

        def hi(*a, **kw):
            hi_calls.append(1)
            return real_hi(*a, **kw)

        def nib(x2, w, *a):
            n = len(hi_calls)
            out = real_matmul(x2, w, *a)
            self.seen.add((int(x2.shape[0]), "hi" if len(hi_calls) > n else "exact"))
            return out

        mp.setattr(tlin, "nib_hi_dot_ste", hi)
        mp.setattr(tlin, "nib_matmul", nib)


@pytest.mark.parametrize("B", [3, 5])
def test_nibble_route_of_each_m(B):
    """B = 3: the greedy lm_head at M = B·A = 21 reads the hi plane; B = 5:
    at M = 35 the exact codes. A wrong draft runs the continuation (M = B)."""
    name = "turbo_nibble"
    serving, params, tserving, tparams = _build(name)
    vocab = TIERS[name][3]
    img, ids, plen, q01, q99, mask = _inputs(vocab)
    r = np.random.default_rng(B)
    rows = r.integers(0, 3, B)                       # B requests drawn from the 3
    inputs = (img[rows], ids[rows], plen[rows], q01, q99, mask)
    wrong = r.integers(0, vocab, (B, A)).astype(np.int32)
    T = 1 + serving.vlm.num_patches + P - 1
    with pytest.MonkeyPatch.context() as mp:
        jspy = _JaxNibbleSpy(mp)
        jout = _jax_spec(name, serving, params, inputs, wrong)
    with pytest.MonkeyPatch.context() as mp:
        tspy = _PortNibbleSpy(mp)
        tout = _port_spec(tserving, tparams, inputs, wrong)
    greedy = "hi" if B * A <= tlin.NIB_HI_M_MAX else "exact"
    assert tspy.seen == {(B * (T + A), "exact"), (B * A, greedy), (B, "hi")}, tspy.seen
    assert jspy.seen == tspy.seen
    assert int(tout["n_accepted"].min()) < A - 1      # the continuation ran
    np.testing.assert_array_equal(tout["action_tokens"], jout["action_tokens"])
    np.testing.assert_array_equal(tout["n_accepted"], jout["n_accepted"])


