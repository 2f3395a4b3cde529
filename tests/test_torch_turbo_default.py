"""The port's `turbo` tier without the fused RMSNorm -> int8 kernel
(``for_tier(..., "turbo", fused_rmsq=False)``) vs the JAX package's `turbo`
tier at its default environment for that gate, on the CPU at tiny size.

The JAX side runs as ``tests/test_torch_turbo.py::jax_turbo`` but with
``OVLA_PALLAS_RMSQ`` unset, its default (``OVLA_PALLAS=1``,
``OVLA_PALLAS_INTERPRET=1``, ``OVLA_PALLAS_MATMUL=0``, ``OVLA_PALLAS_VITLIN=0``,
``OVLA_PALLAS_VITMLP=0`` inside ``force_tpu_interpret_mode()``, restored
afterwards): every int8 linear quantizes its own activations after a plain
RMSNorm. Int8 TURBO_QUANT_SUFFIXES weights, B = 3, P = 64 (T = 68: the
prefill flash gate engages). Tokens and actions equal; first logits and
margins within 2e-2, for the reasons ``tests/test_torch_turbo.py`` states
(found: 5.7e-3 and 4.9e-3). Token equality is margin-limited at random
weights: at the seed of ``tests/test_torch_turbo.py`` every token's margin
is at least 3.6 times the difference of the two sides' margins (smallest
margin 6.2e-3), and the test holds it to 3 times. Neither side calls the
fused norm.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import openvla_probe_tpu.ops.rmsnorm_quant
from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.ops import linear as jlin
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import llama as tllama
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.ops import linear as tlin

from tests.test_torch_pallas_tier import _img_cfg, _inputs
from tests.test_torch_turbo import count_calls

VOCAB = 512
A = 7
P = 64
ATOL = 2e-2
SEED = 5
ENV = {"OVLA_PALLAS": "1", "OVLA_PALLAS_INTERPRET": "1", "OVLA_PALLAS_MATMUL": "0",
       "OVLA_PALLAS_VITLIN": "0", "OVLA_PALLAS_VITMLP": "0"}


@pytest.fixture(scope="module")
def both():
    serving = jvla.VLAServingConfig.for_tier(jvlm.VLMConfig.tiny(), "turbo", action_dim=A,
                                             prompt_pad_len=P, codec_vocab_size=VOCAB)
    params = jlin.quantize_params(jvlm.init_params(serving.vlm, jax.random.key(SEED)),
                                  suffixes=jlin.TURBO_QUANT_SUFFIXES, bits=8)
    tserving = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo", fused_rmsq=False,
                                              action_dim=A, prompt_pad_len=P,
                                              codec_vocab_size=VOCAB)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu", quant_suffixes=tlin.TURBO_QUANT_SUFFIXES)
    img, ids, plen, q01, q99, mask = _inputs()
    jax_calls, routes = {}, {}
    with pytest.MonkeyPatch.context() as mp, pltpu.force_tpu_interpret_mode():
        for k in [k for k in os.environ if k.startswith("OVLA_")]:
            mp.delenv(k)
        for k, v in ENV.items():
            mp.setenv(k, v)
        count_calls(mp, openvla_probe_tpu.ops.rmsnorm_quant, ["rms_norm_quant"], jax_calls)
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
        want = jax.tree.map(np.asarray, want)
    with pytest.MonkeyPatch.context() as mp:
        count_calls(mp, tlin, ["w8a8_matmul", "wi8_matmul"], routes)
        count_calls(mp, tllama, ["rms_norm_quant"], routes)
        got = tvla.predict_action_from_image(
            tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
            return_first_logits=True, device="cpu")
    return tserving, want, {k: v.numpy() for k, v in got.items()}, routes, jax_calls


def test_config_is_the_turbo_tier_without_the_fused_norm(both):
    tserving = both[0]
    assert (tserving.tier, tserving.decode_impl) == ("turbo", "stacked")
    assert (tserving.vlm.llm.int8_matmul, tserving.vlm.llm.fused_rmsq) == ("w8a8", False)
    default = tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "turbo")
    assert default.vlm.llm.fused_rmsq      # the option's default keeps the fused norm
    with pytest.raises(ValueError, match="turbo"):
        tvla.VLAServingConfig.for_tier(tvlm.VLMConfig.tiny(), "pallas", fused_rmsq=False)


def test_tokens_and_actions_equal(both):
    _, want, got, _, _ = both
    assert len(np.unique(want["action_tokens"])) > 1
    np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
    np.testing.assert_array_equal(got["actions"], want["actions"])
    apart = np.abs(got["logit_margins"] - want["logit_margins"])
    assert (want["logit_margins"] > 3 * apart).all()    # no token is a near tie


@pytest.mark.parametrize("key", ["first_logits", "logit_margins"])
def test_logits_and_margins_close(both, key):
    _, want, got, _, _ = both
    np.testing.assert_allclose(got[key], want[key], atol=ATOL)


def test_no_fused_norm_on_either_side(both):
    tserving, _, _, routes, jax_calls = both
    c = tserving.vlm
    L, blocks = c.llm.num_hidden_layers, sum(v.num_layers - 1 for v in c.vision)
    assert routes == {"w8a8_matmul": 4 * blocks + 7 * L * A + A}
    assert jax_calls.get("rms_norm_quant", 0) == 0
