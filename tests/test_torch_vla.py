"""End to end: the port's parity-tier `predict_action_from_image` vs the JAX
package's, on the CPU at tiny fp32 sizes with 28x28 image specs and the JAX
kernels engaged in interpret mode. Action tokens and actions must be equal;
first-position logits and margins within fp32 atol 1e-4 (sums in another
order through the whole model)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.vla.action_tokenizer import ActionCodec as JCodec
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.vla.action_tokenizer import ActionCodec as TCodec

VOCAB = 512
A = 7
P = 64          # T = 1 + 4 patches + 63 = 68 >= 64: the prefill flash gate engages


def _img_cfg(m):
    return m.ImageTransformConfig(specs=(
        m.BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        m.BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    ))


def _inputs(B=2, P=P, seed=0):
    r = np.random.default_rng(seed)
    img = r.integers(0, 256, (B, 40, 40, 3), dtype=np.uint8)
    plen = np.array([20, 35, 9][:B], np.int32)
    ids = np.zeros((B, P), np.int32)
    for b in range(B):
        ids[b, 0] = 1
        ids[b, 1:plen[b] - 1] = r.integers(3, VOCAB, plen[b] - 2)
        ids[b, plen[b] - 1] = 29871 % VOCAB
    q01 = r.uniform(-2, 0, A).astype(np.float32)
    q99 = r.uniform(0.5, 2, A).astype(np.float32)
    mask = np.array([True] * (A - 1) + [False])
    return img, ids, plen, q01, q99, mask


@pytest.fixture(scope="module")
def models():
    cfg = jvlm.VLMConfig.tiny()
    serving = jvla.VLAServingConfig(vlm=cfg, action_dim=A, prompt_pad_len=P,
                                    codec_vocab_size=VOCAB)
    params = jvlm.init_params(cfg, jax.random.key(0))
    tserving = convert.config_from_jax(serving)
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, params), tserving.vlm,
                                      device="cpu")
    return serving, params, tserving, tparams


@pytest.fixture(scope="module")
def both(models):
    serving, params, tserving, tparams = models
    img, ids, plen, q01, q99, mask = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OVLA_PALLAS", "1")
        mp.setenv("OVLA_PALLAS_INTERPRET", "1")
        want = jvla.predict_action_from_image(
            params, serving, jnp.asarray(img), _img_cfg(jimage), jnp.asarray(ids),
            jnp.asarray(plen), jnp.asarray(q01), jnp.asarray(q99), jnp.asarray(mask),
            return_first_logits=True)
    want = jax.tree.map(np.asarray, want)
    tattn.reset_launch_counts()
    got = tvla.predict_action_from_image(
        tparams, tserving, img, _img_cfg(timage), ids, plen, q01, q99, mask,
        return_first_logits=True, device="cpu")
    return want, {k: v.numpy() for k, v in got.items()}


def test_action_tokens_and_actions_equal(both):
    want, got = both
    assert got["action_tokens"].shape == (2, A)
    np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
    np.testing.assert_array_equal(got["normalized_actions"], want["normalized_actions"])
    np.testing.assert_array_equal(got["actions"], want["actions"])


@pytest.mark.parametrize("key", ["first_logits", "logit_margins"])
def test_logits_and_margins_close(both, key):
    want, got = both
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key], want[key], atol=1e-4)


def test_cpu_run_launches_no_kernel(both):
    assert set(tattn.KERNEL_LAUNCHES.values()) == {0}


def test_prompt_padding_invariance(models, both):
    """Same tokens whatever the pad bucket (pad slots are masked, decoded
    tokens keep their true RoPE positions)."""
    _, _, tserving, tparams = models
    img, ids, plen, q01, q99, mask = _inputs()
    wide = np.zeros((2, P + 8), np.int32)
    wide[:, :P] = ids
    out = tvla.predict_action_from_image(
        tparams, dataclasses.replace(tserving, prompt_pad_len=P + 8), img, _img_cfg(timage),
        wide, plen, q01, q99, mask, device="cpu")
    np.testing.assert_array_equal(out["action_tokens"].numpy(), both[1]["action_tokens"])


def test_entry_points_raise_without_cuda(models, monkeypatch):
    """Called without device="cpu" on a machine with no card: raise, never
    continue quietly on the CPU."""
    _, _, tserving, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, ids, plen, q01, q99, mask = _inputs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tvla.predict_action_from_image(tparams, tserving, img, _img_cfg(timage), ids, plen,
                                       q01, q99, mask)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.init_params(tserving.vlm, torch.Generator())


@pytest.mark.parametrize("kw", [{"tier": "turbo_kv8"}, {"decode_impl": "frozen_kv"},
                                {"split_prefill": True}, {"flat_cache": True}])
def test_unported_tiers_raise(models, kw):
    with pytest.raises(NotImplementedError, match="parity"):
        dataclasses.replace(models[2], **kw)


def test_action_codec_matches_jax():
    ids = np.arange(0, 32064, dtype=np.int32)     # every id, incl. the clipped ends
    q01 = np.linspace(-2, 0, 7, dtype=np.float32)
    q99 = np.linspace(0.5, 3, 7, dtype=np.float32)
    mask = np.array([True] * 6 + [False])
    toks = ids[: 32064 // 7 * 7].reshape(-1, 7)
    jc, tc = JCodec(), TCodec()
    want = np.asarray(jc.decode_and_unnormalize(jnp.asarray(toks), q01, q99, mask))
    got = tc.decode_and_unnormalize(torch.from_numpy(toks), q01, q99, mask).numpy()
    np.testing.assert_array_equal(got, want)
