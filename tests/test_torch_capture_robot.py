"""The rollout capture session and the robot glue of the port against the JAX
package's, on the CPU at tiny size (the wrapper config of
tests/test_torch_openvla.py: OpenVLA's vocabulary, prompt_pad_len 24, A = 5,
a turbo-labelled config so that drafts are served).

* `CaptureSession` (plain and speculative) writes the same episodes as the
  JAX package's over the same weights and frames: the fp16 hidden states
  within 2 fp16 steps (the fp32 taps agree within 1e-5, and fp16 rounding can
  land either side of a tie), the labels and the success flag equal; both
  packages' loaders read both packages' files.
* `SpeculativeActionState` and `get_vla_action` (both prompt templates, the
  eval crop, the taps, a control loop drafting from its previous step) give
  the JAX package's tokens and acceptance.
* `crop_and_resize` (PyTorch) against the JAX package's (``tf.image.
  crop_and_resize``) within 1e-6 (found: equal), `center_crop_image_u8` equal;
  `pool_tokens`; the gripper conventions, the seeding and the model-family
  dispatch of `robot_utils`; loading without a tokenizer raises naming the
  argument (the port loads with the caller's tokenizer).
"""

import dataclasses
import random

import jax
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.models.llama import LlamaConfig
from openvla_probe_tpu.models.vit import ViTConfig
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu.probe import capture as jcapture
from openvla_probe_tpu.probe import episodes as jepisodes
from openvla_probe_tpu.robot import openvla_utils as jou
from openvla_probe_tpu.robot import robot_utils as jru
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch import probe as tprobe
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.probe import episodes as tepisodes
from openvla_probe_tpu_torch.robot import openvla_utils as tou
from openvla_probe_tpu_torch.robot import robot_utils as tru

from tests.test_torch_openvla import Tok, _img_cfg, _ovla_env, clean_ovla_env  # noqa: F401

A = 5


STATS = {"libero": {"action": {"q01": -np.ones(A, np.float32), "q99": np.ones(A, np.float32)}}}


@pytest.fixture(scope="module")
def models():
    """(JAX OpenVLA, port OpenVLA, frames) over the same tiny weights."""
    with clean_ovla_env():
        cfg = jvlm.VLMConfig(
            llm=LlamaConfig.tiny(vocab_size=32064),
            vision=(ViTConfig.tiny(num_register_tokens=4, no_embed_class=True),
                    ViTConfig.tiny()),
            vision_names=("dino", "siglip"), arch_specifier="no-align+fused-gelu-mlp")
        serving = jvla.VLAServingConfig(vlm=cfg, action_dim=A, prompt_pad_len=24,
                                        codec_vocab_size=32000, tier="turbo")
        params = jvlm.init_params(cfg, jax.random.key(1))
        tparams = convert.params_from_jax(jax.tree.map(np.asarray, params),
                                          convert.config_from_jax(cfg), device="cpu")
        s = cfg.vision[0].image_size
        jm = jvla.OpenVLA(params, serving, Tok(), STATS, _img_cfg(jimage, s))
        tm = tvla.OpenVLA(tparams, convert.config_from_jax(serving), Tok(), STATS,
                          _img_cfg(timage, s), device="cpu")
        frames = np.random.default_rng(2).integers(0, 256, (4, s + 12, s + 12, 3),
                                                   dtype=np.uint8)
        return jm, tm, frames


class Detector:
    """A symbolic-state oracle stand-in: a fixed {-1, 0, 1} sequence."""

    def __init__(self, k, seed):
        self.r = np.random.default_rng(seed)
        self.k = k

    def detect_binary_states(self):
        return self.r.integers(-1, 2, self.k)


def _episode(session, frames, prompt):
    outs = [session.step(f, prompt) for f in frames]
    return outs, session.end_episode(0, success=True)


@pytest.mark.parametrize("speculative", [False, True])
def test_capture_session_matches_jax(models, tmp_path, speculative):
    jm, tm, frames = models
    prompt = "In: What action should the robot take to put the bowl on the plate?\nOut:"
    steps = np.concatenate([frames[:2], frames[1:2]])       # the last step repeats a frame
    sessions = {}
    for tag, mod, m in (("jax", jcapture, jm), ("port", tprobe, tm)):
        dets = {"symbolic_state_object_relations": Detector(6, 0),
                "symbolic_state_action_subgoals": Detector(3, 1)}
        sessions[tag] = mod.CaptureSession(m, tmp_path / tag, detectors=dets,
                                           unnorm_key="libero", speculative=speculative)
    (jouts, jpath), (touts, tpath) = (_episode(sessions[t], steps, prompt) for t in ("jax", "port"))
    for i, (jo, to) in enumerate(zip(jouts, touts)):
        np.testing.assert_array_equal(to["action_tokens"], jo["action_tokens"])
        np.testing.assert_allclose(to["hidden_pooled"], jo["hidden_pooled"], rtol=1e-5, atol=1e-5)
        # a speculative session drafts from its second step on
        assert ("n_accepted" in to) == ("n_accepted" in jo) == (speculative and i > 0)
    if speculative:
        spec = sessions["port"].spec_state
        assert spec.steps == 3 and spec.last_tokens is None      # reset at the episode's end
        assert [int(o["n_accepted"]) for o in touts[1:]] == [int(o["n_accepted"])
                                                             for o in jouts[1:]]
        assert int(touts[2]["n_accepted"]) == A                  # the repeated frame
    for path in (jpath, tpath):
        for load in (jepisodes.load_episode, tepisodes.load_episode):
            ep = load(path)
            assert set(ep) >= {"visual_semantic_encoding", "symbolic_state_object_relations",
                               "symbolic_state_action_subgoals", "success"}
    jep, tep = jepisodes.load_episode(jpath), tepisodes.load_episode(tpath)
    assert tep["visual_semantic_encoding"].shape == jep["visual_semantic_encoding"].shape == (
        tm.cfg.vlm.llm.num_hidden_layers + 1, 3, tm.cfg.vlm.llm.hidden_size)
    assert tep["visual_semantic_encoding"].dtype == np.float16
    h_t = tep["visual_semantic_encoding"].astype(np.float32)
    h_j = jep["visual_semantic_encoding"].astype(np.float32)
    step = np.spacing(np.abs(h_j).astype(np.float16)).astype(np.float32)
    assert (np.abs(h_t - h_j) <= 2 * step + 1e-7).all()
    for k in ("symbolic_state_object_relations", "symbolic_state_action_subgoals", "success"):
        np.testing.assert_array_equal(tep[k], jep[k])
    assert [p.name for p in tepisodes.list_episodes(tpath.parent)] == ["episode_0.npz"]


def test_speculative_action_state():
    s = tou.SpeculativeActionState()
    assert s.last_tokens is None and s.acceptance_rate == 0.0
    s.observe({"action_tokens": np.arange(5)})
    s.observe({"action_tokens": np.arange(5) + 1, "n_accepted": np.asarray(3)})
    s.observe({"action_tokens": np.arange(5) + 2, "n_accepted": np.asarray(5)})
    np.testing.assert_array_equal(s.last_tokens, np.arange(5) + 2)
    assert s.steps == 3 and s.accepted_total == 8 and s.acceptance_rate == 8 / 15
    s.reset()
    assert s.last_tokens is None and s.steps == 3
    j = jou.SpeculativeActionState()
    for out in ({"action_tokens": np.arange(5)}, {"action_tokens": np.arange(5), "n_accepted": 4}):
        j.observe(out)
        s.observe(out)
    assert j.accepted_total + 8 == s.accepted_total


@pytest.mark.parametrize("base_vlm", ["openvla-7b", "prism-v01"])
@pytest.mark.parametrize("center_crop", [False, True])
def test_get_vla_action_matches_jax(models, base_vlm, center_crop):
    jm, tm, frames = models
    kw = dict(unnorm_key="libero", center_crop=center_crop, return_embeddings=True,
              base_vlm=base_vlm)
    jstate, tstate = jou.SpeculativeActionState(), tou.SpeculativeActionState()
    for f in (frames[0], frames[0], frames[3]):      # a control loop: drafts from step 2 on
        obs = {"full_image": f}
        want = jou.get_vla_action(jm, obs, "Put The Bowl Away", spec_state=jstate, **kw)
        got = tou.get_vla_action(tm, obs, "Put The Bowl Away", spec_state=tstate, **kw)
        np.testing.assert_array_equal(got["action_tokens"], want["action_tokens"])
        np.testing.assert_allclose(got["hidden_pooled"], want["hidden_pooled"], rtol=1e-5,
                                   atol=1e-5)
    assert (tstate.steps, tstate.accepted_total) == (jstate.steps, jstate.accepted_total)
    assert tstate.accepted_total >= A                 # the repeated frame took the whole draft
    plain = tou.get_vla_action(tm, {"full_image": frames[1]}, "go", unnorm_key="libero")
    assert "hidden_pooled" not in plain and "n_accepted" not in plain


def test_get_vla_action_prompts(models):
    _, tm, frames = models
    seen = []

    class Spy:
        def predict_action(self, image, prompt, **kw):
            seen.append(prompt)
            return {"action_tokens": np.zeros(A, np.int32)}

    for base in ("openvla-7b", "x-v01"):
        tou.get_vla_action(Spy(), {"full_image": frames[0]}, "Open The Drawer", base_vlm=base)
    assert seen == ["In: What action should the robot take to open the drawer?\nOut:",
                    "USER: What action should the robot take to open the drawer? ASSISTANT:"]


@pytest.mark.parametrize("shape,scale", [((256, 256, 3), 0.9), ((2, 200, 300, 3), 0.81),
                                         ((224, 224, 3), 0.5), ((17, 31, 3), 1.0)])
def test_crop_and_resize_matches_tensorflow(shape, scale):
    pytest.importorskip("tensorflow")
    img = np.random.default_rng(sum(shape)).random(shape, dtype=np.float32)
    want = jou.crop_and_resize(img, scale)
    got = tou.crop_and_resize(img, scale)
    assert got.shape == want.shape == shape[:-3] + (224, 224, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    u8 = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(tou.center_crop_image_u8(u8, scale),
                                  jou.center_crop_image_u8(u8, scale))


def test_crop_and_resize_is_the_centered_box():
    """At crop_scale 1 and 224 px the box is the whole image: the identity."""
    img = np.random.default_rng(5).random((224, 224, 3), dtype=np.float32)
    np.testing.assert_allclose(tou.crop_and_resize(img, 1.0), img, rtol=0, atol=1e-6)
    out = tou.center_crop_image_u8(np.full((256, 256, 3), 200, np.uint8))
    assert out.shape == (224, 224, 3) and (out == 200).all()


def test_pool_tokens():
    h = np.random.default_rng(0).normal(size=(6, 8)).astype(np.float32)
    np.testing.assert_allclose(tou.pool_tokens(h), jou.pool_tokens(h))
    np.testing.assert_array_equal(tou.pool_tokens(h, "final"), h[-1])
    with pytest.raises(ValueError, match="Unknown pooling mode"):
        tou.pool_tokens(h, "max")


@pytest.mark.parametrize("g", [0.8, 0.2, 0.5, 1.0, 0.0])
def test_gripper_conventions_match_jax(g):
    a = np.array([0.1, 0.2, 0.3, 0.4, 0.5, 0.6, g])
    for binarize in (True, False):
        np.testing.assert_array_equal(tru.normalize_gripper_action(a, binarize),
                                      jru.normalize_gripper_action(a, binarize))
    n = tru.normalize_gripper_action(a, True)
    np.testing.assert_array_equal(tru.invert_gripper_action(n), jru.invert_gripper_action(n))
    assert tru.invert_gripper_action(n)[-1] == -n[-1]
    np.testing.assert_array_equal(a[:-1], n[:-1])


def test_seeding():
    tru.set_seed_everywhere(3)
    a = (np.random.rand(), random.random(), torch.rand(1).item())
    tru.set_seed_everywhere(3)
    assert (np.random.rand(), random.random(), torch.rand(1).item()) == a
    assert tru.DATE_FORMAT == jru.DATE_FORMAT


def test_model_family_dispatch(models):
    _, tm, frames = models
    cfg = type("Cfg", (), {"model_family": "openvla", "unnorm_key": "libero",
                           "center_crop": True, "pretrained_checkpoint": "/nowhere"})()
    out = tru.get_action(cfg, tm, {"full_image": frames[0]}, "go", return_embeddings=True)
    assert out["action_tokens"].shape == (A,) and "hidden_pooled" in out
    with pytest.raises(ValueError, match="pass tokenizer="):   # loading needs the caller's
        tru.get_model(cfg)
    assert tou.get_processor(cfg) is None                      # the JAX package's rule
    other = dataclasses.make_dataclass("C", [("model_family", str)])("diffusion")
    with pytest.raises(ValueError, match="Unexpected `model_family`"):
        tru.get_model(other)
    with pytest.raises(ValueError, match="Unexpected `model_family`"):
        tru.get_action(other, tm, {}, "go")
