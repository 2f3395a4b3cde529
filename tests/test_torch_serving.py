"""The port's action server and dynamic batcher (copies of the JAX package's
``serving/``), with the JAX serving tests' stub models over real HTTP on
127.0.0.1, then end to end over the port's `OpenVLA` on the CPU.

* The wire format (json-numpy both ways, the deploy.py prompt template and
  its v01 form) equal to the JAX package's functions.
* The server: POST /act round trip, 400 on a payload without image or
  instruction, 404 on another path, /health; with dynamic batching the
  concurrent requests batch and each gets its own result, /stats reports
  the batches and the client-side latency percentiles; per-stream drafts
  only on the bs = 1 path and never on a parity-tier model, the acceptance
  telemetry, the stream table's eviction.
* The batcher: strict oldest-first across image shapes (no starvation), no
  mixed shapes in a batch, errors propagated to the caller, a shut-down
  batcher refusing new requests.
* End to end on the port's OpenVLA (tiny, CPU): the batched server's
  responses equal direct `predict_action` calls; a bs = 1 server's
  speculative stream accepts the whole draft from its second step on.
"""

import contextlib
import json
import threading
import time
import urllib.request

import jax
import numpy as np
import pytest

from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.models.llama import LlamaConfig
from openvla_probe_tpu.models.vit import ViTConfig
from openvla_probe_tpu.serving import server as jserver
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import vla as tvla
from openvla_probe_tpu_torch.ops import image as timage
from openvla_probe_tpu_torch.serving.batcher import DynamicBatcher
from openvla_probe_tpu_torch.serving.server import (
    OpenVLAServer,
    decode_numpy,
    encode_numpy,
    get_openvla_prompt,
)

from tests.test_torch_openvla import Tok, _ovla_env, clean_ovla_env  # noqa: F401 (autouse)


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(encode_numpy(payload)).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, decode_numpy(json.loads(r.read()))
    except urllib.error.HTTPError as e:
        return e.code, decode_numpy(json.loads(e.read()))


def _stats(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats") as r:
        return json.loads(r.read())


@contextlib.contextmanager
def serving(model, **kw):
    srv = OpenVLAServer(model, **kw)
    srv.run(host="127.0.0.1", port=0, background=True)
    try:
        yield srv
    finally:
        srv.shutdown()
        if srv.batcher is not None:
            srv.batcher.shutdown()


# --- the wire format -------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "uint8", "int32", "bool"])
def test_numpy_json_matches_jax(dtype):
    a = (np.random.default_rng(1).normal(size=(3, 4)) * 50).astype(dtype)
    payload = {"x": a, "y": [1, 2], "z": np.float32(2.5), "w": {"v": a[0]}}
    enc = encode_numpy(payload)
    assert enc == jserver.encode_numpy(payload)
    b = decode_numpy(json.loads(json.dumps(enc)))
    np.testing.assert_array_equal(b["x"], a)
    assert b["x"].dtype == a.dtype and b["y"] == [1, 2] and b["z"] == 2.5
    np.testing.assert_array_equal(b["w"]["v"], a[0])
    assert jserver.decode_numpy(json.loads(json.dumps(enc)))["x"].tolist() == a.tolist()


@pytest.mark.parametrize("base", ["openvla-7b", "prism-qwen25-v01"])
def test_prompt_template_matches_jax(base):
    got = get_openvla_prompt("Pick Up The Cup", base)
    assert got == jserver.get_openvla_prompt("Pick Up The Cup", base)
    assert got.startswith("USER:" if "v01" in base else "In:")


# --- the server over stub models (the JAX serving tests') ------------------------------------


class StubModel:
    def __init__(self):
        self.calls = []

    def predict_action(self, image, prompt, unnorm_key=None):
        self.calls.append({"shape": image.shape, "prompt": prompt, "unnorm_key": unnorm_key})
        return {"actions": np.arange(7, dtype=np.float32)}


def test_act_round_trip():
    stub = StubModel()
    with serving(stub) as srv:
        img = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
        status, out = _post(srv.port, "/act", {"image": img, "instruction": "Pick Up The Cup",
                                               "unnorm_key": "bridge_orig"})
    assert status == 200
    np.testing.assert_allclose(out["action"], np.arange(7))
    call = stub.calls[-1]
    assert call["shape"] == (64, 64, 3)
    assert call["prompt"] == "In: What action should the robot take to pick up the cup?\nOut:"
    assert call["unnorm_key"] == "bridge_orig"


def test_missing_keys_is_400_and_unknown_path_404():
    with serving(StubModel()) as srv:
        status, out = _post(srv.port, "/act", {"instruction": "x"})
        assert status == 400 and "image" in out["error"]
        assert _post(srv.port, "/nope", {})[0] == 404
        with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health") as r:
            assert json.loads(r.read())["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/elsewhere")


class BatchStubModel:
    """Stub exposing predict_action_batch — counts batch sizes."""

    def __init__(self):
        self.batch_sizes = []

    def predict_action_batch(self, images, prompts, unnorm_keys=None):
        self.batch_sizes.append(len(prompts))
        return [{"actions": np.full(7, float(len(p)), np.float32)} for p in prompts]


def test_dynamic_batching_round_trip_and_stats():
    stub = BatchStubModel()
    with serving(stub, dynamic_batching=True, max_batch=8, max_wait_ms=50.0) as srv:
        assert srv.batcher is not None
        img = np.zeros((32, 32, 3), np.uint8)
        outs = [None] * 4
        prompts = ["a" * (i + 1) for i in range(4)]

        def call(i):
            outs[i] = _post(srv.port, "/act", {"image": img, "instruction": prompts[i]})

        ts = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        stats = _stats(srv.port)
    for i in range(4):
        status, out = outs[i]
        assert status == 200
        np.testing.assert_allclose(out["action"], np.full(7, len(get_openvla_prompt(prompts[i]))))
    assert max(stub.batch_sizes) >= 2
    assert stats["dynamic_batching"] is True and stats["requests"] == 4
    assert stats["batches"] == len(stub.batch_sizes) and stats["max_batch"] == 8
    assert stats["mean_batch"] == round(4 / stats["batches"], 3)
    lat = stats["latency_ms"]
    assert lat["count"] == 4 and lat["p50"] <= lat["p95"] <= lat["p99"]


class SpecStubModel:
    """Turbo-tier stub recording the draft_tokens the server passes."""

    class _Cfg:
        tier = "turbo"

    cfg = _Cfg()

    def __init__(self):
        self.drafts = []

    def predict_action(self, image, prompt, unnorm_key=None, draft_tokens=None):
        self.drafts.append(None if draft_tokens is None else np.asarray(draft_tokens).copy())
        return {"actions": np.arange(7, dtype=np.float32), "action_tokens": np.arange(7) + 31000}


def test_speculative_stream_drafts():
    stub = SpecStubModel()
    with serving(stub) as srv:
        assert srv._spec_streams
        img = np.zeros((32, 32, 3), np.uint8)
        p = {"image": img, "instruction": "go", "stream_id": "robot-a"}
        _post(srv.port, "/act", p)
        assert stub.drafts[-1] is None                    # first step: no draft
        _post(srv.port, "/act", p)
        np.testing.assert_array_equal(stub.drafts[-1], np.arange(7) + 31000)
        _post(srv.port, "/act", {"image": img, "instruction": "go", "stream_id": "robot-b"})
        assert stub.drafts[-1] is None                    # new stream: no draft
        _post(srv.port, "/act", {"image": img, "instruction": "go"})
        assert stub.drafts[-1] is None                    # anonymous: no draft
        stats = _stats(srv.port)
    assert stats["speculative_streams"] is True and stats["active_streams"] == 2


@pytest.mark.parametrize("why", ["parity", "batching", "no_tier", "off"])
def test_no_drafts_off_the_bs1_turbo_path(why):
    """Drafts go only to a non-parity model on the bs = 1 path."""
    class ParityStub(SpecStubModel):
        class _Cfg:
            tier = "parity"
        cfg = _Cfg()

    class NoTier(SpecStubModel):
        cfg = None

    class BatchSpec(SpecStubModel):
        def predict_action_batch(self, images, prompts, unnorm_keys=None):
            return [self.predict_action(i, p) for i, p in zip(images, prompts)]

    stub = {"parity": ParityStub, "no_tier": NoTier, "batching": BatchSpec,
            "off": SpecStubModel}[why]()
    kw = {"dynamic_batching": True} if why == "batching" else {}
    if why == "off":
        kw["speculative_streams"] = False
    with serving(stub, **kw) as srv:
        assert not srv._spec_streams
        p = {"image": np.zeros((32, 32, 3), np.uint8), "instruction": "go", "stream_id": "r"}
        _post(srv.port, "/act", p)
        _post(srv.port, "/act", p)
    assert len(stub.drafts) == 2 and all(d is None for d in stub.drafts)


def test_spec_acceptance_telemetry():
    class AcceptStub(SpecStubModel):
        accept_seq = [7, 7, 3]          # per-drafted-call n_accepted

        def predict_action(self, image, prompt, unnorm_key=None, draft_tokens=None):
            out = super().predict_action(image, prompt, unnorm_key, draft_tokens)
            if draft_tokens is not None:
                out["n_accepted"] = np.asarray(
                    [self.accept_seq[sum(d is not None for d in self.drafts) - 1]])
            return out

    stub = AcceptStub()
    with serving(stub) as srv:
        p = {"image": np.zeros((16, 16, 3), np.uint8), "instruction": "go", "stream_id": "r"}
        for _ in range(4):              # 1 undrafted + 3 drafted
            _post(srv.port, "/act", p)
        spec = _stats(srv.port)["speculative"]
    assert spec["drafted_requests"] == 3
    assert spec["accept_histogram"] == {"7": 2, "3": 1}
    assert spec["rolling_window"] == 3
    assert spec["rolling_accept_rate"] == round(17 / 21, 4)
    assert spec["rolling_full_accept_rate"] == round(2 / 3, 4)


def test_stream_table_eviction():
    stub = SpecStubModel()
    with serving(stub, max_streams=2) as srv:
        img = np.zeros((16, 16, 3), np.uint8)
        for sid in ("a", "b", "c"):
            _post(srv.port, "/act", {"image": img, "instruction": "go", "stream_id": sid})
        assert len(srv._stream_drafts) == 2
        assert "a" not in srv._stream_drafts      # oldest evicted
        _post(srv.port, "/act", {"image": img, "instruction": "go", "stream_id": "a"})
        assert stub.drafts[-1] is None            # an evicted stream re-registers draft-free


# --- the batcher --------------------------------------------------------------------------------


def test_minority_shape_not_starved():
    """The minority-shape request arrives first, so it rides the first batch
    even though majority-shape requests flood in behind it."""
    served = []

    class _Mock:
        def predict_action_batch(self, images, prompts, unnorm_keys):
            served.append([tuple(np.asarray(i).shape) for i in images])
            time.sleep(0.02)   # slow device: arrivals pile up between batches
            return [{"actions": np.zeros(5)} for _ in prompts]

    batcher = DynamicBatcher(_Mock(), max_batch=4, max_wait_ms=5.0)
    minority = np.zeros((24, 24, 3), np.uint8)
    majority = np.zeros((40, 40, 3), np.uint8)
    results = {}

    def call(name, img):
        results[name] = batcher.predict_action(img, "go", timeout=30.0)

    threads = [threading.Thread(target=call, args=("m0", minority))]
    threads += [threading.Thread(target=call, args=(f"M{i}", majority)) for i in range(12)]
    threads[0].start()
    time.sleep(0.01)            # the minority request is the oldest waiter
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=60)
    batcher.shutdown()
    assert len(results) == 13, "a request starved past its timeout"
    assert served[0] == [(24, 24, 3)], served[:3]
    for batch in served:
        assert len(set(batch)) == 1


def test_errors_reach_the_caller_and_shutdown_refuses():
    class _Failing:
        def predict_action_batch(self, images, prompts, unnorm_keys):
            raise KeyError("no such norm stats")

    batcher = DynamicBatcher(_Failing(), max_batch=4, max_wait_ms=5.0)
    with pytest.raises(KeyError, match="no such norm stats"):
        batcher.predict_action(np.zeros((8, 8, 3), np.uint8), "go")
    assert batcher.stats["batches"] == 1 and batcher.stats["requests"] == 1
    batcher.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.predict_action(np.zeros((8, 8, 3), np.uint8), "go")


# --- end to end over the port's OpenVLA on the CPU ----------------------------------------------


A = 5


@pytest.fixture(scope="module")
def port_model():
    """The port's OpenVLA over tiny weights (OpenVLA's vocabulary, so that the
    appended 29871 is a row of the table), on a turbo-labelled config."""
    with clean_ovla_env():
        cfg = jvlm.VLMConfig(
            llm=LlamaConfig.tiny(vocab_size=32064),
            vision=(ViTConfig.tiny(num_register_tokens=4, no_embed_class=True),
                    ViTConfig.tiny()),
            vision_names=("dino", "siglip"), arch_specifier="no-align+fused-gelu-mlp")
        serving_cfg = jvla.VLAServingConfig(vlm=cfg, action_dim=A, prompt_pad_len=24,
                                            codec_vocab_size=32000, tier="turbo")
        params = convert.params_from_jax(
            jax.tree.map(np.asarray, jvlm.init_params(cfg, jax.random.key(0))),
            convert.config_from_jax(cfg), device="cpu")
        s = cfg.vision[0].image_size
        img_cfg = timage.ImageTransformConfig(specs=(
            timage.BackboneTransformSpec((s, s), "bicubic", (0.485, 0.456, 0.406),
                                         (0.229, 0.224, 0.225)),
            timage.BackboneTransformSpec((s, s), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5))))
        stats = {"a": {"action": {"q01": -np.ones(A, np.float32), "q99": np.ones(A, np.float32)}},
                 "b": {"action": {"q01": np.zeros(A, np.float32),
                                  "q99": 2 * np.ones(A, np.float32)}}}
        return tvla.OpenVLA(params, convert.config_from_jax(serving_cfg), Tok(), stats, img_cfg,
                            device="cpu")


def test_batched_server_over_the_port_model(port_model):
    imgs = np.random.default_rng(3).integers(0, 256, (6, 40, 40, 3), dtype=np.uint8)
    tasks = [f"pick up object number {i}" for i in range(6)]
    keys = ["a", "b"] * 3
    outs = [None] * 6
    with serving(port_model, dynamic_batching=True, max_batch=8, max_wait_ms=200.0) as srv:
        def call(i):
            outs[i] = _post(srv.port, "/act", {"image": imgs[i], "instruction": tasks[i],
                                               "unnorm_key": keys[i]})

        ts = [threading.Thread(target=call, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        stats = _stats(srv.port)
    assert stats["requests"] == 6 and stats["max_seen_batch"] >= 2, stats
    for i in range(6):
        status, out = outs[i]
        assert status == 200, out
        want = port_model.predict_action(imgs[i], get_openvla_prompt(tasks[i]), unnorm_key=keys[i])
        np.testing.assert_allclose(out["action"], want["actions"], rtol=0, atol=1e-6)


def test_speculative_stream_over_the_port_model(port_model):
    img = np.random.default_rng(4).integers(0, 256, (40, 40, 3), dtype=np.uint8)
    p = {"image": img, "instruction": "open the drawer", "unnorm_key": "a", "stream_id": "arm"}
    want = port_model.predict_action(img, get_openvla_prompt("open the drawer"), unnorm_key="a")
    with serving(port_model) as srv:
        assert srv._spec_streams
        outs = [_post(srv.port, "/act", p) for _ in range(3)]
        accepted = [a for a, _ in srv._spec_accept]
        spec = _stats(srv.port)["speculative"]
    for status, out in outs:
        assert status == 200
        np.testing.assert_allclose(out["action"], want["actions"], rtol=0, atol=1e-6)
    assert accepted == [A, A]            # the second and third steps: the whole draft
    assert spec["drafted_requests"] == 2 and spec["rolling_full_accept_rate"] == 1.0


def test_adapter_requests_fail_with_item_11(port_model):
    """Multi-LoRA is ported: an adapter request to a model with no banks fails
    with the wrapper's ValueError (HTTP 400), as in the JAX package."""
    with serving(port_model) as srv:
        status, out = _post(srv.port, "/act", {"image": np.zeros((40, 40, 3), np.uint8),
                                               "instruction": "go", "unnorm_key": "a",
                                               "adapter": "x"})
    assert status == 400 and "no adapter banks installed" in out["error"]   # a ValueError
