"""The port's command line (openvla_probe_tpu_torch/scripts/) against the JAX
package's scripts, on the CPU at tiny size.

One tiny checkpoint serves every script: the tiny dinosiglip + Llama config
with OpenVLA's 32064-row vocabulary (the appended 29871 must be a row of the
table), written by the port's exporter (params_to_hf_state, the safetensors
writer, hf_export's sidecars) with a test tokenizer.json
(tests/test_torch_tokenization.build_spec) beside it. Each port script runs
as ``python -m openvla_probe_tpu_torch.scripts.<name> --device cpu`` in a
subprocess with the ``OVLA_*`` variables removed, each wait under its own
timeout; each JAX script runs in this process through its own ``main``.

* deploy, the parity tier: ``/act`` actions equal to the JAX server's.
* generate: the REPL's replies to two prompts equal.
* evaluate, closed and open: equal reports (closed-set scores within the
  bf16 gap of the two packages' forwards, predictions and accuracy equal).

The checkpoint's lm_head is scaled by LOGIT_SCALE, which widens the greedy
margins far past the two packages' bf16 rounding differences (at the plain
random init they sit near 2e-3, below the 2e-2 gap of tests/test_torch_load.py);
the tokens compared here are equal at this seed.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from openvla_probe_tpu.models import catalog as jcat
from openvla_probe_tpu.models import load as jload
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu_torch import convert, scripts
from openvla_probe_tpu_torch.models import catalog as tcat
from openvla_probe_tpu_torch.models import hf_export as texport
from openvla_probe_tpu_torch.models import safetensors_io as sio
from openvla_probe_tpu_torch.serving.server import decode_numpy, encode_numpy
from tests.test_hub_load import ARCH, LLM_ID, VIS_ID
from tests.test_torch_openvla import clean_ovla_env  # noqa: F401 (autouse)
from tests.test_torch_tokenization import build_spec

ROOT = Path(__file__).resolve().parents[1]
VOCAB = 32064
LOGIT_SCALE = 64.0
GAP = 2e-2                  # bf16 first logits, port vs JAX (tests/test_torch_load.py BF16_GAP)
STATS = {"bridge_orig": {"action": {"q01": [-0.5] * 7, "q99": [0.5] * 7,
                                    "mask": [True] * 6 + [False]}}}
WAIT_S = 120


def jax_script(name: str):
    """The JAX package's scripts/<name>.py as a module (its main and config)."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def port_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith("OVLA_")}
    env["PYTHONPATH"] = str(ROOT)
    return env


def port_script(name: str, *args, input_text=None, timeout=WAIT_S):
    """The port's script to its end, on the CPU (a host-only script has no --device)."""
    dev = [] if name in scripts.ON_HOST else ["--device", "cpu"]
    out = subprocess.run(
        [sys.executable, "-m", f"openvla_probe_tpu_torch.scripts.{name}", *dev, *map(str, args)],
        cwd=ROOT, env=port_env(), input=input_text, capture_output=True, text=True,
        timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def repo(tmp_path_factory):
    """The tiny checkpoint directory (HF layout, fp32 tensors, tokenizer.json)."""
    cfg, img_cfg, _ = jcat.build_vlm_config(VIS_ID, LLM_ID, ARCH, "resize-naive")
    cfg = jvlm.VLMConfig(**{**cfg.__dict__, "llm": type(cfg.llm)(
        **{**cfg.llm.__dict__, "vocab_size": VOCAB})})
    params = jax.tree.map(np.asarray, jvlm.init_params(cfg, jax.random.key(3)))
    params["llm"]["lm_head"] = params["llm"]["lm_head"] * np.float32(LOGIT_SCALE)
    tcfg = convert.config_from_jax(cfg)
    tparams = convert.params_from_jax(params, tcfg, device="cpu")
    d = tmp_path_factory.mktemp("ckpt")
    sio.save_file(tcat.params_to_hf_state(tparams, tcfg), d / "model.safetensors",
                  dtype=torch.float32)
    texport.write_export_sidecars(d, tcfg, tcat.build_vlm_config(VIS_ID, LLM_ID, ARCH)[1],
                                  VIS_ID, LLM_ID, ARCH, "resize-naive", norm_stats=STATS)
    (d / "tokenizer.json").write_text(json.dumps(build_spec("legacy")))
    return d


def _frames(n, hw=40, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, hw, hw, 3), dtype=np.uint8)


TASKS = ["pick", "open the drawer", "lift the cup"]   # within prompt_pad_len at this vocabulary


def _post(port, payload, timeout=60):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/act",
                                 data=json.dumps(encode_numpy(payload)).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return decode_numpy(json.loads(r.read()))
    except urllib.error.HTTPError as e:
        raise AssertionError(f"port {port}: {e.code} {e.read()[:2000]!r}") from None


def _wait_ready(port, proc=None, timeout=WAIT_S):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the server exited: {proc.stderr.read()[-4000:]}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/stats", timeout=5) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.2)
    raise AssertionError(f"no server on port {port} after {timeout} s")


def test_deploy_matches_jax(repo, monkeypatch):
    from openvla_probe_tpu.serving import server as jserver

    servers = []
    run = jserver.OpenVLAServer.run

    def background(self, host="0.0.0.0", port=8000, background=False):
        servers.append(self)
        return run(self, host, port, background=True)

    monkeypatch.setattr(jserver.OpenVLAServer, "run", background)
    jdeploy = jax_script("deploy")
    jdeploy.main(jdeploy.DeployConfig(openvla_path=str(repo), host="127.0.0.1", port=0))
    jsrv = servers[0]
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "openvla_probe_tpu_torch.scripts.deploy", "--device", "cpu",
         "--openvla_path", str(repo), "--host", "127.0.0.1", "--port", str(port)],
        cwd=ROOT, env=port_env(), stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        _wait_ready(port, proc)
        for img, task in zip(_frames(3), TASKS):
            payload = {"image": img, "instruction": task, "unnorm_key": "bridge_orig"}
            got = _post(port, payload)
            want = _post(jsrv.port, payload)
            assert got["action"].shape == (7,)
            np.testing.assert_array_equal(got["action"], want["action"])
        stats = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/stats",
                                                  timeout=10).read())
        assert stats["latency_ms"]["count"] == 3 and stats["dynamic_batching"] is False
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        jsrv.shutdown()


def test_generate_matches_jax(repo, tmp_path, monkeypatch, capsys):
    img = tmp_path / "frame.png"
    Image.fromarray(_frames(1, 48, seed=4)[0]).save(img)
    prompts = ["what is on the table?", "describe the scene"]
    out = port_script("generate", "--model_path", repo, "--image", img, "--max_new_tokens", 8,
                      input_text="\n".join(prompts) + "\n")
    feed = iter(prompts)

    def fake_input(msg=""):
        print(msg, end="")      # what input() writes when stdin is not a terminal
        try:
            return next(feed)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", fake_input)
    jgen = jax_script("generate")
    capsys.readouterr()
    jgen.main(jgen.GenerateConfig(model_path=str(repo), image=str(img), max_new_tokens=8))
    want = capsys.readouterr().out
    # the REPL's whole output: its banner, each prompt line and reply
    assert out.stdout == want and want.count("|=> Enter Prompt: ") == len(prompts) + 1


def _write_dataset(tmp_path, task):
    rows = []
    for i, img in enumerate(_frames(8, 40, seed=5)):
        Image.fromarray(img).save(tmp_path / f"im{i}.png")
        if task == "closed":
            # choices of very different lengths: the summed log-probs sit far apart
            rows.append({"question": f"which one is object {i}?", "image": f"im{i}.png",
                         "choices": ["a", "red block on the left side of the table",
                                     "the cup"], "answer_idx": i % 3})
        else:
            rows.append({"question": f"what is object {i}?", "image": f"im{i}.png",
                         "answers": ["block", "cup"]})
    ds = tmp_path / f"{task}.jsonl"
    ds.write_text("\n".join(json.dumps(r) for r in rows))
    return ds


@pytest.mark.parametrize("task", ["closed", "open"])
def test_evaluate_matches_jax(repo, tmp_path, task):
    ds = _write_dataset(tmp_path, task)
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    port_script("evaluate", "--checkpoint", repo, "--dataset", ds, "--task", task,
                "--image_root", tmp_path, "--output", port_out, "--max_new_tokens", 6)
    jeval = jax_script("evaluate")
    jeval.main(jeval.EvalConfig(checkpoint=str(repo), dataset=str(ds), task=task,
                                image_root=str(tmp_path), output=str(jax_out), max_new_tokens=6))
    got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert got["n"] == want["n"] == 8
    for g, w in zip(got.pop("results"), want.pop("results")):
        if task == "closed":
            # summed log-probs of the scaled lm_head: bf16 rounding relative to their size
            np.testing.assert_allclose(g.pop("scores"), w.pop("scores"), rtol=1e-2, atol=GAP)
        assert g == w
    assert got == want
