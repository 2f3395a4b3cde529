"""The weight/config bridge and the port's package boundary.

params_from_jax must consume exactly the JAX pytree (raising on a missing or
an unconsumed leaf), init_params must make the JAX layout with the JAX init
distributions, and the port must import neither JAX nor the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import vla as jvla
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.device import resolve_device
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops.linear import matmul_t, nib_hi_dot_plain, quantize_weight_nibble

ROOT = Path(__file__).resolve().parents[1]
# sklearn and optax: the probe bank's metrics and optimizer are the port's own (numpy,
# training/train_state.py); tensorflow: robot/openvla_utils.crop_and_resize is the port's
# own (PyTorch); the machine with the card has none of them
FORBIDDEN = ("jax", "jaxlib", "openvla_probe_tpu", "transformers", "timm", "PIL", "flax",
             "sklearn", "optax", "tensorflow")


@pytest.fixture(scope="module")
def tiny():
    cfg = jvlm.VLMConfig.tiny()
    params = jax.tree.map(np.asarray, jvlm.init_params(cfg, jax.random.key(0)))
    return cfg, convert.config_from_jax(cfg), params


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_params_from_jax_copies_every_leaf(tiny):
    _, tcfg, params = tiny
    got = _flat(convert.params_from_jax(params, tcfg, device="cpu"))
    want = _flat(params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)


def test_params_from_jax_keeps_bf16_bits():
    cfg = jvlm.VLMConfig.tiny()
    cfg = jvlm.VLMConfig(llm=jvlm.llama.LlamaConfig.tiny(dtype=jnp.bfloat16), vision=cfg.vision)
    params = jax.tree.map(np.asarray, jvlm.init_params(cfg, jax.random.key(1)))
    got = convert.params_from_jax(params, convert.config_from_jax(cfg), device="cpu")
    w = got["llm"]["layers"]["q_proj"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(params["llm"]["layers"]["q_proj"]).astype(np.float32))


@pytest.mark.parametrize("edit,err", [
    (lambda p: p["llm"]["layers"].pop("up_proj"), KeyError),            # missing leaf
    (lambda p: p["llm"].update(extra=np.zeros(3)), KeyError),          # unconsumed leaf
    (lambda p: p["vision"]["dino"]["patch_embed"].update(              # quantized leaf
        weight={"q": np.zeros(1), "s": np.zeros(1)}), NotImplementedError),
    (lambda p: p["llm"].update(norm=np.zeros(3, np.float32)), ValueError),  # wrong shape
])
def test_params_from_jax_rejects(tiny, edit, err):
    _, tcfg, params = tiny
    tree = jax.tree.map(lambda a: a, params)   # fresh dict structure
    edit(tree)
    with pytest.raises(err):
        convert.params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("name", ["tiny", "openvla_7b"])
def test_param_layout_matches_jax_init(name):
    """The port's layout (shapes, dtypes) is the JAX init's, at full width too
    (shapes only: nothing is materialized)."""
    jcfg = getattr(jvlm.VLMConfig, name)()
    shapes = _flat(jax.eval_shape(lambda k: jvlm.init_params(jcfg, k), jax.random.key(0)))
    spec = _flat(convert.vlm_param_spec(convert.config_from_jax(jcfg)))
    assert spec.keys() == shapes.keys()
    for k, s in shapes.items():
        assert spec[k].shape == tuple(s.shape), k
        assert str(spec[k].dtype).removeprefix("torch.") == np.dtype(s.dtype).name, k


def test_init_params_distributions(tiny):
    _, tcfg, params = tiny
    g = torch.Generator().manual_seed(0)
    got = _flat(convert.init_params(tcfg, g, device="cpu"))
    assert got.keys() == _flat(params).keys()
    q = got["/llm/layers/q_proj"]
    assert abs(q.std().item() - 0.02) < 2e-3 and abs(q.mean().item()) < 1e-3
    assert torch.all(got["/vision/dino/blocks/ls1"] == 1e-5)
    assert torch.all(got["/llm/layers/input_layernorm"] == 1)
    assert torch.all(got["/vision/siglip/blocks/qkv_b"] == 0)
    w = got["/projector/fc2/w"]                       # U(-1/sqrt(in), 1/sqrt(in))
    bound = 1 / np.sqrt(w.shape[1])
    assert w.abs().max().item() <= bound and w.abs().max().item() > 0.9 * bound


def test_config_from_jax():
    serving = jvla.VLAServingConfig(vlm=jvlm.VLMConfig.openvla_7b(), prompt_pad_len=32)
    t = convert.config_from_jax(serving)
    assert t.vlm == tvlm.VLMConfig.openvla_7b()
    assert (t.prompt_pad_len, t.prefill_len, t.cache_len) == (32, 288, 295)
    # the turbo numerics now carry over; a MoE trunk still raises
    assert convert.config_from_jax(jvlm.VLMConfig.openvla_7b().turbo()) == \
        tvlm.VLMConfig.openvla_7b().turbo()
    moe = jvlm.VLMConfig.tiny()
    moe = jvlm.VLMConfig(llm=jvlm.llama.LlamaConfig.tiny(moe_experts=4), vision=moe.vision)
    with pytest.raises(NotImplementedError):
        convert.config_from_jax(moe)


def test_matmul_t_float_only():
    """Float, per-channel int8 and (packed) nibble leaves and streamed-LoRA
    wrappers multiply; mix and multi-LoRA leaves still raise, and so do
    unpacked int8 planes (the JAX package's emit_codes form, which
    params_from_jax packs)."""
    x, w = torch.randn(3, 4), torch.randn(5, 4)
    torch.testing.assert_close(matmul_t(x, w), x @ w.T)
    q = torch.randint(-127, 128, (5, 4), dtype=torch.int8)
    torch.testing.assert_close(matmul_t(x, {"q": q, "s": torch.ones(5)}), x @ q.float().T)
    nib = quantize_weight_nibble(w)                                # the hi plane at M = 3
    torch.testing.assert_close(matmul_t(x, nib), nib_hi_dot_plain(x, nib["hi"], nib["s"]),
                               atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="Queue 1"):      # mix: int8 + grouped int4
        matmul_t(x, {"q": q, "s": torch.ones(5), "q4": q.reshape(1, 5, 4), "s4": torch.ones(5, 1)})
    with pytest.raises(TypeError):                                 # unpacked nibble planes
        matmul_t(x, {"hi": q, "lo": q, "s": torch.ones(5)})
    a, bm = torch.randn(2, 4), torch.randn(5, 2)
    torch.testing.assert_close(matmul_t(x, {"base": w, "A": a, "B": bm}),
                               x @ w.T + (x @ a.T) @ bm.T)
    with pytest.raises(NotImplementedError, match="Queue 1"):      # multi-LoRA
        matmul_t(x, {"base": w, "A": a[None], "Bt": bm.T[None], "sel": torch.ones(3, 1)})


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def _port_sources():
    return sorted((ROOT / "openvla_probe_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_the_scan_covers_the_training_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for name in ("lora", "train_state", "train_step", "checkpointing", "preemption"):
        assert f"openvla_probe_tpu_torch/training/{name}.py" in scanned
    assert "openvla_probe_tpu_torch/tools/bench_finetune.py" in scanned


def test_the_scan_covers_the_probe_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for name in ("__init__", "episodes", "train_probes", "analysis", "logs", "metrics"):
        assert f"openvla_probe_tpu_torch/probe/{name}.py" in scanned


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import openvla_probe_tpu_torch.models.vla, openvla_probe_tpu_torch.convert; "
            "import openvla_probe_tpu_torch.training.train_step, "
            "openvla_probe_tpu_torch.training.checkpointing, "
            "openvla_probe_tpu_torch.training.preemption, "
            "openvla_probe_tpu_torch.tools.bench_finetune, openvla_probe_tpu_torch.probe; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


def test_the_scan_covers_the_serving_slice():
    scanned = {str(p.relative_to(ROOT)) for p in _port_sources()}
    for name in ("probe/capture", "robot/openvla_utils", "robot/robot_utils", "serving/batcher",
                 "serving/server", "models/vla", "ops/image"):
        assert f"openvla_probe_tpu_torch/{name}.py" in scanned


def test_importing_the_serving_slice_loads_no_jax():
    code = ("import sys; import openvla_probe_tpu_torch.probe.capture, "
            "openvla_probe_tpu_torch.robot.openvla_utils, "
            "openvla_probe_tpu_torch.robot.robot_utils, "
            "openvla_probe_tpu_torch.serving.server, openvla_probe_tpu_torch.serving.batcher; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
