"""The port's export and probe scripts (openvla_probe_tpu_torch/scripts/
convert_weights_to_hf, train_probes, analyze_probes) against the JAX
package's scripts, on the CPU at tiny size. Each port script runs as
``python -m openvla_probe_tpu_torch.scripts.<name>`` in a subprocess
(tests/test_torch_cli.port_script: ``--device cpu`` for train_probes; the
other two run on the host only); each JAX script runs in this
process through its own ``main``.

* convert_weights_to_hf: the same parameters saved as each package's trainer
  checkpoint (orbax; the port's state.pt) export to equal tensors and
  byte-equal sidecars; a depth-cut checkpoint exports at its own depth and
  loads back with the port's ``load``.
* train_probes on planted labels: the same files and columns; each layer's
  val F1 within TRAIN_F1_TOL of JAX's (the banks' initial draws differ by
  design: ROADMAP's standing divergences).
* analyze_probes on one bank: every CSV equal within 1e-6, every heatmap
  written; with matplotlib unimportable (the card's machine) the same CSVs
  and the bare-matrix PNGs, under their own ``*_matrix.png`` names.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from openvla_probe_tpu.models import catalog as jcat
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.training import checkpointing as jckpt
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.models import catalog as tcat
from openvla_probe_tpu_torch.models import load as tload
from openvla_probe_tpu_torch.scripts import analyze_probes
from openvla_probe_tpu_torch.training import checkpointing as tckpt
from openvla_probe_tpu_torch.utils.image_io import read_image
from tests.test_hub_load import ARCH, LLM_ID, VIS_ID
from tests.test_torch_cli import ROOT, jax_script, port_env, port_script
from tests.test_torch_openvla import clean_ovla_env  # noqa: F401 (autouse)

safetensors_numpy = pytest.importorskip("safetensors.numpy")

# planted labels, 100 epochs: both banks reach a val F1 near 0.71 at every layer, and
# their initial draws (not the same bits) moved it by at most 0.005 here
TRAIN_F1_TOL = 0.02
TRAIN_EPOCHS = 100
SUITE = "spatial"
N_LABELS = (224, 12)        # robot/label_keys: spatial object relations, action states
STATS = {"bridge_orig": {"action": {"q01": [-1.0] * 7, "q99": [1.0] * 7}}}
SIDECARS = ("config.json", "preprocessor_config.json", "processor_config.json",
            "dataset_statistics.json", "tokenizer_config.json")


def _tiny_params(seed=0):
    cfg, _, _ = jcat.build_vlm_config(VIS_ID, LLM_ID, ARCH, "resize-naive")
    params = jax.tree.map(np.asarray, jvlm.init_params(cfg, jax.random.key(seed)))
    tcfg = convert.config_from_jax(cfg)
    return params, convert.params_from_jax(params, tcfg, device="cpu"), tcfg


def test_convert_matches_jax(tmp_path):
    jparams, tparams, tcfg = _tiny_params()
    jrun, trun = tmp_path / "jrun", tmp_path / "trun"
    jckpt.save_checkpoint(jrun, {"params": jparams}, step=3)
    tckpt.save_checkpoint(trun, {"params": tparams}, step=3)
    for run in (jrun, trun):
        (run / "dataset_statistics.json").write_text(json.dumps(STATS))
    ids = dict(vision_backbone_id=VIS_ID, llm_backbone_id=LLM_ID, arch_specifier=ARCH)
    jconv = jax_script("convert_weights_to_hf")
    jconv.main(jconv.HFConvertConfig(run_dir=str(jrun), output_dir=str(tmp_path / "jout"), **ids))
    port_script("convert_weights_to_hf", "--run_dir", trun, "--output_dir", tmp_path / "tout",
                *[a for k, v in ids.items() for a in (f"--{k}", v)])
    want = safetensors_numpy.load_file(str(tmp_path / "jout" / "model.safetensors"))
    got = safetensors_numpy.load_file(str(tmp_path / "tout" / "model.safetensors"))
    assert got.keys() == want.keys()
    flat = dict(tcat.params_to_hf_state(tparams, tcfg))
    for k in want:
        # the JAX restore widens bf16 leaves to fp32; the port writes the checkpoint's dtype
        assert got[k].dtype == np.dtype(str(flat[k].dtype).replace("torch.", "")), k
        np.testing.assert_array_equal(got[k].astype(np.float32), want[k].astype(np.float32),
                                      err_msg=k)
    for name in SIDECARS:
        assert (tmp_path / "tout" / name).read_bytes() == (tmp_path / "jout" / name).read_bytes()


def test_convert_exports_a_depth_cut_checkpoint(tmp_path):
    """A trainer checkpoint whose trunk keeps 1 of the id's 4 layers exports
    at its depth (text_config.num_hidden_layers) and loads back bit for bit."""
    _, tparams, tcfg = _tiny_params(1)
    tparams["llm"]["layers"] = {k: v[:1].clone() for k, v in tparams["llm"]["layers"].items()}
    assert tcfg.llm.num_hidden_layers == 4
    run = tmp_path / "run"
    tckpt.save_checkpoint(run, {"params": tparams}, step=1)
    port_script("convert_weights_to_hf", "--run_dir", run, "--output_dir", tmp_path / "out",
                "--vision_backbone_id", VIS_ID, "--llm_backbone_id", LLM_ID,
                "--arch_specifier", ARCH)
    cfg = json.loads((tmp_path / "out" / "config.json").read_text())
    assert cfg["text_config"]["num_hidden_layers"] == 1
    bundle = tload.load(tmp_path / "out", dtype=torch.float32, device="cpu")
    assert bundle["cfg"].llm.num_hidden_layers == 1

    def leaves(t, p=""):
        if not isinstance(t, dict):
            return {p: t}
        return {k2: x for k, v in t.items() for k2, x in leaves(v, f"{p}/{k}").items()}

    got, want = leaves(bundle["params"]), leaves(tparams)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _episodes(log_dir: Path, n_eps=40, T=32, layers=3, D=32, seed=0):
    """Episode files (probe/episodes.py layout) whose labels are planted
    linear functions of the hidden state at every layer, with some -1s."""
    rng = np.random.default_rng(seed)
    log_dir.mkdir(parents=True, exist_ok=True)
    K = sum(N_LABELS)
    w = rng.normal(size=(D, K))
    for e in range(n_eps):
        base = rng.normal(size=(T, D))
        hidden = np.stack([base + 0.05 * rng.normal(size=(T, D)) for _ in range(layers)])
        y = (base @ w > 0).astype(np.int8)
        y[rng.random(y.shape) < 0.05] = -1
        np.savez_compressed(log_dir / f"episode_{e}.npz",
                            visual_semantic_encoding=hidden.astype(np.float16),
                            symbolic_state_object_relations=y[:, :N_LABELS[0]],
                            symbolic_state_action_subgoals=y[:, N_LABELS[0]:])
    return log_dir


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _csvs_close(got_dir, want_dir, tol=1e-6):
    names = sorted(p.name for p in want_dir.glob("*.csv"))
    assert names and names == sorted(p.name for p in got_dir.glob("*.csv"))
    for name in names:
        got, want = _csv(got_dir / name), _csv(want_dir / name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            assert list(g) == list(w), name
            for k in w:
                try:
                    a, b = float(g[k]), float(w[k])
                except ValueError:
                    assert g[k] == w[k], (name, k)
                    continue
                assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol, (name, k, a, b)
    return names


@pytest.fixture(scope="module")
def episodes(tmp_path_factory):
    return _episodes(tmp_path_factory.mktemp("logs"))


def test_train_probes_matches_jax(episodes, tmp_path):
    jtrain = jax_script("train_probes")
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jtrain.main(jtrain.ProbeCLIConfig(log_dir=str(episodes), out_dir=str(jout), suite=SUITE,
                                      epochs=TRAIN_EPOCHS))
    port_script("train_probes", "--log_dir", episodes, "--out_dir", tout, "--suite", SUITE,
                "--epochs", TRAIN_EPOCHS)
    assert sorted(p.name for p in tout.iterdir()) == sorted(p.name for p in jout.iterdir())
    for name in (f"probe_metrics_{SUITE}.csv", f"probe_metrics_{SUITE}_reference_schema.csv"):
        got, want = _csv(tout / name), _csv(jout / name)
        assert [list(r) for r in got] == [list(r) for r in want]
    got, want = _csv(tout / f"probe_metrics_{SUITE}.csv"), _csv(jout / f"probe_metrics_{SUITE}.csv")
    for g, w in zip(got, want):
        assert g["layer"] == w["layer"]
        assert float(w["val_f1"]) > 0.65
        assert abs(float(g["val_f1"]) - float(w["val_f1"])) < TRAIN_F1_TOL, (g, w)
    z = np.load(tout / f"probe_bank_{SUITE}_binary.npz")
    np.testing.assert_array_equal(z["keep"], np.load(jout / f"probe_bank_{SUITE}_binary.npz")["keep"])


_NO_MATPLOTLIB = ("import importlib.abc, runpy, sys\n"
                  "class _Block(importlib.abc.MetaPathFinder):\n"
                  "    def find_spec(self, name, path=None, target=None):\n"
                  "        if name.split('.')[0] == 'matplotlib':\n"
                  "            raise ImportError('blocked: ' + name)\n"
                  "sys.meta_path.insert(0, _Block())\n"
                  "sys.argv = ['analyze_probes'] + sys.argv[1:]\n"
                  "runpy.run_module('openvla_probe_tpu_torch.scripts.analyze_probes', "
                  "run_name='__main__')\n")


def test_analyze_probes_matches_jax(episodes, tmp_path):
    jtrain = jax_script("train_probes")
    bank_dir = tmp_path / "bank"
    jtrain.main(jtrain.ProbeCLIConfig(log_dir=str(episodes), out_dir=str(bank_dir), suite=SUITE,
                                      epochs=5))
    bank = bank_dir / f"probe_bank_{SUITE}_binary.npz"
    jana = jax_script("analyze_probes")
    jout, tout, bare = tmp_path / "jax", tmp_path / "port", tmp_path / "bare"
    jana.main(jana.AnalyzeConfig(bank=str(bank), log_dir=str(episodes), out_dir=str(jout),
                                 suite=SUITE))
    args = ["--bank", bank, "--log_dir", episodes, "--suite", SUITE]
    port_script("analyze_probes", *args, "--out_dir", tout)
    names = _csvs_close(tout, jout)
    assert {"per_label_metrics.csv", "family_auprc.csv", "label_stats.csv"} <= set(names)
    pngs = sorted(p.name for p in jout.glob("*.png"))
    assert len(pngs) == 3 and sorted(p.name for p in tout.glob("*.png")) == pngs
    # the card's machine: no matplotlib
    out = subprocess.run([sys.executable, "-c", _NO_MATPLOTLIB, *map(str, args), "--out_dir",
                          str(bare)], cwd=ROOT, env=port_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "matplotlib is not installed" in out.stderr
    _csvs_close(bare, jout)
    rows = _csv(jout / "per_label_metrics.csv")
    n_layers = len({r["layer"] for r in rows})
    assert sorted(p.name for p in bare.glob("*.png")) == sorted(map(analyze_probes.matrix_name,
                                                                    pngs))
    for name in pngs:
        img = read_image(bare / analyze_probes.matrix_name(name))
        assert img.shape[0] == 16 * n_layers and img.shape[1] % 16 == 0, (name, img.shape)
