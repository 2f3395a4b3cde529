"""The action codec's encode side and ActionTokenizer
(openvla_probe_tpu_torch/vla/action_tokenizer.py), and the copy of
probe/plots.py with the label-key files, against the JAX package.

ActionCodec.encode (fp32 edges) and ActionTokenizer (float64 np.digitize, and
strings through a tokenizer.json read by each package's reader) give bit-equal
ids and equal strings on seeded actions, bin edges and values out of range."""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import openvla_probe_tpu
import openvla_probe_tpu_torch
from openvla_probe_tpu.models.tokenization import load_tokenizer as jax_load_tokenizer
from openvla_probe_tpu.probe import plots as jplots
from openvla_probe_tpu.vla import action_tokenizer as jat
from openvla_probe_tpu_torch.models.tokenization import load_tokenizer
from openvla_probe_tpu_torch.probe import plots as tplots
from openvla_probe_tpu_torch.vla import action_tokenizer as tat
from tests.test_torch_tokenization import build_spec

JROOT = Path(openvla_probe_tpu.__file__).parent
TROOT = Path(openvla_probe_tpu_torch.__file__).parent


def _actions(seed=0, n=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1.3, 1.3, (n, 7)).astype(np.float32)
    edges = np.linspace(-1, 1, 256).astype(np.float32)
    a[:4] = edges[rng.integers(0, 256, (4, 7))]          # exactly on fp32 edges
    a[4, :3] = [-1.0, 1.0, 0.0]
    return a


@pytest.mark.parametrize("vocab", [32000, 857])
def test_codec_encode_equals_jax(vocab):
    a = _actions()
    want = np.asarray(jat.ActionCodec(vocab_size=vocab).encode(jnp.asarray(a)))
    got = tat.ActionCodec(vocab_size=vocab).encode(torch.from_numpy(a))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and back through decode: the bin centers
    np.testing.assert_array_equal(
        tat.ActionCodec(vocab_size=vocab).decode(got).numpy(),
        np.asarray(jat.ActionCodec(vocab_size=vocab).decode(jnp.asarray(want))))


@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    (d / "tokenizer.json").write_text(json.dumps(build_spec("legacy")))
    return jax_load_tokenizer(d), load_tokenizer(d)


def test_action_tokenizer_equals_jax(toks):
    jtok, ttok = toks
    jt, tt = jat.ActionTokenizer(jtok), tat.ActionTokenizer(ttok)
    assert tt.vocab_size == jt.vocab_size and tt.action_token_begin_idx == jt.action_token_begin_idx
    np.testing.assert_array_equal(tt.bins, jt.bins)
    np.testing.assert_array_equal(tt.bin_centers, jt.bin_centers)
    a = _actions(1).astype(np.float64)
    ids = tt.encode_to_ids(a)
    np.testing.assert_array_equal(ids, jt.encode_to_ids(a))
    assert ids.dtype == np.int64
    assert tt(a) == jt(a) and tt(a[0]) == jt(a[0])
    np.testing.assert_array_equal(tt.decode_token_ids_to_actions(ids),
                                  jt.decode_token_ids_to_actions(ids))


def test_plots_is_the_jax_file():
    assert (TROOT / "probe/plots.py").read_bytes() == (JROOT / "probe/plots.py").read_bytes()


@pytest.mark.parametrize("name", ["object_object_relations_keys.txt",
                                  "object_action_states_keys.txt",
                                  "spatial_object_relations_keys.txt",
                                  "spatial_action_states_keys.txt"])
def test_label_key_files_are_the_jax_files(name):
    t, j = TROOT / "robot/label_keys" / name, JROOT / "robot/label_keys" / name
    assert t.read_bytes() == j.read_bytes()
    assert len(ast.literal_eval(t.read_text())) > 0


def _episodes(K, seed=0):
    rng = np.random.default_rng(seed)
    return [{"symbolic_state_object_relations": rng.integers(-1, 2, (9, K - 3)),
             "symbolic_state_action_subgoals": rng.integers(-1, 2, (9, 3))} for _ in range(3)]


def test_label_stats_rows_equal_jax():
    names = [f"on(obj{i},table)" for i in range(5)] + ["grasped(obj0)", "open(drawer)",
                                                        "near(a,b)"]
    eps = _episodes(len(names))
    assert tplots.label_stats_rows(eps, names) == jplots.label_stats_rows(eps, names)
    st, sj = tplots.label_frequency_stats(eps), jplots.label_frequency_stats(eps)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k])


def test_each_plot_writes_its_png(tmp_path):
    pytest.importorskip("matplotlib")
    rows = [{"layer": l, "label": f"{f}(a,b)", "f1": (l * 7 + i) % 10 / 10, "recall": 0.5,
             "support": i + 1} for l in range(4) for i, f in enumerate(("on", "near", "open"))]
    outs = [tplots.plot_family_heatmap(rows, tmp_path / "h.png"),
            tplots.plot_family_heatmap(rows, tmp_path / "hw.png", weight_by_support=True),
            tplots.plot_layer_metric_curves([{"layer": l, "val_f1": 0.5, "val_acc": 0.6}
                                             for l in range(4)], tmp_path / "c.png"),
            tplots.plot_label_frequencies(tplots.label_frequency_stats(_episodes(8)),
                                          tmp_path / "f.png")]
    for p in outs:
        assert p.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    want = jplots.family_layer_matrix(rows, "f1", True)
    got = tplots.family_layer_matrix(rows, "f1", True)
    np.testing.assert_array_equal(got["matrix"], want["matrix"])
