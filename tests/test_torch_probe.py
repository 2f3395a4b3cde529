"""The port's probe bank (``openvla_probe_tpu_torch/probe``) against the JAX
package's, on the CPU, on the synthetic seeded episodes of tests/test_probe.py.

* `train_probes`, handed the JAX package's initial bank (its `train_probes`
  run for 0 epochs), against the JAX `train_probes` for the binary, dual (with
  the (0.01, 0.99) frequency filter) and 3-class heads and the shuffled-label
  control: the same split, keep columns and majority baseline; the bank
  within 1e-5 + 1e-5 |w| after 8 epochs at lr 1e-2 (measured at most 1.8e-7:
  the fp32 gradients summed in another order; AdamW moves a weight by about
  lr·sign(g) a step, so a gradient near zero could carry that further); the
  records within 1e-2 (measured equal: a prediction at the 0.5 threshold may
  flip between two banks that close, and one frame of the ~50 validation
  frames moves an accuracy by 2e-3 and an F1 by a few 1e-3).
* `evaluate_probes`, `collect_logits`, `per_label_metrics`, `family_auprc` and
  `logs.single_label_f1` on one bank in both packages: equal to 1e-12 (numpy
  logits on both sides; the port's numpy metrics against scikit-learn's).
* The numpy metrics against scikit-learn on edge cases: no positives, all
  positives, every prediction one class, ties in the scores, one sample, and
  random data; to 1e-12.
* A bank or an episode saved by one package and loaded by the other.
"""

import dataclasses

import numpy as np
import pytest
import torch
from sklearn import metrics as skm

from openvla_probe_tpu.probe import analysis as janalysis
from openvla_probe_tpu.probe import episodes as jepisodes
from openvla_probe_tpu.probe import logs as jlogs
from openvla_probe_tpu.probe import train_probes as jtp
from openvla_probe_tpu_torch.probe import analysis as tanalysis
from openvla_probe_tpu_torch.probe import episodes as tepisodes
from openvla_probe_tpu_torch.probe import logs as tlogs
from openvla_probe_tpu_torch.probe import metrics as tm
from openvla_probe_tpu_torch.probe import train_probes as ttp

from tests.test_probe import make_episodes

BASE = jtp.ProbeTrainConfig(epochs=8, batch_size=64, learning_rate=1e-2)
CASES = {
    "binary": BASE,
    "dual": dataclasses.replace(BASE, head="dual", freq_filter=(0.01, 0.99)),
    "3class": dataclasses.replace(BASE, head="3class"),
    "shuffled": dataclasses.replace(BASE, shuffled_label_control=True),
}


def _tcfg(cfg):
    return ttp.ProbeTrainConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def eps():
    return make_episodes()


@pytest.fixture(scope="module")
def runs(eps):
    out = {}
    for name, cfg in CASES.items():
        init = jtp.train_probes(eps, dataclasses.replace(cfg, epochs=0))["bank"]
        want = jtp.train_probes(eps, cfg)
        got = ttp.train_probes(eps, _tcfg(cfg), device="cpu", init=(init.w, init.b))
        out[name] = (want, got, init)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_split_keep_and_baseline_equal(runs, name):
    want, got, _ = runs[name]
    assert got["split"] == want["split"]
    np.testing.assert_array_equal(got["bank"].keep, want["bank"].keep)
    assert got["bank"].layers == want["bank"].layers and got["bank"].head == want["bank"].head
    for key in ("val_acc", "val_f1"):
        assert got["baseline"][key] == pytest.approx(want["baseline"][key], abs=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_bank_matches_jax_from_the_same_start(runs, name):
    want, got, init = runs[name]
    for key in ("w", "b"):
        g, w = getattr(got["bank"], key), getattr(want["bank"], key)
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
        assert np.abs(w - getattr(init, key)).max() > 10 * CASES[name].learning_rate   # it moved


@pytest.mark.parametrize("name", list(CASES))
def test_records_match_jax(runs, name):
    want, got, _ = runs[name]
    assert [r.keys() for r in got["records"]] == [r.keys() for r in want["records"]]
    for g, w in zip(got["records"], want["records"]):
        assert g["layer"] == w["layer"]
        for key in g:
            assert g[key] == pytest.approx(w[key], abs=1e-2), (key, g, w)


def test_the_planted_layer_wins_in_the_port(eps):
    """The port alone, from its own seeded start: the informative layer decodes
    the labels, the noise layer does not (tests/test_probe.py's claims)."""
    cfg = ttp.ProbeTrainConfig(epochs=30, batch_size=64, learning_rate=1e-2)
    result = ttp.train_probes(eps, cfg, device="cpu")
    recs = {r["layer"]: r for r in result["records"]}
    assert recs[1]["val_f1"] > 0.9, recs
    assert recs[1]["val_f1"] > recs[0]["val_f1"] + 0.2
    assert recs[1]["val_ap"] > recs[0]["val_ap"]
    assert result["baseline"]["val_f1"] < recs[1]["val_f1"]
    w0, b0 = ttp.init_bank(3, len(result["bank"].keep), 24, cfg.seed)
    w1, _ = ttp.init_bank(3, len(result["bank"].keep), 24, cfg.seed)
    assert torch.equal(w0, w1) and w0.abs().max() <= 1 / np.sqrt(24)


def test_init_shape_is_checked(eps):
    with pytest.raises(ValueError, match="init"):
        ttp.train_probes(eps, ttp.ProbeTrainConfig(epochs=1), device="cpu",
                         init=(np.zeros((3, 2, 24)), np.zeros((3, 2))))


# --- the host side on one bank --------------------------------------------------------------

@pytest.mark.parametrize("name", ["binary", "dual", "3class"])
def test_evaluate_probes_equal_on_one_bank(runs, eps, name):
    want, _, _ = runs[name]
    bank = want["bank"]
    xs, ys = jtp._episode_xy(eps, jtp.DEFAULT_LABEL_KEYS)
    val = want["split"]["val_ids"]
    x_val = np.concatenate([xs[i][bank.layers] for i in val], axis=1)
    y_val = np.concatenate([ys[i] for i in val], axis=0)[:, bank.keep]
    tbank = ttp.ProbeBank(bank.w, bank.b, bank.layers, bank.keep, bank.head)
    j = jtp.evaluate_probes(bank, x_val, y_val, CASES[name])
    t = ttp.evaluate_probes(tbank, x_val, y_val, _tcfg(CASES[name]))
    assert j == pytest.approx(t, abs=1e-12)
    assert t == pytest.approx(want["records"], abs=1e-12)


def test_analysis_equal_on_one_bank(runs, eps):
    bank = runs["binary"][0]["bank"]
    tbank = ttp.ProbeBank(bank.w, bank.b, bank.layers, bank.keep, bank.head)
    jc, tc = janalysis.collect_logits(bank, eps), tanalysis.collect_logits(tbank, eps)
    assert jc.keys() == tc.keys()
    for layer in jc:
        np.testing.assert_array_equal(tc[layer]["logits"], jc[layer]["logits"])
        np.testing.assert_array_equal(tc[layer]["targets"], jc[layer]["targets"])
    names = ["(inside a b)", "(on c d)", "(inside e f)", "open_drawer", "(on g h)"][:bank.keep.size]
    jrows = janalysis.per_label_metrics(jc, names)
    trows = tanalysis.per_label_metrics(tc, names)
    assert len(trows) == len(jrows) > 0
    for g, w in zip(trows, jrows):
        assert g.keys() == w.keys()
        for key in g:
            if isinstance(w[key], float) and np.isnan(w[key]):
                assert np.isnan(g[key])
            else:
                assert g[key] == pytest.approx(w[key], abs=1e-12), key
    jf, tf = janalysis.family_auprc(jc, names), tanalysis.family_auprc(tc, names)
    assert [r["family"] for r in tf] == [r["family"] for r in jf]
    for g, w in zip(tf, jf):
        for key in ("auprc", "prior", "lift", "n", "n_pos"):
            assert g[key] == pytest.approx(w[key], abs=1e-12, nan_ok=True), key
    for k in range(bank.keep.size):
        assert tlogs.single_label_f1(tc, k, 1) == pytest.approx(
            jlogs.single_label_f1(jc, k, 1), abs=1e-12, nan_ok=True)


# --- the numpy metrics against scikit-learn ------------------------------------------------

_r = np.random.default_rng(9)
METRIC_CASES = {
    "no_positives": (np.zeros(8, int), np.array([0, 0, 1, 0, 0, 1, 0, 0]),
                     np.linspace(0.1, 0.9, 8)),
    "no_positives_none_predicted": (np.zeros(6, int), np.zeros(6, int), np.full(6, 0.3)),
    "all_positives": (np.ones(7, int), np.array([1, 1, 0, 1, 1, 1, 0]), _r.random(7)),
    "all_predicted_positive": (np.array([0, 1, 1, 0, 1]), np.ones(5, int), _r.random(5)),
    "ties_in_scores": (np.array([1, 0, 1, 0, 1, 0, 0, 1]), np.array([1, 0, 0, 0, 1, 1, 0, 1]),
                       np.array([0.5, 0.5, 0.5, 0.2, 0.9, 0.9, 0.2, 0.5])),
    "all_scores_equal": (np.array([1, 0, 0, 1, 0]), np.array([1, 1, 1, 1, 1]), np.full(5, 0.7)),
    "one_sample": (np.array([1]), np.array([0]), np.array([0.2])),
    "random": (_r.integers(0, 2, 500), _r.integers(0, 2, 500), _r.random(500).round(2)),
}


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_binary_metrics_equal_sklearn(case):
    y, p, s = METRIC_CASES[case]
    for average in ("binary", "macro"):
        assert tm.f1_score(y, p, average=average, zero_division=0) == pytest.approx(
            skm.f1_score(y, p, average=average, zero_division=0), abs=1e-12), average
    assert tm.precision_score(y, p, zero_division=0) == pytest.approx(
        skm.precision_score(y, p, zero_division=0), abs=1e-12)
    assert tm.recall_score(y, p, zero_division=0) == pytest.approx(
        skm.recall_score(y, p, zero_division=0), abs=1e-12)
    assert tm.average_precision_score(y, s) == pytest.approx(
        skm.average_precision_score(y, s), abs=1e-12)
    assert tm.matthews_corrcoef(y, p) == pytest.approx(skm.matthews_corrcoef(y, p), abs=1e-12)
    if len(np.unique(y)) > 1:
        assert tm.balanced_accuracy_score(y, p) == pytest.approx(
            skm.balanced_accuracy_score(y, p), abs=1e-12)


@pytest.mark.filterwarnings("ignore")
@pytest.mark.parametrize("seed", range(3))
def test_three_class_macro_f1_equals_sklearn(seed):
    r = np.random.default_rng(seed)
    y = r.integers(0, 3, 200)
    p = np.where(r.random(200) < 0.6, y, r.integers(0, 2, 200))   # class 2 rarely predicted
    assert tm.f1_score(y, p, average="macro", zero_division=0) == pytest.approx(
        skm.f1_score(y, p, average="macro", zero_division=0), abs=1e-12)
    y2 = np.where(y == 2, 0, y)                                     # a class only predicted
    assert tm.f1_score(y2, p, average="macro", zero_division=0) == pytest.approx(
        skm.f1_score(y2, p, average="macro", zero_division=0), abs=1e-12)


# --- files shared by the two packages --------------------------------------------------------

def test_bank_saved_by_one_package_loads_in_the_other(runs, tmp_path):
    jbank = runs["dual"][0]["bank"]
    tbank = runs["dual"][1]["bank"]
    for saved, loader in ((jbank, ttp.ProbeBank), (tbank, jtp.ProbeBank)):
        path = saved.save(tmp_path / f"bank_{type(saved).__module__.split('.')[0]}.npz")
        back = loader.load(path)
        np.testing.assert_array_equal(back.w, saved.w)
        np.testing.assert_array_equal(back.b, saved.b)
        np.testing.assert_array_equal(back.keep, saved.keep)
        assert back.layers == list(saved.layers) and back.head == saved.head
        x = np.random.default_rng(0).normal(size=(5, saved.w.shape[-1])).astype(np.float32)
        np.testing.assert_array_equal(back.logits(x, 1), saved.logits(x, 1))


def test_episodes_written_by_one_package_load_in_the_other(tmp_path):
    r = np.random.default_rng(1)
    for writer_mod, reader_mod in ((tepisodes, jepisodes), (jepisodes, tepisodes)):
        d = tmp_path / writer_mod.__name__.split(".")[0]
        w = writer_mod.EpisodeWriter(d)
        hidden = r.normal(size=(4, 3, 16)).astype(np.float32)
        for t in range(4):
            w.append(hidden[t], symbolic_state_object_relations=r.integers(-1, 2, 5))
        w.flush(3, success=True)
        eps = list(reader_mod.iter_episodes(d))
        assert len(eps) == 1 and eps[0]["visual_semantic_encoding"].shape == (3, 4, 16)
        np.testing.assert_array_equal(eps[0]["visual_semantic_encoding"],
                                      hidden.transpose(1, 0, 2).astype(np.float16))
        pt = writer_mod.export_episode_pt(d / "episode_3.npz")
        back = reader_mod.load_episode(pt)
        np.testing.assert_array_equal(back["visual_semantic_encoding"],
                                      eps[0]["visual_semantic_encoding"].astype(np.float32))


def test_metrics_csv_has_the_jax_package_s_columns(runs, tmp_path):
    want, got, _ = runs["binary"]
    jpath = jtp.save_metrics_csv(want["records"], tmp_path / "j.csv")
    tpath = ttp.save_metrics_csv(got["records"], tmp_path / "t.csv")
    assert jpath.read_text().splitlines()[0] == tpath.read_text().splitlines()[0]
