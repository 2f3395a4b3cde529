"""The port's base-VLM entry points against the JAX package's, on the CPU at
`VLMConfig.tiny()` fp32: `vlm.forward`, generation (`models/generate.py`),
candidate scoring and the eval harness (`eval/harness.py`). Both sides get
the same weights (`convert.params_from_jax`) and the same inputs from one
numpy seed. The JAX kernels run in interpret mode (OVLA_PALLAS=1,
OVLA_PALLAS_INTERPRET=1, set through monkeypatch only) except for rows longer
than 1024 keys, where the JAX package takes its XLA attention on the CPU and
the port the blockwise flash function.

Tolerances: tokens, texts, predictions and metrics equal; logits within fp32
atol 1e-4 (the same fp32 sums in another order through the model); summed
log-probabilities within atol 1e-3 (a few tokens' log-softmax of those
logits, each within 2e-4).

The tokenizer is the `FakeTok` of tests/test_eval_harness.py with a stable
word hash (zlib.crc32 in place of the per-process salted `hash`), so that
every run sees the same ids.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openvla_probe_tpu.eval import harness as jharness
from openvla_probe_tpu.models import generate as jgen
from openvla_probe_tpu.models import vlm as jvlm
from openvla_probe_tpu.ops import image as jimage
from openvla_probe_tpu_torch import convert
from openvla_probe_tpu_torch.eval import harness as tharness
from openvla_probe_tpu_torch.models import generate as tgen
from openvla_probe_tpu_torch.models import vlm as tvlm
from openvla_probe_tpu_torch.ops import attention as tattn
from openvla_probe_tpu_torch.ops import image as timage

LOGIT_TOL = 1e-4
SCORE_TOL = 1e-3


class FakeTok:
    vocab_size = 512

    def encode(self, s):
        return [1] + [50 + (zlib.crc32(w.encode()) % 400) for w in s.split()]

    def decode(self, ids, skip_special_tokens=False):
        return " ".join(f"t{i}" for i in ids)


def _img_cfg(m):
    return m.ImageTransformConfig(specs=(
        m.BackboneTransformSpec((28, 28), "bicubic", (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
        m.BackboneTransformSpec((28, 28), "bicubic", (0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    ))


@pytest.fixture
def jax_kernels(monkeypatch):
    monkeypatch.setenv("OVLA_PALLAS", "1")
    monkeypatch.setenv("OVLA_PALLAS_INTERPRET", "1")


@pytest.fixture
def jax_xla(monkeypatch):
    for name in ("OVLA_PALLAS", "OVLA_PALLAS_INTERPRET", "OVLA_FLASH_ONESHOT"):
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def models():
    cfg = jvlm.VLMConfig.tiny()
    params = jax.tree.map(np.asarray, jvlm.init_params(cfg, jax.random.key(0)))
    tcfg = convert.config_from_jax(cfg)
    return cfg, params, tcfg, convert.params_from_jax(params, tcfg, device="cpu")


def _pixels(seed, n):
    """n preprocessed images, the same values on both sides."""
    img = np.random.default_rng(seed).integers(0, 256, (n, 40, 40, 3), dtype=np.uint8)
    return np.array(jimage.apply_image_transform(jnp.asarray(img), _img_cfg(jimage)))


def _prompts(seed, lens, vocab=512):
    r = np.random.default_rng(seed)
    return [[1] + r.integers(3, vocab, n - 1).tolist() for n in lens]


def _padded(prompts, P):
    ids = np.zeros((len(prompts), P), np.int32)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    return ids, np.array([len(p) for p in prompts], np.int32)


# --- vlm.forward ------------------------------------------------------------------


@pytest.mark.parametrize("case", ["multimodal", "text_only", "mixed"])
def test_vlm_forward_matches_jax(models, jax_kernels, case):
    cfg, params, tcfg, tparams = models
    ids, lens = _padded(_prompts(1, [64, 40, 57]), 64)
    mask = (np.arange(64)[None] < lens[:, None]).astype(np.int32)
    labels = np.where(mask > 0, ids, -100).astype(np.int32)
    labels[:, :5] = -100
    px = None if case == "text_only" else _pixels(2, 3)
    mm = np.array([True, False, True]) if case == "mixed" else None
    want = jvlm.forward(params, cfg, jnp.asarray(ids), jnp.asarray(mask),
                        None if px is None else jnp.asarray(px), labels=jnp.asarray(labels),
                        multimodal_mask=None if mm is None else jnp.asarray(mm))
    got = tvlm.forward(tparams, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                       None if px is None else torch.from_numpy(px),
                       labels=torch.from_numpy(labels),
                       multimodal_mask=None if mm is None else torch.from_numpy(mm))
    T = 64 + (0 if px is None else tcfg.num_patches)
    assert got["logits"].shape == (3, T, tcfg.llm.vocab_size)
    np.testing.assert_array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), atol=LOGIT_TOL)
    np.testing.assert_allclose(got["last_hidden_state"].numpy(),
                               np.asarray(want["last_hidden_state"]), atol=LOGIT_TOL)


def test_vlm_forward_mixed_text_row_equals_unimodal(models):
    """A text-only row of a mixed batch computes the unspliced unimodal row."""
    _, _, tcfg, tparams = models
    ids, lens = _padded(_prompts(3, [30, 22]), 32)
    mask = torch.from_numpy((np.arange(32)[None] < lens[:, None]).astype(np.int32))
    ids = torch.from_numpy(ids)
    mixed = tvlm.forward(tparams, tcfg, ids, mask, torch.from_numpy(_pixels(4, 2)),
                         multimodal_mask=torch.tensor([True, False]))
    uni = tvlm.forward(tparams, tcfg, ids, mask)
    N = tcfg.num_patches
    got = torch.cat([mixed["logits"][1, :1], mixed["logits"][1, 1 + N:]])
    np.testing.assert_allclose(got[:22].numpy(), uni["logits"][1, :22].numpy(), atol=LOGIT_TOL)


def test_vlm_forward_unported_options_raise(models):
    _, _, tcfg, tparams = models
    ids = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tvlm.forward(tparams, tcfg, ids, torch.ones_like(ids), collect_hidden_states=True)


# --- generation -------------------------------------------------------------------


@pytest.mark.parametrize("with_image", [False, True])
def test_generate_tokens_match_jax(models, jax_kernels, with_image):
    cfg, params, tcfg, tparams = models
    ids, lens = _padded(_prompts(5, [9, 20, 14]), 64)
    px = _pixels(6, 3) if with_image else None
    want = np.asarray(jgen._generate_jit(params, cfg, jnp.asarray(ids), jnp.asarray(lens),
                                         None if px is None else jnp.asarray(px), 6))
    got = tgen._generate(tparams, tcfg, ids, lens, px, 6, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_entry_points_match_jax(models, jax_kernels):
    cfg, params, tcfg, tparams = models
    tok = FakeTok()
    prompts = [tok.encode("In: hello world \nOut: "),
               tok.encode("In: a much longer question with many more words here \nOut: "),
               tok.encode("In: q \nOut: ")]
    px = _pixels(7, 3)
    assert (tgen.generate_greedy(tparams, tcfg, tok, prompts[0], max_new_tokens=5, device="cpu")
            == jgen.generate_greedy(params, cfg, tok, prompts[0], max_new_tokens=5))
    assert (tgen.generate_text(tparams, tcfg, tok, prompts[1], px[1:2], max_new_tokens=5,
                               device="cpu")
            == jgen.generate_text(params, cfg, tok, prompts[1], jnp.asarray(px[1:2]),
                                  max_new_tokens=5))
    got = tgen.generate_greedy_batch(tparams, tcfg, tok, prompts, px, max_new_tokens=5,
                                     device="cpu")
    assert got == jgen.generate_greedy_batch(params, cfg, tok, prompts, jnp.asarray(px),
                                             max_new_tokens=5)
    assert got == [tgen.generate_greedy(tparams, tcfg, tok, p, px[i:i + 1], max_new_tokens=5,
                                        device="cpu") for i, p in enumerate(prompts)]


def test_eos_latches_mid_sequence(models, jax_kernels):
    """EOS (id 2) made the greedy choice at a later step of row 0 by giving
    it the lm_head row of that step's token, scaled by 1.001: from there on
    every token of the row is EOS, on both sides; the tokens before it are
    unchanged."""
    cfg, params, tcfg, _ = models
    ids, lens = _padded(_prompts(8, [12, 17]), 64)
    base = np.asarray(jgen._generate_jit(params, cfg, jnp.asarray(ids), jnp.asarray(lens),
                                         None, 8))
    step = next(t for t in range(2, 8) if base[0, t] not in base[0, :t])
    head = params["llm"]["lm_head"].copy()
    head[2] = 1.001 * head[base[0, step]]
    eos_params = {**params, "llm": {**params["llm"], "lm_head": head}}
    want = np.asarray(jgen._generate_jit(eos_params, cfg, jnp.asarray(ids), jnp.asarray(lens),
                                         None, 8))
    got = tgen._generate(convert.params_from_jax(eos_params, tcfg, device="cpu"), tcfg, ids,
                         lens, None, 8, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    first_eos = int(np.argmax(got[0] == 2))
    assert got[0, first_eos] == 2 and 1 <= first_eos <= step
    assert (got[0, first_eos:] == 2).all()
    np.testing.assert_array_equal(got[0, :first_eos], base[0, :first_eos])


def test_sampling_semantics(models):
    """Deterministic per seed, varying across seeds, and equal to greedy at
    temperature -> 0 and at top_k = 1 (the port's generator, not JAX's bits)."""
    _, _, tcfg, tparams = models
    tok = FakeTok()
    ids = tok.encode("In: hello world what is this \nOut: ")

    def gen(**kw):
        return tgen.generate_text(tparams, tcfg, tok, ids, max_new_tokens=6, device="cpu", **kw)

    greedy = gen()
    assert gen(do_sample=True, temperature=5.0, seed=1) == gen(do_sample=True, temperature=5.0,
                                                               seed=1)
    assert len({gen(do_sample=True, temperature=5.0, seed=s) for s in range(6)}) > 1
    assert gen(do_sample=True, temperature=1e-4, seed=3) == greedy
    assert gen(do_sample=True, temperature=5.0, top_k=1, seed=4) == greedy
    # ties at the k-th value stay in
    lg = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
    draws = {int(tgen.pick(lg, True, 1.0, 1, torch.Generator().manual_seed(s))) for s in range(40)}
    assert draws == {1, 2}


# --- scoring ----------------------------------------------------------------------


def test_score_candidates_match_jax(models, jax_kernels):
    cfg, params, tcfg, tparams = models
    prompt = _prompts(9, [30])[0]
    cands = _prompts(10, [3, 5, 2, 7])
    px = _pixels(11, 1)
    want = jgen.score_candidates(params, cfg, prompt, cands, jnp.asarray(px))
    got = tgen.score_candidates(tparams, tcfg, prompt, cands, px, device="cpu")
    assert got.shape == (4,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)


def test_score_continuation_rows_per_row_pixels_match_jax(models, jax_kernels):
    cfg, params, tcfg, tparams = models
    fulls = _prompts(12, [40, 33, 61])
    rows = [(f, s) for f, s in zip(fulls, [35, 20, 60])]
    px = _pixels(13, 3)
    want = jgen.score_continuation_rows(params, cfg, rows, jnp.asarray(px))
    got = tgen.score_continuation_rows(tparams, tcfg, rows, px, device="cpu")
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)


@pytest.mark.parametrize("with_image", [False, True])
def test_score_long_rows_match_jax(models, jax_xla, monkeypatch, with_image):
    """Rows of 1030-1060 tokens (L = 1088; T = 1088, or 1092 with the
    patches): every layer of the port takes the blockwise flash function."""
    cfg, params, tcfg, tparams = models
    fulls = _prompts(14, [1030, 1060, 1045])
    rows = [(f, s) for f, s in zip(fulls, [1020, 1000, 1040])]
    px = _pixels(15, 1) if with_image else None
    calls = []
    real = tattn.flash_attention_blockwise_plain
    monkeypatch.setattr(tattn, "flash_attention_blockwise_plain",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    got = tgen.score_continuation_rows(tparams, tcfg, rows, px, device="cpu")
    T = 1088 + (tcfg.num_patches if with_image else 0)
    assert calls == [(8, T, tcfg.llm.num_attention_heads, tcfg.llm.head_dim)] * \
        tcfg.llm.num_hidden_layers
    want = jgen.score_continuation_rows(params, cfg, rows,
                                        None if px is None else jnp.asarray(px))
    np.testing.assert_allclose(got, want, atol=SCORE_TOL, rtol=0)


# --- eval harness -----------------------------------------------------------------


def _examples(kind):
    r = np.random.default_rng(16)
    imgs = r.integers(0, 256, (3, 40, 40, 3), dtype=np.uint8)
    if kind == "closed":
        return [
            jharness.EvalExample(question="what is shown here?", choices=["cat", "dog", "red ball"],
                                 answer_idx=0, image=imgs[0], example_id="0"),
            jharness.EvalExample(question="which one?", choices=["left", "right"], answer_idx=1,
                                 image=imgs[1], example_id="1"),
            jharness.EvalExample(question="text only question", choices=["yes", "no"],
                                 answer_idx=0, example_id="2"),
            jharness.EvalExample(question="bad", choices=["a"], answer_idx=3, example_id="3"),
        ]
    return [
        jharness.EvalExample(question="what animal?", answers=["cat"], image=imgs[0],
                             example_id="0"),
        jharness.EvalExample(question="what color is the sky today?", answers=["blue"] * 3,
                             image=imgs[1], example_id="1"),
        jharness.EvalExample(question="how many?", answers=["three"], example_id="2"),
    ]


def _port_examples(exs):
    return [tharness.EvalExample(**vars(e)) for e in exs]


@pytest.mark.parametrize("length_normalize", [False, True])
def test_evaluate_closed_set_matches_jax(models, jax_kernels, length_normalize):
    cfg, params, tcfg, tparams = models
    exs = _examples("closed")
    want = jharness.evaluate_closed_set(params, cfg, FakeTok(), exs, image_cfg=_img_cfg(jimage),
                                        length_normalize=length_normalize,
                                        examples_per_batch=2)
    got = tharness.evaluate_closed_set(tparams, tcfg, FakeTok(), _port_examples(exs),
                                       image_cfg=_img_cfg(timage),
                                       length_normalize=length_normalize,
                                       examples_per_batch=2, device="cpu")
    assert (got["accuracy"], got["n"], got["n_skipped"]) == \
        (want["accuracy"], want["n"], want["n_skipped"])
    assert [(r["id"], r["predicted_idx"], r["correct"]) for r in got["results"]] == \
        [(r["id"], r["predicted_idx"], r["correct"]) for r in want["results"]]
    for g, w in zip(got["results"], want["results"]):
        np.testing.assert_allclose(g["scores"], w["scores"], atol=SCORE_TOL, rtol=0)


def test_evaluate_open_ended_matches_jax(models, jax_kernels):
    cfg, params, tcfg, tparams = models
    exs = _examples("open")
    for metric in ("vqa", "exact"):
        want = jharness.evaluate_open_ended(params, cfg, FakeTok(), exs,
                                            image_cfg=_img_cfg(jimage), max_new_tokens=4,
                                            metric=metric)
        got = tharness.evaluate_open_ended(tparams, tcfg, FakeTok(), _port_examples(exs),
                                           image_cfg=_img_cfg(timage), max_new_tokens=4,
                                           metric=metric, device="cpu")
        assert got == want


def test_harness_text_helpers_match_jax(tmp_path):
    tok = FakeTok()
    for text in ("The  red Ball!", "a, an, the", "it's blue-green"):
        assert tharness.normalize_answer(text) == jharness.normalize_answer(text)
    answers = ["cat", "cat"] + ["dog"] * 8
    for pred in ("the cat", "dog", "bird"):
        assert tharness.vqa_accuracy(pred, answers) == jharness.vqa_accuracy(pred, answers)
        assert tharness.exact_match(pred, answers) == jharness.exact_match(pred, answers)
    assert (tharness._continuation_split(tok, "In: q\nOut: ", "hello world")
            == jharness._continuation_split(tok, "In: q\nOut: ", "hello world"))
    assert tharness._build_prompt("q?", None) == jharness._build_prompt("q?", None)
    from PIL import Image

    img = np.random.default_rng(17).integers(0, 256, (8, 8, 3), dtype=np.uint8)
    Image.fromarray(img).save(tmp_path / "x.png")
    p = tmp_path / "eval.jsonl"
    p.write_text('{"question": "Q1", "choices": ["Yes", "no"], "answer": "yes", "image": "x.png"}\n'
                 '{"question": "Q2", "answer": "x"}\n')
    want = [vars(e) for e in jharness.load_jsonl_dataset(str(p), image_root=str(tmp_path))]
    got = [vars(e) for e in tharness.load_jsonl_dataset(
        str(p), image_root=str(tmp_path),
        image_loader=lambda f: np.asarray(Image.open(f).convert("RGB")))]
    np.testing.assert_array_equal(got[0].pop("image"), want[0].pop("image"))
    assert got == want
    # the port decodes no image file by itself
    with pytest.raises(ValueError, match="image_loader"):
        tharness.load_jsonl_dataset(str(p), image_root=str(tmp_path))


def test_entry_points_raise_without_cuda(models, monkeypatch):
    _, _, tcfg, tparams = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.generate_greedy(tparams, tcfg, FakeTok(), [1, 5, 6], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.score_candidates(tparams, tcfg, [1, 5], [[6], [7]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tharness.evaluate_closed_set(tparams, tcfg, FakeTok(), _port_examples(
            _examples("closed")[:1]), image_cfg=_img_cfg(timage))
