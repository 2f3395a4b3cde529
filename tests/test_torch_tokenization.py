"""The port's tokenizer.json reader (openvla_probe_tpu_torch/models/
tokenization.py) against the JAX package's load_tokenizer, which hands the
same file to the ``tokenizers`` package.

Two files are built here with ``tokenizers``: a BPE with byte_fallback over a
seeded vocabulary (``<unk>``, ``<s>``, ``</s>``, ``<0x00>``..``<0xFF>``, the
merges a BpeTrainer learns from a seeded corpus, then OpenVLA's ``<PAD>``),
one in each normalizer form Llama files carry (the Prepend / Replace
normalizer; the Metaspace pre-tokenizer with prepend_scheme "first"). Over
generated strings (ASCII, runs of spaces and newlines, characters and emoji
outside the vocabulary, literal special tokens) the port's encode, decode
with and without skip_special_tokens, vocab_size and BOS id equal the JAX
tokenizer's exactly. So does the seeded 32000-entry file that chip_smoke.py
writes (tools/synthetic_tokenizer.py). Unsupported components raise."""

import copy
import json
import random

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from openvla_probe_tpu.models.tokenization import load_tokenizer as jax_load_tokenizer
from openvla_probe_tpu_torch.models import tokenization as ttok
from openvla_probe_tpu_torch.tools.synthetic_tokenizer import write_llama_tokenizer

tokenizers = pytest.importorskip("tokenizers")

SPACE = "▁"
FRAGMENTS = ["a", "b", "ab", "the", " ", "  ", "\n", "\t", "In: What action", "?\nOut:",
             "robot", "é", "ü", "ñ", "日本", "😀", "🤖", "<s>", "</s>", "<PAD>", "<unk>",
             SPACE, "<0x41>", "<", ">", "s", "aaaa", "0123", ".", ","]
DECODER = {"type": "Sequence", "decoders": [
    {"type": "Replace", "pattern": {"String": SPACE}, "content": " "},
    {"type": "ByteFallback"}, {"type": "Fuse"},
    {"type": "Strip", "content": " ", "start": 1, "stop": 0}]}
BOS = {"SpecialToken": {"id": "<s>", "type_id": 0}}
TEMPLATE = {"type": "TemplateProcessing", "single": [BOS, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [BOS, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}}}


def build_spec(form: str, seed: int = 0, vocab: int = 600) -> dict:
    """A Llama-family tokenizer.json trained by ``tokenizers`` on a seeded
    corpus, rewritten to the Llama layout (specials, byte tokens, the rest)."""
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, trainers

    rng = random.Random(seed)
    words = ["".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randint(1, 8)))
             for _ in range(200)]
    corpus = [" ".join(rng.choice(words) for _ in range(rng.randint(3, 20))) for _ in range(300)]
    corpus += ["Hello, World! 123 über café ñandú",
               "In: What action should the robot take to pick?\nOut:"]
    tok = Tokenizer(models.BPE(unk_token="<unk>", byte_fallback=True, fuse_unk=True))
    if form == "legacy":
        tok.normalizer = normalizers.Sequence([normalizers.Prepend(SPACE),
                                               normalizers.Replace(" ", SPACE)])
    else:
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement=SPACE, prepend_scheme="first",
                                                     split=False)
    tok.train_from_iterator(corpus, trainer=trainers.BpeTrainer(
        vocab_size=vocab, special_tokens=["<unk>", "<s>", "</s>"], show_progress=False))
    spec = json.loads(tok.to_str())
    new = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        new[f"<0x{b:02X}>"] = len(new)
    for t, _ in sorted(spec["model"]["vocab"].items(), key=lambda kv: kv[1]):
        new.setdefault(t, len(new))
    spec["model"]["vocab"] = new
    spec["added_tokens"] = [
        dict(id=i, content=c, single_word=False, lstrip=False, rstrip=False, normalized=False,
             special=True) for i, c in enumerate(("<unk>", "<s>", "</s>"))]
    spec["added_tokens"].append(dict(id=len(new), content="<PAD>", single_word=False,
                                     lstrip=False, rstrip=False, normalized=False, special=True))
    spec["post_processor"] = TEMPLATE
    spec["decoder"] = DECODER
    return spec


@pytest.fixture(scope="module", params=["legacy", "metaspace"])
def pair(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"tok_{request.param}")
    (d / "tokenizer.json").write_text(json.dumps(build_spec(request.param)))
    return jax_load_tokenizer(d), ttok.load_tokenizer(d)


texts = st.one_of(st.lists(st.sampled_from(FRAGMENTS), max_size=24).map("".join),
                  st.text(max_size=40))


@settings(max_examples=150, deadline=None)
@given(text=texts)
def test_encode_and_decode_equal_jax(pair, text):
    jtok, ttok_ = pair
    ids = jtok.encode(text)
    assert ttok_.encode(text) == ids
    assert ttok_(text) == jtok(text)
    for skip in (False, True):
        assert ttok_.decode(ids, skip_special_tokens=skip) == jtok.decode(
            ids, skip_special_tokens=skip)


@settings(max_examples=150, deadline=None)
@given(ids=st.lists(st.integers(0, 900), max_size=16))
def test_decode_of_any_ids_equals_jax(pair, ids):
    """Byte tokens in any order (invalid UTF-8 decodes to one U+FFFD a byte),
    special tokens, ids past the vocabulary (skipped)."""
    jtok, ttok_ = pair
    for skip in (False, True):
        assert ttok_.decode(ids, skip_special_tokens=skip) == jtok.decode(
            ids, skip_special_tokens=skip)


def test_vocab_size_and_bos(pair):
    jtok, ttok_ = pair
    # len(get_vocab()) with the added tokens: <PAD> is the last id
    assert ttok_.vocab_size == jtok.vocab_size == ttok_.hf.token_to_id("<PAD>") + 1
    assert ttok_.bos_token_id == jtok.bos_token_id == 1
    assert ttok_.encode("") == jtok.encode("") == [1]


def test_prepend_differs_between_the_forms(tmp_path):
    """The older normalizer prepends "▁" to every piece between added tokens;
    Metaspace's "first" scheme only to the piece that starts the text."""
    tokens = {}
    for form in ("legacy", "metaspace"):
        d = tmp_path / form
        d.mkdir()
        (d / "tokenizer.json").write_text(json.dumps(build_spec(form)))
        t = ttok.load_tokenizer(d)
        ids = t.encode("ab<s>ab")
        assert ids == jax_load_tokenizer(d).encode("ab<s>ab")
        tokens[form] = [t.hf.id_to_token(i) for i in ids]
    assert tokens["legacy"] == ["<s>", SPACE + "a", "b", "<s>", SPACE + "a", "b"]
    assert tokens["metaspace"] == ["<s>", SPACE + "a", "b", "<s>", "a", "b"]


def test_the_seeded_llama_file_equals_tokenizers(tmp_path):
    """The 32000-entry file chip_smoke.py writes: <PAD> = 32000, vocab_size
    32001, OpenVLA's prompt and generated text equal to tokenizers'."""
    write_llama_tokenizer(tmp_path, seed=0)
    jtok, ttok_ = jax_load_tokenizer(tmp_path), ttok.load_tokenizer(tmp_path)
    assert ttok_.vocab_size == jtok.vocab_size == 32001
    assert ttok_.hf.token_to_id("<PAD>") == 32000
    rng = random.Random(3)
    for i in range(60):
        text = (f"In: What action should the robot take to pick up object {i}?\nOut:"
                if i % 2 else "".join(rng.choice(FRAGMENTS) for _ in range(30)))
        ids = jtok.encode(text)
        assert ttok_.encode(text) == ids
        junk = [rng.randrange(32001) for _ in range(20)]
        for skip in (False, True):
            assert ttok_.decode(ids + junk, skip) == jtok.decode(ids + junk, skip)


def _edit(path, value):
    def fn(spec):
        node = spec
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return fn


@pytest.mark.parametrize("edit,names", [
    (_edit(["normalizer"], {"type": "NFKC"}), "NFKC"),
    (_edit(["pre_tokenizer"], {"type": "ByteLevel", "add_prefix_space": False}), "ByteLevel"),
    (_edit(["model", "type"], "WordPiece"), "WordPiece"),
    (_edit(["decoder"], {"type": "Metaspace", "replacement": SPACE}), "Metaspace"),
    (_edit(["post_processor"], {"type": "ByteLevel"}), "ByteLevel"),
    (_edit(["added_tokens", 3, "lstrip"], True), "lstrip"),
    (_edit(["model", "ignore_merges"], True), "ignore_merges"),
    (lambda spec: spec.update(normalizer=None, pre_tokenizer={
        "type": "Metaspace", "replacement": SPACE, "prepend_scheme": "always", "split": False}),
     "prepend_scheme"),
])
def test_unsupported_components_raise(tmp_path, edit, names):
    spec = copy.deepcopy(build_spec("legacy", vocab=300))
    edit(spec)
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec))
    with pytest.raises(ttok.UnsupportedTokenizer, match=names):
        ttok.load_tokenizer(tmp_path)


def test_a_sentencepiece_model_alone_raises(tmp_path):
    (tmp_path / "tokenizer.model").write_bytes(b"\x00")
    with pytest.raises(ttok.UnsupportedTokenizer, match="tokenizer.model"):
        ttok.load_tokenizer(tmp_path)
    with pytest.raises(FileNotFoundError):
        ttok.load_tokenizer(tmp_path / "missing")
