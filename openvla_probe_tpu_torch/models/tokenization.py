"""Host-side tokenizer: the port's own reader of a Llama-family ``tokenizer.json``
(counterpart of ``openvla_probe_tpu/models/tokenization.py``).

The JAX package hands the file to the ``tokenizers`` package (or, failing
that, to ``transformers``); the card's machine has neither, so this module
reads the file itself, in pure Python, and computes what ``tokenizers``
computes for the components a Llama (SentencePiece-BPE) file carries:

  * added tokens (``<unk>``, ``<s>``, ``</s>``, OpenVLA's ``<PAD>``) split off
    the raw text first, leftmost-longest, as ``tokenizers``' added
    vocabulary does (the ``normalized`` ones matched in the normalized text);
  * the normalizer in either form Llama files carry: the older Sequence of
    Prepend "▁" and Replace " " -> "▁" (no pre-tokenizer: Prepend applies to
    every piece between added tokens), or none, with the newer ``Metaspace``
    pre-tokenizer (``split: false``, ``prepend_scheme: "first"``: "▁" only
    before the piece that starts the text);
  * BPE by merge rank over one heap of (rank, position), with
    ``byte_fallback`` (a character outside the vocabulary becomes its UTF-8
    bytes' ``<0xXX>`` tokens before any merge) and ``fuse_unk``;
  * the TemplateProcessing post-processor's BOS;
  * the Replace / ByteFallback / Fuse / Strip decoder (ByteFallback emits one
    U+FFFD per byte of invalid UTF-8) and ``skip_special_tokens``.

Any other component type raises `UnsupportedTokenizer` naming it, and so
does a checkpoint with only ``tokenizer.model`` (the JAX package falls back
to ``transformers`` there: ROADMAP's standing divergences).

`HostTokenizer` keeps the JAX contract line for line: ``encode`` always
starts with BOS (the reference's base_llm.py:175-180), ``decode(ids,
skip_special_tokens)``, ``vocab_size`` = ``len(get_vocab())`` with the added
tokens (a raw ``tokenizers.Tokenizer`` has no ``vocab_size`` attribute), and
``__call__``.
"""

from __future__ import annotations

import heapq
import json
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

SPACE = "▁"


class UnsupportedTokenizer(ValueError):
    """A tokenizer file with a component this reader does not implement."""


def _unsupported(what: str, spec: Any) -> UnsupportedTokenizer:
    kind = spec.get("type") if isinstance(spec, dict) else spec
    return UnsupportedTokenizer(
        f"tokenizer.json: {what} {kind!r} is not supported by the port's reader (it reads "
        "Llama-family files: added tokens, the Prepend/Replace normalizer or a Metaspace "
        "pre-tokenizer, BPE with byte_fallback, a TemplateProcessing post-processor and the "
        "Replace/ByteFallback/Fuse/Strip decoder)")


def _replace_pattern(spec: dict) -> str:
    pat = spec.get("pattern", {})
    if set(pat) != {"String"}:
        raise _unsupported("Replace pattern", {"type": json.dumps(pat)})
    return pat["String"]


class _Normalizer:
    """Prepend / Replace steps, applied in order to one piece of text."""

    def __init__(self, spec: Optional[dict]) -> None:
        self.steps: List[Tuple[str, str, str]] = []
        if spec is None:
            return
        parts = spec["normalizers"] if spec.get("type") == "Sequence" else [spec]
        for p in parts:
            if p.get("type") == "Prepend":
                self.steps.append(("prepend", p["prepend"], ""))
            elif p.get("type") == "Replace":
                self.steps.append(("replace", _replace_pattern(p), p["content"]))
            else:
                raise _unsupported("normalizer", p)

    def __bool__(self) -> bool:
        return bool(self.steps)

    def __call__(self, text: str) -> str:
        for kind, a, b in self.steps:
            if kind == "prepend":
                if text:
                    text = a + text
            elif a:
                text = text.replace(a, b)
        return text


class _Metaspace:
    """The pre-tokenizer with ``prepend_scheme: "first"`` and ``split: false``:
    spaces become the replacement, which is prepended to the piece that
    starts the text unless it starts with one already."""

    def __init__(self, spec: dict) -> None:
        for key, want in (("split", False), ("prepend_scheme", "first")):
            if spec.get(key) != want:
                raise _unsupported(f"Metaspace {key}", {"type": str(spec.get(key))})
        self.rep = spec.get("replacement", SPACE)

    def __call__(self, text: str, start: int) -> str:
        text = text.replace(" ", self.rep)
        if start == 0 and not text.startswith(self.rep):
            text = self.rep + text
        return text


def _splitter(patterns: List[str]):
    """A leftmost-longest matcher over `patterns` (None when there are none)."""
    if not patterns:
        return None
    alts = sorted(set(patterns), key=len, reverse=True)
    return re.compile("|".join(re.escape(p) for p in alts))


def _split_on(text: str, matcher, ids: Dict[str, int]) -> List[Tuple[str, Optional[int], int]]:
    """`text` cut at every match of `matcher`: (piece, added token id or None,
    offset of the piece in `text`); empty pieces dropped."""
    if matcher is None:
        return [(text, None, 0)] if text else []
    out, at = [], 0
    for m in matcher.finditer(text):
        if m.start() > at:
            out.append((text[at:m.start()], None, at))
        out.append((m.group(), ids[m.group()], m.start()))
        at = m.end()
    if at < len(text):
        out.append((text[at:], None, at))
    return out


def _byte_token(b: int) -> str:
    return f"<0x{b:02X}>"


class _BPE:
    def __init__(self, spec: dict) -> None:
        if spec.get("type", "BPE") != "BPE":
            raise _unsupported("model", spec)
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if spec.get(key):
                raise _unsupported(f"BPE {key}", {"type": spec[key]})
        for key in ("dropout", "ignore_merges"):
            if spec.get(key):
                raise _unsupported(f"BPE {key}", {"type": str(spec[key])})
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        # (left id, right id) -> (rank, merged id)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            try:
                self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])
            except KeyError as e:
                raise ValueError(f"tokenizer.json: merge {a!r} {b!r} names {e} outside the "
                                 "vocabulary") from None

    def _unk_id(self) -> int:
        if self.unk not in self.vocab:
            raise ValueError(f"tokenizer.json: the unk token {self.unk!r} is not in the vocabulary")
        return self.vocab[self.unk]

    def _symbols(self, word: str) -> List[List[int]]:
        """The word's initial symbols [id, byte length] (tokenizers' merge_word)."""
        syms: List[List[int]] = []
        unk: Optional[List[int]] = None
        for ch in word:
            n = len(ch.encode("utf-8"))
            tid = self.vocab.get(ch)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append([tid, n])
                continue
            if self.byte_fallback:
                ids = [self.vocab.get(_byte_token(b)) for b in ch.encode("utf-8")]
                if all(i is not None for i in ids):
                    syms.extend([i, 1] for i in ids)
                    continue
            if self.unk is None:
                continue
            if unk is not None and self.fuse_unk:
                unk = [unk[0], unk[1] + n]
            else:
                if unk is not None:
                    syms.append(unk)
                unk = [self._unk_id(), n]
        if unk is not None:
            syms.append(unk)
        return syms

    def tokenize(self, word: str) -> List[int]:
        syms = self._symbols(word)
        n = len(syms)
        ids = [s[0] for s in syms]
        alive = [True] * n
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        nxt[-1:] = [-1] if n else []
        merges = self.merges
        heap = []
        for i in range(n - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        # tokenizers' Word::merge_all: the lowest rank first, then the leftmost
        # position; an entry whose pair no longer gives its merged id is stale
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] == -1:
                continue
            right = nxt[pos]
            m = merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[right] != -1:
                prev[nxt[right]] = pos
            if prev[pos] >= 0:
                m = merges.get((ids[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] != -1:
                m = merges.get((new_id, ids[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [ids[i] for i in range(n) if alive[i]]


def _parse_hex_byte(s: str) -> Optional[int]:
    """Rust's u8::from_str_radix(s, 16) on two characters."""
    digits = s[1:] if s.startswith("+") else s
    if not digits or any(c not in "0123456789abcdefABCDEF" for c in digits):
        return None
    return int(digits, 16)


def _byte_fallback_decode(tokens: List[str]) -> List[str]:
    out: List[str] = []
    pending: List[int] = []

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in tokens:
        raw = t.encode("utf-8")
        b = None
        if len(raw) == 6 and raw.startswith(b"<0x") and raw.endswith(b">"):
            try:
                b = _parse_hex_byte(raw[3:5].decode("utf-8"))
            except UnicodeDecodeError:
                b = None
        if b is not None:
            pending.append(b)
        else:
            flush()
            out.append(t)
    flush()
    return out


def _strip(tokens: List[str], content: str, start: int, stop: int) -> List[str]:
    out = []
    for t in tokens:
        a = 0
        for i, c in enumerate(t[:start]):
            if c != content:
                break
            a = i + 1
        b = len(t)
        for i in range(stop):
            j = len(t) - i - 1
            if j < 0 or t[j] != content:
                break
            b = j
        out.append(t[a:b])
    return out


class _Decoder:
    def __init__(self, spec: Optional[dict]) -> None:
        self.steps: List[Tuple[str, Any]] = []
        if spec is None:
            return
        parts = spec["decoders"] if spec.get("type") == "Sequence" else [spec]
        for p in parts:
            kind = p.get("type")
            if kind == "Replace":
                self.steps.append(("replace", (_replace_pattern(p), p["content"])))
            elif kind in ("ByteFallback", "Fuse"):
                self.steps.append((kind, None))
            elif kind == "Strip":
                self.steps.append(("strip", (p["content"], int(p["start"]), int(p["stop"]))))
            else:
                raise _unsupported("decoder", p)

    def __call__(self, tokens: List[str]) -> str:
        if not self.steps:
            return " ".join(tokens)
        for kind, arg in self.steps:
            if kind == "replace":
                tokens = [t.replace(*arg) for t in tokens]
            elif kind == "ByteFallback":
                tokens = _byte_fallback_decode(tokens)
            elif kind == "Fuse":
                tokens = ["".join(tokens)]
            else:
                tokens = _strip(tokens, *arg)
        return "".join(tokens)


class TokenizerFile:
    """A ``tokenizer.json`` read into the functions ``tokenizers`` computes
    for it: `encode` (ids with the post-processor's special tokens),
    `decode`, `get_vocab` (with the added tokens) and `token_to_id`."""

    def __init__(self, spec: Dict[str, Any]) -> None:
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, {"type": "set"})
        self.model = _BPE(spec["model"])
        self.normalizer = _Normalizer(spec.get("normalizer"))
        pre = spec.get("pre_tokenizer")
        if pre is not None and pre.get("type") != "Metaspace":
            raise _unsupported("pre-tokenizer", pre)
        if pre is not None and self.normalizer:
            raise _unsupported("normalizer together with a pre-tokenizer",
                               {"type": spec["normalizer"].get("type")})
        self.pre = _Metaspace(pre) if pre is not None else None
        self.decoder = _Decoder(spec.get("decoder"))

        self.added: Dict[str, int] = {}
        self.added_by_id: Dict[int, str] = {}
        self.special: set = set()
        raw, normed = [], []
        for t in spec.get("added_tokens", []):
            for opt in ("single_word", "lstrip", "rstrip"):
                if t.get(opt):
                    raise _unsupported(f"added token option {opt} on", {"type": t["content"]})
            self.added[t["content"]] = t["id"]
            self.added_by_id[t["id"]] = t["content"]
            if t.get("special"):
                self.special.add(t["content"])
            (normed if t.get("normalized", not t.get("special")) else raw).append(t["content"])
        self._raw = _splitter(raw)
        # tokenizers matches a normalized added token by its normalized content
        self._normed_ids = {self.normalizer(c): self.added[c] for c in normed}
        self._normed = _splitter(list(self._normed_ids))

        self.template: List[Tuple[str, Any]] = []
        post = spec.get("post_processor")
        if post is not None:
            if post.get("type") != "TemplateProcessing":
                raise _unsupported("post-processor", post)
            specials = post.get("special_tokens", {})
            for item in post["single"]:
                if "SpecialToken" in item:
                    self.template.append(("ids", list(specials[item["SpecialToken"]["id"]]["ids"])))
                elif item.get("Sequence", {}).get("id") == "A":
                    self.template.append(("A", None))
                else:
                    raise _unsupported("template item", {"type": json.dumps(item)})

    def _pieces(self, text: str) -> List[Union[int, str]]:
        """The text cut into added-token ids and normalized, pre-tokenized
        words (tokenizers' extract_and_normalize, then the pre-tokenizer)."""
        out: List[Union[int, str]] = []
        for piece, tid, start in _split_on(text, self._raw, self.added):
            if tid is not None:
                out.append(tid)
                continue
            norm = self.normalizer(piece)
            for sub, sid, off in _split_on(norm, self._normed, self._normed_ids):
                if sid is not None:
                    out.append(sid)
                elif self.pre is not None:
                    # without a normalizer the normalized text is the raw text
                    out.append(self.pre(sub, start + off))
                else:
                    out.append(sub)
        return out

    def encode(self, text: str) -> List[int]:
        """The ids with the post-processor's special tokens."""
        ids: List[int] = []
        for p in self._pieces(text):
            if isinstance(p, int):
                ids.append(p)
            elif p:
                ids.extend(self.model.tokenize(p))
        if not self.template:
            return ids
        out: List[int] = []
        for kind, arg in self.template:
            out.extend(ids if kind == "A" else arg)
        return out

    def id_to_token(self, i: int) -> Optional[str]:
        return self.added_by_id.get(i, self._inverse().get(i))

    def _inverse(self) -> Dict[int, str]:
        inv = getattr(self, "_inv", None)
        if inv is None:
            inv = self._inv = {v: k for k, v in self.model.vocab.items()}
        return inv

    def token_to_id(self, token: str) -> Optional[int]:
        return self.added.get(token, self.model.vocab.get(token))

    def get_vocab(self) -> Dict[str, int]:
        return {**self.model.vocab, **self.added}

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            t = self.id_to_token(int(i))
            if t is None or (skip_special_tokens and t in self.special):
                continue
            tokens.append(t)
        return self.decoder(tokens)


class HostTokenizer:
    """Thin adapter over a tokenizer object (the JAX package's contract)."""

    def __init__(self, hf_tokenizer, bos_token_id: int = 1) -> None:
        self.hf = hf_tokenizer
        self.bos_token_id = bos_token_id
        vocab = getattr(hf_tokenizer, "vocab_size", None)
        self.vocab_size = int(vocab) if vocab else len(hf_tokenizer.get_vocab())

    def encode(self, text: str) -> List[int]:
        ids = self.hf.encode(text)
        if hasattr(ids, "ids"):  # an object returning an Encoding
            ids = ids.ids
        if not ids or ids[0] != self.bos_token_id:
            ids = [self.bos_token_id] + list(ids)
        return list(ids)

    def decode(self, ids: List[int], skip_special_tokens: bool = False) -> str:
        return self.hf.decode(list(ids), skip_special_tokens=skip_special_tokens)

    def __call__(self, text: str):
        return self.encode(text)


def load_tokenizer(path: Union[str, Path]) -> HostTokenizer:
    """Read `path`/tokenizer.json (a checkpoint directory) or a tokenizer.json
    file; raise naming what is missing or unsupported."""
    path = Path(path)
    file = path if path.is_file() else path / "tokenizer.json"
    if not file.is_file():
        if (path / "tokenizer.model").exists():
            raise UnsupportedTokenizer(
                f"{path} holds only tokenizer.model (a SentencePiece model); the port reads "
                "tokenizer.json files only")
        raise FileNotFoundError(f"no tokenizer.json under {path}")
    tok = TokenizerFile(json.loads(file.read_text(encoding="utf-8")))
    bos = tok.token_to_id("<s>")
    return HostTokenizer(tok, bos_token_id=bos if bos is not None else 1)
