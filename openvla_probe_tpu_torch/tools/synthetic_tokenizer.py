"""A Llama-2-layout ``tokenizer.json`` made from a seed, for runs without the
released files (``chip_smoke.py``'s CLI phase, the CPU tests).

The layout is the released Llama-2 / OpenVLA file's: ``<unk>``, ``<s>``,
``</s>``, the 256 byte tokens ``<0x00>``..``<0xFF>``, the single characters,
then one token a merge up to `vocab_size` entries (32000): first the words of
OpenVLA's prompt and of common instructions, letter by letter (so a prompt
takes about as many tokens as with the released file), then merges drawn at
random; plus OpenVLA's ``<PAD>`` = 32000 as an added special token; the
Prepend / Replace normalizer,
BPE with ``byte_fallback``, the BOS template and the Replace / ByteFallback /
Fuse / Strip decoder. Each merge joins two tokens already in the vocabulary,
so the file is a valid BPE, whose ids are not the released ones.

    python -m openvla_probe_tpu_torch.tools.synthetic_tokenizer OUT_DIR [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import random
import string
from pathlib import Path
from typing import Any, Dict

SPACE = "▁"
SPECIALS = ("<unk>", "<s>", "</s>")
WORDS = ("In What action should the robot take to Out pick up put place open close the a an "
         "on in of and it into from with red blue green black white yellow block cup bowl "
         "plate drawer door top bottom left right front back table bin object stove pot "
         "move push pull turn lift grasp describe what is scene image there this").split()


def llama_tokenizer_json(seed: int = 0, vocab_size: int = 32000) -> Dict[str, Any]:
    rng = random.Random(seed)
    vocab: Dict[str, int] = {t: i for i, t in enumerate(SPECIALS)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    chars = [SPACE] + [c for c in string.printable if not c.isspace()] + list("éèàüöäñç")
    for c in chars:
        vocab[c] = len(vocab)
    words = [SPACE] + chars          # merge candidates, grown as tokens are made
    merges = []
    for w in WORDS:
        for piece in (SPACE + w, w):
            for i in range(2, len(piece) + 1):
                if piece[:i] not in vocab:
                    vocab[piece[:i]] = len(vocab)
                    merges.append([piece[:i - 1], piece[i - 1]])
                    words.append(piece[:i])
    while len(vocab) < vocab_size:
        # a word-like left side (often a token that starts a word), a short right side
        a = rng.choice(words[-4000:]) if rng.random() < 0.7 else rng.choice(chars)
        if rng.random() < 0.3 and not a.startswith(SPACE):
            a = SPACE + a if SPACE + a in vocab else a
        b = rng.choice(string.ascii_lowercase) if rng.random() < 0.8 else rng.choice(words)
        new = a + b
        if new in vocab or len(new) > 16:
            continue
        vocab[new] = len(vocab)
        merges.append([a, b])
        words.append(new)
    added = [dict(id=i, content=t, single_word=False, lstrip=False, rstrip=False,
                  normalized=False, special=True)
             for i, t in enumerate(SPECIALS + ("<PAD>",))]
    added[-1]["id"] = len(vocab)
    bos = {"SpecialToken": {"id": "<s>", "type_id": 0}}
    return {
        "version": "1.0",
        "truncation": None,
        "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": SPACE},
            {"type": "Replace", "pattern": {"String": " "}, "content": SPACE}]},
        "pre_tokenizer": None,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}},
        },
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": SPACE}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def write_llama_tokenizer(out_dir, seed: int = 0, vocab_size: int = 32000) -> Path:
    """Write ``out_dir/tokenizer.json`` (`llama_tokenizer_json`); returns its path."""
    out = Path(out_dir) / "tokenizer.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(llama_tokenizer_json(seed, vocab_size), ensure_ascii=False))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(write_llama_tokenizer(args.out_dir, args.seed))
