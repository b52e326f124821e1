"""CLIP BPE tokenizer (the behaviour of openai/CLIP's SimpleTokenizer,
reference clip_vqgan.py:448-449 via clip.tokenize).  A copy of the JAX
package's maua_style_tpu/models/clip/tokenizer.py (numpy only), so that the
port imports nothing of that package: the same ids for the same text, on
either merge table and on the hash fallback.

Implements byte-level BPE with CLIP's exact conventions: byte<->unicode
table, lowercasing + whitespace cleanup, the word-boundary ``</w>`` marker,
``<|startoftext|>``/``<|endoftext|>`` specials, context length 77 with
truncation.  The merge table loads from either

- the original ``bpe_simple_vocab_16e6.txt(.gz)`` (ships inside the openai/CLIP
  repo at ``clip/bpe_simple_vocab_16e6.txt.gz``; also at
  https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz), or
- Hugging Face format: ``merges.txt`` (+ optional ``vocab.json`` used verbatim
  as the token->id table), as published in e.g. openai/clip-vit-base-patch32.

Both are searched in ``modelzoo/``.  Without any of them a deterministic hash
fallback keeps the pipeline runnable
(token ids are stable but NOT CLIP-meaningful); a one-time warning is printed,
mirroring the loud missing-checkpoint policy of the model loaders.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407

_VOCAB_CANDIDATES = (
    "modelzoo/bpe_simple_vocab_16e6.txt.gz",
    "modelzoo/bpe_simple_vocab_16e6.txt",
    "modelzoo/merges.txt",  # Hugging Face format (openai/clip-vit-base-patch32)
)
_HF_VOCAB_JSON = "modelzoo/vocab.json"
_N_MERGES = 49152 - 256 - 2  # 48894, the CLIP merge count

# CLIP's original pattern uses \p{L}/\p{N} (requires the regex module);
# the ASCII classes below are equivalent for the latin text CLIP was trained on
_PATTERN = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


_WARNED_NO_VOCAB = False


def _warn_no_vocab() -> None:
    """One-time loud fallback notice (the loaders' missing-checkpoint policy)."""
    global _WARNED_NO_VOCAB
    if not _WARNED_NO_VOCAB:
        _WARNED_NO_VOCAB = True
        print(
            "Warning: no CLIP BPE merge table found (searched "
            + ", ".join(_VOCAB_CANDIDATES)
            + "); token ids fall back to a deterministic hash and text guidance "
            "is NOT CLIP-meaningful. Fetch clip/bpe_simple_vocab_16e6.txt.gz "
            "from the openai/CLIP repo (or merges.txt+vocab.json from "
            "huggingface.co/openai/clip-vit-base-patch32) into modelzoo/."
        )


def basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def _read_merges(path: str) -> list[tuple[str, ...]]:
    """Read a BPE merge list: original 16e6 format or HF merges.txt.

    Both formats carry one header line (title / ``#version: ...``) followed by
    ``first second`` pairs; HF files hold exactly the final 48894 CLIP merges
    while the 16e6 file holds more (the original code truncates).  Blank
    trailing lines are dropped so either file round-trips.
    """
    if path.endswith(".gz"):
        lines = gzip.open(path).read().decode("utf-8").split("\n")
    else:
        lines = open(path, encoding="utf-8").read().split("\n")
    lines = lines[1 : _N_MERGES + 1]
    return [tuple(m.split()) for m in lines if m.strip()]


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None, vocab_json: str | None = None):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        path = bpe_path or next((p for p in _VOCAB_CANDIDATES if os.path.exists(p)), None)
        self.has_vocab = path is not None
        if path:
            merges = _read_merges(path)
            self.bpe_ranks = dict(zip(merges, range(len(merges))))
            json_path = vocab_json if vocab_json is not None else (_HF_VOCAB_JSON if os.path.exists(_HF_VOCAB_JSON) else None)
            if json_path:
                # HF vocab.json is the authoritative token->id table when present
                import json

                self.encoder = {str(k): int(v) for k, v in json.load(open(json_path, encoding="utf-8")).items()}
            else:
                vocab = list(self.byte_encoder.values())
                vocab = vocab + [v + "</w>" for v in vocab]
                for merge in merges:
                    vocab.append("".join(merge))
                vocab.extend(["<|startoftext|>", "<|endoftext|>"])
                self.encoder = dict(zip(vocab, range(len(vocab))))
        else:
            _warn_no_vocab()
            self.encoder = {}
            self.bpe_ranks = {}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda pair: self.bpe_ranks.get(pair, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        tokens: list[int] = []
        for token in re.findall(_PATTERN, text):
            token_bytes = token.encode("utf-8")
            token_trans = "".join(self.byte_encoder[b] for b in token_bytes)
            if self.has_vocab:
                tokens.extend(self.encoder[t] for t in self.bpe(token_trans).split(" "))
            else:
                # deterministic hash fallback: stable per word ACROSS PROCESSES
                # (python's hash() is salted), inside the non-special vocab range
                import hashlib

                digest = int.from_bytes(hashlib.sha1(token_trans.encode()).digest()[:4], "little")
                tokens.append((digest % (VOCAB_SIZE - 1000)) + 500)
        return tokens


_TOKENIZER: SimpleTokenizer | None = None


def tokenize(texts: str | list[str], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Texts -> (B, 77) int32 token array with SOT/EOT, truncated like CLIP."""
    global _TOKENIZER
    if _TOKENIZER is None:
        _TOKENIZER = SimpleTokenizer()
    if isinstance(texts, str):
        texts = [texts]
    result = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        tokens = [SOT] + _TOKENIZER.encode(text)[: context_length - 2] + [EOT]
        result[i, : len(tokens)] = tokens
    return result


__all__ = ["SimpleTokenizer", "tokenize", "CONTEXT_LENGTH", "VOCAB_SIZE"]
