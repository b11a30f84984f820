"""CLIP byte-level BPE tokenizer (pure Python, standalone).

The reference calls ``open_clip.tokenize`` (condition.py:211). open_clip is
not a dependency here; this is a from-scratch implementation of the public
CLIP BPE scheme (lowercase + whitespace cleanup, byte-to-unicode mapping,
merge ranks, ``<start_of_text>``/``<end_of_text>``, pad-to-77). It needs the
standard ``bpe_simple_vocab_16e6.txt.gz`` merges file, supplied by the user
next to the model checkpoint (same asset class — this environment and many
deployments have no network egress).

For development without assets, :class:`HashTokenizer` provides a
deterministic stand-in (NOT CLIP-compatible; embeddings will differ).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import zlib
from typing import List, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> unicode mapping (standard byte-level BPE table)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """CLIP-compatible tokenization given the standard merges file."""

    PAT = re.compile(
        # CLIP's pattern uses the `regex` module's \p{L} / \p{N} classes, which
        # stdlib re lacks: letters are [^\W\d_], digits \d
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
        re.IGNORECASE | re.UNICODE,
    )

    def __init__(self, bpe_path: str):
        if not os.path.exists(bpe_path):
            raise FileNotFoundError(
                f"CLIP BPE merges file not found: {bpe_path}. Supply the standard "
                "bpe_simple_vocab_16e6.txt.gz next to the model checkpoint."
            )
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)

        def get_pairs(word):
            return set(zip(word[:-1], word[1:]))

        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
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
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode_text(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in re.findall(self.PAT, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return tokens

    def __call__(self, texts: Union[str, Sequence[str]], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize to a padded int32 array [B, context_length] with
        SOT/EOT, truncating overlong prompts (EOT kept), like
        ``open_clip.tokenize``."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode_text(text) + [self.eot]
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in tokenizer for development/testing without the
    BPE asset. NOT CLIP-compatible — converted CLIP weights will not produce
    meaningful text embeddings with it.

    Words map to ids by CRC-32, so a prompt gives the same ids in every
    process. (The JAX package's twin uses Python's ``hash``, which string
    hash randomisation changes from process to process.)"""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts: Union[str, Sequence[str]], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            words = _whitespace_clean(_basic_clean(text)).lower().split(" ")
            ids = [self.sot] + [
                zlib.crc32(w.encode("utf-8")) % (self.vocab_size - 2) for w in words if w
            ][: context_length - 2] + [self.eot]
            out[i, : len(ids)] = ids
        return out


def load_tokenizer(bpe_path: str = None, allow_fallback: bool = False):
    """Load the real CLIP BPE tokenizer.

    Hard-fails when the asset is missing: real converted weights with the
    HashTokenizer silently produce garbage text embeddings. Random-weight
    development runs construct a HashTokenizer explicitly, or pass
    ``allow_fallback=True``.
    """
    if bpe_path and os.path.exists(bpe_path):
        return CLIPBPETokenizer(bpe_path)
    if allow_fallback:
        return HashTokenizer()
    raise FileNotFoundError(
        "CLIP BPE vocabulary not found"
        + (f" at {bpe_path!r}" if bpe_path else " (no --bpe_path given)")
        + ". Real checkpoints require the open_clip "
        "bpe_simple_vocab_16e6.txt.gz asset — pass its path via --bpe_path. "
        "(The HashTokenizer fallback is only valid for --dev_tiny / "
        "--dev_full_random runs, which never reach this loader.)"
    )
