"""CLIP byte-pair-encoding tokenizer (the `tokenize` used by ADV.py:105); the
port's own copy of nl_vsgg_tpu/pipelines/tokenizer.py.

Standard CLIP BPE: byte->unicode table, lowercased whitespace-normalized
words split by the CLIP regex, merges applied from a bpe vocabulary file
(openai CLIP's bpe_simple_vocab_16e6.txt.gz, supplied by the user at
runtime), '</w>' end-of-word markers, <|startoftext|>/<|endoftext|> framing,
padded/truncated to the 77-token context.
"""

from __future__ import annotations

import gzip
import html
import re
from functools import lru_cache

import numpy as np

CONTEXT = 77


@lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


# CLIP's pre-tokenizer uses the `regex` module's \p{L}/\p{N}; Python re
# equivalents: [^\W\d_] = unicode letter, \d = unicode decimal digit, and
# the punctuation bucket is "not whitespace, not letter, not digit"
# ((?:[^\s\w]|_)+ — \w minus letters/digits is exactly the underscore).
# ASCII behavior is identical; non-ASCII letters (café, naïve) now stay in
# the word bucket like the real CLIP/DAC tokenizer instead of falling into
# punctuation. (\p{N} also covers Nl/No number forms \d does not — absent
# from Charades captions.)
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE)


class SimpleTokenizer:
    def __init__(self, bpe_path: str | None = None,
                 merges: list[tuple[str, str]] | None = None):
        self.byte_encoder = bytes_to_unicode()
        if merges is None:
            assert bpe_path, "need a bpe vocab file or explicit merges"
            opener = gzip.open if bpe_path.endswith(".gz") else open
            with opener(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")[1:49152 - 256 - 2 + 1]
            merges = [tuple(m.split()) for m in lines if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
        out: list[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in _PAT.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return out

    def tokenize(self, texts: str | list[str],
                 context_length: int = CONTEXT) -> np.ndarray:
        """-> (len(texts), context_length) int32, CLIP framing + truncation."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot] + self.encode(text) + [self.eot]
            if len(tokens) > context_length:  # CLIP truncates keeping EOT
                tokens = tokens[:context_length - 1] + [self.eot]
            result[i, :len(tokens)] = tokens
        return result
