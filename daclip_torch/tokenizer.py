"""CLIP byte-BPE tokenizer, host-side Python with the standard library only.

Counterpart of `daclip_tpu/tokenizer.py` (open_clip/tokenizer.py:159-188:
vocab 49408, context 77, SOT/EOT, truncate keeping EOT last). The BPE merges
are read by path from the JAX package's vendored
`assets/bpe_simple_vocab_16e6.txt.gz`.

The JAX tokenizer splits text with the `regex` pattern
``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
under IGNORECASE. Stdlib `re` has no `\\p{..}`, and `[^\\W\\d_]` is another
set (it counts `²`, `½` and `Ⅳ` as letters), so `_pre_tokenize` scans the
text with `unicodedata.category` and takes, at each position, the first
alternative that matches, as the pattern does. Two details of `regex` are
kept: its `\\s` is the Unicode White_Space set (`_WHITESPACE`, without the
four separators U+001C-U+001F that `str.isspace` adds), and IGNORECASE
folds `ſ` (U+017F) to `s` in the literal alternatives. Letters and numbers
are those of the interpreter's Unicode tables; `regex` may ship newer ones,
so code points unassigned there can split differently.

ftfy is not used: text cleaning is the JAX package's fallback, exactly two
`html.unescape`s (identical for the ASCII captions of the DA-CLIP data).
"""
from __future__ import annotations

import functools
import gzip
import html
import pathlib
import re
import unicodedata
from typing import List, Union

import numpy as np

DEFAULT_BPE_PATH = str(pathlib.Path(__file__).resolve().parents[1] / "daclip_tpu"
                       / "assets" / "bpe_simple_vocab_16e6.txt.gz")
CONTEXT_LENGTH = 77

# `regex`'s \s: the Unicode White_Space property
_WHITESPACE = frozenset(map(chr, (0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0, 0x1680,
                                   *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                   0x205F, 0x3000)))
_WHITESPACE_RUN = re.compile("[" + re.escape("".join(sorted(_WHITESPACE))) + "]+")
# the pattern's literal alternatives, in its order
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte→unicode map avoiding whitespace/control chars (GPT-2/CLIP
    standard construction)."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _clean(text: str) -> str:
    """basic_clean (tokenizer.py:50-54) without ftfy: exactly two unescapes,
    then whitespace runs to one space."""
    text = html.unescape(html.unescape(text))
    return _WHITESPACE_RUN.sub(" ", text).strip()


def _kind(ch: str) -> str:
    if ch in _WHITESPACE:
        return " "
    cat = unicodedata.category(ch)
    return cat[0] if cat[0] in "LN" else "o"


def _literal_at(text: str, i: int, lit: str) -> bool:
    """`lit` at text[i:] under the pattern's IGNORECASE (`ſ` folds to `s`)."""
    chunk = text[i:i + len(lit)]
    return len(chunk) == len(lit) and chunk.lower().replace("ſ", "s") == lit


def _pre_tokenize(text: str) -> List[str]:
    """`regex.findall` of the JAX tokenizer's split pattern."""
    out, i, n = [], 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS if _literal_at(text, i, s)), None)
        if lit is not None:
            out.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        kind = _kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # letters and other symbols run; a number is one char
            while j < n and _kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class SimpleTokenizer:
    def __init__(self, bpe_path: str = DEFAULT_BPE_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.vocab_size = len(self.encoder)
        self.sot_token = self.encoder["<|startoftext|>"]
        self.eot_token = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
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
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in _pre_tokenize(_clean(text).lower()):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache(maxsize=1)
def _default_tokenizer() -> SimpleTokenizer:
    return SimpleTokenizer()


def tokenize(texts: Union[str, List[str]],
             context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """Tokenize into a (N, context_length) int32 array; pads with 0, truncates
    keeping EOT last (open_clip/tokenizer.py:159-188)."""
    if isinstance(texts, str):
        texts = [texts]
    tk = _default_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tk.sot_token] + tk.encode(text) + [tk.eot_token]
        if len(tokens) > context_length:
            tokens = tokens[:context_length]
            tokens[-1] = tk.eot_token
        result[i, : len(tokens)] = tokens
    return result


def get_tokenizer(model_name: str = ""):
    """open_clip.get_tokenizer (factory.py:78-85): every shipped config uses
    the simple byte-BPE tokenizer."""
    return tokenize
