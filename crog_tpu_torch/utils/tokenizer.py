"""CLIP byte-level BPE tokenizer.

Re-implementation of the standard CLIP SimpleTokenizer behavior (reference:
utils/simple_tokenizer.py:62-132) against the public OpenAI CLIP vocabulary
(49,408 merges file, vendored in crog_tpu_torch/assets).  Runs purely on the host in
the input pipeline; output token ids feed the text encoder.

Differences from the reference implementation, none behavior-visible for the
OCID-VLG corpus:
  * ftfy text fixing is applied only when ftfy is importable (it is pure
    mojibake repair; the OCID-VLG referring expressions are plain ASCII).
  * the merge loop is the canonical greedy lowest-rank-pair algorithm —
    byte-level BPE has essentially one correct implementation and bitwise
    token parity with CLIP is a hard requirement (golden-token tests).
"""

from __future__ import annotations

import gzip
import html
import os
from functools import lru_cache
from typing import List, Union

import numpy as np
import regex as re

try:  # optional; plain ASCII corpora do not need it
    import ftfy

    _HAS_FTFY = True
except Exception:  # pragma: no cover
    _HAS_FTFY = False

_VOCAB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets",
    "bpe_simple_vocab_16e6.txt.gz",
)


@lru_cache()
def bytes_to_unicode():
    """Map every byte to a printable unicode char (GPT-2 scheme).

    Printable bytes map to themselves; the rest get 256+ codepoints so the
    BPE vocab contains no whitespace/control characters.
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """Byte-level BPE with the CLIP merge table and <|startoftext|>/<|endoftext|>."""

    def __init__(self, bpe_path: str = _VOCAB_PATH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        # CLIP uses merge lines [1, 49152-256-2+1)
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

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
                if i < len(word) - 1 and word[i + 1] == second:
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
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


_tokenizer: ClipTokenizer | None = None


def get_tokenizer() -> ClipTokenizer:
    global _tokenizer
    if _tokenizer is None:
        _tokenizer = ClipTokenizer()
    return _tokenizer


def tokenize(
    texts: Union[str, List[str]],
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    """SOT + BPE + EOT, zero-padded/truncated to ``context_length``.

    Matches reference ``tokenize`` (utils/dataset.py:57-98); returns an int32
    ndarray of shape [len(texts), context_length].
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    all_tokens = [
        [tok.sot_token] + tok.encode(text) + [tok.eot_token] for text in texts
    ]
    result = np.zeros((len(all_tokens), context_length), dtype=np.int32)
    for i, tokens in enumerate(all_tokens):
        if len(tokens) > context_length:
            if truncate:
                tokens = tokens[:context_length]
                tokens[-1] = tok.eot_token
            else:
                raise RuntimeError(
                    f"Input {texts[i]} is too long for context length "
                    f"{context_length}"
                )
        result[i, : len(tokens)] = tokens
    return result
