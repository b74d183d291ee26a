"""CLIP's byte-level BPE tokenizer, read from a checkpoint's ``tokenizer/``.

What transformers' ``CLIPTokenizer`` does for
``tokenizer(prompt, max_length=77, padding="max_length", truncation=True)``
on a host without ``ftfy``, without ``transformers``, ``tokenizers`` or
``regex``:

1. the special tokens (BOS, EOS, UNK and the pad token, e.g. SD2.1's ``!``)
   are split out of the text first, longest match first, and map straight to
   their ids;
2. every other piece goes through the BERT-style clean-up transformers falls
   back to without ftfy (``BasicTokenizer(strip_accents=False,
   do_split_on_punc=False)``): control characters dropped, whitespace made
   spaces, spaces around CJK ideographs, NFC, lower case, split on
   whitespace;
3. CLIP's pre-tokeniser pattern
   ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
   (case-insensitive), written for ``re``: a letter is a word character that
   is neither a digit, ``_`` nor a numeric character, and the numeric class is
   every character whose Unicode category is N (Nd, Nl, No), listed from
   ``unicodedata``;
4. each piece's UTF-8 bytes mapped to printable characters, then BPE by merge
   rank with ``</w>`` closing a word;
5. BOS + the first ``max_length - 2`` ids + EOS, padded with the pad id.

The merges file's first line is a version header, and at most 48,894 merges
are read, as transformers reads them.
"""

from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata

MAX_MERGES = 49152 - 256 - 2


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> dict:
    """Byte -> printable character (CLIP's and GPT-2's reversible table)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@functools.lru_cache(maxsize=None)
def _numeric_class() -> str:
    """A ``re`` character class of every code point in Unicode category N."""
    ranges, start, prev = [], None, None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp))[0] == "N":
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    return "[" + "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                         for a, b in ranges) + "]"


@functools.lru_cache(maxsize=None)
def _pattern() -> re.Pattern:
    num = _numeric_class()
    letters = rf"(?:(?!{num})[^\W\d_])+"
    return re.compile(
        rf"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|{letters}|{num}|(?:(?!{num})[^\s\w]|_)+",
        re.IGNORECASE,
    )


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_clean(text: str) -> list[str]:
    """transformers' BasicTokenizer(strip_accents=False, do_split_on_punc=False)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(t.lower() for t in text.split()).split()


def _token_content(entry):
    """A special token from tokenizer_config.json / special_tokens_map.json:
    a string or an AddedToken dict."""
    if isinstance(entry, dict):
        return entry.get("content")
    return entry


class CLIPTokenizer:
    """``CLIPTokenizer(vocab, merges, ...)``; ``from_pretrained(<dir>)`` reads
    ``vocab.json``, ``merges.txt`` and, where present,
    ``special_tokens_map.json`` and ``tokenizer_config.json``."""

    def __init__(self, vocab: dict, merges: list, *, bos_token="<|startoftext|>", eos_token="<|endoftext|>",
                 unk_token="<|endoftext|>", pad_token="<|endoftext|>", model_max_length: int = 77):
        self.encoder = dict(vocab)
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges[:MAX_MERGES])}
        self.byte_encoder = bytes_to_unicode()
        self.model_max_length = int(model_max_length)
        self.bos_token, self.eos_token, self.unk_token, self.pad_token = bos_token, eos_token, unk_token, pad_token
        # special tokens map to ids directly; one missing from the vocab takes the next free id,
        # as transformers adds it
        self.special = {}
        next_id = len(self.encoder)
        for tok in (bos_token, eos_token, unk_token, pad_token):
            if tok in self.special:
                continue
            if tok in self.encoder:
                self.special[tok] = self.encoder[tok]
            else:
                self.special[tok] = next_id
                next_id += 1
        alternatives = sorted(self.special, key=len, reverse=True)
        self._split = re.compile("(" + "|".join(re.escape(t) for t in alternatives) + ")")
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    @classmethod
    def from_pretrained(cls, path: str) -> "CLIPTokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            merges = [tuple(m.split()) for m in f.read().strip().split("\n")[1:]]
        kwargs = {}
        for name in ("tokenizer_config.json", "special_tokens_map.json"):  # the second takes precedence
            p = os.path.join(path, name)
            if os.path.exists(p):
                with open(p, encoding="utf-8") as f:
                    conf = json.load(f)
                for key in ("bos_token", "eos_token", "unk_token", "pad_token"):
                    if conf.get(key) is not None:
                        kwargs[key] = _token_content(conf[key])
                if name == "tokenizer_config.json" and conf.get("model_max_length"):
                    kwargs["model_max_length"] = conf["model_max_length"]
        return cls(vocab, merges, **kwargs)

    @property
    def bos_token_id(self) -> int:
        return self.special[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.special[self.eos_token]

    @property
    def pad_token_id(self) -> int:
        return self.special[self.pad_token]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = set(zip(word, word[1:]))
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
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
            pairs = set(zip(word, word[1:]))
        out = " ".join(word)
        self.cache[token] = out
        return out

    def tokenize(self, text: str) -> list[str]:
        tokens = []
        for piece in self._split.split(text):
            if not piece:
                continue
            if piece in self.special:
                tokens.append(piece)
                continue
            for tok in _pattern().findall(" ".join(basic_clean(piece))):
                tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                tokens.extend(self.bpe(tok).split(" "))
        return tokens

    def _id(self, token: str) -> int:
        if token in self.special:
            return self.special[token]
        return self.encoder.get(token, self.special[self.unk_token])

    def encode(self, text: str, max_length: int | None = None) -> list[int]:
        """BOS + ids (truncated to max_length - 2) + EOS, padded to max_length."""
        n = self.model_max_length if max_length is None else int(max_length)
        ids = [self._id(t) for t in self.tokenize(text)][: n - 2]
        ids = [self.bos_token_id] + ids + [self.eos_token_id]
        return ids + [self.pad_token_id] * (n - len(ids))

    def __call__(self, prompts, max_length: int | None = None):
        """A prompt or a list of them -> int64 tensor (B, max_length)."""
        import torch

        if isinstance(prompts, str):
            prompts = [prompts]
        return torch.tensor([self.encode(p, max_length) for p in prompts], dtype=torch.int64)
