"""T5's Unigram tokenizer, read from a checkpoint's ``tokenizer_2/tokenizer.json``.

What ``tokenizers`` (and transformers' ``T5TokenizerFast``, which wraps it)
computes for ``tokenizer(prompt, max_length=512, padding="max_length",
truncation=True)``, without ``tokenizers``, ``transformers`` or
``sentencepiece``:

1. the added tokens (``<pad>``, ``</s>``, ``<unk>``, ``<extra_id_N>``) are
   split out of the raw text, leftmost-longest, and map straight to their ids;
2. each other piece goes through the normalizer: ``Precompiled`` (the
   sentencepiece charsmap: a darts-clone double-array trie and a blob of
   replacement strings, see ``Precompiled``), ``Strip`` and ``Replace``;
3. the pre-tokenizer ``Metaspace``: spaces become ``▁``, one is prepended,
   the text is split before each ``▁``;
4. each pre-token is segmented by Viterbi over the Unigram scores, as
   ``tokenizers`` does it: an unknown character scores ``min_score - 10``, and
   a run of unknown pieces is fused into one ``<unk>``;
5. ``TemplateProcessing`` appends ``</s>``; the ids are truncated to leave room
   for it and padded with ``<pad>`` to ``max_length``.

A step of a type this reader does not know raises ``NotImplementedError``; no
step is skipped.
"""

from __future__ import annotations

import base64
import functools
import json
import os
import re
import struct
import unicodedata

# char::is_whitespace (the White_Space property), which Strip uses
WHITE_SPACE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B), 0x2028,
                                  0x2029, 0x202F, 0x205F, 0x3000]))


# ----------------------------------------------------------------------------
# extended grapheme clusters (UAX #29), which the Precompiled normalizer walks
# ----------------------------------------------------------------------------

(_OTHER, _CR, _LF, _CONTROL, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING, _L, _V, _T, _LV, _LVT) = range(14)

# Mc characters that are Grapheme_Extend (so Extend, not SpacingMark), and Mc characters that are neither
_MC_EXTEND = frozenset([0x09BE, 0x09D7, 0x0B3E, 0x0B57, 0x0BBE, 0x0BD7, 0x0CC2, 0x0CD5, 0x0CD6, 0x0D3E, 0x0D57,
                        0x0DCF, 0x0DDF, 0x1B35, 0x302E, 0x302F, 0x1133E, 0x11357, 0x114B0, 0x114BD, 0x115AF,
                        0x11930, 0x1D165, *range(0x1D16E, 0x1D173)])
_MC_OTHER = frozenset([0x102B, 0x102C, 0x1038, 0x1062, 0x1063, 0x1064, *range(0x1067, 0x106E), 0x1083,
                       *range(0x1087, 0x108D), 0x108F, 0x109A, 0x109B, 0x109C, 0x1A61, 0x1A63, 0x1A64, 0xAA7B,
                       0xAA7D, 0x11720, 0x11721])
_PREPEND_CPS = frozenset([*range(0x0600, 0x0606), 0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2, 0x0D4E, 0x110BD, 0x110CD,
                          0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A, *range(0x11A84, 0x11A8A), 0x11D46, 0x11F02])
# Extended_Pictographic, as ranges
_PICT = ((0xA9, 0xA9), (0xAE, 0xAE), (0x203C, 0x203C), (0x2049, 0x2049), (0x2122, 0x2122), (0x2139, 0x2139),
         (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B), (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
         (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2), (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0),
         (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612), (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
         (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D), (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
         (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C), (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
         (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1), (0x27B0, 0x27B0), (0x27BF, 0x27BF), (0x2934, 0x2935),
         (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50), (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
         (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF), (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F),
         (0x1F16C, 0x1F171), (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A), (0x1F1AD, 0x1F1E5),
         (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A), (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
         (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F), (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F),
         (0x1F7D5, 0x1F7FF), (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F), (0x1F888, 0x1F88F),
         (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A), (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


@functools.lru_cache(maxsize=1 << 16)
def _break_class(ch: str) -> int:
    """The Grapheme_Cluster_Break property, from ``unicodedata``'s general
    category and the code point ranges of the classes it does not give."""
    cp = ord(ch)
    if cp == 0x0D:
        return _CR
    if cp == 0x0A:
        return _LF
    if cp == 0x200D:
        return _ZWJ
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return _RI
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return _L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return _V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return _T
    if 0xAC00 <= cp <= 0xD7A3:
        return _LV if (cp - 0xAC00) % 28 == 0 else _LVT
    if cp in _PREPEND_CPS:
        return _PREPEND
    if cp == 0x200C or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F or cp in (0xFF9E, 0xFF9F) \
            or cp in _MC_EXTEND:
        return _EXTEND
    cat = unicodedata.category(ch)
    if cat in ("Mn", "Me"):
        return _EXTEND
    if cat == "Mc":
        return _OTHER if cp in _MC_OTHER else _SPACING
    if cp in (0x0E33, 0x0EB3):
        return _SPACING
    if cat in ("Cc", "Cf", "Zl", "Zp"):
        return _CONTROL
    return _OTHER


@functools.lru_cache(maxsize=1 << 16)
def _pictographic(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _PICT)


def graphemes(text: str) -> list[str]:
    """Extended grapheme clusters: rules GB3-GB13 of UAX #29 (GB9c, the
    Indic conjunct rule, only joins clusters of three or more 3-byte
    characters, which the normalizer walks character by character anyway)."""
    out, start = [], 0
    prev = None
    ri_run = 0  # regional indicators in a row, up to prev
    emoji = 0  # 1: in ExtPict Extend*; 2: the same followed by ZWJ
    for i, ch in enumerate(text):
        c = _break_class(ch)
        if prev is not None:
            if prev == _CR and c == _LF:
                join = True
            elif prev in (_CONTROL, _CR, _LF) or c in (_CONTROL, _CR, _LF):
                join = False
            elif prev == _L and c in (_L, _V, _LV, _LVT):
                join = True
            elif prev in (_LV, _V) and c in (_V, _T):
                join = True
            elif prev in (_LVT, _T) and c == _T:
                join = True
            elif c in (_EXTEND, _ZWJ, _SPACING) or prev == _PREPEND:
                join = True
            elif prev == _ZWJ and emoji == 2 and _pictographic(ch):
                join = True
            elif prev == _RI and c == _RI and ri_run % 2 == 1:
                join = True
            else:
                join = False
            if not join:
                out.append(text[start:i])
                start = i
        ri_run = ri_run + 1 if c == _RI else 0
        if _pictographic(ch):
            emoji = 1
        elif emoji == 1 and c == _EXTEND:
            pass
        elif emoji == 1 and c == _ZWJ:
            emoji = 2
        else:
            emoji = 0
        prev = c
    if start < len(text):
        out.append(text[start:])
    return out


# ----------------------------------------------------------------------------
# normalizers and pre-tokenizers
# ----------------------------------------------------------------------------


class Precompiled:
    """The sentencepiece charsmap as ``tokenizers.normalizers.Precompiled``
    applies it. The blob: a little-endian uint32 byte size of the trie, the
    trie (darts-clone units, uint32 each), then the replacement strings, each
    ended by a NUL byte; a key's value in the trie is the offset of its
    replacement. The text is walked grapheme by grapheme: a grapheme shorter
    than 6 UTF-8 bytes that has a match is replaced whole by the replacement
    of its shortest matching prefix; any other is walked character by
    character, each character replaced where it has a match."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.normalized = blob[4 + size:]
        self._cache = {}

    def _shortest_match(self, key: bytes):
        """The value of the shortest key in the trie that is a prefix of
        ``key`` (darts-clone's commonPrefixSearch, first result), or None."""
        units = self.units
        pos = (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(units):
                return None
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:  # the label
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)  # the offset
            if (unit >> 8) & 1:  # has a leaf: its value is the unit at the offset
                return units[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str):
        if chunk not in self._cache:
            value = self._shortest_match(chunk.encode("utf-8"))
            if value is None:
                self._cache[chunk] = None
            else:
                end = self.normalized.index(b"\0", value)
                self._cache[chunk] = self.normalized[value:end].decode("utf-8")
        return self._cache[chunk]

    def __call__(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


def _strip(text: str, left: bool, right: bool) -> str:
    chars = "".join(WHITE_SPACE)
    if left:
        text = text.lstrip(chars)
    if right:
        text = text.rstrip(chars)
    return text


def _normalizer(spec):
    """A tokenizer.json normalizer -> a function str -> str."""
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]
        return lambda s: functools.reduce(lambda acc, f: f(acc), steps, s)
    if kind == "Precompiled":
        blob = spec["precompiled_charsmap"]
        if blob is None:
            return lambda s: s
        return Precompiled(base64.b64decode(blob) if isinstance(blob, str) else bytes(blob))
    if kind == "Strip":
        return lambda s: _strip(s, spec["strip_left"], spec["strip_right"])
    if kind == "Replace" and "Regex" in spec["pattern"]:
        rx, content = re.compile(spec["pattern"]["Regex"]), spec["content"]
        return lambda s: rx.sub(lambda m: content, s)
    raise NotImplementedError(f"normalizer type {kind!r} is not supported by this reader")


def _metaspace(spec):
    replacement = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme")
    if scheme is None:  # the older serialisation
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    if scheme not in ("always", "never"):
        raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r} is not supported by this reader")
    split = spec.get("split", True)

    def pre_tokenize(piece: str) -> list[str]:
        piece = piece.replace(" ", replacement)
        if scheme == "always" and not piece.startswith(replacement):
            piece = replacement + piece
        if not split:
            return [piece]
        out, cur = [], ""
        for ch in piece:  # split before each replacement character (merged with the next piece)
            if ch == replacement and cur:
                out.append(cur)
                cur = ""
            cur += ch
        if cur:
            out.append(cur)
        return out

    return pre_tokenize


def _pre_tokenizer(spec):
    """A tokenizer.json pre-tokenizer -> a function str -> list[str]."""
    kind = spec.get("type") if spec else None
    if kind == "Metaspace":
        return _metaspace(spec)
    raise NotImplementedError(f"pre-tokenizer type {kind!r} is not supported by this reader")


# ----------------------------------------------------------------------------
# the tokenizer
# ----------------------------------------------------------------------------

UNK_PENALTY = 10.0


class T5Tokenizer:
    """``T5Tokenizer(tokenizer_json)``; ``from_pretrained(<dir>)`` reads
    ``<dir>/tokenizer.json``."""

    def __init__(self, spec: dict, pad_token: str = "<pad>", model_max_length: int = 512):
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise NotImplementedError(f"model type {model.get('type')!r} is not supported by this reader")
        if model.get("byte_fallback"):
            raise NotImplementedError("Unigram byte_fallback is not supported by this reader")
        self.vocab = [(piece, float(score)) for piece, score in model["vocab"]]
        self.pieces = {piece: i for i, (piece, _) in enumerate(self.vocab)}
        self.max_piece = max(len(p) for p, _ in self.vocab)
        self.unk_id = model.get("unk_id")
        self.unk_score = min(s for _, s in self.vocab) - UNK_PENALTY

        self.added = {}  # content -> id
        for tok in spec.get("added_tokens") or []:
            if tok.get("single_word") or tok.get("lstrip") or tok.get("rstrip") or tok.get("normalized"):
                raise NotImplementedError(f"added token options of {tok['content']!r} are not supported")
            self.added[tok["content"]] = tok["id"]
        self._added_firsts = {t[0] for t in self.added}
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"))
        self.template, self.special_ids = self._template(spec.get("post_processor"))
        self.pad_token_id = {**self.pieces, **self.added}[pad_token]
        self.model_max_length = int(model_max_length)
        self._cache = {}

    @staticmethod
    def _template(spec):
        if spec is None:
            return [("A", None)], 0
        if spec.get("type") != "TemplateProcessing":
            raise NotImplementedError(f"post-processor type {spec.get('type')!r} is not supported by this reader")
        template = []
        for item in spec["single"]:
            if "Sequence" in item:
                template.append(("A", None))
            elif "SpecialToken" in item:
                template.append(("special", spec["special_tokens"][item["SpecialToken"]["id"]]["ids"]))
            else:
                raise NotImplementedError(f"template item {item!r}")
        return template, sum(len(ids) for kind, ids in template if kind == "special")

    @classmethod
    def from_pretrained(cls, path: str) -> "T5Tokenizer":
        with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        kwargs = {}
        conf_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(conf_path):
            with open(conf_path, encoding="utf-8") as f:
                conf = json.load(f)
            pad = conf.get("pad_token")
            if pad is not None:
                kwargs["pad_token"] = pad.get("content") if isinstance(pad, dict) else pad
            if conf.get("model_max_length"):
                kwargs["model_max_length"] = conf["model_max_length"]
        return cls(spec, **kwargs)

    def _split_added(self, text: str):
        """[(piece, id or None)]: the added tokens found leftmost-longest, and
        the text between them."""
        tokens = self.added
        out, start, i = [], 0, 0
        while i < len(text):
            best = None
            if text[i] in self._added_firsts:
                best = max((t for t in tokens if text.startswith(t, i)), key=len, default=None)
            if best is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], None))
            out.append((best, tokens[best]))
            i = start = i + len(best)
        if start < len(text):
            out.append((text[start:], None))
        return out

    def _viterbi(self, text: str) -> list[int]:
        """The best segmentation of ``text`` under the Unigram scores."""
        if text in self._cache:
            return self._cache[text]
        n = len(text)
        score, start_of, id_of = [0.0] * (n + 1), [None] * (n + 1), [None] * (n + 1)
        for s in range(n):
            base, single = score[s], False
            for length in range(1, min(self.max_piece, n - s) + 1):
                i = self.pieces.get(text[s:s + length])
                if i is None:
                    continue
                cand = self.vocab[i][1] + base
                if start_of[s + length] is None or cand > score[s + length]:
                    score[s + length], start_of[s + length], id_of[s + length] = cand, s, i
                single = single or length == 1
            if not single:
                cand = self.unk_score + base
                if start_of[s + 1] is None or cand > score[s + 1]:
                    score[s + 1], start_of[s + 1], id_of[s + 1] = cand, s, self.unk_id
        pieces, unk_run, end = [], "", n
        while end > 0:  # back from the end, fusing runs of unknown pieces
            s = start_of[end]
            if id_of[end] == self.unk_id:
                unk_run = text[s:end] + unk_run
            else:
                if unk_run:
                    pieces.append(unk_run)
                    unk_run = ""
                pieces.append(text[s:end])
            end = s
        if unk_run:
            pieces.append(unk_run)
        ids = [self.pieces.get(p, self.unk_id) for p in reversed(pieces)]
        self._cache[text] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        """The ids of ``text`` before the post-processor."""
        ids = []
        for piece, tok in self._split_added(text):
            if tok is not None:
                ids.append(tok)
                continue
            normalized = self.normalize(piece)
            if normalized:
                for pre in self.pre_tokenize(normalized):
                    ids.extend(self._viterbi(pre))
        return ids

    def encode_padded(self, text: str, max_length: int | None = None) -> list[int]:
        """The ids truncated to leave room for the template's special tokens,
        the template applied, padded to ``max_length``."""
        n = self.model_max_length if max_length is None else int(max_length)
        body = self.encode(text)[: n - self.special_ids]
        ids = [i for kind, special in self.template for i in (body if kind == "A" else special)]
        return ids + [self.pad_token_id] * (n - len(ids))

    def __call__(self, prompts, max_length: int | None = None):
        """A prompt or a list of them -> int64 tensor (B, max_length)."""
        import torch

        if isinstance(prompts, str):
            prompts = [prompts]
        return torch.tensor([self.encode_padded(p, max_length) for p in prompts], dtype=torch.int64)
