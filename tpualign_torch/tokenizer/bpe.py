"""CLIP byte-pair-encoding tokenizer, standard library only.

The port's copy of ``tpualign.tokenizer.bpe`` (pure-Python merge path).
That module splits text with the ``regex`` package, whose pattern uses the
``\\p{L}``/``\\p{N}`` classes that the standard ``re`` lacks. Here a small
scanner over ``unicodedata.category`` takes its place: at each position it
tries the pattern's alternatives in the pattern's order,

    <|startoftext|> | <|endoftext|> | 's | 't | 're | 've | 'm | 'll | 'd
    | letters+ | one number | (not space, letter or number)+

under the pattern's case-insensitive flag, and skips the character when
none matches. ``tests/test_torch_tokenizer.py`` holds it against the
``regex`` split. The one remaining difference is the Unicode version: the
scanner follows the interpreter's ``unicodedata``, so a character that is
unassigned there but a letter in a newer table is split as punctuation.

The merges table is read from ``CLIP_BPE_PATH`` or a
``bpe_simple_vocab_16e6.txt(.gz)`` beside this file; without one the
vocabulary is the deterministic byte-level fallback (ids < 49408). With a
merges table the greedy merge loop runs in the native library over symbol
ids (``tpualign_torch.native.bindings.BpeCore``), as tpualign's does;
without the library, the pure-Python ``bpe()`` gives the same ids. Either
way ``encode`` caches each word's ids.
"""

from __future__ import annotations

import gzip
import html
import os
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["ClipTokenizer", "bytes_to_unicode", "split_words", "tokenize"]

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
DEFAULT_CONTEXT_LENGTH = 77

# The pattern's literal alternatives, in its order.
_LITERALS = (SOT_TOKEN, EOT_TOKEN, "'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
# Case-insensitive matching of the literals: besides ASCII case, LATIN
# SMALL LETTER LONG S folds onto "s"; no other character folds onto a
# letter of the literals.
_FOLD = {"\u017f": "s"}
# str.isspace() holds for the four information separators, the regex
# package's \s does not.
_NOT_SPACE = frozenset("\x1c\x1d\x1e\x1f")
# COMBINING GREEK YPOGEGRAMMENI is no letter, but folds onto one, so the
# pattern's negated class rejects it too: it matches no alternative.
_NO_MATCH = frozenset("\u0345")


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode-codepoint mapping (GPT-2/CLIP)."""
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


def _is_space(c: str) -> bool:
    return c.isspace() and c not in _NOT_SPACE


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    return not (_is_space(c) or _is_letter(c) or _is_number(c)
                or c in _NO_MATCH)


def _literal_at(text: str, i: int, lit: str) -> bool:
    if len(text) - i < len(lit):
        return False
    return all(_FOLD.get(a, a.lower()) == b for a, b in zip(text[i:i + len(lit)], lit))


def split_words(text: str) -> List[str]:
    """The CLIP pattern's ``findall`` over ``text`` (see module notes)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        end = 0
        for lit in _LITERALS:
            if _literal_at(text, i, lit):
                end = i + len(lit)
                break
        if not end:
            c = text[i]
            if _is_letter(c):
                end = i + 1
                while end < n and _is_letter(text[end]):
                    end += 1
            elif _is_number(c):
                end = i + 1
            elif _is_other(c):
                end = i + 1
                while end < n and _is_other(text[end]):
                    end += 1
        if end:
            out.append(text[i:end])
            i = end
        else:
            i += 1
    return out


def _get_pairs(word: Tuple[str, ...]) -> set:
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    """Runs of whitespace -> one space, then strip (``\\s+`` of the regex
    package, then ``str.strip``)."""
    if not _NOT_SPACE.intersection(text):
        return " ".join(text.split())
    out: List[str] = []
    in_space = False
    for c in text:
        if _is_space(c):
            if not in_space:
                out.append(" ")
            in_space = True
        else:
            out.append(c)
            in_space = False
    return "".join(out).strip()


def _find_default_merges() -> Optional[str]:
    cands = []
    envp = os.environ.get("CLIP_BPE_PATH")
    if envp:
        cands.append(envp)
    here = Path(__file__).parent
    cands += [
        str(here / "bpe_simple_vocab_16e6.txt.gz"),
        str(here / "bpe_simple_vocab_16e6.txt"),
    ]
    for c in cands:
        if c and Path(c).exists():
            return c
    return None


def _load_merges(path: str) -> List[Tuple[str, str]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8") as f:  # type: ignore[arg-type]
        lines = f.read().split("\n")
    # the published file has a version header line
    if lines and (" " not in lines[0] or lines[0].startswith("#version")):
        lines = lines[1:]
    merges = []
    for line in lines:
        parts = line.split()
        if len(parts) == 2:
            merges.append((parts[0], parts[1]))
    # CLIP uses exactly 48894 merges so the final vocab is 49408
    return merges[: 49152 - 256 - 2]


class ClipTokenizer:
    """CLIP BPE tokenizer: byte->unicode remapping, greedy lowest-rank pair
    merging with ``</w>`` word ends, lower-casing, whitespace collapsing,
    and fixed contexts with ``<|startoftext|>``/``<|endoftext|>``."""

    def __init__(
        self,
        bpe_path: Optional[str] = None,
        context_length: int = DEFAULT_CONTEXT_LENGTH,
    ):
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        path = bpe_path if bpe_path is not None else _find_default_merges()
        merges: List[Tuple[str, str]] = _load_merges(path) if path else []

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TOKEN, EOT_TOKEN])

        self.encoder: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: Dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks: Dict[Tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self._raw_cache: Dict[str, List[int]] = {}

        self.sot_id = self.encoder[SOT_TOKEN]
        self.eot_id = self.encoder[EOT_TOKEN]

        # the native merge core over symbol ids (None: the Python bpe())
        self._bpe_core = None
        if merges:
            from tpualign_torch.native import make_bpe_core

            self._bpe_core = make_bpe_core([self.encoder[l] for l, _ in merges],
                                           [self.encoder[r] for _, r in merges],
                                           [self.encoder[l + r] for l, r in merges])

    def _encode_token_ids(self, btoken: str) -> List[int]:
        """Byte-encoded token -> BPE ids (the native core when loaded)."""
        if self._bpe_core is None:
            return [self.encoder[t] for t in self.bpe(btoken).split(" ")]
        syms = [self.encoder[c] for c in btoken[:-1]]
        syms.append(self.encoder[btoken[-1] + "</w>"])
        return self._bpe_core.word(syms) if len(syms) > 1 else syms

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        cached = self.cache.get(token)
        if cached is not None:
            return cached
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
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
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)

        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (without specials, unpadded)."""
        ids: List[int] = []
        raw_cache = self._raw_cache
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in split_words(text):
            got = raw_cache.get(token)
            if got is None:
                btoken = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                got = self._encode_token_ids(btoken)
                raw_cache[token] = got
            ids.extend(got)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts: Sequence[str] | str) -> np.ndarray:
        """Batch tokenize to a fixed (N, context_length) int32 array:
        [SOT] + ids + [EOT], zero padding, and on truncation EOT forced at
        position context_length-1."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text) + [self.eot_id]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = self.eot_id
            result[i, : len(ids)] = ids
        return result


_DEFAULT: Optional[ClipTokenizer] = None


def tokenize(texts: Sequence[str] | str,
             context_length: int = DEFAULT_CONTEXT_LENGTH) -> np.ndarray:
    """Module-level wrapper over a shared default tokenizer (tpualign's
    ``tokenize``): ``(N, context_length)`` int32 ids."""
    global _DEFAULT
    if _DEFAULT is None or _DEFAULT.context_length != context_length:
        _DEFAULT = ClipTokenizer(context_length=context_length)
    return _DEFAULT(texts)
