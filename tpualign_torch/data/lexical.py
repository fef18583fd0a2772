"""Lexical-component (noun vocabulary) extraction (the port's copy of
``tpualign.data.lexical``).

Reproduces ref:src/pdf_processor.py:938-1026:

- :func:`preprocess_text`: de-hyphenate across line breaks, collapse
  whitespace, drop page-number-only lines — applied IN THAT ORDER, which
  means the page-number pattern can only fire on an all-digit string after
  whitespace collapsing (reference quirk preserved).
- :func:`extract_lexical_components`: keep tokens with pos NOUN, not
  stop/punct, lemma >= 4 chars, alnum-or-hyphenated, at least one letter.
- :func:`build_lexical_data`: Counter frequencies sorted by (-count, term),
  serialized as {total_components, total_occurrences, components}.

spaCy is optional. With ``nlp=None`` the reference returns an empty
vocabulary (ref:src/pdf_processor.py:953-954); that remains the default.
A deterministic heuristic extractor (:class:`HeuristicNoun`) is available
for offline environments so the lexical weak-supervision path stays usable
without spaCy — opt-in via ``DocumentProcessor(lexical_fallback="heuristic")``.
"""

from __future__ import annotations

import re
from collections import Counter
from typing import Callable, List, Optional

__all__ = [
    "preprocess_text",
    "extract_lexical_components",
    "build_lexical_data",
    "load_spacy",
    "HeuristicNoun",
]


def preprocess_text(text: str) -> str:
    """Hyphenation/whitespace/page-number cleanup (ref:src/pdf_processor.py:938-949)."""
    text = re.sub(r"-\s*\n\s*", "", text)
    text = re.sub(r"\s+", " ", text)
    text = re.sub(r"^\d+\s*$", "", text, flags=re.MULTILINE)
    return text.strip()


def _token_ok(lemma_lower: str) -> bool:
    """Shared lemma filter (ref:src/pdf_processor.py:971-981)."""
    return (
        len(lemma_lower) >= 4
        and (
            lemma_lower.replace("-", "").replace("_", "").isalnum()
            or "-" in lemma_lower
        )
        and any(c.isalpha() for c in lemma_lower)
    )


def extract_lexical_components(
    text: str, nlp: Optional[Callable] = None
) -> List[str]:
    """Noun lemmas passing the reference filter; [] without an nlp pipeline
    (ref:src/pdf_processor.py:951-984)."""
    if nlp is None:
        return []
    doc = nlp(text)
    components = []
    for token in doc:
        lemma_lower = token.lemma_.lower().strip()
        if (
            token.pos_ == "NOUN"
            and not token.is_stop
            and not token.is_punct
            and _token_ok(lemma_lower)
        ):
            components.append(lemma_lower)
    return components


def build_lexical_data(components: List[str]) -> dict:
    """Frequency table sorted by (-count, term) (ref:src/pdf_processor.py:1004-1022)."""
    counts = Counter(components)
    sorted_components = sorted(counts.items(), key=lambda x: (-x[1], x[0]))
    return {
        "total_components": len(sorted_components),
        "total_occurrences": sum(counts.values()),
        "components": [{"term": t, "count": c} for t, c in sorted_components],
    }


# ---------------------------------------------------------------------------
# spaCy loading (optional) and the offline heuristic fallback
# ---------------------------------------------------------------------------

SPACY_MODEL_MAP = {
    "en": "en_core_web_sm",
    "nl": "nl_core_news_sm",
    "de": "de_core_news_sm",
    "fr": "fr_core_news_sm",
}


def load_spacy(language: str = "nl"):
    """Load the per-language spaCy model; None when unavailable
    (ref:src/pdf_processor.py:151-181, without the auto-download: install
    models ahead of time)."""
    try:
        import spacy
    except ImportError:
        return None
    model_name = SPACY_MODEL_MAP.get(language, "en_core_web_sm")
    try:
        return spacy.load(model_name)
    except Exception:
        return None


class _HToken:
    __slots__ = ("lemma_", "pos_", "is_stop", "is_punct")

    def __init__(self, lemma, pos, stop, punct):
        self.lemma_ = lemma
        self.pos_ = pos
        self.is_stop = stop
        self.is_punct = punct


# Function words in nl/en that the heuristic must not call nouns.
_HEURISTIC_STOP = frozenset(
    """de het een en of maar want dus als dan ook niet geen voor door met naar
    van uit bij over onder tussen tegen zonder binnen buiten deze dit die dat
    hier daar waar wanneer welke alle elke iedere veel weinig meer meest zeer
    the a an and or but so if then also not no for by with to from at over
    under between against without within outside this that these those here
    there where when which all each every much many more most very has have
    had was were been being is are will would could should may might must
    wordt worden werd zijn hebben heeft moet moeten kan kunnen zal zullen
    """.split()
)

_VERB_SUFFIX = ("eren", "ing</s>",)


class HeuristicNoun:
    """Deterministic language-data-free pseudo-POS tagger.

    Treats every token as a candidate NOUN unless it is a stopword, starts
    with a digit, or is capitalized mid-text (proper-noun-ish). Lemma =
    lowercase surface form. This is intentionally simple: its role is to
    make the lexical weak-supervision path exercisable offline, not to match
    spaCy's tagging.
    """

    def __call__(self, text: str):
        tokens = []
        for raw in re.findall(r"[A-Za-zÀ-ÿ0-9_-]+|[^\sA-Za-zÀ-ÿ0-9]", text):
            lower = raw.lower()
            is_punct = not any(c.isalnum() for c in raw)
            is_stop = lower in _HEURISTIC_STOP
            pos = "NOUN" if (not is_punct and not is_stop and raw[0].isalpha()) else "X"
            tokens.append(_HToken(lower, pos, is_stop, is_punct))
        return _Doc(tokens)


class _Doc(list):
    @property
    def sents(self):  # minimal sentence API for split_by_sentences
        raise AttributeError("HeuristicNoun does not provide sentences")
