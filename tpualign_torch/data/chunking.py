"""Text chunking: words -> lines -> instruction-level chunks with bboxes
(the port's copy of ``tpualign.data.chunking``).

Reproduces the reference semantics exactly (SURVEY.md §2.5):

- words grouped into lines by vertical proximity, tolerance = 0.5 x the
  height of the FIRST word overall (ref:src/pdf_processor.py:720-748);
- each line either kept whole (instruction line) or sentence-split
  (ref:src/pdf_processor.py:750-765);
- instruction detection by Dutch or English regex sets with IGNORECASE
  matching at line start (ref:src/pdf_processor.py:767-793);
- sentence splitting via spaCy when available, else ``[.!?]+`` regex
  (ref:src/pdf_processor.py:795-803);
- chunk bbox = bbox of the first line whose text substring-matches the
  chunk, else union of words whose exact text appears among the chunk's
  whitespace tokens (ref:src/pdf_processor.py:656-684,805-816).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

from tpualign_torch.data.backends import Word

__all__ = [
    "group_words_into_lines",
    "is_instruction_line",
    "split_by_sentences",
    "split_into_instruction_chunks",
    "calculate_chunk_bbox",
    "chunk_bbox_for_lines",
    "DUTCH_INSTRUCTION_PATTERNS",
    "ENGLISH_INSTRUCTION_PATTERNS",
]

Bbox = List[float]

# Instruction regex sets (ref:src/pdf_processor.py:769-785).
DUTCH_INSTRUCTION_PATTERNS = (
    r"^\d+\.",      # numbered list
    r"^[•·▪▫]",     # bullet points
    r"^[a-zA-Z]\.",  # lettered list
    r"^(Stap|Procedure|Instructie|Opmerking|Waarschuwing|Voorzichtigheid"
    r"|Let op|Controleer|Verwijder|Installeer|Vervang|Controle|Onderhoud)",
    r"^[A-Z][a-z]+:",  # bold headers
)

ENGLISH_INSTRUCTION_PATTERNS = (
    r"^\d+\.",
    r"^[•·▪▫]",
    r"^[a-zA-Z]\.",
    r"^(Step|Procedure|Instruction|Note|Warning|Caution|Check|Remove"
    r"|Install|Replace|Maintenance)",
    r"^[A-Z][a-z]+:",
)


def is_instruction_line(text: str, language: str = "nl") -> bool:
    """Line-start regex match, Dutch set iff language == 'nl', IGNORECASE
    (ref:src/pdf_processor.py:767-793)."""
    patterns = (
        DUTCH_INSTRUCTION_PATTERNS if language == "nl" else ENGLISH_INSTRUCTION_PATTERNS
    )
    stripped = text.strip()
    return any(re.match(p, stripped, re.IGNORECASE) for p in patterns)


def split_by_sentences(
    text: str, nlp: Optional[Callable] = None
) -> List[str]:
    """spaCy sentence split when an nlp pipeline is provided, else the
    regex fallback (ref:src/pdf_processor.py:795-803)."""
    if nlp is None:
        return [s.strip() for s in re.split(r"[.!?]+", text) if s.strip()]
    doc = nlp(text)
    return [sent.text.strip() for sent in doc.sents if sent.text.strip()]


def group_words_into_lines(words: Sequence[Word]) -> List[List[Word]]:
    """Vertical-proximity grouping (ref:src/pdf_processor.py:720-748).

    Reference quirks preserved: the tolerance derives from the first word
    (after the global top-sort) only, and membership compares against the
    first word of the current line.
    """
    if not words:
        return []
    ordered = sorted(words, key=lambda w: w.top)
    tolerance = (ordered[0].bottom - ordered[0].top) * 0.5

    lines: List[List[Word]] = []
    current = [ordered[0]]
    for word in ordered[1:]:
        if abs(word.top - current[0].top) <= tolerance:
            current.append(word)
        else:
            current.sort(key=lambda w: w.x0)
            lines.append(current)
            current = [word]
    if current:
        current.sort(key=lambda w: w.x0)
        lines.append(current)
    return lines


def split_into_instruction_chunks(
    lines: Sequence[Sequence[Word]],
    language: str = "nl",
    nlp: Optional[Callable] = None,
) -> List[str]:
    """Instruction lines stay whole; others sentence-split
    (ref:src/pdf_processor.py:750-765)."""
    chunks: List[str] = []
    for line in lines:
        line_text = " ".join(w.text for w in line)
        if is_instruction_line(line_text, language):
            chunks.append(line_text)
        else:
            chunks.extend(split_by_sentences(line_text, nlp))
    return chunks


def calculate_chunk_bbox(words: Sequence[Word]) -> Bbox:
    """Min/max envelope over word boxes (ref:src/pdf_processor.py:805-816)."""
    if not words:
        return [0, 0, 0, 0]
    return [
        min(w.x0 for w in words),
        min(w.top for w in words),
        max(w.x1 for w in words),
        max(w.bottom for w in words),
    ]


def chunk_bbox_for_lines(
    chunk_text: str, lines: Sequence[Sequence[Word]]
) -> Bbox:
    """Two-tier chunk bbox resolution (ref:src/pdf_processor.py:656-684).

    Tier 1: first line whose text substring-contains (or is contained by)
    the chunk text. Tier 2: union of all words whose exact text appears in
    the chunk's whitespace-token set. Else zeros.
    """
    stripped = chunk_text.strip()
    for line in lines:
        line_text = " ".join(w.text for w in line).strip()
        if not line_text:
            continue
        if stripped in line_text or line_text in stripped:
            return calculate_chunk_bbox(list(line))
    chunk_tokens = set(t for t in re.split(r"\s+", stripped) if t)
    chunk_words = [w for line in lines for w in line if w.text and w.text in chunk_tokens]
    if chunk_words:
        return calculate_chunk_bbox(chunk_words)
    return [0, 0, 0, 0]
