"""Caption extraction and image linking (the port's copy of
``tpualign.data.captions``).

Reproduces ref:src/pdf_processor.py:818-869: regex caption patterns (Dutch
set for ``nl``, English otherwise) matched against the full page text with
IGNORECASE|MULTILINE, each match assigned to the FIRST image on the page —
so after the loop the first image carries the LAST caption found (the
acknowledged simplification at ref:src/pdf_processor.py:864-869). Also the
Word-document variant that matches caption numbers to image order
(ref:src/pdf_processor.py:871-936).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

__all__ = [
    "DUTCH_CAPTION_PATTERNS",
    "ENGLISH_CAPTION_PATTERNS",
    "find_captions",
    "link_captions_first_image",
    "link_captions_by_number",
    "link_captions_spatial",
]

DUTCH_CAPTION_PATTERNS = (
    r"Fig\.?\s*\d+[:\s]+.*?(?=\n|$)",
    r"Figuur\s*\d+[:\s]+.*?(?=\n|$)",
    r"Afb\.?\s*\d+[:\s]+.*?(?=\n|$)",
    r"Afbeelding\s*\d+[:\s]+.*?(?=\n|$)",
    r"Foto\s*\d+[:\s]+.*?(?=\n|$)",
)

ENGLISH_CAPTION_PATTERNS = (
    r"Fig\.?\s*\d+[:\s]+.*?(?=\n|$)",
    r"Figure\s*\d+[:\s]+.*?(?=\n|$)",
    r"Abb\.?\s*\d+[:\s]+.*?(?=\n|$)",
    r"Image\s*\d+[:\s]+.*?(?=\n|$)",
)


def find_captions(page_text: str, language: str = "nl") -> List[dict]:
    """All caption matches in pattern order, each as
    ``{"text", "start", "end"}`` (ref:src/pdf_processor.py:848-855)."""
    patterns = DUTCH_CAPTION_PATTERNS if language == "nl" else ENGLISH_CAPTION_PATTERNS
    captions = []
    for pattern in patterns:
        for match in re.finditer(pattern, page_text, re.IGNORECASE | re.MULTILINE):
            captions.append(
                {"text": match.group().strip(), "start": match.start(), "end": match.end()}
            )
    return captions


def link_captions_first_image(
    captions: Sequence[dict], page_images: List[Dict]
) -> None:
    """Assign every caption to the first image (in place); net effect: first
    image ends with the last caption (ref:src/pdf_processor.py:857-869)."""
    for caption in captions:
        if page_images:
            page_images[0]["caption"] = caption["text"]


def _norm(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip().lower()


def _caption_bbox(caption_text: str, lines: Sequence[dict]) -> list | None:
    """Bbox of the first line whose text matches the caption (prefix or
    containment, whitespace-normalized)."""
    cap = _norm(caption_text)
    for line in lines:
        lt = _norm(line.get("text", ""))
        if not lt:
            continue
        if cap in lt or lt in cap:
            bbox = line.get("bbox")
            if bbox and any(bbox):
                return list(bbox)
    return None


def link_captions_spatial(
    captions: Sequence[dict],
    page_images: List[Dict],
    lines: Sequence[dict],
) -> None:
    """Assign each caption to the spatially NEAREST image on the page.

    Improvement over the reference's first-image rule (an acknowledged
    simplification, ref:src/pdf_processor.py:864-869), enabled by
    ``DataConfig.caption_linking="spatial"`` / ``CAPTION_LINKING=spatial``
    (default stays ``first_image`` for parity).

    Heuristic: resolve the caption's bbox from the page's line boxes, then
    pick the image minimizing vertical gap + 0.5 x horizontal center offset,
    where images ABOVE the caption are preferred (a caption usually sits
    below its figure: a caption-above-image gap costs 3x). Captions with no
    resolvable bbox, and pages with no image boxes, fall back to the
    first-image rule for that caption.
    """
    boxed = [
        img for img in page_images
        if img.get("bbox") and any(img["bbox"])
    ]
    for caption in captions:
        cbox = _caption_bbox(caption["text"], lines)
        if cbox is None or not boxed:
            if page_images:
                page_images[0]["caption"] = caption["text"]
            continue
        cx = (cbox[0] + cbox[2]) / 2.0
        ctop, cbottom = cbox[1], cbox[3]
        best, best_cost = None, None
        for img in boxed:
            x0, y0, x1, y1 = img["bbox"][:4]
            if y1 <= ctop:           # image above caption (preferred)
                vgap = ctop - y1
            elif y0 >= cbottom:      # image below caption (penalized)
                vgap = 3.0 * (y0 - cbottom)
            else:                    # vertical overlap
                vgap = 0.0
            cost = vgap + 0.5 * abs((x0 + x1) / 2.0 - cx)
            if best_cost is None or cost < best_cost:
                best, best_cost = img, cost
        best["caption"] = caption["text"]


def link_captions_by_number(
    captions: Sequence[dict], doc_images: List[Dict]
) -> None:
    """Word-document linking: caption number N -> N-1th image, fallback to
    first image (ref:src/pdf_processor.py:916-936)."""
    for caption in captions:
        if not doc_images:
            continue
        m = re.search(r"(\d+)", caption["text"])
        if m:
            idx = int(m.group(1)) - 1
            if 0 <= idx < len(doc_images):
                doc_images[idx]["caption"] = caption["text"]
            else:
                doc_images[0]["caption"] = caption["text"]
        else:
            doc_images[0]["caption"] = caption["text"]
