"""OCR bounding-box fallback for pages with no extractable word boxes (the
port's copy of ``tpualign.data.ocr``).

Rebuild of the reference's OCR path (ref:src/pdf_processor.py:106-149):
render the page to a raster image, run an OCR engine producing
pytesseract ``image_to_data``-style columnar output, and rescale the pixel
boxes into PDF page coordinates. Plain-text lines are then matched to OCR
boxes by whitespace-normalized containment (either direction), mirroring
the reference's substring matching at ref:src/pdf_processor.py:630-641.

The engine is injectable (``DocumentProcessor.ocr_engine``) so tests run
without tesseract; the default engine is pytesseract-gated and degrades to
"no boxes found" when the library or binary is unavailable — the caller
falls back to zero bboxes, the same ladder as the reference
(ref:src/pdf_processor.py:619-648).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from tpualign_torch.utils.logging import get_logger

log = get_logger("data.ocr")

__all__ = ["default_ocr_engine", "extract_ocr_bboxes", "match_line_bbox"]

# An OCR engine maps a PIL image to a dict of parallel lists with at least
# the keys text/left/top/width/height (pytesseract Output.DICT layout).
OcrEngine = Callable[[object], Optional[dict]]


def default_ocr_engine(image) -> Optional[dict]:
    """pytesseract ``image_to_data`` when available, else ``None``."""
    try:
        import pytesseract
        from pytesseract import Output
    except ImportError:
        log.debug("pytesseract not installed; OCR fallback disabled")
        return None
    try:
        return pytesseract.image_to_data(image, output_type=Output.DICT)
    except Exception as e:  # missing tesseract binary, bad image, ...
        log.warning("OCR engine failed: %s", e)
        return None


def extract_ocr_bboxes(
    image,
    page_width: float,
    page_height: float,
    engine: Optional[OcrEngine] = None,
) -> List[dict]:
    """OCR an image of a page and return word boxes in PAGE coordinates.

    The rendered image and the PDF page differ in resolution; boxes are
    rescaled by (page_size / image_size) per axis, the inverse of the
    render DPI scaling (ref:src/pdf_processor.py:121-143). Blank OCR
    tokens are dropped. Returns ``[{"text", "bbox": [x0, y0, x1, y1]}]``.
    """
    if image is None:
        return []
    data = (engine or default_ocr_engine)(image)
    if not data:
        return []
    img_w, img_h = getattr(image, "size", (0, 0))
    if not img_w or not img_h:
        return []
    sx = float(page_width) / float(img_w)
    sy = float(page_height) / float(img_h)
    boxes: List[dict] = []
    texts = data.get("text", [])
    for i in range(len(texts)):
        text = (texts[i] or "").strip()
        if not text:
            continue
        left, top = float(data["left"][i]), float(data["top"][i])
        width, height = float(data["width"][i]), float(data["height"][i])
        boxes.append(
            {
                "text": text,
                "bbox": [
                    left * sx,
                    top * sy,
                    (left + width) * sx,
                    (top + height) * sy,
                ],
            }
        )
    return boxes


def match_line_bbox(line: str, boxes: List[dict]) -> list:
    """Bbox of the first OCR box whose text contains the line or is
    contained by it (whitespace-normalized, case-insensitive); zero bbox
    when nothing matches (ref:src/pdf_processor.py:630-641)."""
    norm = " ".join(line.split()).lower()
    if norm:
        for box in boxes:
            box_text = " ".join(box.get("text", "").split()).lower()
            if box_text and (norm in box_text or box_text in norm):
                return list(box["bbox"])
    return [0, 0, 0, 0]
