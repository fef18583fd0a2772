"""Direct Word (.docx) extractors — python-docx-gated, duck-typed (the
port's copy of ``tpualign.data.word``).

Rebuild of the reference's direct Word extractors
(ref:src/pdf_processor.py:459-601 images/chunks, :871-936 caption
linking). In both the reference and this rebuild the MAIN .docx path
converts to PDF via LibreOffice and reuses the PDF pipeline
(ref:src/pdf_processor.py:293-318); these direct extractors are the
fallback surface for environments without LibreOffice. Word documents
carry no page geometry, so every item gets ``page=1`` and a zero bbox —
which the zero-bbox image filter then drops, exactly the failure mode the
reference's hard-fail-on-conversion-error guards against
(ref:src/pdf_processor.py:306-318).

All functions take a duck-typed document object (``paragraphs`` /
``tables`` / ``part.rels``), so tests run without python-docx installed.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Tuple

from tpualign_torch.data import chunking
from tpualign_torch.data.captions import find_captions, link_captions_by_number
from tpualign_torch.utils.logging import get_logger

log = get_logger("data.word")

__all__ = [
    "detect_image_ext",
    "extract_images_from_word",
    "extract_text_chunks_from_word",
    "link_word_captions",
    "load_word_document",
]

# Magic-byte sniffing: docx media parts are stored by content, and the rel
# target extension is unreliable (ref:src/pdf_processor.py:487-503).
_IMAGE_MAGIC: Tuple[Tuple[bytes, str], ...] = (
    (b"\x89PNG", "png"),
    (b"\xff\xd8\xff", "jpg"),
    (b"GIF8", "gif"),
    (b"BM", "bmp"),
)


def detect_image_ext(blob: bytes) -> str:
    """File extension from leading magic bytes; png when unrecognized."""
    for magic, ext in _IMAGE_MAGIC:
        if blob.startswith(magic):
            return ext
    return "png"


def load_word_document(path):
    """Open a .docx with python-docx (gated import)."""
    import docx  # raises ImportError when not installed — caller gates

    return docx.Document(str(path))


def extract_images_from_word(doc, manual_id: str, images_dir) -> List[dict]:
    """Extract embedded media parts to files + metadata entries.

    Iterates the document part's relationships and keeps those whose
    target lives under ``media/`` (ref:src/pdf_processor.py:470-486).
    Entries use the same metadata schema as the PDF path but with
    ``page=1`` and a zero bbox (no geometry in the docx package), which
    marks them for the zero-bbox filter — parity with the reference's
    acknowledgement that direct Word extraction loses positions.
    """
    images_dir = Path(images_dir)
    images_dir.mkdir(parents=True, exist_ok=True)
    out: List[dict] = []
    idx = 0
    for rel in doc.part.rels.values():
        ref = getattr(rel, "target_ref", "") or ""
        if "media" not in ref:
            continue
        try:
            blob = rel.target_part.blob
        except Exception as e:
            log.warning("Unreadable media part %s: %s", ref, e)
            continue
        ext = detect_image_ext(blob)
        filename = f"{manual_id}_img{idx}.{ext}"
        (images_dir / filename).write_bytes(blob)
        out.append(
            {
                "image_id": f"{manual_id}_img{idx}",
                "manual_id": manual_id,
                "page": 1,
                "bbox": [0, 0, 0, 0],
                "bbox_source": "unknown",
                "caption": None,
                "filename": filename,
                "image_type": "raster_image",
            }
        )
        idx += 1
    return out


def extract_text_chunks_from_word(
    doc,
    manual_id: str,
    language: str = "nl",
    nlp: Optional[Callable] = None,
) -> Tuple[List[dict], str]:
    """Paragraph + table chunks, plus the full concatenated text.

    Paragraphs follow the PDF chunking rules: instruction-classified lines
    kept whole, everything else sentence-split
    (ref:src/pdf_processor.py:558-577). Table rows become one chunk each,
    cells joined with spaces, ids ``{manual}_table{t}_row{r}``
    (ref:src/pdf_processor.py:579-597). The full text feeds caption
    linking (:func:`link_word_captions`).
    """
    chunks: List[dict] = []
    full_parts: List[str] = []
    c_idx = 0
    for para in doc.paragraphs:
        text = (para.text or "").strip()
        if not text:
            continue
        full_parts.append(text)
        if chunking.is_instruction_line(text, language):
            pieces = [text]
        else:
            pieces = chunking.split_by_sentences(text, nlp)
        for piece in pieces:
            piece = piece.strip()
            if not piece:
                continue
            chunks.append(
                {
                    "chunk_id": f"{manual_id}_p1_c{c_idx}",
                    "manual_id": manual_id,
                    "page": 1,
                    "bbox": [0, 0, 0, 0],
                    "text": piece,
                }
            )
            c_idx += 1
    for t_idx, table in enumerate(getattr(doc, "tables", ()) or ()):
        for r_idx, row in enumerate(table.rows):
            row_text = " ".join(
                cell.text.strip() for cell in row.cells if cell.text.strip()
            )
            if not row_text:
                continue
            full_parts.append(row_text)
            chunks.append(
                {
                    "chunk_id": f"{manual_id}_table{t_idx}_row{r_idx}",
                    "manual_id": manual_id,
                    "page": 1,
                    "bbox": [0, 0, 0, 0],
                    "text": row_text,
                }
            )
    return chunks, "\n".join(full_parts)


def link_word_captions(full_text: str, images: List[dict], language: str = "nl") -> None:
    """Find captions in the document text and link caption number N to the
    N-1th extracted image, falling back to the first image when the number
    is missing or out of range (ref:src/pdf_processor.py:871-936).
    Mutates ``images`` in place."""
    captions = find_captions(full_text, language)
    link_captions_by_number(captions, images)
