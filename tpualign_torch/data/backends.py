"""Document backends: a uniform page-primitive interface over PDF libraries
(the port's copy of ``tpualign.data.backends``).

The reference hard-imports PyMuPDF for images (ref:src/pdf_processor.py:15,
326-457) and pdfplumber for words (ref:src/pdf_processor.py:16,603-718).
Neither is a dependency of the package, so the extraction semantics are
implemented against this small protocol instead:

- :class:`MuPDFHandle` — real PDFs via fitz (+ pdfplumber words when
  available, fitz words otherwise). Activates only when the libraries exist.
- :class:`SyntheticHandle` — deterministic ``*.synthdoc.json`` fixtures used
  by tests and offline runs (the replacement for the reference's
  reportlab-generated fixture PDFs, SURVEY.md §4).
"""

from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Sequence

__all__ = [
    "RasterImage",
    "Word",
    "DocumentHandle",
    "SyntheticBackend",
    "MuPDFBackend",
    "open_document",
    "write_synthetic_document",
]

Bbox = List[float]


@dataclass
class RasterImage:
    """One embedded raster image on a page.

    ``rects`` mirrors ``page.get_image_rects(xref)`` (tier-1 bbox source);
    ``dict_bbox`` mirrors the image block found in ``page.get_text('dict')``
    (tier-2); both absent -> tier-3 zero bbox (ref:src/pdf_processor.py:345-393).
    """

    xref: int
    data: bytes
    ext: str
    rects: Sequence[Bbox] = field(default_factory=list)
    dict_bbox: Optional[Bbox] = None


@dataclass
class Word:
    """A positioned word (pdfplumber ``extract_words`` layout: x0/x1/top/bottom)."""

    text: str
    x0: float
    x1: float
    top: float
    bottom: float

    def as_dict(self) -> dict:
        return {
            "text": self.text,
            "x0": self.x0,
            "x1": self.x1,
            "top": self.top,
            "bottom": self.bottom,
        }


class DocumentHandle:
    """Abstract per-document accessor."""

    def num_pages(self) -> int:
        raise NotImplementedError

    def page_images(self, page: int) -> List[RasterImage]:
        raise NotImplementedError

    def page_drawings(self, page: int) -> List[Bbox]:
        """Vector drawing rects (ref:src/pdf_processor.py:427-452)."""
        raise NotImplementedError

    def page_words(self, page: int) -> List[Word]:
        raise NotImplementedError

    def page_text(self, page: int) -> str:
        raise NotImplementedError

    def dict_image_blocks(self, page: int) -> List[Bbox]:
        """Bboxes of all type-1 (image) blocks on the page in order —
        the idx-th-block last-resort fallback (ref:src/pdf_processor.py:375-386)."""
        raise NotImplementedError

    def page_size(self, page: int):
        """(width, height) in PDF points."""
        return (612.0, 792.0)

    def render_page(self, page: int, dpi: int = 200):
        """Rendered PIL image of the page for OCR, or None when the backend
        cannot render (ref:src/pdf_processor.py:96-104)."""
        return None

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Synthetic backend (offline fixtures)
# ---------------------------------------------------------------------------


class SyntheticHandle(DocumentHandle):
    """Reads a ``*.synthdoc.json`` document.

    Schema::

        {"pages": [{
            "width": 612, "height": 792,
            "images": [{"data_b64"|"data_hex": ..., "ext": "png",
                        "rects": [[x0,y0,x1,y1], ...],   # may be []
                        "dict_bbox": [x0,y0,x1,y1]|null}],
            "drawings": [[x0,y0,x1,y1], ...],
            "words": [{"text","x0","x1","top","bottom"}, ...],
            "plain_text": "..."                           # optional
        }, ...]}
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "r", encoding="utf-8") as f:
            self.doc = json.load(f)
        self.pages = self.doc.get("pages", [])

    def num_pages(self) -> int:
        return len(self.pages)

    def page_images(self, page: int) -> List[RasterImage]:
        out = []
        for i, img in enumerate(self.pages[page].get("images", [])):
            if "data_b64" in img:
                data = base64.b64decode(img["data_b64"])
            elif "data_hex" in img:
                data = bytes.fromhex(img["data_hex"])
            else:
                data = b""
            out.append(
                RasterImage(
                    xref=img.get("xref", 1000 + i),
                    data=data,
                    ext=img.get("ext", "png"),
                    rects=[list(r) for r in img.get("rects", [])],
                    dict_bbox=img.get("dict_bbox"),
                )
            )
        return out

    def page_drawings(self, page: int) -> List[Bbox]:
        return [list(r) for r in self.pages[page].get("drawings", [])]

    def page_words(self, page: int) -> List[Word]:
        return [Word(**w) for w in self.pages[page].get("words", [])]

    def page_text(self, page: int) -> str:
        p = self.pages[page]
        if "plain_text" in p:
            return p["plain_text"]
        # derive from words: group by 'top' into lines
        lines: dict = {}
        for w in p.get("words", []):
            lines.setdefault(round(w["top"], 1), []).append(w)
        return "\n".join(
            " ".join(w["text"] for w in sorted(ws, key=lambda w: w["x0"]))
            for _, ws in sorted(lines.items())
        )

    def dict_image_blocks(self, page: int) -> List[Bbox]:
        out = []
        for img in self.pages[page].get("images", []):
            if img.get("dict_bbox") is not None:
                out.append(list(img["dict_bbox"]))
        return out

    def page_size(self, page: int):
        p = self.pages[page]
        return (float(p.get("width", 612)), float(p.get("height", 792)))


class SyntheticBackend:
    suffixes = (".synthdoc.json",)

    @staticmethod
    def open(path: str | Path) -> DocumentHandle:
        return SyntheticHandle(path)


def write_synthetic_document(path: str | Path, pages: List[dict]) -> None:
    """Fixture writer used by tests: encodes raw image bytes to base64."""
    ser_pages = []
    for p in pages:
        sp = dict(p)
        imgs = []
        for img in p.get("images", []):
            si = dict(img)
            if isinstance(si.get("data"), bytes):
                si["data_b64"] = base64.b64encode(si.pop("data")).decode("ascii")
            imgs.append(si)
        sp["images"] = imgs
        ser_pages.append(sp)
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"pages": ser_pages}, f)


# ---------------------------------------------------------------------------
# MuPDF backend (real PDFs — optional dependency)
# ---------------------------------------------------------------------------


class MuPDFHandle(DocumentHandle):
    """fitz-based handle with pdfplumber words when available.

    Mirrors the reference call pattern: ``page.get_images(full=True)`` +
    ``doc.extract_image(xref)`` + ``page.get_image_rects(xref)`` +
    ``page.get_text('dict')`` blocks + ``page.get_drawings()``
    (ref:src/pdf_processor.py:329-452) and pdfplumber
    ``extract_words(x_tolerance=2, y_tolerance=2)``
    (ref:src/pdf_processor.py:613-615).
    """

    def __init__(self, path: str | Path):
        import fitz

        self.path = Path(path)
        self.doc = fitz.open(str(path))
        self._plumber = None
        try:
            import pdfplumber

            self._plumber = pdfplumber.open(str(path))
        except Exception:
            self._plumber = None

    def num_pages(self) -> int:
        return len(self.doc)

    def page_images(self, page: int) -> List[RasterImage]:
        pg = self.doc[page]
        out = []
        for img in pg.get_images(full=True):
            xref = img[0]
            try:
                base = self.doc.extract_image(xref)
            except Exception:
                continue
            rects = []
            try:
                rects = [[r.x0, r.y0, r.x1, r.y1] for r in pg.get_image_rects(xref)]
            except Exception:
                pass
            dict_bbox = None
            try:
                raw = pg.get_text("dict")
                for block in raw.get("blocks", []):
                    if block.get("type") == 1:
                        info = block.get("image", {})
                        if isinstance(info, dict) and info.get("xref") == xref and "bbox" in block:
                            dict_bbox = list(block["bbox"])
                            break
            except Exception:
                pass
            out.append(
                RasterImage(
                    xref=xref,
                    data=base["image"],
                    ext=base["ext"],
                    rects=rects,
                    dict_bbox=dict_bbox,
                )
            )
        return out

    def page_drawings(self, page: int) -> List[Bbox]:
        out = []
        try:
            for d in self.doc[page].get_drawings():
                rect = d.get("rect")
                if rect:
                    out.append([rect.x0, rect.y0, rect.x1, rect.y1])
        except Exception:
            pass
        return out

    def page_words(self, page: int) -> List[Word]:
        if self._plumber is not None:
            try:
                try:
                    words = self._plumber.pages[page].extract_words(
                        x_tolerance=2, y_tolerance=2, keep_blank_chars=False
                    )
                except Exception:
                    words = self._plumber.pages[page].extract_words()
                return [
                    Word(
                        text=w["text"],
                        x0=float(w["x0"]),
                        x1=float(w["x1"]),
                        top=float(w["top"]),
                        bottom=float(w["bottom"]),
                    )
                    for w in words
                ]
            except Exception:
                pass
        # fitz fallback: word tuples (x0, y0, x1, y1, word, ...)
        try:
            return [
                Word(text=w[4], x0=w[0], x1=w[2], top=w[1], bottom=w[3])
                for w in self.doc[page].get_text("words")
            ]
        except Exception:
            return []

    def page_text(self, page: int) -> str:
        if self._plumber is not None:
            try:
                return self._plumber.pages[page].extract_text() or ""
            except Exception:
                pass
        return self.doc[page].get_text() or ""

    def dict_image_blocks(self, page: int) -> List[Bbox]:
        out = []
        try:
            raw = self.doc[page].get_text("dict")
            for block in raw.get("blocks", []):
                if block.get("type") == 1 and "bbox" in block:
                    out.append(list(block["bbox"]))
        except Exception:
            pass
        return out

    def page_size(self, page: int):
        rect = self.doc[page].rect
        return (float(rect.width), float(rect.height))

    def render_page(self, page: int, dpi: int = 200):
        """fitz pixmap -> PIL image (ref:src/pdf_processor.py:96-104)."""
        try:
            from PIL import Image

            pix = self.doc[page].get_pixmap(dpi=dpi)
            mode = "RGB" if pix.alpha == 0 else "RGBA"
            return Image.frombytes(mode, (pix.width, pix.height), pix.samples)
        except Exception:
            return None

    def close(self) -> None:
        try:
            self.doc.close()
        finally:
            if self._plumber is not None:
                self._plumber.close()


class MuPDFBackend:
    suffixes = (".pdf",)

    @staticmethod
    def available() -> bool:
        try:
            import fitz  # noqa: F401

            return True
        except ImportError:
            return False

    @staticmethod
    def open(path: str | Path) -> DocumentHandle:
        return MuPDFHandle(path)


def open_document(path: str | Path) -> DocumentHandle:
    """Open by suffix: ``.synthdoc.json`` -> synthetic, ``.pdf`` -> MuPDF."""
    name = str(path)
    if name.endswith(".synthdoc.json"):
        return SyntheticBackend.open(path)
    if name.endswith(".pdf"):
        if not MuPDFBackend.available():
            raise ImportError(
                "PyMuPDF (fitz) is required for real PDFs but is not "
                "installed; use *.synthdoc.json fixtures instead"
            )
        return MuPDFBackend.open(path)
    raise ValueError(f"Unsupported document type: {path}")
