"""The port's stages 1-2 (``tpualign_torch.data``) against tpualign's, on
the CPU: every unit case of ``tests/test_data.py`` and
``tests/test_word_ocr.py`` run through both packages' functions, and both
``DocumentProcessor``s over the same synthdoc corpora, which must write
identical ``image_metadata.json``, ``text_chunks.json`` and
``lexical_components.json``, byte-identical ``images/`` and, after the
operator's exclusion list, an identical filtered vocabulary."""

import io
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

import tpualign.config as jax_config
import tpualign.data.backends as jax_backends
import tpualign.data.captions as jax_captions
import tpualign.data.chunking as jax_chunking
import tpualign.data.filtering as jax_filtering
import tpualign.data.lexical as jax_lexical
import tpualign.data.ocr as jax_ocr
import tpualign.data.processor as jax_processor
import tpualign.data.word as jax_word
import tpualign_torch.config as torch_config
import tpualign_torch.data.backends as torch_backends
import tpualign_torch.data.captions as torch_captions
import tpualign_torch.data.chunking as torch_chunking
import tpualign_torch.data.filtering as torch_filtering
import tpualign_torch.data.lexical as torch_lexical
import tpualign_torch.data.ocr as torch_ocr
import tpualign_torch.data.processor as torch_processor
import tpualign_torch.data.word as torch_word
from tests.test_data import manual_dir  # noqa: F401  (a fixture of this module too)
from tests.test_pipeline import make_corpus
from tests.test_word_ocr import (JPG_MAGIC, PNG_MAGIC, StubDoc, StubRel, StubTable,
                                 stub_engine)

pytestmark = pytest.mark.fast

JAX = SimpleNamespace(config=jax_config, backends=jax_backends, captions=jax_captions,
                      chunking=jax_chunking, filtering=jax_filtering, lexical=jax_lexical,
                      ocr=jax_ocr, processor=jax_processor, word=jax_word)
PORT = SimpleNamespace(config=torch_config, backends=torch_backends, captions=torch_captions,
                       chunking=torch_chunking, filtering=torch_filtering,
                       lexical=torch_lexical, ocr=torch_ocr, processor=torch_processor,
                       word=torch_word)


def _png(color, size=(60, 40)):
    buf = io.BytesIO()
    Image.new("RGB", size, color).save(buf, format="PNG")
    return buf.getvalue()


# -- unit cases: each runs through both packages and must give the same result --------

def _words(pkg, rows):
    return [pkg.backends.Word(text=t, x0=x0, x1=x1, top=top, bottom=bottom)
            for t, x0, top, x1, bottom in rows]


def _lines(pkg, rows_per_line):
    return [_words(pkg, rows) for rows in rows_per_line]


def _texts(lines):
    return [[w.text for w in line] for line in lines]


class _Token:
    def __init__(self, lemma, pos="NOUN", stop=False, punct=False):
        self.lemma_, self.pos_, self.is_stop, self.is_punct = lemma, pos, stop, punct


_TOKENS = [_Token("Filter"), _Token("abc"), _Token("de", stop=True), _Token(".", punct=True),
           _Token("1234"), _Token("bout-moer"), _Token("we!rd"), _Token("lopen", pos="VERB")]
_GROUP = [("a", 0, 100, 10, 110), ("b", 20, 104, 30, 114), ("c", 0, 120, 10, 130)]
_CHUNK_LINES = [[("1.", 0, 0, 5, 10), ("Remove", 6, 0, 20, 10), ("cover.", 21, 0, 40, 10)],
                [("It", 0, 20, 5, 30), ("works.", 6, 20, 20, 30), ("Done.", 21, 20, 40, 30)]]
_BBOX_LINES = [[("hello", 10, 5, 40, 15), ("world", 45, 5, 80, 15)],
               [("other", 10, 25, 40, 35)]]
_SPATIAL_IMAGES = [{"image_id": "a", "bbox": [50, 100, 150, 200], "caption": None},
                   {"image_id": "b", "bbox": [300, 100, 400, 200], "caption": None},
                   {"image_id": "c", "bbox": [50, 300, 150, 400], "caption": None}]
_SPATIAL_LINES = [{"text": "Figuur 1: de pomp", "bbox": [50, 210, 160, 222]},
                  {"text": "Figuur 2: de klep", "bbox": [300, 210, 410, 222]},
                  {"text": "Figuur 3: boven", "bbox": [50, 280, 160, 292]}]
_CAPTION_TEXT = ("Figuur 2: tweede\nsome text\nFig. 1: eerste\nFoto 3 derde\n"
                 "Figure 1: en only\nAfbeelding 2: nl only\nImage 7 x\nAbb. 4: y")
_OCR_BOXES = [{"text": "hello", "l": 10, "t": 20, "w": 30, "h": 10},
              {"text": "  ", "l": 0, "t": 0, "w": 1, "h": 1},
              {"text": "regel een", "l": 5, "t": 10, "w": 50, "h": 5}]


def _link(fn, captions, images, *rest):
    images = [dict(i) for i in images]
    fn(captions, images, *rest)
    return images


def _word_images(pkg, tmp):
    doc = StubDoc([], rels=[StubRel(PNG_MAGIC), StubRel(JPG_MAGIC, "media/image2.jpg"),
                            StubRel(b"x", "styles.xml")])
    out = pkg.word.extract_images_from_word(doc, "man", tmp)
    return out, sorted((p.name, p.read_bytes()) for p in Path(tmp).iterdir())


UNIT_CASES = {
    "group_words_into_lines": lambda p, t: _texts(
        p.chunking.group_words_into_lines(_words(p, _GROUP))),
    "lines_sorted_horizontally": lambda p, t: _texts(p.chunking.group_words_into_lines(
        _words(p, [("right", 50, 0, 60, 10), ("left", 0, 1, 10, 11)]))),
    "group_words_empty": lambda p, t: p.chunking.group_words_into_lines([]),
    "is_instruction_line": lambda p, t: [
        p.chunking.is_instruction_line(text, lang) for text, lang in (
            ("1. Remove the cover", "en"), ("• bullet item", "en"), ("a. lettered", "en"),
            ("Step one: do it", "en"), ("Warning: hot", "en"), ("Note the difference", "en"),
            ("the quick brown fox", "en"), ("Stap 1: verwijder", "nl"),
            ("Controleer de filter", "nl"), ("Verwijder het deksel", "nl"),
            ("gewone zin zonder marker", "nl"), ("remove the cover now", "nl"),
            ("warning: hot", "en"), ("Onderhoud: jaarlijks", "nl"), ("  ▪ x", "de"))],
    "split_by_sentences": lambda p, t: p.chunking.split_by_sentences(
        "One. Two! Three? Four... ?!", nlp=None),
    "split_into_instruction_chunks": lambda p, t: [
        p.chunking.split_into_instruction_chunks(_lines(p, _CHUNK_LINES), lang, None)
        for lang in ("en", "nl")],
    "calculate_chunk_bbox": lambda p, t: [
        p.chunking.calculate_chunk_bbox(_words(p, _GROUP)), p.chunking.calculate_chunk_bbox([])],
    "chunk_bbox_for_lines": lambda p, t: [
        p.chunking.chunk_bbox_for_lines(text, _lines(p, _BBOX_LINES))
        for text in ("hello world", "world other", "world qqq", "zzz qqq", " other ")],
    "find_captions": lambda p, t: [p.captions.find_captions(_CAPTION_TEXT, lang)
                                   for lang in ("nl", "en")],
    "link_captions_first_image": lambda p, t: _link(
        p.captions.link_captions_first_image, [{"text": "Fig. 1: a"}, {"text": "Fig. 2: b"}],
        [{"caption": None}, {"caption": None}]),
    "link_captions_spatial": lambda p, t: _link(
        p.captions.link_captions_spatial,
        [{"text": "Figuur 1: de pomp"}, {"text": "Figuur 2: de klep"},
         {"text": "Figuur 3: boven"}, {"text": "Figuur 9: onvindbaar"}],
        _SPATIAL_IMAGES, _SPATIAL_LINES),
    "link_captions_by_number": lambda p, t: _link(
        p.captions.link_captions_by_number,
        [{"text": "Figuur 2: de pomp"}, {"text": "Figuur 9: x"}, {"text": "Foto: geen"}],
        [{"caption": None}, {"caption": None}]),
    "preprocess_text": lambda p, t: [p.lexical.preprocess_text(x) for x in (
        "hyphen-\nated  word", "a   b\t c", "42", "  7 \n", "pomp-\n  huis 3\n12")],
    "extract_lexical_components": lambda p, t: [
        p.lexical.extract_lexical_components("x", lambda text: _TOKENS),
        p.lexical.extract_lexical_components("any text", None)],
    "heuristic_noun_extractor": lambda p, t: p.lexical.extract_lexical_components(
        "Verwijder de filterdeksel met een sleutel, bout-moer M8 en 2x Ölfilter!",
        p.lexical.HeuristicNoun()),
    "build_lexical_data": lambda p, t: p.lexical.build_lexical_data(
        ["b", "a", "b", "c", "a", "b"]),
    "load_spacy": lambda p, t: p.lexical.load_spacy("nl") is None,
    "load_exclude_terms": lambda p, t: _exclude_terms(p, t),
    "filter_lexical_components": lambda p, t: _filter(p, t),
    "filter_invalid_bboxes": lambda p, t: p.processor.filter_invalid_bboxes(
        [{"bbox": [0, 0, 0, 0]}, {"bbox": None}, {"bbox": [1, 2, 3, 4]},
         {"bbox": [0, 0, 5, 0]}, {"bbox": [None, 0, 0, 0]}]),
    "detect_image_ext": lambda p, t: [p.word.detect_image_ext(b) for b in (
        PNG_MAGIC, JPG_MAGIC, b"GIF89a", b"BM1234", b"????")],
    "extract_images_from_word": lambda p, t: _word_images(p, t),
    "extract_text_chunks_from_word": lambda p, t: p.word.extract_text_chunks_from_word(
        StubDoc(["1. Verwijder de schroef", "De pomp werkt. Daarna stopt hij.", ""],
                tables=[StubTable([["a", "b"], ["", ""]])]), "man", "nl", None),
    "link_word_captions": lambda p, t: _word_captions(p),
    "extract_ocr_bboxes": lambda p, t: [
        p.ocr.extract_ocr_bboxes(Image.new("RGB", (200, 100)), 400, 200,
                                 stub_engine(_OCR_BOXES)),
        p.ocr.extract_ocr_bboxes(None, 400, 200, stub_engine(_OCR_BOXES)),
        p.ocr.extract_ocr_bboxes(Image.new("RGB", (200, 100)), 400, 200, lambda im: None)],
    "match_line_bbox": lambda p, t: [
        p.ocr.match_line_bbox(line, [{"text": "hello world", "bbox": [1, 2, 3, 4]}])
        for line in ("hello", "hello world and more", "zzz", "", "HELLO   World")],
    "default_ocr_engine": lambda p, t: p.ocr.default_ocr_engine(Image.new("RGB", (8, 8))),
}


def _exclude_terms(pkg, tmp):
    path = Path(tmp) / "exclude.txt"
    path.write_text("# comment\nruis\n\n  proce  \n")
    return [sorted(pkg.filtering.load_exclude_terms(str(path))),
            pkg.filtering.load_exclude_terms(None),
            pkg.filtering.load_exclude_terms(str(Path(tmp) / "missing.txt"))]


def _filter(pkg, tmp):
    inp = Path(tmp) / "lex.json"
    inp.write_text(json.dumps(pkg.lexical.build_lexical_data(
        ["schroef"] * 3 + ["ruis"] * 2 + ["pomp"])))
    out = Path(tmp) / "filtered.json"
    data = pkg.filtering.filter_lexical_components(inp, out, exclude_terms={"ruis", "vreemd"})
    missing = pkg.filtering.filter_lexical_components(Path(tmp) / "none.json", out)
    return data, out.read_text(), missing


def _word_captions(pkg):
    images = [{"image_id": "m_img0", "caption": None}, {"image_id": "m_img1", "caption": None}]
    pkg.word.link_word_captions("intro\nFiguur 2: de pomp\ntekst", images, "nl")
    first = [dict(i) for i in images]
    pkg.word.link_word_captions("Figuur 9: onbekend", images, "nl")
    return first, images


@pytest.mark.parametrize("case", sorted(UNIT_CASES))
def test_unit_case_matches_tpualign(case, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = UNIT_CASES[case](JAX, tmp_path / "jax")
    got = UNIT_CASES[case](PORT, tmp_path / "port")
    assert got == want


# -- stage 1 over synthdoc corpora, stage 2 after it ------------------------------------

def _spatial_corpus(raw: Path) -> None:
    """Two figures stacked vertically, each with its caption below it
    (``tests/test_data.py``'s spatial-linking corpus)."""
    words = []
    for top, caption in ((210, "Figuur 1: de pomp"), (410, "Figuur 2: de klep")):
        x = 60
        for t in caption.split():
            words.append({"text": t, "x0": x, "x1": x + 8 * len(t), "top": top,
                          "bottom": top + 12})
            x += 8 * len(t) + 4
    jax_backends.write_synthetic_document(raw / "m.synthdoc.json", [{
        "width": 612, "height": 792,
        "images": [
            {"data": _png((200, 0, 0)), "ext": "png", "rects": [[50, 100, 150, 200]]},
            {"data": _png((0, 200, 0)), "ext": "png", "rects": [[50, 300, 150, 400]]},
        ],
        "drawings": [],
        "words": words,
        "plain_text": "Figuur 1: de pomp\nFiguur 2: de klep",
    }])


_LANG_LINES = {
    "nl": ["Stap 1: verwijder de afdekplaat van de pomp", "Controleer het oliepeil.",
           "De filter zit achter de klep. Vervang de pakking!", "Afb. 2: de pompbehuizing",
           "Waarschuwing: hete onderdelen", "a. draai de bout los"],
    "en": ["Step 1: remove the cover plate of the pump", "Check the oil level.",
           "The filter sits behind the valve. Replace the gasket!", "Figure 2: the pump housing",
           "Warning: hot parts", "b. loosen the drain bolt"],
}


def _language_corpus(raw: Path, language: str) -> None:
    """Three manuals: instruction and sentence lines in ``language``,
    captions, vector drawings, a dict-bbox fallback, an image without any
    bbox, a page without word boxes, and a JPEG."""
    rng = np.random.default_rng(7)
    lines = _LANG_LINES[language]
    for m in range(3):
        pages = []
        for p in range(3):
            words, top = [], 80.0
            for li, line in enumerate(lines[(m + p) % 3:] + lines[:(m + p) % 3]):
                x = 40.0
                for t in line.split():
                    w = 6.5 * len(t)
                    words.append({"text": t, "x0": x, "x1": x + w, "top": top + (li % 2) * 1.5,
                                  "bottom": top + 11})
                    x += w + 5
                top += 23
            jpg = io.BytesIO()
            Image.fromarray(rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)).save(
                jpg, format="JPEG", quality=90)
            pages.append({
                "width": 612, "height": 792,
                "images": [
                    {"data": _png((40 * m, 30 * p, 90)), "ext": "png",
                     "rects": [[60 + 10 * p, 300, 200, 420]]},
                    {"data": jpg.getvalue(), "ext": "jpg", "rects": [],
                     "dict_bbox": [300, 300, 420, 400] if p != 1 else None},
                    {"data": _png((1, 2, 3)), "ext": "png", "rects": []},
                ],
                "drawings": [[400, 500, 520, 600], [10, 10, 13, 13]],
                "words": words if (m, p) != (2, 2) else [],
                "plain_text": "\n".join(lines),
            })
        jax_backends.write_synthetic_document(raw / f"{language}{m}.synthdoc.json", pages)


def _corpus(name: str, root: Path, request) -> tuple:
    """Writes corpus ``name``; returns (raw dir, DataConfig overrides)."""
    if name == "manual_dir":
        return request.getfixturevalue("manual_dir") / "raw", {"language": "nl"}
    raw = root / "raw"
    raw.mkdir()
    if name == "pipeline":
        make_corpus(raw)
        return raw, {"language": "nl"}
    if name.startswith("spatial"):
        _spatial_corpus(raw)
        return raw, {"language": "nl", "caption_linking": name.split("-", 1)[1]}
    if name == "bounded":
        _language_corpus(raw, "nl")
        return raw, {"language": "nl", "min_chunk_length": 12, "max_chunk_length": 40,
                     "min_image_size": 200}
    _language_corpus(raw, name)
    return raw, {"language": name}


def _processed(out: Path) -> dict:
    files = {name: json.loads((out / name).read_text())
             for name in ("image_metadata.json", "text_chunks.json",
                          "lexical_components.json", "filtered_lexical_components.json")}
    files["images/"] = sorted((p.name, p.read_bytes()) for p in (out / "images").iterdir())
    return files


@pytest.mark.parametrize("nlp", ["heuristic", "none"])
@pytest.mark.parametrize("corpus", ["pipeline", "manual_dir", "spatial-spatial",
                                    "spatial-first_image", "nl", "en", "bounded"])
def test_stage1_and_stage2_match_tpualign(corpus, nlp, tmp_path, request):
    raw, fields = _corpus(corpus, tmp_path, request)
    exclude = tmp_path / "exclude.txt"
    exclude.write_text("pagina\nfilter\nthe\n")
    outputs, summaries = [], []
    for pkg in (JAX, PORT):
        out = tmp_path / ("jax" if pkg is JAX else "port")
        cfg = pkg.config.DataConfig(input_dir=str(raw), output_dir=str(out), **fields)
        # "auto" with the heuristic fallback is what the pipeline passes
        kw = ({"nlp": "auto", "lexical_fallback": "heuristic"} if nlp == "heuristic"
              else {"nlp": None})
        proc = pkg.processor.DocumentProcessor(cfg, **kw)
        summaries.append([proc.process_all_documents(), proc.process_all_documents()])
        pkg.filtering.filter_lexical_components(
            out / "lexical_components.json", out / "filtered_lexical_components.json",
            pkg.filtering.load_exclude_terms(str(exclude)))
        outputs.append(_processed(out))
    want, got = outputs
    assert summaries[1] == summaries[0]
    for name in want:
        assert got[name] == want[name], name
    assert want["image_metadata.json"] and want["text_chunks.json"]
    if nlp == "heuristic":
        assert want["lexical_components.json"]["components"]


def test_processor_ocr_fallback_matches_tpualign(tmp_path):
    """A page without word boxes, ``use_ocr_fallback`` and an injected OCR
    engine: the plain-text lines get the OCR boxes, scaled to the page."""
    raw = tmp_path / "raw"
    raw.mkdir()
    jax_backends.write_synthetic_document(raw / "m.synthdoc.json", [{
        "width": 400, "height": 200, "images": [], "drawings": [], "words": [],
        "plain_text": "regel een\nregel twee\n\nhello"}])
    blocks = []
    for pkg in (JAX, PORT):
        cfg = pkg.config.DataConfig(input_dir=str(raw), output_dir=str(tmp_path / "out"),
                                    use_ocr_fallback=True)
        proc = pkg.processor.DocumentProcessor(cfg, nlp=None)
        proc.ocr_engine = stub_engine(_OCR_BOXES)
        handle = pkg.backends.SyntheticHandle(raw / "m.synthdoc.json")
        handle.render_page = lambda page, dpi=200: Image.new("RGB", (200, 100))
        blocks.append(proc.extract_text_blocks(handle, "m", 1))
    assert blocks[1] == blocks[0]
    assert blocks[0][0]["bbox"] == [10.0, 20.0, 110.0, 30.0]


def test_backends_and_file_rules_match_tpualign(tmp_path):
    """The synthdoc handle's primitives, ``open_document``'s suffix rules,
    MAX_FILE_SIZE_MB and the Word route without LibreOffice."""
    raw = tmp_path / "raw"
    raw.mkdir()
    make_corpus(raw, n_manuals=1, pages=2)
    (raw / "notes.docx").write_bytes(b"PK\x03\x04 not really a docx")
    path = raw / "manual0.synthdoc.json"
    results = []
    for pkg in (JAX, PORT):
        h = pkg.backends.open_document(path)
        prims = [h.num_pages(), h.page_size(0), h.page_text(1), h.dict_image_blocks(0),
                 h.page_drawings(0), [w.as_dict() for w in h.page_words(0)],
                 [(i.xref, i.data, i.ext, i.rects, i.dict_bbox) for i in h.page_images(1)],
                 h.render_page(0)]
        errors = []
        for bad in (tmp_path / "x.txt", tmp_path / "x.pdf"):
            with pytest.raises((ValueError, ImportError)) as e:
                pkg.backends.open_document(bad)
            errors.append((type(e.value).__name__, str(e.value)))
        cfg = pkg.config.DataConfig(input_dir=str(raw), output_dir=str(tmp_path / "o"),
                                    soffice_path=str(tmp_path / "no-soffice"))
        proc = pkg.processor.DocumentProcessor(cfg, nlp=None)
        with pytest.raises(RuntimeError, match="Word->PDF conversion failed"):
            proc.process_single_document(raw / "notes.docx")
        summary = proc.process_all_documents()
        sized = pkg.processor.DocumentProcessor(
            pkg.config.DataConfig(input_dir=str(raw), output_dir=str(tmp_path / "s"),
                                  max_file_size_mb=0), nlp=None).process_all_documents()
        results.append((prims, errors, [p.name for p in proc._discover_files()], summary,
                        sized))
    assert results[1] == results[0]
    assert results[0][4] == {"images": 0, "chunks": 0, "lexical_terms": 0}
