"""The port's weak supervision (``tpualign_torch.weaksup``) against the JAX
package on the CPU: lexical scores, the positional grid (bit for bit),
and the alignment records of ``compute_alignments`` for every schema's
strategies, including a run across the per-batch cell budget."""

import numpy as np
import pytest
import torch

import tpualign.weaksup.alignment as jax_alignment
import tpualign_torch.weaksup.alignment as alignment
from tpualign.weaksup import compute_alignments as jax_compute_alignments
from tpualign.weaksup.lexical import lexical_scores as jax_lexical_scores
from tpualign.weaksup.positional import positional_scores as jax_positional_scores
from tpualign_torch.weaksup import compute_alignments, lexical_scores, positional_scores
from tpualign_torch.weaksup.positional import positional_score_scalar

pytestmark = pytest.mark.fast

WORDS = ["filter", "pomp", "bout", "pakking", "olie", "de", "het", "klep", "slang", "regel"]


def _boxes(rng, n):
    """Boxes on a 612 x 792 page, with degenerate and missing ones."""
    x0 = rng.integers(0, 500, n)
    y0 = rng.integers(0, 700, n)
    boxes = np.stack([x0, y0, x0 + rng.integers(0, 120, n), y0 + rng.integers(0, 90, n)], 1)
    boxes = boxes.astype(np.float32)
    boxes[::7] = 0.0                     # missing
    boxes[3::11, 2] = boxes[3::11, 0]    # zero width
    return boxes


def _corpus(seed, n_manuals=3, pages=4, imgs=2, chunks=5):
    rng = np.random.default_rng(seed)
    images, texts = [], []
    for m in range(n_manuals):
        for p in range(pages):
            for i in range(imgs):
                bb = _boxes(rng, 1)[0].tolist() if (m + p + i) % 5 else None
                images.append({"image_id": f"m{m}_p{p}_i{i}", "manual_id": f"m{m}",
                               "page": p, "bbox": bb})
            for c in range(chunks):
                texts.append({"chunk_id": f"m{m}_p{p}_c{c}", "manual_id": f"m{m}", "page": p,
                              "bbox": _boxes(rng, 1)[0].tolist() if c % 4 else [1, 2, 3],
                              "text": " ".join(rng.choice(WORDS, 6)).title()})
    images.append({"image_id": "nopage", "manual_id": "m0", "page": None, "bbox": [0, 0, 5, 5]})
    texts.append({"chunk_id": "nopage_c", "manual_id": "m0", "page": None, "bbox": [1, 1, 6, 6],
                  "text": "filter"})
    return images, texts


def test_lexical_scores_match_jax():
    rng = np.random.default_rng(0)
    texts = [" ".join(rng.choice(WORDS, 5)).upper() for _ in range(40)] + [""]
    for terms in (WORDS[:3], WORDS, ["filt", "x"], []):
        got = lexical_scores(texts, terms)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_lexical_scores(texts, terms))


def test_positional_scores_match_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, 37), _boxes(rng, 53)
    b[5] = a[6]                          # identical boxes: IoU 1
    got = positional_scores(a, b)
    assert got.dtype == torch.float32 and got.shape == (37, 53)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_positional_scores(a, b)))
    # on tensors it takes their device; against the scalar rule per pair
    np.testing.assert_array_equal(positional_scores(torch.from_numpy(a), b).numpy(), got.numpy())
    for i in range(0, 37, 5):
        for j in range(0, 53, 7):
            want = positional_score_scalar(a[i].tolist(), b[j].tolist())
            assert got[i, j].item() == pytest.approx(want, abs=1e-6)


@pytest.mark.parametrize("use_lexical,use_positional", [(False, False), (True, False),
                                                        (False, True), (True, True)])
def test_compute_alignments_match_jax(use_lexical, use_positional):
    images, chunks = _corpus(2)
    terms = WORDS[:4]
    got = compute_alignments(images, chunks, terms, use_lexical, use_positional, device="cpu")
    want = jax_compute_alignments(images, chunks, terms, use_lexical, use_positional)
    assert got == want
    if use_lexical or use_positional:
        assert got  # the corpus yields records of each enabled kind
    mask, lex, pos = alignment.alignment_grids(images, chunks, terms, use_lexical,
                                               use_positional)
    jmask, jlex, jpos = jax_alignment.alignment_grids(images, chunks, terms, use_lexical,
                                                      use_positional)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(lex, jlex)
    np.testing.assert_array_equal(pos, jpos)


def test_compute_alignments_across_the_cell_budget(monkeypatch):
    """A budget of a few cells cuts the images into many batches; the
    records stay those of one batch, and tpualign's under the same cut."""
    images, chunks = _corpus(4, n_manuals=4, pages=5)
    terms = WORDS[:5]
    whole = compute_alignments(images, chunks, terms, True, True, device="cpu")
    monkeypatch.setattr(alignment, "_ALIGN_BATCH_CELLS", 12)
    monkeypatch.setattr(jax_alignment, "_ALIGN_BATCH_CELLS", 12)
    cut = compute_alignments(images, chunks, terms, True, True, device="cpu")
    assert cut == whole
    assert cut == jax_alignment.compute_alignments(images, chunks, terms, True, True)
    assert {r[3] for r in cut} >= {"combined", "lexical"}


def test_compute_alignments_empty_inputs():
    images, chunks = _corpus(5)
    assert compute_alignments([], chunks, WORDS, True, True, device="cpu") == []
    assert compute_alignments(images, [], WORDS, True, True, device="cpu") == []


def test_compute_alignments_needs_cuda_unless_cpu_is_asked(monkeypatch):
    images, chunks = _corpus(6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compute_alignments(images, chunks, WORDS, True, True)
