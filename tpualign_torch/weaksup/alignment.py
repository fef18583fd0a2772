"""Alignment records: thresholds, combination, emission order (the port's
``tpualign.weaksup.alignment``).

- candidates are pairs with equal manual_id AND equal page;
- a lexical score is kept iff > 0.05, a positional one iff > 0.05;
- with both strategies on and BOTH kept: one 'combined' record with the
  mean score, kept iff > 0.1 (and no individual records for that pair);
- otherwise each kept score becomes its own typed record.

Records come image-major, chunk-minor, lexical before positional, so that
stored alignment tables compare byte for byte with tpualign's.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from tpualign_torch.utils.device import resolve_device
from tpualign_torch.weaksup.lexical import lexical_scores
from tpualign_torch.weaksup.positional import positional_scores

__all__ = [
    "LEXICAL_THRESHOLD",
    "POSITIONAL_THRESHOLD",
    "COMBINED_THRESHOLD",
    "same_page_mask",
    "alignment_grids",
    "compute_alignments",
]

LEXICAL_THRESHOLD = 0.05
POSITIONAL_THRESHOLD = 0.05
COMBINED_THRESHOLD = 0.1

# Dense-grid cell budget per image batch: images are batched and each
# batch is scored only against the chunks of its own (manual, page) keys,
# so memory is O(valid pairs + batch), never O(images x chunks).
_ALIGN_BATCH_CELLS = 8 * 1024 * 1024


def same_page_mask(images: Sequence[dict], chunks: Sequence[dict]) -> np.ndarray:
    """(I, C) bool: equal manual_id and equal page."""
    key_to_idx: Dict[Tuple, List[int]] = {}
    for j, c in enumerate(chunks):
        key_to_idx.setdefault((c["manual_id"], c.get("page")), []).append(j)
    mask = np.zeros((len(images), len(chunks)), dtype=bool)
    for i, img in enumerate(images):
        for j in key_to_idx.get((img["manual_id"], img.get("page")), ()):
            mask[i, j] = True
    return mask


def _bbox4(bbox) -> List[float]:
    """Exactly 4 floats; an invalid box becomes zeros (which score 0)."""
    if not bbox or len(bbox) != 4:
        return [0.0, 0.0, 0.0, 0.0]
    return [float(v) for v in bbox]


def alignment_grids(images: Sequence[dict], chunks: Sequence[dict],
                    lexical_terms: Sequence[str], use_lexical: bool, use_positional: bool,
                    device: str | torch.device = "cpu"
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense (I, C) score grids and the candidate mask, as host arrays:
    (mask, lex_grid, pos_grid); a disabled strategy gives a zero grid.
    Lexical scores are per chunk, broadcast across images; positional
    scores are computed on ``device``."""
    n_img, n_chunk = len(images), len(chunks)
    mask = same_page_mask(images, chunks)
    lex = np.zeros((n_img, n_chunk), np.float32)
    pos = np.zeros((n_img, n_chunk), np.float32)
    if use_lexical and n_chunk:
        lex_c = lexical_scores([c["text"] for c in chunks], lexical_terms)
        lex = np.broadcast_to(lex_c[None, :], (n_img, n_chunk)).copy()
    if use_positional and n_img and n_chunk:
        img_bb = np.asarray([_bbox4(img.get("bbox")) for img in images], np.float32)
        chk_bb = np.asarray([_bbox4(c.get("bbox")) for c in chunks], np.float32)
        pos = positional_scores(img_bb, chk_bb, device).cpu().numpy()
    return mask, lex, pos


def compute_alignments(images: Sequence[dict], chunks: Sequence[dict],
                       lexical_terms: Sequence[str], use_lexical: bool, use_positional: bool,
                       device: str | torch.device = "cuda"
                       ) -> List[Tuple[str, str, float, str]]:
    """All (image_id, chunk_id, weak_score, alignment_type) records for one
    schema, image-major, chunk-minor, lexical before positional.

    Images are taken in batches whose dense sub-grid (the batch's images
    against the chunks of their own pages) stays within
    ``_ALIGN_BATCH_CELLS``; the positional grid of each batch is computed
    on ``device`` (CUDA unless the caller asks for the CPU)."""
    if not (use_lexical or use_positional):
        return []
    n_img, n_chunk = len(images), len(chunks)
    if n_img == 0 or n_chunk == 0:
        return []
    dev = resolve_device(device)
    lex_c = (np.asarray(lexical_scores([c["text"] for c in chunks], lexical_terms), np.float32)
             if use_lexical else np.zeros(n_chunk, np.float32))
    key_to_idx: Dict[Tuple, List[int]] = {}
    for j, c in enumerate(chunks):
        key_to_idx.setdefault((c["manual_id"], c.get("page")), []).append(j)
    img_keys = [(img["manual_id"], img.get("page")) for img in images]
    chunks_per_key = {k: len(v) for k, v in key_to_idx.items()}
    if use_positional:
        chk_bb = torch.as_tensor(
            np.asarray([_bbox4(c.get("bbox")) for c in chunks], np.float32), device=dev)

    records: List[Tuple[str, str, float, str]] = []
    both_mode = use_lexical and use_positional
    i0 = 0
    while i0 < n_img:
        # grow the image batch until its dense sub-grid hits the budget
        i1 = i0
        keys: Dict[Tuple, None] = {}
        cols = 0
        while i1 < n_img:
            k = img_keys[i1]
            extra = 0 if k in keys else chunks_per_key.get(k, 0)
            if i1 > i0 and (i1 - i0 + 1) * (cols + extra) > _ALIGN_BATCH_CELLS:
                break
            if k not in keys:
                keys[k] = None
                cols += extra
            i1 += 1
        union: List[int] = sorted(j for k in keys for j in key_to_idx.get(k, ()))
        if union:
            col_of = {j: bj for bj, j in enumerate(union)}
            if use_positional:
                img_bb = np.asarray([_bbox4(images[i].get("bbox")) for i in range(i0, i1)],
                                    np.float32)
                pos_grid = positional_scores(
                    img_bb, chk_bb[torch.as_tensor(union, device=dev)], dev).cpu().numpy()
            for i in range(i0, i1):
                for j in key_to_idx.get(img_keys[i], ()):
                    lex_v = float(lex_c[j])
                    pos_v = float(pos_grid[i - i0, col_of[j]]) if use_positional else 0.0
                    lex_hit = use_lexical and lex_v > LEXICAL_THRESHOLD
                    pos_hit = use_positional and pos_v > POSITIONAL_THRESHOLD
                    if both_mode and lex_hit and pos_hit:
                        combined = (lex_v + pos_v) / 2.0
                        if combined > COMBINED_THRESHOLD:
                            records.append((images[i]["image_id"], chunks[j]["chunk_id"],
                                            combined, "combined"))
                    else:
                        if lex_hit:
                            records.append((images[i]["image_id"], chunks[j]["chunk_id"],
                                            lex_v, "lexical"))
                        if pos_hit:
                            records.append((images[i]["image_id"], chunks[j]["chunk_id"],
                                            pos_v, "positional"))
        i0 = i1
    return records
