"""Operator-in-the-loop lexical filtering (the port's copy of
``tpualign.data.filtering``).

The reference makes operators edit an EXCLUDE_TERMS set in Python source and
re-run a script (ref:src/filter_lexical_components.py:25-32,
ref:README.md:119-140). Here the exclusion list is a plain text file
(one term per line, ``#`` comments) so no source editing is needed; output
JSON structure is identical (ref:src/filter_lexical_components.py:58-64).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Optional, Set

from tpualign_torch.utils.logging import get_logger

log = get_logger("data.filtering")

__all__ = ["load_exclude_terms", "filter_lexical_components"]


def load_exclude_terms(path: Optional[str]) -> Set[str]:
    """Read the operator exclusion list; missing/None -> empty set."""
    if not path or not Path(path).exists():
        return set()
    terms = set()
    for raw in Path(path).read_text(encoding="utf-8").splitlines():
        line = raw.strip()
        if line and not line.startswith("#"):
            terms.add(line)
    return terms


def filter_lexical_components(
    input_file: str | Path,
    output_file: str | Path,
    exclude_terms: Iterable[str] = (),
) -> Optional[dict]:
    """Filter excluded terms and save the filtered vocabulary
    (ref:src/filter_lexical_components.py:35-84). Returns the filtered data
    dict, or None when the input is missing."""
    input_file = Path(input_file)
    if not input_file.exists():
        log.error("%s not found. Run document processing first.", input_file)
        return None

    exclude = set(exclude_terms)
    with open(input_file, "r", encoding="utf-8") as f:
        data = json.load(f)

    original = data.get("components", [])
    filtered = [c for c in original if c["term"] not in exclude]

    filtered_data = {
        "total_components": len(filtered),
        "total_occurrences": sum(c["count"] for c in filtered),
        "excluded_count": len(original) - len(filtered),
        "excluded_terms": sorted(exclude),
        "components": filtered,
    }
    with open(output_file, "w", encoding="utf-8") as f:
        json.dump(filtered_data, f, indent=2, ensure_ascii=False)

    log.info(
        "Filtered lexical components: original=%d excluded=%d remaining=%d",
        data.get("total_components", 0),
        filtered_data["excluded_count"],
        len(filtered),
    )
    for i, comp in enumerate(filtered[:10], 1):
        log.debug("  %d. %s: %d", i, comp["term"], comp["count"])
    return filtered_data
