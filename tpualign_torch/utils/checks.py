"""Installation and store diagnostics, ``python -m tpualign_torch check``
(the port's copy of ``tpualign.utils.checks``): the imports the port
needs, the CUDA cards, the configured directories, the native library,
the store's schemas and the share of images with a bounding box. Exit
code 0 = healthy.
"""

from __future__ import annotations

import importlib
import json
from collections import Counter
from pathlib import Path

from tpualign_torch.config import PipelineConfig
from tpualign_torch.store import SCHEMAS

REQUIRED = ("torch", "numpy", "PIL")
OPTIONAL = ("pyarrow", "safetensors", "fitz", "pdfplumber", "spacy", "matplotlib")


def check_imports() -> bool:
    ok = True
    for mod in REQUIRED:
        try:
            importlib.import_module(mod)
            print(f"  [ok]      {mod}")
        except ImportError as e:
            print(f"  [MISSING] {mod}: {e}")
            ok = False
    for mod in OPTIONAL:
        try:
            importlib.import_module(mod)
            print(f"  [ok]      {mod} (optional)")
        except ImportError:
            print(f"  [absent]  {mod} (optional)")
    return ok


def check_devices() -> bool:
    """The CUDA cards torch sees; fails without one, since every stage
    that computes runs on the card unless asked for the CPU."""
    import torch

    try:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available")
        count = torch.cuda.device_count()
        print(f"  [ok]      cuda {torch.version.cuda} devices={count}")
        for i in range(min(count, 4)):
            print(f"            - cuda:{i} {torch.cuda.get_device_name(i)}")
        return True
    except Exception as e:
        print(f"  [FAIL]    cuda devices: {e}")
        return False


def check_directories(config: PipelineConfig) -> bool:
    for name, path in (("input", config.data.input_dir), ("output", config.data.output_dir),
                       ("images", config.data.images_dir), ("store", config.store.root)):
        exists = Path(path).exists()
        print(f"  [{'ok' if exists else 'absent'}]{' ' * 6}{name}: {path}")
    return True


def check_store(config: PipelineConfig) -> bool:
    from tpualign_torch.store import EmbeddingStore

    store = EmbeddingStore(config.store.root, embed_dim=config.model.variant.embed_dim)
    any_found = False
    for schema in SCHEMAS:
        if store.schema_exists(schema):
            try:
                counts = store.counts(schema)
                print(f"  [ok]      {schema}: {counts}")
                any_found = True
            except Exception as e:
                print(f"  [warn]    {schema}: unreadable ({e})")
        else:
            print(f"  [absent]  {schema}")
    return any_found


def check_bbox_quality(config: PipelineConfig) -> None:
    """Share of images with a non-zero bbox, and the bbox_source histogram."""
    meta = Path(config.data.output_dir) / "image_metadata.json"
    if not meta.exists():
        print("  [absent]  image_metadata.json (run processing first)")
        return
    images = json.loads(meta.read_text())
    total = len(images)
    valid = sum(1 for m in images if m.get("bbox") and any((c or 0) != 0 for c in m["bbox"]))
    print(f"  images with valid bbox: {valid}/{total}"
          + (f" ({valid / total:.2%})" if total else ""))
    hist = Counter(m.get("bbox_source", "unknown") for m in images)
    for src, n in sorted(hist.items()):
        print(f"    bbox_source={src}: {n}")


def check_native() -> bool:
    """Native C++ library builds (or rebuilds) and passes its self-test."""
    try:
        from tpualign_torch.native import native_available

        ok = native_available()
        print(f"  {'OK' if ok else '--'} native C++ library "
              f"{'available (self-tested)' if ok else 'unavailable; pure-Python fallbacks active'}")
        return True  # fallbacks make this non-fatal
    except Exception as e:
        print(f"  -- native check failed: {e}")
        return True


def run_checks(config: PipelineConfig) -> int:
    print("tpualign_torch installation check")
    print("=" * 60)
    print("imports:")
    imports_ok = check_imports()
    print("devices:")
    devices_ok = check_devices()
    print("directories:")
    check_directories(config)
    print("native:")
    check_native()
    print("store:")
    check_store(config)
    print("bbox quality:")
    check_bbox_quality(config)
    print("=" * 60)
    healthy = imports_ok and devices_ok
    print("RESULT:", "healthy" if healthy else "PROBLEMS FOUND")
    return 0 if healthy else 1
