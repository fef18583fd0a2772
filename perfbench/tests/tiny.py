"""Fixtures the benchmark's own tests share (a test module imports the
ones it uses): a tiny two-tower configuration that the port knows by
name, and cells cut to it, for runs of the harness on the CPU."""

import copy
import json
from pathlib import Path

import pytest

CHECKOUT = Path(__file__).resolve().parents[2]

TINY = {"port_model": "perfbench-tiny", "embed_dim": 32, "quick_gelu": True,
        "compute_dtype": "bfloat16",
        "vision_cfg": {"image_size": 32, "layers": 2, "width": 64, "patch_size": 8,
                       "head_width": 32, "mlp_ratio": 4},
        "text_cfg": {"context_length": 77, "vocab_size": 49408, "width": 64, "heads": 2,
                     "layers": 2, "mlp_ratio": 4}}

# each traffic mix cut to a size the CPU runs in seconds; shapes kept otherwise
TINY_MIXES = {
    "corpus_embed": dict(groups=2, images_per_group=8, batch_size=8, image_bucket=48,
                         image_side_range=[20, 48]),
    "finetune_weak": dict(batch_size=8, image_bucket=48, image_side_range=[20, 48]),
    "global_search_1m": dict(rows=5000, dim=32, centroids=50, manuals=100, query_batches=4,
                             queries_per_call=16),
}


@pytest.fixture
def tiny_cfg(monkeypatch):
    """TINY, registered with the port under its ``port_model`` name."""
    from tpualign_torch import config as tcfg

    v, t = TINY["vision_cfg"], TINY["text_cfg"]
    monkeypatch.setitem(tcfg.CLIP_VARIANTS, TINY["port_model"], tcfg.ClipVariant(
        name=TINY["port_model"], embed_dim=TINY["embed_dim"], image_size=v["image_size"],
        patch_size=v["patch_size"], vision_width=v["width"], vision_layers=v["layers"],
        vision_heads=v["width"] // v["head_width"], context_length=t["context_length"],
        vocab_size=t["vocab_size"], text_width=t["width"], text_layers=t["layers"],
        text_heads=t["heads"]))
    return copy.deepcopy(TINY)


@pytest.fixture
def tiny_cell(tiny_cfg):
    """``tiny_cell(workload)``: the cell as BENCHMARK.json has it, with the
    tiny configuration and its mix cut to TINY_MIXES; its limits as set."""
    from perfbench import harness

    def make(workload: str):
        cell = harness.load_cell(workload)
        traffic = {w["name"]: w for w in harness.manifest()["workloads"]}[workload]["traffic"]
        mix = json.loads((CHECKOUT / "perfbench" / "traffic" / f"{traffic}.json").read_text())
        mix.update(TINY_MIXES[traffic])
        cell.cfg, cell.mix = copy.deepcopy(tiny_cfg), mix
        if "train" in mix:
            # at tiny widths the warm-up's first learning rates move the
            # parameters by about their rounding: a short warm-up instead;
            # and bf16's rounding there is not the cell's (a sound step's
            # change reads 0.14 at the kept step): float32, in which a sound
            # run passes every limit
            mix["train"] = dict(mix["train"], learning_rate=1e-3, warmup_steps=1)
            cell.cfg["compute_dtype"] = "float32"
        return cell

    return make
