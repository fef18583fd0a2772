"""The port's ``utils/flops.py`` and ``utils/profiling.py`` on the CPU: the
FLOP counts against tpualign's, the card's peak table, the throughput
meter, and the trace helpers (a span in a ``torch.profiler`` trace, a
trace written to a directory, the barrier)."""

import dataclasses

import pytest
import torch

import tpualign.config as jax_config
import tpualign.utils.flops as jax_flops
import tpualign_torch.config as torch_config
from tpualign_torch.utils import flops, profiling

pytestmark = pytest.mark.fast


@pytest.mark.parametrize("name", ["ViT-B-32", "ViT-B-16", "ViT-L-14"])
def test_flop_counts_match_jax(name):
    jv = jax_config.CLIP_VARIANTS[name]
    tv = torch_config.ClipVariant(**dataclasses.asdict(jv))
    assert flops.vision_tower_flops(tv) == jax_flops.vision_tower_flops(jv)
    assert flops.text_tower_flops(tv) == jax_flops.text_tower_flops(jv)
    assert flops.clip_pair_flops(tv) == jax_flops.clip_pair_flops(jv)


@pytest.mark.parametrize("device_name, peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA H100 PCIe", 756e12),
    ("NVIDIA A100-SXM4-80GB", None),
    ("TPU v5 lite", None),
])
def test_device_peak_flops(device_name, peak):
    assert flops.device_peak_flops(device_name) == peak


def test_throughput_meter():
    m = profiling.ThroughputMeter()
    with m.measure("train", 100):
        pass
    with m.measure("train", 50):
        pass
    assert m.counts["train"] == 150
    assert m.rate("train") > 0
    assert "train" in m.report()
    assert m.rate("missing") is None


def test_annotate_is_a_span_of_the_trace():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("test_span"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert "test_span" in {e.key for e in prof.key_averages()}


def test_start_and_stop_trace_write_a_trace(tmp_path):
    profiling.start_trace(str(tmp_path))
    with profiling.annotate("traced_span"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    profiling.stop_trace()
    traces = list(tmp_path.glob("*.json"))
    assert len(traces) == 1
    assert "traced_span" in traces[0].read_text()
    profiling.stop_trace()  # with no trace running: nothing to stop
    assert list(tmp_path.glob("*.json")) == traces


def test_device_barrier_without_a_card():
    assert not torch.cuda.is_available()
    assert profiling.device_barrier(torch.ones(2)) is None
    assert profiling.device_barrier() is None
