"""The port refuses what it cannot honour, where tpualign would compute
something the port does not: a ``CLIP_CHECKPOINT`` that fails to load
(``EmbedEngine``, ``Pipeline.engine`` and ``make_engine`` raise one error;
no seeded weights take its place). ``CLIP_QUANT`` is read and checked as
tpualign reads and checks it, and its int8 modes build (their numbers
against tpualign's are in ``tests/test_torch_int8.py``)."""

import dataclasses

import numpy as np
import pytest

from tests.test_models import TINY
from tpualign import config as jax_config
from tpualign.models.clip import build_clip as jax_build_clip
from tpualign_torch import config as torch_config
from tpualign_torch.models import build_clip
from tpualign_torch.parallel.embed import EmbedEngine
from tpualign_torch.pipeline import Pipeline
from tpualign_torch.serving.server import make_engine

pytestmark = pytest.mark.fast


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny",
                        torch_config.ClipVariant(**dataclasses.asdict(TINY)))


def test_embed_engine_refuses_a_checkpoint():
    """A checkpoint that cannot be read raises; it is never replaced by the
    seeded weights."""
    cfg = torch_config.ModelConfig(checkpoint_path="/nonexistent/x.safetensors")
    with pytest.raises(FileNotFoundError, match="x.safetensors"):
        EmbedEngine(cfg, device="cpu")


def test_embed_pipeline_and_serve_refuse_one_checkpoint(tmp_path, tiny):
    """The three entry points load ``CLIP_CHECKPOINT`` through one loader,
    so a file they cannot load (here: no CLIP layout) fails all three
    with one error."""
    from safetensors.numpy import save_file

    path = str(tmp_path / "clip.safetensors")
    save_file({"unrelated.weight": np.ones(3, np.float32)}, path)
    config = torch_config.load_config({
        "CLIP_CHECKPOINT": path, "CLIP_MODEL": "tiny",
        "STORE_DIR": str(tmp_path / "store"), "OUTPUT_DIR": str(tmp_path / "out")})
    assert config.model.checkpoint_path == path
    with pytest.raises(ValueError) as embed:
        EmbedEngine(config.model, device="cpu")
    with pytest.raises(ValueError) as pipeline:
        Pipeline(config, device="cpu").engine
    with pytest.raises(ValueError) as serve:
        make_engine(config, "cpu")
    assert str(embed.value) == str(pipeline.value) == str(serve.value)
    assert "Unrecognized checkpoint layout" in str(serve.value)


@pytest.mark.parametrize("quant", ["none", "int8", "int8_qat"])
def test_clip_quant_is_read_as_tpualign_reads_it(quant):
    got = torch_config.load_config({"CLIP_QUANT": quant}).model.quant
    want = jax_config.load_config(env_file=None, overrides={"CLIP_QUANT": quant}).model.quant
    assert got == want == quant
    assert torch_config.load_config({}).model.quant == "none"


@pytest.mark.parametrize("quant", ["int8", "int8_qat"])
def test_clip_quant_int8_builds_as_tpualign_builds_it(quant, tiny):
    cfg = torch_config.ModelConfig("tiny", quant=quant)
    assert jax_build_clip(jax_config.ModelConfig(quant=quant)).quant == quant
    model = build_clip(cfg, "cpu")
    assert model.quant == quant
    block = model.visual.transformer.resblocks[0]
    assert block.attn.quant == block.mlp.quant == quant
    engine = EmbedEngine(cfg, device="cpu")
    assert engine.model.quant == quant


def test_clip_quant_bogus_raises_value_error_as_tpualign(tiny):
    with pytest.raises(ValueError, match="Unknown CLIP_QUANT mode 'bogus'") as want:
        jax_build_clip(jax_config.ModelConfig(quant="bogus"))
    with pytest.raises(ValueError, match="Unknown CLIP_QUANT mode 'bogus'") as got:
        build_clip(torch_config.ModelConfig("tiny", quant="bogus"), "cpu")
    assert str(got.value) == str(want.value)


def test_parity_mode_builds_fp32_towers_over_int8(tiny):
    """tpualign's parity mode forces CLIP_QUANT to none; so does the port's."""
    assert jax_build_clip(jax_config.ModelConfig(parity_mode=True, quant="int8")).quant == "none"
    model = build_clip(torch_config.ModelConfig("tiny", parity_mode=True, quant="int8"), "cpu")
    assert model.quant == "none"
    assert model.visual.compute_dtype == model.text.compute_dtype
    assert str(model.visual.compute_dtype) == "torch.float32"
