"""The port's checkpoint loader (``tpualign_torch.models.loader``) against
tpualign's, on the CPU. A seeded tiny tree exported to the OpenCLIP
layout (``.safetensors`` and ``.pt``) and a tiny HuggingFace
``CLIPModel`` must load into array-equal trees in both packages; the
port's towers loaded from the file must be within 1e-3 of tpualign's at
fp32, through ``EmbedEngine``, ``Pipeline.engine`` and ``make_engine``;
the safe-loading rules (``weights_only``, the pickle opt-in, the
unwrapping) must match."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpualign.config as jax_config
import tpualign.models.loader as jax_loader
import tpualign_torch.config as torch_config
import tpualign_torch.models.loader as torch_loader
from tests.test_loader import _Payload
from tests.test_models import TINY
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign_torch.parallel.embed import EmbedEngine
from tpualign_torch.pipeline import Pipeline
from tpualign_torch.serving.server import make_engine

pytestmark = pytest.mark.fast

TINY77 = dataclasses.replace(TINY, context_length=77)


@pytest.fixture
def tiny_variant(monkeypatch):
    """``tiny`` in both packages' variant tables (a 77-token context, as
    ``tests/test_torch_pipeline.py``'s fixture)."""
    monkeypatch.setitem(jax_config.CLIP_VARIANTS, "tiny", TINY77)
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny",
                        torch_config.ClipVariant(**dataclasses.asdict(TINY77)))
    return TINY77


@pytest.fixture(scope="module")
def jax_tree():
    model = JaxCLIP(variant=TINY77, use_quick_gelu=True, compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, jax_init(model, seed=0))


def to_openclip(tree) -> dict:
    """The JAX tree's layout -> an OpenCLIP state dict of numpy arrays (the
    inverse of ``convert_openclip_state_dict``)."""
    sd = {}

    def blocks(prefix, transformer):
        for name, blk in transformer.items():
            p = f"{prefix}.resblocks.{name.split('_')[1]}"
            for ln in ("ln_1", "ln_2"):
                sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = blk[ln]["scale"], blk[ln]["bias"]
            a, m = blk["attn"], blk["mlp"]
            sd[f"{p}.attn.in_proj_weight"] = a["in_proj_kernel"].T
            sd[f"{p}.attn.in_proj_bias"] = a["in_proj_bias"]
            sd[f"{p}.attn.out_proj.weight"] = a["out_proj_kernel"].T
            sd[f"{p}.attn.out_proj.bias"] = a["out_proj_bias"]
            sd[f"{p}.mlp.c_fc.weight"] = m["c_fc_kernel"].T
            sd[f"{p}.mlp.c_fc.bias"] = m["c_fc_bias"]
            sd[f"{p}.mlp.c_proj.weight"] = m["c_proj_kernel"].T
            sd[f"{p}.mlp.c_proj.bias"] = m["c_proj_bias"]

    v, t = tree["visual"], tree["text"]
    sd["visual.conv1.weight"] = v["conv1"]["kernel"].transpose(3, 2, 0, 1)
    for name in ("class_embedding", "positional_embedding", "proj"):
        sd[f"visual.{name}"] = v[name]
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"], sd[f"visual.{ln}.bias"] = v[ln]["scale"], v[ln]["bias"]
    blocks("visual.transformer", v["transformer"])
    sd["token_embedding.weight"] = t["token_embedding"]
    sd["positional_embedding"] = t["positional_embedding"]
    sd["text_projection"] = t["text_projection"]
    sd["ln_final.weight"], sd["ln_final.bias"] = t["ln_final"]["scale"], t["ln_final"]["bias"]
    blocks("transformer", t["transformer"])
    sd["logit_scale"] = np.asarray(tree["logit_scale"], np.float32)
    return {k: np.ascontiguousarray(x, np.float32) for k, x in sd.items()}


def save(sd: dict, path, fmt: str) -> str:
    """``sd`` (numpy) as ``.safetensors`` or as a ``torch.save``d tensor dict."""
    path = str(path) + "." + fmt
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(sd, path)
    else:
        torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, path)
    return path


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    got, want = flat(got), flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_openclip_file_loads_equal_trees(fmt, jax_tree, tiny_variant, tmp_path):
    path = save(to_openclip(jax_tree), tmp_path / "clip", fmt)
    got = torch_loader.load_checkpoint_params(torch_config.ModelConfig("tiny"), path)
    want = jax_loader.load_checkpoint_params(jax_config.ModelConfig("tiny"), path)
    assert_trees_equal(got, want)
    assert_trees_equal(got, jax_tree)  # the exporter round-trips


@pytest.mark.parametrize("fmt", ["safetensors", "pt"])
def test_towers_from_the_file_match_tpualign_fp32(fmt, jax_tree, tiny_variant, tmp_path):
    """``EmbedEngine`` with ``CLIP_CHECKPOINT`` against tpualign's towers on
    the tree tpualign's loader reads from the same file."""
    path = save(to_openclip(jax_tree), tmp_path / "clip", fmt)
    params = jax_loader.load_checkpoint_params(jax_config.ModelConfig("tiny"), path)
    jmodel = JaxCLIP(variant=TINY77, use_quick_gelu=True, compute_dtype=jnp.float32)
    engine = EmbedEngine(torch_config.ModelConfig("tiny", checkpoint_path=path,
                                                  compute_dtype="float32"),
                         text_buckets=None, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    toks = np.asarray(engine.tokenizer(["remove the filter", "", "draai de bout los"]))
    want_img = jmodel.apply({"params": params}, jnp.asarray(x), normalize=True,
                            method=jmodel.encode_image)
    want_txt = jmodel.apply({"params": params}, jnp.asarray(toks), normalize=True,
                            method=jmodel.encode_text)
    got_img = engine.encode_image_batch(x)
    got_txt = engine.encode_text_batch(["remove the filter", "", "draai de bout los"])
    assert float(np.max(np.abs(got_img - np.asarray(want_img)))) <= 1e-3
    assert float(np.max(np.abs(got_txt - np.asarray(want_txt)))) <= 1e-3


def test_embed_pipeline_and_serve_load_one_checkpoint(jax_tree, tiny_variant, tmp_path):
    """``EmbedEngine``, ``Pipeline.engine`` and ``make_engine`` load the
    same weights from ``CLIP_CHECKPOINT``, and none of them the seeded ones."""
    path = save(to_openclip(jax_tree), tmp_path / "clip", "pt")
    config = torch_config.load_config({
        "CLIP_CHECKPOINT": path, "CLIP_MODEL": "tiny", "STORE_DIR": str(tmp_path / "s"),
        "OUTPUT_DIR": str(tmp_path / "o"), "COMPUTE_DTYPE": "float32"})
    engines = [EmbedEngine(config.model, device="cpu"),
               Pipeline(config, device="cpu").engine, make_engine(config, "cpu")]
    seeded = EmbedEngine(torch_config.ModelConfig("tiny", compute_dtype="float32"),
                         device="cpu")
    texts = ["check the pump seal", "vervang de pakking"]
    want = engines[0].encode_text_batch(texts)
    for engine in engines[1:]:
        np.testing.assert_array_equal(engine.encode_text_batch(texts), want)
    assert not np.allclose(seeded.encode_text_batch(texts), want, atol=1e-3)
    np.testing.assert_array_equal(
        engines[0].model.text.text_projection.detach().numpy(),
        jax_tree["text"]["text_projection"])


@pytest.fixture(scope="module")
def hf_state_dict():
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    cfg = transformers.CLIPConfig(
        projection_dim=64,
        vision_config={"image_size": 32, "patch_size": 8, "hidden_size": 64,
                       "intermediate_size": 256, "num_hidden_layers": 2,
                       "num_attention_heads": 4, "hidden_act": "quick_gelu"},
        text_config={"vocab_size": 1000, "hidden_size": 64, "intermediate_size": 256,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "max_position_embeddings": 77, "hidden_act": "quick_gelu",
                     "eos_token_id": 999})
    model = transformers.CLIPModel(cfg).eval()
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("fmt", ["safetensors", "pt", "module-prefixed pt"])
def test_hf_layout_loads_equal_trees(fmt, hf_state_dict, tiny_variant, tmp_path):
    sd = {k: v.numpy() for k, v in hf_state_dict.items()}
    if fmt == "module-prefixed pt":
        path = str(tmp_path / "hf.bin")
        torch.save({"state_dict": {f"module.{k}": v for k, v in hf_state_dict.items()}}, path)
    else:
        path = save(sd, tmp_path / "hf", fmt)
    got = torch_loader.load_checkpoint_params(torch_config.ModelConfig("tiny"), path)
    want = jax_loader.load_checkpoint_params(jax_config.ModelConfig("tiny"), path)
    assert_trees_equal(got, want)
    assert_trees_equal(torch_loader.convert_hf_clip_state_dict(hf_state_dict, TINY77),
                       jax_loader.convert_hf_clip_state_dict(hf_state_dict, TINY77))
    assert got["visual"]["transformer"]["resblock_1"]["attn"]["in_proj_kernel"].shape == (64, 192)


# -- file reading: tests/test_loader.py's cases through both packages --------------------

def _plain(path):
    torch.save({"w": torch.ones(2, 2), "b": torch.zeros(3)}, path)


def _module_prefix(path):
    torch.save({"module.w": torch.ones(1), "module.b": torch.zeros(1)}, path)


def _model_prefix(path):
    torch.save({"model.w": torch.ones(1), "model.b": torch.zeros(1)}, path)


def _nested(path):
    torch.save({"state_dict": {"w": torch.ones(1)}}, path)


def _mixed_prefix(path):
    torch.save({"module.w": torch.ones(1), "b": torch.zeros(1)}, path)


def _pickled(path):
    torch.save({"w": torch.ones(1), "obj": _Payload()}, path)


@pytest.mark.parametrize("allow_pickle", [False, True])
@pytest.mark.parametrize("writer", [_plain, _module_prefix, _model_prefix, _nested,
                                    _mixed_prefix, _pickled])
def test_read_state_dict_matches_tpualign(writer, allow_pickle, tmp_path):
    path = str(tmp_path / "ckpt.pt")
    writer(path)
    results = []
    for loader in (jax_loader, torch_loader):
        try:
            sd = loader._read_state_dict(path, allow_pickle=allow_pickle)
            results.append({k: np.asarray(v) if hasattr(v, "shape") else type(v).__name__
                            for k, v in sd.items()})
        except ValueError as e:
            results.append(("ValueError", str(e)))
    want, got = results
    if writer is _pickled and not allow_pickle:
        assert got == want and "allow_pickle" in got[1]
        return
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_allow_pickle_is_read_as_tpualign_reads_it(tmp_path, tiny_variant):
    for raw in ("", "true", "0", "yes"):
        overrides = {"CLIP_CHECKPOINT_ALLOW_PICKLE": raw} if raw else {}
        got = torch_config.load_config(overrides).model.checkpoint_allow_pickle
        want = jax_config.load_config(env_file=None,
                                      overrides=overrides).model.checkpoint_allow_pickle
        assert got == want
    path = str(tmp_path / "trusted.pt")
    _pickled(path)
    with pytest.raises(ValueError, match="allow_pickle"):
        torch_loader.load_checkpoint_params(torch_config.ModelConfig("tiny"), path)
    # the opt-in reads the file; its keys are no CLIP layout
    with pytest.raises(ValueError, match="Unrecognized checkpoint layout"):
        torch_loader.load_checkpoint_params(
            torch_config.ModelConfig("tiny", checkpoint_allow_pickle=True), path)


def test_load_errors(tmp_path, tiny_variant):
    cfg = torch_config.ModelConfig("tiny")
    with pytest.raises(FileNotFoundError, match="CLIP_CHECKPOINT"):
        torch_loader.load_checkpoint_params(cfg)
    # a directory is a training run's checkpoints; one without steps raises
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        torch_loader.load_checkpoint_params(cfg, str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no checkpoint steps"):
        EmbedEngine(torch_config.ModelConfig("tiny", checkpoint_path=str(tmp_path)),
                    device="cpu")
    path = str(tmp_path / "other.safetensors")
    from safetensors.numpy import save_file

    save_file({"w": np.ones(2, np.float32)}, path)
    for loader, mc in ((torch_loader, cfg), (jax_loader, jax_config.ModelConfig("tiny"))):
        with pytest.raises(ValueError, match="Unrecognized checkpoint layout"):
            loader.load_checkpoint_params(mc, path)
