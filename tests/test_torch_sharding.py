"""``tpualign_torch.parallel.sharding`` against tpualign's on the CPU.

The port's mesh repeats the CPU device (``create_mesh(4, 2, devices=[cpu]
* 8)``); tpualign's stands on its eight virtual CPU devices
(``tests/conftest.py``). Held against tpualign:

- ``clip_param_specs`` at fsdp 1 and 4, on the tiny model and on the
  ViT-B-32, ViT-L-14 and ViT-H-14 shapes (meta tensors and
  ``jax.eval_shape``: no weights are drawn), spec for spec as
  ``tuple(PartitionSpec)``;
- every part of ``shard_params`` at ``NamedSharding(...).shard_shape``, and
  the gathered tensor equal to the input; ``in_proj``'s parts hold whole
  heads (ROADMAP settled difference 22);
- the tensor-parallel towers (``RowTowers``) and ``EmbedEngine`` on (4, 2)
  against the one-device towers within 1e-6 (a split product sums in
  another order) and against tpualign's towers and mesh engine within
  1e-3 (the port's fp32 towers' bound against tpualign);
- the int8 towers' ``EmbedEngine`` on (1, 2) and (2, 2) bit-equal to the
  one-device int8 engine, and as close to tpualign's mesh engine as the
  one-device engines are to each other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import tpualign_torch.config as torch_config
from tests.test_models import TINY
from tpualign import config as jax_config
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign.parallel import mesh as jax_mesh
from tpualign.parallel import sharding as jax_sharding
from tpualign_torch.models.clip import CLIP
from tpualign_torch.models.convert import _jax_name, from_jax_params
from tpualign_torch.parallel import EmbedEngine, clip_param_specs, create_mesh, shard_params
from tpualign_torch.parallel.sharding import (
    RowTowers, ShardedTensor, data_spec, model_slices, row_params)
from tpualign_torch.train.step import model_params

pytestmark = pytest.mark.fast

CPU = torch.device("cpu")
TORCH_TINY = torch_config.ClipVariant(**dataclasses.asdict(TINY))


def port_mesh(data, model=1):
    return create_mesh(data, model, devices=[CPU] * (data * model))


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _meta_params(variant) -> dict:
    with torch.device("meta"):
        return dict(CLIP(variant, True, torch.float32, False).named_parameters())


@pytest.fixture(scope="module")
def tiny_tree():
    model = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32)
    return model, jax_init(model, seed=0)


def torch_tiny(tree) -> CLIP:
    model = CLIP(TORCH_TINY, True, torch.float32, False)
    return from_jax_params(model, jax.tree.map(np.asarray, tree)).requires_grad_(False)


@pytest.mark.parametrize("fsdp", [1, 4])
@pytest.mark.parametrize("name", ["tiny", "ViT-B-32", "ViT-L-14", "ViT-H-14"])
def test_specs_match_tpualign(name, fsdp):
    if name == "tiny":
        jv, tv = TINY, TORCH_TINY
    else:
        jv, tv = jax_config.CLIP_VARIANTS[name], torch_config.CLIP_VARIANTS[name]
    jax_model = JaxCLIP(variant=jv, use_quick_gelu=True, compute_dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jax_init(jax_model, seed=0))
    want = _flat_specs(jax_sharding.clip_param_specs(shapes, fsdp=fsdp))
    got = clip_param_specs(_meta_params(tv), fsdp=fsdp)
    assert {_jax_name(k) for k in got} == set(want)
    for k, spec in got.items():
        assert spec == tuple(want[_jax_name(k)]), k
    if fsdp > 1:
        blk = "visual.transformer.resblocks.0."
        assert got[blk + "attn.in_proj_kernel"] == ("data", "model")
        assert got[blk + "mlp.c_proj_kernel"] == ("model", "data")
        assert got[blk + "attn.in_proj_bias"] == ("model",)
        assert got["logit_scale"] == ()
    assert data_spec(4) == tuple(jax_sharding.data_spec(4))


@pytest.mark.parametrize("fsdp", [False, True])
def test_parts_take_the_shard_shapes_of_tpualign(tiny_tree, fsdp):
    """Each part at ``NamedSharding(mesh, spec).shard_shape``, on the device
    of its grid position, a fresh tensor; the gathered tensor is the input;
    ``in_proj``'s part j holds the q, k and v columns of heads [2j, 2j+2)."""
    _, tree = tiny_tree
    mesh, jmesh = port_mesh(4, 2), jax_mesh.create_mesh(4, 2)
    params = model_params(torch_tiny(tree))
    sharded = shard_params(params, mesh, fsdp=fsdp)
    for name, st in sharded.items():
        shape = NamedSharding(jmesh, P(*st.spec)).shard_shape(tuple(params[name].shape))
        for i, j in st.positions():
            part = st.parts[i][j]
            assert tuple(part.shape) == shape and part.device == mesh.devices[i, j], name
            assert part.data_ptr() != params[name].data_ptr()
        assert torch.equal(st.full(), params[name]), name
    name = "visual.transformer.resblocks.0.attn.in_proj_kernel"
    kernel, st = params[name], sharded[name]
    width, hd = TINY.vision_width, TINY.vision_width // TINY.vision_heads
    for j in range(2):
        cols = [s * width + h * hd + c for s in range(3) for h in (2 * j, 2 * j + 1)
                for c in range(hd)]
        assert torch.equal(st.local(0, j), kernel[:, cols])
        assert torch.equal(model_slices(kernel, st.spec, st.perm, 2)[j], kernel[:, cols])
    assert len({p.data_ptr() for row in st.parts for p in row}) == 8


def test_tensor_parallel_towers_match_one_device_and_tpualign(tiny_tree):
    """Every data row of (4, 2), (2, 4) with FSDP and (1, 4): the rows'
    features against the one-device towers (1e-6) and tpualign's (1e-3)."""
    jax_model, tree = tiny_tree
    model = torch_tiny(tree)
    rng = np.random.default_rng(4)
    images = rng.normal(size=(8, 32, 32, 3)).astype(np.float32)
    tokens = np.zeros((8, 16), np.int64)
    tokens[:, 0], tokens[:, 1], tokens[:, 2] = 998, rng.integers(1, 100, 8), 999
    want_img, want_txt, _ = jax_model.apply({"params": tree}, jnp.asarray(images),
                                            jnp.asarray(tokens))
    with torch.no_grad():
        one_img, one_txt, _ = model(torch.from_numpy(images), torch.from_numpy(tokens))
    for (d, m), fsdp in (((4, 2), False), ((2, 4), True), ((1, 4), False)):
        sharded = shard_params(model_params(model), port_mesh(d, m), fsdp=fsdp)
        rows = [RowTowers(model, row_params(sharded, i)) for i in range(d)]
        assert (rows[0].tp is None) == (m == 1)
        with torch.no_grad():
            outs = [t(x, y) for t, x, y in zip(
                rows, torch.tensor_split(torch.from_numpy(images), d),
                torch.tensor_split(torch.from_numpy(tokens), d))]
        img = torch.cat([o[0] for o in outs]).numpy()
        txt = torch.cat([o[1] for o in outs]).numpy()
        np.testing.assert_allclose(img, one_img.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(txt, one_txt.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(img, np.asarray(want_img), rtol=0, atol=1e-3)
        np.testing.assert_allclose(txt, np.asarray(want_txt), rtol=0, atol=1e-3)


def test_towers_refuse_a_split_they_cannot_take(tiny_tree):
    """Heads that a model axis does not divide are refused; the int8
    towers split (their comparisons: the test below)."""
    _, tree = tiny_tree
    model = torch_tiny(tree)
    sharded = shard_params(model_params(model), port_mesh(1, 8))
    with pytest.raises(ValueError, match="heads do not split"):
        RowTowers(model, row_params(sharded, 0))
    quant = CLIP(TORCH_TINY, True, torch.float32, False, "int8")
    towers = RowTowers(quant, row_params(shard_params(model_params(model), port_mesh(1, 2)), 0))
    assert len(towers.tp["visual"][0]["attn"]) == 2


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_int8_embed_engine_on_a_model_axis_matches_one_device_and_tpualign(monkeypatch, shape):
    """``CLIP_QUANT=int8`` on a model axis of 2: the row-split products take
    their row and column maxima over the cards of a row and sum the int32
    partials exactly on its first card, so ``EmbedEngine(mesh=)``'s images
    and chunks equal, bit for bit, the port's int8 engine without the model
    split: the one-device engine on (1, 2), the (2, 1) replicas on (2, 2)
    (a data split alone may round the fp32 products of the smaller row
    batches otherwise, within the 1e-6 of the fp32 engine test below).

    Against tpualign's ``EmbedEngine(quant="int8", mesh=create_mesh(...))``
    on the same params (bit-equal to its one-device engine): the chunks
    within 1e-3, the bound ``tests/test_torch_int8.py`` holds one device to;
    the images within 1e-3 too, save where the two packages' one-device
    engines are already farther apart, and there no farther than they are
    (plus the 1e-6 of a data split): on this input one image row of those
    is 1.3e-3 off, because the two attention contexts in front of block
    0's ``out_proj`` differ by ulps and one int8 code lands on the other
    side of a rounding (ROADMAP settled difference 26,
    ``tests/test_torch_int8_parity.py``); that gap is held under 2e-3."""
    from tests.test_torch_embed import TINY77, _chunk_records
    from tpualign.parallel.embed import EmbedEngine as JaxEngine

    monkeypatch.setitem(jax_config.CLIP_VARIANTS, "tiny", TINY77)
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny",
                        torch_config.ClipVariant(**dataclasses.asdict(TINY77)))
    params = jax_init(JaxCLIP(variant=TINY77, compute_dtype=jnp.float32), seed=1)
    host = jax.tree.map(np.asarray, params)
    jax_model = jax_config.ModelConfig("tiny", compute_dtype="float32", quant="int8")
    ref = JaxEngine(jax_model, batch_size=8, params=params, mesh=jax_mesh.create_mesh(*shape))
    ref_one = JaxEngine(jax_model, batch_size=8, params=params)
    config = torch_config.ModelConfig("tiny", compute_dtype="float32", quant="int8")
    kw = dict(batch_size=8, params=host, decode_workers=2)
    tp = EmbedEngine(config, mesh=port_mesh(*shape), **kw)
    base = (EmbedEngine(config, device="cpu", **kw) if shape[0] == 1
            else EmbedEngine(config, mesh=port_mesh(shape[0], 1), **kw))
    assert tp.model.quant == "int8" and tp._towers[0].tp is not None
    images = np.random.default_rng(5).normal(size=(13, 32, 32, 3)).astype(np.float32)
    got, want = tp.encode_image_batch(images), ref.encode_image_batch(images)
    np.testing.assert_array_equal(got, base.encode_image_batch(images))
    np.testing.assert_array_equal(want, ref_one.encode_image_batch(images))
    one_gap = np.abs(EmbedEngine(config, device="cpu", **kw).encode_image_batch(images)
                     - want)
    assert float(one_gap.max()) < 2e-3
    assert (np.abs(got - want) <= np.maximum(1e-3, one_gap + 1e-6)).all()
    records = _chunk_records()
    got = tp.embed_chunk_records(records)
    np.testing.assert_array_equal(got, base.embed_chunk_records(records))
    np.testing.assert_allclose(got, ref.embed_chunk_records(records), rtol=0, atol=1e-3)


def test_embed_engine_on_4x2_matches_tpualign(monkeypatch, tiny_tree):
    """``EmbedEngine`` on the port's (4, 2) mesh (tensor parallel rows)
    against tpualign's ``EmbedEngine`` on its (4, 2) mesh, at fp32: images
    and chunks within 1e-3; against the port's one-device engine within
    1e-6."""
    from tests.test_torch_embed import TINY77, _chunk_records
    from tpualign.parallel.embed import EmbedEngine as JaxEngine

    monkeypatch.setitem(jax_config.CLIP_VARIANTS, "tiny", TINY77)
    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny",
                        torch_config.ClipVariant(**dataclasses.asdict(TINY77)))
    params = jax_init(JaxCLIP(variant=TINY77, compute_dtype=jnp.float32), seed=1)
    host = jax.tree.map(np.asarray, params)
    ref = JaxEngine(jax_config.ModelConfig("tiny", parity_mode=True), batch_size=8,
                    params=params, mesh=jax_mesh.create_mesh(4, 2))
    config = torch_config.ModelConfig("tiny", parity_mode=True)
    tp = EmbedEngine(config, batch_size=8, params=host, mesh=port_mesh(4, 2), decode_workers=2)
    one = EmbedEngine(config, batch_size=8, params=host, device="cpu", decode_workers=2)
    assert isinstance(tp._towers[0], RowTowers) and tp._towers[0].tp is not None
    images = np.random.default_rng(5).normal(size=(13, 32, 32, 3)).astype(np.float32)
    got = tp.encode_image_batch(images)
    np.testing.assert_allclose(got, one.encode_image_batch(images), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref.encode_image_batch(images), rtol=0, atol=1e-3)
    records = _chunk_records()
    got = tp.embed_chunk_records(records)
    np.testing.assert_allclose(got, one.embed_chunk_records(records), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref.embed_chunk_records(records), rtol=0, atol=1e-3)


def test_sharded_tensor_keeps_a_dtype_and_its_layout():
    """``from_full`` into another dtype (a bf16 moment) and ``like``/``map``
    keep the layout; ``local`` gathers an FSDP slice over ``data``."""
    mesh = port_mesh(2, 2)
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    st = ShardedTensor.from_full(t, mesh, ("data", "model"), dtype=torch.bfloat16)
    assert st.dtype == torch.bfloat16 and st.parts[1][0].shape == (2, 3)
    assert torch.equal(st.local(1, 1), t[:, 3:].bfloat16())
    doubled = st.map(lambda p: p * 2)
    assert doubled.spec == st.spec and torch.equal(doubled.full(), 2 * t.bfloat16())
    assert st.group(1, 0) == (1, 0) and ShardedTensor.from_full(t, mesh, ()).group(1, 1) == (0, 0)
