"""The port's int8 towers (``CLIP_QUANT=int8|int8_qat``) against the JAX
package's, on the CPU: ``quantize_weight``, ``int8_dot`` and
``int8_dot_qat`` against tpualign's jitted functions (the towers run them
under jit), their int8 codes, the straight-through gradients, and the
towers at fp32 compute with the same params, jitted as tpualign runs them."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_models import TINY
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign.ops import quant as jax_quant
from tpualign_torch import config as torch_config
from tpualign_torch.models import CLIP, build_clip, from_jax_params
from tpualign_torch.ops import quant

pytestmark = pytest.mark.fast

TORCH_TINY = torch_config.ClipVariant(**dataclasses.asdict(TINY))


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """Largest distance in fp32 units in the last place (same-sign values)."""
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max(initial=0))


def _operands(seed, m, k, n, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * scale).astype(np.float32)
    x[0] = 0.0                                    # a zero row: the 1e-12 floor
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    w[:, 1] = 0.0                                 # a zero column
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape", [(8, 16), (64, 48), (768, 2304)])
def test_quantize_weight_matches_jitted_jax(shape):
    w = (np.random.default_rng(shape[0]).normal(size=shape) * 0.02).astype(np.float32)
    w[:, 3] = 0.0
    w_q, w_s = quant.quantize_weight(torch.from_numpy(w))
    j_q, j_s = jax.jit(jax_quant.quantize_weight)(jnp.asarray(w))
    assert w_q.dtype == torch.int8 and tuple(w_s.shape) == (1, shape[1])
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(j_q))
    np.testing.assert_array_equal(w_s.numpy(), np.asarray(j_s))


def _jax_codes(x):
    """tpualign's jitted activation codes and scales (int8_dot's first half)."""
    def codes(a):
        s = jnp.maximum(jnp.max(jnp.abs(a), axis=-1, keepdims=True).astype(jnp.float32)
                        / 127.0, 1e-12)
        return jnp.round(a.astype(jnp.float32) / s).astype(jnp.int8), s
    return [np.asarray(t) for t in jax.jit(codes)(jnp.asarray(x))]


@pytest.mark.parametrize("m,k,n,scale", [(1, 8, 16, 1.0), (9, 64, 48, 0.01),
                                         (33, 512, 64, 30.0), (16, 768, 24, 3.0)])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_dot_matches_jitted_jax(m, k, n, scale, bias):
    x, w, b = _operands(m * k, m, k, n, scale)
    bb = b if bias else None
    got = quant.int8_dot(torch.from_numpy(x), torch.from_numpy(w),
                         None if bb is None else torch.from_numpy(bb)).numpy()
    want = np.asarray(jax.jit(jax_quant.int8_dot)(x, w, bb))
    assert got.dtype == np.float32 and got.shape == (m, n)
    assert _ulps(got, want) <= 1
    x_q, x_s = quant._quantize_rows(torch.from_numpy(x))
    j_q, j_s = _jax_codes(x)
    np.testing.assert_array_equal(x_q.numpy(), j_q)
    np.testing.assert_array_equal(x_s.numpy(), j_s)


def test_int8_dot_keeps_the_stream_dtype_and_batch_shape():
    x, w, b = _operands(3, 10, 32, 24)
    x3 = x.reshape(2, 5, 32)
    got = quant.int8_dot(torch.from_numpy(x3), torch.from_numpy(w), torch.from_numpy(b))
    want = np.asarray(jax.jit(jax_quant.int8_dot)(x3, w, b))
    assert tuple(got.shape) == (2, 5, 24) and _ulps(got.numpy(), want) <= 1
    xb = torch.from_numpy(x3).to(torch.bfloat16)
    got = quant.int8_dot(xb, torch.from_numpy(w), torch.from_numpy(b))
    want = jax.jit(jax_quant.int8_dot)(jnp.asarray(x3, jnp.bfloat16), w, b)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    zero = quant.int8_dot(torch.zeros(4, 16), torch.ones(16, 8))
    assert torch.equal(zero, torch.zeros(4, 8))


@pytest.mark.parametrize("m,k,n,scale", [(6, 16, 8, 1.0), (24, 64, 48, 0.1),
                                         (17, 512, 32, 5.0)])
def test_int8_dot_qat_forward_matches_jitted_jax(m, k, n, scale):
    """The fake-quantized operands equal tpualign's bit for bit; the fp32
    product of them sums in another order than XLA's, so the outputs agree
    within that product's rounding bound, ``k * eps * (|x_fq| @ |w_fq|)``."""
    x, w, b = _operands(m + k, m, k, n, scale)
    got = quant.int8_dot_qat(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b)).numpy()
    want = np.asarray(jax.jit(jax_quant.int8_dot_qat)(x, w, b))
    w_s = np.asarray(jax.jit(jax_quant.quantize_weight)(w)[1])
    j_q, j_s = _jax_codes(x)
    x_fq, w_fq = j_q * j_s, np.asarray(jax.jit(jax_quant.quantize_weight)(w)[0]) * w_s
    bound = k * np.finfo(np.float32).eps * (np.abs(x_fq) @ np.abs(w_fq)) + 1e-30
    assert (np.abs(got - want) <= bound).all()
    serve = quant.int8_dot(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(b)).numpy()
    assert (np.abs(got - serve) <= bound + np.abs(b) * np.finfo(np.float32).eps).all()


def test_int8_dot_qat_gradients_are_straight_through():
    """tests/test_quant.py's case: the gradients are those of
    ``x_fq @ w_fq`` with the quantizers taken as the identity."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(6, 16)).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32)).requires_grad_()
    quant.int8_dot_qat(x, w).sum().backward()
    jgx = jax.grad(lambda a: jnp.sum(jax_quant.int8_dot_qat(a, jnp.asarray(w.detach()))))(
        jnp.asarray(x.detach()))
    jgw = jax.grad(lambda k: jnp.sum(jax_quant.int8_dot_qat(jnp.asarray(x.detach()), k)))(
        jnp.asarray(w.detach()))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), rtol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(jgw), rtol=1e-5)
    assert x.grad.abs().max() > 0 and w.grad.abs().max() > 0


def _split(x, w, parts):
    """``x``'s columns and ``w``'s rows cut into ``parts`` K-slices (one a
    card of a model row)."""
    xs = [torch.from_numpy(np.ascontiguousarray(a)) for a in np.split(x, parts, axis=1)]
    ws = [torch.from_numpy(np.ascontiguousarray(a)) for a in np.split(w, parts, axis=0)]
    return xs, ws


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_dot_rows_match_jitted_jax_on_the_whole_operands(parts, bias):
    """The row-split form (``out_proj``/``c_proj`` on a model axis): the
    scales taken over the parts equal tpualign's jitted scales of the whole
    operands, so do the parts' codes; the output is within an ulp of
    tpualign's jitted ``int8_dot`` and equal to the port's one-device one
    (int32 partials summed exactly, the bias added once, in the epilogue).
    The last card's slice of ``x`` is all zeros, and row 0 is zero on every
    card: a card's own maxima would take the 1e-12 floor there."""
    x, w, b = _operands(parts, 33, 256, 48, 3.0)
    x[:, -256 // parts:] = 0.0
    bb = b if bias else None
    xs, ws = _split(x, w, parts)
    tb = None if bb is None else torch.from_numpy(bb)
    got = quant.int8_dot_rows(xs, ws, tb, torch.device("cpu")).numpy()
    want = np.asarray(jax.jit(jax_quant.int8_dot)(x, w, bb))
    assert got.dtype == np.float32 and got.shape == (33, 48) and _ulps(got, want) <= 1
    whole = quant.int8_dot(torch.from_numpy(x), torch.from_numpy(w), tb).numpy()
    np.testing.assert_array_equal(got, whole)
    cpu = torch.device("cpu")
    x_s, w_s = quant._split_scale(xs, -1, cpu), quant._split_scale(ws, 0, cpu)
    j_q, j_s = _jax_codes(x)
    jw_q, jw_s = (np.asarray(t) for t in jax.jit(jax_quant.quantize_weight)(w))
    np.testing.assert_array_equal(x_s.numpy(), j_s)
    np.testing.assert_array_equal(w_s.numpy(), jw_s)
    np.testing.assert_array_equal(torch.cat([quant._codes(a, x_s) for a in xs], 1).numpy(), j_q)
    np.testing.assert_array_equal(torch.cat([quant._codes(a, w_s) for a in ws]).numpy(), jw_q)


def test_int8_dot_columns_equal_the_one_device_columns():
    """The column-split form (``in_proj``/``c_fc``): ``x`` quantized once,
    each card's columns bit-equal to the one-device ``int8_dot``'s, in the
    stream dtype (fp32 and bf16)."""
    x, w, b = _operands(7, 2 * 9, 64, 48, 2.0)
    x3 = torch.from_numpy(x.reshape(2, 9, 64))
    ws, bs = torch.from_numpy(w).chunk(4, dim=1), torch.from_numpy(b).chunk(4)
    for xx in (x3, x3.to(torch.bfloat16)):
        got = quant.int8_dot_columns(xx, ws, bs)
        whole = quant.int8_dot(xx, torch.from_numpy(w), torch.from_numpy(b))
        assert all(g.dtype == xx.dtype for g in got)
        assert torch.equal(torch.cat(got, dim=-1), whole)


@pytest.mark.parametrize("parts", [2, 4])
def test_int8_dot_qat_rows_match_the_whole_product_and_its_gradients(parts):
    """The row-split QAT form: the fake-quantized slices use the whole
    operands' scales, so the output is the one-device ``int8_dot_qat``'s
    within the fp32 product's rounding bound, and the straight-through
    gradients reach every card's slices as the whole product's."""
    x, w, b = _operands(11 + parts, 12, 64, 24, 1.5)
    x[:, :64 // parts] = 0.0
    xs, ws = _split(x, w, parts)
    for t in xs + ws:
        t.requires_grad_()
    got = quant.int8_dot_qat_rows(xs, ws, torch.from_numpy(b), torch.device("cpu"))
    xw = torch.from_numpy(x).requires_grad_()
    ww = torch.from_numpy(w).requires_grad_()
    want = quant.int8_dot_qat(xw, ww, torch.from_numpy(b))
    j_q, j_s = _jax_codes(x)
    w_fq = np.asarray(jax.jit(jax_quant.quantize_weight)(w)[0]) * np.asarray(
        jax.jit(jax_quant.quantize_weight)(w)[1])
    bound = 64 * np.finfo(np.float32).eps * (np.abs(j_q * j_s) @ np.abs(w_fq)) + 1e-30
    assert (np.abs(got.detach().numpy() - want.detach().numpy()) <= bound).all()
    cot = torch.from_numpy(np.random.default_rng(3).normal(size=(12, 24)).astype(np.float32))
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    np.testing.assert_allclose(torch.cat([t.grad for t in xs], 1).numpy(), xw.grad.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(torch.cat([t.grad for t in ws]).numpy(), ww.grad.numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_params():
    return jax_init(JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32),
                    seed=0)


def _tokens():
    toks = np.zeros((3, 16), np.int32)
    toks[0, :5] = [1, 17, 33, 501, 999]
    toks[1, :2] = [1, 999]
    toks[2, :] = np.arange(1, 17)
    toks[2, 15] = 999
    return toks


@pytest.mark.parametrize("quant_mode", ["int8", "int8_qat"])
@pytest.mark.parametrize("tower", ["image", "text"])
def test_int8_towers_match_jax_at_fp32(jax_params, quant_mode, tower):
    jmodel = JaxCLIP(variant=TINY, use_quick_gelu=True, compute_dtype=jnp.float32,
                     quant=quant_mode)
    port = from_jax_params(CLIP(TORCH_TINY, True, torch.float32, False, quant_mode),
                           jax.tree.map(np.asarray, jax_params))
    if tower == "image":
        x = np.random.default_rng(1).normal(size=(3, 32, 32, 3)).astype(np.float32)
        want = jax.jit(lambda p, a: jmodel.apply({"params": p}, a, normalize=True,
                                                 method=jmodel.encode_image))(jax_params, x)
        with torch.no_grad():
            got = port.encode_image(torch.from_numpy(x), normalize=True)
    else:
        toks = _tokens()
        want = jax.jit(lambda p, t: jmodel.apply({"params": p}, t, normalize=True,
                                                 method=jmodel.encode_text))(jax_params, toks)
        with torch.no_grad():
            got = port.encode_text(torch.from_numpy(toks), normalize=True)
    err = float(np.max(np.abs(got.numpy() - np.asarray(want))))
    assert err <= 1e-3, f"{quant_mode} {tower} tower: max abs error {err:.3g} > 1e-3"
    # and the quantized towers stay close to the fp32 ones (tests/test_quant.py)
    plain = from_jax_params(CLIP(TORCH_TINY, True, torch.float32, False),
                            jax.tree.map(np.asarray, jax_params))
    with torch.no_grad():
        ref = (plain.encode_image(torch.from_numpy(x), normalize=True) if tower == "image"
               else plain.encode_text(torch.from_numpy(_tokens()), normalize=True))
    assert float((got * ref).sum(dim=1).min()) > 0.99


def test_build_clip_reads_clip_quant_and_embeds(monkeypatch):
    """CLIP_QUANT reaches the towers through ``build_clip`` and the
    embedding engine; a checkpoint's weights are quantized per call, so
    a later ``load_state_dict`` changes the int8 towers' output."""
    from tpualign_torch.parallel.embed import EmbedEngine

    monkeypatch.setitem(torch_config.CLIP_VARIANTS, "tiny", TORCH_TINY)
    engine = EmbedEngine(torch_config.ModelConfig("tiny", quant="int8",
                                                  compute_dtype="float32"),
                         device="cpu", seed=0)
    assert engine.model.quant == "int8"
    images = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    a = engine.encode_image_batch(images)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(np.linalg.norm(a, axis=1), 1.0, atol=1e-5)
    state = engine.model.state_dict()
    state["visual.proj"] = state["visual.proj"] * -1.0
    engine.model.load_state_dict(state)
    np.testing.assert_allclose(engine.encode_image_batch(images), -a, atol=1e-6)
    model = build_clip(torch_config.ModelConfig("tiny", quant="int8_qat"), "cpu")
    assert model.text.transformer.resblocks[0].mlp.quant == "int8_qat"
