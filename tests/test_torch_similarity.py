"""The port's copies of tpualign's package-level helpers against
tpualign's, on seeded numpy inputs: ``l2_normalize``,
``cosine_similarity_matrix``, ``topk_similarity_search``
(``ops/similarity.py``), ``sharded_topk_search`` without a mesh
(``parallel/retrieval.py``) and the module-level ``tokenize``.

Tolerances: float32 results within 1e-6 absolute (the norm and the
products are summed in another order); indices and token ids equal."""

import numpy as np
import pytest
import torch

import tpualign.ops as jax_ops
from tpualign.ops.similarity import topk_similarity_search as jax_topk_search
from tpualign.parallel import sharded_topk_search as jax_sharded
from tpualign.tokenizer import tokenize as jax_tokenize
from tpualign_torch import ops as torch_ops
from tpualign_torch.ops.similarity import topk_similarity_search
from tpualign_torch.parallel import sharded_topk_search
from tpualign_torch.tokenizer import tokenize

pytestmark = pytest.mark.fast


def _rows(rng, n, d, scale=1.0):
    return (rng.normal(size=(n, d)) * scale).astype(np.float32)


@pytest.mark.parametrize("axis", [-1, 0])
def test_l2_normalize_matches_tpualign(axis):
    rng = np.random.default_rng(0)
    x = _rows(rng, 7, 33, scale=3.0)
    x[2] = 0.0                      # the eps floor
    want = np.asarray(jax_ops.l2_normalize(x, axis=axis))
    got = torch_ops.l2_normalize(torch.from_numpy(x), axis=axis).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("normalized,dtype", [(True, "float32"), (False, "float32"),
                                              (True, "bfloat16")])
def test_cosine_similarity_matrix_matches_tpualign(normalized, dtype):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    q, c = _rows(rng, 9, 64, 2.0), _rows(rng, 31, 64, 2.0)
    if normalized:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        c /= np.linalg.norm(c, axis=1, keepdims=True)
    want = np.asarray(jax_ops.cosine_similarity_matrix(
        q, c, normalized=normalized, compute_dtype=getattr(jnp, dtype)))
    got = torch_ops.cosine_similarity_matrix(
        torch.from_numpy(q), torch.from_numpy(c), normalized=normalized,
        compute_dtype=getattr(torch, dtype))
    assert got.dtype == torch.float32 and got.shape == (9, 31)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 5, 31])
def test_topk_similarity_search_matches_tpualign(k):
    rng = np.random.default_rng(2)
    q, c = _rows(rng, 6, 48), _rows(rng, 31, 48)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    mask = rng.random((6, 31)) < 0.5
    mask[3] = False                 # a query without candidates
    wv, wi = (np.asarray(a) for a in jax_topk_search(q, c, mask, k))
    gv, gi = topk_similarity_search(torch.from_numpy(q), torch.from_numpy(c),
                                    torch.from_numpy(mask), k)
    live = wv > -1e29
    np.testing.assert_array_equal(gi.numpy()[live], wi[live])
    np.testing.assert_allclose(gv.numpy(), wv, rtol=0, atol=1e-6)


def test_masked_topk_is_exported():
    from tpualign_torch.ops.similarity import masked_topk

    assert torch_ops.masked_topk is masked_topk


@pytest.mark.parametrize("k", [3, 40])
def test_sharded_topk_search_without_a_mesh_matches_tpualign(k):
    rng = np.random.default_rng(3)
    q, c = _rows(rng, 12, 32), _rows(rng, 30, 32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    qk = rng.integers(0, 4, 12).astype(np.int32)
    ck = rng.integers(0, 4, 30).astype(np.int32)
    qk[0], qk[1] = -3, 99           # a wildcard query, a query without candidates
    wv, wi = jax_sharded(q, qk, c, ck, k)
    gv, gi = sharded_topk_search(q, qk, c, ck, k, device="cpu")
    assert gv.shape == gi.shape == (12, k)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)


def test_sharded_topk_search_refuses_a_mesh():
    """A mesh that is not the port's (tpualign's JAX mesh, or any other
    object) is refused; the port's meshes: tests/test_torch_parallel.py."""
    from tpualign.parallel.mesh import create_mesh as jax_create_mesh

    for mesh in (object(), jax_create_mesh(2, 1)):
        with pytest.raises(TypeError, match="tpualign_torch Mesh"):
            sharded_topk_search(np.zeros((1, 4), np.float32), np.zeros(1, np.int32),
                                np.zeros((2, 4), np.float32), np.zeros(2, np.int32), 1,
                                mesh=mesh, device="cpu")


@pytest.mark.parametrize("texts,context", [
    (["replace the oil filter", "", "Het oliefilter vervangen (fig. 3)"], 77),
    ("one text, not a list", 77),
    (["a long manual step " * 40], 77),   # truncated, EOT forced last
    (["torque the drain bolt to 25 Nm"], 16),
])
def test_tokenize_matches_tpualign(texts, context):
    got = tokenize(texts, context_length=context)
    want = jax_tokenize(texts, context_length=context)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
