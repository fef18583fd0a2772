"""tpualign_torch's RetrievalIndex and encode_keys against the JAX
package's, on the CPU: identical indices (ties and sentinels included),
values within 1e-6."""

import numpy as np
import pytest

import torch

from tpualign.parallel.retrieval import RetrievalIndex as JaxIndex
from tpualign.parallel.retrieval import encode_keys as jax_encode_keys
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.parallel.retrieval import RetrievalIndex, encode_keys

pytestmark = pytest.mark.fast

MANUALS = ["m-b", "m-a", "m-c"]


def _corpus(seed=0, n=300, d=32, dup=12):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[-dup:] = emb[:dup]                     # exact ties
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    manuals = [MANUALS[i] for i in rng.integers(0, 3, n)]
    pages = [None if p == 5 else int(p) for p in rng.integers(0, 6, n)]
    return emb, manuals, pages


def _queries(seed=1, q=40, d=32):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(q, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    manuals = [MANUALS[i] for i in rng.integers(0, 3, q)]
    manuals[3] = "m-unknown"                   # no candidates
    pages = [None if p == 5 else int(p) for p in rng.integers(0, 6, q)]
    return emb, manuals, pages


@pytest.fixture(scope="module")
def indexes():
    emb, manuals, pages = _corpus()
    return (RetrievalIndex(emb, manuals, pages, device="cpu"),
            JaxIndex(emb, manuals, pages))


def _assert_same(got, want):
    (vals, idx), (jvals, jidx) = got, want
    assert idx.dtype == np.int64 and vals.dtype == np.float32
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(vals, jvals, atol=1e-6)


def test_encode_keys_matches_jax():
    manuals = ["b", "a", "b", "c", "a"]
    pages = [3, None, 0, 99_998, 7]
    vocab, jvocab = {"z": 0}, {"z": 0}
    keys, vocab = encode_keys(manuals, pages, vocab)
    jkeys, jvocab = jax_encode_keys(manuals, pages, jvocab)
    np.testing.assert_array_equal(keys, jkeys)
    assert keys.dtype == np.int32 and vocab == jvocab
    empty, _ = encode_keys([], [])
    assert empty.shape == (0,) and empty.dtype == np.int32
    for bad in (-1, 100_000, 10**6):
        with pytest.raises(ValueError, match="outside the encodable range"):
            encode_keys(["a"], [bad])
        with pytest.raises(ValueError, match="outside the encodable range"):
            jax_encode_keys(["a"], [bad])


@pytest.mark.parametrize("k", [1, 10, 100])
def test_keyed_search_matches_jax(indexes, k):
    port, ref = indexes
    q, manuals, pages = _queries()
    got = port.search(q, manuals, pages, k=k)
    _assert_same(got, ref.search(q, manuals, pages, k=k))
    vals, idx = got
    assert (idx[3] == -1).all() and (vals[3] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("k", [10, 100, 150, 400])
def test_global_search_matches_jax(indexes, k):
    """k=150 takes the port's dense route (k > 128); k=400 > n pads."""
    port, ref = indexes
    q, _, _ = _queries(seed=2)
    got = port.search(q, k=k, global_search=True)
    _assert_same(got, ref.search(q, k=k, global_search=True))
    assert got[1].shape == (len(q), k)


def test_ties_rank_by_ascending_index(indexes):
    port, ref = indexes
    emb, _, _ = _corpus()
    got = port.search(emb[:4], k=5, global_search=True)
    _assert_same(got, ref.search(emb[:4], k=5, global_search=True))
    for r in range(4):                 # row r and its duplicate 288 + r
        assert got[1][r, :2].tolist() == [r, 288 + r]


def test_search_encoded_and_device(indexes):
    port, ref = indexes
    q, _, _ = _queries(seed=3, q=7)
    qk = np.full(7, WILDCARD_KEY, np.int32)
    qk[0] = -2
    _assert_same(port.search_encoded(q, qk, 10), ref.search_encoded(q, qk, 10))
    vals, idx = port.search_device(torch.from_numpy(q), torch.from_numpy(qk), 10)
    assert vals.shape == (7, 10) and idx.dtype == torch.int32


def test_empty_corpus_and_queries():
    port = RetrievalIndex(np.zeros((0, 8), np.float32), [], [], device="cpu")
    vals, idx = port.search(np.ones((2, 8), np.float32), ["a", "a"], [1, 1], k=3)
    assert (idx == -1).all() and vals.shape == (2, 3)
    emb, manuals, pages = _corpus(n=20)
    port = RetrievalIndex(emb, manuals, pages, device="cpu")
    vals, idx = port.search(np.zeros((0, 32), np.float32), [], [], k=4)
    assert vals.shape == (0, 4) and idx.shape == (0, 4)


def test_deferred_options_raise():
    """A mesh, the mesh strategies and the index mutations are later
    slices; precision, recall_target, refine and refine_store now work
    (tests/test_torch_quant.py)."""
    emb, manuals, pages = _corpus(n=20)
    with pytest.raises(NotImplementedError, match="mesh"):
        RetrievalIndex(emb, manuals, pages, device="cpu", mesh=object())
    for kw in ({"precision": "int8"}, {"precision": "int4"}, {"recall_target": 0.9},
               {"refine": 4, "precision": "int2"}, {"refine_store": "ram"}):
        RetrievalIndex(emb, manuals, pages, device="cpu", **kw)
    with pytest.raises(ValueError, match="precision"):
        RetrievalIndex(emb, manuals, pages, precision="fp16", device="cpu")
    port = RetrievalIndex(emb, manuals, pages, device="cpu", refine=1)
    with pytest.raises(NotImplementedError, match="mesh"):
        port.search(emb[:2], k=3, strategy="ring")
    with pytest.raises(ValueError, match="strategy"):
        port.search(emb[:2], k=3, strategy="bogus")
    for call in (lambda: port.add(emb[:1]), lambda: port.remove([0]), port.compact):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            call()
