"""The port's quantized search against the JAX package's, on the CPU: the
quantizers (bit-identical codes and scales), K3's plain version against
JAX's masked_sim_topk over quantized corpora (Pallas, interpret mode), and
RetrievalIndex/build_index at int8/int4/int2 with refine, recall_target and
every refine store mode."""

import logging
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_pallas import make
from tpualign.ops.pallas_kernels import masked_sim_topk as jax_sim_topk
from tpualign.parallel import retrieval as jax_retrieval
from tpualign_torch.ops.sim_topk import (
    SENTINEL_IDX, masked_sim_topk, masked_sim_topk_reference, quant_variant, quantize_queries)
from tpualign_torch.ops.similarity import NEG_INF, WILDCARD_KEY
from tpualign_torch.parallel import retrieval as port_retrieval

pytestmark = pytest.mark.fast

QUANTIZERS = ("_quantize_rows", "_quantize_rows_int4", "_quantize_rows_int2")
# (name, port quantizer, int8_mxu)
VARIANTS = [("s8", "_quantize_rows", True), ("dequant", "_quantize_rows", False),
            ("int4", "_quantize_rows_int4", True), ("int2", "_quantize_rows_int2", True)]
MANUALS = ["m-b", "m-a", "m-c"]


@pytest.mark.parametrize("name", QUANTIZERS)
@pytest.mark.parametrize("d", [8, 64, 512])
def test_quantizers_bit_identical(name, d):
    rng = np.random.default_rng(d)
    x = rng.normal(size=(97, d)).astype(np.float32)
    x[3] = 0.0                              # an all-zero row: the 1e-12 floor
    x[5, : d // 2] = 0.5                    # exact ties in the row maximum
    got, want = getattr(port_retrieval, name)(x), getattr(jax_retrieval, name)(x)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,d", [("_quantize_rows_int4", 7), ("_quantize_rows_int2", 6),
                                    ("_quantize_rows_int2", 9)])
def test_quantizers_reject_dims(name, d):
    x = np.ones((3, d), np.float32)
    for module in (port_retrieval, jax_retrieval):
        with pytest.raises(ValueError, match="dim"):
            getattr(module, name)(x)


def test_query_quantization_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(40, 64)).astype(np.float32)
    q[2] = 0.0
    q[4] = np.linspace(-1, 1, 64, dtype=np.float32) * 127 / 2   # x.5 after scaling: ties
    qq, qs = quantize_queries(torch.from_numpy(q))
    jq = jnp.asarray(q)
    jqs = jnp.maximum(jnp.max(jnp.abs(jq), axis=1, keepdims=True) / 127.0, 1e-12)
    jqq = jnp.clip(jnp.rint(jq / jqs), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(qq.numpy(), np.asarray(jqq))
    np.testing.assert_array_equal(qs.numpy(), np.asarray(jqs)[:, 0])


def _k3_inputs(seed, q, n, d, groups):
    rng = np.random.default_rng(seed)
    qv, qk, cv, ck = make(rng, q, n, d, groups)
    cv[n - 6:] = cv[:6]                     # duplicated rows: exact ties
    qk[::5] = WILDCARD_KEY
    qk[2::7] = 10**6                        # no candidates
    return qv, qk, cv, ck


@pytest.mark.parametrize("variant,quantizer,mxu", VARIANTS)
@pytest.mark.parametrize("k", [5, 40])
def test_k3_plain_matches_jax_kernel(variant, quantizer, mxu, k):
    qv, qk, cv, ck = _k3_inputs(k, 29, 333, 64, 3)
    codes, scales = getattr(port_retrieval, quantizer)(cv)
    t = [torch.from_numpy(a) for a in (qv, qk, codes, ck)]
    assert quant_variant(t[2], 64, torch.from_numpy(scales), mxu) == variant
    vals, idx = masked_sim_topk(*t, k, corpus_scales=torch.from_numpy(scales), int8_mxu=mxu)
    jv, ji = jax_sim_topk(*(jnp.asarray(a) for a in (qv, qk, codes, ck)), k, block_q=8,
                          block_n=128, corpus_scales=jnp.asarray(scales), int8_mxu=mxu)
    vals, idx, jv, ji = (np.asarray(a) for a in (vals, idx, jv, ji))
    has = jv > NEG_INF / 2
    np.testing.assert_array_equal(vals > NEG_INF / 2, has)
    assert (idx[~has] == SENTINEL_IDX).all() and (vals[~has] == np.float32(NEG_INF)).all()
    assert (~has[2::7]).all() and has[::5].all()
    if variant == "dequant":
        # fp32 products in another summation order: indices may swap only
        # inside runs of values within 1e-6 of each other
        np.testing.assert_allclose(vals[has], jv[has], atol=1e-6)
        close = np.abs(np.diff(jv, axis=1)) <= 1e-6
        near = np.zeros(has.shape, bool)
        near[:, 1:] |= close
        near[:, :-1] |= close
        np.testing.assert_array_equal(idx[has & ~near], ji[has & ~near])
    else:
        np.testing.assert_array_equal(idx[has], ji[has])
        np.testing.assert_array_equal(vals[has], jv[has])


def test_k3_rejects_bad_packing():
    c = torch.zeros(5, 3, dtype=torch.uint8)
    args = (torch.zeros(2, 8), torch.zeros(2, dtype=torch.int32), c,
            torch.zeros(5, dtype=torch.int32), 3)
    with pytest.raises(ValueError, match="packed corpus"):
        masked_sim_topk(*args, corpus_scales=torch.ones(5))
    with pytest.raises(TypeError, match="int8 or packed"):
        masked_sim_topk(torch.zeros(2, 8), args[1], torch.zeros(5, 8), args[3], 3,
                        corpus_scales=torch.ones(5))


def test_k3_reference_is_the_kernels_plain_version():
    """The wrapper on CPU tensors returns the reference, launching nothing."""
    from tpualign_torch.ops.sim_topk import masked_sim_topk_quant

    qv, qk, cv, ck = _k3_inputs(0, 9, 100, 32, 2)
    codes, scales = port_retrieval._quantize_rows_int2(cv)
    t = [torch.from_numpy(a) for a in (qv, qk, codes, ck)]
    before = masked_sim_topk_quant.launches
    got = masked_sim_topk(*t, 7, corpus_scales=torch.from_numpy(scales))
    want = masked_sim_topk_reference(*t, 7, corpus_scales=torch.from_numpy(scales))
    assert masked_sim_topk_quant.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _corpus(seed=0, n=400, d=32, dup=10):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(n, d)).astype(np.float32)
    emb[-dup:] = emb[:dup]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    manuals = [MANUALS[i] for i in rng.integers(0, 3, n)]
    pages = [None if p == 3 else int(p) for p in rng.integers(0, 4, n)]
    return emb, manuals, pages


def _queries(seed=1, q=24, d=32):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(q, d)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    manuals = [MANUALS[i] for i in rng.integers(0, 3, q)]
    manuals[2] = "m-unknown"
    pages = [None if p == 3 else int(p) for p in rng.integers(0, 4, q)]
    return emb, manuals, pages


@pytest.fixture(scope="module")
def corpus():
    return _corpus()


def _both(corpus, **kw):
    emb, manuals, pages = corpus
    return (port_retrieval.build_index(emb, manuals, pages, device="cpu", **kw),
            jax_retrieval.build_index(emb, manuals, pages, **kw))


# Inside jit, XLA rewrites tpualign's query scale max|q| / 127 as
# max|q| * fl(1/127), one ulp off the division for some rows; the port
# divides, as tpualign's kernel path writes it (and computes it eagerly).
# So first-stage values may differ by an ulp or two of the scale; indices
# agree, and refined values, rescored exactly, are bit-identical.
SCALE_ULPS = 2.5e-7


def _same(got, want, refined=True):
    (v, i), (jv, ji) = got, want
    assert i.dtype == np.int64 and v.dtype == np.float32 and v.shape == jv.shape
    np.testing.assert_array_equal(i, ji)
    if refined:
        np.testing.assert_array_equal(v, jv)
    else:
        np.testing.assert_allclose(v, jv, rtol=SCALE_ULPS, atol=0)


@pytest.mark.parametrize("precision", ["int8", "int4", "int2"])
@pytest.mark.parametrize("refine", [0, 4])
@pytest.mark.parametrize("recall_target", [None, 0.9])
def test_index_matches_jax(corpus, precision, refine, recall_target):
    port, ref = _both(corpus, precision=precision, refine=refine, recall_target=recall_target)
    assert port.refine == ref.refine
    q, manuals, pages = _queries()
    q[7] *= 3.0                      # unnormalised rows, as the serving path may send
    refined = refine > 1
    for k in (5, 10):
        _same(port.search(q, manuals, pages, k=k), ref.search(q, manuals, pages, k=k), refined)
        _same(port.search(q, k=k, global_search=True), ref.search(q, k=k, global_search=True),
              refined)
    vals, idx = port.search(q, manuals, pages, k=5)
    assert (idx[2] == -1).all() and (vals[2] == np.float32(NEG_INF)).all()


@pytest.mark.parametrize("precision", ["int8", "int2"])
def test_index_dense_route_matches_jax(corpus, precision):
    """k=150 > 128 takes the port's dense route (the plain version in
    slabs); refine 2 over-fetches 300 of the 400 rows."""
    q, _, _ = _queries(seed=4, q=9)
    for refine in (0, 2):
        port, ref = _both(corpus, precision=precision, refine=refine)
        _same(port.search(q, k=150, global_search=True), ref.search(q, k=150, global_search=True),
              refine > 1)


@pytest.mark.parametrize("store", ["ram", "fp16", "memmap", "memmap16"])
def test_refine_store_modes_match_jax(corpus, store, tmp_path, monkeypatch):
    monkeypatch.setenv("RETRIEVAL_REFINE_DIR", str(tmp_path))
    port, ref = _both(corpus, precision="int4", refine=4, refine_store=store)
    assert port._refine_corpus.mode == ref._refine_corpus.mode == store
    resident = port._refine_corpus.nbytes_resident
    assert resident == (0 if store.startswith("memmap") else ref._refine_corpus.nbytes_resident)
    q, manuals, pages = _queries(seed=5)
    _same(port.search(q, manuals, pages, k=10), ref.search(q, manuals, pages, k=10))
    if store.startswith("memmap"):
        assert any(f.startswith(f"tpualign_refine_{os.getpid()}_") for f in os.listdir(tmp_path))


def test_refine_store_auto_and_knob(corpus, monkeypatch):
    monkeypatch.setattr(port_retrieval, "REFINE_RAM_MAX_BYTES", 1000)
    emb, manuals, pages = corpus
    index = port_retrieval.RetrievalIndex(emb, manuals, pages, precision="int8", refine=3,
                                          device="cpu")
    assert index._refine_corpus.mode == "memmap"       # auto, above the RAM bound
    monkeypatch.setenv("RETRIEVAL_REFINE_STORE", "fp16")
    index = port_retrieval.RetrievalIndex(emb, manuals, pages, precision="int8", refine=3,
                                          device="cpu")
    assert index._refine_corpus.mode == "fp16"
    with pytest.raises(ValueError, match="refine store"):
        port_retrieval.RetrievalIndex(emb, manuals, pages, refine_store="disk", device="cpu")
    with pytest.raises(ValueError, match="refine must be"):
        port_retrieval.RetrievalIndex(emb, manuals, pages, refine=-1, device="cpu")


def test_stale_refine_memmaps_are_swept(tmp_path, monkeypatch):
    """A memmap whose creating process is dead is removed at the first
    build in its directory; a live process's file and foreign files stay."""
    dead = tmp_path / "tpualign_refine_999999999_x.f32"
    live = tmp_path / f"tpualign_refine_{os.getppid()}_y.f32"
    other = tmp_path / "unrelated.f32"
    for f in (dead, live, other):
        f.write_bytes(b"0" * 16)
    monkeypatch.setenv("RETRIEVAL_REFINE_DIR", str(tmp_path))
    monkeypatch.setattr(port_retrieval, "_swept_refine_dirs", set())
    emb, manuals, pages = _corpus(n=30)
    port_retrieval.RetrievalIndex(emb, manuals, pages, precision="int8", refine=2,
                                  refine_store="ram", device="cpu")
    assert not dead.exists() and live.exists() and other.exists()


def test_refine_on_fp32_warns_and_disables(corpus):
    """Both packages turn refine off on an exact fp32 index (no rescore
    copy), and return the unrefined results."""
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("tpualign_torch.parallel.retrieval")
    logger.addHandler(handler)
    try:
        port, ref = _both(corpus, refine=4)
    finally:
        logger.removeHandler(handler)
    assert port.refine == ref.refine == 0
    assert port._refine_corpus is None and ref._refine_corpus is None
    assert any("refine=4" in r.getMessage() and "disabling" in r.getMessage() for r in records)
    q, manuals, pages = _queries()
    _same_fp32(port.search(q, manuals, pages, k=10), ref.search(q, manuals, pages, k=10))
    # recall_target keeps the factor: an over-fetch of exactly scored rows
    port, ref = _both(corpus, refine=4, recall_target=0.95)
    assert port.refine == ref.refine == 4 and port._refine_corpus is None
    _same_fp32(port.search(q, k=10, global_search=True),
               ref.search(q, k=10, global_search=True))


def _same_fp32(got, want):
    """fp32 products sum in another order than XLA's: values within 1e-6,
    indices identical (this corpus has no near-ties closer than that)."""
    (v, i), (jv, ji) = got, want
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(v, jv, atol=1e-6)


def test_later_slices_raise(corpus):
    """The sharded IVF index builds on a mesh (tests/test_torch_ivf_sharded.py;
    the exact index shards: tests/test_torch_parallel.py); IVF
    (tests/test_torch_ivf.py) and HNSW
    (tests/test_torch_hnsw.py) are ported: HNSW builds its host graph, or
    says that it needs the native library."""
    from tpualign_torch.parallel import create_mesh

    from tpualign_torch.native import native_available

    emb, manuals, pages = corpus
    if native_available():
        index = port_retrieval.build_index(emb, manuals, pages, index_type="hnsw", device="cpu")
        assert type(index).__name__ == "HNSWIndex" and index.n == len(emb)
    else:
        with pytest.raises(RuntimeError, match="native library"):
            port_retrieval.build_index(emb, manuals, pages, index_type="hnsw", device="cpu")
    mesh = create_mesh(2, devices=["cpu"] * 2)
    sharded = port_retrieval.build_index(emb, manuals, pages, mesh=mesh, index_type="ivf")
    assert type(sharded).__name__ == "IVFIndex" and sharded.mesh is mesh
    assert len(sharded._ids.parts) == 2 and sharded.n == len(emb)
    exact = port_retrieval.build_index(emb, manuals, pages, mesh=mesh, precision="int8")
    assert exact.mesh is mesh and exact._n_local == len(emb) // 2
    with pytest.raises(ValueError, match="retrieval_index"):
        port_retrieval.build_index(emb, manuals, pages, index_type="flat", device="cpu")
    # an empty corpus serves the exact index under RETRIEVAL_INDEX=ivf
    empty = port_retrieval.build_index(np.zeros((0, 32), np.float32), [], [],
                                       index_type="ivf", device="cpu")
    assert empty.search(emb[:2], k=3)[1].tolist() == [[-1] * 3] * 2


def test_skip_vals_fetches_indices_only(corpus):
    """With a rescore corpus the first stage's values are synthesised from
    the indices; the refined results are the same either way."""
    emb, manuals, pages = corpus
    index = port_retrieval.RetrievalIndex(emb, manuals, pages, precision="int2", refine=4,
                                          device="cpu")
    q, _, _ = _queries(seed=6)
    qk = np.full(len(q), WILDCARD_KEY, np.int32)
    qk[0] = -2
    v, i = index._search_encoded_raw(q, qk, 40, skip_vals=True)
    v_full, i_full = index._search_encoded_raw(q, qk, 40)
    np.testing.assert_array_equal(i, i_full)
    assert (v[i >= 0] == 0).all() and (v[i < 0] == np.float32(NEG_INF)).all()
    a = port_retrieval._refine_rescore(q, v, i, index._refine_corpus, 10)
    b = port_retrieval._refine_rescore(q, v_full, i_full, index._refine_corpus, 10)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
