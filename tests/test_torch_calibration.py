"""tpualign_torch's weak-score calibration against tpualign's, bit for bit:
``fit_isotonic`` (PAV with tie pre-pooling), ``apply_calibration``,
``calibrate_schema`` (dry run and ``--write``) on a seeded store, and the
``calibrate`` command's printout and exit codes."""

import shutil

import numpy as np
import pytest

import tpualign.cli as jax_cli
import tpualign_torch.cli as torch_cli
from tpualign.store import EmbeddingStore as JaxStore
from tpualign.weaksup import calibration as jax_cal
from tpualign_torch.store import EmbeddingStore
from tpualign_torch.weaksup import calibration as cal

pytestmark = pytest.mark.fast

D = 16


def _fit_inputs(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "empty":
        return np.zeros(0), np.zeros(0)
    if case == "one":
        return np.array([0.4]), np.array([0.2])
    if case == "constant_x":
        return np.full(50, 0.3), rng.normal(size=50)
    if case == "ties":  # weak scores on a coarse grid, noisy cosines
        x = rng.integers(0, 12, size=400) / 11.0
        return x, 0.1 + 0.2 * x + rng.normal(scale=0.15, size=400)
    if case == "decreasing":  # everything pools into one block
        x = rng.random(120)
        return x, 1.0 - x
    x = rng.random(300).astype(np.float32)  # float32 scores, as the store holds them
    return x, np.sin(3 * x) + rng.normal(scale=0.3, size=300)


@pytest.mark.parametrize("case", ["empty", "one", "constant_x", "ties", "decreasing", "noisy"])
def test_fit_and_apply_equal_tpualigns(case):
    x, y = _fit_inputs(case)
    got, want = cal.fit_isotonic(x, y), jax_cal.fit_isotonic(x, y)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert np.all(np.diff(got[1]) >= 0)
    probe = np.linspace(-0.2, 1.2, 57)
    for knots in (got, (np.zeros(0), np.zeros(0))):
        a, b = cal.apply_calibration(probe, knots), jax_cal.apply_calibration(probe, knots)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)
    if len(x):  # PAV keeps the sum of the fitted values over the pairs
        fitted = np.interp(np.asarray(x, np.float64), *got)
        assert fitted.sum() == pytest.approx(np.sum(y), rel=1e-9)


def _write_store(root, schema="clip_combined"):
    rng = np.random.default_rng(4)
    n_img, n_chunk = 40, 160
    store = JaxStore(root, embed_dim=D)
    store.setup([schema, "vanilla_clip"])
    img = rng.normal(size=(n_img, D)).astype(np.float32)
    chunk = rng.normal(size=(n_chunk, D)).astype(np.float32)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    chunk /= np.linalg.norm(chunk, axis=1, keepdims=True)
    store.insert_images(schema, [{"image_id": f"i{j}", "manual_id": f"m{j % 4}", "page": j % 5}
                                 for j in range(n_img)], img)
    store.insert_chunks(schema, [{"chunk_id": f"c{c}", "manual_id": f"m{c % 4}", "page": c % 5,
                                  "text": f"chunk {c}"} for c in range(n_chunk)], chunk)
    aligns = [(f"i{j}", f"c{c}", float(rng.integers(0, 9) / 8), "combined")
              for j in range(n_img) for c in rng.choice(n_chunk, 6, replace=False)]
    aligns += [("i_gone", "c1", 0.5, "combined"), ("i1", "c_gone", 0.25, "combined")]
    store.insert_alignments(schema, aligns)
    store.save()
    return root


@pytest.fixture
def two_stores(tmp_path):
    src = _write_store(tmp_path / "src")
    shutil.copytree(src, tmp_path / "port")
    shutil.copytree(src, tmp_path / "jax")
    return tmp_path / "port", tmp_path / "jax"


@pytest.mark.parametrize("write", [False, True])
def test_calibrate_schema_equals_tpualigns(two_stores, write):
    port_root, jax_root = two_stores
    got = cal.calibrate_schema(EmbeddingStore(port_root, embed_dim=D), "clip_combined", write)
    want = jax_cal.calibrate_schema(JaxStore(jax_root, embed_dim=D), "clip_combined", write)
    assert got.keys() == want.keys()
    for g, w in zip(got["knots"], want["knots"]):
        assert np.array_equal(g, w)
    assert (got["n_pairs"], got["raw_range"], got["calibrated_range"]) == (
        want["n_pairs"], want["raw_range"], want["calibrated_range"])
    assert got["n_pairs"] == 40 * 6  # the two pairs without embeddings are left out
    rows = {}
    for name, root in (("port", port_root), ("jax", jax_root)):
        # each package reads the other's writes: the store format is one
        rows[name] = (EmbeddingStore(root, embed_dim=D).alignments("clip_combined"),
                      JaxStore(root, embed_dim=D).alignments("clip_combined"))
        assert rows[name][0] == rows[name][1]
    assert rows["port"] == rows["jax"]
    src = JaxStore(port_root.parent / "src", embed_dim=D).alignments("clip_combined")
    assert (rows["port"][0] != src) == write
    if write:  # the calibrated scores are monotone in the raw ones
        raw = {(a, b): s for a, b, s, _ in src}
        new = {(a, b): s for a, b, s, _ in rows["port"][0] if (a, b) in raw
               and not a.endswith("gone") and not b.endswith("gone")}
        pairs = sorted(new, key=lambda p: raw[p])
        assert all(new[p] <= new[q] for p, q in zip(pairs, pairs[1:]) if raw[p] < raw[q])


def test_calibrate_cli_equals_tpualigns(two_stores, tmp_path, monkeypatch, capsys):
    port_root, jax_root = two_stores
    out = {}
    for name, main, root in (("port", torch_cli.main, port_root), ("jax", jax_cli.main, jax_root)):
        monkeypatch.setenv("STORE_DIR", str(root))
        lines = []
        for argv in (["calibrate"], ["calibrate", "--write"],
                     ["calibrate", "--schema", "vanilla_clip"]):
            code = main(argv + ["--env-file", ""])
            lines.append((code, capsys.readouterr().out))
        out[name] = lines
    assert out["port"] == out["jax"]
    codes = [code for code, _ in out["port"]]
    assert codes == [0, 0, 1]
    assert "(dry run; --write to persist)" in out["port"][0][1]
    assert out["port"][1][1].rstrip().endswith("(written)")
    assert out["port"][2][1] == "no alignments in schema vanilla_clip\n"
