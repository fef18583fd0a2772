"""tpualign_torch's native library against tpualign's: the same C++ source,
the same bindings, and callers that take the same path (native, else
Python) with the same results.

tpualign's bindings are run over the port's library (``jax_native``):
tpualign's ``build`` is patched to return the port's built path, so its
own ``_load`` sets its own argtypes on it and nothing is written into
``tpualign/native/``. The tests skip only where g++ is missing; a build
that fails with g++ present fails them.
"""

import filecmp
import itertools
import os
import random
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest

import tpualign.native.bindings as jax_bindings
import tpualign.native.build as jax_build
import tpualign_torch.native.bindings as torch_bindings
from tpualign_torch.native import build as torch_build

pytestmark = [pytest.mark.fast,
              pytest.mark.skipif(shutil.which("g++") is None, reason="needs g++")]

REPO = Path(__file__).resolve().parent.parent
# the edges where the two lexical paths part: an empty term, a NUL inside a
# text, case folding beyond ASCII
LEX_TEXTS = ["Het oliefilter vervangen", "abc\x00filter", "ÉÉN filter", "",
             "Verwijder de filterdeksel en de schroef", "De POMP werkt", "niets",
             "ünïcode filter ✓", "filter filter filter"]
LEX_TERMS = ["", "filter", "één", "pomp", "schroef", "deksel", "ünïcode"]


@pytest.fixture
def jax_native(monkeypatch):
    """tpualign's bindings loaded over the port's library."""
    path = torch_build.build()
    assert path is not None, "g++ is present but the port's native build failed"
    monkeypatch.setattr(jax_build, "build", lambda force=False: path)
    monkeypatch.setattr(jax_bindings, "_TRIED", False)
    monkeypatch.setattr(jax_bindings, "_LIB", None)
    assert jax_bindings.native_available() and torch_bindings.native_available()
    return path


@pytest.fixture
def python_paths(monkeypatch):
    """Both packages without their native library: the Python fallbacks."""
    for mod in (jax_bindings, torch_bindings):
        monkeypatch.setattr(mod, "_TRIED", True)
        monkeypatch.setattr(mod, "_LIB", None)


@pytest.fixture(params=["native", "python"])
def path(request):
    request.getfixturevalue("jax_native" if request.param == "native" else "python_paths")
    return request.param


def test_cpp_source_is_tpualigns():
    assert filecmp.cmp(REPO / "tpualign/native/tpualign_native.cpp",
                       REPO / "tpualign_torch/native/tpualign_native.cpp", shallow=False)


def test_lexical_counts_match_tpualign_on_each_path(path):
    from tpualign.weaksup.lexical import lexical_match_counts as jax_counts
    from tpualign_torch.weaksup.lexical import lexical_match_counts

    got = lexical_match_counts(LEX_TEXTS, LEX_TERMS)
    np.testing.assert_array_equal(got, jax_counts(LEX_TEXTS, LEX_TERMS))
    assert got.dtype == np.int32
    # the measured disagreement between the paths, on the first three texts
    edge = lexical_match_counts(LEX_TEXTS[:3], ["", "filter", "één"]).tolist()
    assert edge == ([1, 0, 2] if path == "native" else [2, 2, 3])


def test_lexical_scores_match_tpualign(path):
    from tpualign.weaksup.lexical import lexical_scores as jax_scores
    from tpualign_torch.weaksup.lexical import lexical_scores

    rng = random.Random(3)
    words = ["filter", "pomp", "olie", "bout", "moer", "klep", "riem", "lager"]
    texts = [" ".join(rng.choice(words) for _ in range(rng.randint(0, 9))) for _ in range(200)]
    terms = words[:5] + ["ilt", "x"]
    np.testing.assert_array_equal(lexical_scores(texts, terms), jax_scores(texts, terms))


def test_bindings_lexical_counts_equal(jax_native):
    texts = [t * 3 for t in LEX_TEXTS]
    np.testing.assert_array_equal(torch_bindings.lexical_counts(texts, LEX_TERMS),
                                  jax_bindings.lexical_counts(texts, LEX_TERMS))


@pytest.mark.parametrize("k", [1, 5, 12, 20])
def test_topk_merge_matches_tpualign(jax_native, k):
    rng = np.random.default_rng(k)
    vals = rng.integers(0, 6, size=(7, 12)).astype(np.float32) / 4  # many ties
    idx = rng.permutation(100)[:84].reshape(7, 12).astype(np.int64)
    got = torch_bindings.topk_merge(vals, idx, k)
    want = jax_bindings.topk_merge(vals, idx, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    order = np.lexsort((idx, -vals), axis=1)[:, :min(k, 12)]
    np.testing.assert_array_equal(got[1][:, :min(k, 12)], np.take_along_axis(idx, order, 1))
    if k > 12:
        assert (got[1][:, 12:] == -1).all() and (got[0][:, 12:] <= -1e29).all()


def test_topk_merge_is_none_without_the_library(python_paths):
    assert torch_bindings.topk_merge(np.zeros((1, 2), np.float32),
                                     np.zeros((1, 2), np.int64), 1) is None
    assert torch_bindings.lexical_counts(["a"], ["a"]) is None
    assert torch_bindings.make_bpe_core([0], [1], [2]) is None
    assert torch_bindings.make_hnsw_core(4, 16, 64, 0) is None
    assert not torch_bindings.native_available()


def _synthetic_merges(tmp_path) -> str:
    letters = "abcdefgh"
    pairs = list(itertools.product(letters, repeat=2))
    random.Random(0).shuffle(pairs)
    merges = [f"{a} {b}" for a, b in pairs[:20]]
    merges += [f"{a}{b} {c}</w>" for (a, b), c in zip(pairs[:5], letters)]
    merges += ["l o", "lo w</w>", "e r</w>", "w o", "wo r", "wor ld</w>", "l d</w>"]
    p = tmp_path / "merges.txt"
    p.write_text("#version: t\n" + "\n".join(merges))
    return str(p)


def test_bpe_core_matches_tpualign_and_python(jax_native, tmp_path):
    from tpualign.tokenizer.bpe import ClipTokenizer as JaxTokenizer
    from tpualign_torch.tokenizer.bpe import ClipTokenizer

    merges = _synthetic_merges(tmp_path)
    tok, jax_tok = ClipTokenizer(bpe_path=merges), JaxTokenizer(bpe_path=merges)
    assert tok._bpe_core is not None and jax_tok._bpe_core is not None
    rng = random.Random(1)
    for _ in range(300):
        word = "".join(rng.choice("abcdefghlowr") for _ in range(rng.randint(1, 12)))
        btoken = "".join(tok.byte_encoder[b] for b in word.encode())
        syms = [tok.encoder[c] for c in btoken[:-1]] + [tok.encoder[btoken[-1] + "</w>"]]
        python_ids = [tok.encoder[t] for t in tok.bpe(btoken).split(" ")]
        if len(syms) > 1:
            assert tok._bpe_core.word(syms) == jax_tok._bpe_core.word(syms) == python_ids, word
        assert tok._encode_token_ids(btoken) == python_ids, word


def test_tokenizer_ids_match_tpualign_on_each_path(path, tmp_path):
    from tests.test_torch_tokenizer import TEXTS
    from tpualign.tokenizer.bpe import ClipTokenizer as JaxTokenizer
    from tpualign_torch.tokenizer.bpe import ClipTokenizer

    merges = _synthetic_merges(tmp_path)
    tok, jax_tok = ClipTokenizer(bpe_path=merges), JaxTokenizer(bpe_path=merges)
    assert (tok._bpe_core is not None) == (path == "native") == (jax_tok._bpe_core is not None)
    texts = TEXTS + ["low lower world hello-world 123 Ünïcode!", "abcdefgh " * 9]
    np.testing.assert_array_equal(tok(texts), jax_tok(texts))


def test_check_native_prints_as_tpualign(path, capsys):
    from tpualign.utils.checks import check_native as jax_check
    from tpualign_torch.utils.checks import check_native

    assert check_native() and jax_check()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2 and out[0] == out[1]
    assert ("available (self-tested)" in out[0]) == (path == "native")


_RACER = textwrap.dedent("""
    import ctypes, importlib.util, os, sys, time
    spec = importlib.util.spec_from_file_location("racing_build", sys.argv[1])
    build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(build)
    work = sys.argv[2]
    open(os.path.join(work, "ready." + sys.argv[3]), "w").close()
    while not os.path.exists(os.path.join(work, "go")):
        time.sleep(0.005)
    path = build.build()
    lib = ctypes.CDLL(str(path))
    texts = (ctypes.c_char_p * 2)(b"the oil filter", b"no match here")
    terms = (ctypes.c_char_p * 2)(b"filter", b"oil")
    out = (ctypes.c_int32 * 2)()
    lib.tpua_lexical_counts(texts, 2, terms, 2, out)
    assert list(out) == [2, 0], list(out)
    assert build._self_test(str(path))
    print(path)
""")


def test_four_processes_build_one_library(tmp_path):
    """Four processes build into an empty ``_build/`` at once: one compiles
    (under the lock), all four load the same library and pass the
    self-test, and no temporary file is left behind."""
    pkg = tmp_path / "pkg"
    shutil.copytree(REPO / "tpualign_torch" / "native", pkg / "native",
                    ignore=shutil.ignore_patterns("__pycache__"))
    work = tmp_path / "work"
    work.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO), LOG_LEVEL="INFO")
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(pkg / "native" / "build.py"),
                               str(work), str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for i in range(4)]
    deadline = time.monotonic() + 120
    while len(list(work.glob("ready.*"))) < 4 and time.monotonic() < deadline:
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.01)
    (work / "go").touch()
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    paths = {out.strip() for out, _ in outs}
    assert len(paths) == 1
    built = sorted(f.name for f in (pkg / "_build").iterdir())
    assert built == sorted([Path(paths.pop()).name, "tpualign_native.lock"])
    assert sum("Built native library" in err for _, err in outs) == 1
