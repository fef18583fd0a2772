"""Builds the native host library (``tpualign_native.cpp``) with g++.

The source is a byte-identical copy of ``tpualign``'s, compiled with its
flags (``-O3 -march=native -shared -fPIC -std=c++17``) into
``tpualign_torch/_build/``, under a name keyed by a hash of the source,
the flags and the host CPU's model and feature flags: a library built for
another CPU (``-march=native``) never matches, so it is never loaded.

Several processes may build at once (pytest workers, a daemon and a CLI):
each takes an exclusive ``fcntl.flock`` on ``_build/tpualign_native.lock``,
and the first compiles to a ``mkstemp`` name, runs a self-test on that
file in a subprocess (an instruction the CPU lacks kills the subprocess
with SIGILL, not the caller) and ``os.replace``s it into place; the others
find the library when they get the lock. Nothing builds at import.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import platform
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Optional

from tpualign_torch.utils.logging import get_logger

log = get_logger("native.build")

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "tpualign_native.cpp"
BUILD_DIR = _HERE.parent / "_build"

CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_SELFTEST = """
import ctypes, sys
lib = ctypes.CDLL(sys.argv[1])
lib.tpua_lexical_counts.argtypes = [
    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32),
]
texts = (ctypes.c_char_p * 2)(b"the oil filter", b"no match here")
terms = (ctypes.c_char_p * 2)(b"filter", b"oil")
out = (ctypes.c_int32 * 2)()
lib.tpua_lexical_counts(texts, 2, terms, 2, out)
assert list(out) == [2, 0], list(out)
print("selftest-ok")
"""


def _cpu_identity() -> bytes:
    """The host CPU's model name and feature flags (what ``-march=native``
    compiles for)."""
    try:
        text = Path("/proc/cpuinfo").read_text(errors="replace")
    except OSError:
        text = ""
    fields: dict = {}  # the first processor's value of each field
    for line in text.splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip(), value.strip())
    return "\n".join([platform.machine()] + [
        fields.get(k, "") for k in ("model name", "flags", "Features", "CPU part")]).encode()


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256()
    h.update(Path(source).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_cpu_identity())
    return Path(build_dir) / f"libtpualign_native-{h.hexdigest()[:16]}.so"


def _self_test(path: str) -> bool:
    try:
        proc = subprocess.run([sys.executable, "-c", _SELFTEST, path],
                              capture_output=True, text=True, timeout=60)
    except Exception as e:  # pragma: no cover - spawn failure
        log.warning("native self-test could not run: %s", e)
        return False
    if proc.returncode != 0 or "selftest-ok" not in proc.stdout:
        log.warning("native self-test failed (rc=%d): %s", proc.returncode,
                    (proc.stderr or proc.stdout)[:300])
        return False
    return True


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Optional[Path]:
    """The library's path, compiled and self-tested on first use; ``None``
    (with the reason logged) when g++ is missing, fails, or its library
    fails the self-test."""
    lib = library_path(source, build_dir)
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        log.warning("g++ not found; native acceleration disabled")
        return None
    build_dir = Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "tpualign_native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():  # another process built it while this one waited
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", prefix=".tpualign_native-", dir=build_dir)
        os.close(fd)
        try:
            subprocess.run([cxx, *CXX_FLAGS, str(source), "-o", tmp], check=True,
                           capture_output=True, timeout=300)
            if not _self_test(tmp):
                return None
            os.replace(tmp, lib)
        except subprocess.CalledProcessError as e:
            log.warning("native build failed: %s", e.stderr.decode(errors="replace")[:500])
            return None
        except subprocess.TimeoutExpired:
            log.warning("native build timed out")
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    log.info("Built native library at %s", lib)
    return lib
