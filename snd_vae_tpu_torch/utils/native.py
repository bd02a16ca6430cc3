"""The native data-path library: random spanning trees and pairwise
distances in C++ (``utils/csrc/sndkern.cpp``), loaded with ctypes.

The port's copy of ``snd_vae_tpu/utils/native.py`` and its library.  The
source compiles with the host's C++ compiler (``$CXX``, else ``g++``, else
``c++`` on PATH) and the JAX module's flags into
``<repo>/build/native/libsndkern_<hash>.so``, keyed on a hash of the source
and the flags, at first use; nothing is built when the module is imported.
The compiler writes to a temporary name that is then renamed into place, so
a process that loads the library never sees half a file.

The JAX module falls back to numpy when the library cannot be built; this
one raises with the compiler's output instead.  Both libraries draw per
(graph, tree) splitmix seeds and shuffle the edges with ``std::shuffle``
over an ``mt19937_64``, whose draw belongs to the C++ standard library: two
builds on one host draw the same trees.

    python -m snd_vae_tpu_torch.utils.native    # build, print the library's path
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "sndkern.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
# the compiler and seconds of the build this process ran (empty: the library was there)
build_info: dict = {}


def compiler() -> List[str]:
    """The C++ compiler's command: ``$CXX`` (split as a shell would), else
    ``g++``, else ``c++`` on PATH."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return [found]
    raise RuntimeError("no C++ compiler for the native library: set CXX or put g++ or c++ "
                       "on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"libsndkern_{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the library if it is missing; returns the seconds the build
    took (0.0 where it was there).  Raises with the compiler's output when
    the compile fails."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [*compiler(), *CXX_FLAGS, str(SOURCE), "-o"]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd + [str(tmp)], capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"native library: cannot run {cmd[0]!r}: {e}") from e
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library: {' '.join(cmd)} {tmp} exited {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_info.update(compiler=cmd[0], seconds=secs)
    return secs


def load() -> ctypes.CDLL:
    """The loaded library, built first if missing; raises if it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            dbl = ctypes.POINTER(ctypes.c_double)
            lib.snd_sample_spanning_trees.argtypes = [
                dbl, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64, dbl]
            lib.snd_sample_spanning_trees.restype = ctypes.c_int
            lib.snd_pairwise_distances.argtypes = [
                dbl, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, dbl]
            lib.snd_pairwise_distances.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def sample_spanning_trees(adj: np.ndarray, num_samples: int, seed: int = 0) -> np.ndarray:
    """[G, N, N] adjacencies -> [G, S, N, N] float64 random spanning trees
    (a spanning forest where a graph is disconnected)."""
    adj = np.ascontiguousarray(adj, dtype=np.float64)
    if adj.ndim != 3 or adj.shape[1] != adj.shape[2]:
        raise ValueError(f"adjacencies must be [G, N, N], got {adj.shape}")
    lib = load()
    G, N = adj.shape[0], adj.shape[1]
    out = np.zeros((G, num_samples, N, N), dtype=np.float64)
    rc = lib.snd_sample_spanning_trees(_ptr(adj), G, N, num_samples, seed, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"snd_sample_spanning_trees failed with code {rc}")
    return out


def pairwise_distances(coords: np.ndarray) -> np.ndarray:
    """[G, N, D] coordinates -> [G, N, N] float64 Euclidean distances."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    if coords.ndim != 3:
        raise ValueError(f"coordinates must be [G, N, D], got {coords.shape}")
    lib = load()
    G, N, D = coords.shape
    out = np.zeros((G, N, N), dtype=np.float64)
    rc = lib.snd_pairwise_distances(_ptr(coords), G, N, D, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"snd_pairwise_distances failed with code {rc}")
    return out


if __name__ == "__main__":
    load()
    print(library_path())
