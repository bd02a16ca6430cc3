"""Build the CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``<repo>/build/kernels/lib<name>_<hash>.so`` for ``sm_90a``, keyed on a hash of
the source, every ``csrc/`` header it includes (followed through headers)
and the flags, so an edited source or header builds anew and an unchanged
one loads at once.  ``build()`` starts one ``nvcc`` per missing library and
waits for all of them; nothing is built when a module is imported.  Each
library has a plain C interface: raw pointers, shapes and strides in, a CUDA
error code out.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("motif_level3", "motif_level3_backward", "motif_combine", "adj_matmul",
           "adj_matmul_backward", "span_stamp", "motif_level4", "motif_level4_backward")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_INCLUDE = re.compile(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', re.M)

_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory / spill report) per kernel,
# from the builds this process ran
build_log: Dict[str, str] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every file under ``csrc/`` it includes, in
    the order first met."""
    seen: List[Path] = []
    todo = [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            cand = (path.parent / inc).resolve()
            if cand.is_file() and CSRC in cand.parents:
                todo.append(cand)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, all in parallel.
    Returns the seconds each build took (0.0 where the library was there)."""
    names = list(names)
    for n in names:
        if n not in KERNELS:
            raise ValueError(f"unknown kernel {n!r}; known: {KERNELS}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    secs = {n: 0.0 for n in names}
    procs = []
    exe = None
    for n in names:
        out = library_path(n)
        if out.exists():
            continue
        exe = exe or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, out, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, out, tmp, t0, p in procs:
        log, _ = p.communicate()
        secs[n] = time.perf_counter() - t0
        build_log[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n} (exit {p.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def load(name: str, signatures: Optional[Dict[str, Sequence]] = None) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if missing.
    ``signatures`` maps each C function to its argtypes (restype is int)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in (signatures or {}).items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
