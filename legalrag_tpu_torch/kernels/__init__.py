"""Build, load and count the port's CUDA kernels.

The sources in ``legalrag_tpu_torch/csrc/*.cu`` have plain C entry points.
At first use ``nvcc`` compiles each source for ``sm_90a`` (all sources at
once, one process each) and links them into
``build/legalrag_tpu_torch/libkernels.so`` at the root of the checkout; the
library is rebuilt when the hash of the sources or of the flags changes.
``ctypes`` loads it: pointers and the stream go as ``c_void_p``, each entry
returns ``cudaGetLastError()`` after its launch, and :func:`launch` raises
when that is not 0. A launch is asynchronous on PyTorch's current stream:
a tensor that a wrapper drops after it (a cast copy, scratch) goes back to
PyTorch's caching allocator, which gives its memory only to later work on
the same stream, so the kernel's reads and writes finish first.

Nothing here runs at import time: the CPU tests import every module of the
port, and a machine without a card has no ``nvcc``.

Each kernel has a launch count (:func:`launch_counts`), raised by one in
:func:`launch` and nowhere else, so a run can show that the main path went
through the kernels. A kernel with routes (:data:`ROUTES`: MaxSim's store
kinds) also counts each launch under the route its wrapper names.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "legalrag_tpu_torch"
SOURCES = ("score_select.cu", "maxsim.cu", "bm25_sparse.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C signatures of the entry points (csrc/*.cu, extern "C")
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "score_select": [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "score_select_tile": [],
    "score_select_queries": [],
    "score_select_scratch_bytes": [_I, _I, _I],
    "maxsim": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
               _P, _P],
    "maxsim_queries_per_block": [],
    "maxsim_smem_bytes": [_I, _I, _I],
    "bm25_sparse": [_P, _P, _I, _I, _P, _I, _P, _P, _I, _I, _P, _P, _P],
}
# entries that return something other than an int
_RESTYPES = {"score_select_scratch_bytes": ctypes.c_longlong,
             "maxsim_smem_bytes": ctypes.c_longlong}
# kernels counted by launch(): name -> the C entry that launches it
KERNELS = ("score_select", "maxsim", "bm25_sparse")
# kernels whose launches are also counted per route, as "name/route"
ROUTES = {"maxsim": ("float32", "bf16", "int8", "nbit4")}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_launches: Dict[str, int] = {k: 0 for k in KERNELS}
_route_launches: Dict[str, int] = {f"{k}/{r}": 0 for k, rs in ROUTES.items()
                                   for r in rs}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Dict[str, object]:
    """Compile ``csrc/*.cu`` into ``libkernels.so`` unless an up-to-date one
    exists. Returns ``{"path", "seconds", "built", "ptxas"}`` (``ptxas``:
    the compiler's register / shared-memory report per source)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = _source_hash()
    if (not force and lib_path.exists() and stamp.exists()
            and stamp.read_text().strip() == digest):
        return {"path": str(lib_path), "seconds": 0.0, "built": False,
                "ptxas": ""}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        reports = []
        failed = []
        for src, _obj, p in procs:
            out, _ = p.communicate()
            reports.append(f"== {src}\n{out}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n"
                               + "\n".join(reports))
        tmp_lib = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", str(tmp_lib), *[str(o) for _s, o, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest)
    return {"path": str(lib_path), "seconds": time.perf_counter() - t0,
            "built": True, "ptxas": "\n".join(reports)}


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()["path"]
            cdll = ctypes.CDLL(path)
            for name, args in _SIGNATURES.items():
                fn = getattr(cdll, name)
                fn.argtypes = args
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _lib = cdll
        return _lib


def launch(name: str, *args, route: Optional[str] = None) -> None:
    """Call the C entry ``name`` (one of :data:`KERNELS`), raise if the
    launch failed, and count it (and under ``route``, one of
    ``ROUTES[name]``, where the kernel has routes)."""
    key = None if route is None else f"{name}/{route}"
    if key is not None and key not in _route_launches:
        raise ValueError(f"{name} has no route {route!r}")
    rc = getattr(lib(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    with _lock:  # request threads launch concurrently on the serving path
        _launches[name] += 1
        if key is not None:
            _route_launches[key] += 1


def launch_counts(routes: bool = False) -> Dict[str, int]:
    """Launches per kernel since the last reset; with ``routes`` also per
    route, keyed "name/route"."""
    with _lock:
        return {**_launches, **(_route_launches if routes else {})}


def reset_launch_counts() -> None:
    with _lock:
        for counts in (_launches, _route_launches):
            for k in counts:
                counts[k] = 0
