"""Build and load the port's CUDA kernels (DESIGN.md §4).

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first
use, and loaded with ``ctypes``.  Sources compile in parallel (one
``nvcc -c`` per file, all started together) and are linked in one
``nvcc -shared`` step.  The library's file name carries a hash of the
sources, so an edited kernel is never served from a stale build.  The
build directory, ``src/repro_torch/build/``, is listed in
``.gitignore``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0, so a refused
launch (too many threads, too much shared memory) never passes
silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: name -> argtypes (see the .cu sources)
SIGNATURES = {
    # q, k, v, lengths, out, B, T, H, KV, dq, dv, scale, stream
    "clover_flash_decode": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _P],
    # q, k_pool, v_pool, page_table, lengths, out, B, n_p, pt, H, KV, dq,
    # dv, scale, stream
    "clover_paged_flash_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _F, _P],
    # q, k, v, out, B, S, T, H, KV, dq, dv, scale, stream
    "clover_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _F, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (set CUDA_HOME or PATH)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libclover_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (if this exact set is not built yet) and
    return the library path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = out.stem
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}_{src.stem}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared",
                           *map(str, objs), "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)            # atomic: readers never see a partial .so
    for obj in objs:
        obj.unlink(missing_ok=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
