"""Build and load the port's CUDA kernels (DESIGN.md §4).

Every ``src/repro_torch/csrc/*.cu`` is compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first
use, and loaded with ``ctypes``.  Sources compile in parallel (one
``nvcc -c`` per file, all started together; a file listed in ``PARTS``
once per part, with ``-DCLOVER_PART=p``, each part instantiating its
share of the file's kernels) and are linked in one ``nvcc -shared``
step.  The library's file name carries a hash of the
sources, so an edited kernel is never served from a stale build.  The
build directory, ``src/repro_torch/build/``, is listed in
``.gitignore``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; ``check`` raises on anything but 0, so a refused
launch (too many threads, too much shared memory) never passes
silently.  ``ptxas -v``'s report of every kernel (registers, spills)
is kept beside the library and read back by ``ptxas_report``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# -Xptxas -v: each kernel's registers and spills, kept beside the library;
# --split-compile 0: each source's kernel instances optimized on every CPU
# (decode_attention.cu holds ~100 of them)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0"]
# sources built in parts: stem -> parts (decode_attention.cu's 72 kernel
# instances in five objects, one element kind each; clover_attention.cu's
# float32 form, then its 16-bit flash and window forms in bfloat16 and
# float16, in five)
PARTS = {"clover_attention": 5, "decode_attention": 5}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_int64
# C entry points: name -> argtypes (see the .cu sources)
SIGNATURES = {
    # q, k, v, table, lengths, qk_ranks, vo_ranks, part, umax, out, lse
    # (table, ranks, umax, lse nullable), B, n_p, pt, H, KV, dq, dv, ldk,
    # ldv, n_split, span, block, unit, q dtype, kv dtype, scale, stream
    "clover_decode": [_P] * 11 + [_I] * 15 + [_F, _P],
    # q, k, v, out, B, S, T, H, KV, dq, dv, width bucket, dtype code,
    # scale, row tiles, staging route (the 16-bit plan), stream
    "clover_flash_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _F, _I, _I, _P],
    # q, k, v, out, B, S, T, H, KV, dq, dv, k strides (batch, position,
    # head), v strides, width bucket, dtype code, scale, scale_first, row
    # tiles, staging route, stream
    "clover_window_attention": ([_P] * 4 + [_I] * 7 + [_L] * 6
                                + [_I] * 2 + [_F, _I, _I, _I, _P]),
    # leaf table, n_leaves, src, dst, m, route, access, chunk, group, smem,
    # ctas, stream
    "clover_page_copy": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # leaf table, n_leaves, dst, W, route, access, chunk, group, smem, ctas,
    # stream
    "clover_page_restore": [_P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # r, k, v, logw, u, s0 (nullable), out, s_end, B, H, T, d, lanes,
    # columns per thread, columns per block, stream
    "clover_wkv6": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                    _I, _P],
    # dt, A, Bm, C, x, h0 (nullable), y, h_end, B, S, dI, dS, lanes,
    # channels per block, stream
    "clover_mamba_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                          _I, _I, _P],
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
        parts = PARTS.get(src.stem, 1)
        for p in range(parts):
            obj = BUILD_DIR / f"{tag}_{src.stem}_{p}.o"
            part = ([f"-DCLOVER_PARTS={parts}", f"-DCLOVER_PART={p}"]
                    if parts > 1 else [])
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *part, "-I", str(CSRC), "-c", str(src),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    errors, logs = [], []
    for src, p in procs:
        log, _ = p.communicate()
        logs.append(log)
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
    out.with_suffix(".ptxas.txt").write_text("".join(logs))
    os.replace(tmp, out)            # atomic: readers never see a partial .so
    for obj in objs:
        obj.unlink(missing_ok=True)
    return out


def _demangle(names: List[str]) -> List[str]:
    """Kernel names as ``flash_kernel<64, 64>``: ``cu++filt`` (beside
    ``nvcc``) with the namespaces dropped, or the mangled names where it
    is missing."""
    try:
        filt = Path(_nvcc()).with_name("cu++filt")
        out = subprocess.run([str(filt)], input="\n".join(names),
                             capture_output=True, text=True, check=True)
        lines = out.stdout.splitlines()
    except (OSError, RuntimeError, subprocess.CalledProcessError):
        return names
    if len(lines) != len(names):
        return names
    clean = []
    for line in lines:
        for noise in ("clover::(anonymous namespace)::",
                      "clover::<unnamed>::", "clover::decode::", "(int)",
                      "(bool)"):
            line = line.replace(noise, "")
        m = re.search(r"(\w+_kernel(?:<[^()]*>)?)\(", line)
        clean.append(m.group(1) if m else line)
    return clean


def ptxas_report() -> List[Tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) of every
    kernel in the built library, from ``ptxas -v``."""
    rows, spills, name = [], {}, None
    text = build().with_suffix(".ptxas.txt").read_text()
    for line in text.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            spills[name] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            st, ld = spills.get(name, (0, 0))
            rows.append((name, int(m.group(1)), st, ld))
    names = _demangle([r[0] for r in rows])
    return [(n, *r[1:]) for n, r in zip(names, rows)]


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


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of the card (asked once per device): the
    wrappers' planners size their grids by it."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_tensor(name: str, t, shape) -> None:
    """A float32 kernel operand: on the card, of ``shape``, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} {tuple(t.shape)}: need {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
