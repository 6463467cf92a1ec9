"""Build the hand-written CUDA kernels with ``nvcc`` and load them with ctypes.

Each source ``kernels/csrc/<name>.cu`` becomes one shared library with a
plain C interface (no PyTorch headers), compiled for ``sm_90a`` (sources
that share a kernel include it from a ``csrc/*.cuh`` header):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

The build runs at first use, all sources at once in parallel, into
``build/repro_torch_kernels/<name>-<hash>/`` at the repository root, keyed
by a hash of the source, the shared headers and the flags; a later process
finds the library there and loads it.  ``nvcc``'s ``-Xptxas -v`` report
(registers, shared memory, spills) is kept beside each library.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

__all__ = ["SOURCES", "build", "library", "ptxas_report", "check_launch",
           "host_ints"]

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# C entry point and argument types of each library.  Every pointer and the
# stream are c_void_p: without argtypes ctypes would pass 32-bit ints.
SOURCES: Dict[str, tuple] = {
    "spmm": ("spmm_launch", [_P] * 7 + [_I] * 14 + [_P]),
    "spmm_batched": ("spmm_batched_launch",
                     [_P] * 7 + [_I] * 12 + [_L, _L] + [_I] * 3 + [_P]),
    "spmm_noncoalesced": ("spmm_noncoalesced_launch",
                          [_P] * 11 + [_I] * 9 + [_P]),
    "spmm_staged": ("spmm_staged_launch", [_P] * 5 + [_I] * 13 + [_P]),
    "spmm_gather": ("spmm_gather_launch", [_P] * 3 + [_I] * 3 + [_P]),
    "sddmm": ("sddmm_launch", [_P] * 6 + [_I] * 6 + [_P]),
    "sddmm_batched": ("sddmm_batched_launch",
                      [_P] * 6 + [_I] * 6 + [_L, _L, _I, _P]),
    "attention": ("attention_launch",
                  [_P] * 7 + [_I] * 10 + [_L, _L, _L, _I, _P]),
    "spmm_balanced": ("spmm_balanced_launch",
                      [_P] * 10 + [_I] * 7 + [_L, _L, _P, _I, _L, _L, _I,
                                              _I, _P]),
    "sddmm_balanced": ("sddmm_balanced_launch",
                       [_P] * 7 + [_I] * 6 + [_L, _L, _L, _I, _P]),
    "attention_balanced": ("attention_balanced_launch",
                           [_P] * 15 + [_I] * 7 + [_L, _L, _L, _P, _I, _L,
                                                   _L, _I, _I, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the CUDA "
                       "kernels are built from source on first use")


def _out_dir(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}"


def _build_one(name: str) -> pathlib.Path:
    out_dir = _out_dir(name)
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    (out_dir / "nvcc.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build() -> Dict[str, pathlib.Path]:
    """Compile every kernel library not built yet, one ``nvcc`` per source,
    all started together.  Returns the library path of each source."""
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
        return dict(zip(SOURCES, ex.map(_build_one, SOURCES)))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``kernels/csrc/<name>.cu``, building all
    kernels on first use."""
    with _lock:
        if not _libs:
            for src, path in build().items():
                lib = ctypes.CDLL(str(path))
                entry, argtypes = SOURCES[src]
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                err_fn = getattr(lib, f"{src}_error_string")
                err_fn.argtypes = [ctypes.c_int]
                err_fn.restype = ctypes.c_char_p
                _libs[src] = lib
        return _libs[name]


def host_ints(values) -> ctypes.c_void_p:
    """A host array of C ints holding ``values``, as a pointer argument
    (the caller keeps the array alive by keeping the return value)."""
    arr = (ctypes.c_int * max(len(values), 1))(*values)
    ptr = ctypes.cast(arr, ctypes.c_void_p)
    ptr._keep = arr
    return ptr


def check_launch(name: str, err: int) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        text = getattr(library(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({text})")


def ptxas_report() -> str:
    """The register, shared-memory and spill lines ``nvcc -Xptxas -v``
    printed for each built library."""
    lines = []
    for name in SOURCES:
        log = _out_dir(name) / "nvcc.log"
        text = log.read_text() if log.exists() else "(not built)\n"
        lines += [f"[{name}.cu] {ln.strip()}" for ln in text.splitlines()
                  if any(w in ln for w in ("registers", "spill", "smem",
                                           "Compiling entry", "(not built)"))]
    return "\n".join(lines)
