"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into ONE shared library with
a plain C interface, at first use, and loaded with ``ctypes`` (no PyTorch
headers, so the build takes seconds). The library's file name carries a
hash of the sources and flags, so an edited source is rebuilt and a stale
library is never loaded. Importing this module compiles nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["check", "load_library", "stream_of"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
#: C entry points: name -> argtypes. Each returns cudaGetLastError().
_SIGNATURES = {
    # words, n_words, valid, starts, n_files, out, ld, n_valid, p, k, bits,
    # payload, kb0, tiebreak, fid_mode, fid_shift, n_cols, fused, stream
    "m2t_build_keys": [_P, _I64, _P, _P, _I32, _P, _I64, _P, _I64, _I32, _I32,
                       _I32, _I32, _I32, _I32, _I32, _I32, _I32, _P],
    # u64, keys, n_words, ld, p, n_valid, min_count, rows, status,
    # status_len, n_out, out_keys, out_counts, stream
    "m2t_finalize": [_I32, _P, _I32, _I64, _I64, _P, _I32, _I64, _P,
                     _I64, _P, _P, _P, _P],
    # u64, n_words
    "m2t_finalize_tile_rows": [_I32, _I32],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the port's CUDA kernels cannot be built"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmercat2_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails, after all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")


def build() -> Path:
    """Compile the library unless the current one exists; its path. One
    ``nvcc`` a source, all at once, then one link."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    try:
        _run_all([[nvcc, *FLAGS, "-c", "-o", str(obj), str(src)]
                  for obj, src in zip(objs, _sources())])
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        os.replace(tmp, so)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return so


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def stream_of(device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
