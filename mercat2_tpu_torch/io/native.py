"""ctypes bindings for the native C++ IO library (native/mercat2_native.cpp).

The native parser is a single-pass zlib-streaming FASTA/FASTQ reader —
the framework's replacement for the reference's external native data tools
(fastp / FragGeneScanRs / Ray core). It is optional: when the shared
library cannot be built (no C++ compiler), callers fall back to the
vectorized numpy parser in :mod:`mercat2_tpu_torch.io.fasta`, whose output
is identical.

The port builds its own copy of the library: it reads the source file
``native/mercat2_native.cpp`` (it imports nothing of the JAX package) and
compiles it with ``native/Makefile``'s flags into
``mercat2_tpu_torch/_build/``, under a file lock, to a temporary name that
``os.replace`` then moves into place, so that parallel processes never
load a half-written library. The file name carries a hash of the source
and flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "native_lib",
    "parse_fasta_native",
    "parse_fastq_native",
    "build_native",
    "NativeFasta",
    "open_fasta_native",
]

_SRC = Path(__file__).resolve().parents[2] / "native" / "mercat2_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
#: the flags of native/Makefile
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra")
_LDFLAGS = ("-shared", "-lz")
_lib = None
_lib_tried = False
_lib_lock = threading.Lock()


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_CXXFLAGS + _LDFLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libmercat2_native_{h.hexdigest()[:16]}.so"


def build_native(quiet: bool = True) -> Path | None:
    """Compile the shared library unless it exists; its path, or None when
    the source or a compiler is missing or the compile fails."""
    if not _SRC.is_file():
        return None
    so = _so_path()
    if so.exists():  # os.replace put it there whole
        return so
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, str(_SRC), "-o", str(tmp),
           *_LDFLAGS]
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(_BUILD_DIR / "native.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
            if so.exists():  # another process built it while this one waited
                return so
            proc = subprocess.run(cmd, capture_output=quiet, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                return None
            os.replace(tmp, so)
            return so
    except (OSError, subprocess.SubprocessError):
        return None


def native_lib():
    """Load (and memoize) the shared library; None if unavailable.

    Thread-safe: concurrent first calls (e.g. file parses fanned out over a
    ThreadPoolExecutor) serialize on a lock instead of racing the memo —
    the round-1 race set ``_lib_tried`` before ``_lib`` and made every
    thread but the first fall back to the slow numpy parser."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    with _lib_lock:
        if _lib is not None or _lib_tried:
            return _lib
        lib = _load_lib()
        _lib = lib
        _lib_tried = True
        return _lib


def _load_lib():
    so = build_native()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.m2n_parse_fasta.restype = ctypes.c_int
    lib.m2n_parse_fasta.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.m2n_seq_len.restype = ctypes.c_int64
    lib.m2n_seq_len.argtypes = [ctypes.c_void_p]
    lib.m2n_num_records.restype = ctypes.c_int64
    lib.m2n_num_records.argtypes = [ctypes.c_void_p]
    lib.m2n_seq_ptr.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.m2n_seq_ptr.argtypes = [ctypes.c_void_p]
    lib.m2n_starts_ptr.restype = ctypes.POINTER(ctypes.c_int64)
    lib.m2n_starts_ptr.argtypes = [ctypes.c_void_p]
    lib.m2n_rec_ptr.restype = ctypes.POINTER(ctypes.c_int64)
    lib.m2n_rec_ptr.argtypes = [ctypes.c_void_p]
    lib.m2n_free.restype = None
    lib.m2n_free.argtypes = [ctypes.c_void_p]
    lib.m2n_stream_len.restype = ctypes.c_int64
    lib.m2n_stream_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.m2n_fill_stream.restype = ctypes.c_int64
    lib.m2n_fill_stream.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.m2n_byte_hist.restype = None
    lib.m2n_byte_hist.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.m2n_packed_len.restype = ctypes.c_int64
    lib.m2n_packed_len.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.m2n_gap_ranges.restype = ctypes.c_int64
    lib.m2n_gap_ranges.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ]
    lib.m2n_fill_packed.restype = ctypes.c_int64
    lib.m2n_fill_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int64,
    ]
    lib.m2n_parse_fastq.restype = ctypes.c_int
    lib.m2n_parse_fastq.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    for name, res in [
        ("m2n_fq_seq_len", ctypes.c_int64),
        ("m2n_fq_num_reads", ctypes.c_int64),
        ("m2n_fq_headers_len", ctypes.c_int64),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    lib.m2n_fq_seq_ptr.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.m2n_fq_seq_ptr.argtypes = [ctypes.c_void_p]
    lib.m2n_fq_starts_ptr.restype = ctypes.POINTER(ctypes.c_int64)
    lib.m2n_fq_starts_ptr.argtypes = [ctypes.c_void_p]
    lib.m2n_fq_headers_ptr.restype = ctypes.c_char_p
    lib.m2n_fq_headers_ptr.argtypes = [ctypes.c_void_p]
    lib.m2n_fq_free.restype = None
    lib.m2n_fq_free.argtypes = [ctypes.c_void_p]
    return lib


def parse_fasta_native(path) -> tuple[np.ndarray, np.ndarray] | None:
    """(seq uint8[N], rec int64[N]) via the C++ parser, or None if absent.

    Semantics identical to :func:`mercat2_tpu_torch.io.fasta.parse_fasta_seq`.
    """
    lib = native_lib()
    if lib is None:
        return None
    handle = ctypes.c_void_p()
    rc = lib.m2n_parse_fasta(str(path).encode(), ctypes.byref(handle))
    if rc != 0:
        raise OSError(f"native FASTA parse failed (rc={rc}) for {path}")
    try:
        n = lib.m2n_seq_len(handle)
        seq = np.ctypeslib.as_array(lib.m2n_seq_ptr(handle), shape=(n,)).copy() \
            if n else np.zeros(0, np.uint8)
        rec = np.ctypeslib.as_array(lib.m2n_rec_ptr(handle), shape=(n,)).copy() \
            if n else np.zeros(0, np.int64)
    finally:
        lib.m2n_free(handle)
    return seq, rec


class NativeFasta:
    """Zero-copy handle over a native-parsed FASTA file.

    Exposes exactly what the count engine needs — alphabet histogram,
    exact stream length, and direct sentinel-gapped encoding into a
    caller-allocated buffer — without materializing the per-byte record-id
    array the numpy path requires. Use as a context manager.
    """

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        if self._h:
            self._lib.m2n_free(self._h)
            self._h = None

    @property
    def seq_len(self) -> int:
        return int(self._lib.m2n_seq_len(self._h))

    def byte_hist(self) -> np.ndarray:
        out = np.zeros(256, np.int64)
        self._lib.m2n_byte_hist(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        return out

    def alphabet(self) -> np.ndarray:
        return np.nonzero(self.byte_hist())[0].astype(np.uint8)

    def stream_len(self, k: int) -> int:
        return int(self._lib.m2n_stream_len(self._h, k))

    def fill_stream(self, k: int, lut256: np.ndarray, out: np.ndarray) -> int:
        """Encode into ``out`` (uint8, pre-filled with the sentinel)."""
        assert out.dtype == np.uint8 and out.flags.c_contiguous
        lut = np.ascontiguousarray(lut256, dtype=np.uint8)
        return int(self._lib.m2n_fill_stream(
            self._h, k,
            lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ))

    @property
    def num_records(self) -> int:
        return int(self._lib.m2n_num_records(self._h))

    def packed_len(self, gap: int) -> int:
        """Gapped stream length in symbols for the packed transport."""
        return int(self._lib.m2n_packed_len(self._h, gap))

    def gap_ranges(self, gap: int) -> tuple[np.ndarray, np.ndarray]:
        """Interior gap symbol ranges [begin, end), file-relative int64."""
        cap = max(1, self.num_records)
        begins = np.empty(cap, np.int64)
        ends = np.empty(cap, np.int64)
        n = int(self._lib.m2n_gap_ranges(
            self._h, gap,
            begins.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ends.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ))
        return begins[:n], ends[:n]

    def fill_packed(self, bits: int, gap: int, lut256: np.ndarray,
                    words: np.ndarray, sym_off: int) -> int:
        """Encode + bit-pack this file into ``words`` at symbol offset
        ``sym_off`` (a multiple of 32//bits; buffer must be zeroed)."""
        assert words.dtype == np.uint32 and words.flags.c_contiguous
        lut = np.ascontiguousarray(lut256, dtype=np.uint8)
        return int(self._lib.m2n_fill_packed(
            self._h, bits, gap,
            lut.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            sym_off,
        ))

    def seq_and_rec(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.seq_len
        if not n:
            return np.zeros(0, np.uint8), np.zeros(0, np.int64)
        seq = np.ctypeslib.as_array(self._lib.m2n_seq_ptr(self._h), shape=(n,)).copy()
        rec = np.ctypeslib.as_array(self._lib.m2n_rec_ptr(self._h), shape=(n,)).copy()
        return seq, rec


def open_fasta_native(path) -> NativeFasta | None:
    """Open a FASTA through the native parser; None if the lib is absent."""
    lib = native_lib()
    if lib is None:
        return None
    handle = ctypes.c_void_p()
    rc = lib.m2n_parse_fasta(str(path).encode(), ctypes.byref(handle))
    if rc != 0:
        raise OSError(f"native FASTA parse failed (rc={rc}) for {path}")
    return NativeFasta(lib, handle)


def parse_fastq_native(path):
    """(seq uint8[N], read_starts int64[R], headers list[str]) or None."""
    lib = native_lib()
    if lib is None:
        return None
    handle = ctypes.c_void_p()
    rc = lib.m2n_parse_fastq(str(path).encode(), ctypes.byref(handle))
    if rc != 0:
        raise OSError(f"native FASTQ parse failed (rc={rc}) for {path}")
    try:
        n = lib.m2n_fq_seq_len(handle)
        r = lib.m2n_fq_num_reads(handle)
        seq = np.ctypeslib.as_array(lib.m2n_fq_seq_ptr(handle), shape=(n,)).copy() \
            if n else np.zeros(0, np.uint8)
        starts = np.ctypeslib.as_array(lib.m2n_fq_starts_ptr(handle), shape=(r,)).copy() \
            if r else np.zeros(0, np.int64)
        blob = lib.m2n_fq_headers_ptr(handle)
        headers = blob.decode("latin-1").split("\n") if blob else []
    finally:
        lib.m2n_fq_free(handle)
    return seq, starts, headers
