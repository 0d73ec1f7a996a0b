"""ctypes bindings for the native IO runtime (native/isee3_io.cpp).

Every entry point has a NumPy fallback so the package works without the
compiled library; ``available()`` reports which path is active.  The
native layer covers the host data plane the reference implements in C:
stream reading with a background-thread ring buffer, int16 IQ
deinterleave/convert, and host-side golden codec kernels.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_LIB = None
_TRIED = False
_LOAD_LOCK = threading.Lock()

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"


def _load():
    # callers in other threads wait for the first one's on-demand build
    with _LOAD_LOCK:
        return _load_locked()


def _load_locked():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = _NATIVE_DIR / "libisee3_io.so"
    if not so.exists():
        try:  # build on demand; fall back silently if no toolchain
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None

    lib.iq_deinterleave.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.conv_encode.restype = ctypes.c_uint64
    lib.conv_encode.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint64,
    ]
    lib.viterbi_decode_frame.restype = ctypes.c_int
    lib.viterbi_decode_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.stream_reader_create.restype = ctypes.c_void_p
    lib.stream_reader_create.argtypes = [ctypes.c_int, ctypes.c_int64]
    lib.stream_reader_read.restype = ctypes.c_int64
    lib.stream_reader_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.stream_reader_available.restype = ctypes.c_int64
    lib.stream_reader_available.argtypes = [ctypes.c_void_p]
    lib.stream_reader_eof.restype = ctypes.c_int
    lib.stream_reader_eof.argtypes = [ctypes.c_void_p]
    lib.stream_reader_destroy.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def iq_deinterleave(raw: np.ndarray, flip: bool = False) -> np.ndarray:
    """Interleaved int16 I,Q → complex64 (native when available)."""
    raw = np.ascontiguousarray(raw, "<i2")
    n = raw.size // 2
    lib = _load()
    if lib is None:
        arr = raw.astype(np.float32).reshape(-1, 2)
        i, q = (arr[:, 1], arr[:, 0]) if flip else (arr[:, 0], arr[:, 1])
        return (i + 1j * q).astype(np.complex64)
    out_i = np.empty(n, np.float32)
    out_q = np.empty(n, np.float32)
    lib.iq_deinterleave(
        raw.ctypes.data, n, out_i.ctypes.data, out_q.ctypes.data, int(flip)
    )
    return (out_i + 1j * out_q).astype(np.complex64)


def conv_encode(data: np.ndarray, code, state: int = 0) -> tuple[np.ndarray, int]:
    """Native golden encoder; returns (symbols, final_state)."""
    lib = _load()
    data = np.ascontiguousarray(data, np.uint8)
    if lib is None:
        raise RuntimeError("native library unavailable")
    out = np.empty(data.size * 16, np.uint8)
    final = lib.conv_encode(
        data.ctypes.data, data.size, out.ctypes.data,
        code.poly1, code.poly2, code.k, code.g1flip, code.g2flip, state,
    )
    return out, int(final)


def viterbi_decode_frame(
    syms: np.ndarray, nbits: int, start_state: int, end_state: int, code
) -> np.ndarray:
    """Native golden Viterbi frame decode."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    syms = np.ascontiguousarray(syms, np.uint8)
    out = np.empty(nbits, np.uint8)
    r = lib.viterbi_decode_frame(
        syms.ctypes.data, nbits, start_state, end_state,
        code.poly1, code.poly2, code.k, code.g1flip, code.g2flip,
        out.ctypes.data,
    )
    assert r == 0
    return out


class StreamReader:
    """Background-thread ring-buffer reader over a file descriptor."""

    def __init__(self, fd: int, capacity: int = 1 << 24):
        lib = _load()
        self._lib = lib
        self._fd = fd
        if lib is None:
            self._handle = None
            self._file = os.fdopen(os.dup(fd), "rb", buffering=0)
        else:
            self._handle = lib.stream_reader_create(fd, capacity)

    def read(self, nbytes: int) -> bytes:
        if self._handle is None:
            chunks = []
            got = 0
            while got < nbytes:
                b = self._file.read(nbytes - got)
                if not b:
                    break
                chunks.append(b)
                got += len(b)
            return b"".join(chunks)
        buf = np.empty(nbytes, np.uint8)
        n = self._lib.stream_reader_read(self._handle, buf.ctypes.data, nbytes)
        return buf[:n].tobytes()

    def close(self) -> None:
        if self._handle is not None:
            self._lib.stream_reader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
