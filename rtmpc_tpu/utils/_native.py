"""ctypes binding for the native batched-LP kernel (``native/rtmpc_lp.cpp``).

The shared library is built on first use with the repo Makefile (g++,
single translation unit, std::thread) and cached next to the source; set
``RTMPC_NO_NATIVE=1`` to force the pure-scipy fallback.  All entry points
degrade gracefully: if the toolchain or the build is unavailable,
``native_available()`` returns False, callers keep using scipy/HiGHS, and
``native_status()`` (and a warning) says why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SRC = os.path.join(_NATIVE_DIR, "rtmpc_lp.cpp")
_SO = os.path.join(_NATIVE_DIR, "librtmpc_lp.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_why = ""            # why the library is not in use, once _load has run


def _build() -> bool:
    global _why
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        return True
    except OSError as e:
        _why = f"cannot run make: {e}"
    except subprocess.CalledProcessError as e:
        _why = f"make failed: {(e.stderr or e.stdout).strip()[-400:]}"
    except subprocess.TimeoutExpired:
        _why = "make timed out after 120 s"
    return False


def _src_hash() -> str:
    import hashlib
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _open_if_current(want_hash: str) -> Optional[ctypes.CDLL]:
    """dlopen the .so only if its embedded source hash matches ``want_hash``
    (mtime ordering is meaningless after a git clone; the hash is not)."""
    if not os.path.exists(_SO):
        return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.rtmpc_src_hash.restype = ctypes.c_char_p
        got = lib.rtmpc_src_hash().decode()
    except (OSError, AttributeError):
        return None
    return lib if got == want_hash else None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _why
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("RTMPC_NO_NATIVE"):
            _why = "RTMPC_NO_NATIVE is set"
            return None
        if not os.path.exists(_SRC):
            _why = f"{_SRC} is missing"
            return None
        want = _src_hash()
        lib = _open_if_current(want)
        if lib is None:
            if _build():
                lib = _open_if_current(want)
                if lib is None:
                    _why = (f"{_SO} did not load or does not embed the "
                            "source's hash")
            if lib is None:
                warnings.warn(f"native LP kernel unavailable, using scipy: "
                              f"{_why}", RuntimeWarning, stacklevel=3)
                return None
        lib.rtmpc_support_batch.restype = ctypes.c_int
        lib.rtmpc_support_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),   # A
            ctypes.POINTER(ctypes.c_double),   # b
            ctypes.c_int, ctypes.c_int,        # m, n
            ctypes.POINTER(ctypes.c_double),   # C
            ctypes.c_int,                      # k
            ctypes.POINTER(ctypes.c_double),   # h out
            ctypes.POINTER(ctypes.c_int),      # status out
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_status() -> str:
    """"native", or "scipy (<why the library is not in use>)"."""
    return "native" if _load() is not None else f"scipy ({_why})"


def support_batch_native(A: np.ndarray, b: np.ndarray,
                         C: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``h[j] = max{C[j]@y : A y <= b}`` for all rows of C.

    Returns ``(h, status)`` with status 0 = optimal, 1 = unbounded
    (``h = +inf``), 2 = infeasible/failed (``h = NaN``).  Raises
    ``RuntimeError`` if the native library is unavailable — call
    ``native_available()`` first.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native LP kernel unavailable")
    A = np.ascontiguousarray(A, dtype=np.float64)
    b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1)
    C = np.ascontiguousarray(np.atleast_2d(C), dtype=np.float64)
    m, n = A.shape
    k = C.shape[0]
    assert C.shape[1] == n and b.shape[0] == m
    h = np.empty(k, dtype=np.float64)
    status = np.empty(k, dtype=np.int32)
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.rtmpc_support_batch(
        A.ctypes.data_as(dp), b.ctypes.data_as(dp),
        ctypes.c_int(m), ctypes.c_int(n),
        C.ctypes.data_as(dp), ctypes.c_int(k),
        h.ctypes.data_as(dp), status.ctypes.data_as(ip))
    return h, status
