"""Exact maximum clique via the native C++ branch-and-bound library.

Host-side equivalent of the PMC path in MaxCliqueSolver::findMaxClique
(/root/reference/teaser/src/graph.cc:84-124: heuristic lower bound then
pmcx_maxclique exact search with `in.threads = 12` and a time limit). The
library (native/maxclique.cpp) is loaded with ctypes and auto-built with
g++ on first use if the .so is missing.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libpsulvsb_native.so"))
_lock = threading.Lock()
_lib = None


def _build() -> None:
    """Build the library from native/maxclique.cpp unless it exists. The
    file lock serialises processes that reach the first use together (test
    workers on a fresh checkout); the Makefile renames the finished file
    into place, so no process ever loads a partial one."""
    import fcntl

    native_dir = os.path.abspath(_NATIVE_DIR)
    with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-C", native_dir], check=True, capture_output=True
            )


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        _build()
        lib = ctypes.CDLL(_LIB_PATH)
        lib.max_clique.restype = ctypes.c_int
        lib.max_clique.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_double,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.kcores.restype = None
        lib.kcores.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def exact_max_clique(
    adj: np.ndarray, time_limit_s: float = 3600.0, n_threads: int = 12
) -> list[int]:
    """Exact maximum clique of a dense symmetric adjacency matrix.

    Returns sorted vertex list (the reference sorts, graph.cc ...
    registration.cc:1025). On timeout the best clique found so far is
    returned (PMC behavior under in.time_limit). n_threads defaults to the
    reference's hard-coded 12 (graph.cc:38).
    """
    adj = np.ascontiguousarray(np.asarray(adj, np.uint8))
    n = adj.shape[0]
    if n == 0:
        return []
    lib = _load()
    out = np.zeros(n, np.int32)
    size = lib.max_clique(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        float(time_limit_s),
        int(n_threads),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    size = abs(int(size))
    return sorted(out[:size].tolist())


def native_core_numbers(adj: np.ndarray) -> np.ndarray:
    adj = np.ascontiguousarray(np.asarray(adj, np.uint8))
    n = adj.shape[0]
    lib = _load()
    out = np.zeros(n, np.int32)
    lib.kcores(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out


def exact_max_clique_mask(adj, active=None) -> np.ndarray:
    """Mask-shaped wrapper used by clique.kcore.max_clique_mask("exact")."""
    adj_np = np.asarray(adj, bool)
    n = adj_np.shape[0]
    if active is not None:
        act = np.asarray(active, bool)
        adj_np = adj_np & act[None, :] & act[:, None]
    members = exact_max_clique(adj_np)
    mask = np.zeros(n, bool)
    mask[members] = True
    return mask
