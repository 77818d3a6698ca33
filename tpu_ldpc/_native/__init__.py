"""Native host-side kernels: build-on-first-use C++ via ctypes.

The device hot path is Pallas/XLA; this module covers the *host* hot
paths the reference implements in C++ (SURVEY.md §2.3): cycle counting
for girth-driven construction/annealing and bit-packed GF(2) algebra
for encoder precomputation.  Every entry point has a NumPy fallback —
``lib`` is None when no compiler is available — and tests cross-check
native vs fallback results.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "native.cpp")
_SO = os.path.join(_DIR, "libldpc_native.so")


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    if (
        os.path.exists(_SO)
        and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    ):
        return _SO
    tmp = _SO + f".tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
           _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except (OSError, subprocess.SubprocessError) as e:  # no compiler etc.
        print(f"tpu_ldpc._native: build skipped ({e})", file=sys.stderr)
        if os.path.exists(tmp):
            os.unlink(tmp)
        return None


def _load():
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    ip = ctypes.c_int
    lib.qc_count_4cycles.argtypes = [i64p, ip, ip, ip]
    lib.qc_count_4cycles.restype = ctypes.c_longlong
    lib.qc_count_6cycles.argtypes = [i64p, ip, ip, ip]
    lib.qc_count_6cycles.restype = ctypes.c_longlong
    lib.qc_ace6_cost.argtypes = [i64p, ip, ip, ip, i64p]
    lib.qc_ace6_cost.restype = ctypes.c_double
    lib.qc_count_8cycles_raw.argtypes = [i64p, ip, ip, ip]
    lib.qc_count_8cycles_raw.restype = ctypes.c_longlong
    lib.qc_ace8_cost.argtypes = [i64p, ip, ip, ip, i64p]
    lib.qc_ace8_cost.restype = ctypes.c_double
    lib.gf2_rank.argtypes = [i8p, ip, ip]
    lib.gf2_rank.restype = ip
    lib.gf2_row_reduce.argtypes = [i8p, ip, ip, i8p]
    lib.gf2_row_reduce.restype = ip
    lib.gf2_inv.argtypes = [i8p, ip, i8p]
    lib.gf2_inv.restype = ip
    lib.gf2_parity_map.argtypes = [i8p, ip, ip, i8p]
    lib.gf2_parity_map.restype = ip
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.ldpc_minsum_decode.argtypes = [
        i32p, i32p, i32p, i32p, i32p, ip, ip, ip,
        f32p, ip, ip, ctypes.c_float, ctypes.c_float, ip,
        i8p, i8p, i32p,
    ]
    lib.ldpc_minsum_decode.restype = None
    return lib


lib = _load()


# ---- typed wrappers (None-safe callers should check `lib is None`) ----

def count_4cycles(B: np.ndarray, Z: int) -> int:
    B = np.ascontiguousarray(B, dtype=np.int64)
    return int(lib.qc_count_4cycles(B, B.shape[0], B.shape[1], Z))


def count_6cycles(B: np.ndarray, Z: int) -> int:
    B = np.ascontiguousarray(B, dtype=np.int64)
    return int(lib.qc_count_6cycles(B, B.shape[0], B.shape[1], Z))


def ace6_cost(B: np.ndarray, Z: int) -> float:
    B = np.ascontiguousarray(B, dtype=np.int64)
    colw = np.ascontiguousarray((B >= 0).sum(axis=0), dtype=np.int64)
    return float(lib.qc_ace6_cost(B, B.shape[0], B.shape[1], Z, colw))


def count_8cycles_raw(B: np.ndarray, Z: int) -> int:
    B = np.ascontiguousarray(B, dtype=np.int64)
    return int(lib.qc_count_8cycles_raw(B, B.shape[0], B.shape[1], Z))


def ace8_cost(B: np.ndarray, Z: int) -> float:
    B = np.ascontiguousarray(B, dtype=np.int64)
    colw = np.ascontiguousarray((B >= 0).sum(axis=0), dtype=np.int64)
    return float(lib.qc_ace8_cost(B, B.shape[0], B.shape[1], Z, colw))


def gf2_rank(M: np.ndarray) -> int:
    M = np.ascontiguousarray(M % 2, dtype=np.uint8)
    return int(lib.gf2_rank(M, M.shape[0], M.shape[1]))


def gf2_row_reduce(M: np.ndarray):
    """(rref, pivot_cols) — bit-packed native RREF, same semantics as
    the golden gf2_row_reduce (leftmost pivots, eliminated above and
    below).  Pivot columns are recovered from the rref: row r's pivot
    is its first set column (argmax on 0/1 rows)."""
    M = np.ascontiguousarray(M % 2, dtype=np.uint8)
    out = np.zeros_like(M)
    rank = int(lib.gf2_row_reduce(M, M.shape[0], M.shape[1], out))
    pivots = out[:rank].argmax(axis=1).tolist() if rank else []
    return out, pivots


def gf2_inv(M: np.ndarray) -> np.ndarray:
    M = np.ascontiguousarray(M % 2, dtype=np.uint8)
    n = M.shape[0]
    out = np.zeros((n, n), dtype=np.uint8)
    if lib.gf2_inv(M, n, out) != 0:
        raise ValueError("matrix is singular over GF(2)")
    return out


def parity_map(H_dense: np.ndarray) -> np.ndarray:
    H = np.ascontiguousarray(H_dense % 2, dtype=np.uint8)
    m, n = H.shape
    out = np.zeros((m, n - m), dtype=np.uint8)
    rc = lib.gf2_parity_map(H, m, n, out)
    if rc != 0:
        raise ValueError(f"parity part not invertible (rc={rc})")
    return out


def minsum_decode(H, llr, iters=50, alpha=0.75, beta=0.0, early_stop=True,
                  _graph_cache={}):
    """Native CPU min-sum decode (flooding), bit-exact vs the golden
    float32 model.  H: scipy sparse; llr: (batch, n) float32."""
    import scipy.sparse as sp

    # Cache key is id(H); the entry HOLDS a reference to H so the id
    # cannot be recycled by a different matrix while the entry lives.
    # (Keying by bare id() of a dead object once served a *different*
    # graph to a decode — silently wrong results.)
    key = id(H)
    g = _graph_cache.get(key)
    if g is None:
        Hc = sp.coo_matrix(H)
        order = np.lexsort((Hc.col, Hc.row))
        erow = Hc.row[order].astype(np.int32)
        ecol = Hc.col[order].astype(np.int32)
        m, n = Hc.shape
        E = len(erow)
        row_ptr = np.zeros(m + 1, dtype=np.int32)
        np.cumsum(np.bincount(erow, minlength=m), out=row_ptr[1:])
        corder = np.argsort(ecol, kind="stable").astype(np.int32)
        col_ptr = np.zeros(n + 1, dtype=np.int32)
        np.cumsum(np.bincount(ecol, minlength=n), out=col_ptr[1:])
        g = (H, erow, ecol, row_ptr, corder, col_ptr, m, n, E)
        if len(_graph_cache) > 32:
            _graph_cache.clear()
        _graph_cache[key] = g
    _, erow, ecol, row_ptr, col_edges, col_ptr, m, n, E = g
    llr = np.ascontiguousarray(llr, dtype=np.float32)
    batch = llr.shape[0]
    bits = np.zeros((batch, n), dtype=np.uint8)
    ok = np.zeros(batch, dtype=np.uint8)
    iters_used = np.zeros(batch, dtype=np.int32)
    lib.ldpc_minsum_decode(
        erow, ecol, row_ptr, col_edges, col_ptr, m, n, E,
        llr, batch, iters, alpha, beta, int(early_stop),
        bits, ok, iters_used,
    )
    return bits, ok.astype(bool), iters_used
