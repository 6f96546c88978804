"""ctypes bridge to the native C++ oracle (golden model, fast path).

Builds ``native/liboracle.so`` on first use when a compiler is available
(guard with LDPC_NO_NATIVE=1); falls back to the NumPy model otherwise.
Bit-for-bit identical to ``golden.decoder.decode_golden`` — enforced by
tests/test_native_oracle.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..codes.code import LdpcCode
from .decoder import GoldenParams

__all__ = [
    "native_available",
    "decode_golden_native",
    "syndrome_ok_native",
    "encode_accumulate_native",
    "simd_available",
    "decode_simd_native",
    "awgn_quantize_native",
]

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liboracle.so")
_ALGO_IDS = {"MS": 0, "OMS": 1, "NMS": 2, "2NMS": 3}

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("LDPC_NO_NATIVE") == "1":
        return None
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.ldpc_decode_golden.argtypes = [
        i32p, i32p, ctypes.c_int, i32p, ctypes.c_int,
        i8p, ctypes.c_int, ctypes.c_int, i8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i32p,
    ]
    lib.ldpc_decode_golden.restype = None
    lib.ldpc_syndrome_ok.argtypes = [
        i32p, i32p, ctypes.c_int, i32p, i8p,
        ctypes.c_int, ctypes.c_int, i8p,
    ]
    lib.ldpc_syndrome_ok.restype = ctypes.c_int
    lib.ldpc_encode_accumulate.argtypes = [
        i32p, i32p, ctypes.c_int64, i8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, i8p, ctypes.c_int,
    ]
    lib.ldpc_encode_accumulate.restype = None
    lib.ldpc_simd_lanes.argtypes = []
    lib.ldpc_simd_lanes.restype = ctypes.c_int
    lib.ldpc_decode_simd.argtypes = [
        i32p, i32p, ctypes.c_int, i32p, ctypes.c_int,
        i8p, ctypes.c_int, ctypes.c_int, i8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, i32p,
    ]
    lib.ldpc_decode_simd.restype = None
    lib.ldpc_awgn_quantize.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, i8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, i8p,
    ]
    lib.ldpc_awgn_quantize.restype = None
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load() is not None


def _code_arrays(code: LdpcCode):
    degs = np.asarray([c.deg for c in code.classes], np.int32)
    counts = np.asarray([c.count for c in code.classes], np.int32)
    edges = np.ascontiguousarray(code.edges, np.int32)
    return degs, counts, edges


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _p8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def decode_golden_native(
    code: LdpcCode,
    llr: np.ndarray,
    params: GoldenParams = GoldenParams(),
) -> tuple[np.ndarray, np.ndarray]:
    """Batched golden decode: llr [B, N] int8 -> (bits [B, N] int8,
    iters_used [B] int32)."""
    lib = _load()
    assert lib is not None, "native oracle unavailable"
    llr = np.ascontiguousarray(llr, np.int8)
    if llr.ndim == 1:
        llr = llr[None, :]
    b, n = llr.shape
    assert n == code.N
    degs, counts, edges = _code_arrays(code)
    out = np.empty((b, n), np.int8)
    used = np.empty(b, np.int32)
    lib.ldpc_decode_golden(
        _p32(degs), _p32(counts), len(code.classes),
        _p32(edges), edges.size,
        _p8(llr), b, n, _p8(out),
        _ALGO_IDS[params.algo], params.iters, params.offset,
        1 if params.minclamp == "pre" else 0,
        1 if params.early_term else 0,
        params.sat_var, params.sat_msg,
        # float factors are /32-exact by contract (GoldenParams docstring);
        # the native oracle computes (min * f32) >> 5
        int(round(params.nms_factor * 32)),
        int(round(params.nms_factor2 * 32)),
        _p32(used),
    )
    return out, used


def encode_accumulate_native(
    scatter_pos: np.ndarray,
    scatter_bit: np.ndarray,
    info: np.ndarray,
    n: int,
    k: int,
) -> np.ndarray:
    """Batched accumulate+staircase encode: info [B, K] -> codewords [B, N]."""
    lib = _load()
    assert lib is not None, "native oracle unavailable"
    pos = np.ascontiguousarray(scatter_pos, np.int32)
    bit = np.ascontiguousarray(scatter_bit, np.int32)
    info = np.ascontiguousarray(info, np.int8)
    b = info.shape[0]
    out = np.empty((b, n), np.int8)
    lib.ldpc_encode_accumulate(
        _p32(pos), _p32(bit), pos.size, _p8(info), b, k, n - k, _p8(out), n
    )
    return out


def syndrome_ok_native(code: LdpcCode, bits: np.ndarray) -> np.ndarray:
    """Per-frame syndrome satisfaction for bits [B, N] -> bool [B]."""
    lib = _load()
    assert lib is not None, "native oracle unavailable"
    bits = np.ascontiguousarray(bits, np.int8)
    if bits.ndim == 1:
        bits = bits[None, :]
    b, n = bits.shape
    degs, counts, edges = _code_arrays(code)
    ok = np.empty(b, np.int8)
    lib.ldpc_syndrome_ok(
        _p32(degs), _p32(counts), len(code.classes), _p32(edges),
        _p8(bits), b, n, _p8(ok),
    )
    return ok.astype(bool)


def simd_available() -> bool:
    """True when liboracle.so was built with AVX-512BW (64-lane path)."""
    lib = _load()
    return lib is not None and int(lib.ldpc_simd_lanes()) > 0


def decode_simd_native(
    code: LdpcCode,
    llr: np.ndarray,
    params: GoldenParams = GoldenParams(),
) -> tuple[np.ndarray, int]:
    """Batched AVX-512 decode: llr [B, N] int8 -> (bits [B, N] int8,
    iters_used int) — 64 frames per vector, OpenMP over blocks, per-lane
    early-termination freeze.  Bit-for-bit identical to
    ``decode_golden`` / the JAX paths (tests/test_native_oracle.py)."""
    lib = _load()
    assert lib is not None and int(lib.ldpc_simd_lanes()) > 0, (
        "SIMD decoder unavailable (no AVX-512BW build)"
    )
    llr = np.ascontiguousarray(llr, np.int8)
    if llr.ndim == 1:
        llr = llr[None, :]
    b, n = llr.shape
    assert n == code.N
    degs, counts, edges = _code_arrays(code)
    out = np.empty((b, n), np.int8)
    used = np.zeros(1, np.int32)
    lib.ldpc_decode_simd(
        _p32(degs), _p32(counts), len(code.classes),
        _p32(edges), edges.size,
        _p8(llr), b, n, _p8(out),
        _ALGO_IDS[params.algo], params.iters, params.offset,
        1 if params.minclamp == "pre" else 0,
        1 if params.early_term else 0,
        params.sat_var, params.sat_msg,
        int(round(params.nms_factor * 32)),
        int(round(params.nms_factor2 * 32)),
        used.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, int(used[0])


def awgn_quantize_native(
    seed: int,
    stream: int,
    frames: int,
    n: int,
    sigma: float,
    factor: float,
    sat: int = 31,
    coded: Optional[np.ndarray] = None,
    amp: float = 1.0,
) -> np.ndarray:
    """Counter-based Philox AWGN + BPSK/QPSK(amp) + trunc-quantize (the
    native C2 analogue).  Deterministic in (seed, stream, frame, position);
    statistically identical to channel.awgn's threefry path (different
    stream) — see tests/test_native_oracle.py's distribution check."""
    lib = _load()
    assert lib is not None, "native library unavailable"
    out = np.empty((frames, n), np.int8)
    cptr = _p8(np.ascontiguousarray(coded, np.int8)) if coded is not None \
        else ctypes.POINTER(ctypes.c_int8)()
    lib.ldpc_awgn_quantize(
        ctypes.c_uint64(seed), ctypes.c_uint64(stream), cptr,
        frames, n, ctypes.c_float(amp), ctypes.c_float(sigma),
        ctypes.c_float(factor), int(sat), _p8(out),
    )
    return out
