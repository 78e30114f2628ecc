"""ctypes loader for the native BC decoders (native/bcdec.cpp).

Compiles the shared library on first use (g++ -O3, cached next to the
source), injects the BC7 partition/anchor tables, and exposes
numpy-in/numpy-out wrappers with the exact signatures of the reference
implementations in bcdec.py / bc6h.py. Falls back cleanly when no
compiler is available (``available()`` returns False) — set
TPURAST_NATIVE=0 to force the numpy path.
"""

from __future__ import annotations

import ctypes
import logging
import os
import pathlib
import subprocess

import numpy as np

log = logging.getLogger("tpurast.native")

_SRC = pathlib.Path(__file__).resolve().parent.parent.parent / "native" / "bcdec.cpp"
_LIB = _SRC.parent / "libbcdec.so"
_lib = None
_tried = False


def _build() -> bool:
    if not _SRC.exists():
        return False
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return True
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(_LIB), str(_SRC)],
            check=True,
            capture_output=True,
        )
        return True
    except (OSError, subprocess.CalledProcessError) as e:
        log.warning("native bcdec build failed (%s); using numpy decoders", e)
        return False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("TPURAST_NATIVE", "1") == "0":
        return None
    if not _build():
        return None
    lib = ctypes.CDLL(str(_LIB))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.bc7_init.argtypes = [i32p] * 5
    lib.decode_bc7.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.decode_bc4.argtypes = [u8p, ctypes.c_int64, u8p]
    lib.decode_bc6h.argtypes = [u8p, ctypes.c_int64, u16p]
    lib.decode_bc6h_sf.argtypes = [u8p, ctypes.c_int64, u16p]

    from tpurast.assets import _bc7_tables as t

    lib.bc7_init(
        np.ascontiguousarray(t.PARTITIONS_2, dtype=np.int32),
        np.ascontiguousarray(t.PARTITIONS_3, dtype=np.int32),
        np.ascontiguousarray(t.ANCHOR_SECOND_2, dtype=np.int32),
        np.ascontiguousarray(t.ANCHOR_SECOND_3, dtype=np.int32),
        np.ascontiguousarray(t.ANCHOR_THIRD_3, dtype=np.int32),
    )
    _lib = lib
    log.debug("native bcdec loaded from %s", _LIB)
    return _lib


def available() -> bool:
    return _load() is not None


def decode_bc7(blocks: np.ndarray) -> np.ndarray:
    lib = _load()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    out = np.empty((blocks.shape[0], 4, 4, 4), dtype=np.uint8)
    lib.decode_bc7(blocks, blocks.shape[0], out.reshape(-1))
    return out


def decode_bc4(blocks: np.ndarray) -> np.ndarray:
    lib = _load()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 8)
    out = np.empty((blocks.shape[0], 4, 4), dtype=np.uint8)
    lib.decode_bc4(blocks, blocks.shape[0], out.reshape(-1))
    return out


def decode_bc6h(blocks: np.ndarray, signed: bool = False) -> np.ndarray:
    lib = _load()
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    half = np.empty((blocks.shape[0], 16, 3), dtype=np.uint16)
    fn = lib.decode_bc6h_sf if signed else lib.decode_bc6h
    fn(blocks, blocks.shape[0], half.reshape(-1))
    return half.view(np.float16).astype(np.float32).reshape(-1, 4, 4, 3)
