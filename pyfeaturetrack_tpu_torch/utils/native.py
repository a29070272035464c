"""The native host components, in C++ under ``native/`` and loaded with
ctypes; port of ``pyfeaturetrack_tpu/utils/native.py``.

* The PNM codec (``native/pnm_codec.cpp``): header parse and ascii pixel
  decode. Where it cannot be built or loaded, ``available()`` is False
  and ``utils/io`` parses in Python, with the same results and errors.
* ``enforce_min_distance`` (``native/min_distance.cpp``): the host greedy
  min-distance suppression over a sorted candidate list, a public
  utility on numpy arrays. The port's own selection runs K5 on the
  feature arrays' device instead (ops/select.py). Where the library
  cannot be built or loaded, ``enforce_min_distance`` raises.

Each source is compiled with the system ``g++`` at its first use into
``build/torch_native/`` under the repository root (rebuilt when the
source is newer).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_NATIVE = Path(__file__).resolve().parent.parent.parent / "native"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_native"

PNM_TRUNCATED = -1
PNM_BAD_MAGIC = -2
PNM_BAD_TOKEN = -3

_lock = threading.Lock()
_tried = False
_pnm_hdr = None
_pnm_asc = None
_Out5 = ctypes.c_int64 * 5
_greedy = None
_greedy_tried = False


def _compile(src_name: str, lib_name: str) -> Path | None:
    """``native/<src_name>`` built into ``build/torch_native/<lib_name>``
    (None where the source is missing or g++ fails)."""
    src = _NATIVE / src_name
    out = _BUILD / lib_name
    if not src.exists():
        return None
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                        str(src)], check=True, capture_output=True,
                       timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def _load() -> bool:
    global _tried, _pnm_hdr, _pnm_asc
    with _lock:
        if _tried:
            return _pnm_hdr is not None
        _tried = True
        path = _compile("pnm_codec.cpp", "libpft_pnm.so")
        if path is None:
            return False
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return False
        # raw CFUNCTYPE prototypes: ndpointer argument checks would cost
        # more than the header parse itself
        _pnm_hdr = ctypes.CFUNCTYPE(
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64))(("pft_pnm_parse_header", lib))
        _pnm_asc = ctypes.CFUNCTYPE(
            ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64)(
            ("pft_pnm_decode_ascii", lib))
        return True


def available() -> bool:
    """True when the codec is built and loaded."""
    return _load()


def pnm_parse_header(data: bytes):
    """Parse a PNM header from the file bytes.

    Returns (rc, fmt, width, height, maxval, data_offset): rc == 0 on
    success, else one of the PNM_* error codes (the caller maps it to a
    KLTError that names the path)."""
    if not _load():
        raise RuntimeError("the native PNM codec is not available")
    out = _Out5()
    rc = _pnm_hdr(data, len(data), out)
    return rc, out[0], out[1], out[2], out[3], out[4]


def pnm_decode_ascii(payload: bytes, npix: int):
    """Decode ascii (P2) grey values. Returns (rc, pixels): rc is the
    number of values decoded (< npix means truncated) or PNM_BAD_TOKEN;
    pixels is a uint8 array of the decoded prefix."""
    if not _load():
        raise RuntimeError("the native PNM codec is not available")
    pix = np.zeros(int(npix), np.uint8)
    rc = _pnm_asc(payload, len(payload),
                  pix.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                  int(npix))
    return int(rc), pix


def _load_greedy():
    """The greedy's C entry, built and bound at the first call (None where
    it cannot be)."""
    global _greedy, _greedy_tried
    with _lock:
        if _greedy_tried:
            return _greedy
        _greedy_tried = True
        path = _compile("min_distance.cpp", "libpft_greedy.so")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        fn = lib.pft_enforce_min_distance
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        fn.restype = ctypes.c_int64
        fn.argtypes = [i64, i64, i64, i64, ctypes.c_int64,
                       np.ctypeslib.ndpointer(np.float64,
                                              flags="C_CONTIGUOUS"),
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                       np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
        _greedy = fn
        return _greedy


def enforce_min_distance(xs: np.ndarray, ys: np.ndarray, vals: np.ndarray,
                         order: np.ndarray, feats: np.ndarray,
                         shape: tuple[int, int], mindist: int,
                         min_eigenvalue: int, overwrite_all: bool
                         ) -> np.ndarray:
    """Native greedy suppression (reference parity: selectGoodFeatures.py
    -> _enforceMinimumDistance). Candidates ``xs``/``ys``/``vals`` are
    visited in ``order``; ``feats`` (N, 3) float64 (x, y, val) is copied
    and the copy filled: with ``overwrite_all`` every slot, else the
    slots with val < 0, the kept features masking their mindist boxes
    first. Raises RuntimeError where the library cannot be built."""
    fn = _load_greedy()
    if fn is None:
        raise RuntimeError("enforce_min_distance: native/min_distance.cpp "
                           "could not be built with g++ or loaded")
    nrows, ncols = (int(v) for v in shape)
    order = np.ascontiguousarray(order, np.int64)
    xs, ys, vals = (np.ascontiguousarray(a, np.int64) for a in (xs, ys, vals))
    out = np.array(feats, dtype=np.float64, order="C", copy=True)
    # the C loop indexes its map unchecked: every pixel it may touch must
    # lie in the image
    if out.ndim != 2 or out.shape[1] != 3:
        raise ValueError("enforce_min_distance: feats is (N, 3)")
    if order.size and (order.min() < 0
                       or order.max() >= min(xs.size, ys.size, vals.size)):
        raise ValueError("enforce_min_distance: order indexes past the "
                         "candidates")
    kept = out[out[:, 2] >= 0] if not overwrite_all else out[:0]
    px = np.concatenate([xs[order], kept[:, 0].astype(np.int64)])
    py = np.concatenate([ys[order], kept[:, 1].astype(np.int64)])
    if px.size and (px.min() < 0 or px.max() >= ncols or py.min() < 0
                    or py.max() >= nrows):
        raise ValueError("enforce_min_distance: a candidate or kept feature "
                         f"lies outside the {nrows} x {ncols} image")
    fmap = np.zeros(nrows * ncols, np.uint8)
    fn(xs, ys, vals, order,
       order.shape[0], out, out.shape[0], nrows, ncols, int(mindist),
       int(min_eigenvalue), 1 if overwrite_all else 0, fmap)
    return out
