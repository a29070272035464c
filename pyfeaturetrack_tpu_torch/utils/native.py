"""The native PNM codec (``native/pnm_codec.cpp``): header parse and ascii
pixel decode in C, loaded with ctypes.

Port of the PNM-codec part of ``pyfeaturetrack_tpu/utils/native.py``. The
codec is compiled with the system ``g++`` at its first use into
``build/torch_native/`` under the repository root (rebuilt when the
source is newer). Where it cannot be built or loaded, ``available()`` is
False and ``utils/io`` parses in Python, with the same results and errors.
The JAX package's native greedy suppression is not ported: the port's
host selection runs K5 on the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / \
    "pnm_codec.cpp"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / \
    "torch_native"
_LIB_NAME = "libpft_pnm.so"

PNM_TRUNCATED = -1
PNM_BAD_MAGIC = -2
PNM_BAD_TOKEN = -3

_lock = threading.Lock()
_tried = False
_pnm_hdr = None
_pnm_asc = None
_Out5 = ctypes.c_int64 * 5


def _compile() -> Path | None:
    out = _BUILD / _LIB_NAME
    if not _SRC.exists():
        return None
    if out.exists() and out.stat().st_mtime >= _SRC.stat().st_mtime:
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                        str(_SRC)], check=True, capture_output=True,
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
        path = _compile()
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
