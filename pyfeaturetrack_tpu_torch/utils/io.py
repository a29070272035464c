"""PGM image I/O (reference parity: pnmio.py -> pgmReadFile / pgmWriteFile).

Port of the PGM half of ``pyfeaturetrack_tpu/utils/io.py`` (its pure-Python
parser; the native codec and the feature list/table formats are not in
the port yet). NumPy only.
"""

from __future__ import annotations

import numpy as np

from ..errors import KLTError


def _read_pnm_token(f) -> bytes:
    """Read one whitespace-delimited token, skipping '#' comments.

    A '#' abutting a token ("24# comment") terminates the token (the
    comment runs to end-of-line), per common netpbm parsing."""
    tok = b""
    while True:
        c = f.read(1)
        if not c:
            if tok:
                return tok
            raise KLTError("(pnm) unexpected end of file in header")
        if c == b"#":
            f.readline()
            if tok:
                return tok
            continue
        if c.isspace():
            if tok:
                return tok
            continue
        tok += c


def _pnm_int(f, path, what: str) -> int:
    """Header token as a non-negative int, or KLTError (not ValueError)."""
    tok = _read_pnm_token(f)
    try:
        val = int(tok)
    except ValueError:
        raise KLTError(f"(pnm) {path}: malformed {what} {tok!r}") from None
    if val < 0:
        raise KLTError(f"(pnm) {path}: negative {what} {val}")
    return val


def pgm_read(path) -> np.ndarray:
    """Read a binary (P5) or ascii (P2) PGM file -> uint8 [H, W].

    Like the reference's 8-bit-only pnmio, maxval > 255 is rejected.
    """
    with open(path, "rb") as f:
        magic = _read_pnm_token(f)
        if magic not in (b"P5", b"P2"):
            raise KLTError(f"(pgm_read) {path}: not a PGM file (magic {magic!r})")
        ncols = _pnm_int(f, path, "width")
        nrows = _pnm_int(f, path, "height")
        maxval = _pnm_int(f, path, "maxval")
        if maxval > 255:
            raise KLTError(f"(pgm_read) {path}: maxval {maxval} > 255 unsupported")
        if magic == b"P5":
            data = f.read(nrows * ncols)
            if len(data) != nrows * ncols:
                raise KLTError(f"(pgm_read) {path}: truncated pixel data")
            img = np.frombuffer(data, dtype=np.uint8)
        else:
            vals = f.read().split()
            if len(vals) < nrows * ncols:
                raise KLTError(f"(pgm_read) {path}: truncated pixel data "
                               f"({len(vals)} of {nrows * ncols} values)")
            try:
                img = np.array([int(v) for v in vals[:nrows * ncols]],
                               dtype=np.uint8)
            except (ValueError, OverflowError):
                raise KLTError(
                    f"(pgm_read) {path}: bad pixel data (non-numeric or "
                    "outside 0..255)") from None
    return img.reshape(nrows, ncols)


def pgm_write(path, img: np.ndarray) -> None:
    """Write a binary (P5) PGM. Reference parity: pnmio.py -> pgmWriteFile."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    nrows, ncols = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (ncols, nrows))
        f.write(img.tobytes())
