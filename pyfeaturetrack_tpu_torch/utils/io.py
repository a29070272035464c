"""PNM image I/O and feature list/table files.

Reference parity: pnmio.py (PGM/PPM read+write), writeFeatures.py
(KLTWriteFeatureList / KLTReadFeatureList / KLTWriteFeatureTable /
KLTReadFeatureTable) and storeFeatures.py table layout. Port of
``pyfeaturetrack_tpu/utils/io.py``: PNM files parse through the native
codec (``utils/native``, ``native/pnm_codec.cpp``) where it builds, else
in Python with the same results and errors; ``read_image`` and
``write_image`` take other formats through PIL, imported only for them. Files are byte-identical to the JAX package's: binary lists
are ``KLTFL`` + int32 count + (float32 x, float32 y, int32 val) records,
binary tables ``KLTFT`` + int32 (frames, features) + feature-major
records, and the text forms are the same formatted lines.

Readers return tensors on ``device`` (default "cuda").
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np
import torch

from ..errors import KLTError
from ..features import (FeatureState, FeatureTable, feature_state_from_numpy,
                        feature_state_to_numpy)

BINHEADER_FL = b"KLTFL"
BINHEADER_FT = b"KLTFT"


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


def _pnm_read_native(path, who: str) -> np.ndarray | None:
    """The native codec's read shared by pgm_read/ppm_read (None when the
    codec is not available: the callers parse in Python). Every malformed
    input is a KLTError, as in the Python parse."""
    from . import native
    if not native.available():
        return None
    data = Path(path).read_bytes()
    rc, fmt, ncols, nrows, maxval, off = native.pnm_parse_header(data)
    if rc == native.PNM_TRUNCATED:
        raise KLTError(f"(pnm) {path}: unexpected end of file in header")
    if rc == native.PNM_BAD_MAGIC or (who == "pgm_read" and fmt == 6) \
            or (who == "ppm_read" and fmt != 6):
        kind = "a PGM" if who == "pgm_read" else "a binary PPM"
        raise KLTError(f"({who}) {path}: not {kind} file")
    if rc != 0:
        raise KLTError(f"(pnm) {path}: malformed header token")
    if maxval > 255:
        raise KLTError(f"({who}) {path}: maxval {maxval} > 255 unsupported")
    npix = nrows * ncols * (3 if fmt == 6 else 1)
    if fmt == 2:
        n, pix = native.pnm_decode_ascii(data[off:], npix)
        if n == native.PNM_BAD_TOKEN:
            raise KLTError(f"({who}) {path}: bad pixel data (non-numeric "
                           "or outside 0..255)")
        if n != npix:
            raise KLTError(f"({who}) {path}: truncated pixel data "
                           f"({n} of {npix} values)")
        img = pix
    else:
        if len(data) - off < npix:
            raise KLTError(f"({who}) {path}: truncated pixel data")
        img = np.frombuffer(data, np.uint8, count=npix, offset=off)
    shape = (nrows, ncols, 3) if fmt == 6 else (nrows, ncols)
    return img.reshape(shape)


def pgm_read(path) -> np.ndarray:
    """Read a binary (P5) or ascii (P2) PGM file -> uint8 [H, W].

    Like the reference's 8-bit-only pnmio, maxval > 255 is rejected.
    Parsed by the native codec where it builds (the per-byte Python
    header parse is the ingest bottleneck at serving rates), else here.
    """
    img = _pnm_read_native(path, "pgm_read")
    if img is not None:
        return img
    return _pgm_read_python(path)


def _pgm_read_python(path) -> np.ndarray:
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


def ppm_write(path, rgb: np.ndarray) -> None:
    """Write a binary (P6) PPM from an [H, W, 3] array.

    Reference parity: pnmio.py -> ppmWriteFileRGB.
    """
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8:
        rgb = np.clip(rgb, 0, 255).astype(np.uint8)
    nrows, ncols, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (ncols, nrows))
        f.write(rgb.tobytes())


def ppm_read(path) -> np.ndarray:
    """Read a binary (P6) PPM -> uint8 [H, W, 3] (the native codec where
    it builds, as pgm_read)."""
    img = _pnm_read_native(path, "ppm_read")
    if img is not None:
        return img.copy()  # writable, like the Python path
    return _ppm_read_python(path)


def _ppm_read_python(path) -> np.ndarray:
    with open(path, "rb") as f:
        magic = _read_pnm_token(f)
        if magic != b"P6":
            raise KLTError(f"(ppm_read) {path}: not a binary PPM")
        ncols = _pnm_int(f, path, "width")
        nrows = _pnm_int(f, path, "height")
        maxval = _pnm_int(f, path, "maxval")
        if maxval > 255:
            raise KLTError(f"(ppm_read) {path}: maxval {maxval} > 255 unsupported")
        data = f.read(nrows * ncols * 3)
        if len(data) != nrows * ncols * 3:
            raise KLTError(f"(ppm_read) {path}: truncated pixel data")
    return np.frombuffer(data, dtype=np.uint8).reshape(nrows, ncols, 3).copy()


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma (the PIL 'L' convention), rounded to uint8:
    L = (299 R + 587 G + 114 B + 500) // 1000."""
    rgb = np.asarray(rgb).astype(np.uint32)
    luma = (299 * rgb[..., 0] + 587 * rgb[..., 1] + 114 * rgb[..., 2]
            + 500) // 1000
    return luma.astype(np.uint8)


def read_image(path) -> np.ndarray:
    """Read any image file -> uint8 grayscale [H, W].

    PGM goes through :func:`pgm_read`; PPM through :func:`ppm_read` and
    ITU-R 601 luma; a ``.pnm`` by its magic bytes; any other file is
    decoded by PIL (imported here, for such files only) and converted to
    mode 'L'.
    """
    p = str(path)
    ext = p.rsplit(".", 1)[-1].lower() if "." in p else ""
    if ext == "pgm":
        return pgm_read(path)
    if ext == "ppm":
        return rgb_to_gray(ppm_read(path))
    if ext == "pnm":
        # P2/P5 gray -> pgm_read, P6 color -> ppm_read; P3 and anything
        # else fall to PIL below, which decodes ascii PPM too
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic in (b"P2", b"P5"):
            return pgm_read(path)
        if magic == b"P6":
            return rgb_to_gray(ppm_read(path))
    try:
        from PIL import Image
    except ImportError as e:
        raise KLTError(
            f"(read_image) {path}: non-PNM formats need PIL ({e})") from e
    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("L"), dtype=np.uint8)
    except Exception as e:
        raise KLTError(f"(read_image) {path}: {e}") from e


def write_image(path, img: np.ndarray) -> None:
    """Write a uint8 image: [H, W] grayscale or [H, W, 3] RGB. PGM/PPM
    use the reference-parity writers; other extensions go through PIL
    (e.g. ``.png`` overlays for tools that cannot read PNM)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    p = str(path)
    ext = p.rsplit(".", 1)[-1].lower() if "." in p else ""
    if ext in ("pgm", "pnm") and img.ndim == 2:
        pgm_write(path, img)
        return
    if ext == "ppm" and img.ndim == 3:
        ppm_write(path, img)
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise KLTError(
            f"(write_image) {path}: non-PNM formats need PIL ({e})") from e
    try:
        Image.fromarray(img).save(path)
    except Exception as e:
        raise KLTError(f"(write_image) {path}: {e}") from e


def float_image_to_pgm(path, img: np.ndarray, scale: bool = True) -> None:
    """Debug-dump a float image to PGM (abs then optionally rescaled to 255).

    Reference parity: klt_util.py -> _KLTWriteFloatImageToPGM /
    _KLTWriteAbsFloatImageToPGM.
    """
    a = np.abs(np.asarray(img, dtype=np.float64))
    mx = a.max()
    if scale and mx > 0:
        a = a * (255.0 / mx)
    pgm_write(path, np.floor(a))


# ---------------------------------------------------------------------------
# Feature list files (reference parity: writeFeatures.py)
# ---------------------------------------------------------------------------

def write_feature_list(fl: FeatureState, path, fmt: str | None = None) -> None:
    """Write a feature list; binary if ``fmt`` is None, else formatted text
    with ``fmt`` as the per-coordinate %-format (e.g. "%5.1f").

    Reference parity: writeFeatures.py -> KLTWriteFeatureList.
    """
    arr = feature_state_to_numpy(fl)
    path = Path(path)
    if fmt is None:
        with open(path, "wb") as f:
            f.write(BINHEADER_FL)
            f.write(struct.pack("<i", arr.shape[0]))
            for x, y, v in arr:
                f.write(struct.pack("<ffi", float(x), float(y), int(v)))
        return
    with open(path, "w") as f:
        f.write("\n")
        f.write("Feature List\n")
        f.write("------------\n\n")
        f.write(f"nFeatures = {arr.shape[0]}\n\n")
        f.write("feature | (x,y) = val\n")
        f.write("--------|------------\n")
        for i, (x, y, v) in enumerate(arr):
            sx, sy = fmt % x, fmt % y
            f.write(f"{i:7d} | ({sx},{sy}) = {int(v)}\n")


def read_feature_list(path, device="cuda") -> FeatureState:
    """Read a feature list file (binary or text) onto ``device``.

    Reference parity: writeFeatures.py -> KLTReadFeatureList.
    """
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(5)
        if head == BINHEADER_FL:
            raw = f.read(4)
            if len(raw) != 4:
                raise KLTError(f"(read_feature_list) {path}: truncated "
                               "nFeatures field")
            (n,) = struct.unpack("<i", raw)
            if n < 0:
                raise KLTError(f"(read_feature_list) {path}: negative "
                               f"nFeatures {n}")
            body = f.read(12 * n)
            if len(body) != 12 * n:
                raise KLTError(f"(read_feature_list) {path}: truncated "
                               f"records ({len(body)} of {12 * n} bytes)")
            arr = np.zeros((n, 3), dtype=np.float64)
            for i in range(n):
                arr[i] = struct.unpack_from("<ffi", body, 12 * i)
            return feature_state_from_numpy(arr, device=device)
    text = path.read_text()
    m = re.search(r"nFeatures\s*=\s*(\d+)", text)
    if not m:
        raise KLTError(f"(read_feature_list) {path}: no nFeatures header")
    n = int(m.group(1))
    rows = re.findall(
        r"^\s*(\d+)\s*\|\s*\(\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)\s*\)\s*=\s*(-?\d+)",
        text, re.M)
    if len(rows) != n:
        raise KLTError(
            f"(read_feature_list) {path}: expected {n} rows, found {len(rows)}")
    arr = np.zeros((n, 3), dtype=np.float64)
    for idx, x, y, v in rows:
        i = int(idx)
        if i >= n:
            raise KLTError(f"(read_feature_list) {path}: row index {i} "
                           f"out of range for nFeatures {n}")
        arr[i] = (float(x), float(y), int(v))
    return feature_state_from_numpy(arr, device=device)


# ---------------------------------------------------------------------------
# Feature table files (reference parity: writeFeatures.py / storeFeatures.py)
# ---------------------------------------------------------------------------

def write_feature_table(ft: FeatureTable, path, fmt: str | None = None) -> None:
    """Write a feature table; binary if ``fmt`` is None (feature-major
    record order, as in the KLT lineage), else formatted text.

    Reference parity: writeFeatures.py -> KLTWriteFeatureTable.
    """
    x = ft.x.cpu().numpy().astype(np.float64)
    y = ft.y.cpu().numpy().astype(np.float64)
    v = ft.val.cpu().numpy().astype(np.int64)
    n_frames, n_features = x.shape
    path = Path(path)
    if fmt is None:
        rec = np.empty((n_features, n_frames),
                       dtype=[("x", "<f4"), ("y", "<f4"), ("v", "<i4")])
        rec["x"] = x.T
        rec["y"] = y.T
        rec["v"] = v.T
        with open(path, "wb") as f:
            f.write(BINHEADER_FT)
            f.write(struct.pack("<ii", n_frames, n_features))
            f.write(rec.tobytes())  # feature-major records, one shot
        return
    with open(path, "w") as f:
        f.write("\n")
        f.write("Feature Table\n")
        f.write("-------------\n\n")
        f.write(f"nFrames = {n_frames}, nFeatures = {n_features}\n\n")
        f.write("feature |          frame\n")
        f.write("        |" + "".join(f"{i:^22d}" for i in range(n_frames)) + "\n")
        f.write("--------|" + "-" * (22 * n_frames) + "\n")
        for j in range(n_features):
            cells = []
            for i in range(n_frames):
                sx, sy = fmt % x[i, j], fmt % y[i, j]
                cells.append(f"({sx},{sy})={int(v[i, j]):<4d}")
            f.write(f"{j:7d} |" + " ".join(cells) + "\n")


def _table(x, y, v, device) -> FeatureTable:
    return FeatureTable(
        x=torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device),
        y=torch.as_tensor(np.ascontiguousarray(y, np.float32), device=device),
        val=torch.as_tensor(np.ascontiguousarray(v, np.int32), device=device))


def read_feature_table(path, device="cuda") -> FeatureTable:
    """Read a feature table file (binary or text) onto ``device``.

    Reference parity: writeFeatures.py -> KLTReadFeatureTable.
    """
    path = Path(path)
    with open(path, "rb") as f:
        head = f.read(5)
        if head == BINHEADER_FT:
            hdr = f.read(8)
            if len(hdr) != 8:
                raise KLTError(f"(read_feature_table) {path}: truncated "
                               "dims header")
            n_frames, n_features = struct.unpack("<ii", hdr)
            if n_frames < 0 or n_features < 0:
                raise KLTError(f"(read_feature_table) {path}: negative "
                               f"dims ({n_frames}, {n_features})")
            raw = f.read(n_frames * n_features * 12)
            if len(raw) != n_frames * n_features * 12:
                raise KLTError(f"(read_feature_table) {path}: truncated "
                               f"records ({len(raw)} of "
                               f"{n_frames * n_features * 12} bytes)")
            rec = np.frombuffer(
                raw, dtype=[("x", "<f4"), ("y", "<f4"), ("v", "<i4")]
            ).reshape(n_features, n_frames)
            return _table(rec["x"].T, rec["y"].T, rec["v"].T, device)
    text = path.read_text()
    m = re.search(r"nFrames\s*=\s*(\d+),\s*nFeatures\s*=\s*(\d+)", text)
    if not m:
        raise KLTError(f"(read_feature_table) {path}: no dims header")
    n_frames, n_features = int(m.group(1)), int(m.group(2))
    x = np.zeros((n_frames, n_features), np.float64)
    y = np.zeros((n_frames, n_features), np.float64)
    v = np.zeros((n_frames, n_features), np.int64)
    cell_re = re.compile(
        r"\(\s*([-\d.eE+]+)\s*,\s*([-\d.eE+]+)\s*\)\s*=\s*(-?\d+)")
    row_re = re.compile(r"^\s*(\d+)\s*\|(.*)$", re.M)
    nrows = 0
    for mrow in row_re.finditer(text):
        j = int(mrow.group(1))
        cells = cell_re.findall(mrow.group(2))
        if len(cells) != n_frames:
            continue
        if j >= n_features:
            raise KLTError(f"(read_feature_table) {path}: row index {j} "
                           f"out of range for nFeatures {n_features}")
        for i, (xx, yy, vv) in enumerate(cells):
            x[i, j], y[i, j], v[i, j] = float(xx), float(yy), int(vv)
        nrows += 1
    if nrows != n_features:
        raise KLTError(
            f"(read_feature_table) {path}: expected {n_features} rows, "
            f"found {nrows}")
    return _table(x, y, v, device)
