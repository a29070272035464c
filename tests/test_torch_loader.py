"""The port's frame loader (``utils/loader.py``), image I/O
(``read_image``, ``write_image``, ``rgb_to_gray``) and native PNM codec
(``utils/native.py``) on the CPU: the scenarios of tests/test_loader.py,
tests/test_native.py's codec part and tests/test_io.py's image part, each
against the JAX package's function on the same files (arrays equal), and
the loader feeding the port's serving path (tables equal to the JAX
package's within 1e-4 px, vals equal)."""

import numpy as np
import pytest
import torch

from pyfeaturetrack_tpu.serving import serve_stream as jax_serve_stream
from pyfeaturetrack_tpu.utils import io as jio
from pyfeaturetrack_tpu.utils.loader import FrameLoader as JaxFrameLoader

from pyfeaturetrack_tpu_torch.errors import KLTError
from pyfeaturetrack_tpu_torch.serving import serve_stream
from pyfeaturetrack_tpu_torch.utils import io, native
from pyfeaturetrack_tpu_torch.utils.loader import FrameLoader, load_frames

torch.set_num_threads(2)


@pytest.fixture
def pgm_seq(tmp_path):
    rng = np.random.default_rng(0)
    paths, imgs = [], []
    for i in range(12):
        img = rng.integers(0, 256, (24, 32), np.uint8)
        p = tmp_path / f"img{i}.pgm"
        io.pgm_write(p, img)
        paths.append(p)
        imgs.append(img)
    return paths, imgs


@pytest.mark.parametrize("workers,readahead", [(1, 1), (2, 3), (4, 16)])
def test_frames_in_order(pgm_seq, workers, readahead):
    paths, imgs = pgm_seq
    got = list(FrameLoader(paths, readahead=readahead, workers=workers))
    want = list(JaxFrameLoader(paths, readahead=readahead, workers=workers))
    assert len(got) == len(imgs) == len(want)
    for g, w, img in zip(got, want, imgs):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, img)


def test_load_frames_convenience(pgm_seq):
    paths, imgs = pgm_seq
    for g, want in zip(load_frames(paths, workers=3), imgs):
        np.testing.assert_array_equal(g, want)


def test_reader_error_surfaces_at_failed_frame(pgm_seq, tmp_path):
    paths, imgs = pgm_seq
    bad = tmp_path / "bad.pgm"
    bad.write_bytes(b"P5\n4 4\n255\n\x00")  # truncated
    it = iter(FrameLoader(paths[:3] + [bad] + paths[3:], readahead=4,
                          workers=2))
    for want in imgs[:3]:
        np.testing.assert_array_equal(next(it), want)
    with pytest.raises(KLTError):
        next(it)


def test_missing_file_raises(pgm_seq):
    paths, _ = pgm_seq
    with pytest.raises(FileNotFoundError):
        list(FrameLoader([paths[0], paths[0].parent / "nope.pgm"]))


def test_single_pass_guard(pgm_seq):
    paths, _ = pgm_seq
    ld = FrameLoader(paths[:2])
    list(ld)
    with pytest.raises(KLTError):
        list(ld)


def test_early_break_releases_workers(pgm_seq):
    paths, imgs = pgm_seq
    ld = FrameLoader(paths, readahead=2, workers=2)
    for i, frame in enumerate(ld):
        np.testing.assert_array_equal(frame, imgs[i])
        if i == 2:
            break  # generator close must cancel pending decodes cleanly


def test_empty_and_bad_params():
    assert list(FrameLoader([])) == []
    with pytest.raises(KLTError):
        FrameLoader([], readahead=0)
    with pytest.raises(KLTError):
        FrameLoader([], workers=0)


def test_custom_reader(pgm_seq):
    paths, imgs = pgm_seq
    got = list(FrameLoader(paths[:4], reader=lambda p: io.pgm_read(p).astype(
        np.float32) / 2))
    for g, want in zip(got, imgs):
        np.testing.assert_allclose(g, want.astype(np.float32) / 2)


def test_feeds_serve_stream(tmp_path):
    """Loader -> the port's serving path == an eager list through it, bit
    for bit, and == the JAX package's loader -> serving path."""
    rng = np.random.default_rng(7)
    base = np.zeros((64, 96), np.float64)
    yy, xx = np.mgrid[0:64, 0:96]
    for _ in range(40):  # textured scene with gentle drift
        cx, cy = rng.uniform(8, 88), rng.uniform(8, 56)
        base += rng.uniform(40, 90) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / rng.uniform(4, 16))
    frames, paths = [], []
    for i in range(5):
        img = np.clip(np.roll(base, (i, -i), axis=(0, 1)), 0, 255
                      ).astype(np.uint8)
        p = tmp_path / f"s{i}.pgm"
        io.pgm_write(p, img)
        frames.append(img)
        paths.append(p)
    via_loader = serve_stream(FrameLoader(paths), n_features=20, chain=2,
                              stage_uint8=True, device="cpu")
    eager = serve_stream(frames, n_features=20, chain=2, stage_uint8=True,
                         device="cpu")
    for a, b in zip(via_loader, eager):
        np.testing.assert_array_equal(a, b)
    jx, jy, jv = jax_serve_stream(JaxFrameLoader(paths), n_features=20,
                                  chain=2, stage_uint8=True)
    np.testing.assert_array_equal(via_loader[2], jv)
    np.testing.assert_allclose(via_loader[0], jx, atol=1e-4)
    np.testing.assert_allclose(via_loader[1], jy, atol=1e-4)


def _drift_frames():
    rng = np.random.default_rng(7)
    base = np.zeros((64, 96), np.float64)
    yy, xx = np.mgrid[0:64, 0:96]
    for _ in range(40):
        cx, cy = rng.uniform(8, 88), rng.uniform(8, 56)
        base += rng.uniform(40, 90) * np.exp(
            -((xx - cx) ** 2 + (yy - cy) ** 2) / rng.uniform(4, 16))
    return [np.clip(np.roll(base, (i, -i), axis=(0, 1)), 0, 255
                    ).astype(np.uint8) for i in range(5)]


def test_serve_stream_repeats_bit_for_bit():
    """serve_stream three times on the same frames, twice on this thread
    and once from a second Python thread (whose intra-op thread count is
    the process default, not this module's 2): the tables are equal bit
    for bit."""
    import threading
    frames = _drift_frames()

    def run():
        return serve_stream(frames, n_features=20, chain=2, stage_uint8=True,
                            device="cpu")

    first, second = run(), run()
    third = []
    t = threading.Thread(target=lambda: third.append(run()))
    t.start()
    t.join()
    for table in (second, third[0]):
        for a, b in zip(first, table):
            np.testing.assert_array_equal(a, b)


def test_plain_versions_run_on_the_calling_thread(monkeypatch):
    """What keeps repeated calls equal: a kernel's plain version (here
    K3's, whose torch.sqrt PyTorch would split over two threads at this
    size) runs its CPU work with one intra-op thread, from this thread and
    from a second one, blocks nest, and the count comes back after."""
    import threading
    from pyfeaturetrack_tpu_torch.ops import cuda_eig
    from pyfeaturetrack_tpu_torch.utils import cuda
    seen = []
    real = cuda_eig.compute_min_eig_map
    monkeypatch.setattr(cuda_eig, "compute_min_eig_map", lambda *a: (
        seen.append(torch.get_num_threads()), real(*a))[1])
    before = torch.get_num_threads()
    assert before > 1
    g = torch.rand(64, 96)
    first = cuda_eig.min_eig_map(g, g.flip(0), 7, 7)
    other = []
    t = threading.Thread(target=lambda: other.append(
        cuda_eig.min_eig_map(g, g.flip(0), 7, 7)))
    t.start()
    t.join()
    assert torch.equal(first, other[0])
    with cuda.calling_thread_only():
        with cuda.calling_thread_only():
            assert torch.get_num_threads() == 1
        assert torch.get_num_threads() == 1
    assert seen == [1, 1]
    assert torch.get_num_threads() == before


@pytest.mark.parametrize("first_out", ["a", "b"])
def test_calling_thread_only_keeps_each_threads_count(first_out):
    """Two Python threads inside overlapping calling_thread_only blocks
    (intra-op counts 3 and 2 before): each runs at one intra-op thread
    inside and gets its own count back after, whichever leaves first;
    this thread's count is not touched."""
    import threading
    from pyfeaturetrack_tpu_torch.utils import cuda
    before = torch.get_num_threads()
    counts = {"a": 3, "b": 2}
    both = threading.Barrier(2, timeout=30)
    left = threading.Event()
    seen = {}

    def worker(name):
        torch.set_num_threads(counts[name])
        with cuda.calling_thread_only():
            both.wait()
            seen[f"{name} inside"] = torch.get_num_threads()
            both.wait()
            if name != first_out:
                assert left.wait(30)
        seen[f"{name} after"] = torch.get_num_threads()
        left.set()

    threads = [threading.Thread(target=worker, args=(n,)) for n in counts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert seen == {"a inside": 1, "b inside": 1, "a after": 3,
                    "b after": 2}
    assert torch.get_num_threads() == before


def test_serve_stream_owns_buffered_frames():
    """A source that reuses one buffer for every frame (a camera's frame
    ring, a decoder's output) gives the table of the frames themselves:
    a frame held for a later chain step is the port's own copy."""
    frames = _drift_frames()

    def camera():
        buf = np.empty_like(frames[0])
        for f in frames:
            buf[...] = f
            yield buf

    for prefetch in (0, 2):
        got = serve_stream(camera(), n_features=20, chain=2,
                           stage_uint8=True, prefetch=prefetch, device="cpu")
        want = serve_stream(frames, n_features=20, chain=2, stage_uint8=True,
                            device="cpu")
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# The native PNM codec == the Python parse == the JAX package's reader
# ---------------------------------------------------------------------------

def _python_path(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


def _write(tmp_path, payload: bytes):
    p = tmp_path / "f.pnm"
    p.write_bytes(payload)
    return p


VALID_PGMS = [
    b"P5\n4 3\n255\n" + bytes(range(12)),
    b"P5 # binary\n# full-line comment\n 4\t3 255# abutting\n" + bytes(range(12)),
    b"P2\n3 2\n255\n0 255 17\n128 7 9\n",
    b"P2   3 2 255  0 255 17 128 7 9   ",
    b"P5\n1 1\n255\n\x2a",
]


def test_codec_builds_here():
    assert native.available()


@pytest.mark.parametrize("payload", VALID_PGMS)
def test_pnm_native_matches_python_and_jax(tmp_path, monkeypatch, payload):
    p = _write(tmp_path, payload)
    got_native = io.pgm_read(p)
    np.testing.assert_array_equal(got_native, jio.pgm_read(p))
    _python_path(monkeypatch)
    np.testing.assert_array_equal(io.pgm_read(p), got_native)


MALFORMED_PNMS = [
    b"",                                   # empty
    b"P5",                                 # header EOF
    b"P5\n4\n",                            # missing dims
    b"P7\n4 3\n255\n",                     # bad magic
    b"Px\n4 3\n255\n",                     # bad magic
    b"P5\n4 x3\n255\n" + bytes(12),        # malformed width
    b"P5\n-4 3\n255\n" + bytes(12),        # negative dim
    b"P5\n4 3\n70000\n" + bytes(12),       # maxval > 255
    b"P5\n4 3\n255\n\x00\x01",             # truncated binary payload
    b"P2\n4 3\n255\n1 2 3",                # truncated ascii payload
    b"P2\n2 2\n255\n1 2 3 999",            # ascii value out of range
    b"P2\n2 2\n255\n1 2 -3 4",             # ascii negative value
    b"P2\n2 2\n255\n1 2 zz 4",             # ascii non-numeric
    b"P6\n2 2\n255\n" + bytes(12),         # PPM fed to pgm_read
]


@pytest.mark.parametrize("payload", MALFORMED_PNMS)
def test_pnm_native_matches_python_malformed(tmp_path, monkeypatch,
                                             payload):
    p = _write(tmp_path, payload)
    with pytest.raises(KLTError):
        io.pgm_read(p)
    _python_path(monkeypatch)
    with pytest.raises(KLTError):
        io.pgm_read(p)


def test_ppm_native_matches_python(tmp_path, monkeypatch):
    rgb = np.arange(24, dtype=np.uint8).reshape(2, 4, 3)
    p = tmp_path / "f.ppm"
    io.ppm_write(p, rgb)
    got_native = io.ppm_read(p)
    np.testing.assert_array_equal(got_native, jio.ppm_read(p))
    got_native[0, 0, 0] = 99  # must be writable, like the Python path
    _python_path(monkeypatch)
    np.testing.assert_array_equal(io.ppm_read(p), rgb)
    for payload in (b"P5\n2 2\n255\n" + bytes(4),  # PGM fed to ppm_read
                    b"P6\n2 2\n255\n\x00"):        # truncated
        q = _write(tmp_path, payload)
        with pytest.raises(KLTError):
            io.ppm_read(q)


# ---------------------------------------------------------------------------
# read_image / write_image / rgb_to_gray against the JAX package's
# ---------------------------------------------------------------------------

def _gray(seed=0, h=24, w=32):
    return np.random.default_rng(seed).integers(0, 256, (h, w),
                                                dtype=np.uint8)


def test_read_image_formats_match_jax(tmp_path):
    """pgm, png (through PIL), ppm (luma) and both kinds of .pnm decode
    as the JAX package decodes them."""
    rgb = np.stack([_gray(8), _gray(9), _gray(10)], axis=-1)
    files = {"a.pgm": _gray(1), "b.png": _gray(2), "c.ppm": rgb,
             "g.pnm": _gray(7), "c.pnm": rgb}
    for name, img in files.items():
        p = tmp_path / name
        if name.endswith(".pnm"):
            (io.pgm_write if img.ndim == 2 else io.ppm_write)(p, img)
        else:
            io.write_image(p, img)
        got = io.read_image(p)
        assert got.dtype == np.uint8 and got.shape == img.shape[:2]
        np.testing.assert_array_equal(got, jio.read_image(p))
    np.testing.assert_array_equal(io.read_image(tmp_path / "b.png"),
                                  files["b.png"])
    np.testing.assert_array_equal(io.rgb_to_gray(rgb), jio.rgb_to_gray(rgb))


def test_write_image_matches_jax_bytes(tmp_path):
    img = _gray(5)
    rgb = np.stack([img, _gray(6), img], -1)
    for name, a in (("w.pgm", img), ("w.ppm", rgb), ("w.png", rgb)):
        io.write_image(tmp_path / name, a)
        jio.write_image(tmp_path / ("j" + name), a)
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / ("j" + name)).read_bytes()
    assert (tmp_path / "w.pgm").read_bytes().startswith(b"P5\n")


def test_read_image_corrupt_file_raises_klt_error(tmp_path):
    p = tmp_path / "bad.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n not actually a png")
    with pytest.raises(KLTError):
        io.read_image(p)


def test_frame_loader_mixed_formats(tmp_path):
    imgs = [_gray(10 + i) for i in range(3)]
    paths = [tmp_path / "f0.pgm", tmp_path / "f1.png", tmp_path / "f2.ppm"]
    io.pgm_write(paths[0], imgs[0])
    io.write_image(paths[1], imgs[1])
    io.ppm_write(paths[2], np.stack([imgs[2]] * 3, -1))  # gray RGB
    for got, want in zip(load_frames(paths), imgs):
        np.testing.assert_array_equal(got, want)
