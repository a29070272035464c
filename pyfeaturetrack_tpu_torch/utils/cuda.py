"""Build, load and dispatch the port's hand-written CUDA kernels.

All ``csrc/*.cu`` files are compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together) and linked into one shared
library with a plain C interface, ``build/torch_kernels/
libpft_torch_kernels.so`` under the repository root, at the first kernel
call; the library is rebuilt whenever a source is newer than it. It is
loaded with ``ctypes``: every pointer and the stream pass as
``c_void_p``. Nothing here runs at import time, so the package imports on
machines with no CUDA toolkit.

Dispatch rule (``use_kernel``): a CUDA tensor launches the kernel (or the
call raises), a CPU tensor takes the kernel's plain PyTorch version. The
only way to run a plain version on CUDA tensors is the explicit
``reference_path()`` context, which the kernel-vs-plain comparisons use.

Gradients (``with_plain_vjp``): when autograd records a kernel call (grad
mode on, an input requiring grad), the launch runs inside a
``torch.autograd.Function`` whose backward is the plain version's
vector-Jacobian product, so the card route differentiates like the CPU
route. Otherwise the call launches the kernel alone.

A plain version runs its CPU work on the calling thread alone
(``plain_version``): PyTorch splits an elementwise op of a few thousand
elements (``torch.sqrt`` of a 64 x 96 map) over its intra-op OpenMP
threads, and a worker thread can round differently from the caller (seen
after the JAX package's first XLA computation in the same process: the
lower half of a min-eig map off by one), so the same call gave two
results. On the calling thread the bits depend on the inputs only.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
_LIB_NAME = "libpft_torch_kernels.so"
# -fmad=false: products and sums round separately, as in the plain
# PyTorch versions (no fused multiply-add contraction).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_functions: dict[str, object] = {}
_force_reference = False
build_info: dict = {}

c_ptr = ctypes.c_void_p
c_int = ctypes.c_int
c_float = ctypes.c_float


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ at their first call")
    return found


def build() -> Path:
    """Compile csrc/*.cu into the kernel library if it is missing or older
    than a source. Records the command, seconds and ptxas report in
    ``build_info``."""
    out = _BUILD / _LIB_NAME
    srcs = sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))
    newest = max(s.stat().st_mtime for s in srcs)
    if out.exists() and out.stat().st_mtime >= newest:
        if not build_info:
            build_info.update(path=str(out), seconds=0.0, rebuilt=False)
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in srcs if s.suffix == ".cu"):
        obj = _BUILD / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs = []
    for obj, cmd, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            for _, _, other in jobs:
                other.kill()
            raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{err}")
        logs.append(err)
    tmp = out.with_suffix(f".{tag}")
    link = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o, _, _ in jobs)]
    res = subprocess.run(link, capture_output=True, text=True)
    for obj, _, _ in jobs:
        obj.unlink()
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    build_info.update(path=str(out), seconds=time.perf_counter() - t0,
                      rebuilt=True,
                      command=" ".join(jobs[0][1][:-4] + ["-c", "<src>"]),
                      log="".join(logs))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
            _lib.pft_error_string.argtypes = [c_int]
            _lib.pft_error_string.restype = ctypes.c_char_p
        return _lib


def function(name: str, argtypes: list):
    """A C entry point of the library with its argtypes set."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(library(), name)
        fn.argtypes = argtypes
        fn.restype = c_int
        _functions[name] = fn
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a refused launch or bad argument."""
    if rc != 0:
        msg = library().pft_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def use_kernel(*tensors: torch.Tensor) -> bool:
    """True when the kernel must launch: every tensor is on one CUDA device
    and no ``reference_path()`` is active. CPU tensors take the plain
    version; a mix of devices raises."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return not _force_reference
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


_serial = threading.local()


@contextlib.contextmanager
def calling_thread_only():
    """Run the enclosed PyTorch CPU work on the calling thread: this
    thread's intra-op thread count (``torch.set_num_threads`` acts on the
    calling thread alone) is 1 inside the block. Blocks nest; the
    outermost one gives the thread back the count it had before. Each
    Python thread keeps its own depth and count."""
    depth = getattr(_serial, "depth", 0)
    if depth == 0:
        _serial.outside = torch.get_num_threads()
        if _serial.outside != 1:
            torch.set_num_threads(1)
    _serial.depth = depth + 1
    try:
        yield
    finally:
        _serial.depth -= 1
        if _serial.depth == 0 and _serial.outside != 1:
            torch.set_num_threads(_serial.outside)


def plain_version(fn):
    """Mark ``fn`` as a kernel's plain version: it runs in
    ``calling_thread_only``, so its bits depend on its inputs alone."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with calling_thread_only():
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def reference_path():
    """Run the plain PyTorch versions even on CUDA tensors (for comparing
    kernels with their plain versions on the card)."""
    global _force_reference
    prev = _force_reference
    _force_reference = True
    try:
        yield
    finally:
        _force_reference = prev


def require(cond: bool, what: str) -> None:
    """Wrapper argument check: raise on anything a kernel does not take."""
    if not cond:
        raise ValueError(what)


def records_grad(*tensors) -> bool:
    """True when autograd records a call on these inputs: grad mode is on
    and one of them (None entries skipped) requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _PlainVJP(torch.autograd.Function):
    """A kernel launch whose backward is its plain version's
    vector-Jacobian product: the forward is the kernel, unchanged; the
    backward reruns the plain version on the saved inputs under
    ``torch.enable_grad()`` and lets autograd differentiate it. Integer
    outputs (statuses, counts, maps) are not differentiable."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        outs = tuple(kernel(*inputs))
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        ctx.mark_non_differentiable(
            *(o for o in outs if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[2:]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ctx.plain(*leaves)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if o.is_floating_point() and o.requires_grad]
        wanted = [t for t, n in zip(leaves, need) if n]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs],
            allow_unused=True) if pairs and wanted else [None] * len(wanted))
        return (None, None) + tuple(next(got) if n else None for n in need)


def with_plain_vjp(kernel, plain, *inputs) -> tuple:
    """``kernel(*inputs)`` (a tuple of tensors), made differentiable when
    autograd records the call: its gradients are those of
    ``plain(*inputs)``, the kernel's plain version, which returns the
    kernel's outputs in the same order (trailing integer outputs, which
    carry no gradient, may be left out). Without recording, the kernel
    runs alone (nothing saved, one launch as before)."""
    if not records_grad(*inputs):
        return tuple(kernel(*inputs))
    return _PlainVJP.apply(kernel, plain, *inputs)
