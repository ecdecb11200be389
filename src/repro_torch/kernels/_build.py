"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/*.cu`` file exports a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds. At first use every compile unit (a source
and its defines: ``lower_bound.cu`` is compiled once per SAX width, so that
its many launch-shape instantiations build in parallel, and once for its C
entries) is compiled to an object file by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library that
``ctypes`` loads. The library lands in ``kernels/build/`` (listed in
``.gitignore``) under a name that hashes the sources and flags, so an edit
rebuilds and an unchanged tree reuses the last build.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is only reached when a kernel is launched on a CUDA tensor (or
:func:`load` is called).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
# (source, defines): one nvcc process each.
UNITS = (("paa_isax.cu", ()),
         ("lower_bound.cu", ()),
         *(("lower_bound.cu", (f"-DPARIS_LB_W={w}",)) for w in (4, 8, 16, 32)),
         ("euclidean.cu", ()),
         ("select.cu", ()))
SOURCES = tuple(dict.fromkeys(name for name, _ in UNITS))
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None
# What the last build printed (ptxas register/shared-memory lines), how
# long it took, and the loaded library's path; chip_smoke.py reports them.
build_log = ""
build_seconds = 0.0
library_path = None

_VP = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signature of every exported entry; each returns cudaGetLastError().
_SIGNATURES = {
    # series, breakpoints, sax, paa, B, n, w, n_bp, normalize, threads,
    # stream
    "paa_isax_launch": (_VP, _VP, _VP, _VP, _L, _I, _I, _I, _I, _I, _VP),
    # qpaa, sax, bp_padded, out, Q, N, w, n_bp_padded, scale, block_q,
    # threads, rows, stream
    "lower_bound_sq_batch_launch": (_VP, _VP, _VP, _VP, _I, _L, _I, _I, _F,
                                    _I, _I, _I, _VP),
    # qpaa, sax, bp_padded, out, N, w, n_bp_padded, scale, threads,
    # blocks_per_sm, stream
    "lower_bound_sq_launch": (_VP, _VP, _VP, _VP, _L, _I, _I, _F, _I, _I,
                              _VP),
    # qpaa, sax, bp_padded, block_len, out, Q, N, w, n_bp_padded, block_n,
    # scale, block_q, threads, rows, stream
    "lower_bound_sq_multi_launch": (_VP, _VP, _VP, _VP, _VP, _I, _L, _I, _I,
                                    _I, _F, _I, _I, _I, _VP),
    # queries, raw, positions, out, Q, R, N, n, pos_row_stride, threads,
    # rows_per_warp, stream
    "euclid_sq_gather_launch": (_VP, _VP, _VP, _VP, _I, _I, _L, _I, _L, _I,
                                _I, _VP),
    # query, data, best key, B, n, stream
    "euclid_min_launch": (_VP, _VP, _VP, _L, _I, _VP),
    # cols, bounds, list row stride, width, round size, round, position
    # table, raw, N, n, queries, top_d, its row stride, top_p, its row
    # stride, k, reads, updates, eps, budget, skip_lb, out_d, out_p, state,
    # Q, stream
    "engine_round_launch": (_VP, _VP, _L, _I, _I, _I, _VP, _VP, _L, _I, _VP,
                            _VP, _L, _VP, _L, _I, _VP, _VP, _VP, _VP, _VP,
                            _VP, _VP, _VP, _I, _VP),
    # lb, cols, bounds, kth, scratch, scratch words, Q, L, k, stream
    "select_launch": (_VP, _VP, _VP, _VP, _VP, _L, _I, _L, _L, _VP),
    # list bounds, list cols, cut bounds, cut cols, out cols, out bounds,
    # scratch, scratch words, Q, L, hi, n, stream
    "order_range_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _L, _I, _L,
                           _L, _L, _VP),
}


def nvcc_path() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cand = pathlib.Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels are built from source at first use")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, defines in UNITS:
        h.update(" ".join((name, *defines)).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, tag: str) -> pathlib.Path:
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    objs = []
    for i, (name, defines) in enumerate(UNITS):  # one nvcc each, all at once
        obj = BUILD_DIR / f"{pathlib.Path(name).stem}{i}-{tag}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-c", str(CSRC / name), "-o",
               str(obj)]
        procs.append((" ".join((name, *defines)), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
        objs.append(obj)
    logs = []
    failed = []
    for name, p in procs:
        out, _ = p.communicate()
        logs.append(f"--- {name}\n{out}")
        if p.returncode:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(logs))
    so = BUILD_DIR / f"libparis_kernels-{tag}.so"
    tmp = BUILD_DIR / f"libparis_kernels-{tag}.{os.getpid()}.tmp.so"
    link = subprocess.run(
        [nvcc, ARCH, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    build_log = "\n".join(logs)
    so.with_suffix(".log").write_text(build_log)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    for obj in objs:
        obj.unlink()
    build_seconds = time.perf_counter() - t0
    return so


def load() -> ctypes.CDLL:
    """Build (once per source state) and load the kernel library."""
    global _lib, library_path, build_log
    with _lock:
        if _lib is not None:
            return _lib
        tag = _digest()
        so = BUILD_DIR / f"libparis_kernels-{tag}.so"
        if not so.is_file():
            so = _compile(nvcc_path(), tag)
        elif so.with_suffix(".log").is_file():  # built earlier: its log
            build_log = so.with_suffix(".log").read_text()
        lib = ctypes.CDLL(str(so))
        library_path = so
        for fn_name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        for fn_name, argtypes in (("select_scratch_words", [_I, _L]),
                                  ("order_range_scratch_words",
                                   [_I, _L, _L])):
            getattr(lib, fn_name).argtypes = argtypes
            getattr(lib, fn_name).restype = ctypes.c_longlong
        lib.paris_cuda_error_string.argtypes = [ctypes.c_int]
        lib.paris_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


class LaunchCounter:
    """A kernel's launch count, exact when several threads launch at once.

    ``count += 1`` on a module global is a read, an add and a store, and
    two threads can interleave them and lose a launch; the pipeline's
    workers and concurrent appenders launch from several threads, so the
    count is taken under a lock.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._count = 0

    def add(self) -> None:
        """Count one launch."""
        with self._lock:
            self._count += 1

    @property
    def value(self) -> int:
        """Launches since the last :meth:`reset`."""
        with self._lock:
            return self._count

    def reset(self) -> None:
        """Set the count to 0."""
        with self._lock:
            self._count = 0


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs)."""
    if err:
        text = _lib.paris_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text}) at launch")


def require(t, name: str, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and rank."""
    import torch

    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def same_device(*tensors) -> None:
    """Raise unless every tensor lies on the same card."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
