"""Fake CUDA tensors on a PyTorch built without CUDA, for the dry-run.

``launch/dryrun.py`` traces every cell on fake ``cuda`` tensors, so that
it counts the card's path (the kernels through their fake
implementations) on any machine. A PyTorch built with CUDA traces them as
it is. One built without CUDA (the CPU machines the tests run on) cannot:
Python's indexing, ``.to()`` and copies set a CUDA device guard, and
autograd's engine asks for the CUDA accelerator's current stream, and
neither exists there. :func:`ensure` then starts the dry-run's process
again with ``csrc/fake_cuda.cpp`` preloaded (``LD_PRELOAD``): a device
guard of one device whose streams and events do nothing, and an
accelerator query that answers CUDA. It is built by ``g++`` at first use
into ``launch/build/`` (listed in ``.gitignore``), under a name that
hashes the source and the PyTorch version. Only a process that traces
and does nothing else gets it, and nothing here runs at import.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "fake_cuda.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
ENV_FLAG = "REPRO_TORCH_FAKE_CUDA"


def needed() -> bool:
    """Whether this PyTorch lacks CUDA, so fake CUDA tensors need the
    preloaded stand-in."""
    import torch

    return not torch.backends.cuda.is_built()


def active() -> bool:
    """Whether this process was started with the stand-in preloaded."""
    return os.environ.get(ENV_FLAG) == "1"


def library() -> pathlib.Path:
    """The built stand-in (built now if missing)."""
    import torch

    root = pathlib.Path(torch.__file__).resolve().parent
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    tag = hashlib.sha256(SOURCE.read_bytes() + torch.__version__.encode()
                         + bytes([abi])).hexdigest()[:16]
    out = BUILD_DIR / f"fake_cuda-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"fake_cuda-{tag}.{os.getpid()}.so"
    cmd = ["g++", "-shared", "-fPIC", "-std=c++17", "-O1",
           f"-D_GLIBCXX_USE_CXX11_ABI={abi}", f"-I{root / 'include'}",
           str(SOURCE), f"-L{root / 'lib'}", "-lc10",
           f"-Wl,-rpath,{root / 'lib'}", "-o", str(tmp)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"building {SOURCE.name} failed:\n"
                           f"{done.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def child_env(env=None) -> dict:
    """An environment for a child process that traces fake CUDA tensors:
    ``env`` (default this process's) with the stand-in preloaded when this
    PyTorch lacks CUDA."""
    env = dict(os.environ if env is None else env)
    if needed():
        pre = env.get("LD_PRELOAD", "")
        env["LD_PRELOAD"] = f"{library()}{':' + pre if pre else ''}"
        env[ENV_FLAG] = "1"
    return env


def ensure(module: str, argv) -> None:
    """Make this process able to trace fake CUDA tensors: on a PyTorch
    without CUDA, start ``python -m module argv`` again with the stand-in
    preloaded, in place of this process (it does not return)."""
    if not needed() or active():
        return
    env = child_env()
    sys.stdout.flush()
    os.execve(sys.executable, [sys.executable, "-m", module, *argv], env)
