"""Build the port's CUDA kernels from ``kernels/csrc/*.cu`` on first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, and loaded with ``ctypes``: tensors and
the stream are passed as ``c_void_p``, and every C entry point returns
``cudaGetLastError()`` after its launch, which ``entry`` raises on. The
build reads only the sources in this directory, so a fresh checkout builds
everything it runs. Libraries are named by a hash of their source and
flags (and the shared headers), so an edited source is rebuilt and a
stale one is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# one loaded library per source per process (a shared object is mapped
# once; the lock keeps two threads from building the same source twice),
# and one typed callable per C entry point
_lock = threading.RLock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Callable[..., None]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "compiled from kernels/csrc on first use")
    return path


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):      # shared by every source
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source whose library is missing — one ``nvcc``
    per source, all started together. Returns the compiler's output
    (``-Xptxas -v``: registers, shared memory, spills) per source built."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in jobs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, so)       # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def entry(name: str, symbol: str,
          argtypes: Sequence[type]) -> Callable[..., None]:
    """The C entry point ``symbol`` of ``csrc/<name>.cu``, typed once when
    it is first asked for. Calling it raises if the entry point returns a
    CUDA error (a refused launch never runs, and no later synchronize
    reports it)."""
    call = _entries.get(symbol)
    if call is not None:
        return call
    with _lock:
        if symbol in _entries:
            return _entries[symbol]
        lib = load(name)
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int

        def call(*args) -> None:
            err = fn(*args)
            if err != 0:
                msg = lib.repro_cuda_error_string(err).decode()
                raise RuntimeError(f"{symbol}: CUDA error {err} ({msg})")
        _entries[symbol] = call
        return call


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, as the raw handle the C
    entry points take (``torch._C._cuda_getCurrentRawStream``, which
    PyTorch's own compiler uses: no ``torch.cuda.Stream`` object is built
    per launch)."""
    import torch
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.get_device()))
