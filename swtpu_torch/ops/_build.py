"""Build the package's native libraries and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``); the host runtime ``csrc/<name>.cpp``
(``sw_native.cpp``) is compiled by ``g++``.  Both go into
``swtpu_torch/build/`` on first use; the library name carries a hash of the
source and flags, so an edited source rebuilds.  Nothing here runs at import
time: the CPU tests import every module on machines with no CUDA toolkit,
and build the host library with the system's g++.  ``load``'s first load
of a library (its build included) is the span ``swtpu.build`` in a
recording profiler's trace.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Tuple

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then the default toolkit."""
    home = os.environ.get("CUDA_HOME")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH")


def gxx() -> str:
    """Path of the host C++ compiler, g++ on PATH."""
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found: the host library csrc/sw_native.cpp needs a C++17 compiler on PATH")
    return path


def source(name: str) -> Path:
    """``csrc/<name>.cu``, or the host source ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _compiler(src: Path) -> Tuple[Callable[[], str], Tuple[str, ...]]:
    return (nvcc, NVCC_FLAGS) if src.suffix == ".cu" else (gxx, GXX_FLAGS)


def library_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha256(src.read_bytes() + " ".join(_compiler(src)[1]).encode()).hexdigest()[:16]
    return BUILD / f"lib{name}-{digest}.so"


def build(*names: str) -> Dict[str, dict]:
    """Compile every named source that is not built yet, all compiler
    processes at once.  Returns {name: {"path", "seconds", "log"}}; "log"
    holds the compiler's output (nvcc's -Xptxas -v report) for sources built
    by this call.  A failed compile raises with the compiler's output and
    leaves no library."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if not lib.exists():
            src = source(name)
            compiler, flags = _compiler(src)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [compiler(), *flags, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib, src)
    done = {name: {"path": library_path(name), "seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, lib, src) in procs.items():  # every compiler ends before anything raises
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{Path(proc.args[0]).name} failed on csrc/{src.name}:\n{log}")
            continue
        os.replace(tmp, lib)  # atomic: concurrent builders never load a partial file
        done[name].update(seconds=time.perf_counter() - t0, log=log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str, **entries: list) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (or ``.cpp``), building it
    if needed.  ``entries`` maps each C entry point to its argument ctypes;
    every one returns an int error code, which ``<name>_error_string``
    names.  Thread-safe: the engine's ``warmup`` launches from several threads
    at once.  A loaded library is returned without taking the lock: it is
    published only once its entry points are bound."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    from ..utils.profiling import span

    with _load_lock, span("swtpu.build"):
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)[name]["path"]))
            for entry, argtypes in entries.items():
                getattr(lib, entry).argtypes, getattr(lib, entry).restype = argtypes, ctypes.c_int
            error_string = getattr(lib, f"{name}_error_string")
            error_string.argtypes, error_string.restype = [ctypes.c_int], ctypes.c_char_p
            _loaded[name] = lib
    return lib


class Library:
    """A library's entry points and their argument ctypes, named once at
    module level (nothing is built then); a call returns the loaded
    ``ctypes.CDLL``: a dict lookup once ``load`` has built and bound it."""

    __slots__ = ("name", "entries")

    def __init__(self, name: str, **entries: list):
        self.name, self.entries = name, entries

    def __call__(self) -> ctypes.CDLL:
        lib = _loaded.get(self.name)
        return lib if lib is not None else load(self.name, **self.entries)


def stream(index: int) -> int:
    """The handle of the current CUDA stream of device ``index``, as
    ``torch.cuda.current_stream(index).cuda_stream`` gives it, read by
    torch's raw getter without building a ``torch.cuda.Stream`` (a tenth of
    a microsecond a call against several for the public route on an H100's
    host: PERF.md, K9's split; the gpu test
    ``test_stream_handle_is_the_current_stream`` pins the two together)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def where(dev) -> Tuple[int, int]:
    """(device index, current stream handle) of a CUDA ``torch.device``:
    the last two arguments of every launch entry point."""
    index = dev.index
    if index is None:
        import torch

        index = torch.cuda.current_device()
    return index, stream(index)


def check(rc: int, error_string: Callable[[int], bytes], what: str) -> None:
    """Raise unless a C entry point returned 0 (cudaSuccess);
    ``error_string`` is the library's ``<name>_error_string``."""
    if rc != 0:
        raise RuntimeError(f"{what} failed: {error_string(rc).decode()} ({rc})")
