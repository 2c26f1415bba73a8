"""Build the CUDA sources under ``csrc/`` with nvcc at first use and load
them with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``), named
by the hash of its text, in ``csrc/_build/`` (listed in ``.gitignore``).  A
library that is already there is loaded as it is.  Nothing here runs at
import time: the CPU tests import every module, and this host has no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_mu = threading.Lock()
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


_recording = threading.local()


class LaunchCounter:
    """Launches of one kernel: the wrapper adds one where it launches the
    kernel and nowhere else, so a run can show that its path went through
    the kernel and not through the plain version.  Inside
    :func:`recording_launches` this thread's additions go to the recording
    instead (a CUDA graph capture launches nothing: the graph adds what it
    recorded at each replay)."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._mu = threading.Lock()

    def add(self, n: int = 1) -> None:
        rec = getattr(_recording, "counts", None)
        if rec is not None:
            rec[self.name] = rec.get(self.name, 0) + n
            return
        with self._mu:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._mu:
            self._n = 0


@contextlib.contextmanager
def recording_launches() -> Iterator[Dict[str, int]]:
    """Divert this thread's :class:`LaunchCounter` additions into the
    yielded dict (counter name -> launches) instead of the counters; other
    threads keep counting as before."""
    prev = getattr(_recording, "counts", None)
    _recording.counts = {}
    try:
        yield _recording.counts
    finally:
        _recording.counts = prev


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc`` (PyTorch's own lookup), else
    the one on ``PATH``."""
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _flags(defines: Sequence[str]) -> Tuple[str, ...]:
    return ARCH_FLAGS + NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def _lib_path(source: pathlib.Path, defines: Sequence[str]) -> pathlib.Path:
    text = source.read_bytes() + " ".join(_flags(defines)).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}-{digest}.so"


def compile_source(source: pathlib.Path,
                   defines: Sequence[str] = ()) -> Tuple[pathlib.Path, float]:
    """Compile one ``.cu`` file unless its library exists; -> (library
    path, seconds spent in nvcc).  ``defines`` (``NAME=VALUE``) set a
    source's build-time switches, for a timing sweep's variants; the
    wrappers build with none.  Writes to a temporary name and renames, so
    concurrent builds never load a half-written library.  ptxas's report
    (registers, spills, shared memory of each kernel) goes beside the
    library (:func:`ptxas_report`)."""
    out = _lib_path(source, defines)
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.monotonic()
    try:
        cmd = [nvcc(), *_flags(defines), "-o", tmp, str(source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name}:\n"
                               f"{res.stdout}\n{res.stderr}")
        out.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, time.monotonic() - t0


def ptxas_report(source: pathlib.Path, defines: Sequence[str] = ()
                 ) -> Optional[str]:
    """What ptxas printed when :func:`compile_source` built ``source`` with
    ``defines`` (None if that build left no report)."""
    log = _lib_path(source, defines).with_suffix(".log")
    return log.read_text() if log.exists() else None


def load(source: str, signatures: Dict[str, list],
         defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>`` with ``defines`` (see
    :func:`compile_source`); ``signatures`` maps each C entry point to its
    ctypes argtypes (every entry returns int, the launch's cudaError_t).
    Every source also exports ``bravo_error_string(int) -> const char*``."""
    key = (source, tuple(defines))
    with _mu:
        lib = _libs.get(key)
        if lib is None:
            path, _ = compile_source(CSRC / source, defines)
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            lib.bravo_error_string.argtypes = [ctypes.c_int]
            lib.bravo_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.bravo_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {msg} ({err})")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device``, as a C pointer.  Every table
    kernel goes to this one stream, so launches from several host threads
    run on the device in the order they were enqueued."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())
