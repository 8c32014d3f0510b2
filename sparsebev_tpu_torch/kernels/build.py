"""Build the port's CUDA sources with ``nvcc`` at first use; load with ctypes.

Each source ``csrc/<name>.cu`` has a plain C interface (pointers and the
stream as ``void*``, every entry returns ``cudaGetLastError()``) and is
compiled on its own into ``build/lib<name>-<hash>.so`` for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
         -shared -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so \
         csrc/<name>.cu

``--fmad=false`` keeps every multiply and add separately rounded, as the
plain PyTorch versions compute them, so a kernel and its plain version give
the same bits where their operation order is the same. The hash covers the
source and the flags, so an edited source rebuilds and a built one loads
without ``nvcc`` running again. Nothing falls back: without ``nvcc`` (or
without a card) a build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (ptxas register / shared-memory / spill report)
BUILD_LOGS: Dict[str, str] = {}
_LOCK = threading.Lock()


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.environ.get("NVCC"), shutil.which("nvcc")]
    if cuda_home:
        cands.append(os.path.join(cuda_home, "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (checked $NVCC, PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin): the CUDA kernels of sparsebev_tpu_torch are "
        "built from csrc/ with nvcc at first use")


def _source(name: str) -> str:
    path = os.path.join(CSRC_DIR, f"{name}.cu")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    return path


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to (content- and flag-hashed)."""
    h = hashlib.sha256()
    with open(_source(name), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start one nvcc for ``name`` unless its library is already built.
    Returns ``(popen, tmp_path, final_path)`` or None."""
    out = library_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, _source(name)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        BUILD_LOGS.setdefault(name, "(already built)")
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    BUILD_LOGS[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Build several sources at once: one nvcc per source, all started
    together, all waited for. Returns each source's nvcc output."""
    names = list(names)
    with _LOCK:
        jobs = {}
        try:
            for n in names:
                jobs[n] = _start(n)
        finally:
            # every started nvcc is waited for, even when a later start fails
            errors = []
            for n, job in jobs.items():
                try:
                    _finish(n, job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: BUILD_LOGS[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(library_path(name))
                _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry of
    ``csrc/<name>.cu`` (each source exports ``<name>_error_string``)."""
    if rc != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        msg = fn(rc).decode(errors="replace")
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")
