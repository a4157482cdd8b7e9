"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries go to ``build/kernels/`` at
the repository root, named by a hash of their source, so an edited source
is rebuilt and a stale library is never loaded.  Nothing is built when this
module is imported: the first launch builds, or :func:`build_all` does.
Each library actually built is reported as ``(name, seconds)`` to the
listeners of :func:`subscribe` (the observability handle's build spans,
``repro_torch.obs.Obs.compile_spans``); an up-to-date one reports nothing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LISTENERS: List[Callable[[str, float], None]] = []


def subscribe(fn: Callable[[str, float], None]
              ) -> Callable[[str, float], None]:
    """Call ``fn(name, seconds)`` after each library this process builds;
    returns ``fn`` (pass it to :func:`unsubscribe`)."""
    _LISTENERS.append(fn)
    return fn


def unsubscribe(fn: Callable[[str, float], None]) -> None:
    _LISTENERS.remove(fn)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start one nvcc for ``name`` (None if its library is up to date)."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, t0


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    # atomic: concurrent builders never see a half-written library
    os.replace(tmp, out)
    seconds = time.perf_counter() - t0
    for fn in list(_LISTENERS):
        fn(name, seconds)
    return log


def build_all() -> Dict[str, str]:
    """Build every source at once (one nvcc each, started together);
    returns each build's compiler log (empty when it was up to date)."""
    started = {name: _start(name) for name in sources()}
    return {name: _finish(name, s) for name, s in started.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
