"""Builds the CUDA sources in ``csrc/`` and loads them with ``ctypes``.

Every ``csrc/<name>.cu`` becomes ``build/<digest>/lib<name>.so`` under
the package, compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface.  ``<digest>`` hashes the sources and
the flags, so an edit rebuilds and an unchanged tree reuses the
libraries.  All sources compile at once, one ``nvcc`` each, on the first
call that needs any of them; a file lock keeps processes that start
together from building twice.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "build"

# No --use_fast_math and no -ftz=true: the f16 kernels keep subnormals (a
# flush to zero would round dS = P (dP - delta), which underflows in f16
# far sooner than in bf16, otherwise than the plain versions' casts do),
# and expf, logf and the divisions stay IEEE.  -Xptxas=-v writes each
# kernel's registers, shared memory and spills into <name>.log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def sources() -> Sequence[Path]:
    """The kernel sources, one library each."""
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Dict[str, float]:
    """Compile every source that has no library yet; returns the seconds
    each build took (empty when all were built already).  ``nvcc``'s
    report (registers, shared memory, spills) goes to ``<name>.log``."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    with open(out / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [s for s in sources()
                if not (out / ("lib%s.so" % s.stem)).exists()]
        if not todo:
            return {}
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = out / ("lib%s.so.%d.tmp" % (src.stem, os.getpid()))
            log = open(out / ("%s.log" % src.stem), "w")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(src)]
            procs.append((src, tmp, log, time.perf_counter(),
                          subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT)))
        seconds, failed = {}, []
        for src, tmp, log, t0, proc in procs:
            rc = proc.wait()
            seconds[src.stem] = time.perf_counter() - t0
            log.close()
            if rc != 0:
                failed.append("%s (nvcc exit %d):\n%s" % (
                    src.name, rc, (out / ("%s.log" % src.stem)).read_text()))
            else:
                os.replace(tmp, out / ("lib%s.so" % src.stem))
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
        return seconds


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The library built from ``csrc/<name>.cu``, with ``argtypes`` set
    from ``signatures`` (function -> ctypes argument types); every entry
    returns a ``cudaError_t`` as an int."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(build_dir() / ("lib%s.so" % name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libraries[name] = lib
        return lib


def check(rc: int, what: str):
    """Raise when a C entry returned a CUDA error."""
    if rc != 0:
        raise RuntimeError("%s failed: CUDA error %d" % (what, rc))
