"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

Each source is compiled by ``nvcc`` for ``sm_90a`` into an object file, all
at once in parallel, and the objects are linked into one shared library with
a plain C interface, loaded with :mod:`ctypes`.  No source includes PyTorch's
headers, so a build takes seconds.  The library lands in
``kernels/build/`` (git-ignored) under a name that carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one loads
the library already built.

Importing this module runs nothing: ``nvcc`` is looked up, and the build
runs, only when :func:`load` is first called.  A missing ``nvcc`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
SOURCES = ("leap_copy.cu", "heat_scan.cu", "paged_attn.cu", "lru_scan.cu")
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas",
    "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
# name -> argtypes; every pointer and the stream are c_void_p so that ctypes
# never cuts a 64-bit address to a 32-bit int.
_SIGNATURES = {
    "leap_copy_lanes": (_P, _P, _P, _I64, _I64, _I64, _P),
    "leap_gather_blocks": (_P, _P, _P, _I64, _I64, _P),
    "leap_scatter_blocks": (_P, _P, _P, _I64, _I64, _P),
    "leap_heat_scan": (_P, _P, _P, _I64, _I64, ctypes.c_float, _P),
    "leap_paged_decode": (
        (_P,) * 10 + (_I64,) * 8 + (ctypes.c_float, ctypes.c_float, ctypes.c_int, _P)
    ),
    "leap_lru_scan": (_P, _P, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P),
}

_lib: ctypes.CDLL | None = None
build_info: dict = {}  # path, seconds, ptxas log of the build this process loaded


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or ``PATH``."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libleap_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile every source in parallel and link the library; return its path."""
    out = library_path()
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, log="(already built)")
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
            for s, o in zip(SOURCES, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for s, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {s} (exit {p.returncode}):\n{log}")
        staged = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(staged)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(staged, out)  # atomic: a concurrent loader sees all or nothing
    build_info.update(
        path=str(out), seconds=time.perf_counter() - t0, log="".join(logs)
    )
    return out


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call in this process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
