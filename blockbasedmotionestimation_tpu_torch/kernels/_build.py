"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

One shared library with a plain C interface holds every kernel.  It is built
at first use into ``build/kernels/<hash>/`` beside the package (the repo's
``.gitignore`` lists ``build/``), keyed by a hash of the sources and flags,
so a fresh checkout builds exactly once.  Every C entry point returns the
``cudaGetLastError()`` code of its launch; ``check`` raises on a non-zero one.

Nothing here runs at import time: the CPU-only test machine imports every
module but has no nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
_LIB_NAME = "libbbme_kernels.so"

# --fmad=false: the colour step's f32 energy must round like the reference's
# separate multiply and add (it also uses __fmul_rn/__fadd_rn explicitly)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_ROOT / h.hexdigest()[:16] / _LIB_NAME


def build() -> Path:
    """Compile the library if it is missing; returns its path.

    The compiler's output (ptxas register and shared-memory report) is kept
    in ``build.log`` beside the library.
    """
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)]
    cmd += [str(s) for s in _sources() if s.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out.parent / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.bbme_error_string.argtypes = [ctypes.c_int]
    lib.bbme_error_string.restype = ctypes.c_char_p
    return lib


def entry(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """A C entry point of the library with its argument types declared."""
    fn = getattr(library(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = library().bbme_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
