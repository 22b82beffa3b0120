"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

One shared library with a plain C interface holds every kernel.  It is built
at first use into ``build/kernels/<hash>/`` beside the package (the repo's
``.gitignore`` lists ``build/``), keyed by a hash of the sources and flags,
so a fresh checkout builds exactly once: one nvcc per source, all started
together, then one link.  Every C entry point returns the
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh"))


def nvcc_path() -> str:
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
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [out.with_name(f"{s.stem}.{os.getpid()}.o") for s in srcs]
    cmds = [[nvcc_path(), *NVCC_FLAGS, "-c", str(s), "-o", str(o)] for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    log, failed = [], []
    for cmd, proc in zip(cmds, procs):
        text = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode != 0:
            failed.append(f"{cmd[-3]} ({proc.returncode}):\n{text}")
    if not failed:
        cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
               "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}")
    for o in objs:
        o.unlink(missing_ok=True)
    (out.parent / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
