"""ctypes bindings for the native C++ I/O runtime (``native/flowio_native.cpp``
and ``native/image_native.cpp``: .flo, PGM, PNG and Targa codecs, EPE).

Builds the shared library on demand with the bundled Makefile (g++ and
zlib) into ``native/libbbme_io.so`` beside its sources, then exposes typed
wrappers.  Everything degrades gracefully: callers check ``available()``
and fall back to the pure-Python codecs in ``utils.flowio``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "libbbme_io.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False

_ERRORS = {
    -1: "could not open file",
    -2: "bad magic",
    -3: "bad dimensions",
    -4: "short read",
    -5: "file too long",
    -6: "write failed",
    -7: "bad argument",
    -8: "unsupported format variant",
    -9: "corrupt file",
    -10: "zlib error",
    -11: "out of memory",
}


class NativeIOError(IOError):
    pass


def _check(rc: int, path: str = "") -> None:
    if rc != 0:
        raise NativeIOError(f"{_ERRORS.get(rc, rc)}: {path}")


def build(force: bool = False) -> bool:
    """Compile the shared library; returns True on success.  Each build
    writes its own file and renames it into place, so processes that build
    at once never load a half-written library."""
    if os.path.exists(_SO_PATH) and not force:
        return True
    tmp = f".libbbme_io.{os.getpid()}.{threading.get_ident()}.so"
    try:
        subprocess.run(
            ["make", "-s", "-B", "-C", _NATIVE_DIR, f"SO={tmp}"],
            check=True, capture_output=True,
        )
        os.replace(os.path.join(_NATIVE_DIR, tmp), _SO_PATH)
        return True
    except (subprocess.CalledProcessError, FileNotFoundError, OSError):
        return False


def _load() -> ctypes.CDLL | None:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        c_charpp = ctypes.POINTER(ctypes.c_char_p)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i32p = ctypes.POINTER(ctypes.c_int)

        lib.bbme_flo_dims.argtypes = [ctypes.c_char_p, i32p, i32p]
        lib.bbme_flo_read.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int, ctypes.c_int]
        lib.bbme_flo_write.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int, ctypes.c_int]
        lib.bbme_flo_read_batch.argtypes = [
            c_charpp, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i32p,
        ]
        lib.bbme_pgm_dims.argtypes = [ctypes.c_char_p, i32p, i32p]
        lib.bbme_pgm_read.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
        lib.bbme_pgm_write.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int]
        lib.bbme_average_epe.argtypes = [f32p, f32p, ctypes.c_longlong]
        lib.bbme_average_epe.restype = ctypes.c_double
        for name in ("bbme_png_dims", "bbme_tga_dims"):
            getattr(lib, name).argtypes = [ctypes.c_char_p, i32p, i32p, i32p]
        for name in ("bbme_png_read", "bbme_tga_read", "bbme_png_write"):
            getattr(lib, name).argtypes = [
                ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ]
        lib.bbme_tga_write.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_flo(path: str | os.PathLike) -> np.ndarray:
    lib = _load()
    assert lib is not None
    p = os.fspath(path).encode()
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib.bbme_flo_dims(p, ctypes.byref(w), ctypes.byref(h)), path)
    out = np.empty((h.value, w.value, 2), dtype=np.float32)
    _check(lib.bbme_flo_read(p, out, w.value, h.value), path)
    return out


def write_flo(path: str | os.PathLike, flow: np.ndarray) -> None:
    lib = _load()
    assert lib is not None
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    h, w = flow.shape[:2]
    _check(lib.bbme_flo_write(os.fspath(path).encode(), flow, w, h), path)


def read_flo_batch(paths: list, nthreads: int = 8) -> np.ndarray:
    """Threaded batch read of same-sized .flo files -> (N, H, W, 2) f32."""
    lib = _load()
    assert lib is not None
    if not paths:
        return np.empty((0, 0, 0, 2), dtype=np.float32)
    first = read_flo(paths[0])
    h, w = first.shape[:2]
    out = np.empty((len(paths), h, w, 2), dtype=np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[os.fspath(p).encode() for p in paths])
    rcs = (ctypes.c_int * len(paths))()
    rc = lib.bbme_flo_read_batch(arr, len(paths), out, w, h, nthreads, rcs)
    if rc != 0:
        bad = [os.fspath(paths[i]) for i, c in enumerate(rcs) if c != 0]
        raise NativeIOError(f"batch read failed for: {bad}")
    return out


def read_pgm(path: str | os.PathLike) -> np.ndarray:
    lib = _load()
    assert lib is not None
    p = os.fspath(path).encode()
    w, h = ctypes.c_int(), ctypes.c_int()
    _check(lib.bbme_pgm_dims(p, ctypes.byref(w), ctypes.byref(h)), path)
    out = np.empty((h.value, w.value), dtype=np.uint8)
    _check(lib.bbme_pgm_read(p, out, w.value, h.value), path)
    return out


def write_pgm(path: str | os.PathLike, img: np.ndarray) -> None:
    lib = _load()
    assert lib is not None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape
    _check(lib.bbme_pgm_write(os.fspath(path).encode(), img, w, h), path)


def _read_image(path, dims_fn: str, read_fn: str) -> np.ndarray:
    lib = _load()
    assert lib is not None
    p = os.fspath(path).encode()
    w, h, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(getattr(lib, dims_fn)(p, ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch)), path)
    out = np.empty((h.value, w.value, ch.value), dtype=np.uint8)
    _check(getattr(lib, read_fn)(p, out, w.value, h.value, ch.value), path)
    return out[..., 0] if ch.value == 1 else out


def _as_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8:
        # the native codecs are 8-bit only; a silent cast would truncate
        # uint16/float data mod 256 (use cv2/PIL paths for deeper formats)
        raise ValueError(
            f"native image writers take uint8 data, got dtype {img.dtype}"
        )
    img = np.ascontiguousarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"expected (H, W[, C<=4]) uint8 image, got {img.shape}")
    return img


def _image_dims(path, dims_fn: str) -> tuple[int, int, int]:
    lib = _load()
    assert lib is not None
    p = os.fspath(path).encode()
    w, h, ch = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check(getattr(lib, dims_fn)(p, ctypes.byref(w), ctypes.byref(h), ctypes.byref(ch)), path)
    return w.value, h.value, ch.value


def png_dims(path: str | os.PathLike) -> tuple[int, int, int]:
    """(width, height, channels) from the PNG header - no pixel decode."""
    return _image_dims(path, "bbme_png_dims")


def tga_dims(path: str | os.PathLike) -> tuple[int, int, int]:
    """(width, height, channels) from the Targa header - no pixel decode."""
    return _image_dims(path, "bbme_tga_dims")


def read_png(path: str | os.PathLike) -> np.ndarray:
    """8-bit non-interlaced PNG -> (H, W) gray or (H, W, C) uint8.

    Native analogue of imageLib's ``ImageIOpng.cpp`` reader (gray / gray+A /
    RGB / RGBA; palette and 16-bit rejected with a clear error).
    """
    return _read_image(path, "bbme_png_dims", "bbme_png_read")


def write_png(path: str | os.PathLike, img: np.ndarray) -> None:
    img = _as_hwc(img)
    h, w, ch = img.shape
    lib = _load()
    assert lib is not None
    _check(lib.bbme_png_write(os.fspath(path).encode(), img, w, h, ch), path)


def read_tga(path: str | os.PathLike) -> np.ndarray:
    """Targa types 2/3/10/11 -> top-down (H, W[, C]) uint8, RGB(A) order."""
    return _read_image(path, "bbme_tga_dims", "bbme_tga_read")


def write_tga(path: str | os.PathLike, img: np.ndarray, rle: bool = True) -> None:
    img = _as_hwc(img)
    h, w, ch = img.shape
    if ch == 2:
        raise ValueError("Targa has no gray+alpha pixel format")
    lib = _load()
    assert lib is not None
    _check(
        lib.bbme_tga_write(os.fspath(path).encode(), img, w, h, ch, int(rle)),
        path,
    )


def average_epe(gt: np.ndarray, flow: np.ndarray) -> float:
    lib = _load()
    assert lib is not None
    gt = np.ascontiguousarray(gt, dtype=np.float32)
    flow = np.ascontiguousarray(flow, dtype=np.float32)
    assert gt.shape == flow.shape
    return float(lib.bbme_average_epe(gt, flow, gt.size // 2))
