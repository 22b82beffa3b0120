"""Middlebury ``.flo`` I/O, flow colorization, and endpoint-error metrics.

Re-derivation of the reference's ``rw_flow.cpp`` (itself a port of Scharstein's
``middlebury/flow-code``) on NumPy arrays:

  * ``read_flo`` / ``write_flo``    <- ``rw_flow.cpp:50-200`` ("PIEH" tag float
    202021.25, little-endian int32 width/height, interleaved row-major u,v f32).
  * ``unknown_flow``                <- ``rw_flow.cpp:39-47`` (|u| or |v| > 1e9,
    or NaN).
  * ``make_colorwheel`` / ``flow_to_color`` <- ``rw_flow.cpp:251-307`` (55-entry
    wheel RY15 YG6 GC4 CB11 BM13 MR6; hue from atan2(-v,-u)).
  * ``average_epe``                 <- ``rw_flow.cpp:309-332``.  The reference
    calls this "MSE" but computes mean endpoint error; we use the honest name
    and keep a value-compatible alias.
  * ``color_legend``                <- ``middlebury/flow-code/colortest.cpp``.

A native C++ fast path (bulk ``.flo`` decode, PGM, EPE) lives in
``native/flowio_native.cpp`` behind the ctypes bindings in ``native_io``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

TAG_FLOAT = 202021.25  # first 4 bytes of a .flo file, "PIEH" as little-endian f32
TAG_STRING = b"PIEH"
UNKNOWN_FLOW_THRESH = 1e9
UNKNOWN_FLOW = 1e10
MAX_DIM = 99999


class FlowIOError(ValueError):
    """Raised for malformed .flo files (reference prints + exit(1))."""


def unknown_flow(u, v):
    """Whether a flow vector is 'unknown' (``rw_flow.cpp:39-43``)."""
    return (
        (np.abs(u) > UNKNOWN_FLOW_THRESH)
        | (np.abs(v) > UNKNOWN_FLOW_THRESH)
        | np.isnan(u)
        | np.isnan(v)
    )


def unknown_flow_mask(flow: np.ndarray) -> np.ndarray:
    """Per-pixel unknown mask for an (H, W, 2) flow field."""
    return unknown_flow(flow[..., 0], flow[..., 1])


def read_flo(path: str | os.PathLike) -> np.ndarray:
    """Read a Middlebury .flo file into an (H, W, 2) float32 array.

    Mirrors the sanity checks of ``rw_flow.cpp:50-136``: tag, dimension bounds,
    exact payload length (both too-short and too-long are errors).
    """
    path = os.fspath(path)
    if not path.endswith(".flo"):
        raise FlowIOError(f"read_flo: extension .flo expected: {path}")
    with open(path, "rb") as f:
        header = f.read(12)
        if len(header) != 12:
            raise FlowIOError(f"read_flo: problem reading header of {path}")
        tag, width, height = struct.unpack("<fii", header)
        if tag != TAG_FLOAT:
            raise FlowIOError(
                f"read_flo: wrong tag {tag!r} (big-endian file?): {path}"
            )
        if not (1 <= width <= MAX_DIM):
            raise FlowIOError(f"read_flo: illegal width {width}: {path}")
        if not (1 <= height <= MAX_DIM):
            raise FlowIOError(f"read_flo: illegal height {height}: {path}")
        payload = f.read(width * height * 2 * 4)
        if len(payload) != width * height * 2 * 4:
            raise FlowIOError(f"read_flo: file is too short: {path}")
        if f.read(1):
            raise FlowIOError(f"read_flo: file is too long: {path}")
    return np.frombuffer(payload, dtype="<f4").reshape(height, width, 2).copy()


def write_flo(path: str | os.PathLike, flow: np.ndarray) -> None:
    """Write an (H, W, 2) flow field as .flo (``rw_flow.cpp:139-200``)."""
    path = os.fspath(path)
    if not path.endswith(".flo"):
        raise FlowIOError(f"write_flo: filename should have extension '.flo': {path}")
    flow = np.asarray(flow)
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise FlowIOError(f"write_flo: expected (H, W, 2) array, got {flow.shape}")
    height, width = flow.shape[:2]
    with open(path, "wb") as f:
        f.write(TAG_STRING)
        f.write(struct.pack("<ii", width, height))
        f.write(np.ascontiguousarray(flow, dtype="<f4").tobytes())


# ---------------------------------------------------------------------------
# Colorization (Middlebury color wheel)
# ---------------------------------------------------------------------------

_RY, _YG, _GC, _CB, _BM, _MR = 15, 6, 4, 11, 13, 6
NCOLS = _RY + _YG + _GC + _CB + _BM + _MR  # 55


def make_colorwheel() -> np.ndarray:
    """The 55-entry Middlebury color wheel (``rw_flow.cpp:276-300``), (55,3) int32 RGB."""
    wheel = np.zeros((NCOLS, 3), dtype=np.int32)
    k = 0
    for i in range(_RY):
        wheel[k] = (255, 255 * i // _RY, 0)
        k += 1
    for i in range(_YG):
        wheel[k] = (255 - 255 * i // _YG, 255, 0)
        k += 1
    for i in range(_GC):
        wheel[k] = (0, 255, 255 * i // _GC)
        k += 1
    for i in range(_CB):
        wheel[k] = (0, 255 - 255 * i // _CB, 255)
        k += 1
    for i in range(_BM):
        wheel[k] = (255 * i // _BM, 0, 255)
        k += 1
    for i in range(_MR):
        wheel[k] = (255, 0, 255 - 255 * i // _MR)
        k += 1
    return wheel


_COLORWHEEL = make_colorwheel()


def compute_color(fx: np.ndarray, fy: np.ndarray) -> np.ndarray:
    """Vectorized port of ``Flow::computeColor`` (``rw_flow.cpp:251-274``).

    Inputs are flow components already normalized by the max radius; output is
    (..., 3) uint8 RGB.  Quantization matches the reference exactly: colors
    interpolated in float, radius<=1 raised toward white, radius>1 dimmed by
    0.75, final ``(int)(255*col)`` truncation.
    """
    fx = np.asarray(fx, dtype=np.float32)
    fy = np.asarray(fy, dtype=np.float32)
    rad = np.sqrt(fx * fx + fy * fy)
    a = np.arctan2(-fy, -fx) / np.float32(np.pi)
    fk = (a + 1.0) / 2.0 * (NCOLS - 1)
    k0 = fk.astype(np.int32)  # truncation, fk >= 0
    k1 = (k0 + 1) % NCOLS
    f = (fk - k0)[..., None].astype(np.float32)
    col0 = _COLORWHEEL[k0].astype(np.float32) / 255.0
    col1 = _COLORWHEEL[k1].astype(np.float32) / 255.0
    col = (1.0 - f) * col0 + f * col1
    radx = rad[..., None]
    col = np.where(radx <= 1.0, 1.0 - radx * (1.0 - col), col * 0.75)
    return (255.0 * col).astype(np.uint8)


def flow_to_color(
    flow: np.ndarray, max_motion: float = -1.0, verbose: bool = False
) -> np.ndarray:
    """Color-code a flow field (``Flow::MotionToColor``, ``rw_flow.cpp:202-249``).

    Returns (H, W, 3) uint8 RGB; unknown-flow pixels are black.  ``max_motion``
    > 0 overrides the normalization radius, matching the reference CLI arg.
    """
    flow = np.asarray(flow, dtype=np.float32)
    fx, fy = flow[..., 0], flow[..., 1]
    unknown = unknown_flow(fx, fy)
    known_fx = np.where(unknown, 0.0, fx)
    known_fy = np.where(unknown, 0.0, fy)
    rad = np.sqrt(known_fx**2 + known_fy**2)
    if np.all(unknown):
        maxrad = np.float32(-1.0)
    else:
        maxrad = rad[~unknown].max()
    if verbose:
        kx = fx[~unknown] if not np.all(unknown) else np.array([np.nan])
        ky = fy[~unknown] if not np.all(unknown) else np.array([np.nan])
        print(
            "max motion: %.4f  motion range: u = %.3f .. %.3f;  v = %.3f .. %.3f"
            % (maxrad, kx.min(), kx.max(), ky.min(), ky.max())
        )
    if max_motion > 0:
        maxrad = np.float32(max_motion)
    if maxrad == 0:
        maxrad = np.float32(1.0)
    rgb = compute_color(known_fx / maxrad, known_fy / maxrad)
    rgb[unknown] = 0
    return rgb


def color_legend(range_px: int = 10) -> np.ndarray:
    """Render the color-wheel legend image (``colortest.cpp:12-61``).

    A (2R+1, 2R+1) grid of flow vectors (x-R, y-R) normalized by ``truerange``
    = range * sqrt(2) like the standalone Middlebury tool.
    """
    truerange = range_px * np.sqrt(2.0)
    size = 2 * range_px + 1
    ys, xs = np.mgrid[0:size, 0:size]
    fx = (xs - range_px) / truerange
    fy = (ys - range_px) / truerange
    return compute_color(fx.astype(np.float32), fy.astype(np.float32))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def average_epe(gtruth: np.ndarray, flow: np.ndarray) -> float:
    """Average endpoint error over known-GT pixels (``Flow::CalculateMSE``,
    ``rw_flow.cpp:309-332`` - named "MSE" there, but it is mean EPE)."""
    gtruth = np.asarray(gtruth, dtype=np.float64)
    flow = np.asarray(flow, dtype=np.float64)
    known = ~unknown_flow(gtruth[..., 0], gtruth[..., 1])
    du = gtruth[..., 0] - flow[..., 0]
    dv = gtruth[..., 1] - flow[..., 1]
    epe = np.sqrt(du * du + dv * dv)
    return float(epe[known].sum() / known.sum())


# Alias kept for users migrating from the reference API.
calculate_mse = average_epe


# ---------------------------------------------------------------------------
# Grayscale image I/O (the reference uses cv::imread(..., 0) / cv::imwrite)
# ---------------------------------------------------------------------------


def read_gray(path: str | os.PathLike) -> np.ndarray:
    """Read an image as 8-bit grayscale, matching ``cv::imread(path, 0)``.

    Prefers OpenCV (exact parity with the reference's color->gray weights);
    falls back to the native PGM codec, then PIL ("L" uses the same BT.601
    weights as OpenCV).
    """
    path = os.fspath(path)
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(f"read_gray: could not open {path}")
        return img
    except ImportError:
        pass
    from blockbasedmotionestimation_tpu_torch.utils import native_io

    lower = path.lower()
    if lower.endswith((".pgm", ".ppm")) and native_io.available():
        return native_io.read_pgm(path)
    if lower.endswith((".png", ".tga")) and native_io.available():
        # Use the native codec only for already-gray files: color->gray weights
        # must stay consistent with the cv2/PIL conversions used elsewhere.
        # Channel count comes from the cheap header probe so color files are
        # not decoded natively just to be thrown away.
        try:
            if lower.endswith(".png"):
                probe, reader = native_io.png_dims, native_io.read_png
            else:
                probe, reader = native_io.tga_dims, native_io.read_tga
            if probe(path)[2] == 1:
                img = reader(path)
                if img.ndim == 2:
                    return img
        except native_io.NativeIOError:
            pass
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def write_image(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write an image (RGB or grayscale uint8) to disk."""
    img = np.ascontiguousarray(img)
    path = os.fspath(path)
    try:
        import cv2

        out = img[..., ::-1] if img.ndim == 3 else img  # RGB -> BGR
        cv2.imwrite(path, out)
        return
    except ImportError:
        pass
    from blockbasedmotionestimation_tpu_torch.utils import native_io

    lower = path.lower()
    if native_io.available() and img.dtype == np.uint8:
        if lower.endswith(".pgm") and img.ndim == 2:
            native_io.write_pgm(path, img)
            return
        if lower.endswith(".png"):
            native_io.write_png(path, img)
            return
        if lower.endswith(".tga") and (img.ndim == 2 or img.shape[-1] != 2):
            native_io.write_tga(path, img)
            return
    from PIL import Image

    Image.fromarray(img).save(path)
