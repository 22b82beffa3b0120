"""Pooled cost volumes and compact tables (replace the TPU kernels
``delta_pooled_cvs`` (B), ``deep_pooled_cvs`` (C), ``full_block_volume``
(13) and ``compact_tables`` (14)).

``pooled_cvs`` returns ``{cur: volume}`` for cur = 2, 4, ..., bs.  Each
volume is the reference's ``ops/windowed.py:_compute_cv`` layout with a
leading batch dim, (B, side^2, npy*f, npx*f) with f = bs // cur:
``cv[b, (dy+r)*side + (dx+r), py*f + sy, px*f + sx]`` is the cost of
sub-block (sy, sx) of parent (py, px) against the frame-2 window shifted by
(dy, dx).  Volumes are stored in the reference's ``_cv_dtype`` widths:
uint16 while the worst-case cost fits (sad at cur <= 16), int32 otherwise,
f32 for ``cost="zsad"``, which only ``pooled_cvs_plain`` computes (the
reference runs zsad in XLA only; every kernel wrapper here refuses it).

Two options narrow what is written:
  * ``store_r``: the cur=2 volume keeps only dx in [-store_r, store_r], with
    every dy row: (B, side * side_st, h/2, w/2), side_st = 2*store_r + 1,
    index ``(dy+r)*side_st + (dx+store_r)`` (the reference's
    ``delta_pooled_cvs(store_r2=...)`` band);
  * ``emit``: the sizes to write; the others are pooled but never stored.
``deep_pooled_cvs`` (kernel C) is the call that writes only cur > fuse_max
and cur = bs, ``full_block_volume`` (kernel 13) the one that writes only
cur = bs, each with its own launch count.

``compact_tables`` (kernel 14, ``cv_compact``) stores, for cur = 2 .. bs/2,
only the costs at the K slot deltas of each parent's 128-parent chunk
(``ops.compact.chunk_delta_slots``): (B, K, h/cur, w/cur).

For CPU tensors the wrappers run the plain versions (``pooled_cvs_plain``,
the ``_compute_cv`` code in torch, and ``compact_tables_plain``); for CUDA
tensors they launch ``csrc/cv_diff.cu``.  The volume kernel is built for bs
2, 4, .., 128, kernel 14 for bs 4, .., 128; ``volume_geometry`` and
``compact_geometry`` pick their launches (parents and delta rows or slots
per block, threads, shared bytes), and the entry points refuse any other
bs.  ``models.engine.cuda_refusals`` names the shapes no launch of these
kernels can take.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Iterable

import torch

from blockbasedmotionestimation_tpu_torch.kernels import _build
from blockbasedmotionestimation_tpu_torch.kernels.sad_search import zero_mean_sad
from blockbasedmotionestimation_tpu_torch.ops.compact import CHUNK
from blockbasedmotionestimation_tpu_torch.utils import profiling


def cv_dtype(cur: int, cost: str) -> torch.dtype:
    """Smallest dtype holding a worst-case cost at sub-block size cur; f32
    for zsad, whose costs are float-valued."""
    if cost == "zsad":
        return torch.float32
    peak = (255 * 255 if cost == "ssd" else 255) * cur * cur
    return torch.uint16 if peak < (1 << 16) else torch.int32


def _curs(bs: int) -> list[int]:
    return [1 << k for k in range(1, bs.bit_length())]


def deep_curs(bs: int, fuse_max: int) -> list[int]:
    """The sizes kernel C writes: those above fuse_max, and bs."""
    return [c for c in _curs(bs) if c > fuse_max or c == bs]


def _check_cost(cost: str) -> None:
    """The kernels' costs: zsad has no kernel (its callers run
    ``pooled_cvs_plain`` by name, as the reference runs zsad in XLA)."""
    if cost not in ("sad", "ssd"):
        raise NotImplementedError(
            f"cost={cost!r}: the kernels compute sad and ssd; zsad runs pooled_cvs_plain"
        )


def _check_options(bs: int, r: int, store_r: int | None, emit) -> list[int]:
    """The emitted sizes, ascending; raises on a bad store_r or emit set."""
    curs = _curs(bs)
    emit = curs if emit is None else sorted(set(emit))
    if not emit or any(c not in curs for c in emit):
        raise ValueError(f"emit must be a non-empty subset of {curs}, got {emit}")
    if store_r is not None:
        if not 0 <= store_r <= r:
            raise ValueError(f"need 0 <= store_r <= r = {r}, got {store_r}")
        if 2 not in emit:
            raise ValueError("store_r narrows the cur=2 volume, which emit leaves out")
    return emit


def _shape(b: int, side: int, h: int, w: int, cur: int, store_r: int | None):
    nd = side * (2 * store_r + 1) if cur == 2 and store_r is not None else side * side
    return (b, nd, h // cur, w // cur)


def _row_costs(d: torch.Tensor, bs: int, cost: str, curs):
    """(cur, (B, nP, side, f, f) costs) for each size in ``curs`` of one
    delta row's diffs d (B, nP, side, bs, bs): sad and ssd pooled 2x2 from
    each size to the next; zsad computed from the diffs at every size,
    since each sub-block subtracts its own mean (the reference's
    ``_compute_cv``), so no size pools from the one below."""
    b, n_p, side = d.shape[:3]
    if cost == "zsad":
        d = d.to(torch.float32)
        for cur in sorted(curs):
            f = bs // cur
            sub = d.reshape(b, n_p, side, f, cur, f, cur).transpose(4, 5)
            yield cur, zero_mean_sad(sub.reshape(b, n_p, side, f, f, cur * cur))
        return
    cvr = d.abs() if cost == "sad" else d * d
    cur = 1
    while cur < bs:
        n = bs // cur
        cvr = cvr.reshape(b, n_p, side, n // 2, 2, n // 2, 2).sum(dim=(4, 6))
        cur *= 2
        if cur in curs:
            yield cur, cvr


def pooled_cvs_plain(
    im1: torch.Tensor,      # (B, H, W) u8 frame-1 level image
    windows: torch.Tensor,  # (B, nP, bs + 2r, bs + 2r) u8 frame-2 windows
    bs: int,
    r: int,
    cost: str,
    *,
    store_r: int | None = None,
    emit: Iterable[int] | None = None,
) -> dict[int, torch.Tensor]:
    """The volumes with torch ops: one delta row per step, the row's deltas
    unfolded, pooled 2x2 from each size to the next (``_row_costs``).  Also
    the volumes of ``cost="zsad"``, which no kernel computes: f32, each
    size from the diffs."""
    if cost not in ("sad", "ssd", "zsad"):
        raise ValueError(f"unknown cost: {cost}")
    emit = _check_options(bs, r, store_r, emit)
    b, h, w = im1.shape
    npy, npx = h // bs, w // bs
    side = 2 * r + 1
    dev = im1.device
    patches = (
        im1.reshape(b, npy, bs, npx, bs).permute(0, 1, 3, 2, 4)
        .reshape(b, npy * npx, 1, bs, bs).to(torch.int32)
    )
    out = {
        c: torch.empty(_shape(b, side, h, w, c, store_r), dtype=cv_dtype(c, cost), device=dev)
        for c in emit
    }
    for dyi in range(side):
        rows = windows[:, :, dyi : dyi + bs]
        # (B, nP, bs, side, bs) -> (B, nP, side, bs, bs): window of delta dx
        shifted = rows.unfold(-1, bs, 1).permute(0, 1, 3, 2, 4).to(torch.int32)
        for cur, cvr in _row_costs(patches - shifted, bs, cost, out):
            f = bs // cur
            vol = (
                cvr.reshape(b, npy, npx, side, f, f)
                .permute(0, 3, 1, 4, 2, 5)
                .reshape(b, side, npy * f, npx * f)
            )
            if cur == 2 and store_r is not None:
                st = 2 * store_r + 1
                vol = vol[:, r - store_r : r + store_r + 1]
            else:
                st = side
            out[cur][:, dyi * st : (dyi + 1) * st] = vol.to(out[cur].dtype)
    return out


def deep_pooled_cvs_plain(
    im1: torch.Tensor, windows: torch.Tensor, bs: int, r: int, cost: str, fuse_max: int
) -> dict[int, torch.Tensor]:
    """Kernel C's volumes with torch ops: ``pooled_cvs_plain`` at
    ``emit=deep_curs(bs, fuse_max)``."""
    return pooled_cvs_plain(im1, windows, bs, r, cost, emit=deep_curs(bs, fuse_max))


# ------------------------------------------------- launch geometry (B, C, 13)

SMEM_LIMIT = 232_448  # H100: dynamic shared memory one block may use
MAX_BS = 128          # the largest bs csrc/cv_diff.cu instantiates
SMS = 132             # H100 SXM streaming multiprocessors
TARGET_BLOCKS = 8 * SMS
MAX_THREADS = 256     # csrc/cv_diff.cu kMaxThreads


# parents a block takes: a call that writes the cur 2 or 4 volume is bound
# by its writes, and a block of FINE_PARENTS neighbours of one row writes
# each volume row in runs FINE_PARENTS times as long; the other calls are
# bound by their diffs and gain a little from 2 (the times at each choice:
# ``profile_main --volume-launches``, PERF.md)
FINE_PARENTS = 4
COARSE_PARENTS = 2


@dataclasses.dataclass(frozen=True)
class VolumeGeometry:
    """How ``csrc/cv_diff.cu`` launches one volume call: one block per
    ``parents_per_block`` parents of a row and group of ``dy_per_block``
    delta rows, ``groups`` groups (the last one may be short), ``blocks``
    blocks in all, ``threads`` per block, ``smem_bytes`` of dynamic shared
    memory."""

    parents_per_block: int
    dy_per_block: int
    groups: int
    blocks: int
    threads: int
    smem_bytes: int


def _ndx(bs: int) -> int:
    """Deltas per thread (cv_diff.cu Shape::kNdx)."""
    return 1 if bs >= 128 else 2 if bs >= 64 else 4


def _items_per_row(bs: int, side: int) -> int:
    """Threads' items of one dy row: for each residue k = dx % 4, its deltas
    in runs of ``_ndx(bs)``."""
    ndx = _ndx(bs)
    return sum(-(-max(0, -(-(side - k) // 4)) // ndx) for k in range(4))


def volume_smem(bs: int, r: int, dy_per_block: int, parents_per_block: int = 1) -> int:
    """Shared bytes of one block (cv_diff.cu volume_layout): per parent its
    patch, its window rows' four byte-shifted word copies, its raw rows;
    at bs >= 128 also the 16 bytes through which the two warps of a parent
    row pool its cur = bs cell."""
    side, wc = 2 * r + 1, bs + 2 * r
    ndx, nw = _ndx(bs), max(1, bs // 4)
    vec = 4 if ndx % 4 == 0 else 2 if ndx % 2 == 0 else 1
    nload = -(-(ndx + nw - 1) // vec) * vec
    cnt_max = -(-(-(-side // 4)) // ndx)
    rows = dy_per_block + bs - 1
    wpr = -(-((cnt_max - 1) * ndx + nload) // 4) * 4
    if (wpr // 4) % 2 == 0:
        wpr += 4  # row pitch 16 * odd bytes: no bank conflicts in a quarter-warp
    patch = -(-(bs * max(bs, 4)) // 16) * 16
    raw = -(-(rows * wc + 4 * wpr + 32) // 16) * 16
    return parents_per_block * (patch + 4 * rows * wpr * 4 + raw) + (16 if bs >= 128 else 0)


def volume_launch(bs: int, r: int, batch: int, npy: int, npx: int, parents_per_block: int,
                  dy_per_block: int) -> VolumeGeometry:
    """The launch of one volume call at ``parents_per_block`` parents and
    ``dy_per_block`` delta rows a block."""
    side, f2, pp = 2 * r + 1, max(1, bs // 2), parents_per_block
    groups = -(-side // dy_per_block)
    lanes = dy_per_block * _items_per_row(bs, side) * f2 * pp
    unit = max(32, f2 * pp)  # whole warps, whole (parent, row) groups
    threads = min(MAX_THREADS // unit * unit, -(-lanes // unit) * unit)
    return VolumeGeometry(pp, dy_per_block, groups, batch * npy * -(-npx // pp) * groups,
                          threads, volume_smem(bs, r, dy_per_block, pp))


def volume_geometry(bs: int, r: int, batch: int, npy: int, npx: int,
                    writes_fine: bool) -> VolumeGeometry:
    """The launch of one volume call over ``batch`` frames of npy x npx
    parents; ``writes_fine``: the call writes the cur 2 or 4 volume.

    FINE_PARENTS (else COARSE_PARENTS) parents of a row a block, at most
    256 threads' worth and the row, and every delta row in one group (each
    window read once) unless the grid then has fewer than ``TARGET_BLOCKS``
    blocks (the 1080p level 3 at B=8 has 320 parents) or the rows overflow
    the shared memory: then the fewest groups that fix both."""
    side, f2 = 2 * r + 1, max(1, bs // 2)
    want = FINE_PARENTS if writes_fine else COARSE_PARENTS
    pp = 1
    while (2 * pp <= min(want, MAX_THREADS // f2, npx)
           and volume_smem(bs, r, 1, 2 * pp) <= SMEM_LIMIT):
        pp *= 2
    tiles = batch * npy * -(-npx // pp)
    groups = 1
    while groups < side and (tiles * groups < TARGET_BLOCKS
                             or volume_smem(bs, r, -(-side // groups), pp) > SMEM_LIMIT):
        groups += 1
    return volume_launch(bs, r, batch, npy, npx, pp, -(-side // groups))


def paired_curs(bs: int, cost: str, emit: Iterable[int], parents_per_block: int) -> list[int]:
    """The sizes of ``emit`` whose runs lane pairs store together
    (cv_diff.cu paired_cur2): [2] where a lane's cur=2 run of a parent row,
    ``bs // 2`` cells, is a whole number of 32-byte sectors (sad at bs 32,
    ssd at bs 16 and 32), a warp holds two parents' rows (bs <= 32) and a
    block takes more than one parent; else none.  The lanes of parents 2j
    and 2j + 1 then swap half their runs, so that each 16-byte store fills
    whole sectors; alone, a lane half-fills two."""
    f2 = bs // 2
    if (2 in emit and f2 <= 16 and parents_per_block > 1
            and f2 * cv_dtype(2, cost).itemsize % 32 == 0):
        return [2]
    return []


# bbme_pooled_cvs(im1, windows, outs, ncur, is16_mask, emit_mask, batch, h, w,
#                 bs, side, store_r, ssd, dy_per_cta, parents_per_cta, threads,
#                 smem_bytes, stream)
ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    + [ctypes.c_int] * 14 + [ctypes.c_void_p]
)


@functools.lru_cache(maxsize=None)
def _kernel():
    return _build.entry("bbme_pooled_cvs", ARGTYPES)


def _launch(wrapper, im1, windows, bs, r, cost, store_r, emit) -> dict[int, torch.Tensor]:
    """Check the inputs; run the plain version on the CPU, else launch the
    kernel, count the launch on ``wrapper`` and return the volumes."""
    _check_cost(cost)
    emit = _check_options(bs, r, store_r, emit)
    if im1.dtype != torch.uint8 or im1.dim() != 3:
        raise ValueError(f"im1 must be (B, H, W) uint8, got {im1.dtype} {tuple(im1.shape)}")
    b, h, w = im1.shape
    if r < 0:
        raise ValueError(f"need r >= 0, got {r}")
    win = bs + 2 * r
    n_p = (h // bs) * (w // bs)
    if h % bs or w % bs:
        raise ValueError(f"frame {h}x{w} is not a multiple of bs={bs}")
    if windows.dtype != torch.uint8 or tuple(windows.shape) != (b, n_p, win, win):
        raise ValueError(
            f"windows must be ({b}, {n_p}, {win}, {win}) uint8, got "
            f"{windows.dtype} {tuple(windows.shape)}"
        )
    if windows.device != im1.device:
        raise ValueError(f"windows on {windows.device}, im1 on {im1.device}")
    if im1.device.type == "cpu":
        return pooled_cvs_plain(im1, windows, bs, r, cost, store_r=store_r, emit=emit)
    if im1.device.type != "cuda":
        raise ValueError(f"unsupported device {im1.device}")
    if not (im1.is_contiguous() and windows.is_contiguous()):
        raise ValueError("pooled_cvs needs contiguous tensors")
    side = 2 * r + 1
    curs = _curs(bs)
    out = {
        c: torch.empty(_shape(b, side, h, w, c, store_r), dtype=cv_dtype(c, cost),
                       device=im1.device)
        for c in emit
    }
    ptrs = (ctypes.c_void_p * len(curs))(*(out[c].data_ptr() if c in out else None for c in curs))
    is16 = sum(1 << i for i, c in enumerate(curs) if cv_dtype(c, cost) == torch.uint16)
    emit_mask = sum(1 << i for i, c in enumerate(curs) if c in out)
    geo = volume_geometry(bs, r, b, h // bs, w // bs, writes_fine=bool(emit_mask & 3))
    paired = paired_curs(bs, cost, emit, geo.parents_per_block)
    with torch.cuda.device(im1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _kernel()(
            im1.data_ptr(), windows.data_ptr(), ptrs, len(curs), is16, emit_mask,
            b, h, w, bs, side, -1 if store_r is None else store_r,
            int(cost == "ssd"), geo.dy_per_block, geo.parents_per_block, geo.threads,
            geo.smem_bytes, stream,
        )
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    for c, t in out.items():
        profiling.volume_store("pairs" if c in paired else "lanes", t.nbytes)
    return out


def pooled_cvs(
    im1: torch.Tensor,
    windows: torch.Tensor,
    bs: int,
    r: int,
    cost: str,
    *,
    store_r: int | None = None,
    emit: Iterable[int] | None = None,
) -> dict[int, torch.Tensor]:
    """Kernel B: the volumes of ``emit`` (every size by default); see
    ``pooled_cvs_plain`` for shapes.  ``windows`` has edge ``bs + 2*r``;
    deltas span [-r, r] around the window centre."""
    return _launch(pooled_cvs, im1, windows, bs, r, cost, store_r, emit)


def deep_pooled_cvs(
    im1: torch.Tensor, windows: torch.Tensor, bs: int, r: int, cost: str, fuse_max: int
) -> dict[int, torch.Tensor]:
    """Kernel C: only the volumes the dense rounds read, cur > fuse_max and
    cur = bs (the hybrid form's and ``cv_fused``'s windows)."""
    return _launch(deep_pooled_cvs, im1, windows, bs, r, cost, None, deep_curs(bs, fuse_max))


def full_block_volume_plain(
    im1: torch.Tensor, windows: torch.Tensor, bs: int, r: int, cost: str
) -> dict[int, torch.Tensor]:
    """Kernel 13's volume with torch ops: ``pooled_cvs_plain`` at emit={bs}."""
    return pooled_cvs_plain(im1, windows, bs, r, cost, emit=[bs])


def full_block_volume(
    im1: torch.Tensor, windows: torch.Tensor, bs: int, r: int, cost: str
) -> dict[int, torch.Tensor]:
    """Kernel 13: ``{bs: volume}``, the cur = bs volume alone (the search
    volume of ``cv_compact``)."""
    return _launch(full_block_volume, im1, windows, bs, r, cost, None, [bs])


pooled_cvs.launches = 0
deep_pooled_cvs.launches = 0
full_block_volume.launches = 0


# ------------------------------------------------ compact tables (kernel 14)

MAX_PARENTS = 8  # parents a block takes at most (csrc/cv_diff.cu)


def compact_smem(bs: int, r: int, parents_per_block: int = 1) -> int:
    """Shared bytes of one kernel-14 block (cv_diff.cu compact_layout): each
    parent's window as aligned words, its rows at an odd pitch of at least
    ``(ws + 3) // 4 + 1`` words (the word past a row feeds the funnel
    shift), the windows ``bs/2`` words apart modulo 32 below bs 64 (the sy
    lanes of a warp's parents on distinct banks)."""
    ws, f2 = bs + 2 * r, bs // 2
    pitch = (ws + 3) // 4 + 1
    pitch += 1 - pitch % 2
    words = ws * pitch
    if f2 < 32:
        words += (f2 - words) % 32
    return 4 * parents_per_block * words


@dataclasses.dataclass(frozen=True)
class CompactGeometry:
    """How ``csrc/cv_diff.cu`` launches kernel 14: one block per
    ``parents_per_block`` parents of a row and group of ``slots_per_block``
    slots, ``groups`` groups (the last one may be short), ``blocks`` blocks
    in all, ``threads`` per block (a thread a parent's cur=2 row at one
    slot, ``threads // (bs/2 * parents_per_block)`` slots at a time),
    ``smem_bytes`` of dynamic shared memory."""

    parents_per_block: int
    slots_per_block: int
    groups: int
    blocks: int
    threads: int
    smem_bytes: int


def compact_geometry(bs: int, r: int, k_slots: int, batch: int, npy: int,
                     npx: int) -> CompactGeometry:
    """Kernel 14's launch over ``batch`` frames of npy x npx parents at K =
    ``k_slots`` >= 1.

    FINE_PARENTS parents of a row a block (32 / (bs/2) below bs 16, so that
    a warp's lanes are one slot's), at most 256 threads' worth, the row and
    the shared memory; every slot in one group (each window read once)
    unless the grid then has fewer than ``TARGET_BLOCKS`` blocks (the 1080p
    level 3 at B=8 has 320 parents): then the fewest groups of whole
    iterations that fix it."""
    f2 = bs // 2
    want = min(MAX_PARENTS, max(FINE_PARENTS, 32 // f2))
    pp = 1
    while (2 * pp <= min(want, MAX_THREADS // f2, npx)
           and compact_smem(bs, r, 2 * pp) <= SMEM_LIMIT):
        pp *= 2
    unit = max(32, f2 * pp)  # whole warps, whole (parent, slot) groups
    threads = min(MAX_THREADS // unit * unit, -(-k_slots * f2 * pp // unit) * unit)
    per_iter = threads // (f2 * pp)
    iters = -(-k_slots // per_iter)
    tiles = batch * npy * -(-npx // pp)
    groups = 1
    while groups < iters and tiles * groups < TARGET_BLOCKS:
        groups += 1
    slots_per_block = -(-iters // groups) * per_iter
    groups = -(-k_slots // slots_per_block)
    return CompactGeometry(pp, slots_per_block, groups, tiles * groups, threads,
                           compact_smem(bs, r, pp))


def table_curs(bs: int) -> list[int]:
    """The sizes a compact level stores as K-slot tables: 2 .. bs/2."""
    return _curs(bs)[:-1]


def _check_tables(im1, windows, slots, bs, r, cost):
    """Validate kernel 14's inputs; returns K."""
    _check_cost(cost)
    if im1.dtype != torch.uint8 or im1.dim() != 3:
        raise ValueError(f"im1 must be (B, H, W) uint8, got {im1.dtype} {tuple(im1.shape)}")
    b, h, w = im1.shape
    if bs < 4 or h % bs or w % bs:
        raise ValueError(f"need bs >= 4 tiling the {h}x{w} frame, got bs={bs}")
    n_p = (h // bs) * (w // bs)
    win = bs + 2 * r
    if windows.dtype != torch.uint8 or tuple(windows.shape) != (b, n_p, win, win):
        raise ValueError(f"windows must be ({b}, {n_p}, {win}, {win}) uint8, got "
                         f"{windows.dtype} {tuple(windows.shape)}")
    nch = -(-n_p // CHUNK)
    if slots.dtype != torch.int32 or slots.dim() != 4 or tuple(slots.shape[:2]) != (b, nch) \
            or slots.shape[3] != 2:
        raise ValueError(f"slots must be ({b}, {nch}, K, 2) int32, got "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if windows.device != im1.device or slots.device != im1.device:
        raise ValueError("im1, windows and slots must share a device")
    return slots.shape[2]


def compact_tables_plain(
    im1: torch.Tensor,      # (B, H, W) u8
    windows: torch.Tensor,  # (B, nP, bs + 2r, bs + 2r) u8
    slots: torch.Tensor,    # (B, nch, K, 2) int32 (dy + r, dx + r) or -1
    bs: int,
    r: int,
    cost: str,
) -> dict[int, torch.Tensor]:
    """Kernel 14 with torch ops: one slot at a time, the block against the
    window at the slot's delta, pooled 2x2 from each size to the next."""
    k_slots = _check_tables(im1, windows, slots, bs, r, cost)
    b, h, w = im1.shape
    npy, npx = h // bs, w // bs
    n_p = npy * npx
    ws = bs + 2 * r
    dev = im1.device
    patches = (
        im1.reshape(b, npy, bs, npx, bs).permute(0, 1, 3, 2, 4)
        .reshape(b, n_p, bs, bs).to(torch.int32)
    )
    per_parent = slots[:, torch.arange(n_p, device=dev) // CHUNK]  # (B, nP, K, 2)
    ar = torch.arange(bs, device=dev)
    flat = windows.reshape(b, n_p, ws * ws)
    out = {
        c: torch.empty((b, k_slots, h // c, w // c), dtype=cv_dtype(c, cost), device=dev)
        for c in table_curs(bs)
    }
    for k in range(k_slots):
        dy, dx = per_parent[:, :, k, 0], per_parent[:, :, k, 1]
        idx = ((dy.clamp(min=0)[..., None, None] + ar[:, None]) * ws
               + dx.clamp(min=0)[..., None, None] + ar[None, :])  # (B, nP, bs, bs)
        vals = torch.gather(flat, 2, idx.reshape(b, n_p, -1).long()).reshape(b, n_p, bs, bs)
        d = patches - vals.to(torch.int32)
        used = (dy >= 0) & (dx >= 0)
        cvr = torch.where(used[..., None, None], d.abs() if cost == "sad" else d * d, 0)
        cur = 1
        while 2 * cur < bs:
            n = bs // cur
            cvr = cvr.reshape(b, n_p, n // 2, 2, n // 2, 2).sum(dim=(3, 5))
            cur *= 2
            f = bs // cur
            out[cur][:, k] = (
                cvr.reshape(b, npy, npx, f, f).permute(0, 1, 3, 2, 4)
                .reshape(b, npy * f, npx * f).to(out[cur].dtype)
            )
    return out


# bbme_compact_tables(im1, windows, slots, outs, ncur, is16_mask, batch, h, w,
#                     bs, ws, k_slots, nch, chunk, ssd, slots_per_cta,
#                     parents_per_cta, threads, smem_bytes, stream)
TABLES_ARGTYPES = (
    [ctypes.c_void_p] * 3 + [ctypes.POINTER(ctypes.c_void_p)]
    + [ctypes.c_int] * 15 + [ctypes.c_void_p]
)


@functools.lru_cache(maxsize=None)
def _tables_kernel():
    return _build.entry("bbme_compact_tables", TABLES_ARGTYPES)


def compact_tables(
    im1: torch.Tensor,
    windows: torch.Tensor,
    slots: torch.Tensor,
    bs: int,
    r: int,
    cost: str,
) -> dict[int, torch.Tensor]:
    """Kernel 14: ``{cur: (B, K, H/cur, W/cur)}`` for cur = 2 .. bs/2, the
    cost of sub-block (sy, sx) of parent p at slot k of p's chunk at
    ``[b, k, py*f + sy, px*f + sx]`` (f = bs/cur); unused slots hold 0.
    ``slots`` is ``ops.compact.chunk_delta_slots``'s (B, nch, K, 2)."""
    k_slots = _check_tables(im1, windows, slots, bs, r, cost)
    if im1.device.type == "cpu":
        return compact_tables_plain(im1, windows, slots, bs, r, cost)
    if im1.device.type != "cuda":
        raise ValueError(f"unsupported device {im1.device}")
    if not all(t.is_contiguous() for t in (im1, windows, slots)):
        raise ValueError("compact_tables needs contiguous tensors")
    b, h, w = im1.shape
    curs = table_curs(bs)
    out = {
        c: torch.empty((b, k_slots, h // c, w // c), dtype=cv_dtype(c, cost), device=im1.device)
        for c in curs
    }
    if k_slots == 0:
        return out
    ptrs = (ctypes.c_void_p * len(curs))(*(out[c].data_ptr() for c in curs))
    is16 = sum(1 << i for i, c in enumerate(curs) if cv_dtype(c, cost) == torch.uint16)
    geo = compact_geometry(bs, r, k_slots, b, h // bs, w // bs)
    with torch.cuda.device(im1.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = _tables_kernel()(
            im1.data_ptr(), windows.data_ptr(), slots.data_ptr(), ptrs, len(curs), is16,
            b, h, w, bs, bs + 2 * r, k_slots, slots.shape[1], CHUNK, int(cost == "ssd"),
            geo.slots_per_block, geo.parents_per_block, geo.threads, geo.smem_bytes, stream,
        )
    _build.check(code, "compact_tables")
    compact_tables.launches += 1
    return out


compact_tables.launches = 0
