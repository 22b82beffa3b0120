"""Row and 2-D (ty x tx) tiling with halo exchange, and frame-pair batching
(``blockbasedmotionestimation_tpu/parallel/tiled.py``).

A tiled level shards the frame's rows into ``t`` block-aligned strips, or
its rows and columns into a ``t x tx`` grid of block-aligned tiles, and
exchanges exactly what the algorithm reads across tile edges:

  * frame-2 pixel halos for the windows: a tile's predicted centres sit at
    most ``mv_bound`` pixels outside it and the windows reach the spiral
    extent further (``im2_halo``), exchanged once a level (rows, then
    columns: the column pass over the row-extended buffer carries the
    diagonal corners);
  * one row of MVs before every colour step of every round (the ghost rows,
    ``cell_exchange``), and on 2-D tiles one column each side, extended
    with the ghost rows' end cells (``cell_exchange_2d``: the corners);
    one ring of search winners for the rival pick (``rival_extend``,
    edge-replicated at the frame's edges).

Every bounds check in ``ops`` uses the frame's rows, columns, height and
width, so the tiled pipeline equals the untiled one bit for bit.  A level
that shards on both axes runs on 2-D tiles, one that shards rows only on
row strips, any other whole-frame (``engine._run_level``); the pyramid and
``transfer_mvs`` run whole-frame too, with the ``mv_cap`` clamp.

The mesh (``Mesh``) names its axes as the reference's does: ("batch",
"ty") or ("ty", "tx") / ("batch", "ty", "tx").  Two transports carry the
exchanges, one interface (``exchange_rows``, ``exchange_cols``, their
edge-replicated forms, ``cell_exchange``, ``cell_exchange_2d``, and
``ghost_cells`` and ``rival_extend``, which a level's ``ops.search.Tiling``
carries):

  * in-process (``Mesh`` without ranks, ``LocalTiles``): the tiles of a
    frame are consecutive entries of one batch on one device (entry
    b * (t * tx) + i * tx + j is tile (i, j) of frame b), so every step of
    a round is one launch for all tiles, and an exchange is a few copies
    between entries.  The one-card H100 runs this; NCCL takes one device a
    rank.
  * ``torch.distributed`` point to point (a ``Mesh`` over ranks, as
    ``multihost.make_mesh`` builds, or a ("ty", "tx") one built directly;
    ``DistTiles``): each process holds one tile of its batch chunk and
    swaps edge rows with its north and south neighbours and edge columns
    with its west and east ones (``batch_isend_irecv``; NCCL on CUDA
    tensors, gloo on CPU tensors, a mismatch raises).  After a tiled level
    the tiles are gathered along the column axis, then the row axis, and
    the result along the batch axis.  On a row-only level of a 2-D mesh
    every process of a column line computes the same strip.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from blockbasedmotionestimation_tpu_torch.config import MotionConfig
from blockbasedmotionestimation_tpu_torch.models import engine
from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops
from blockbasedmotionestimation_tpu_torch.ops import resample
from blockbasedmotionestimation_tpu_torch.ops.regularize import run_schedule
from blockbasedmotionestimation_tpu_torch.ops.search import Tiling, block_search_level
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent
from blockbasedmotionestimation_tpu_torch.ops.windowed import windowed_level, windowed_schedule
from blockbasedmotionestimation_tpu_torch.utils import profiling

_NO_EXACT = ("regularizer='exact' is a whole-frame raster sweep and cannot be row-tiled; "
             "use {}, or fourcolor/windowed here")


# ------------------------------------------------------------ planning

def mv_bound(cfg: MotionConfig, level: int) -> int:
    """Worst-case |MV| component at `level` after its search: the propagated
    coarse MV doubles per level and each search adds its spiral extent;
    windowed mode adds the reg radius per coarser level; ``cfg.mv_cap``
    clamps the transferred prediction."""
    m = 0  # max |MV| after the coarser level completes
    for l in range(cfg.num_levels - 1, level - 1, -1):
        s = spiral_extent(cfg.shift(l))
        pred = 2 * m  # the transferred prediction at level l
        if cfg.mv_cap is not None:
            pred = min(pred, cfg.mv_cap)
        m = pred + s  # search reach at level l
        if cfg.regularizer == "windowed" and l > level:
            r = s if cfg.reg_radius is None else min(cfg.reg_radius, s)
            m += r
    return m


def im2_halo(cfg: MotionConfig, level: int) -> int:
    """Frame-2 halo rows needed at `level`: the search-window reach, plus the
    regularizer windows' extra spiral-extent reach in windowed mode."""
    halo = mv_bound(cfg, level)
    if cfg.regularizer == "windowed":
        halo += spiral_extent(cfg.shift(level))
    return halo


def _level_shardable(h: int, w: int, bs: int, t: int) -> bool:
    """Rows must tile evenly into block-aligned strips (odd block-row counts
    are fine: colour steps use per-strip parity)."""
    return h % (t * bs) == 0


def plan_tiling(cfg: MotionConfig, padded_h: int, padded_w: int, t: int,
                tx: int = 1) -> list[dict]:
    """Per-level shardability report for pre-padded frames on a (t row
    tiles x tx column tiles) mesh: {level, h, w, bs, halo, strip_h,
    strip_w, rows_ok, cols_ok}, the predicate the tiled engine evaluates:
    rows_ok and cols_ok, the level runs on 2-D tiles; rows_ok alone, on row
    strips; otherwise whole-frame."""
    out = []
    h, w = padded_h, padded_w
    dims = []
    for level in range(cfg.num_levels):
        dims.append((h, w))
        h, w = h // 2, w // 2
    for level, (h, w) in enumerate(dims):
        bs = cfg.block_sizes[level]
        halo = im2_halo(cfg, level)
        rows_ok = _level_shardable(h, w, bs, t) and halo < h // t
        cols_ok = tx > 1 and _level_shardable(w, h, bs, tx) and halo < w // tx
        out.append(dict(level=level, h=h, w=w, bs=bs, halo=halo, strip_h=h // t,
                        strip_w=(w // tx if tx > 1 else w), rows_ok=rows_ok, cols_ok=cols_ok))
    return out


def derive_mv_cap(cfg: MotionConfig, orig_h: int, orig_w: int, t: int,
                  tx: int = 1) -> int | None:
    """Largest ``mv_cap`` that lets the finest level shard into ``t`` row
    strips (and ``tx`` column strips when > 1) at the tile-aware padding.
    None when the uncapped halo already fits; ValueError when even the
    smallest legal cap cannot."""
    p = pad_ops.compute_padding(orig_h, orig_w, cfg, row_tiles=t)
    strip = p.padded_h // t
    if tx > 1:
        strip = min(strip, p.padded_w // tx)

    def fits(cap: int | None) -> bool:
        return im2_halo(cfg.replace(mv_cap=cap), 0) < strip

    if fits(None):
        return None
    cap_min = max(ss - bs for bs, ss in zip(cfg.block_sizes, cfg.search_sizes))
    if not fits(cap_min):
        raise ValueError(
            f"even mv_cap={cap_min} needs a {im2_halo(cfg.replace(mv_cap=cap_min), 0)}-row "
            f"halo but strips are only {strip} rows: {t}x{tx} tiles cannot "
            f"shard a {orig_h}x{orig_w} frame under this config; use fewer "
            "tiles or rely on batch parallelism"
        )
    lo, hi = cap_min, max(cap_min + 1, im2_halo(cfg.replace(mv_cap=None), 0))
    while lo + 1 < hi:  # fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo


def _warn_if_fully_replicated(cfg: MotionConfig, h: int, w: int, t: int, tx: int) -> None:
    """Warn when no level shards: every level would run whole-frame on
    every tile."""
    plan = plan_tiling(cfg, h, w, t, tx)
    if any(e["rows_ok"] or e["cols_ok"] for e in plan):
        return
    e0 = plan[0]
    if e0["halo"] >= e0["strip_h"]:
        try:
            cap = derive_mv_cap(cfg, h, w, t, tx)
            hint = (f"set mv_cap (derive_mv_cap suggests {cap}) and pad with "
                    "compute_padding(..., row_tiles=t), or use estimate_flow_tiled_auto")
        except ValueError as err:
            hint = str(err)
    else:
        hint = ("pad with compute_padding(..., row_tiles=t) so strips are "
                "block-aligned, or use estimate_flow_tiled_auto")
    warnings.warn(
        f"estimate_flow_padded_tiled: NO pyramid level shards on the "
        f"{t}x{tx} spatial mesh ({h}x{w} frame, level-0 halo {e0['halo']} "
        f"rows vs {e0['strip_h']}-row strips) - every level will run "
        f"REPLICATED on all devices ({t * tx}x redundant work); {hint}",
        stacklevel=3,
    )


# ------------------------------------------------------------ the mesh

class Mesh:
    """A grid of tiles with named axes, the port's counterpart of the
    reference's ``jax.sharding.Mesh``: ``shape`` is {axis name: size}.
    Without ``ranks`` every tile is a batch entry of this process
    (in-process); with ``ranks`` (an array of that shape) tile k is the
    process of that rank in the default ``torch.distributed`` group."""

    def __init__(self, shape, axis_names=("batch", "ty"), ranks=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not match axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, shape))
        self.ranks = None if ranks is None else np.asarray(ranks).reshape(shape)
        self._groups = None

    @property
    def distributed(self) -> bool:
        """Whether the tiles are processes (a mesh of one tile never is)."""
        return self.ranks is not None and self.ranks.size > 1

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={None if self.ranks is None else self.ranks.tolist()})"

    def coords(self) -> dict:
        """This process's index on each axis."""
        pos = np.argwhere(self.ranks == torch.distributed.get_rank())
        if len(pos) != 1:
            raise ValueError(f"rank {torch.distributed.get_rank()} is not in {self!r}")
        return dict(zip(self.axis_names, pos[0].tolist()))

    def line(self, axis: str) -> list[int]:
        """The ranks of this process's line along ``axis``, in order."""
        c = self.coords()
        idx = tuple(slice(None) if a == axis else c[a] for a in self.axis_names)
        return self.ranks[idx].tolist()

    def group(self, axis: str):
        """This process's ``torch.distributed`` group along ``axis`` (every
        process creates every line's group, in the same order, once)."""
        if self._groups is None:
            self._groups = {}
        if axis not in self._groups:
            k = self.axis_names.index(axis)
            lines = np.moveaxis(self.ranks, k, -1).reshape(-1, self.ranks.shape[k])
            mine = None
            for ln in lines:
                g = torch.distributed.new_group(ln.tolist())
                if torch.distributed.get_rank() in ln:
                    mine = g
            self._groups[axis] = mine
        return self._groups[axis]


# ------------------------------------------------------------ transports

class _Tiles:
    """The exchanges of one level's tiles over a (ty x tx) grid, batch
    first: x is (n, rows, cols, ...); tx = 1 for row strips.  Subclasses
    give ``_swap(axis, first, last)`` -> (from before, from after): along
    ``axis`` (0: rows, the north / south neighbours; 1: columns, west /
    east) each tile's first part sent to the tile before it and its last
    part to the tile after it, the neighbours' received, zeros at the mesh
    edge; ``_sent(axis, first, last)``: the bytes this process sends in
    that swap; and ``_edges(axis, n, device)`` -> ((n,) bool, (n,) bool):
    the tiles at the frame's first / last rows (columns).

    Each swap along an axis of more than one tile is one exchange of its
    kind (``utils.profiling.exchanged``, in the span ``mf.exchange``):
    ``halo`` (``exchange_rows``, ``exchange_cols``), ``ghost``
    (``cell_exchange``, ``cell_exchange_2d``), ``rival`` (the
    edge-replicated forms, ``rival_extend``); each all-gather of a join one
    of ``join`` (in the span ``mf.join``)."""

    ty: int
    tx: int

    def _exchange(self, kind: str, axis: int, first: torch.Tensor, last: torch.Tensor):
        """``_swap``, counted as one exchange of ``kind``."""
        if (self.ty, self.tx)[axis] > 1:
            profiling.exchanged(kind, self._sent(axis, first, last))
        with profiling.span("exchange", kind=kind):
            return self._swap(axis, first, last)

    def exchange_rows(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        """x with ``halo`` rows of its north and south neighbours
        (zeros at the frame's edges)."""
        if halo == 0:
            return x
        north, south = self._exchange("halo", 0, x[:, :halo], x[:, -halo:])
        return torch.cat([north, x, south], dim=1)

    def exchange_cols(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        """x with ``halo`` columns of its west and east neighbours (zeros
        at the frame's edges); after ``exchange_rows`` the columns carry
        the diagonal neighbours' corners."""
        if halo == 0:
            return x
        west, east = self._exchange("halo", 1, x[:, :, :halo], x[:, :, -halo:])
        return torch.cat([west, x, east], dim=2)

    def _exchange_edge(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        d = axis + 1
        lo, hi = x.narrow(d, 0, 1), x.narrow(d, x.shape[d] - 1, 1)
        before, after = self._exchange("rival", axis, lo, hi)
        first, last = self._edges(axis, x.shape[0], x.device)
        shape = (-1,) + (1,) * (x.dim() - 1)
        before = torch.where(first.reshape(shape), lo, before)
        after = torch.where(last.reshape(shape), hi, after)
        return torch.cat([before, x, after], dim=d)

    def exchange_rows_edge(self, x: torch.Tensor) -> torch.Tensor:
        """x with one neighbour row each side, edge-replicated at the
        frame's edges (the untiled engine's edge padding)."""
        return self._exchange_edge(x, 0)

    def exchange_cols_edge(self, x: torch.Tensor) -> torch.Tensor:
        """x with one neighbour column each side, edge-replicated at the
        frame's edges."""
        return self._exchange_edge(x, 1)

    def cell_exchange(self, top: torch.Tensor, bottom: torch.Tensor):
        """The ghost rows before a colour step: each strip's first row (top)
        sent north and last row (bottom) sent south; returns (from north,
        from south), zeros at the frame's edges."""
        north, south = self._exchange("ghost", 0, top[:, None], bottom[:, None])
        return north[:, 0], south[:, 0]

    def cell_exchange_2d(self, top: torch.Tensor, bottom: torch.Tensor, west: torch.Tensor,
                         east: torch.Tensor):
        """The ghost rows and columns before a colour step on 2-D tiles
        (reference ``cell_exchange_2d``): the ghost rows over the row axis
        first; then each tile's first and last columns, extended with the
        end cells of the ghost rows it received (rows -1 .. nby), over the
        column axis, so a ghost column carries the diagonal neighbours'
        corner cells.  top / bottom (n, nbx, 2), west / east (n, nby, 2);
        returns (from north, from south, from west, from east), zeros at
        the frame's edges."""
        north, south = self.cell_exchange(top, bottom)
        west_mine = torch.cat([north[:, :1], west, south[:, :1]], dim=1)
        east_mine = torch.cat([north[:, -1:], east, south[:, -1:]], dim=1)
        from_west, from_east = self._exchange("ghost", 1, west_mine[:, None],
                                              east_mine[:, None])
        return north, south, from_west[:, 0], from_east[:, 0]

    def ghost_cells(self, grid: torch.Tensor):
        """The ghost cells of an (n, nby, nbx, 2) grid before a colour step
        (``ops.search.Tiling.exchange``): (north, south, west, east), west
        and east None on row strips (their columns are the frame's)."""
        if self.tx == 1:
            return (*self.cell_exchange(grid[:, 0], grid[:, -1]), None, None)
        return self.cell_exchange_2d(grid[:, 0], grid[:, -1], grid[:, :, 0], grid[:, :, -1])

    def rival_extend(self, g: torch.Tensor) -> torch.Tensor:
        """(n, npy, npx, 2) search winners with a ring of one: the
        neighbouring tiles' rows, then columns (edge-replicated at the
        frame's edges, so on row strips the edge columns replicated)."""
        return self.exchange_cols_edge(self.exchange_rows_edge(g))


class LocalTiles(_Tiles):
    """In-process transport: entry b * (ty * tx) + i * tx + j of a batch is
    tile (i, j) of frame b, all on one device (tx = 1: row strips)."""

    def __init__(self, ty: int, tx: int = 1):
        self.ty, self.tx = ty, tx

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, ...) frames -> (B * ty * tx, H / ty, W / tx, ...) tiles
        (a view for row strips: the transposed axis has size 1)."""
        b, h, w = x.shape[:3]
        ty, tx = self.ty, self.tx
        t = x.reshape(b, ty, h // ty, tx, w // tx, *x.shape[3:]).transpose(2, 3)
        return t.reshape(b * ty * tx, h // ty, w // tx, *x.shape[3:])

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """(B * ty * tx, h, w, ...) tiles -> (B, ty * h, tx * w, ...) frames,
        counted as the processes of a (ty, tx) mesh join them: each tile
        sent to the others of its column line, then each row of whole width
        to the others of its row line."""
        n, h, w = x.shape[:3]
        ty, tx = self.ty, self.tx
        with profiling.span("join"):
            for tiles, sent in ((tx, x.nbytes), (ty, x.nbytes * tx)):
                if tiles > 1:
                    profiling.exchanged("join", sent * (tiles - 1))
            t = x.reshape(n // (ty * tx), ty, tx, h, w, *x.shape[3:]).transpose(2, 3)
            return t.reshape(n // (ty * tx), ty * h, tx * w, *x.shape[3:])

    def _index(self, axis: int, n: int, device) -> torch.Tensor:
        k = torch.arange(n, device=device)
        return (k // self.tx) % self.ty if axis == 0 else k % self.tx

    def row0(self, n: int, ht: int, device) -> torch.Tensor:
        return (self._index(0, n, device) * ht).to(torch.int32)

    def col0(self, n: int, wt: int, device) -> torch.Tensor:
        return (self._index(1, n, device) * wt).to(torch.int32)

    def _edges(self, axis, n, device):
        k = self._index(axis, n, device)
        return k == 0, k == (self.ty, self.tx)[axis] - 1

    def _sent(self, axis, first, last):
        # every tile but the mesh edge's sends its first (last) part
        k = (self.ty, self.tx)[axis]
        return (first.nbytes + last.nbytes) * (k - 1) // k

    def _swap(self, axis, first, last):
        ty, tx = self.ty, self.tx
        d = 1 + axis  # the mesh axis in the (-1, ty, tx, ...) view
        fv = first.reshape(-1, ty, tx, *first.shape[1:])
        lv = last.reshape(-1, ty, tx, *last.shape[1:])
        k = fv.shape[d]
        before = torch.zeros_like(lv)
        after = torch.zeros_like(fv)
        before.narrow(d, 1, k - 1).copy_(lv.narrow(d, 0, k - 1))
        after.narrow(d, 0, k - 1).copy_(fv.narrow(d, 1, k - 1))
        return before.reshape(last.shape), after.reshape(first.shape)


class DistTiles(_Tiles):
    """``torch.distributed`` transport: this process holds tile (i, j) of
    each frame of its batch chunk, i its index on the mesh's row axis and
    j on its column axis (``axis_x``; None: row strips, every process of
    a column line holding the same strip); its neighbours along each axis
    are the processes before and after it on that line."""

    def __init__(self, mesh: Mesh, axis: str, axis_x: str | None = None):
        self.lines = []
        for ax in (axis, axis_x):
            if ax is None:
                self.lines.append(dict(tiles=1, index=0, prev=None, next=None, group=None))
                continue
            line = mesh.line(ax)
            i = mesh.coords()[ax]
            self.lines.append(dict(tiles=len(line), index=i,
                                   prev=line[i - 1] if i > 0 else None,
                                   next=line[i + 1] if i + 1 < len(line) else None,
                                   group=mesh.group(ax)))
        self.ty, self.tx = self.lines[0]["tiles"], self.lines[1]["tiles"]

    def split(self, x: torch.Tensor) -> torch.Tensor:
        ht, wt = x.shape[1] // self.ty, x.shape[2] // self.tx
        i, j = self.lines[0]["index"], self.lines[1]["index"]
        return x[:, i * ht:(i + 1) * ht, j * wt:(j + 1) * wt].contiguous()

    def join(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.span("join"):
            for d in (2, 1):  # the column line first, then the rows of whole width
                ln = self.lines[d - 1]
                if ln["tiles"] == 1:
                    continue
                profiling.exchanged("join", x.nbytes * (ln["tiles"] - 1))
                parts = [torch.empty_like(x) for _ in range(ln["tiles"])]
                torch.distributed.all_gather(parts, _checked(x.contiguous()), group=ln["group"])
                x = torch.cat(parts, dim=d)
            return x

    def row0(self, n: int, ht: int, device) -> torch.Tensor:
        return torch.full((n,), self.lines[0]["index"] * ht, dtype=torch.int32, device=device)

    def col0(self, n: int, wt: int, device) -> torch.Tensor:
        return torch.full((n,), self.lines[1]["index"] * wt, dtype=torch.int32, device=device)

    def _edges(self, axis, n, device):
        ln = self.lines[axis]
        return (torch.full((n,), ln["prev"] is None, device=device),
                torch.full((n,), ln["next"] is None, device=device))

    def _sent(self, axis, first, last):
        ln = self.lines[axis]
        return ((first.nbytes if ln["prev"] is not None else 0)
                + (last.nbytes if ln["next"] is not None else 0))

    def _swap(self, axis, first, last):
        dist = torch.distributed
        ln = self.lines[axis]
        first, last = _checked(first.contiguous()), last.contiguous()
        before = torch.zeros_like(last)
        after = torch.zeros_like(first)
        ops = []
        if ln["prev"] is not None:
            ops += [dist.P2POp(dist.isend, first, ln["prev"]),
                    dist.P2POp(dist.irecv, before, ln["prev"])]
        if ln["next"] is not None:
            ops += [dist.P2POp(dist.isend, last, ln["next"]),
                    dist.P2POp(dist.irecv, after, ln["next"])]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return before, after


def _checked(x: torch.Tensor) -> torch.Tensor:
    """x, if the process group's backend carries its device: NCCL CUDA
    tensors, gloo CPU tensors; anything else raises (no quiet swap)."""
    backend = torch.distributed.get_backend()
    want = {"nccl": "cuda", "gloo": "cpu"}.get(backend)
    if want is not None and x.device.type != want:
        raise ValueError(f"the {backend} process group carries {want} tensors, got one on "
                         f"{x.device}")
    return x


# ------------------------------------------------------------ the engine

def _tiled_level(im1: torch.Tensor, im2: torch.Tensor, pred: torch.Tensor, bs: int, ss: int,
                 cfg: MotionConfig, level: int, full_h: int, full_w: int, halo: int,
                 tiles: _Tiles) -> torch.Tensor:
    """One level on a batch of tiles (im1, im2 (n, ht, wt) u8, pred (n,
    ht / bs, wt / bs, 2)): the frame-2 halo exchanged once (rows, then on
    2-D tiles columns, which carry the corners), then the level's search
    and schedule as ``engine._run_level`` dispatches them, in the frame's
    coordinates.  Returns the tiles' (n, ht, wt, 2) int32 grid.
    ``cv_compact`` is not taken (the reference's tiled levels pass none)."""
    n, ht, wt = im1.shape
    row0 = tiles.row0(n, ht, im1.device)
    im2_buf = tiles.exchange_rows(im2, halo)
    col0 = im2_col0 = 0  # row strips: the buffer's columns are the frame's
    if tiles.tx > 1:
        col0 = tiles.col0(n, wt, im1.device)
        im2_col0 = col0 - halo
        im2_buf = tiles.exchange_cols(im2_buf, halo)
    tiling = Tiling(row0, row0 - halo, full_h, col0, im2_col0, full_w, tiles.ghost_cells,
                    tiles.rival_extend)
    lam0 = float(bs) * cfg.lambda_scale
    rr = cfg.rival_radius_at(level)
    if cfg.uses_fused_windowed:
        return windowed_level(
            im1, im2_buf, pred, bs, ss, lam0, cfg.sweeps_per_round, cost=cfg.cost,
            rival=cfg.rival_window, rival_radius=rr, store_radius=cfg.cv_store_radius,
            fuse=cfg.cv_fused if engine._accelerated(cfg) else None, tiling=tiling,
        )
    grid = block_search_level(im1, im2_buf, pred, bs, ss, order=cfg.search_order,
                              cost=cfg.cost, tiling=tiling)
    if cfg.regularizer == "windowed":
        return windowed_schedule(
            im1, im2_buf, grid, bs, ss, lam0, cfg.sweeps_per_round, cost=cfg.cost,
            reg_radius=cfg.reg_radius, rival=cfg.rival_window, rival_radius=rr, tiling=tiling,
        )
    return run_schedule(im1, im2_buf, grid, bs, lam0, cfg.sweeps_per_round, cfg.regularizer,
                        cost=cfg.cost, tiling=tiling)


def _levels(im1s: torch.Tensor, im2s: torch.Tensor, cfg: MotionConfig, tiles: _Tiles,
            rows: _Tiles) -> torch.Tensor:
    """The coarse-to-fine engine on pre-padded (B, H, W) frames: a level
    that shards on both axes (``plan_tiling``'s rows_ok and cols_ok) runs
    on the 2-D tiles of ``tiles``, one that shards rows only on the row
    strips of ``rows``, any other whole-frame (so does one that shards
    columns only); (B, H, W, 2) f32.  For row tiling ``tiles`` is
    ``rows``."""
    levels = cfg.num_levels
    with profiling.span("pyramid"):
        pyr1 = resample.build_pyramid(im1s, levels)
        pyr2 = resample.build_pyramid(im2s, levels)
    dense = None
    for level in range(levels - 1, -1, -1):
        with profiling.span("level", level=level):
            im1, im2 = pyr1[level], pyr2[level]
            b, h, w = im1.shape
            bs, ss = cfg.block_sizes[level], cfg.search_sizes[level]
            if dense is None:
                pred = torch.zeros((b, h // bs, w // bs, 2), dtype=torch.float32,
                                   device=im1.device)
            else:
                pred = engine.transfer_mvs(dense, cfg.block_sizes[level + 1], bs)
                if cfg.mv_cap is not None:  # the untiled engine's clamp
                    pred = pred.clamp(-float(cfg.mv_cap), float(cfg.mv_cap))
            halo = im2_halo(cfg, level)
            rows_ok = _level_shardable(h, w, bs, rows.ty) and halo < h // rows.ty
            cols_ok = (tiles.tx > 1 and _level_shardable(w, h, bs, tiles.tx)
                       and halo < w // tiles.tx)
            by = tiles if rows_ok and cols_ok else rows if rows_ok else None
            profiling.tiled_level("whole" if by is None else "tiles" if by.tx > 1 else "strips")
            if by is not None:
                grid = _tiled_level(by.split(im1), by.split(im2), by.split(pred), bs, ss, cfg,
                                    level, h, w, halo, by)
                dense = by.join(grid).to(torch.float32)
            else:
                # a level too small to tile runs whole-frame (coarse levels are tiny)
                dense = engine._run_level(im1, im2, pred, bs, ss, cfg, level).to(torch.float32)
    return dense


def _gather_batch(x: torch.Tensor, mesh: Mesh, batch_axis: str | None) -> torch.Tensor:
    """The (B, ...) result of every batch chunk, from the first process of
    each chunk, on every process (one exchange of kind ``batch``); ``x``
    itself, with no collective, where the batch is not split
    (``batch_axis`` None: every process holds the whole batch)."""
    if batch_axis is None:
        return x
    dist = torch.distributed
    world = dist.get_world_size()
    profiling.exchanged("batch", x.nbytes * (world - 1))
    with profiling.span("exchange", kind="batch"):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, _checked(x.contiguous()))
    k = mesh.axis_names.index(batch_axis)
    firsts = np.moveaxis(mesh.ranks, k, 0).reshape(mesh.ranks.shape[k], -1)[:, 0]
    return torch.cat([parts[r] for r in firsts.tolist()], dim=0)


def _run(im1s, im2s, cfg: MotionConfig, mesh: Mesh, axis: str, axis_x, batch_axis,
         device, entry: str) -> torch.Tensor:
    """The tiled engine on pre-padded (B, H, W) pairs: the batch split over
    ``batch_axis`` (None: every process takes the whole batch), rows over
    ``axis`` and columns over ``axis_x`` (None: row tiling); (B, H, W, 2)
    f32 on every process."""
    if cfg.regularizer == "exact":
        raise ValueError(_NO_EXACT.format(entry))
    a = engine._as_frames(im1s, device, 3)
    b = engine._as_frames(im2s, a.device, 3)
    engine.check_config(cfg, a.device)
    if batch_axis is not None and a.shape[0] % mesh.shape[batch_axis]:
        raise ValueError(f"batch {a.shape[0]} does not split over {mesh.shape}")
    if not mesh.distributed:
        rows = LocalTiles(mesh.shape[axis])
        tiles = LocalTiles(mesh.shape[axis], mesh.shape[axis_x]) if axis_x else rows
        return _levels(a, b, cfg, tiles, rows)
    rows = DistTiles(mesh, axis)
    tiles = DistTiles(mesh, axis, axis_x) if axis_x else rows
    if batch_axis is not None:
        chunk = a.shape[0] // mesh.shape[batch_axis]
        bi = mesh.coords()[batch_axis]
        a, b = a[bi * chunk:(bi + 1) * chunk], b[bi * chunk:(bi + 1) * chunk]
    dense = _levels(a.contiguous(), b.contiguous(), cfg, tiles, rows)
    return _gather_batch(dense, mesh, batch_axis)


@profiling.entry
def estimate_flow_padded_tiled(im1p, im2p, cfg: MotionConfig, mesh: Mesh, axis: str = "ty",
                               axis_x: str | None = None, device=None) -> torch.Tensor:
    """Tiled, halo-exchanged engine on one pre-padded (H', W') pair: the
    dense (H', W', 2) f32 flow, equal to ``engine.estimate_flow_padded``
    bit for bit in fourcolor, jacobi and windowed modes.  Rows shard over
    ``axis``, and with ``axis_x`` columns over that mesh axis too (2-D ty x
    tx tiling); ``exact`` does not decompose and raises.  Numpy frames run
    on the card unless ``device`` says otherwise."""
    a = engine._as_frames(im1p, device, 2)
    b = engine._as_frames(im2p, a.device, 2)
    if cfg.regularizer != "exact":
        _warn_if_fully_replicated(cfg, a.shape[0], a.shape[1], mesh.shape[axis],
                                  mesh.shape[axis_x] if axis_x else 1)
    return _run(a[None], b[None], cfg, mesh, axis, axis_x, None, None,
                "estimate_flow_padded")[0]


@profiling.entry
def estimate_flow_padded_batch_tiled(im1s, im2s, cfg: MotionConfig, mesh: Mesh,
                                     batch_axis: str = "batch", axis: str = "ty",
                                     axis_x: str | None = None, device=None) -> torch.Tensor:
    """Frame pairs over ``batch_axis`` and rows over ``axis`` (the layout
    ``multihost.make_mesh`` builds), with ``axis_x`` columns over a third
    mesh axis (batch x ty x tx): (B, H', W') pre-padded u8 pairs, B
    divisible by the batch axis -> (B, H', W', 2) f32 on every process."""
    return _run(im1s, im2s, cfg, mesh, axis, axis_x, batch_axis, device,
                "engine.estimate_flow_batched")


@profiling.entry
def estimate_flow_batch(im1s, im2s, cfg: MotionConfig, mesh: Mesh,
                        batch_axis: str = "batch", device=None) -> torch.Tensor:
    """Data-parallel driver over (B, H, W) u8 pairs: each batch chunk
    through ``engine.estimate_flow_driver_batched``; (B, H, W, 2) f32
    original-resolution flow on every process."""
    a = engine._as_frames(im1s, device, 3)
    b = engine._as_frames(im2s, a.device, 3)
    nb = mesh.shape[batch_axis]
    if a.shape[0] % nb:
        raise ValueError(f"batch {a.shape[0]} does not split over {mesh.shape}")
    if not mesh.distributed:
        return engine.estimate_flow_driver_batched(a, b, cfg)
    chunk = a.shape[0] // nb
    bi = mesh.coords()[batch_axis]
    flow = engine.estimate_flow_driver_batched(a[bi * chunk:(bi + 1) * chunk],
                                               b[bi * chunk:(bi + 1) * chunk], cfg)
    return _gather_batch(flow, mesh, batch_axis)


@profiling.entry
def estimate_flow_driver_tiled(im1s, im2s, cfg: MotionConfig, mesh: Mesh, axis: str = "ty",
                               axis_x: str | None = None, device=None) -> torch.Tensor:
    """The reference driver on (B, H, W) u8 pairs through the tiled engine,
    the counterpart of ``engine.estimate_flow_driver_batched``: upscale by
    ``interp_factor``, pad with ``row_tiles`` = the mesh's row axis, rows
    over ``axis`` and columns over ``axis_x`` (None: row tiling), every
    process on the whole batch, then every f-th pixel of the unpadded field
    divided by f.  The configuration
    is run as given (no ``mv_cap`` is derived): a level whose halo does not
    fit its tiles runs whole-frame.  Returns (B, H, W, 2) f32 flow at the
    original resolution on every process."""
    a = engine._as_frames(im1s, device, 3)
    b = engine._as_frames(im2s, a.device, 3)
    a, b = engine.upscale(a, b, cfg.interp_factor)
    with profiling.span("pad"):
        p = pad_ops.compute_padding(a.shape[1], a.shape[2], cfg, row_tiles=mesh.shape[axis])
        a, b = pad_ops.pad_frame(a, p), pad_ops.pad_frame(b, p)
    flow = _run(a, b, cfg, mesh, axis, axis_x, None, None,
                "engine.estimate_flow_driver_batched")
    return engine.subsample(flow, p, cfg.interp_factor)


@profiling.entry
def estimate_flow_tiled_auto(im1, im2, cfg: MotionConfig, mesh: Mesh, axis: str = "ty",
                             axis_x: str | None = None, device=None) -> torch.Tensor:
    """Tiling on an unpadded (H, W) pair: pads with ``row_tiles`` = the
    mesh's row axis, applies ``derive_mv_cap`` (rows over ``axis``, columns
    over ``axis_x`` when given) when ``cfg.mv_cap`` is unset and the
    uncapped halo cannot fit a tile (an explicit cap is kept), raises when
    no cap can make the finest level shard.  Returns the (H, W, 2) flow
    cropped to the frame (MVs in processed pixels)."""
    a = engine._as_frames(im1, device, 2)
    b = engine._as_frames(im2, a.device, 2)
    h, w = a.shape
    t = mesh.shape[axis]
    tx = mesh.shape[axis_x] if axis_x is not None else 1
    run_cfg = cfg
    if cfg.mv_cap is None:
        cap = derive_mv_cap(cfg, h, w, t, tx)
        if cap is not None:
            run_cfg = cfg.replace(mv_cap=cap)
    p = pad_ops.compute_padding(h, w, run_cfg, row_tiles=t)
    flow = estimate_flow_padded_tiled(pad_ops.pad_frame(a, p), pad_ops.pad_frame(b, p), run_cfg,
                                      mesh, axis, axis_x)
    return flow[p.pad_y:p.pad_y + h, p.pad_x:p.pad_x + w]
