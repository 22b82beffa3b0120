"""Row tiling with halo exchange, and frame-pair batching
(``blockbasedmotionestimation_tpu/parallel/tiled.py``).

A tiled level shards the frame's rows into ``t`` block-aligned strips and
exchanges exactly what the algorithm reads across strip edges:

  * frame-2 pixel halos for the windows: a strip's predicted centres sit at
    most ``mv_bound`` rows outside it and the windows reach the spiral
    extent further (``im2_halo``), exchanged once a level;
  * one row of MVs before every colour step of every round (the ghost rows,
    ``cell_exchange``), and one row of search winners for the rival pick
    (``rival_extend``, edge-replicated at the frame's edges).

Every bounds check in ``ops`` uses the frame's rows and height, so the
tiled pipeline equals the untiled one bit for bit.  A level whose rows do
not split into block-aligned strips, or whose halo swallows a strip, runs
whole-frame (``engine._run_level``); the pyramid and ``transfer_mvs`` run
whole-frame too, with the ``mv_cap`` clamp.

The mesh (``Mesh``) names its axes as the reference's does: ("batch",
"ty").  Two transports carry the exchanges, one interface
(``exchange_rows``, ``exchange_rows_edge``, ``cell_exchange``):

  * in-process (``Mesh`` without ranks): the strips of a frame are
    consecutive entries of one batch on one device (entry b * t + i is
    strip i of frame b), so every step of a round is one launch for all
    strips, and an exchange is a few copies between entries.  The one-card
    H100 runs this; NCCL takes one device a rank.
  * ``torch.distributed`` point to point (a ``Mesh`` over ranks, as
    ``multihost.make_mesh`` builds): each process holds one strip of its
    batch chunk and swaps edge rows with its north and south neighbours
    (``batch_isend_irecv``; NCCL on CUDA tensors, gloo on CPU tensors, a
    mismatch raises).  After a tiled level the strips are gathered along
    the row axis, and the result along the batch axis.

2-D (ty x tx) tiling is not ported yet (``axis_x`` raises).
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
from blockbasedmotionestimation_tpu_torch.ops.search import block_search_level
from blockbasedmotionestimation_tpu_torch.ops.spiral import spiral_extent
from blockbasedmotionestimation_tpu_torch.ops.windowed import (
    _edge_index,
    windowed_level,
    windowed_schedule,
)

_NO_2D = ("2-D (ty x tx) tiling is not ported yet (ROADMAP Queue 1: the 2-D tiling "
          "slice); tile rows only")
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
    strip_w, rows_ok, cols_ok}, the predicate the tiled engine evaluates.
    (Columns are reported as the reference reports them; the port tiles
    rows only.)"""
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

class _Rows:
    """The row exchanges of one level's strips, batch first: x is (n, rows,
    ...).  Subclasses give ``_swap(top, bottom)`` -> (from north, from
    south): each strip's top block sent north and bottom block sent south,
    the neighbours' received, zeros at the mesh edge; and ``_first(n)`` /
    ``_last(n)``: (n,) bool, the strips at the frame's top / bottom."""

    def exchange_rows(self, x: torch.Tensor, halo: int) -> torch.Tensor:
        """x with ``halo`` rows of its north and south neighbours
        (zeros at the frame's edges)."""
        if halo == 0:
            return x
        north, south = self._swap(x[:, :halo], x[:, -halo:])
        return torch.cat([north, x, south], dim=1)

    def exchange_rows_edge(self, x: torch.Tensor) -> torch.Tensor:
        """x with one neighbour row each side, edge-replicated at the
        frame's edges (the untiled engine's edge padding)."""
        north, south = self._swap(x[:, :1], x[:, -1:])
        shape = (-1,) + (1,) * (x.dim() - 1)
        north = torch.where(self._first(x.shape[0], x.device).reshape(shape), x[:, :1], north)
        south = torch.where(self._last(x.shape[0], x.device).reshape(shape), x[:, -1:], south)
        return torch.cat([north, x, south], dim=1)

    def cell_exchange(self, top: torch.Tensor, bottom: torch.Tensor):
        """The ghost rows before a colour step: each strip's first row (top)
        sent north and last row (bottom) sent south; returns (from north,
        from south), zeros at the frame's edges."""
        north, south = self._swap(top[:, None], bottom[:, None])
        return north[:, 0], south[:, 0]

    def rival_extend(self, g: torch.Tensor) -> torch.Tensor:
        """(n, npy, npx, 2) search winners with a ring of one: the
        neighbouring strips' rows (edge-replicated at the frame's edges),
        the edge columns replicated."""
        gr = self.exchange_rows_edge(g)
        return gr[:, :, _edge_index(g.shape[2], g.device)]


class LocalRows(_Rows):
    """In-process transport: entry b * tiles + i of a batch is strip i of
    frame b, all on one device."""

    def __init__(self, tiles: int):
        self.tiles = tiles

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, ...) frames -> (B * tiles, H / tiles, ...) strips (a view)."""
        return x.reshape(x.shape[0] * self.tiles, x.shape[1] // self.tiles, *x.shape[2:])

    def join(self, x: torch.Tensor) -> torch.Tensor:
        """(B * tiles, h, ...) strips -> (B, tiles * h, ...) frames."""
        return x.reshape(x.shape[0] // self.tiles, x.shape[1] * self.tiles, *x.shape[2:])

    def row0(self, n: int, ht: int, device) -> torch.Tensor:
        return ((torch.arange(n, device=device) % self.tiles) * ht).to(torch.int32)

    def _first(self, n, device):
        return torch.arange(n, device=device) % self.tiles == 0

    def _last(self, n, device):
        return torch.arange(n, device=device) % self.tiles == self.tiles - 1

    def _swap(self, top, bottom):
        t = self.tiles
        tv = top.reshape(-1, t, *top.shape[1:])
        bv = bottom.reshape(-1, t, *bottom.shape[1:])
        north = torch.zeros_like(bv)
        south = torch.zeros_like(tv)
        north[:, 1:] = bv[:, :-1]
        south[:, :-1] = tv[:, 1:]
        return north.reshape(bottom.shape), south.reshape(top.shape)


class DistRows(_Rows):
    """``torch.distributed`` transport: this process holds strip ``index``
    of each frame of its batch chunk; its neighbours along the mesh's row
    axis are the processes north and south of it."""

    def __init__(self, mesh: Mesh, axis: str):
        line = mesh.line(axis)
        self.tiles = len(line)
        self.index = mesh.coords()[axis]
        self.north = line[self.index - 1] if self.index > 0 else None
        self.south = line[self.index + 1] if self.index + 1 < self.tiles else None
        self.group = mesh.group(axis)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        ht = x.shape[1] // self.tiles
        return x[:, self.index * ht:(self.index + 1) * ht].contiguous()

    def join(self, x: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(x) for _ in range(self.tiles)]
        torch.distributed.all_gather(parts, _checked(x.contiguous()), group=self.group)
        return torch.cat(parts, dim=1)

    def row0(self, n: int, ht: int, device) -> torch.Tensor:
        return torch.full((n,), self.index * ht, dtype=torch.int32, device=device)

    def _first(self, n, device):
        return torch.full((n,), self.north is None, device=device)

    def _last(self, n, device):
        return torch.full((n,), self.south is None, device=device)

    def _swap(self, top, bottom):
        dist = torch.distributed
        top, bottom = _checked(top.contiguous()), bottom.contiguous()
        north = torch.zeros_like(bottom)
        south = torch.zeros_like(top)
        ops = []
        if self.north is not None:
            ops += [dist.P2POp(dist.isend, top, self.north),
                    dist.P2POp(dist.irecv, north, self.north)]
        if self.south is not None:
            ops += [dist.P2POp(dist.isend, bottom, self.south),
                    dist.P2POp(dist.irecv, south, self.south)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return north, south


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
                 cfg: MotionConfig, level: int, full_h: int, halo: int,
                 rows: _Rows) -> torch.Tensor:
    """One level on a batch of strips (im1, im2 (n, ht, w) u8, pred (n,
    ht / bs, w / bs, 2)): the frame-2 halo exchanged once, then the
    level's search and schedule as ``engine._run_level`` dispatches them,
    in the frame's coordinates.  Returns the strips' (n, ht, w, 2) int32
    grid.  ``cv_compact`` is not taken (the reference's tiled levels pass
    none)."""
    n, ht = im1.shape[:2]
    row0 = rows.row0(n, ht, im1.device)
    kw = dict(full_h=full_h, row0=row0, im2_row0=row0 - halo)
    im2_buf = rows.exchange_rows(im2, halo)
    lam0 = float(bs) * cfg.lambda_scale
    rr = cfg.rival_radius_at(level)
    if cfg.uses_fused_windowed:
        return windowed_level(
            im1, im2_buf, pred, bs, ss, lam0, cfg.sweeps_per_round, cost=cfg.cost,
            rival=cfg.rival_window, rival_radius=rr, store_radius=cfg.cv_store_radius,
            fuse=cfg.cv_fused if engine._accelerated(cfg) else None,
            rival_extend=rows.rival_extend, cell_exchange=rows.cell_exchange, **kw,
        )
    grid = block_search_level(im1, im2_buf, pred, bs, ss, order=cfg.search_order,
                              cost=cfg.cost, **kw)
    if cfg.regularizer == "windowed":
        return windowed_schedule(
            im1, im2_buf, grid, bs, ss, lam0, cfg.sweeps_per_round, cost=cfg.cost,
            reg_radius=cfg.reg_radius, rival=cfg.rival_window, rival_radius=rr,
            rival_extend=rows.rival_extend, cell_exchange=rows.cell_exchange, **kw,
        )
    return run_schedule(im1, im2_buf, grid, bs, lam0, cfg.sweeps_per_round, cfg.regularizer,
                        cost=cfg.cost, cell_exchange=rows.cell_exchange, **kw)


def _levels(im1s: torch.Tensor, im2s: torch.Tensor, cfg: MotionConfig, t: int,
            rows: _Rows) -> torch.Tensor:
    """The coarse-to-fine engine on pre-padded (B, H, W) frames, each level
    that shards (``plan_tiling``'s rows_ok) on ``t`` row strips through
    ``rows``, the others whole-frame; (B, H, W, 2) f32."""
    levels = cfg.num_levels
    pyr1 = resample.build_pyramid(im1s, levels)
    pyr2 = resample.build_pyramid(im2s, levels)
    dense = None
    for level in range(levels - 1, -1, -1):
        im1, im2 = pyr1[level], pyr2[level]
        b, h, w = im1.shape
        bs, ss = cfg.block_sizes[level], cfg.search_sizes[level]
        if dense is None:
            pred = torch.zeros((b, h // bs, w // bs, 2), dtype=torch.float32, device=im1.device)
        else:
            pred = engine.transfer_mvs(dense, cfg.block_sizes[level + 1], bs)
            if cfg.mv_cap is not None:  # the untiled engine's clamp
                pred = pred.clamp(-float(cfg.mv_cap), float(cfg.mv_cap))
        halo = im2_halo(cfg, level)
        if _level_shardable(h, w, bs, t) and halo < h // t:
            grid = _tiled_level(rows.split(im1), rows.split(im2), rows.split(pred), bs, ss, cfg,
                                level, h, halo, rows)
            dense = rows.join(grid).to(torch.float32)
        else:
            # a level too small to tile runs whole-frame (coarse levels are tiny)
            dense = engine._run_level(im1, im2, pred, bs, ss, cfg, level).to(torch.float32)
    return dense


def _gather_batch(x: torch.Tensor, mesh: Mesh, batch_axis: str | None) -> torch.Tensor:
    """The (B, ...) result of every batch chunk, from the first process of
    each chunk, on every process."""
    dist = torch.distributed
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, _checked(x.contiguous()))
    if batch_axis is None:
        return x
    k = mesh.axis_names.index(batch_axis)
    firsts = np.moveaxis(mesh.ranks, k, 0).reshape(mesh.ranks.shape[k], -1)[:, 0]
    return torch.cat([parts[r] for r in firsts.tolist()], dim=0)


def _run(im1s, im2s, cfg: MotionConfig, mesh: Mesh, axis: str, axis_x, batch_axis,
         device, entry: str) -> torch.Tensor:
    """The tiled engine on pre-padded (B, H, W) pairs: the batch split over
    ``batch_axis`` (None: every process takes the whole batch), rows over
    ``axis``; (B, H, W, 2) f32 on every process."""
    if axis_x is not None:
        raise NotImplementedError(_NO_2D)
    if cfg.regularizer == "exact":
        raise ValueError(_NO_EXACT.format(entry))
    a = engine._as_frames(im1s, device, 3)
    b = engine._as_frames(im2s, a.device, 3)
    engine.check_config(cfg, a.device)
    t = mesh.shape[axis]
    if not mesh.distributed:
        if batch_axis is not None and a.shape[0] % mesh.shape[batch_axis]:
            raise ValueError(f"batch {a.shape[0]} does not split over {mesh.shape}")
        return _levels(a, b, cfg, t, LocalRows(t))
    rows = DistRows(mesh, axis)
    if batch_axis is not None:
        nb = mesh.shape[batch_axis]
        if a.shape[0] % nb:
            raise ValueError(f"batch {a.shape[0]} does not split over {mesh.shape}")
        chunk = a.shape[0] // nb
        bi = mesh.coords()[batch_axis]
        a, b = a[bi * chunk:(bi + 1) * chunk], b[bi * chunk:(bi + 1) * chunk]
    dense = _levels(a.contiguous(), b.contiguous(), cfg, t, rows)
    return _gather_batch(dense, mesh, batch_axis)


def estimate_flow_padded_tiled(im1p, im2p, cfg: MotionConfig, mesh: Mesh, axis: str = "ty",
                               axis_x: str | None = None, device=None) -> torch.Tensor:
    """Row-tiled, halo-exchanged engine on one pre-padded (H', W') pair:
    the dense (H', W', 2) f32 flow, equal to ``engine.estimate_flow_padded``
    bit for bit in fourcolor, jacobi and windowed modes.  Rows shard over
    ``axis``; ``exact`` does not decompose and raises; ``axis_x`` (2-D
    tiling) raises NotImplementedError.  Numpy frames run on the card
    unless ``device`` says otherwise."""
    a = engine._as_frames(im1p, device, 2)
    b = engine._as_frames(im2p, a.device, 2)
    if axis_x is None and cfg.regularizer != "exact":
        _warn_if_fully_replicated(cfg, a.shape[0], a.shape[1], mesh.shape[axis], 1)
    return _run(a[None], b[None], cfg, mesh, axis, axis_x, None, None,
                "estimate_flow_padded")[0]


def estimate_flow_padded_batch_tiled(im1s, im2s, cfg: MotionConfig, mesh: Mesh,
                                     batch_axis: str = "batch", axis: str = "ty",
                                     axis_x: str | None = None, device=None) -> torch.Tensor:
    """Frame pairs over ``batch_axis`` and rows over ``axis`` (the layout
    ``multihost.make_mesh`` builds): (B, H', W') pre-padded u8 pairs, B
    divisible by the batch axis -> (B, H', W', 2) f32 on every process."""
    return _run(im1s, im2s, cfg, mesh, axis, axis_x, batch_axis, device,
                "engine.estimate_flow_batched")


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


def estimate_flow_tiled_auto(im1, im2, cfg: MotionConfig, mesh: Mesh, axis: str = "ty",
                             axis_x: str | None = None, device=None) -> torch.Tensor:
    """Row tiling on an unpadded (H, W) pair: pads with ``row_tiles`` =
    the mesh's row axis, applies ``derive_mv_cap`` when ``cfg.mv_cap`` is
    unset and the uncapped halo cannot fit a strip (an explicit cap is
    kept), raises when no cap can make the finest level shard.  Returns the
    (H, W, 2) flow cropped to the frame (MVs in processed pixels)."""
    if axis_x is not None:
        raise NotImplementedError(_NO_2D)
    a = engine._as_frames(im1, device, 2)
    b = engine._as_frames(im2, a.device, 2)
    h, w = a.shape
    t = mesh.shape[axis]
    run_cfg = cfg
    if cfg.mv_cap is None:
        cap = derive_mv_cap(cfg, h, w, t)
        if cap is not None:
            run_cfg = cfg.replace(mv_cap=cap)
    p = pad_ops.compute_padding(h, w, run_cfg, row_tiles=t)
    flow = estimate_flow_padded_tiled(pad_ops.pad_frame(a, p), pad_ops.pad_frame(b, p), run_cfg,
                                      mesh, axis)
    return flow[p.pad_y:p.pad_y + h, p.pad_x:p.pad_x + w]
