"""Configuration of the port: ``MotionConfig`` and its two factories.

The same fields, defaults and checks as the reference package's
``blockbasedmotionestimation_tpu/config.py``, kept here so that the port
imports nothing of that package.  ``from_fields`` builds one from another
config's fields (a plain dict), for tests that run both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

CostKind = Literal["sad", "ssd", "zsad"]
RegularizerMode = Literal["exact", "fourcolor", "jacobi", "windowed"]
SearchImpl = Literal["auto", "xla", "pallas", "pallas_interpret"]
SearchOrder = Literal["spiral", "raster"]


@dataclasses.dataclass(frozen=True)
class MotionConfig:
    """Full configuration of the coarse-to-fine block-matching pipeline.

    Defaults replicate the reference program's shipped Middlebury
    configuration: 4 pyramid levels, 32x32 blocks, 64 px search windows, 4x
    pre-interpolation for quarter-pel output.  The port runs every
    regularizer, window centre, search order and cost (``zsad`` on the
    plain versions, as the reference runs it in XLA only;
    ``models.engine.check_config`` names what raises).

    Attributes:
      block_sizes: per-level block edge (level 0 = finest). Powers of two >= 2.
      search_sizes: per-level search window edge; ``shift = search - block``
        defines the spiral extent.
      interp_factor: integer pre-upsampling factor applied to both frames
        before estimation; output MVs are divided back down.
      cost: matching cost, ``sad`` (the reference's L1 norm), ``ssd`` or
        ``zsad`` (zero-mean SAD).
      regularizer: sweep scheduling of the 8-connected smoothness pass
        (``exact``, ``fourcolor``, ``jacobi`` or ``windowed``).
      sweeps_per_round: regularization sweeps per block-subdivision round,
        with lambda multiplier sweep_index + 1.
      lambda_scale: initial lambda = block_size * lambda_scale, doubled on
        each subdivision.
      search_impl: the reference's cost-volume backend.  ``xla`` runs the
        reference's XLA path, which ignores ``cv_fused`` and ``cv_compact``;
        the others run its accelerator path.  The tensors' device decides
        between the CUDA kernels and their plain versions.
      reg_radius: max |candidate delta| from the parent search MV in
        ``windowed`` mode; None means the level's spiral extent S.
      search_order: ``spiral`` (the reference's live path) or ``raster``.
      cv_compact / cv_compact_ring: K-slot compact cost-volume tables.
      mv_cap: optional per-component cap on the MV predictions transferred
        between pyramid levels.
      cv_fused: chunk-fused fine rounds (costs recomputed from the windows
        for cur <= cv_fused).
      rival_window: gather a second frame-2 window per parent, centred on its
        most-covering neighbour search MV, and evaluate candidates outside
        the main window against it.
      rival_radius: max |candidate delta| from the rival centre (None: the
        level's radius), or a per-level tuple (level 0 = finest) whose last
        entry repeats for deeper levels.
      cv_store_radius: with rival windows and bs % 8 == 0, the cur=2 main
        volume is stored only for |dx delta| <= cv_store_radius (all dy
        rows); in-window candidates beyond it are recomputed from the main
        window's pixels.  Bit-exact; None = dense.
      window_center: ``pred`` centres the windows on the truncated
        prediction (one cost volume per level); ``search`` on the search
        winner.
    """

    block_sizes: tuple[int, ...] = (32, 32, 32, 32)
    search_sizes: tuple[int, ...] = (64, 64, 64, 64)
    interp_factor: int = 4
    cost: CostKind = "sad"
    # the production default: windowed scheduling with rival windows
    # (rival radius (12, None, 8, 8)) plus the bit-exact stored cur=2 band
    # (cv_store_radius default 4).  The reference-faithful schedules remain
    # one flag away (regularizer="exact"/"fourcolor").
    regularizer: RegularizerMode = "windowed"
    sweeps_per_round: int = 2
    lambda_scale: float = 0.5
    search_impl: SearchImpl = "auto"
    search_order: SearchOrder = "spiral"
    reg_radius: int | None = None
    window_center: Literal["pred", "search"] = "pred"
    rival_window: bool = True
    rival_radius: int | tuple[int | None, ...] | None = (12, None, 8, 8)
    mv_cap: int | None = None
    cv_store_radius: int | None = 4
    cv_compact: int | None = None
    cv_compact_ring: int = 3
    cv_fused: int | None = None

    def __post_init__(self) -> None:
        if len(self.block_sizes) != len(self.search_sizes):
            raise ValueError(
                "block_sizes and search_sizes must have the same length, got "
                f"{len(self.block_sizes)} vs {len(self.search_sizes)}"
            )
        if not self.block_sizes:
            raise ValueError("need at least one pyramid level")
        for bs, ss in zip(self.block_sizes, self.search_sizes):
            if bs < 2 or bs & (bs - 1):
                raise ValueError(f"block size must be a power of two >= 2, got {bs}")
            if ss < bs:
                raise ValueError(f"search size {ss} must be >= block size {bs}")
        if self.interp_factor < 1:
            raise ValueError("interp_factor must be >= 1")
        if isinstance(self.rival_radius, tuple):
            if not self.rival_radius:
                raise ValueError("per-level rival_radius tuple cannot be empty")
            for r in self.rival_radius:
                if r is not None and r < 0:
                    raise ValueError("rival_radius entries must be >= 0 or None")
        elif self.rival_radius is not None and self.rival_radius < 0:
            raise ValueError("rival_radius must be >= 0")
        if self.cv_store_radius is not None and self.cv_store_radius < 0:
            raise ValueError("cv_store_radius must be >= 0")
        if self.cv_fused is not None:
            if self.cv_fused < 2:
                raise ValueError("cv_fused must be >= 2 (sub-block size)")
            if self.cv_compact is not None:
                raise ValueError(
                    "cv_fused and cv_compact are mutually exclusive cost-"
                    "volume strategies"
                )
        if self.mv_cap is not None and self.mv_cap < max(
            ss - bs for bs, ss in zip(self.block_sizes, self.search_sizes)
        ):
            raise ValueError(
                "mv_cap below the largest search shift would forbid MVs the "
                f"coarsest search itself produces, got {self.mv_cap}"
            )

    @classmethod
    def from_fields(cls, fields: dict) -> "MotionConfig":
        """A config from another config's fields, e.g. ``vars(other)``."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(fields) - names)
        if unknown:
            raise ValueError(f"unknown MotionConfig fields: {unknown}")
        return cls(**fields)

    @property
    def num_levels(self) -> int:
        return len(self.block_sizes)

    @property
    def uses_fused_windowed(self) -> bool:
        """True when levels run the fused one-cost-volume windowed path."""
        return (
            self.regularizer == "windowed"
            and self.window_center == "pred"
            and self.search_order == "spiral"
            and self.reg_radius is None
        )

    def shift(self, level: int) -> int:
        """Search extent: reference ``shift = search_size - block_size``."""
        return self.search_sizes[level] - self.block_sizes[level]

    def rival_radius_at(self, level: int) -> int | None:
        """Rival radius for one pyramid level (level 0 = finest): the scalar
        setting everywhere, or the level's entry of a per-level tuple."""
        if isinstance(self.rival_radius, tuple):
            return self.rival_radius[min(level, len(self.rival_radius) - 1)]
        return self.rival_radius

    def replace(self, **kw) -> "MotionConfig":
        return dataclasses.replace(self, **kw)


def middlebury_config(**overrides) -> MotionConfig:
    """The reference program's shipped configuration."""
    return MotionConfig(**overrides)


def tiny_config(
    block_sizes: Sequence[int] = (8, 8),
    search_sizes: Sequence[int] = (16, 16),
    **overrides,
) -> MotionConfig:
    """Small config for unit tests and CPU smoke runs."""
    overrides.setdefault("interp_factor", 1)
    return MotionConfig(
        block_sizes=tuple(block_sizes),
        search_sizes=tuple(search_sizes),
        **overrides,
    )
