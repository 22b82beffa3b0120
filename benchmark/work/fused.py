"""Work of the fused capacity form (``cv_fused``): its volume calls (kernel
C on both windows) and its rounds (D on the stored sizes, kernel 12 or 11
on the rest), level by level.

The form's own level geometry, from the configuration's fields alone, on
the frames as the entry point upscales them: with fuse_eff = min(cv_fused,
bs / 2), the main window (radius S) and the rival window (radius r2)
store only cur > fuse_eff and cur = bs; rounds cur > fuse_eff run D on
them, rounds cur <= fuse_eff recompute every candidate's cost from the
windows' pixels.  Only levels with bs % 8 == 0 take the form; this model
refuses a configuration with another level, or not in the fused form.

Volume calls count as ``work/cv_diff.volume_call`` counts them.  A D
round counts as ``work/fused_step.round_call`` counts it.  A recomputing
round reads its grid once and writes it once, reads the window centres,
frame 1 and both windows once; its operations are, for each cell of each
step, 3 * cur^2 for each of the 9 candidates whose cost it recomputes and
the 243 smoothness operations.  Which candidates fall in which window, and
how often a block's pixels are read again, depend on the data: the count
is a floor of what the round needs.
"""

from __future__ import annotations

from benchmark.reference.flow import padded_dims, spiral_offsets
from benchmark.work.cv_diff import entry_bytes, volume_call
from benchmark.work.fused_step import round_call
from benchmark.work.peaks import bound_ms


def fused_levels(fields: dict, height: int, width: int) -> list[dict]:
    """Each level (finest first): its padded size, block size, window radii
    and the sizes both windows store."""
    if (fields["cv_fused"] is None or fields["cv_compact"] is not None
            or fields["window_center"] != "pred" or fields["reg_radius"] is not None
            or fields["regularizer"] != "windowed" or fields["cost"] not in ("sad", "ssd")):
        raise ValueError("not the fused form: cv_fused set, windows around the prediction, "
                         "the windowed regulariser, sad or ssd, no cv_compact")
    f = int(fields["interp_factor"])
    ph, pw = padded_dims(height * f, width * f, fields["block_sizes"])
    out = []
    for level, (bs, ss) in enumerate(zip(fields["block_sizes"], fields["search_sizes"])):
        if bs % 8:
            raise ValueError(f"level {level}: bs = {bs} does not take the fused form")
        r = spiral_offsets(ss - bs)[2]
        rr = fields["rival_radius"]
        if isinstance(rr, (list, tuple)):
            rr = rr[min(level, len(rr) - 1)]
        rival = bool(fields["rival_window"])
        fuse = min(int(fields["cv_fused"]), bs // 2)
        curs = [1 << k for k in range(1, bs.bit_length())]
        out.append(dict(bs=bs, h=ph >> level, w=pw >> level, r=r, rival=rival,
                        r2=(r if rr is None else min(rr, r)) if rival else None, fuse=fuse,
                        stored=[c for c in curs if c > fuse or c == bs]))
    return out


def volume_calls(fields: dict, height: int, width: int, batch: int) -> list[tuple[int, int]]:
    """(bytes, ops) of every volume call of one batch: both windows a level."""
    calls = []
    for lv in fused_levels(fields, height, width):
        for r in (lv["r"], lv["r2"]) if lv["rival"] else (lv["r"],):
            calls.append(volume_call(batch, lv["h"], lv["w"], lv["bs"], r, fields["cost"],
                                     lv["stored"]))
    return calls


def recompute_round(b: int, h: int, w: int, bs: int, cur: int, sweeps: int, r: int,
                    r2: int | None):
    """(bytes, ops) of one recomputing round (kernel 12, or 11 without
    rival windows, ``r2`` None) at sub-block size cur on B frames of h x w."""
    npy, npx, f = h // bs, w // bs, bs // cur
    # the D round's count without its cost entries: the grid, the centres
    # and 243 smoothness operations a cell a step
    grid_bytes, ops = round_call(b, npy * f, npx * f, npy, npx, sweeps, r2 is not None, 0)
    cells = ops // 243
    windows = b * npy * npx * ((bs + 2 * r) ** 2 + ((bs + 2 * r2) ** 2 if r2 is not None else 0))
    return grid_bytes + b * h * w + windows, cells * (9 * 3 * cur * cur + 243)


def round_calls(fields: dict, height: int, width: int, batch: int) -> list[tuple[int, int]]:
    """(bytes, ops) of every round of one batch, cur = bs .. 2 a level."""
    sweeps, calls = fields["sweeps_per_round"], []
    for lv in fused_levels(fields, height, width):
        bs, cur = lv["bs"], lv["bs"]
        while cur > 1:
            if cur > lv["fuse"]:
                f = bs // cur
                npy, npx = lv["h"] // bs, lv["w"] // bs
                calls.append(round_call(batch, npy * f, npx * f, npy, npx, sweeps, lv["rival"],
                                        entry_bytes(cur, fields["cost"])))
            else:
                calls.append(recompute_round(batch, lv["h"], lv["w"], bs, cur, sweeps, lv["r"],
                                             lv["r2"]))
            cur >>= 1
    return calls


def volume_bound_ms(fields: dict, height: int, width: int, batch: int) -> float:
    """Least device time of one batch's volume calls, each at its own bound."""
    return sum(bound_ms(*c) for c in volume_calls(fields, height, width, batch))


def round_bound_ms(fields: dict, height: int, width: int, batch: int) -> float:
    """Least device time of one batch's rounds, each at its own bound."""
    return sum(bound_ms(*c) for c in round_calls(fields, height, width, batch))
