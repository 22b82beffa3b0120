"""The pyramid levels of a configuration at a frame size, from the
configuration's fields alone: the shapes each stage works on, on the
frames as the driver upscales them by ``interp_factor``.

Each level (finest first) gives its padded size, block and window
geometry, and the form its level takes: ``fused`` (windows around the
prediction, one set of volumes for search and rounds) or the search
first and windows around its winners; ``hybrid`` (the fused level with
rival windows and bs % 8 == 0: the rival window stores only cur > fuse_max
and cur = bs, the cur = 2 main volume only the band |dx| <= store_r).
"""

from __future__ import annotations

from benchmark.reference.flow import padded_dims, spiral_offsets


def levels(fields: dict, height: int, width: int) -> list[dict]:
    bss, sss = fields["block_sizes"], fields["search_sizes"]
    f = int(fields["interp_factor"])
    ph, pw = padded_dims(height * f, width * f, bss)
    fused = (fields["window_center"] == "pred" and fields["reg_radius"] is None
             and fields["regularizer"] == "windowed")
    if fields["cv_fused"] is not None or fields["cv_compact"] is not None:
        raise NotImplementedError("the capacity modes have no work model here")
    out = []
    for level, (bs, ss) in enumerate(zip(bss, sss)):
        h, w = ph >> level, pw >> level
        ext = spiral_offsets(ss - bs)[2]
        r = ext if fused or fields["reg_radius"] is None else min(fields["reg_radius"], ext)
        rr = fields["rival_radius"]
        if isinstance(rr, (list, tuple)):
            rr = rr[min(level, len(rr) - 1)]
        rival = bool(fields["rival_window"])
        hybrid = fused and rival and bs % 8 == 0
        store_r = fields["cv_store_radius"]
        out.append(dict(
            bs=bs, h=h, w=w, npy=h // bs, npx=w // bs, ext=ext, r=r,
            r2=(r if rr is None else min(rr, r)) if rival else None, rival=rival,
            fused=fused, hybrid=hybrid,
            store_r=store_r if hybrid and store_r is not None and 0 <= store_r < ext else None,
            fuse_max=min(16, bs // 2),
        ))
    return out
