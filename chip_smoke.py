"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: card name and power limit, torch / CUDA / nvcc versions;
  2. build: the CUDA kernels compiled from ``csrc/`` with nvcc;
  3. each kernel against its plain PyTorch version on the same CUDA inputs,
     at the shapes of the 1080p main path, exact equality, with times;
  4. the main path: ``estimate_flow_batched`` with ``MotionConfig(
     interp_factor=1)`` on 8 seeded-noise 1080p pairs, counting kernel
     launches and checking the known translation; fields/s;
  5. CUDA equals the CPU (plain) path bit for bit on a two-motion pair at
     the default configuration;
  6. ``estimate_flow_driver`` with ``interp_factor=4`` at 388x584.
The line before the last is a JSON object of per-kernel results; the last
is ``{"ok": true, "device": {...}}``.  Without a CUDA device the script
exits non-zero before printing either.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np

H, W, B = 1080, 1920, 8
SHIFT_Y, SHIFT_X = 5, 9  # frame 2 = frame 1 moved by (-5, -9): flow (u, v) = (-9, -5)


def _cmd_line(cmd: list[str], pick=None) -> str:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if pick is not None:
        lines = [ln for ln in lines if pick in ln] or lines
    return lines[0]


def _texture(h: int, w: int, rng: np.random.Generator) -> np.ndarray:
    """Smooth multi-octave value noise, uint8 (matchable at every level)."""
    img = np.zeros((h, w))
    for o, amp in enumerate((1.0, 0.6, 0.36, 0.22)):
        step = 1 << (4 - o)
        g = rng.standard_normal((h // step + 2, w // step + 2))
        ys, xs = np.arange(h) / step, np.arange(w) / step
        y0, x0 = ys.astype(int), xs.astype(int)
        fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
        img += amp * (
            g[np.ix_(y0, x0)] * (1 - fy) * (1 - fx) + g[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
            + g[np.ix_(y0, x0 + 1)] * (1 - fy) * fx + g[np.ix_(y0 + 1, x0 + 1)] * fy * fx
        )
    img -= img.min()
    return (img * (255.0 / img.max())).astype(np.uint8)


def _cuda_ms(torch, fn, reps: int) -> float:
    """Mean time of fn on the card, CUDA events around `reps` calls, warmed up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(torch, a, b) -> int:
    """Largest |a - b| of two integer tensors of one dtype and shape (costs
    and MVs fit int32; computed in place to bound memory)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        raise AssertionError(f"kernel {a.dtype} {tuple(a.shape)} vs plain {b.dtype} {tuple(b.shape)}")
    d = a.to(torch.int32)
    d.sub_(b.to(torch.int32)).abs_()
    return int(d.max())


@contextlib.contextmanager
def _plain_kernels():
    """Route the main path through the kernels' plain versions (also on CUDA)."""
    from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, gather, reg_step
    from blockbasedmotionestimation_tpu_torch.ops import search, windowed

    saved = (search._gather, windowed.pooled_cvs, windowed.color_step)
    search._gather = gather.gather_windows_plain
    windowed.pooled_cvs = cv_diff.pooled_cvs_plain
    windowed.color_step = reg_step.color_step_plain
    try:
        yield
    finally:
        search._gather, windowed.pooled_cvs, windowed.color_step = saved


def _two_motion(h: int, w: int, b: int, rng: np.random.Generator):
    """b seeded-noise pairs, each with two translations split by a vertical
    line: (im1, im2) (b, h, w) uint8 and the known (b, h, w, 2) flow (u, v).
    The motions differ by more than the level-0 window radius, so a parent
    window at the split sees only one of them."""
    im1 = np.empty((b, h, w), np.uint8)
    im2 = np.empty((b, h, w), np.uint8)
    flow = np.empty((b, h, w, 2), np.float32)
    for bi in range(b):
        tex = rng.integers(0, 256, size=(h + 64, w + 64), dtype=np.uint8)
        split = w // 3 + 97 * bi
        (ul, vl), (ur, vr) = (7, -3 + bi % 3), (-12 - bi % 4, 5)
        im2[bi] = tex[32:32 + h, 32:32 + w]
        left = tex[32 + vl:32 + vl + h, 32 + ul:32 + ul + w]
        right = tex[32 + vr:32 + vr + h, 32 + ur:32 + ur + w]
        im1[bi] = np.where(np.arange(w)[None, :] < split, left, right)
        flow[bi] = np.where((np.arange(w) < split)[None, :, None], (ul, vl), (ur, vr))
    return im1, im2, flow


def _same_as_plain(torch, engine, cfg, im1, im2, flow, tag: str) -> None:
    """Every frame of a kernel-path batch equals the plain path on the card."""
    for bi in range(im1.shape[0]):
        with _plain_kernels():
            plain, _ = engine.estimate_flow_batched(im1[bi:bi + 1], im2[bi:bi + 1], cfg)
        if not torch.equal(plain[0], flow[bi]):
            diff = int((plain[0] != flow[bi]).any(-1).sum())
            raise AssertionError(f"[{tag}] frame {bi}: plain path differs at {diff} pixels")
    print(f"[{tag}] all {im1.shape[0]} frames through the plain versions on the card == kernel path")


def _kernels_vs_plain(torch, dev, cfg, card: str, rng: np.random.Generator) -> dict:
    """Phase 3: each kernel against its plain version at the 1080p level-0
    shapes of the main path; returns the per-kernel results (launches 0).

    Every kernel runs at B=8 as the main path launches it; the plain versions
    run frame by frame on the same inputs (bounded memory) and each frame's
    slice is compared, so offsets past 2^31 entries are checked too."""
    from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, gather, reg_step
    from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops
    from blockbasedmotionestimation_tpu_torch.ops import windowed

    p = pad_ops.compute_padding(H, W, cfg)
    hp, wp, bs = p.padded_h, p.padded_w, cfg.block_sizes[0]
    npy, npx = hp // bs, wp // bs
    ext = (cfg.search_sizes[0] - bs) // 2
    r2 = cfg.rival_radius_at(0)
    frames = torch.as_tensor(rng.integers(0, 256, size=(B, hp, wp), dtype=np.uint8), device=dev)
    results = {}

    def record(name, source, replaces, err, ms, plain_ms, also=None):
        """Keep the first (main-window) shape's times and the worst error."""
        print(f"[kernel] {name}: max_abs_err {err}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({card})")
        if name in results:
            results[name]["max_abs_err"] = max(err, results[name]["max_abs_err"])
            return
        results[name] = {
            "name": name, "route": "cuda",
            "source": f"blockbasedmotionestimation_tpu_torch/csrc/{source}",
            "replaces": f"blockbasedmotionestimation_tpu/kernels/{replaces}",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        }
        if also:
            results[name]["also_replaces"] = f"blockbasedmotionestimation_tpu/kernels/{also}"

    offs = {}
    for tag, e in (("main", ext), ("rival", r2)):
        by = torch.as_tensor(rng.integers(0, hp - bs + 1, size=(B, npy * npx)), dtype=torch.int32, device=dev)
        bx = torch.as_tensor(rng.integers(0, wp - bs + 1, size=(B, npy * npx)), dtype=torch.int32, device=dev)
        k = gather.gather_windows(frames, by, bx, bs, e)
        err = _max_abs_err(torch, k, gather.gather_windows_plain(frames, by, bx, bs, e))
        ms = _cuda_ms(torch, lambda: gather.gather_windows(frames, by, bx, bs, e), 20)
        pms = _cuda_ms(torch, lambda: gather.gather_windows_plain(frames, by, bx, bs, e), 5)
        print(f"[kernel] gather_windows {tag}: win {bs + 2 * e}, B={B}")
        record("gather_windows", "gather.cu", "gather.py:58", err, ms, pms)
        offs[tag] = (k, by, bx)

    def plain_per_frame(fn):
        for bi in range(B):
            fn(bi)

    vols = {}
    for tag, e in (("main", ext), ("rival", r2)):
        wins = offs[tag][0]
        k = cv_diff.pooled_cvs(frames, wins, bs, e, cfg.cost)
        err = 0
        for bi in range(B):
            ref = cv_diff.pooled_cvs_plain(frames[bi:bi + 1], wins[bi:bi + 1], bs, e, cfg.cost)
            err = max([err] + [_max_abs_err(torch, k[c][bi:bi + 1], ref[c]) for c in k])
            del ref
        ms = _cuda_ms(torch, lambda: cv_diff.pooled_cvs(frames, wins, bs, e, cfg.cost), 3)
        pms = _cuda_ms(torch, lambda: plain_per_frame(
            lambda bi: cv_diff.pooled_cvs_plain(frames[bi:bi + 1], wins[bi:bi + 1], bs, e, cfg.cost)), 1)
        print(f"[kernel] pooled_cvs {tag}: r={e}, B={B} (plain: {B} frames one by one), "
              f"curs {sorted(k)}, cur=2 volume {k[2].numel()} entries")
        record("pooled_cvs", "cv_diff.cu", "cv_diff.py:672", err, ms, pms)
        vols[tag] = k

    origin = torch.stack(
        torch.meshgrid(torch.arange(npx, device=dev) * bs, torch.arange(npy, device=dev) * bs,
                       indexing="xy"), -1)[None].to(torch.int32)
    base = (torch.stack([offs["main"][2], offs["main"][1]], -1).reshape(B, npy, npx, 2)
            - origin).contiguous()
    rbase = (base + torch.as_tensor(rng.integers(-16, 17, size=base.shape), dtype=torch.int32,
                                    device=dev)).contiguous()
    del offs
    for cur in (2, bs):
        f = bs // cur
        pmf = base.repeat_interleave(f, 1).repeat_interleave(f, 2)
        g0 = (pmf + torch.as_tensor(rng.integers(-20, 21, size=pmf.shape), dtype=torch.int32,
                                    device=dev)).contiguous()
        cv, rcv = vols["main"][cur], vols["rival"][cur]
        kw = dict(cur=cur, h=hp, w=wp, r=ext, lam_mult=16.0 * bs / cur, r2=r2)
        gk = g0.clone()
        for ci, cj in windowed.COLORS:
            reg_step.color_step(gk, cv, base, ci=ci, cj=cj, rcv=rcv, rpm=rbase, **kw)
        err = 0
        for bi in range(B):
            gp = g0[bi:bi + 1].clone()
            for ci, cj in windowed.COLORS:
                reg_step.color_step_plain(gp, cv[bi:bi + 1], base[bi:bi + 1], ci=ci, cj=cj,
                                          rcv=rcv[bi:bi + 1], rpm=rbase[bi:bi + 1], **kw)
            err = max(err, _max_abs_err(torch, gk[bi:bi + 1], gp))
        if torch.equal(gk, g0):
            raise AssertionError(f"color_step at cur={cur} changed no cell")
        ms = _cuda_ms(torch, lambda: reg_step.color_step(
            g0.clone(), cv, base, ci=1, cj=0, rcv=rcv, rpm=rbase, **kw), 20)
        pms = _cuda_ms(torch, lambda: plain_per_frame(lambda bi: reg_step.color_step_plain(
            g0[bi:bi + 1].clone(), cv[bi:bi + 1], base[bi:bi + 1], ci=1, cj=0,
            rcv=rcv[bi:bi + 1], rpm=rbase[bi:bi + 1], **kw)), 1)
        print(f"[kernel] color_step at cur={cur} (f={f}): four colours compared, one timed; "
              f"B={B}, grid {tuple(g0.shape[1:3])}")
        record("color_step", "reg_step.cu", "reg_step.py:680", err, ms, pms, also="reg_step.py:773")
    bad = [r["name"] for r in results.values() if r["max_abs_err"] != 0]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return results


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from blockbasedmotionestimation_tpu_torch import MotionConfig
    from blockbasedmotionestimation_tpu_torch.kernels import _build, cv_diff, gather, reg_step
    from blockbasedmotionestimation_tpu_torch.models import engine

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = _cmd_line(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])

    # 1. environment
    print(f"[env] card: {card}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"triton {'present' if importlib.util.find_spec('triton') else 'absent'}")
    print(f"[env] nvcc: {_cmd_line([_build._nvcc(), '--version'], pick='release')}")

    # 2. build
    t0 = time.time()
    lib_path = _build.build()
    _build.library()
    print(f"[build] {time.time() - t0:.1f} s -> {lib_path}")
    for ln in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in ln or "Compiling entry" in ln:
            print(f"[build] {ln.strip()}")

    # 3. kernels against their plain versions at the 1080p level-0 shapes
    cfg = MotionConfig(interp_factor=1)
    rng = np.random.default_rng(0)
    results = _kernels_vs_plain(torch, dev, cfg, card, rng)
    torch.cuda.empty_cache()

    # 4. the main path: default config, 8 pairs at 1080p, made as bench.py
    #    makes them (seeded noise; frame 2 = frame 1 moved by (-5, -9))
    noise = np.random.default_rng(0).integers(0, 256, size=(B, H + 16, W + 16), dtype=np.uint8)
    im1 = torch.as_tensor(noise[:, :H, :W].copy(), device=dev)
    im2 = torch.as_tensor(noise[:, SHIFT_Y:SHIFT_Y + H, SHIFT_X:SHIFT_X + W].copy(), device=dev)
    torch.cuda.reset_peak_memory_stats()
    counters = {"gather_windows": gather.gather_windows, "pooled_cvs": cv_diff.pooled_cvs,
                "color_step": reg_step.color_step}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    flow, pad = engine.estimate_flow_batched(im1, im2, cfg)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    for name, fn in counters.items():
        results[name]["launches"] = fn.launches
    print(f"[main] launches: { {n: fn.launches for n, fn in counters.items()} }")
    if any(fn.launches == 0 for fn in counters.values()):
        raise AssertionError("a kernel of the main path was never launched")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if tuple(flow.shape) != (B, pad.padded_h, pad.padded_w, 2) or not torch.isfinite(flow).all():
        raise AssertionError(f"bad main-path output {tuple(flow.shape)}")
    m = 64
    inner = flow[:, pad.pad_y + m : pad.pad_y + H - m, pad.pad_x + m : pad.pad_x + W - m]
    want = torch.tensor([-SHIFT_X, -SHIFT_Y], dtype=torch.float32, device=dev)
    wrong = ~(inner == want).all(-1)
    print(f"[main] interior pixels off the known flow {(-SHIFT_X, -SHIFT_Y)}: "
          f"{int(wrong.sum())} of {wrong.numel()}, per frame {wrong.sum(dim=(1, 2)).tolist()}")
    for bi, y, x in wrong.nonzero()[:8].tolist():
        print(f"[main]   frame {bi} at ({y + m}, {x + m}): {inner[bi, y, x].tolist()}")
    batch_s = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.time()
        engine.estimate_flow_batched(im1, im2, cfg)
        torch.cuda.synchronize()
        batch_s.append(time.time() - t0)
    med = float(np.median(batch_s))
    print(f"[main] first call {first_s:.3f} s; 10 batches of {B}: min {min(batch_s):.4f}, "
          f"median {med:.4f}, max {max(batch_s):.4f} s; {B / med:.3f} fields/s at the median; "
          f"peak {peak_gb:.2f} GB ({card})")
    _same_as_plain(torch, engine, cfg, im1, im2, flow, "main")
    if float(wrong.float().mean()) > 1e-3:
        raise AssertionError("main path did not recover the known translation")
    del im1, im2, flow, inner, wrong
    torch.cuda.empty_cache()

    # 4b. two motions per frame at 1080p, B=8: the rival windows decide cells
    #     (the rival-off run differs), and every frame equals the plain path
    tm1, tm2, tflow = _two_motion(H, W, B, np.random.default_rng(1))
    tm1, tm2 = torch.as_tensor(tm1, device=dev), torch.as_tensor(tm2, device=dev)
    flow, pad = engine.estimate_flow_batched(tm1, tm2, cfg)
    no_rival, _ = engine.estimate_flow_batched(tm1, tm2, cfg.replace(rival_window=False))
    crop = (slice(None), slice(pad.pad_y, pad.pad_y + H), slice(pad.pad_x, pad.pad_x + W))
    decided = int((flow[crop] != no_rival[crop]).any(-1).sum())
    inner = (slice(None), slice(m, H - m), slice(m, W - m))
    at_known = (flow[crop][inner] == torch.as_tensor(tflow, device=dev)[inner]).all(-1)
    print(f"[two-motion] B={B} at {H}x{W}: pixels changed by the rival windows {decided}; "
          f"interior at the known flows {float(at_known.float().mean()):.6f}, per frame "
          f"{at_known.float().mean(dim=(1, 2)).tolist()}")
    _same_as_plain(torch, engine, cfg, tm1, tm2, flow, "two-motion")
    if decided == 0:
        raise AssertionError("the rival windows decided no pixel of the two-motion batch")
    if float(at_known.float().mean()) < 0.97:
        raise AssertionError("two-motion batch: fewer than 97% of interior pixels at the known flows")
    del tm1, tm2, flow, no_rival, at_known
    torch.cuda.empty_cache()

    # 5. CUDA == CPU (plain) end to end on a two-motion pair, default config
    h5, w5 = 256, 384
    tex = _texture(h5 + 64, w5 + 64, rng)
    a2 = tex[32:32 + h5, 32:32 + w5]
    left = tex[32 - 3:32 - 3 + h5, 32 + 7:32 + 7 + w5]    # flow (7, -3)
    right = tex[32 + 5:32 + 5 + h5, 32 - 12:32 - 12 + w5]  # flow (-12, 5)
    a1 = np.where(np.arange(w5)[None, :] < w5 // 2, left, right).astype(np.uint8)
    pair = (np.stack([a1, a2]), np.stack([a2, a1]))
    on_gpu, _ = engine.estimate_flow_batched(*pair, cfg, device=dev)
    on_cpu, _ = engine.estimate_flow_batched(*pair, cfg, device="cpu")
    if not torch.equal(on_gpu.cpu(), on_cpu):
        diff = int((on_gpu.cpu() != on_cpu).any(-1).sum())
        raise AssertionError(f"CUDA and CPU flows differ at {diff} pixels")
    print(f"[parity] CUDA == CPU on two {h5}x{w5} two-motion pairs (default config)")

    # 6. the reference driver at Middlebury geometry, interp_factor=4
    h6, w6 = 388, 584
    tex = _texture(h6 + 64, w6 + 64, rng)
    b2 = tex[32:32 + h6, 32:32 + w6]
    b1 = tex[32 - 2:32 - 2 + h6, 32 + 3:32 + 3 + w6]  # flow (3, -2)
    t0 = time.time()
    fl = engine.estimate_flow_driver(b1, b2, MotionConfig(), device=dev)
    torch.cuda.synchronize()
    core = fl[48:-48, 48:-48]
    ok6 = float((core == torch.tensor([3.0, -2.0], device=dev)).all(-1).float().mean())
    print(f"[driver] interp 4 at {h6}x{w6}: {time.time() - t0:.3f} s, shape {tuple(fl.shape)}, "
          f"interior at the known flow (3, -2): {ok6:.6f}")
    if tuple(fl.shape) != (h6, w6, 2) or not torch.isfinite(fl).all() or ok6 != 1.0:
        raise AssertionError("driver did not recover the known translation")

    print(card)
    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
