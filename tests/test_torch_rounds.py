"""The round form of kernels E, F, 11 and 12 on the CPU.

``kernels.fused_step.color_round_*`` run a whole round (``sweeps`` sweeps
of the four colours) in one call: on the card one cooperative launch with a
grid barrier between colour steps (``tests/test_torch_cuda.py`` holds it to
the plain step loop there), on the CPU the plain steps in the same order.
Here: the round wrappers equal the per-step wrappers called colour by
colour, the f32 multipliers a launch receives are those the per-step loop
rounds, rounds longer than one launch split into spans, and
``ops.windowed.rounds_loop`` calls a round callable once per round.  The
levels built on them are held to JAX's interpret-mode kernels by
``tests/test_torch_hybrid.py`` and ``tests/test_torch_windowed.py``.
"""

import ctypes

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, fused_step
from blockbasedmotionestimation_tpu_torch.ops import windowed
from blockbasedmotionestimation_tpu_torch.ops.regularize import COLORS

BS, H, W, R, R2, STORE_R = 8, 32, 48, 5, 3, 2


def _inputs(rng, cur, cost):
    """Seeded numpy inputs at bs 8 on 4x6 parents, B=2: windows, the dense
    main volume at cur, its band (every dy row, |dx| <= STORE_R), window
    centres and candidates within +-9 of them (in band, in the tail, rival
    only, unevaluable and off the frame's edge)."""
    b, npy, npx = 2, H // BS, W // BS
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, H, W), dtype=np.uint8))
    win = torch.as_tensor(rng.integers(0, 256, size=(b, npy * npx, BS + 2 * R, BS + 2 * R),
                                       dtype=np.uint8))
    rwin = torch.as_tensor(rng.integers(0, 256, size=(b, npy * npx, BS + 2 * R2, BS + 2 * R2),
                                        dtype=np.uint8))
    dense = cv_diff.pooled_cvs(im1, win, BS, R, cost, emit=[cur])[cur]
    side, nby, nbx = 2 * R + 1, H // cur, W // cur
    band = dense.reshape(b, side, side, nby, nbx)[:, :, R - STORE_R:R + STORE_R + 1]
    band = band.reshape(b, side * (2 * STORE_R + 1), nby, nbx).contiguous()
    pm = torch.as_tensor(rng.integers(-3, 4, size=(b, npy, npx, 2)), dtype=torch.int32)
    rpm = pm + torch.as_tensor(rng.integers(-6, 7, size=pm.shape), dtype=torch.int32)
    f = BS // cur
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = g0 + torch.as_tensor(rng.integers(-9, 10, size=g0.shape), dtype=torch.int32)
    common = dict(im1=im1, cur=cur, h=H, w=W, r=R, cost=cost)
    return g0, {
        "E": (fused_step.color_round_hybrid, fused_step.color_step_hybrid, (dense, pm),
              dict(common, rwin=rwin, rpm=rpm, r2=R2)),
        "F": (fused_step.color_round_hybrid_tail, fused_step.color_step_hybrid_tail, (band, pm),
              dict(common, win=win, rwin=rwin, rpm=rpm, r2=R2, store_r=STORE_R)),
        "11": (fused_step.color_round_fused, fused_step.color_step_fused, (pm,),
               dict(common, win=win)),
        "12": (fused_step.color_round_fused_rival, fused_step.color_step_fused_rival, (pm,),
               dict(common, win=win, rwin=rwin, rpm=rpm, r2=R2)),
    }


@pytest.mark.parametrize("cost", ["sad", "ssd"])
@pytest.mark.parametrize("cur", [2, 4])
@pytest.mark.parametrize("form", ["E", "F", "11", "12"])
def test_round_wrappers_equal_the_step_loop(form, cur, cost):
    rng = np.random.default_rng(10 * cur + len(form) + (cost == "ssd"))
    g0, forms = _inputs(rng, cur, cost)
    round_fn, step_fn, args, kw = forms[form]
    assert round_fn.per_round and not getattr(step_fn, "per_round", False)
    lam = 3.0 * BS / cur
    launches = round_fn.launches
    for sweeps in (1, 2, 3):
        got, want = g0.clone(), g0.clone()
        round_fn(got, *args, lam=lam, sweeps=sweeps, **kw)
        for sweep in range(sweeps):
            for ci, cj in COLORS:
                step_fn(want, *args, ci=ci, cj=cj, lam_mult=lam * (sweep + 1), **kw)
        assert not torch.equal(want, g0)
        assert torch.equal(got, want), (form, cur, cost, sweeps)
    assert round_fn.launches == launches  # CPU tensors: the plain steps, no launch


def test_round_wrappers_validate_once_per_round(monkeypatch):
    rng = np.random.default_rng(5)
    g0, forms = _inputs(rng, 4, "sad")
    calls = []
    checked = fused_step._checked

    def counting(*a, **k):
        calls.append(1)
        return checked(*a, **k)

    monkeypatch.setattr(fused_step, "_checked", counting)
    for round_fn, _, args, kw in forms.values():
        calls.clear()
        round_fn(g0.clone(), *args, lam=2.0, sweeps=3, **kw)
        assert len(calls) == 1, round_fn.__name__
    with pytest.raises(ValueError):  # a volume of another radius, caught once up front
        round_fn, _, (dense, pm), kw = forms["E"]
        round_fn(g0.clone(), dense[:, :9], pm, lam=2.0, sweeps=2, **kw)


def test_sweep_multipliers_are_f32_of_the_double_products():
    # the host computes lam * (sweep + 1) in Python double and the launch
    # carries it as f32, exactly as the per-step loop's ctypes float does;
    # an f32 product on the card would round differently for these lambdas
    lams = [0.1, 0.3, 1.0 / 3.0, 2.2, 16.0, 12.345678]
    differs = 0
    for lam in lams:
        for sweeps in (1, 2, 3, fused_step.MAX_SWEEPS + 1):
            got = fused_step.sweep_lams(lam, sweeps)
            want = [np.float32(lam * (s + 1)) for s in range(sweeps)]
            sent = np.array(fused_step._lam_array(got), dtype=np.float32)
            np.testing.assert_array_equal(sent, np.array(want, dtype=np.float32))
            assert [np.float32(ctypes.c_float(x).value) for x in got] == want
            on_card = [np.float32(lam) * np.float32(s + 1) for s in range(sweeps)]
            differs += sum(a != b for a, b in zip(on_card, want))
    assert differs > 0  # the check above can tell the two apart


def test_rounds_split_into_spans_of_max_sweeps():
    n = fused_step.MAX_SWEEPS
    assert fused_step._spans(0) == []
    assert fused_step._spans(2) == [range(0, 2)]
    assert fused_step._spans(n) == [range(0, n)]
    assert fused_step._spans(2 * n + 1) == [range(0, n), range(n, 2 * n),
                                            range(2 * n, 2 * n + 1)]
    with pytest.raises(ValueError):
        fused_step._spans(-1)


def test_rounds_loop_calls_a_round_callable_once_per_round():
    # a round callable (per_round) is called once per round with lam and
    # sweeps; a step is called once per colour step with lam * (sweep + 1)
    calls = []

    def step(grid, tag, *, cur, h, w, ci, cj, lam_mult):
        calls.append(("step", tag, cur, ci, cj, lam_mult))

    def round_fn(grid, tag, *, cur, h, w, lam, sweeps):
        calls.append(("round", tag, cur, lam, sweeps))

    round_fn.per_round = True

    def round_of(cur):
        return (round_fn if cur <= 4 else step), ("t",), {}

    grid = torch.zeros((1, 2, 3, 2), dtype=torch.int32)
    out = windowed.rounds_loop(grid, 16, 32, 48, 8.0, 2, round_of)
    assert out.shape == (1, 32, 48, 2)
    want = [("step", "t", c, ci, cj, lam * (s + 1))
            for c, lam in ((16, 8.0), (8, 16.0)) for s in range(2) for ci, cj in COLORS]
    want += [("round", "t", 4, 32.0, 2), ("round", "t", 2, 64.0, 2)]
    assert calls == want
