"""The round form of kernels E, F, 11, 12 and D, D', 8, 9 on the CPU.

``kernels.rounds.color_round_*`` run a whole round (``sweeps`` sweeps of
the four colours) in one call: on the card one cooperative launch with a grid
barrier between colour steps (``tests/test_torch_cuda.py`` holds it to the
plain step loop there), on the CPU the plain steps in the same order.
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

from blockbasedmotionestimation_tpu_torch.kernels import cv_diff, rounds
from blockbasedmotionestimation_tpu_torch.ops import windowed
from blockbasedmotionestimation_tpu_torch.ops.regularize import COLORS

BS, R, R2, STORE_R = 8, 5, 3, 2
STORED = ("D", "D'", "8", "9")  # the stored form's rows: rival at f = 1 / f > 1, then none


def _bs_of(form: str, cur: int) -> int:
    """The block size a case runs at: D and 8 are the rounds at cur = bs
    (f = 1), D' and 9 those below it (f >= 2); the other forms at BS, or
    cur where it is larger."""
    if form in ("D", "8"):
        return cur
    if form in ("D'", "9"):
        return max(BS, 2 * cur)
    return max(BS, cur)


def _other_width(vol):
    """The volume in the other of the stored widths (u16 <-> i32) where its
    values allow, so that the main and rival volumes of a case differ."""
    if vol.dtype == torch.uint16:
        return vol.to(torch.int32)
    return vol.to(torch.uint16) if int(vol.max()) < 2**16 else vol


def _inputs(rng, cur, cost, bs=BS):
    """Seeded numpy inputs at bs on 4x6 parents, B=2: windows, the dense
    main volume at cur, its band (every dy row, |dx| <= STORE_R), the rival
    window's volume at cur (in the other width where it fits), window
    centres and candidates within +-9 of them (in band, in the tail, rival
    only, unevaluable and off the frame's edge)."""
    b, npy, npx = 2, 4, 6
    h, w = npy * bs, npx * bs
    im1 = torch.as_tensor(rng.integers(0, 256, size=(b, h, w), dtype=np.uint8))
    win = torch.as_tensor(rng.integers(0, 256, size=(b, npy * npx, bs + 2 * R, bs + 2 * R),
                                       dtype=np.uint8))
    rwin = torch.as_tensor(rng.integers(0, 256, size=(b, npy * npx, bs + 2 * R2, bs + 2 * R2),
                                        dtype=np.uint8))
    dense = cv_diff.pooled_cvs(im1, win, bs, R, cost, emit=[cur])[cur]
    rdense = _other_width(cv_diff.pooled_cvs(im1, rwin, bs, R2, cost, emit=[cur])[cur])
    side, nby, nbx = 2 * R + 1, h // cur, w // cur
    band = dense.reshape(b, side, side, nby, nbx)[:, :, R - STORE_R:R + STORE_R + 1]
    band = band.reshape(b, side * (2 * STORE_R + 1), nby, nbx).contiguous()
    pm = torch.as_tensor(rng.integers(-3, 4, size=(b, npy, npx, 2)), dtype=torch.int32)
    rpm = pm + torch.as_tensor(rng.integers(-6, 7, size=pm.shape), dtype=torch.int32)
    f = bs // cur
    g0 = pm.repeat_interleave(f, 1).repeat_interleave(f, 2)
    g0 = g0 + torch.as_tensor(rng.integers(-9, 10, size=g0.shape), dtype=torch.int32)
    common = dict(im1=im1, cur=cur, h=h, w=w, r=R, cost=cost)
    stored = dict(cur=cur, h=h, w=w, r=R)
    rival = dict(stored, rcv=rdense, rpm=rpm, r2=R2)
    steps = (rounds.color_round_stored, rounds.color_step)
    return g0, {
        # the stored forms: D / D' or 8 / 9 by f, whatever the key
        "D": steps + ((dense, pm), rival), "D'": steps + ((dense, pm), rival),
        "8": steps + ((dense, pm), stored), "9": steps + ((dense, pm), stored),
        "E": (rounds.color_round_hybrid, rounds.color_step_hybrid, (dense, pm),
              dict(common, rwin=rwin, rpm=rpm, r2=R2)),
        "F": (rounds.color_round_hybrid_tail, rounds.color_step_hybrid_tail, (band, pm),
              dict(common, win=win, rwin=rwin, rpm=rpm, r2=R2, store_r=STORE_R)),
        "11": (rounds.color_round_fused, rounds.color_step_fused, (pm,),
               dict(common, win=win)),
        "12": (rounds.color_round_fused_rival, rounds.color_step_fused_rival, (pm,),
               dict(common, win=win, rwin=rwin, rpm=rpm, r2=R2)),
    }


@pytest.mark.parametrize("cost", ["sad", "ssd"])
@pytest.mark.parametrize("cur", [2, 4, 8, 16, 32])
@pytest.mark.parametrize("form", ["E", "F", "11", "12", *STORED])
def test_round_wrappers_equal_the_step_loop(form, cur, cost):
    # the stored forms: sad volumes are u16 up to bs 16 and i32 above, ssd
    # ones i32; each case's rival volume is in the other width where it fits
    rng = np.random.default_rng(10 * cur + len(form) + (cost == "ssd"))
    bs = _bs_of(form, cur)
    g0, forms = _inputs(rng, cur, cost, bs)
    round_fn, step_fn, args, kw = forms[form]
    assert round_fn.per_round and not getattr(step_fn, "per_round", False)
    if form in STORED:
        assert STORED[2 * ("rcv" not in kw) + (g0.shape[1] > args[1].shape[1])] == form
    lam = 3.0 * BS / cur
    launches = round_fn.launches
    # a round longer than one launch takes (two spans on the card)
    for sweeps in (1, 2, 3) + ((rounds.MAX_SWEEPS + 1,) if form in STORED else ()):
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

    def counting(fn):
        def call(*a, **k):
            calls.append(1)
            return fn(*a, **k)
        return call

    # every form's validate-and-pack checks the grid first, once
    monkeypatch.setattr(rounds, "_check_grid", counting(rounds._check_grid))
    for round_fn, _, args, kw in forms.values():
        calls.clear()
        round_fn(g0.clone(), *args, lam=2.0, sweeps=3, **kw)
        assert len(calls) == 1, round_fn.__name__
    for form in ("E", "D'"):  # a volume of another radius, caught once up front
        with pytest.raises(ValueError):
            round_fn, _, (dense, pm), kw = forms[form]
            round_fn(g0.clone(), dense[:, :9], pm, lam=2.0, sweeps=2, **kw)
    round_fn, _, args, kw = forms["D'"]
    with pytest.raises(ValueError):  # rival centres without a rival volume
        round_fn(g0.clone(), *args, lam=2.0, sweeps=2, **dict(kw, rcv=None))


def test_sweep_multipliers_are_f32_of_the_double_products():
    # the host computes lam * (sweep + 1) in Python double and the launch
    # carries it as f32, exactly as the per-step loop's ctypes float does;
    # an f32 product on the card would round differently for these lambdas
    lams = [0.1, 0.3, 1.0 / 3.0, 2.2, 16.0, 12.345678]
    differs = 0
    for lam in lams:
        for sweeps in (1, 2, 3, rounds.MAX_SWEEPS + 1):
            got = rounds.sweep_lams(lam, sweeps)
            want = [np.float32(lam * (s + 1)) for s in range(sweeps)]
            sent = np.array(rounds._lam_array(got), dtype=np.float32)
            np.testing.assert_array_equal(sent, np.array(want, dtype=np.float32))
            assert [np.float32(ctypes.c_float(x).value) for x in got] == want
            on_card = [np.float32(lam) * np.float32(s + 1) for s in range(sweeps)]
            differs += sum(a != b for a, b in zip(on_card, want))
    assert differs > 0  # the check above can tell the two apart


def test_rounds_split_into_spans_of_max_sweeps():
    n = rounds.MAX_SWEEPS
    assert rounds._spans(0) == []
    assert rounds._spans(2) == [range(0, 2)]
    assert rounds._spans(n) == [range(0, n)]
    assert rounds._spans(2 * n + 1) == [range(0, n), range(n, 2 * n),
                                            range(2 * n, 2 * n + 1)]
    with pytest.raises(ValueError):
        rounds._spans(-1)


def test_rounds_loop_calls_a_round_callable_once_per_round():
    # every round is one call of a round callable (per_round) with the
    # round's lambda (doubling every round) and sweeps; a one-step callable
    # (not per_round) is refused before it runs
    calls = []

    def round_fn(grid, tag, *, cur, h, w, lam, sweeps):
        calls.append(("round", tag, cur, lam, sweeps))

    round_fn.per_round = True

    def step(grid, tag, *, cur, h, w, ci, cj, lam_mult):
        calls.append(("step", tag, cur, ci, cj, lam_mult))

    grid = torch.zeros((1, 2, 3, 2), dtype=torch.int32)
    out = windowed.rounds_loop(grid, 16, 32, 48, 8.0, 2, lambda cur: (round_fn, ("t",), {}))
    assert out.shape == (1, 32, 48, 2)
    assert calls == [("round", "t", c, lam, 2)
                     for c, lam in ((16, 8.0), (8, 16.0), (4, 32.0), (2, 64.0))]
    calls.clear()
    with pytest.raises(TypeError, match="per_round"):
        windowed.rounds_loop(grid, 16, 32, 48, 8.0, 2,
                             lambda cur: (round_fn if cur <= 4 else step, ("t",), {}))
    assert calls == []


@pytest.mark.parametrize("rival", [True, False])
def test_rounds_loop_calls_the_stored_round_once_per_round(monkeypatch, rival):
    # the search-centred schedule stores every volume, so each of its
    # rounds (cur 8, 4, 2) is one call of the stored round wrapper with the
    # round's lambda and sweeps, and no colour step is called on its own
    from blockbasedmotionestimation_tpu_torch.ops.windowed import windowed_schedule

    calls, steps = [], []

    def spy(grid, cv, pm, **kw):
        calls.append((kw["cur"], kw["lam"], kw["sweeps"], "rcv" in kw))
        return rounds.color_round_stored(grid, cv, pm, **kw)

    spy.per_round = True

    def step(*a, **k):
        steps.append(1)
        return rounds.color_step(*a, **k)

    monkeypatch.setattr(windowed, "color_round_stored", spy)
    monkeypatch.setattr(rounds, "color_step", step)
    rng = np.random.default_rng(3)
    im = torch.as_tensor(rng.integers(0, 256, size=(1, 32, 48), dtype=np.uint8))
    grid0 = torch.as_tensor(rng.integers(-2, 3, size=(1, 4, 6, 2)), dtype=torch.int32)
    out = windowed_schedule(im, torch.roll(im, 1, 2), grid0, 8, 16, 1.0, 2, rival=rival)
    assert out.shape == (1, 32, 48, 2)
    assert calls == [(8, 1.0, 2, rival), (4, 2.0, 2, rival), (2, 4.0, 2, rival)]
    assert not steps
