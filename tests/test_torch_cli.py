"""The port's CLI and evaluation runner against the JAX package's, on the
CPU (``--device cpu``): every subcommand writes the same files and makes
the same prints (times masked), and the evaluation gives JAX's EPE."""

import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu import cli as jcli
from blockbasedmotionestimation_tpu.config import tiny_config
from blockbasedmotionestimation_tpu.models import evaluate as jeval
from blockbasedmotionestimation_tpu.utils import flowio as jflowio
from blockbasedmotionestimation_tpu_torch import cli
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.models import evaluate
from blockbasedmotionestimation_tpu_torch.utils import flowio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE = ["--levels", "2", "--block", "8", "--search", "24", "--interp", "1",
          "--rival-radius", "4,full"]
CFG = tiny_config(block_sizes=(8, 8), search_sizes=(24, 24), rival_radius=(4, None))
TIME = re.compile(r" *\d+\.\d+(s| pairs/s)?")


def _masked(text: str) -> str:
    """Prints with every decimal number masked, together with the spaces
    in front of it, since times differ (a right-aligned 9.99 and 10.00 mask
    alike); the EPE lines are compared unmasked separately."""
    return TIME.sub("#", text)


def _both(capsys, argv, port_extra=(), equal_numbers=True):
    """Run JAX's CLI, then the port's on ``argv`` (``{pkg}`` in an argument
    becomes ``jax`` / ``port``); returns the two prints."""
    outs = []
    for main, tag, extra in ((jcli.main, "jax", ()), (cli.main, "port", port_extra)):
        assert main([a.format(pkg=tag) for a in argv] + list(extra)) == 0
        outs.append(capsys.readouterr().out)
    want, got = outs
    assert _masked(got) == _masked(want)
    if equal_numbers:
        assert got == want
    return got, want


def _texture_pair(tmp_path, h=64, w=96):
    base = np.random.default_rng(4).integers(0, 256, size=(h + 16, w + 16), dtype=np.uint8)
    im1 = base[8 + 1 : 8 + 1 + h, 8 - 3 : 8 - 3 + w]
    im2 = base[8 : 8 + h, 8 : 8 + w]
    paths = tmp_path / "f1.png", tmp_path / "f2.png"
    for p, im in zip(paths, (im1, im2)):
        flowio.write_image(p, im)
    return [str(p) for p in paths]


def test_cli_estimate_evaluate_colorize_legend_equal_jax(tmp_path, capsys):
    f1, f2 = _texture_pair(tmp_path)
    gt = np.zeros((64, 96, 2), np.float32)
    gt[..., 0], gt[..., 1] = -3.0, 1.0
    flowio.write_flo(tmp_path / "gt.flo", gt)
    got, _ = _both(capsys, ["estimate", f1, f2, str(tmp_path / "{pkg}.flo"),
                            "--png", str(tmp_path / "{pkg}.png"), "--gt", str(tmp_path / "gt.flo"),
                            *ENGINE], ("--device", "cpu"), equal_numbers=False)
    assert "Seconds:" in got and "The MSE is" in got
    assert len([ln for ln in got.splitlines() if ln.startswith("The MSE is")]) == 1
    for ext in ("flo", "png"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (tmp_path / f"jax.{ext}").read_bytes()
    flow = flowio.read_flo(tmp_path / "port.flo")
    assert got.splitlines()[-1] == f"The MSE is {jflowio.average_epe(gt, flow)}"
    _both(capsys, ["evaluate", str(tmp_path / "port.flo"), str(tmp_path / "gt.flo")])
    _both(capsys, ["colorize", str(tmp_path / "port.flo"), str(tmp_path / "c_{pkg}.png"),
                   "--max-motion", "5"])
    assert (tmp_path / "c_port.png").read_bytes() == (tmp_path / "c_jax.png").read_bytes()
    _both(capsys, ["legend", str(tmp_path / "l_{pkg}.png"), "--range", "6"])
    assert (tmp_path / "l_port.png").read_bytes() == (tmp_path / "l_jax.png").read_bytes()


def test_cli_evaluate_shape_mismatch(tmp_path, capsys):
    flowio.write_flo(tmp_path / "a.flo", np.zeros((4, 6, 2), np.float32))
    flowio.write_flo(tmp_path / "b.flo", np.zeros((4, 5, 2), np.float32))
    assert cli.main(["evaluate", str(tmp_path / "a.flo"), str(tmp_path / "b.flo")]) == 1
    assert "shape mismatch" in capsys.readouterr().err


def test_cli_sequence_equals_jax(tmp_path, capsys):
    base = np.random.default_rng(5).integers(0, 256, size=(64 + 16, 96 + 16), dtype=np.uint8)
    for k in range(4):
        flowio.write_image(tmp_path / f"f{k:03d}.png", base[8 - k : 72 - k, 8 + k : 104 + k])
    argv = ["sequence", str(tmp_path / "f*.png"), str(tmp_path / "{pkg}"), "--batch", "2",
            "--out-stride", "2", "--transfer", "f16", *ENGINE]
    got, _ = _both(capsys, argv, ("--device", "cpu"), equal_numbers=False)
    assert _masked(got).splitlines()[:3] == [f"pair {i:05d}:#" for i in range(3)]
    for i in range(3):
        name = f"flow{i:05d}.flo"
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    # a second run resumes every pair
    got, _ = _both(capsys, argv, ("--device", "cpu"))
    assert got.splitlines()[-1] == "0 computed, 3 resumed"
    assert cli.main(["sequence", str(tmp_path / "none*.png"), str(tmp_path / "x")]) == 1


def _gt_dir(tmp_path, names=("Venus", "Dimetrodon")):
    rng = np.random.default_rng(6)
    for k, name in enumerate(names):
        gt = np.zeros((48, 64, 2), np.float32)
        gt[..., 0] = 2.0 + k
        gt[:, 32:, 1] = -1.5
        gt[0, 0] = (1e10, 1e10)  # an unknown pixel
        os.makedirs(tmp_path / "gt" / name)
        flowio.write_flo(tmp_path / "gt" / name / "flow10.flo", gt)
        im1, im2 = jeval.synth.pair_from_gt(gt, rng)
        os.makedirs(tmp_path / "frames" / name)
        flowio.write_image(tmp_path / "frames" / name / "frame10.png", im1)
        flowio.write_image(tmp_path / "frames" / name / "frame11.png", im2)
    return str(tmp_path / "gt"), str(tmp_path / "frames")


def test_cli_middlebury_equals_jax(tmp_path, capsys):
    gt_dir, frames_dir = _gt_dir(tmp_path)
    for extra in ([], ["--frames-dir", frames_dir]):
        argv = ["middlebury", gt_dir, "--sequences", "Venus", "Dimetrodon", "--seed", "3",
                *extra, *ENGINE]
        got, want = _both(capsys, argv, ("--device", "cpu"), equal_numbers=False)
        # the EPE column and its mean are equal; only the times differ
        def epes(text):
            rows = text.splitlines()
            return [ln.split()[2] for ln in rows[1:-1]] + [rows[-1].split()[1]]

        assert epes(got) == epes(want)
        assert len(epes(got)) == 3


def test_evaluate_sequence_gives_jax_epe(tmp_path):
    gt_dir, frames_dir = _gt_dir(tmp_path, ("Grove2",))
    port = tconfig.MotionConfig.from_fields(vars(CFG))
    for kw in (dict(), dict(frames_dir=frames_dir)):
        got = evaluate.evaluate_sequence("Grove2", gt_dir, port, seed=1, device="cpu", **kw)
        want = jeval.evaluate_sequence("Grove2", gt_dir, CFG, seed=1, **kw)
        assert (got.name, got.epe, got.shape) == (want.name, want.epe, want.shape)
    kw = dict(gain=1.2, offset=-8.0, noise_sigma=1.0, occlusion_fill=True, seed=2)
    got = evaluate.evaluate_sequence_photometric("Grove2", gt_dir, port.replace(cost="zsad"),
                                                 device="cpu", **kw)
    want = jeval.evaluate_sequence_photometric("Grove2", gt_dir, CFG.replace(cost="zsad"), **kw)
    assert got.epe == want.epe
    assert evaluate.SEQUENCES == jeval.SEQUENCES
    report = evaluate.format_report([got])
    assert report.splitlines()[1].split()[:3] == ["Grove2", "64x", "48"]
    with pytest.raises(FileNotFoundError):
        evaluate.evaluate_middlebury(gt_dir, port, sequences=("Urban2",), device="cpu")


def test_cli_runs_without_jax(tmp_path):
    # a fresh interpreter: the port's CLI end to end, then no module of jax
    # or of the JAX package is loaded
    code = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        from blockbasedmotionestimation_tpu_torch import cli
        from blockbasedmotionestimation_tpu_torch.utils import flowio
        d = {str(tmp_path)!r}
        rng = np.random.default_rng(0)
        a = rng.integers(0, 256, size=(32, 48), dtype=np.uint8)
        flowio.write_image(d + "/a.png", a)
        flowio.write_image(d + "/b.png", np.roll(a, 2, axis=1))
        assert cli.main(["estimate", d + "/a.png", d + "/b.png", d + "/o.flo", "--png",
                         d + "/o.png", "--levels", "1", "--block", "8", "--search", "16",
                         "--interp", "1", "--device", "cpu"]) == 0
        assert cli.main(["legend", d + "/l.png"]) == 0
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "blockbasedmotionestimation_tpu"))
        assert not bad, bad
        print("jax-free")
        """
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "jax-free" in out.stdout
