"""The port's sequence runner against the JAX package's, on the CPU: the
same ``.flo`` bytes, the same report keys, resume, atomic checkpoints,
batching and the on-device stride / f16 download."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu.config import tiny_config
from blockbasedmotionestimation_tpu.models import sequence as jseq
from blockbasedmotionestimation_tpu.utils import flowio as jflowio
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.models import sequence
from blockbasedmotionestimation_tpu_torch.utils import flowio

CFG = tiny_config(block_sizes=(16, 8), search_sizes=(32, 24), rival_radius=(4, None))


def _port(cfg):
    return tconfig.MotionConfig.from_fields(vars(cfg))


def _frames(n=4, h=64, w=96, seed=3):
    """n frames of a texture moving by (2, -1) a frame."""
    base = np.random.default_rng(seed).integers(0, 256, size=(h + 16, w + 16), dtype=np.uint8)
    return [base[8 - k : 8 - k + h, 8 + 2 * k : 8 + 2 * k + w].copy() for k in range(n)]


def _flo_bytes(d, n):
    return [(d / sequence.flo_name(i)).read_bytes() for i in range(n)]


def test_sequence_equals_jax_bytes_and_report(tmp_path):
    frames = _frames()
    seen = []
    res = sequence.run_sequence(frames, tmp_path / "port", _port(CFG), device="cpu",
                                progress=lambda r: seen.append(r.index))
    jres = jseq.run_sequence(frames, tmp_path / "jax", CFG)
    assert [r.index for r in res] == [r.index for r in jres] == [0, 1, 2] == seen
    assert not any(r.skipped for r in res)
    assert _flo_bytes(tmp_path / "port", 3) == _flo_bytes(tmp_path / "jax", 3)
    report = json.loads((tmp_path / "port" / "report.json").read_text())
    jreport = json.loads((tmp_path / "jax" / "report.json").read_text())
    assert sorted(report) == sorted(jreport)
    for key in ("pairs", "computed", "resumed", "out_stride", "transfer_dtype", "config"):
        assert report[key] == jreport[key], key
    assert not [f for f in os.listdir(tmp_path / "port") if ".tmp" in f]


def test_sequence_resumes_and_batches_as_single(tmp_path):
    frames = _frames(n=5)
    cfg = _port(CFG)
    sequence.run_sequence(frames[:3], tmp_path / "single", cfg, device="cpu")  # pairs 0, 1
    seen = []
    res = sequence.run_sequence(frames, tmp_path / "single", cfg, device="cpu",
                                progress=lambda r: seen.append((r.index, r.skipped)))
    assert seen == [(0, True), (1, True), (2, False), (3, False)]
    assert [r.skipped for r in res] == [True, True, False, False]
    report = json.loads((tmp_path / "single" / "report.json").read_text())
    assert (report["resumed"], report["computed"]) == (2, 2)
    # batch 3 over 4 pairs: a full batch, then a tail of 1 (not padded)
    res = sequence.run_sequence(frames, tmp_path / "batched", cfg, device="cpu", batch_size=3)
    assert [r.index for r in res] == [0, 1, 2, 3]
    assert _flo_bytes(tmp_path / "batched", 4) == _flo_bytes(tmp_path / "single", 4)
    assert not [f for f in os.listdir(tmp_path / "batched") if ".tmp" in f]


def test_sequence_stride_f16_and_paths_equal_jax(tmp_path):
    frames = _frames(n=3)
    paths = []
    for k, f in enumerate(frames):
        p = tmp_path / f"f{k:03d}.png"
        flowio.write_image(p, f)
        paths.append(str(p))
    kw = dict(out_stride=2, transfer_dtype="f16")
    sequence.run_sequence(paths, tmp_path / "port", _port(CFG), device="cpu", batch_size=2, **kw)
    jseq.run_sequence(paths, tmp_path / "jax", CFG, batch_size=2, **kw)
    assert _flo_bytes(tmp_path / "port", 2) == _flo_bytes(tmp_path / "jax", 2)
    full = tmp_path / "full"
    sequence.run_sequence(frames, full, _port(CFG), device="cpu")
    for i in range(2):
        sub = flowio.read_flo(tmp_path / "port" / sequence.flo_name(i))
        assert sub.shape == (32, 48, 2)
        np.testing.assert_array_equal(sub, jflowio.read_flo(full / sequence.flo_name(i))[::2, ::2])
    with pytest.raises(ValueError, match="transfer_dtype"):
        sequence.run_sequence(frames, tmp_path / "bad", _port(CFG), device="cpu",
                              transfer_dtype="bf16")
