"""The benchmark's 4-card tiled 4K deployment
(``benchmark/configs/tiled2x2-fused4-interp4-3840x2160.json``) at a frame
the CPU runs in seconds: the tiled driver ``estimate_flow_driver_tiled`` on
the in-process transport (``LocalTiles``) and over four gloo processes on a
(ty=2, tx=2) mesh (``DistTiles``, tests/_torch_tiled_deployment_worker.py),
held bit for bit to the untiled driver and to the benchmark's plain
reference; the form each level ran in, and the exchanges the program
counted against the bytes reckoned from the shapes.

The configuration is the file's but for its depth: the first two of its
four levels (32 px blocks, 64 px search, rival radius 12, then the full
window), since every level of the file's four tiles 2 x 2 only from 1024
rows and columns on (level 3's 32-row halo needs tiles of more than 32
rows), which the CPU runs in about a minute a call.  The pairs are 60x62
clips of the ``clip-b8`` traffic (``benchmark/gen.py``), upscaled 4x to
240x248 and padded to 256x256: tiles of 128x128 at level 0, 64x64 at
level 1.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import gen  # noqa: E402
from benchmark.reference import flow as reference  # noqa: E402
from blockbasedmotionestimation_tpu_torch.config import MotionConfig  # noqa: E402
from blockbasedmotionestimation_tpu_torch.models import engine  # noqa: E402
from blockbasedmotionestimation_tpu_torch.ops import pad as pad_ops  # noqa: E402
from blockbasedmotionestimation_tpu_torch.parallel import tiled  # noqa: E402
from blockbasedmotionestimation_tpu_torch.utils import profiling  # noqa: E402
from tests.test_torch_multihost import _free_port  # noqa: E402

CONFIG = json.loads((ROOT / "benchmark/configs/tiled2x2-fused4-interp4-3840x2160.json")
                    .read_text())
TRAFFIC = json.loads((ROOT / "benchmark/traffic/clip-b8.json").read_text())
WORKER = ROOT / "tests" / "_torch_tiled_deployment_worker.py"
LEVELS = 2
FRAME = (60, 62)
PADDED = (256, 256)
BATCH = 2
SEED = 2**33 + 29
LIST_FIELDS = ("block_sizes", "search_sizes", "rival_radius")
KINDS = ("exchanges_by_kind", "exchange_bytes_by_kind", "tiled_levels_by_form")


def _fields(**over) -> dict:
    """The configuration file's MotionConfig fields (lists as tuples), its
    first ``LEVELS`` levels."""
    fields = {k: tuple(v) if k in LIST_FIELDS and isinstance(v, list) else v
              for k, v in CONFIG["motion_config"].items()}
    for k in LIST_FIELDS:
        fields[k] = fields[k][:LEVELS]
    return dict(fields, **over)


def _mesh(ranks=None) -> tiled.Mesh:
    return tiled.Mesh(CONFIG["mesh"]["shape"], CONFIG["mesh"]["axes"], ranks=ranks)


def _counted(c0: dict, c1: dict) -> dict:
    out = {k: {x: v - c0[k].get(x, 0) for x, v in c1[k].items()} for k in KINDS}
    out = {k: {x: v for x, v in d.items() if v} for k, d in out.items()}
    out["exchange_bytes"] = c1["exchange_bytes"] - c0["exchange_bytes"]
    return out


def exchanges_from_the_shapes(cfg: MotionConfig, batch: int, h: int, w: int, ty: int,
                              tx: int) -> tuple[dict, dict]:
    """(exchanges, bytes) by kind that the processes of a (ty, tx) mesh send
    in one request of the tiled engine on pre-padded (batch, h, w) frames,
    every level on 2-D tiles, reckoned from the shapes: each tile edge
    inside the frame crossed both ways; frame-2 halos of u8 pixels, rows
    first, then columns of the row-extended tiles; the winners' ring and
    the ghost rows and columns of int32 (u, v) cells, the columns again
    with the rows' end cells; a round a block size bs .. 2 of
    ``sweeps_per_round`` sweeps of 4 colour steps; the tiles joined
    column line first, then each row of whole width to the other rows'
    processes, which all hold it."""
    count = {"halo": 0, "rival": 0, "ghost": 0, "join": 0}
    sent = dict.fromkeys(count, 0)
    across_rows = (ty - 1) * tx * 2 * batch   # tile edges between rows, both ways
    across_cols = (tx - 1) * ty * 2 * batch
    for level in range(cfg.num_levels):
        ht, wt, bs = (h >> level) // ty, (w >> level) // tx, cfg.block_sizes[level]
        halo = tiled.im2_halo(cfg, level)
        count["halo"] += 2
        sent["halo"] += across_rows * halo * wt + across_cols * halo * (ht + 2 * halo)
        npy, npx = ht // bs, wt // bs
        count["rival"] += 2
        sent["rival"] += across_rows * npx * 8 + across_cols * (npy + 2) * 8
        cur = bs
        while cur > 1:
            steps = cfg.sweeps_per_round * 4
            count["ghost"] += 2 * steps
            nby, nbx = ht // cur, wt // cur
            sent["ghost"] += steps * (across_rows * nbx * 8 + across_cols * (nby + 2) * 8)
            cur //= 2
        tile = batch * ht * wt * 8
        count["join"] += 2
        sent["join"] += ty * tx * (tile * (tx - 1) + tile * tx * (ty - 1))
    return count, sent


@pytest.fixture(scope="module")
def request_pairs():
    tr = dict(TRAFFIC, batch=BATCH, pool_requests=1)
    frames = gen.pool(tr, *FRAME, SEED, "cpu")
    return frames[:BATCH], frames[1:BATCH + 1]


@pytest.fixture(scope="module")
def untiled(request_pairs):
    cfg = MotionConfig.from_fields(_fields())
    return engine.estimate_flow_driver_batched(*request_pairs, cfg, device="cpu")


def test_every_level_tiles_two_by_two_and_the_padding_is_the_untiled_one():
    cfg = MotionConfig.from_fields(_fields())
    h, w = FRAME[0] * cfg.interp_factor, FRAME[1] * cfg.interp_factor
    p = pad_ops.compute_padding(h, w, cfg, row_tiles=2)
    assert p == pad_ops.compute_padding(h, w, cfg)
    assert (p.padded_h, p.padded_w) == PADDED and p.pad_y > 0 and p.pad_x > 0
    plan = tiled.plan_tiling(cfg, *PADDED, 2, 2)
    assert [(e["rows_ok"], e["cols_ok"]) for e in plan] == [(True, True)] * LEVELS
    assert tiled.derive_mv_cap(cfg, h, w, 2, 2) is None
    # the file's deployment: 4 levels over 2 x 2 cards, every level on tiles
    full = MotionConfig.from_fields({k: tuple(v) if isinstance(v, list) else v
                                     for k, v in CONFIG["motion_config"].items()})
    f = full.interp_factor
    h4, w4 = CONFIG["frame"]["height"] * f, CONFIG["frame"]["width"] * f
    p4 = pad_ops.compute_padding(h4, w4, full, row_tiles=2)
    assert p4 == pad_ops.compute_padding(h4, w4, full)
    assert (p4.padded_h, p4.padded_w) == (8704, 15360)
    plan4 = tiled.plan_tiling(full, p4.padded_h, p4.padded_w, 2, 2)
    assert [(e["halo"], e["strip_h"], e["strip_w"]) for e in plan4] == [
        (480, 4352, 7680), (224, 2176, 3840), (96, 1088, 1920), (32, 544, 960)]
    assert all(e["rows_ok"] and e["cols_ok"] for e in plan4)
    assert tiled.derive_mv_cap(full, h4, w4, 2, 2) is None


def test_local_tiles_equal_the_untiled_driver_and_the_reference(request_pairs, untiled):
    cfg = MotionConfig.from_fields(_fields())
    c0 = profiling.counters()
    flow = tiled.estimate_flow_driver_tiled(*request_pairs, cfg, _mesh(),
                                            **CONFIG["entry_kwargs"])
    counted = _counted(c0, profiling.counters())
    assert flow.dtype == torch.float32 and flow.shape == (BATCH, *FRAME, 2)
    assert torch.equal(flow, untiled)
    want = reference.estimate(*request_pairs, _fields())
    assert reference.mismatched_pixels(flow, want) == 0
    assert torch.unique(flow[..., 0]).numel() > 3  # the motion is not trivial
    assert counted["tiled_levels_by_form"] == {"tiles": LEVELS}
    count, sent = exchanges_from_the_shapes(cfg, BATCH, *PADDED, 2, 2)
    assert counted["exchanges_by_kind"] == count
    assert counted["exchange_bytes_by_kind"] == sent
    assert counted["exchange_bytes"] == sum(sent.values())


def test_four_gloo_processes_equal_the_untiled_driver(request_pairs, untiled, tmp_path):
    """Each of four processes holds one tile of each frame and swaps halos,
    ghost cells, the winners' ring and the joins point to point: every
    process returns the untiled flow, and what their counters counted adds
    up to what the in-process transport counts for the whole mesh."""
    cfg = MotionConfig.from_fields(_fields())
    torch.save({"im1": request_pairs[0], "im2": request_pairs[1], "fields": _fields()},
               tmp_path / "request.pt")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + (os.pathsep + env["PYTHONPATH"]
                                     if env.get("PYTHONPATH") else "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    addr = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, str(WORKER), addr, "4", str(pid), str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("the tiled workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
    results = [torch.load(tmp_path / f"{pid}.pt") for pid in range(4)]
    for r in results:
        assert torch.equal(r["flow"], untiled)
    count, sent = exchanges_from_the_shapes(cfg, BATCH, *PADDED, 2, 2)
    for r in results:
        assert r["counted"]["tiled_levels_by_form"] == {"tiles": LEVELS}
        assert r["counted"]["exchanges_by_kind"] == count
    for kind, nbytes in sent.items():
        assert sum(r["counted"]["exchange_bytes_by_kind"][kind] for r in results) == nbytes
    assert sum(r["counted"]["exchange_bytes"] for r in results) == sum(sent.values())
    # no process sends the batch: every one holds the whole batch
    assert all("batch" not in r["counted"]["exchanges_by_kind"] for r in results)


SMALL = dict(block_sizes=(8, 8), search_sizes=(16, 16), rival_radius=(2, None),
             interp_factor=1)


@pytest.mark.parametrize("mesh,axis_x,frame,form", [
    # the halo does not fit the tiles: every level runs whole-frame
    (((2, 2), ("ty", "tx")), "tx", (32, 40), "whole"),
    (((2,), ("ty",)), None, (64, 48), "strips"),
])
def test_the_driver_takes_the_configuration_as_given(mesh, axis_x, frame, form, monkeypatch):
    """No ``mv_cap`` is derived: levels whose halo does not fit their tiles
    run whole-frame, and the flow is the untiled driver's."""
    cfg = MotionConfig(**SMALL)
    im1, im2 = (torch.as_tensor(a) for a in gen.pool(
        dict(TRAFFIC, batch=1, pool_requests=1, object_px=[8, 16], pan_px=1,
             object_motion_px=2), *frame, SEED, "cpu")[:2])
    im1, im2 = im1[None], im2[None]
    seen = []
    run = tiled._run

    def recorded(a, b, cfg_run, *args):
        seen.append(cfg_run)
        return run(a, b, cfg_run, *args)
    monkeypatch.setattr(tiled, "_run", recorded)
    c0 = profiling.counters()
    flow = tiled.estimate_flow_driver_tiled(im1, im2, cfg, tiled.Mesh(*mesh), axis_x=axis_x)
    counted = _counted(c0, profiling.counters())
    assert seen == [cfg] and seen[0].mv_cap is None
    assert torch.equal(flow, engine.estimate_flow_driver_batched(im1, im2, cfg, device="cpu"))
    assert counted["tiled_levels_by_form"] == {form: cfg.num_levels}
    if form == "whole":
        assert counted["exchange_bytes"] == 0 and counted["exchanges_by_kind"] == {}
    else:  # row strips: no column exchange moves a byte
        assert counted["exchanges_by_kind"]["halo"] == cfg.num_levels


def test_gather_batch_without_a_batch_axis_makes_no_collective(monkeypatch):
    """Every process holds the whole batch: its own flow is returned as it
    is, with no collective (none can run: there is no process group) and
    no exchange counted."""
    def no_collective(*args, **kw):
        raise AssertionError("a collective was made")
    monkeypatch.setattr(torch.distributed, "all_gather", no_collective)
    monkeypatch.setattr(torch.distributed, "get_world_size", no_collective)
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 2, 2)
    c0 = profiling.counters()
    assert tiled._gather_batch(x, _mesh(ranks=[[0, 1], [2, 3]]), None) is x
    assert _counted(c0, profiling.counters())["exchange_bytes"] == 0
