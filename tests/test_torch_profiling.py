"""The port's ``utils/profiling.py`` against the JAX package's, on the CPU.

The work models (``search_sad_ops``, ``speed_of_light``,
``windowed_pipeline_roofline``, ``windowed_pipeline_floor``) give the JAX
package's counts term by term for the same config, size and rates: exact
equality of every count and every time (the same arithmetic in the same
order).  The port renames the TPU vocabulary (``vpu_ops`` -> ``int_ops``,
``vpu_s`` -> ``ops_s``, ``vpu_ops_per_sec`` -> ``ops_per_sec``); the tests
map the names.  Then ``trace`` writing a Chrome trace on the CPU (the
counters and spans: ``tests/test_torch_tracing.py``).
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from blockbasedmotionestimation_tpu import config as jconfig
from blockbasedmotionestimation_tpu.utils import profiling as jprof
from blockbasedmotionestimation_tpu_torch import config as tconfig
from blockbasedmotionestimation_tpu_torch.utils import profiling as tprof

# port name -> JAX name
NAMES = {"int_ops": "vpu_ops", "ops_s": "vpu_s", "hbm_bytes": "hbm_bytes",
         "hbm_s": "hbm_s", "floor_s": "floor_s"}
CONFIGS = {
    "default": dict(interp_factor=1),
    "ssd": dict(interp_factor=1, cost="ssd"),
    "rival-off": dict(interp_factor=1, rival_window=False),
    "no-band": dict(interp_factor=1, cv_store_radius=None),
    "2-level": dict(block_sizes=(8, 16), search_sizes=(24, 32), interp_factor=1,
                    rival_radius=(4, None)),
}
SIZES = [(1280, 2048), (1037, 1531)]
RATES = [None, (2.0e12, 8.1e11)]  # the port's H100 defaults; the JAX defaults


def _rates(rates):
    """(port kwargs, JAX kwargs): the same two rates under each's names."""
    if rates is None:
        rates = (tprof.CORE_OPS_PER_S, tprof.HBM_BYTES_PER_S)
    ops, hbm = rates
    return (dict(ops_per_sec=ops, hbm_bytes_per_sec=hbm),
            dict(vpu_ops_per_sec=ops, hbm_bytes_per_sec=hbm))


def test_h100_rates():
    assert tprof.HBM_BYTES_PER_S == 3.35e12
    assert tprof.CORE_OPS_PER_S == 67e12
    assert tprof.INSTR_PER_S == tprof.CORE_OPS_PER_S / 2


@pytest.mark.parametrize("rates", RATES, ids=["h100", "jax-defaults"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_roofline_term_by_term(name, size, rates):
    jc = jconfig.MotionConfig(**CONFIGS[name])
    tc = tconfig.MotionConfig(**CONFIGS[name])
    tk, jk = _rates(rates)
    want = jprof.windowed_pipeline_roofline(jc, *size, **jk)
    got = tprof.windowed_pipeline_roofline(tc, *size, **tk)
    assert list(got["components"]) == list(want["components"])
    for comp, terms in got["components"].items():
        assert {NAMES[k]: v for k, v in terms.items()} == want["components"][comp], comp
    assert got["total_floor_s"] == want["total_floor_s"]


@pytest.mark.parametrize("rates", RATES, ids=["h100", "jax-defaults"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_floor_term_by_term(name, size, rates):
    jc = jconfig.MotionConfig(**CONFIGS[name])
    tc = tconfig.MotionConfig(**CONFIGS[name])
    tk, jk = _rates(rates)
    want = jprof.windowed_pipeline_floor(jc, *size, **jk)
    got = tprof.windowed_pipeline_floor(tc, *size, **tk)
    assert {NAMES[k]: v for k, v in got.items()} == want


@pytest.mark.parametrize("h,w,bs,ss", [(1280, 2048, 32, 64), (160, 256, 32, 64),
                                       (1037, 1531, 8, 24), (64, 96, 4, 12)])
def test_search_ops_and_speed_of_light(h, w, bs, ss):
    assert tprof.search_sad_ops(h, w, bs, ss) == jprof.search_sad_ops(h, w, bs, ss)
    for rate in (tprof.CORE_OPS_PER_S, 2.0e12):
        got = tprof.speed_of_light(h, w, bs, ss, 1.25e-3, ops_per_sec=rate)
        assert got == jprof.speed_of_light(h, w, bs, ss, 1.25e-3, vpu_ops_per_sec=rate)


def test_default_h100_totals():
    # the default at 1080p (padded 1280x2048), B=8, at the H100's rates:
    # the figures the port's records quote (arithmetic, not a measurement)
    cfg = tconfig.MotionConfig(interp_factor=1)
    roof = tprof.windowed_pipeline_roofline(cfg, 1280, 2048)
    floor = tprof.windowed_pipeline_floor(cfg, 1280, 2048)
    assert round(8e3 * roof["total_floor_s"], 2) == 14.44
    assert round(8e3 * floor["floor_s"], 2) == 18.14
    assert round(8e3 * roof["components"]["cv_stream"]["floor_s"], 2) == 5.44


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with tprof.trace(str(tmp_path)) as prof:
        (x @ x).sum()
    assert prof is not None
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
