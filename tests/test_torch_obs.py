"""``repro_torch.obs`` (registry, spans, export, ``python -m``) held against
``repro.obs``: the same operations give the same snapshot JSON, exposition
text and trace events (timestamps aside); the plan-cache stats of the port's
dispatch are a view over its registry; a checked-in plan's modeled energy
per token is the reference's. The monitor's cases are in
``test_torch_monitor.py``."""

import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import obs as JO  # noqa: E402
from repro.numerics import load_plan as jload_plan  # noqa: E402
from repro_torch import obs as TO  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.numerics import load_plan as tload_plan  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PLANS_DIR = ROOT / "examples" / "plans"


def _populate(O):
    reg = O.Registry()
    c = reg.counter("repro_x_total", "things", ("kind",))
    c.inc(kind="a")
    c.inc(2, kind="b")
    c.inc(0.5, kind='q"uote\\d\nnl')
    g = reg.gauge("repro_y", "level")
    g.set(4.5)
    g.add(-1.25)
    h = reg.histogram("repro_z_seconds", "latency", ("route",))
    for v in (0.0004, 0.01, 2.0, 75.0):
        h.observe(v, route="r1")
    reg.histogram("repro_w_seconds", "custom", buckets=(0.5, 0.1)).observe(0.3)
    reg.counter("repro_empty_total", "declared, never incremented")
    return reg, c, g, h


def test_registry_snapshot_and_exposition_equal_reference():
    (treg, tc, tg, th), (jreg, jc, jg, jh) = _populate(TO), _populate(JO)
    assert treg.snapshot_json() == jreg.snapshot_json()
    assert json.loads(json.dumps(treg.snapshot())) == treg.snapshot()
    assert treg.snapshot()["kind"] == "repro.obs.MetricsSnapshot"
    assert treg.exposition() == jreg.exposition()
    assert 'repro_x_total{kind="a"} 1' in treg.exposition()
    assert (tc.total(), tg.value(), th.value(route="r1")) == \
        (jc.total(), jg.value(), jh.value(route="r1"))
    assert treg.names() == jreg.names()
    treg.reset()
    jreg.reset()
    assert treg.snapshot_json() == jreg.snapshot_json()
    assert tc.total() == 0.0 and tc.value(kind="a") == 0.0   # handles survive


def test_registry_rejects_mismatched_redeclaration():
    reg = TO.Registry()
    reg.counter("repro_m_total", "x", ("a",))
    with pytest.raises(TO.MetricError):
        reg.gauge("repro_m_total", "x", ("a",))         # kind mismatch
    with pytest.raises(TO.MetricError):
        reg.counter("repro_m_total", "x", ("b",))       # label mismatch
    with pytest.raises(TO.MetricError):
        reg.counter("repro_m_total", "x", ("a",)).inc(-1)   # negative inc
    with pytest.raises(TO.MetricError):
        reg.counter("repro_m_total", "x", ("a",)).inc(b=1)  # unknown label


def _spans(O):
    O.recorder().clear()
    with O.span("serving.outer", plan="p") as outer:
        assert O.current_span() is outer
        with O.span("serving.inner", skipped=None):
            assert O.current_span().name == "serving.inner"
        assert O.current_span() is outer
        outer.annotate(steps=3)
    sp = O.start_span("train.lifecycle", uid=7)
    assert O.current_span() is None          # manual spans stay off the stack
    sp.end(status="done")
    sp.end()                                 # idempotent: recorded once
    return O.chrome_trace()


def test_spans_and_chrome_trace_equal_reference():
    tdoc, jdoc = _spans(TO), _spans(JO)
    assert json.loads(json.dumps(tdoc)) == tdoc
    timeless = lambda doc: [{k: v for k, v in ev.items() if k not in ("ts", "dur")}
                            for ev in doc["traceEvents"]]
    assert timeless(tdoc) == timeless(jdoc)
    assert {k: v for k, v in tdoc.items() if k != "traceEvents"} == \
        {k: v for k, v in jdoc.items() if k != "traceEvents"}
    assert [e["name"] for e in tdoc["traceEvents"]] == \
        ["serving.inner", "serving.outer", "train.lifecycle"]
    by_name = {e["name"]: e for e in tdoc["traceEvents"]}
    assert by_name["serving.outer"]["args"] == {"plan": "p", "steps": 3}
    assert by_name["serving.inner"]["args"] == {}
    o, i = by_name["serving.outer"], by_name["serving.inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    for ev in tdoc["traceEvents"]:
        assert ev["ph"] == "X" and ev["dur"] >= 0 and ev["ts"] >= 0


def test_recorder_ring_counts_drops():
    rec = TO.SpanRecorder(limit=2)
    for n in range(5):
        rec.record({"name": f"e{n}"})
    assert [e["name"] for e in rec.events()] == ["e3", "e4"] and rec.dropped == 3
    rec.enabled = False
    rec.record({"name": "off"})
    assert len(rec.events()) == 2
    rec.clear()
    assert rec.events() == [] and rec.dropped == 0


def test_save_chrome_trace_and_metrics_server(tmp_path):
    _spans(TO)
    path = tmp_path / "trace.json"
    assert TO.save_chrome_trace(str(path)) == 3
    assert json.loads(path.read_text()) == json.loads(json.dumps(TO.chrome_trace()))
    reg, *_ = _populate(TO)
    srv = TO.start_metrics_server(0, registry=reg)
    try:
        base = f"http://127.0.0.1:{srv.server_port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            assert r.read().decode() == reg.exposition()
        with urllib.request.urlopen(base + "/metrics.json", timeout=10) as r:
            assert json.loads(r.read()) == reg.snapshot()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        srv.shutdown()
        srv.server_close()


def test_monitor_names_are_not_ported_yet():
    """The monitor is ported (the name stays from the slice before it):
    every name of ``repro.obs.__all__`` resolves in ``repro_torch.obs``,
    the ``monitor`` module too, and an unknown name still raises."""
    assert TO.__all__ == JO.__all__
    for name in JO.__all__:
        assert getattr(TO, name) is not None, name
    assert TO.monitor.NumericsMonitor is TO.NumericsMonitor
    assert TO.STATUS_CODE == JO.STATUS_CODE
    assert (TO.INSIDE, TO.NEAR_EDGE, TO.VIOLATED, TO.UNMONITORED) == \
        (JO.INSIDE, JO.NEAR_EDGE, JO.VIOLATED, JO.UNMONITORED)
    with pytest.raises(AttributeError, match="no attribute"):
        TO.nothing_like_it


@pytest.mark.parametrize("flags", [["--demo"], ["--demo", "--json"], []])
def test_cli_prints_what_the_reference_prints(flags):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    run = lambda pkg: subprocess.run([sys.executable, "-m", pkg, *flags], env=env,
                                     capture_output=True, text=True, timeout=300)
    got, want = run("repro_torch.obs"), run("repro.obs")
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    if flags:
        assert "repro_demo_requests_total" in got.stdout


def test_cli_writes_out(tmp_path):
    from repro_torch.obs.__main__ import main
    before = TO.default_registry().snapshot_json()
    assert main(["--json", "--out", str(tmp_path / "m.json")]) == 0
    assert json.loads((tmp_path / "m.json").read_text()) == json.loads(before)


def test_plan_cache_stats_is_registry_view():
    TD.clear_plan_cache()
    st0 = TD.plan_cache_stats()
    assert st0.hits == 0 and st0.size == 0
    spec = TD.AccumulatorSpec(ovf=30, msb=30, lsb=-30)
    TD.plan_gemm(16, 16, 32, fmt=TD.FP32, spec=spec)   # miss
    TD.plan_gemm(16, 16, 32, fmt=TD.FP32, spec=spec)   # hit
    st1 = TD.plan_cache_stats()
    assert st1.misses == 1 and st1.hits == 1 and st1.size == 1
    ops = TO.default_registry().counter("repro_plan_cache_ops_total", "", ("op",))
    assert ops.value(op="misses") == st1.misses     # same numbers, one source
    assert ops.value(op="hits") == st1.hits
    assert TO.default_registry().gauge("repro_plan_cache_size").value() == 1
    TD.clear_plan_cache()
    assert TD.plan_cache_stats().size == 0


@pytest.mark.parametrize("name", ["qwen3_0p6b.json", "dbrx_132b.json", "paper_mlp.json"])
def test_plan_energy_per_token_equals_reference(name):
    path = str(PLANS_DIR / name)
    got = TO.plan_energy_per_token(tload_plan(path))
    assert got > 0.0
    assert got == JO.plan_energy_per_token(jload_plan(path))
