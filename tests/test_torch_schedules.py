"""The port's autotuner and schedule zoo against ``repro.core.schedules`` and
``repro.core.dispatch`` (modelled on the reference's
``tests/test_ragged_segment.py`` zoo tests and
``tests/test_batched_pallas.py``'s autotune test).

A zoo round-trips with the reference's document schema; a wrong kind,
version or fingerprint is refused; a warm process takes zero misses and
launches the persisted launches; the checked-in ``cuda.json`` loads with
its fingerprint checked and covers every plan key of a qwen3-0.6b serve and
continuous engine at full width; the reference's ``cpu.json`` loads into
the port with the same entries. ``plan_gemm(autotune=True)`` upgrades a
heuristic entry and never re-measures another, and is refused under
capture; a plan's launch that is not a layout raises. In ``pallas`` mode
dispatch resolves one plan per FDP call, and its counters and keys equal
the reference's where no weight is folded. On CPU tensors every candidate
launch runs the plain version: these tests exercise the logic, not the
pick."""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import accumulator as jacc  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.core import schedules as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import accumulator as tacc  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core import schedules as TS  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
SPEC = tacc.AccumulatorSpec.paper_91bit()
JSPEC = jacc.AccumulatorSpec.paper_91bit()


@pytest.fixture(autouse=True)
def _clean_caches():
    TD.clear_plan_cache()
    JD.clear_plan_cache()
    yield
    TD.clear_plan_cache()
    JD.clear_plan_cache()


def _spec_tuple(spec):
    return (spec.ovf, spec.msb, spec.lsb, spec.round_mode, spec.overflow_mode)


def _keys(cache):
    return {(b, m, n, k, f, _spec_tuple(s)) for b, m, n, k, f, s, _ in cache}


def _heuristic_entries(D, fmts, spec, **kw):
    D.plan_gemm(64, 48, 80, fmt=fmts.FP32, spec=spec, **kw)
    D.plan_gemm(32, 32, 32, fmt=fmts.BF16, spec=spec, batch=3, **kw)


def test_schedule_zoo_round_trip_keeps_the_reference_schema(tmp_path):
    _heuristic_entries(JD, jfmt, JSPEC)
    _heuristic_entries(TD, tfmt, SPEC, backend="cpu")
    JS.ScheduleZoo.from_cache("cpu", meta={"note": "test"}).save(tmp_path / "j.json")
    zoo = TS.ScheduleZoo.from_cache("cpu", meta={"note": "test"})
    zoo.save(tmp_path / "t.json")
    jdoc = json.loads((tmp_path / "j.json").read_text())
    tdoc = json.loads((tmp_path / "t.json").read_text())
    assert tdoc.keys() == jdoc.keys()
    assert {k: v for k, v in tdoc.items() if k != "fingerprint"} == \
        {k: v for k, v in jdoc.items() if k != "fingerprint"}
    assert tdoc["fingerprint"] == TS.schedule_fingerprint()
    assert tdoc["kind"] == TS.SCHEDULE_KIND == JS.SCHEDULE_KIND
    loaded = TS.ScheduleZoo.load(tmp_path / "t.json")
    assert loaded.backend == "cpu" and loaded.meta == {"note": "test"}
    assert loaded.entries == zoo.entries
    # a measured plan names its launch: its row adds the launch's fields
    TD.plan_gemm(8, 16, 32, fmt=tfmt.FP32, spec=SPEC, backend="cpu", autotune=True)
    TS.ScheduleZoo.from_cache("cpu").save(tmp_path / "m.json")
    rows = json.loads((tmp_path / "m.json").read_text())["entries"]
    measured = [r for r in rows if r["source"] == "measured"]
    assert len(measured) == 1 and set(measured[0]) == set(jdoc["entries"][0]) | set(
        TD.LAUNCH_FIELDS)
    again = TS.ScheduleZoo.load(tmp_path / "m.json").entries
    assert again == TS.ScheduleZoo.from_cache("cpu").entries
    TS.ScheduleZoo(backend="cpu", entries=again).save(tmp_path / "m2.json")
    assert (tmp_path / "m2.json").read_text() == (tmp_path / "m.json").read_text()


@pytest.mark.parametrize("field,value,msg", [
    ("kind", "bogus", "not a schedule zoo"),
    ("version", 99, "schema version"),
    ("fingerprint", "deadbeef", "fingerprint"),
])
def test_schedule_zoo_rejects(tmp_path, field, value, msg):
    _heuristic_entries(TD, tfmt, SPEC, backend="cpu")
    path = tmp_path / "zoo.json"
    TS.ScheduleZoo.from_cache("cpu").save(path)
    doc = json.loads(path.read_text())
    doc[field] = value
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match=msg):
        TS.ScheduleZoo.load(path)
    if field == "fingerprint":     # explicit bypass for offline inspection
        assert len(TS.ScheduleZoo.load(path, check_fingerprint=False).entries) == 2
    else:
        with pytest.raises(ValueError, match=msg):
            TS.ScheduleZoo.load(path, check_fingerprint=False)


def test_fingerprint_reads_the_tile_table_and_the_timing(monkeypatch):
    fp = TS.schedule_fingerprint()
    assert len(fp) == 16 and fp == TS.schedule_fingerprint()
    tiles, resident, smem = tk._dense_table()
    for obj, name, value in ((TD, "AUTOTUNE_TOP", TD.AUTOTUNE_TOP + 1),
                             (TD, "MEASURE_MIN_SECONDS", 2e-3),
                             (tk, "_dense_table", lambda: (tiles, resident, smem + 1)),
                             (tk, "DENSE_THREADS", 128)):
        with monkeypatch.context() as m:
            m.setattr(obj, name, value)
            assert TS.schedule_fingerprint() != fp, name
    assert TS.schedule_fingerprint() == fp


def test_warm_process_takes_zero_misses_and_launches_the_persisted_launch(tmp_path,
                                                                         monkeypatch):
    """save -> cold cache -> preload -> the same lookups all hit, and a
    dispatch of a preloaded key hands the kernel wrapper its launch."""
    p1 = TD.plan_gemm(6, 5, 24, fmt=tfmt.FP32, spec=SPEC, backend="cpu", autotune=True)
    p2 = TD.plan_gemm(4, 8, 16, fmt=tfmt.BF16, spec=SPEC, batch=2, backend="cpu",
                      autotune=True)
    assert p1.source == p2.source == "measured" and p1.launch and p2.launch
    TS.ScheduleZoo.from_cache("cpu").save(tmp_path / "cpu.json")

    TD.clear_plan_cache()                       # a new process
    assert TS.preload_schedules(str(tmp_path), "cpu") == 2
    q1 = TD.plan_gemm(6, 5, 24, fmt=tfmt.FP32, spec=SPEC, backend="cpu")
    q2 = TD.plan_gemm(4, 8, 16, fmt=tfmt.BF16, spec=SPEC, batch=2, backend="cpu")
    assert (q1.tile, q1.launch, q2.tile, q2.launch) == (p1.tile, p1.launch, p2.tile, p2.launch)
    assert q1.source == q2.source == "persisted"
    st = TD.plan_cache_stats()
    assert (st.misses, st.hits, st.persisted_loads, st.size) == (0, 2, 2, 2)

    seen = []
    plain = tk.fdp_gemm

    def spy(a, b, *, spec, fmt, launch=None):
        seen.append(launch)
        return plain(a, b, spec=spec, fmt=fmt, launch=launch)

    monkeypatch.setattr(tk, "fdp_gemm", spy)
    pol = TD.NumericsPolicy(TD.GemmConfig(tfmt.FP32, SPEC, "pallas"))
    a = torch.randn(2, 3, 24)                  # (2,3,24) @ (24,5) folds to (1, 6, 5, 24)
    TD.gemm(a, torch.randn(24, 5), site="mlp_in", policy=pol)
    assert seen == [tk.DenseLaunch(*p1.launch)]
    assert TD.plan_cache_stats().misses == 0
    # an override is never replaced by a zoo
    TD.register_plan(6, 5, 24, TD.GemmPlan(8, 8, 8), fmt=tfmt.FP32, spec=SPEC, backend="cpu")
    assert TS.preload_schedules(str(tmp_path), "cpu") == 1
    assert TD.plan_gemm(6, 5, 24, fmt=tfmt.FP32, spec=SPEC, backend="cpu").source == "override"


def test_preload_missing_zoo_is_zero(tmp_path):
    assert TS.preload_schedules(str(tmp_path / "nowhere")) == 0
    assert TS.preload_schedules(str(tmp_path), "cpu") == 0
    assert TS.zoo_path(str(tmp_path), "cuda") == os.path.join(str(tmp_path), "cuda.json")
    assert os.path.realpath(TS.zoo_path(backend="cuda")) == os.path.realpath(
        os.path.join(ROOT, "src", "repro_torch", "schedules", "cuda.json"))


def _serve_keys_at_full_width(monkeypatch):
    """The plan keys a qwen3-0.6b serve and continuous engine resolve at
    full width under the 91-bit kernel policy, gathered on the CPU: one
    layer (every layer resolves the same keys), weights left uninitialized
    (never touched: the dense kernel's wrapper is replaced by one that
    returns zeros of its output's shape; the plan lookups in
    ``kernels.ops`` before it run as they do on the card)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=1)
    params = Transformer(cfg, gen=None, dtype=torch.float32, device="cpu")
    monkeypatch.setattr(tk, "fdp_gemm", lambda a, b, *, spec, fmt, launch=None: torch.zeros(
        (a.shape[0], a.shape[1], b.shape[2])))
    return {key[:6] for key in TS.serve_keys(cfg, params, "cpu")}


def test_checked_in_cuda_zoo_loads_and_covers_the_qwen3_serve(monkeypatch):
    """``src/repro_torch/schedules/cuda.json`` was measured on an H100 (its
    meta names the card), loads against the current autotune configuration
    and holds a measured launch for every key of the serves it was made
    for, and each launch is a layout of its key's call."""
    path = TS.zoo_path(backend="cuda")
    zoo = TS.ScheduleZoo.load(path)
    assert zoo.backend == "cuda" and "H100" in zoo.meta["device"]
    assert zoo.meta["sms"] > 0 and zoo.meta["power_limit"]
    keys = _serve_keys_at_full_width(monkeypatch)
    assert len(keys) == 10                 # 6 dense shapes, 4 attention shapes at 2 lengths
    assert keys <= set(zoo.entries)
    for (batch, m, n, k, fmt, spec), plan in zoo.entries.items():
        assert fmt == tfmt.FP32.name and spec == SPEC
        assert plan.source == "measured" and plan.launch is not None
        tk.check_launch(tk.DenseLaunch(*plan.launch), spec.num_limbs, m, n, k)


def test_reference_cpu_zoo_loads_with_the_same_entries():
    path = os.path.join(ROOT, "examples", "plans", "schedules", "cpu.json")
    want = JS.ScheduleZoo.load(path)
    with pytest.raises(ValueError, match="fingerprint"):
        TS.ScheduleZoo.load(path)                       # another autotune configuration
    got = TS.ScheduleZoo.load(path, check_fingerprint=False)
    assert got.backend == want.backend == "cpu" and got.meta == want.meta
    conv = lambda entries: {key[:5] + (_spec_tuple(key[5]),): (p.bm, p.bn, p.bk, p.source)
                            for key, p in entries.items()}
    assert conv(got.entries) == conv(want.entries) and got.entries
    assert all(p.launch is None for p in got.entries.values())


def test_autotune_upgrades_a_heuristic_entry_and_never_remeasures():
    m, n, k = 16, 16, 32
    p0 = TD.plan_gemm(m, n, k, fmt=tfmt.FP32, spec=SPEC, backend="cpu")
    assert p0.source == "heuristic" and p0.launch is None
    report = []
    p1 = TD.plan_gemm(m, n, k, fmt=tfmt.FP32, spec=SPEC, backend="cpu", autotune=True,
                      report=report)
    assert p1.source == "measured" and p1.tile == tk.DenseLaunch(*p1.launch).tile
    assert [r["rank"] for r in report] == list(range(TD.AUTOTUNE_TOP))
    assert report[0]["launch"] == tk.dense_launch(SPEC.num_limbs, 1, m, n, k, tk.PLAIN_SMS)
    assert [r["launch"] for r in report] == tk.dense_candidates(
        SPEC.num_limbs, 1, m, n, k, tk.PLAIN_SMS, TD.AUTOTUNE_TOP)
    assert min(report, key=lambda r: r["seconds"])["launch"] == tk.DenseLaunch(*p1.launch)
    assert all(r["seconds"] > 0 for r in report)
    p2 = TD.plan_gemm(m, n, k, fmt=tfmt.FP32, spec=SPEC, backend="cpu", autotune=True)
    assert p2 == p1                       # a measured entry is not re-measured
    assert TD.plan_cache_stats().as_dict() == {"size": 1, "hits": 1, "misses": 2,
                                               "autotuned": 1, "persisted_loads": 0}
    # neither are override or persisted entries
    TD.register_plan(8, 8, 8, TD.GemmPlan(8, 8, 8), fmt=tfmt.FP32, spec=SPEC, backend="cpu")
    assert TD.plan_gemm(8, 8, 8, fmt=tfmt.FP32, spec=SPEC, backend="cpu",
                        autotune=True).source == "override"
    TS.ScheduleZoo("cpu", {(1, 4, 4, 4, tfmt.FP32.name, SPEC): TD.GemmPlan(8, 8, 8)}).install()
    assert TD.plan_gemm(4, 4, 4, fmt=tfmt.FP32, spec=SPEC, backend="cpu",
                        autotune=True).source == "persisted"
    assert TD.plan_cache_stats().autotuned == 1


def test_the_reference_autotunes_with_the_same_counters():
    """The reference's counters over the same plan_gemm sequence."""
    for D, fmts, spec, kw in ((JD, jfmt, JSPEC, {}), (TD, tfmt, SPEC, {"backend": "cpu"})):
        D.plan_gemm(16, 16, 32, fmt=fmts.FP32, spec=spec, **kw)
        D.plan_gemm(16, 16, 32, fmt=fmts.FP32, spec=spec, autotune=True, **kw)
        D.plan_gemm(16, 16, 32, fmt=fmts.FP32, spec=spec, autotune=True, **kw)
        D.plan_gemm(8, 16, 32, fmt=fmts.FP32, spec=spec, autotune=True, **kw)
    assert TD.plan_cache_stats().as_dict() == JD.plan_cache_stats().as_dict()


def test_autotune_raises_under_capture_and_on_a_disagreeing_candidate(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(TD, "capturing", lambda: True)
        with pytest.raises(RuntimeError, match="captured"):
            TD.plan_gemm(8, 8, 8, fmt=tfmt.FP32, spec=SPEC, backend="cpu", autotune=True)
        TD.plan_gemm(8, 8, 8, fmt=tfmt.FP32, spec=SPEC, backend="cpu")   # a lookup is fine
    plain = tk.fdp_gemm
    pick = tk.dense_launch(SPEC.num_limbs, 1, 8, 8, 8, tk.PLAIN_SMS)

    def off_by_one(a, b, *, spec, fmt, launch=None):
        out = plain(a, b, spec=spec, fmt=fmt, launch=launch)
        return out if launch == pick else out + 1

    monkeypatch.setattr(tk, "fdp_gemm", off_by_one)
    with pytest.raises(RuntimeError, match="disagrees with the model pick"):
        TD.plan_gemm(8, 8, 8, fmt=tfmt.FP32, spec=SPEC, backend="cpu", autotune=True)
    assert TD.plan_cache_stats().autotuned == 0


def test_a_plan_launch_that_is_not_a_layout_raises():
    pol = TD.NumericsPolicy(TD.GemmConfig(tfmt.FP32, SPEC, "pallas"))
    a, b = torch.randn(4, 64), torch.randn(64, 16)
    lays = tk.dense_candidates(SPEC.num_limbs, 1, 4, 16, 64, tk.PLAIN_SMS, 2)
    good = TD.GemmPlan(*lays[1].tile, source="override", launch=dataclasses.astuple(lays[1]))
    assert good.fit(4, 16, 64) is good              # fit never rewrites a launch
    torch.testing.assert_close(TD.gemm(a, b, site="t", policy=pol, plan=good),
                               TD.gemm(a, b, site="t", policy=pol), rtol=0, atol=0)
    # a layout of a larger call: its rows exceed the call's
    big = tk.dense_launch(SPEC.num_limbs, 1, 512, 512, 512, tk.PLAIN_SMS)
    bad = TD.GemmPlan(*big.tile, launch=dataclasses.astuple(big))
    with pytest.raises(ValueError, match="is not a layout of the dense kernel"):
        TD.gemm(a, b, site="t", policy=pol, plan=bad)
    with pytest.raises(ValueError, match="is not a layout"):
        tk.fdp_gemm(a[None], b[None], spec=SPEC, fmt=tfmt.FP32,
                    launch=dataclasses.replace(lays[0], lc=40))
    with pytest.raises(ValueError, match="not the tile of launch"):
        TD.GemmPlan(8, 8, 8, launch=dataclasses.astuple(lays[0]))
    with pytest.raises(ValueError, match="fields"):
        TD.GemmPlan(8, 8, 8, launch=(6, 1))


# (label, a shape, b shape): no weight broadcast over a batch, so no fold
CALLS = [
    ("2d", (5, 24), (24, 7)),
    ("vec_mat", (24,), (24, 7)),
    ("mat_vec", (5, 24), (24,)),
    ("batched", (2, 3, 24), (2, 24, 5)),
    ("4d", (1, 2, 3, 8), (1, 2, 8, 5)),
    ("lhs_broadcast", (3, 24), (2, 24, 5)),
]


def test_dispatch_resolves_one_plan_per_fdp_call_as_the_reference():
    rng = np.random.default_rng(3)
    ops = [(rng.standard_normal(sa).astype(np.float32),
            rng.standard_normal(sb).astype(np.float32)) for _, sa, sb in CALLS]
    q, k = (rng.standard_normal(s).astype(np.float32) for s in ((1, 2, 2, 3, 8), (1, 2, 5, 8)))
    p = rng.standard_normal((1, 2, 2, 3, 5)).astype(np.float32)
    x = rng.standard_normal((12, 8)).astype(np.float32)
    w = rng.standard_normal((3, 8, 6)).astype(np.float32)
    gs = np.array([5, 0, 6], np.int32)
    jpol = JD.NumericsPolicy(JD.GemmConfig(jfmt.FP32, JSPEC, "pallas"))
    tpol = TD.NumericsPolicy(TD.GemmConfig(tfmt.FP32, SPEC, "pallas"))
    for D, pol, conv in ((JD, jpol, jnp.asarray), (TD, tpol, torch.from_numpy)):
        with D.use_policy(pol):
            for _ in range(2):
                for a, b in ops:
                    D.gemm(conv(a), conv(b), site="t")
                D.grouped_qk(conv(q), conv(k), site="attn_qk")
                D.grouped_av(conv(p), conv(k), site="attn_av")
                D.ragged_gemm(conv(x), conv(w), conv(gs), site="moe_in")
    want = JD.plan_cache_stats()
    assert TD.plan_cache_stats().as_dict() == want.as_dict()
    # one lookup a call (two rounds of len(CALLS) + 3), a miss on a key's first
    assert want.hits + want.misses == 2 * (len(CALLS) + 3) and want.misses == want.size
    assert _keys(TD._PLAN_CACHE) == _keys(JD._PLAN_CACHE)
