"""The live envelope monitor of the port (``repro_torch.obs.monitor``) held
against ``repro.obs.monitor``.

The reference's ten monitor cases (``tests/test_obs.py``) run against the
port; its "does not retrace" case becomes: an eager engine under the monitor
folds every dispatch of every step and captures nothing. The same synthetic
GEMMs go through both monitors (native fp32 on a grid where every sum is
exact, FDP91, and a ⟨9,6,−20⟩ fixed-point site whose envelope has an lsb, so
the low side is tracked) and give equal snapshots and registry snapshots;
the reduced paper-mlp forward on carried weights gives the same status at
every site under the zoo plan's envelope in both packages. The hook reads
nothing back to the host per call: the queue is folded in one copy when a
reader asks, when it reaches ``FOLD_AT`` entries, or at uninstall.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core.accumulator import AccumulatorSpec as JSpec  # noqa: E402
from repro.core.formats import FP32 as JFP32  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.numerics import load_plan as jload  # noqa: E402
from repro.obs import monitor as JM  # noqa: E402
from repro.obs.registry import Registry as JRegistry  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core.accumulator import AccumulatorSpec as TSpec  # noqa: E402
from repro_torch.core.formats import FP32 as TFP32  # noqa: E402
from repro_torch.launch.batching import ContinuousBatcher, Request  # noqa: E402
from repro_torch.models import forward as tforward, params_from_numpy  # noqa: E402
from repro_torch.numerics import load_plan as tload  # noqa: E402
from repro_torch.obs import monitor as TM  # noqa: E402
from repro_torch.obs.monitor import (INSIDE, NEAR_EDGE, UNMONITORED, VIOLATED,  # noqa: E402
                                     NumericsMonitor, monitoring)
from repro_torch.obs.registry import Registry  # noqa: E402

torch.set_num_threads(1)

PLANS_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "plans")


# ---------------------------------------------------------------------------
# the reference's cases against the port
# ---------------------------------------------------------------------------
def _env(msb=127, lsb=None, a=(-8, 2), b=(-8, 2)):
    return {"version": 1, "sites": {"s": {
        "a_exp": list(a), "b_exp": list(b), "out_exp": [None, None],
        "msb": msb, "lsb": lsb, "calls": 4, "max_k": 8}}}


def _drive(mon, scale_a=1.0, scale_b=1.0):
    with mon:
        TD.gemm(scale_a * torch.ones((4, 8)), scale_b * torch.ones((8, 4)), site="s")
    return mon


def test_monitor_inside_on_calibration_like_traffic():
    mon = _drive(NumericsMonitor(_env(), registry=Registry()), 0.5, 0.5)
    info = mon.status("s")
    assert info["status"] == INSIDE
    assert mon.worst_status() == INSIDE and mon.overflow_events() == 0
    assert info["live"]["calls"] == 1 and info["live"]["max_k"] == 8


def test_monitor_near_edge_on_exponent_drift():
    mon = _drive(NumericsMonitor(_env(), registry=Registry()), 2.0 ** 10, 0.5)
    info = mon.status("s")
    assert info["status"] == NEAR_EDGE
    assert "traced range" in info["detail"]


def test_monitor_low_side_drift_only_flags_fixed_point():
    mon = _drive(NumericsMonitor(_env(), registry=Registry()), 2.0 ** -20, 2.0 ** -20)
    assert mon.status("s")["status"] == INSIDE
    mon = _drive(NumericsMonitor(_env(lsb=-30), registry=Registry()), 2.0 ** -20, 2.0 ** -20)
    assert mon.status("s")["status"] == NEAR_EDGE


def test_monitor_violated_when_msb_capacity_exceeded():
    mon = _drive(NumericsMonitor(_env(msb=20), registry=Registry()), 2.0 ** 14, 2.0 ** 14)
    info = mon.status("s")
    assert info["status"] == VIOLATED
    assert "exceeds deployed capacity 20" in info["detail"]


def test_monitor_nonfinite_counts_overflow_event():
    reg = Registry()
    mon = _drive(NumericsMonitor(_env(), registry=reg), 2.0 ** 70, 2.0 ** 70)
    assert mon.status("s")["status"] == VIOLATED
    assert mon.overflow_events() >= 1
    counted = reg.counter("repro_overflow_events_total", "", ("site", "source"))
    assert counted.value(site="s", source="gemm_nonfinite") == 1


def test_monitor_alert_sink_fires_once_per_escalation():
    fired = []
    mon = NumericsMonitor(_env(msb=20), registry=Registry(),
                          alert_sink=lambda s, status, info: fired.append((s, status)))
    _drive(mon, 2.0 ** 14, 2.0 ** 14)
    _drive(mon, 2.0 ** 14, 2.0 ** 14)      # same level: no second alert
    assert fired == [("s", VIOLATED)]


def test_monitor_unenveloped_site_reports_no_envelope():
    mon = _drive(NumericsMonitor(None, registry=Registry()), 1.0, 1.0)
    assert mon.status("s")["status"] == UNMONITORED


def test_monitor_eager_engine_folds_every_dispatch_and_captures_nothing():
    """The reference's "does not retrace": its staged callback re-fires at
    every execution of one compiled step. Here the engine runs eager steps
    (a hook sees no graph replay), so every dispatch of every step reaches
    the hook, and nothing is captured."""
    cfg = tget("paper-mlp").reduced()
    from repro_torch.models import init
    params = init(cfg, seed=0, device="cpu")
    reg = Registry()
    TD.reset_sites_seen()
    with NumericsMonitor(None, registry=reg) as mon:
        eng = ContinuousBatcher(cfg, params, n_slots=2, max_len=16, warmup=TD.MXU_FP32)
        for i in range(3):
            eng.submit(Request(uid=i, prompt=[3 + i, 7, 1], max_new=3))
        eng.run()
        assert mon.folds == 0                 # no reader yet: nothing read back
    assert eng.capture_count == 0 and not eng.graphed
    dispatched = TD.site_calls()
    calls = reg.counter("repro_monitor_calls_total", "", ("site",))
    assert dispatched and all(calls.value(site=s) == n for s, n in dispatched.items())
    assert sum(st["live"]["calls"] for st in mon.statuses().values()) == \
        sum(dispatched.values())
    assert mon.folds == 1                     # one copy, at uninstall


def test_monitor_coexists_with_calibration():
    reg = Registry()
    mon = NumericsMonitor(_env(), registry=reg).install()
    try:
        prev = TD.set_trace_hook(lambda *a: None)
        TD.set_trace_hook(prev)
        TD.gemm(torch.ones((4, 8)), torch.ones((8, 4)), site="s")
    finally:
        mon.uninstall()
    calls = reg.counter("repro_monitor_calls_total", "", ("site",))
    assert calls.value(site="s") == 1


def test_paper_mlp_envelope_violation_names_site():
    plan = tload(os.path.join(PLANS_DIR, "paper_mlp.json"))
    env = plan.meta["envelope"]
    site = "attn_qk"
    assert env["sites"] and site in env["sites"]
    pol = plan.to_policy()
    with monitoring(plan, registry=Registry()) as mon:
        TD.gemm(0.5 * torch.ones((4, 8)), 0.5 * torch.ones((8, 4)), site=site, policy=pol)
        assert mon.status(site)["status"] == INSIDE
        TD.gemm(torch.full((4, 8), 2.0 ** 70), torch.full((8, 4), 2.0 ** 70), site=site,
                policy=pol)
    info = mon.status(site)
    assert info["status"] == VIOLATED and info["site"] == site
    assert mon.worst_status() == VIOLATED
    assert mon.overflow_events() >= 1
    others = {s: i["status"] for s, i in mon.statuses().items()
              if s != site and i["live"] is not None}
    assert all(st == INSIDE for st in others.values())
    snap = json.loads(json.dumps(mon.snapshot()))
    assert snap["worst_status"] == VIOLATED


# ---------------------------------------------------------------------------
# both monitors on the same GEMMs
# ---------------------------------------------------------------------------
SPEC_LOW = (9, 6, -20)
CASES = {
    # name -> (JAX config, port config, envelope lsb)
    "native_fp32": (JD.GemmConfig(JFP32, None, "native"),
                    TD.GemmConfig(TFP32, None, "native"), None),
    "fdp91": (JD.FDP91.default, TD.FDP91.default, -30),
    "fixed_9_6_m20": (JD.GemmConfig(JFP32, JSpec(*SPEC_LOW), "simulate"),
                      TD.GemmConfig(TFP32, TSpec(*SPEC_LOW), "simulate"), SPEC_LOW[2]),
}


def _operands():
    """GEMMs at several scales: calibration-like, drifting high, tiny (the
    low side), one near msb. Values on a 1/8 grid times a power of two, so
    every native fp32 sum is exact whatever its order."""
    rng = np.random.default_rng(7)
    out = []
    for i, (scale_a, scale_b, shape) in enumerate((
            (1.0, 0.5, (2, 4, 8, 4)), (2.0 ** 6, 1.0, (4, 16, 8)),
            (2.0 ** -16, 2.0 ** -8, (4, 8, 4)), (0.25, 2.0, (3, 32, 5)))):
        if len(shape) == 4:
            a_shape, b_shape = shape[:3], shape[2:]
        else:
            a_shape, b_shape = shape[:2], shape[1:]
        a = rng.integers(-8, 9, a_shape).astype(np.float32) / 8 * scale_a
        b = rng.integers(-8, 9, b_shape).astype(np.float32) / 8 * scale_b
        if i == 0:
            a[0, 0, :] = 0.0                  # a zero row: the nonzero min skips it
        out.append((a, b))
    return out


def _envelope(lsb, msb):
    return {"version": 1, "sites": {
        "s1": {"a_exp": [-6, 1], "b_exp": [-5, 0], "out_exp": [None, None],
               "msb": msb, "lsb": lsb, "calls": 2, "max_k": 8},
        "s2": {"a_exp": [-3, 3], "b_exp": [-3, 3], "out_exp": [None, None],
               "msb": msb, "lsb": lsb, "calls": 2, "max_k": 16}}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_monitors_give_equal_snapshots_on_the_same_gemms(case):
    jcfg, tcfg, lsb = CASES[case]
    msb = tcfg.acc.msb if tcfg.acc is not None else 127
    env = _envelope(lsb, msb)
    jpol = JD.NumericsPolicy(jcfg, name=case)
    tpol = TD.NumericsPolicy(tcfg, name=case)
    jreg, treg = JRegistry(), Registry()
    jmon = JM.NumericsMonitor(env, registry=jreg)
    tmon = NumericsMonitor(env, registry=treg)
    sites = ("s1", "s2", "s1", "s3")          # s3: no envelope entry
    with jmon, tmon:
        for site, (a, b) in zip(sites, _operands()):
            jax.block_until_ready(JD.gemm(jnp.asarray(a), jnp.asarray(b), site=site,
                                          policy=jpol))
            TD.gemm(torch.from_numpy(a), torch.from_numpy(b), site=site, policy=tpol)
    jsnap, tsnap = jmon.snapshot(), tmon.snapshot()
    assert json.dumps(tsnap, sort_keys=True) == json.dumps(jsnap, sort_keys=True)
    assert treg.snapshot_json() == jreg.snapshot_json()
    s1 = tsnap["sites"]["s1"]
    if lsb is None:                           # native: smaller operands are harmless
        assert s1["status"] == INSIDE and s1["live"]["a_exp"][0] is None
    else:                                     # fixed point: the tiny call left the range
        assert s1["status"] == NEAR_EDGE and s1["live"]["a_exp"][0] == -19
    assert tsnap["sites"]["s3"]["status"] == UNMONITORED


def _replay_operands():
    """Three runs of five GEMMs on the same shapes: ``_operands()`` scaled by
    a power of two a run, and a fifth GEMM whose operands reach 2^70 in the
    second run only (a non-finite native output, an accumulator wrap)."""
    base = _operands() + [(np.full((4, 16), 0.5, np.float32), np.full((16, 8), 0.25,
                                                                         np.float32))]
    runs = []
    for r, scale in enumerate((1.0, 2.0 ** 3, 2.0 ** -2)):
        ops = [(a * np.float32(scale), b) for a, b in base[:-1]]
        big = np.float32(2.0 ** 70 if r == 1 else 1.0)
        ops.append((base[-1][0] * big, base[-1][1] * big))
        runs.append(ops)
    return runs


def _captured_runs(mon, sites, policy, runs):
    """Drive the captured-record path on the CPU as a CUDA graph's replays
    do: two warm-up calls (recording nothing), then the same body once a
    run against one set of rows, the k-th dispatch updating row k. On the
    CPU the capture pass executes, so it is the first run."""
    bufs = [(torch.zeros(a.shape), torch.zeros(b.shape)) for a, b in runs[0]]

    def body():
        for site, (a, b) in zip(sites, bufs):
            TD.gemm(a, b, site=site, policy=policy)

    def load(ops):
        for (ta, tb), (a, b) in zip(bufs, ops):
            ta.copy_(torch.from_numpy(a))
            tb.copy_(torch.from_numpy(b))

    load(runs[0])
    for _ in range(2):
        with mon.warmup():
            body()
    with mon.capture() as rec:
        body()
        rec.seal()
    for ops in runs[1:]:
        load(ops)
        with rec.recording():
            body()
            rec.seal()
    return rec


@pytest.mark.parametrize("case", sorted(CASES))
def test_captured_records_equal_the_reference_under_one_jit(case):
    """The captured-record path against ``repro.obs.monitor`` under one
    ``jax.jit`` executed three times (one trace) and against the port's own
    eager queue: equal snapshots and registries, as JSON, in every case of
    the parity test above, with a wrap and a non-finite output in one run."""
    jcfg, tcfg, lsb = CASES[case]
    msb = tcfg.acc.msb if tcfg.acc is not None else 127
    env = _envelope(lsb, msb)
    jpol = JD.NumericsPolicy(jcfg, name=case)
    tpol = TD.NumericsPolicy(tcfg, name=case)
    sites = ("s1", "s2", "s1", "s3", "s2")
    runs = _replay_operands()
    traces = []

    @jax.jit
    def step(*ops):
        traces.append(1)
        return [JD.gemm(ops[2 * i], ops[2 * i + 1], site=site, policy=jpol)
                for i, site in enumerate(sites)]

    jreg, treg, ereg = JRegistry(), Registry(), Registry()
    jmon = JM.NumericsMonitor(env, registry=jreg)
    with jmon:
        for ops in runs:
            jax.block_until_ready(step(*(jnp.asarray(x) for pair in ops for x in pair)))
    assert len(traces) == 1
    tmon = NumericsMonitor(env, registry=treg)
    with tmon:
        _captured_runs(tmon, sites, tpol, runs)
        assert tmon.folds == 0 and not tmon._queue
    emon = NumericsMonitor(env, registry=ereg)
    with emon:
        for ops in runs:
            for site, (a, b) in zip(sites, ops):
                TD.gemm(torch.from_numpy(a), torch.from_numpy(b), site=site, policy=tpol)
    jsnap = json.dumps(jmon.snapshot(), sort_keys=True)
    assert json.dumps(tmon.snapshot(), sort_keys=True) == jsnap
    assert json.dumps(emon.snapshot(), sort_keys=True) == jsnap
    assert treg.snapshot_json() == jreg.snapshot_json() == ereg.snapshot_json()
    live = tmon.snapshot()["sites"]["s2"]["live"]
    assert live["calls"] == 6 and live["wrap_events"] + live["nonfinite_events"] >= 1
    assert tmon.snapshot()["sites"]["s3"]["status"] == UNMONITORED
    assert tmon.folds == 1 and not tmon._captured   # at uninstall; the record was freed


def test_warmup_records_nothing():
    """A warm-up call records only its dispatches' static shapes: no scalar
    is computed or queued and nothing is folded, as the reference's
    ``.lower().compile()`` executes nothing."""
    reg = Registry()
    a, b = torch.ones((4, 8)), torch.ones((8, 4))
    with NumericsMonitor(_env(), registry=reg) as mon:
        with mon.warmup():
            TD.gemm(a, b, site="s")
            TD.gemm(a, b, site="s")
        assert not mon._queue and not mon._captured and mon.folds == 0
    assert mon.folds == 0 and mon.status("s")["live"] is None
    assert reg.counter("repro_monitor_calls_total", "", ("site",)).total() == 0
    assert [c.site for c in mon._tls.warm] == ["s", "s"]


def test_capture_the_monitor_cannot_record_raises(monkeypatch):
    """A captured body that dispatches otherwise than its warm-up raises, and
    so does a monitored dispatch under a capture the monitor was not told
    of: its queued scalars would be the capture pass's garbage."""
    a, b = torch.ones((4, 8)), torch.ones((8, 4))
    with NumericsMonitor(_env(), registry=Registry()) as mon:
        with mon.warmup():
            TD.gemm(a, b, site="s")
        with pytest.raises(RuntimeError, match="warm-up call dispatched"):
            with mon.capture():
                TD.gemm(a, b, site="other")
        with mon.warmup():
            TD.gemm(a, b, site="s")
            TD.gemm(a, b, site="s")
        with pytest.raises(RuntimeError, match="dispatched 1 GEMMs"):
            with mon.capture() as rec:
                TD.gemm(a, b, site="s")
                rec.seal()
        with pytest.raises(RuntimeError, match="needs a warm-up call"):
            with mon.capture():
                pass
        monkeypatch.setattr(TM, "capturing", lambda: True)
        with pytest.raises(RuntimeError, match="did not tell the monitor"):
            TD.gemm(a, b, site="s")
        assert not mon._captured and not mon._queue
    assert mon.status("s")["live"] is None


def test_captured_msb_capacity_is_the_last_replayed():
    """One site under two plans, captured in two records and replayed in
    turns, eager calls between them: ``msb_capacity`` is the last call's,
    as the eager order gives it, and a record freed before a fold keeps its
    calls."""
    import gc
    low = TD.NumericsPolicy(TD.GemmConfig(TFP32, TSpec(*SPEC_LOW), "simulate"), name="low")
    a, b = torch.full((4, 8), 0.5), torch.full((8, 4), 0.25)

    def body(pol):
        return lambda: TD.gemm(a, b, site="s", policy=pol)

    def capture(mon, fn):
        with mon.warmup():
            fn()
        with mon.capture() as rec:
            fn()
            rec.seal()
        return rec

    def replay(rec, fn):
        with rec.recording():
            fn()
            rec.seal()

    order = ("fdp", "low", "eager", "low", "fdp", "fdp", "low")
    pols = {"fdp": TD.FDP91, "low": low, "eager": TD.MXU_FP32}
    emon = NumericsMonitor(_env(), registry=Registry())
    with emon:
        for name in order:
            body(pols[name])()
    mon = NumericsMonitor(_env(), registry=Registry())
    with mon:
        recs = {n: capture(mon, body(pols[n])) for n in ("fdp", "low")}   # one call each
        for name in order[2:]:
            if name == "eager":
                body(pols[name])()
            else:
                replay(recs[name], body(pols[name]))
        assert mon.status("s")["live"]["msb_capacity"] == SPEC_LOW[1]
        replay(recs["fdp"], body(pols["fdp"]))
        del recs["fdp"]
        gc.collect()
    emon.install()
    with emon:
        body(TD.FDP91)()
    assert len(mon._captured) == 1            # the freed record left once folded
    assert json.dumps(mon.snapshot(), sort_keys=True) == \
        json.dumps(emon.snapshot(), sort_keys=True)
    assert mon.snapshot()["sites"]["s"]["live"]["msb_capacity"] == TD.FDP91.default.acc.msb


def test_paper_mlp_forward_statuses_equal_reference():
    """The reduced paper-mlp forward on carried weights under the zoo plan's
    envelope: the same status at every site, and the same calls."""
    jc, tc = jget("paper-mlp").reduced(), tget("paper-mlp").reduced()
    jp = JT.init(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    jplan = jload(os.path.join(PLANS_DIR, "paper_mlp.json"))
    tplan = tload(os.path.join(PLANS_DIR, "paper_mlp.json"))
    with JM.monitoring(jplan, registry=JRegistry()) as jmon:
        with JD.use_policy(jplan.to_policy()):
            jax.block_until_ready(JT.forward(jp, jc, {"tokens": jnp.asarray(toks)}))
    with monitoring(tplan, registry=Registry()) as tmon:
        with TD.use_policy(tplan.to_policy()), torch.no_grad():
            tforward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
    jst, tst = jmon.statuses(), tmon.statuses()
    assert set(tst) == set(jst)
    assert {s: i["status"] for s, i in tst.items()} == {s: i["status"] for s, i in jst.items()}
    assert {s: i["live"] and i["live"]["calls"] for s, i in tst.items()} == \
        {s: i["live"] and i["live"]["calls"] for s, i in jst.items()}
    assert tmon.worst_status() == jmon.worst_status()


# ---------------------------------------------------------------------------
# no host read per call
# ---------------------------------------------------------------------------
def test_hook_reads_nothing_back_per_call(monkeypatch):
    reads = []
    for name in ("item", "tolist", "cpu", "numpy", "__float__", "__bool__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    mon = NumericsMonitor(_env(lsb=-30), registry=Registry()).install()
    try:
        a, b = torch.ones((4, 8)), torch.ones((8, 4))
        for _ in range(5):
            mon.hook("s", TD.FDP91.default, a, b, a @ b)
        assert reads == [] and mon.folds == 0
        assert mon.status("s")["live"]["calls"] == 5      # one fold for five calls
        assert mon.folds == 1
        assert mon.status("s")["live"]["calls"] == 5 and mon.folds == 1
    finally:
        mon.uninstall()


def test_full_queue_folds_by_itself(monkeypatch):
    monkeypatch.setattr(TM, "FOLD_AT", 3)
    mon = NumericsMonitor(_env(), registry=Registry())
    a, b = torch.ones((4, 8)), torch.ones((8, 4))
    for _ in range(7):
        mon.hook("s", TD.MXU_FP32.default, a, b, a @ b)
    assert mon.folds == 2                     # at the 3rd and the 6th call
    assert mon.status("s")["live"]["calls"] == 7 and mon.folds == 3
