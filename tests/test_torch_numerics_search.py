"""Candidates and search in the port against ``repro.numerics.candidates``
and ``repro.numerics.search``, from the checked-in calibration traces: the
candidate grids of every site of every trace; the scores, frontiers and
picks at each trace's first forward, first backward and first aux site; a
whole forward search of the qwen3-0.6b and dbrx-132b traces; the ``validate=``
upgrade loop; plan interchange; and a CPU end-to-end run (calibrate a
reduced qwen3-0.6b, search the FDP-only grid in ``simulate``, save the plan,
serve it). Every port call runs with ``device="cpu"``.

Tolerances, and why:
- FDP candidates: ``error_bits`` and ``energy_j`` exactly equal. The FDP is
  bit-exact in both packages, the oracle too, and the median of equal
  arrays is equal.
- Native candidates: ``error_bits`` within 1.2 bits. Both are f32 matmuls
  of the same sample that sum the same exact products in different orders:
  the port's CPU matmul as one fused multiply-add chain over k, XLA:CPU as
  four interleaved chains added pairwise, each reproduced bit for bit
  (``test_native_gap_is_the_summation_order``). The measured gaps are 1.09
  bits (mamba2's ``lm_head@bwd.dA``, K = 256, where those orders alone span
  22.11-23.75 bits), 0.30, 0.28 and 0.09; every other native score is
  equal.
- Aux (block-scaled) candidates: ``error_bits`` within 0.01 bits. The
  reference's ``jnp.exp2`` is inexact on XLA:CPU away from exponent 0
  (ROADMAP section 3), the port's powers of two are exact.
- Picks, chosen indices, the plans' tags, modeled energies and envelopes:
  exactly equal. A pick that flips is a fault, not a tolerance.
- Frontiers: exactly equal, except where a native score moved across an
  FDP one. Every frontier must equal the reference's recomputed with the
  port's native scores, and the sites where that changes the frontier are
  listed (``NATIVE_FRONTIER_DIFFS``, ROADMAP section 3).

Modelled on ``tests/test_numerics_search.py`` and
``tests/test_numerics_serve.py``."""

import dataclasses
import glob
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import numerics as JN  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core.formats import BF16, FP32  # noqa: E402
from repro_torch.core.metrics import correct_bits  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import init  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402

torch.set_num_threads(1)

# the modules (the packages export the function ``search`` under that name)
JS = importlib.import_module("repro.numerics.search")
TSR = importlib.import_module("repro_torch.numerics.search")

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
TRACES = sorted(glob.glob(os.path.join(ROOT, "examples", "plans", "traces",
                                       "*.trace.json")))
TRACE_OF = {os.path.basename(p).split(".")[0]: p for p in TRACES}
BUDGET, MARGIN = 10.0, 2.0
NATIVE_BITS_TOL, QUANT_BITS_TOL = 1.2, 0.01
# (trace, site) where the port's native fp32 score sits below an FDP point
# that the reference's dominates: one more frontier point, past the pick
NATIVE_FRONTIER_DIFFS = {("whisper_large_v3", "attn_av@bwd.dA")}
GRID = dict(widths=(32,))          # the reference's grid for reduced traces
WIDE_GRID = (16, 32, 64, 2048)


def _spec(s):
    return (s.ovf, s.msb, s.lsb, s.round_mode, s.overflow_mode)


def _report(r):
    d = dataclasses.asdict(r)
    d["spec"] = _spec(r.spec)
    return d


def _load(path):
    return JN.load_trace(path), TN.load_trace(path)


@pytest.mark.parametrize("path", TRACES, ids=os.path.basename)
def test_enumerate_candidates_equal(path):
    jt, tt = _load(path)
    for site in jt.sites("fwd") + jt.sites("bwd"):
        for widths in (JN.candidates.DEFAULT_WIDTHS, WIDE_GRID):
            want = JN.enumerate_candidates(jt.profile(site), widths=widths)
            got = TN.enumerate_candidates(tt.profile(site), widths=widths)
            assert [c.tag for c in got] == [c.tag for c in want], site
            assert [_report(c.report) for c in got] == [_report(c.report) for c in want]
            assert [c.watts for c in got] == [c.watts for c in want]
    for site in jt.aux_sites():
        want = JN.enumerate_quant_candidates(jt.profile(site))
        got = TN.enumerate_quant_candidates(tt.profile(site))
        assert [(c.tag, c.bytes_total) for c in got] == [(c.tag, c.bytes_total) for c in want]


def test_posit_formats_are_refused():
    from repro_torch.core.formats import POSIT16_1
    prof = TN.load_trace(TRACE_OF["qwen3_0p6b"]).profile("attn_q")
    with pytest.raises(ValueError, match="not searchable yet"):
        TN.enumerate_candidates(prof, formats=(POSIT16_1,))


def _assert_scores_equal(got, want, quant=False):
    assert [e.candidate.tag for e in got] == [e.candidate.tag for e in want]
    for g, w in zip(got, want):
        assert g.energy_j == w.energy_j and g.bytes_total == w.bytes_total
        if quant:
            assert abs(g.error_bits - w.error_bits) <= QUANT_BITS_TOL, g.candidate.tag
        elif g.cfg.mode == "native":
            assert abs(g.error_bits - w.error_bits) <= NATIVE_BITS_TOL, g.candidate.tag
        else:
            assert g.error_bits == w.error_bits, g.candidate.tag


def _chosen(frontier, target):
    return next((i for i, p in enumerate(frontier) if p.error_bits >= target),
                len(frontier) - 1)


def _tags(points):
    return [e.candidate.tag for e in points]


def _assert_frontier_and_pick_equal(got, want, target, where):
    """The port's frontier and pick from its scores against the reference's
    (module docstring: frontiers may differ only by native scores)."""
    tf, jf = TN.pareto_frontier(got), JN.pareto_frontier(want)
    swapped = [dataclasses.replace(w, error_bits=g.error_bits) if w.cfg.mode == "native"
               else w for g, w in zip(got, want)]
    assert _tags(tf) == _tags(JN.pareto_frontier(swapped)), where
    assert _tags(tf) == _tags(jf) or where in NATIVE_FRONTIER_DIFFS, where
    assert _chosen(tf, target) == _chosen(jf, target), where
    assert tf[_chosen(tf, target)].candidate.tag == jf[_chosen(jf, target)].candidate.tag


@pytest.mark.parametrize("path", TRACES, ids=os.path.basename)
def test_evaluate_frontier_and_pick_equal(path):
    jt, tt = _load(path)
    name = os.path.basename(path).split(".")[0]
    for site in (jt.sites("fwd")[0], jt.sites("bwd")[0]):
        jp, tp = jt.profile(site), tt.profile(site)
        want = JN.evaluate_candidates(jp, JN.enumerate_candidates(jp, **GRID))
        got = TN.evaluate_candidates(tp, TN.enumerate_candidates(tp, **GRID), device="cpu")
        _assert_scores_equal(got, want)
        _assert_frontier_and_pick_equal(got, want, BUDGET + MARGIN, (name, site))
    for site in jt.aux_sites()[:1]:
        jp, tp = jt.profile(site), tt.profile(site)
        want = JN.evaluate_quant_candidates(jp, JN.enumerate_quant_candidates(jp))
        got = TN.evaluate_quant_candidates(tp, TN.enumerate_quant_candidates(tp))
        _assert_scores_equal(got, want, quant=True)
        assert TSR.AUX_TARGET_BITS == JS.AUX_TARGET_BITS
        _assert_frontier_and_pick_equal(got, want, JS.AUX_TARGET_BITS, (name, site))


# the sites of the compared set where a native score differs from the
# reference's
NATIVE_GAP_SITES = [("mamba2_1p3b", "lm_head"), ("mamba2_1p3b", "lm_head@bwd.dA"),
                    ("whisper_large_v3", "attn_av"), ("whisper_large_v3", "attn_av@bwd.dA")]
FMA_LANES = (1, 2, 4, 8, 16)


def _fma_chains(a, b, lanes):
    """``a @ b`` summed as ``lanes`` fused multiply-add chains, chain l over
    the k with k % lanes == l, the chains then added pairwise: each product
    is exact (24 + 24 bits in an f64) and only the running f32 sum rounds."""
    prods = a.astype(np.float64)[:, :, None] * b.astype(np.float64)[None]
    chains = []
    for lane in range(lanes):
        acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
        for k in range(lane, a.shape[1], lanes):
            acc = (acc + prods[:, k]).astype(np.float32)
        chains.append(acc)
    while len(chains) > 1:
        chains = [chains[i] + chains[i + 1] for i in range(0, len(chains), 2)]
    return chains[0]


@pytest.mark.parametrize("name,site", NATIVE_GAP_SITES)
def test_native_gap_is_the_summation_order(name, site):
    """Where the port's native fp32 score differs from the reference's, each
    package's output is, bit for bit, the same exact products summed in one
    of the FMA chain orders, and the scores of those orders span the gap: the
    difference is the summation order, not the operands or the config."""
    jt, tt = _load(TRACE_OF[name])
    jp, tp = jt.profile(site), tt.profile(site)
    [jc] = [c for c in JN.enumerate_candidates(jp, **GRID)
            if c.cfg.mode == "native" and c.cfg.fmt.name == "ieee_fp32"]
    [tc] = [c for c in TN.enumerate_candidates(tp, **GRID) if c.tag == jc.tag]
    a, b = tp.sample_a.astype(np.float32), tp.sample_b.astype(np.float32)
    port = TSR._apply_cfg(tc.cfg, torch.from_numpy(a), torch.from_numpy(b), site).numpy()
    ref = np.asarray(JS._apply_cfg(jc.cfg, a, b, site))
    oracle = TSR.oracle_output(tp, torch.from_numpy(a), torch.from_numpy(b))

    def bits(out):
        return float(np.median(correct_bits(out, oracle, cap=TSR.ERROR_CAP_BITS)))

    orders = {lanes: _fma_chains(a, b, lanes) for lanes in FMA_LANES}
    port_lanes = [n for n, out in orders.items() if np.array_equal(out, port)]
    ref_lanes = [n for n, out in orders.items() if np.array_equal(out, ref)]
    assert port_lanes and ref_lanes and port_lanes != ref_lanes, (port_lanes, ref_lanes)
    [got] = TN.evaluate_candidates(tp, [tc], device="cpu")
    [want] = JN.evaluate_candidates(jp, [jc])
    assert got.error_bits == bits(port) and want.error_bits == bits(ref)
    scores = [bits(out) for out in orders.values()]
    gap = abs(got.error_bits - want.error_bits)
    assert 0 < gap <= max(scores) - min(scores) and gap <= NATIVE_BITS_TOL, (gap, scores)


# ---------------------------------------------------------------------------
# whole searches
# ---------------------------------------------------------------------------
FWD_GRID = dict(phases=("fwd",), **GRID)


@pytest.fixture(scope="module")
def fwd_searches():
    """The reference's forward search of the qwen3 and dbrx traces, once."""
    return {name: JN.search(JN.load_trace(TRACE_OF[name]), BUDGET, name=name, **FWD_GRID)
            for name in ("qwen3_0p6b", "dbrx_132b")}


def _site_rows(plan):
    return [(s.site, s.kind, s.cfg.tag(), s.macs, s.energy_j, s.latency_us, s.bytes_total)
            for s in plan.sites]


def _assert_plans_equal(got, want):
    assert _site_rows(got) == _site_rows(want)
    for g, w in zip(got.sites, want.sites):
        tol = (QUANT_BITS_TOL if g.kind != "gemm"
               else NATIVE_BITS_TOL if g.cfg.mode == "native" else 0.0)
        assert abs(g.error_bits - w.error_bits) <= tol, g.site
    assert got.default.tag() == want.default.tag()
    assert got.bwd_default.tag() == want.bwd_default.tag()
    assert got.budget_bits == want.budget_bits and got.name == want.name
    assert got.meta == want.meta            # energies, fingerprint, envelope


@pytest.mark.parametrize("name", ["qwen3_0p6b", "dbrx_132b"])
def test_forward_search_matches_the_reference(fwd_searches, name, tmp_path):
    want = fwd_searches[name]
    got = TN.search(TN.load_trace(TRACE_OF[name]), BUDGET, name=name, device="cpu",
                    **FWD_GRID)
    assert sorted(got.decisions) == sorted(want.decisions)
    for site, d in got.decisions.items():
        w = want.decisions[site]
        assert _tags(d.frontier) == _tags(w.frontier), site
        assert d.chosen == w.chosen, site
    _assert_plans_equal(got.plan, want.plan)
    assert got.validated_bits is None and got.reports is None
    assert "precision plan" in got.describe()
    # the port's plan reloads in both packages to the same configs
    path = tmp_path / "plan.json"
    got.plan.save(path)
    jpol, tpol = JN.load_plan(path).to_policy(), TN.load_plan(path).to_policy()
    gemm_sites = [s.site for s in got.plan.gemm_sites()]
    for site in gemm_sites + [f"{s}@bwd.dA" for s in gemm_sites]:
        assert tpol.lookup(site).tag() == jpol.lookup(site).tag() == \
            got.plan.to_policy().lookup(site).tag()
    assert tpol.aux == got.plan.to_policy().aux and len(tpol.aux) == len(jpol.aux)


def _subtrace(package, path, sites):
    full = package.load_trace(path)
    tr = package.trace.CalibrationTrace()
    tr.fingerprint, tr.meta = full.fingerprint, full.meta
    tr._profiles = {s: full.profile(s) for s in sites}
    return tr


def test_validate_upgrade_loop_matches_the_reference():
    """One scripted validator drives the legacy upgrade loop: both packages
    see the same policies and make the same upgrades."""
    sites = ("attn_q", "attn_qk", "mlp_in")
    script = [4.0, 6.0, 8.0, 9.5, 11.0]

    def validator(seen):
        def validate(policy):
            seen.append(tuple(policy.lookup(s).tag() for s in sites))
            return script[min(len(seen) - 1, len(script) - 1)]
        return validate

    seen_j, seen_t = [], []
    # FDP candidates only: the loop upgrades the weakest pick, and native
    # scores differ between the packages by summation order
    kw = dict(phases=("fwd",), margin_bits=-4.0, max_upgrades=3, include_native=False,
              **GRID)
    want = JN.search(_subtrace(JN, TRACE_OF["qwen3_0p6b"], sites), BUDGET,
                     validate=validator(seen_j), **kw)
    got = TN.search(_subtrace(TN, TRACE_OF["qwen3_0p6b"], sites), BUDGET,
                    validate=validator(seen_t), device="cpu", **kw)
    assert seen_t == seen_j and len(seen_t) == 4          # max_upgrades + 1 calls
    assert len(set(seen_t)) == 4                          # every call upgraded a site
    assert got.validated_bits == want.validated_bits == 9.5
    _assert_plans_equal(got.plan, want.plan)


def test_validators_are_refused():
    """Validators with the legacy hook are refused; alone they drive the
    loop (``test_torch_workloads_search.py`` holds it to the reference)."""
    tr = _subtrace(TN, TRACE_OF["qwen3_0p6b"], ("attn_q",))
    with pytest.raises(ValueError, match="not both"):
        TN.search(tr, BUDGET, validators=[object()], validate=lambda p: 0.0, device="cpu")
    from repro_torch.workloads import WorkloadContext, build_validators
    res = TN.search(tr, BUDGET, include_native=False, device="cpu", **GRID,
                    validators=build_validators(["repro"], WorkloadContext(device="cpu")))
    assert res.plan.meta["validation"]["repro"]["score"] == 53.0
    assert res.plan.meta["validation_upgrades"] == [] and res.validated_bits is None


def test_search_refuses_tf32_on_a_card():
    cuda = torch.device("cuda")
    TSR._check_full_fp32(cuda)                             # the port pins TF32 off
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            TSR._check_full_fp32(cuda)
        TSR._check_full_fp32(torch.device("cpu"))         # no cuBLAS on the CPU
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    prec = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="highest"):
            TSR._check_full_fp32(cuda)
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cuda.matmul.allow_tf32 = prev
    if not torch.cuda.is_available():
        # the entry point defaults to the card, and never falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TN.search(TN.load_trace(TRACE_OF["paper_mlp"]), BUDGET)


def test_default_fdp_mode_is_the_kernel_on_a_card():
    """A search left at its default scores FDP candidates through the dense
    kernel on a card, so its plan deploys the kernel; on the CPU, the plain
    version (the end-to-end test below searches there at the default)."""
    assert TSR._default_fdp_mode(torch.device("cuda")) == "pallas"
    assert TSR._default_fdp_mode(torch.device("cuda", 0)) == "pallas"
    assert TSR._default_fdp_mode(torch.device("cpu")) == "simulate"
    tr = _subtrace(TN, TRACE_OF["qwen3_0p6b"], ("attn_q",))
    res = TN.search(tr, BUDGET, include_native=False, device="cpu", **GRID)
    assert {e.cfg.mode for e in res.decisions["attn_q"].frontier} == {"simulate"}


def test_latency_column_is_measured_and_on_the_frontier():
    prof = TN.load_trace(TRACE_OF["qwen3_0p6b"]).profile("attn_q")
    cands = TN.enumerate_candidates(prof, formats=(FP32,), widths=(32,))
    ev = TN.evaluate_candidates(prof, cands, measure_latency=True, device="cpu")
    assert all(e.latency_us is not None and e.latency_us > 0 for e in ev)
    assert TN.pareto_frontier(ev)


# ---------------------------------------------------------------------------
# CPU end to end: calibrate -> search -> save -> serve
# ---------------------------------------------------------------------------
def test_calibrate_search_save_serve_on_the_cpu(tmp_path):
    cfg = tget("qwen3-0.6b").reduced(n_kv_heads=2)
    params = init(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(43)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))) for k in
             ("tokens", "targets")}
    with TN.calibrate() as trace, TD.use_policy(TD.MXU_FP32):
        with torch.no_grad():
            TT.forward(params, cfg, {"tokens": batch["tokens"]}, remat="none")
        loss, _ = TL.make_loss_fn(cfg, remat="none")(params, batch)
        loss.backward()
    trace_path = tmp_path / "qwen.trace.json"
    trace.save(trace_path, fingerprint=TN.config_fingerprint(cfg), meta={"batch": 2, "seq": 8})
    loaded = TN.load_trace(trace_path, expect_fingerprint=TN.config_fingerprint(cfg))
    res = TN.search(loaded, BUDGET, name="qwen-cpu", formats=(FP32, BF16),
                    widths=(24, 40, 64), include_native=False, device="cpu")
    assert len(res.plan.sites) == 30 and res.plan.meta["envelope"]["traced_tokens"] == 16
    assert all(s.cfg.mode == "simulate" for s in res.plan.sites)
    assert res.plan.meta["modeled_energy_j"] <= res.plan.meta["baseline_energy_j"]
    plan_path = tmp_path / "qwen.plan.json"
    res.plan.save(plan_path)
    policy = TD.policy_from_plan(plan_path)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 4)))
    with torch.no_grad():
        with TD.use_policy(policy):
            toks = TS.serve(cfg, params, prompts, 3, device="cpu")
            got = TT.forward(params, cfg, {"tokens": prompts})
        with TD.use_policy(TD.FDP91):
            ref = TT.forward(params, cfg, {"tokens": prompts})
    assert toks.shape == (2, 3)
    bits = float(np.median(correct_bits(got[..., :cfg.vocab_size],
                                        ref[..., :cfg.vocab_size], cap=24)))
    assert bits >= BUDGET, bits
