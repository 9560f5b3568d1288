"""The plan router of the port (``repro_torch.serving.router``) held against
``repro.serving.router``, and the reference's selection, bucket and
manifest cases (``tests/test_routed_serving.py``) run against the port.

For every architecture of the checked-in MANIFEST, ``from_manifest`` of both
packages (with the derived fdp91/repro variants) gives the same plans in
order with the same evidence (energies within a relative 1e-12: the repro
variant's comes from each package's ``gemm_power``), and ``route`` over the
three classes and every explicit name, under every ``min_bits`` and
``bit_stable`` constraint, picks the same plan or fails with the same
``RoutingError.reason``.
"""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro.serving import router as JR  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dispatch import FDP91  # noqa: E402
from repro_torch.core.accumulator import AccumulatorSpec  # noqa: E402
from repro_torch.models import init  # noqa: E402
from repro_torch.serving import (AdmissionError, Bucket, BucketedEnginePool,  # noqa: E402
                                 PlanRouter, RoutedPlan, RoutingError, parse_buckets,
                                 routed_plan_from_entry)
from repro_torch.serving import router as TR  # noqa: E402

torch.set_num_threads(1)

PLANS_DIR = os.path.join(os.path.dirname(__file__), "..", "examples", "plans")
with open(os.path.join(PLANS_DIR, "MANIFEST.json")) as _f:
    MANIFEST = json.load(_f)
ARCHS = sorted({e["arch"] for e in MANIFEST["plans"].values()})
MIN_BITS = (None, 10, 20, 21.1, 53, 99)


def _evidence(p):
    return (p.name, p.arch, p.scores, p.passed, p.validated_bits, p.repro_certified,
            p.derived, p.path and os.path.basename(p.path))


def test_constants_equal_reference():
    assert (TR.WORKLOAD_CLASSES, TR.FDP_CAP_BITS, TR.REPRO_CERT_BITS) == \
        (JR.WORKLOAD_CLASSES, JR.FDP_CAP_BITS, JR.REPRO_CERT_BITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_from_manifest_equals_reference(arch):
    jr = JR.PlanRouter.from_manifest(PLANS_DIR, arch=arch, derive=True)
    tr = PlanRouter.from_manifest(PLANS_DIR, arch=arch, derive=True)
    assert tr.names() == jr.names() and len(tr.names()) == 3
    for tp, jp in zip(tr.plans, jr.plans):
        assert _evidence(tp) == _evidence(jp)
        assert tp.energy == pytest.approx(jp.energy, rel=1e-12)
    base, wide, stable = tr.plans
    jstable = jr.plans[2].policy().default
    assert wide.policy() is FDP91 and FDP91.default.mode == "simulate"
    cfg = stable.policy().default
    assert (cfg.fmt.name, cfg.acc, cfg.mode) == \
        (jstable.fmt.name, AccumulatorSpec.paper_91bit(), "simulate")
    assert stable.policy().name == jr.plans[2].policy().name
    assert base.policy().default.tag() == jr.plans[0].policy().default.tag()


def _outcome(router, Error, workload, **kw):
    try:
        return ("plan", router.route(workload, **kw).name)
    except Error as e:
        return ("error", e.workload, e.reason)


@pytest.mark.parametrize("arch", ARCHS)
def test_routes_equal_reference(arch):
    jr = JR.PlanRouter.from_manifest(PLANS_DIR, arch=arch)
    tr = PlanRouter.from_manifest(PLANS_DIR, arch=arch)
    n = 0
    for workload in (*TR.WORKLOAD_CLASSES, *tr.names(), "no-such-class"):
        for min_bits in MIN_BITS:
            for bit_stable in (False, True):
                kw = dict(min_bits=min_bits, bit_stable=bit_stable)
                assert _outcome(tr, RoutingError, workload, **kw) == \
                    _outcome(jr, JR.RoutingError, workload, **kw), (workload, kw)
                n += 1
    assert n == (3 + 3 + 1) * len(MIN_BITS) * 2


# ---------------------------------------------------------------------------
# the reference's selection cases over synthetic evidence, against the port
# ---------------------------------------------------------------------------
def _plan(name, energy, *, solve=None, repro=None, passed=True, bits=20.0, certified=False):
    scores, ok = {"logits": bits}, {"logits": passed}
    if solve is not None:
        scores["solve"], ok["solve"] = solve, passed
    if repro is not None:
        scores["repro"], ok["repro"] = repro, passed
    return RoutedPlan(name=name, scores=scores, passed=ok, energy=energy,
                      validated_bits=bits, repro_certified=certified, loader=lambda: FDP91)


@pytest.fixture
def router():
    return PlanRouter([
        _plan("cheap", 0.2, solve=18.0, bits=16.0),
        _plan("mid", 0.5, solve=30.0, repro=51.0, bits=24.0, certified=True),
        _plan("wide", 1.0, solve=53.0, repro=53.0, bits=53.0, certified=True),
        _plan("broken", 0.1, solve=40.0, bits=10.0, passed=False),
    ])


@pytest.mark.parametrize("workload,kw,want", [
    ("chat", {}, "cheap"),                    # "broken" is cheaper but failed
    ("solve", {}, "wide"),                    # highest solve score, energy aside
    ("repro", {}, "mid"),                     # cheapest certified
    ("wide", {}, "wide"),                     # an explicit name wins
    ("chat", {"min_bits": 20.0}, "mid"),
    ("chat", {"min_bits": 40.0}, "wide"),
    ("chat", {"bit_stable": True}, "mid"),
], ids=["chat_cheapest_passing", "solve_highest_score", "repro_certified_only",
        "explicit_name_wins", "min_bits_20", "min_bits_40", "bit_stable"])
def test_selection(router, workload, kw, want):
    assert router.route(workload, **kw).name == want


@pytest.mark.parametrize("workload,kw,match", [
    ("chat", {"min_bits": 99.0}, "99"),
    ("cheap", {"bit_stable": True}, "repro-certified"),
    ("no-such-class-or-plan", {}, "unknown workload class"),
], ids=["min_bits", "explicit_name_unmet", "unknown"])
def test_unsatisfiable_raises_typed(router, workload, kw, match):
    with pytest.raises(RoutingError) as ei:
        router.route(workload, **kw)
    assert ei.value.workload == workload and match in ei.value.reason


@pytest.mark.parametrize("plans,match", [
    (lambda: [_plan("chat", 0.5)], "shadows"),
    (lambda: [_plan("a", 0.5), _plan("a", 0.6)], "duplicate"),
    (lambda: [], "at least one"),
], ids=["shadows", "duplicate", "empty"])
def test_router_rejects_bad_names(plans, match):
    with pytest.raises(ValueError, match=match):
        PlanRouter(plans())


def test_plan_without_policy_source_raises():
    with pytest.raises(RoutingError, match="no policy source"):
        RoutedPlan(name="bare").policy()


def test_synthetic_manifest_roundtrip(tmp_path):
    man = {"plans": {
        "good": {"arch": "x", "file": "good.json", "energy_vs_baseline": 0.3,
                 "validated_bits": 22.0,
                 "validation": {"logits": {"score": 22.0, "passed": True}}},
        "no-scores": {"arch": "x", "energy_vs_baseline": 0.3, "validation": {}},
        "bad-energy": {"arch": "x", "energy_vs_baseline": "cheap",
                       "validation": {"logits": {"score": 9.0, "passed": True}}},
    }}
    (tmp_path / "MANIFEST.json").write_text(json.dumps(man))
    ok = routed_plan_from_entry("good", man["plans"]["good"], str(tmp_path))
    assert ok.scores["logits"] == 22.0 and ok.path.endswith("good.json")
    with pytest.raises(ValueError, match="no validation"):
        routed_plan_from_entry("no-scores", man["plans"]["no-scores"], str(tmp_path))
    with pytest.raises(ValueError, match="energy_vs_baseline"):
        routed_plan_from_entry("bad-energy", man["plans"]["bad-energy"], str(tmp_path))
    with pytest.raises(RoutingError, match="no MANIFEST entry"):
        PlanRouter.from_manifest(tmp_path, arch="unknown-arch", derive=False)


def test_zoo_manifest_distinct_plans_per_class():
    r = PlanRouter.from_manifest(PLANS_DIR, arch="paper-mlp")
    picks = {wl: r.route(wl).name for wl in ("chat", "solve", "repro")}
    assert len(set(picks.values())) == 3
    assert r.route("solve").scores["solve"] >= 53.0
    assert r.route("repro").repro_certified
    assert r.route("repro").energy < 1.0


def test_hand_built_plan_routes_like_a_manifest_entry():
    """A RoutedPlan with a loader and measured evidence (how a kernel policy
    joins the zoo's plans) is picked by the evidence alone."""
    zoo = PlanRouter.from_manifest(PLANS_DIR, arch="qwen3-0.6b", derive=False).plans
    kernel = RoutedPlan(name="fdp91_kernel", arch="qwen3-0.6b",
                        scores={"solve": 53.0, "repro": 53.0, "logits": 53.0},
                        passed={"solve": True, "repro": True, "logits": True},
                        energy=1.0, validated_bits=53.0, repro_certified=True,
                        loader=lambda: FDP91)
    r = PlanRouter([*zoo, kernel])
    assert r.route("solve").name == "fdp91_kernel"
    assert r.route("repro").name == "fdp91_kernel"
    assert r.route("chat").name == zoo[0].name
    assert r.route("chat", min_bits=30).name == "fdp91_kernel"


# ---------------------------------------------------------------------------
# buckets
# ---------------------------------------------------------------------------
def test_parse_buckets_sorted_dedup():
    bs = parse_buckets("4x64, 2x32, 4x64")
    assert [b.label for b in bs] == ["2x32", "4x64"]
    assert bs[0].capacity == 31
    with pytest.raises(ValueError, match="degenerate"):
        Bucket(max_len=2, n_slots=1)


@pytest.mark.parametrize("prompt,new,want", [(10, 8, "2x32"), (30, 8, "4x64"), (60, 8, None)],
                         ids=["small", "large", "too_long"])
def test_bucket_for_smallest_fit(prompt, new, want):
    cfg = get_config("paper-mlp").reduced()
    pool = BucketedEnginePool(cfg, init(cfg, seed=0, device="cpu"), "2x32,4x64")
    if want is None:
        with pytest.raises(AdmissionError, match="largest bucket"):
            pool.bucket_for(prompt, new)
    else:
        assert pool.bucket_for(prompt, new).label == want
    assert pool.live() == {}                  # engines are lazy


def test_pool_refuses_unknown_method_and_bucket():
    cfg = get_config("paper-mlp").reduced()
    pool = BucketedEnginePool(cfg, init(cfg, seed=0, device="cpu"), "2x16")
    plan = _plan("p", 1.0)
    with pytest.raises(ValueError, match="unknown method"):
        pool.get(plan, pool.buckets[0], "train")
    with pytest.raises(ValueError, match="not in this pool"):
        pool.get(plan, Bucket(max_len=64, n_slots=2), "generate")
    with pytest.raises(ValueError, match="at least one bucket"):
        BucketedEnginePool(cfg, pool.params, ())
