"""``search(validators=...)`` in the port against ``repro.numerics.search``
with ``repro.workloads``: the same trace, the reference's seeded parameters
and probe batches carried across, the same validators. The port makes the
reference's upgrades, in the reference's order, and the same picks; its
plan records the reports it was accepted on, and they reproduce against the
shipped (saved and reloaded) policy. Every port call runs on the CPU.

The trace is five backward sites of the checked-in
``examples/plans/traces/paper_mlp.trace.json`` over the FDP-only grid
(``widths=(32,)``, the reference test's), the plan's default native fp32,
the validators' thresholds 14 bits (the search's budget 10): the grad
workload then fails at first and drives four ``@bwd`` upgrades. The whole
trace drives 16 in both packages, but costs the reference ~520 s on the CPU
(~20 s a validation round: its eager gradient retraces the layer scan),
against ~30 s for the port.

Tolerances, and why: scores within 1.0 bit of the reference's, as in
``tests/_torch_workload_models.py`` (elementwise ops differ by ulps between
the packages); upgrades, picks and report keys equal. Modelled on
``tests/test_workloads.py::test_search_with_validators_upgrades_bwd_sites_and_records_reports``."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.workloads as JW  # noqa: E402
import repro_torch.workloads as TW  # noqa: E402
from repro import numerics as JN  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

TRACE = os.path.join(os.path.dirname(__file__), os.pardir, "examples", "plans", "traces",
                     "paper_mlp.trace.json")
SITES = ("attn_o@bwd.dA", "attn_v@bwd.dA", "mlp_out@bwd.dA", "lm_head@bwd.dB",
         "attn_qk@bwd.dA")
BUDGET, THRESHOLD, BITS_TOL = 10.0, 14.0, 1.0
GRID = dict(widths=(32,), include_native=False, phases=("fwd", "bwd"))


def _subtrace(package, sites):
    full = package.load_trace(TRACE)
    tr = package.trace.CalibrationTrace()
    tr.fingerprint, tr.meta = full.fingerprint, full.meta
    tr._profiles = {s: full.profile(s) for s in sites}
    return tr


@pytest.fixture(scope="module")
def searched():
    jctx = JW.WorkloadContext.for_model(jget("paper-mlp").reduced(), budget_bits=THRESHOLD,
                                        seed=0)
    cfg = tget("paper-mlp").reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jctx.params), cfg, device="cpu")
    conv = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    tctx = TW.WorkloadContext(budget_bits=THRESHOLD, cfg=cfg, params=params,
                              batch=conv(jctx.batch), grad_batch=conv(jctx.grad_batch),
                              seed=0, device="cpu")
    jv = JW.build_validators(["grad", "logits"], jctx)
    tv = TW.build_validators(["grad", "logits"], tctx)
    want = JN.search(_subtrace(JN, SITES), BUDGET, name="wl-test", validators=jv,
                     default=JD.GemmConfig(jfmt.FP32, None, "native"), **GRID)
    got = TN.search(_subtrace(TN, SITES), BUDGET, name="wl-test", validators=tv,
                    default=TD.GemmConfig(tfmt.FP32, None, "native"), device="cpu", **GRID)
    return want, got, tv


def test_validated_search_matches_the_reference(searched):
    want, got, _ = searched
    upgrades = got.plan.meta["validation_upgrades"]
    assert upgrades == want.plan.meta["validation_upgrades"]
    assert len(upgrades) == 4 and all("@bwd" in s for s in upgrades)
    assert [(s.site, s.cfg.tag()) for s in got.plan.sites] == \
        [(s.site, s.cfg.tag()) for s in want.plan.sites]
    assert {s: d.chosen for s, d in got.decisions.items()} == \
        {s: d.chosen for s, d in want.decisions.items()}
    tval, jval = got.plan.meta["validation"], want.plan.meta["validation"]
    assert set(tval) == set(jval) == {"grad", "logits"}
    for name in tval:
        assert tval[name].keys() == jval[name].keys()
        assert tval[name]["details"].keys() == jval[name]["details"].keys()
        assert abs(tval[name]["score"] - jval[name]["score"]) <= BITS_TOL
        assert tval[name]["passed"] == jval[name]["passed"]
    assert got.reports["grad"].passed and got.reports["logits"].passed
    assert got.plan.meta["validated_bits"] == got.reports["logits"].score
    assert got.validated_bits == got.reports["logits"].score
    text = got.describe()
    assert "workload grad" in text and "validator-driven upgrades: " + upgrades[0] in text


def test_recorded_evidence_reproduces_against_the_shipped_policy(searched, tmp_path):
    _, got, validators = searched
    path = tmp_path / "plan.json"
    got.plan.save(path)
    policy = TN.load_plan(path).to_policy()
    for v in validators:
        assert v.run(policy).to_json() == got.plan.meta["validation"][v.name], v.name


def test_search_rejects_both_validation_flavors():
    with pytest.raises(ValueError, match="not both"):
        TN.search(_subtrace(TN, SITES[:1]), BUDGET, validate=lambda p: 24.0,
                  validators=TW.build_validators(["repro"], TW.WorkloadContext(device="cpu")),
                  device="cpu")
