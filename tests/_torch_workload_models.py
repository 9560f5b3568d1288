"""The model-bound workloads (``logits``, ``grad``) in the port against
``repro.workloads``, shared by ``test_torch_workloads_models.py`` (reduced
paper-mlp) and ``test_torch_workloads_qwen.py`` (reduced qwen3-0.6b): each
test file defines the ``arch`` fixture and star-imports this module. The
reference's context (its seeded parameters and probe batches) is carried
across: parameters by ``params_from_numpy``, batches as tensors. Every port
call runs on the CPU.

Tolerances, and why:
- Scores of the same policy: within 1.0 bit (measured gaps up to 0.3).
  The GEMMs are bit-exact (FDP) or differ by summation order (native), but
  softmax, rsqrt, rope and silu differ by ulps between XLA and PyTorch, so
  the two packages' logits and gradients differ at every policy, FDP ones
  included, and a median of correct bits moves with them.
- The oracle against itself reads 24.0 exactly in both packages: FDP91
  for ``logits``, and for ``grad`` a policy whose backward namespace is the
  91-bit FDP (the reference's own FDP91 gradient run costs it ~60 s on
  the CPU; the port's FDP91 reads 24.0 too).
- ``worst_leaves`` keys: equal, in order, under the FDP backward policy;
  under native fp32 the worst leaf is the same, and the rest may swap
  places (paper-mlp's wk and wq read 18.42 and 18.44 bits in the port,
  18.44 and 18.42 apart from the top four in the reference: the summation
  order moves them). ``n_leaves`` equal; losses within rtol 1e-5; cosines
  within 1e-6 (qwen3 under the narrow backward: 0.91985760 and 0.91985763,
  the packages' gradients differing by ulps before the narrow register)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.workloads as JW  # noqa: E402
import repro_torch.workloads as TW  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import accumulator as JA  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import accumulator as TA  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.launch.serve import FDP91_KERNEL  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

BUDGET = 10.0
BITS_TOL = 1.0
LOSS_RTOL, COSINE_TOL = 1e-5, 1e-6


def _policy_pair(default, overrides, name):
    """(fmt, acc or None, mode) specs -> the same NumericsPolicy in both."""
    def cfgs(fmt, acc, mode):
        return (JD.GemmConfig(jfmt.get_format(fmt), JA.AccumulatorSpec(*acc) if acc else None,
                              mode),
                TD.GemmConfig(tfmt.get_format(fmt), TA.AccumulatorSpec(*acc) if acc else None,
                              mode))
    jd, td = cfgs(*default)
    over = [(pat, cfgs(*spec)) for pat, spec in overrides]
    return (JD.NumericsPolicy(jd, tuple((p, c[0]) for p, c in over), name),
            TD.NumericsPolicy(td, tuple((p, c[1]) for p, c in over), name))


FP32 = ("ieee_fp32", None, "native")
FIG3 = ("ieee_fp32", (9, 6, -20), "simulate")       # the paper's Fig. 3 pick
NARROW_BWD = ("ieee_fp32", (4, 10, -12), "simulate")
SIM91 = ("ieee_fp32", (30, 30, -30), "simulate")


@pytest.fixture(scope="module")
def pair(arch):
    """The reference's seeded context, and the port's carrying the same
    parameters and batches."""
    jctx = JW.WorkloadContext.for_model(jget(arch).reduced(), budget_bits=BUDGET, seed=0)
    cfg = tget(arch).reduced()
    params = params_from_numpy(jax.tree.map(np.asarray, jctx.params), cfg, device="cpu")
    conv = lambda b: {k: torch.from_numpy(np.array(v)) for k, v in b.items()}
    tctx = TW.WorkloadContext(budget_bits=BUDGET, cfg=cfg, params=params,
                              batch=conv(jctx.batch), grad_batch=conv(jctx.grad_batch),
                              seed=0, device="cpu")
    return jctx, tctx


def _reports(pair, name, policies):
    jctx, tctx = pair
    [jv] = JW.build_validators([name], jctx)
    [tv] = TW.build_validators([name], tctx)
    return [(jv.run(jp).to_json(), tv.run(tp).to_json()) for jp, tp in policies], tv


def test_logits_match_the_reference(pair):
    policies = [(JD.MXU_FP32, TD.MXU_FP32), (JD.FDP91, TD.FDP91),
                _policy_pair(FIG3, [("lm_head", FP32)], "fig3")]
    (fp32, fdp91, fig3), tv = _reports(pair, "logits", policies)
    assert fdp91[0]["score"] == fdp91[1]["score"] == 24.0       # the oracle against itself
    assert fdp91[1]["details"]["top1_agreement"] == 1.0
    for j, t in (fp32, fig3):
        assert abs(t["score"] - j["score"]) <= BITS_TOL, (t, j)
        assert t["details"]["n_logits"] == j["details"]["n_logits"]
        assert t["site_attribution"] == j["site_attribution"] == {}
    assert fig3[1]["score"] < fp32[1]["score"]                   # a narrow register costs bits
    assert tv.ref_policy is TD.FDP91                             # simulate on the CPU
    assert TW.LogitFidelity(None, None, None, device="cpu",
                            fdp_mode="pallas").ref_policy is FDP91_KERNEL


def test_grads_match_the_reference(pair):
    policies = [(JD.MXU_FP32, TD.MXU_FP32),
                _policy_pair(FP32, [("*@bwd", NARROW_BWD)], "narrow_bwd"),
                _policy_pair(FP32, [("*@bwd", SIM91)], "bwd91")]
    (fp32, narrow, bwd91), tv = _reports(pair, "grad", policies)
    assert bwd91[0]["score"] == bwd91[1]["score"] == 24.0        # the oracle against itself
    for j, t in (fp32, narrow):
        assert abs(t["score"] - j["score"]) <= BITS_TOL, (t, j)
        assert abs(t["details"]["median_bits"] - j["details"]["median_bits"]) <= BITS_TOL
        tw, jw = list(t["details"]["worst_leaves"]), list(j["details"]["worst_leaves"])
        # native: the worst leaf is the same; leaves within a tenth of a bit
        # of each other may swap places (summation order)
        assert tw == jw if t is narrow[1] else tw[0] == jw[0], (tw, jw)
        assert t["details"]["n_leaves"] == j["details"]["n_leaves"]
        assert t["site_attribution"].keys() == j["site_attribution"].keys() == {"*@bwd"}
        assert abs(t["details"]["cosine"] - j["details"]["cosine"]) <= COSINE_TOL
        np.testing.assert_allclose(t["details"]["loss"], j["details"]["loss"], rtol=LOSS_RTOL)
    assert narrow[1]["score"] < fp32[1]["score"]
    # the three policies share one forward surface: one reference gradient
    assert tv._ref_key == (TD.MXU_FP32.default.tag(), ())
    assert TD.FDP91.default.tag() != tv._ref_key[0]
    rep = tv.run(TD.FDP91)                   # the port's full FDP91 run, 24.0 as well
    assert rep.score == rep.details["median_bits"] == 24.0
