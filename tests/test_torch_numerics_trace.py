"""Calibration traces in the port against ``repro.numerics.trace``: every
checked-in trace loads in both packages to the same profiles, derived
properties and sample bytes; a trace saved by either package loads in the
other (the saved JSON is byte-equal); the loader's refusals; the config
fingerprint; ``record_aux``; ``build_envelope``; the calibration hook's
lifetime; and ``calibrate`` itself on reduced qwen3-0.6b and dbrx-132b
(the reference's weights carried across by ``convert``, the same numpy
tokens, under native fp32): one forward and one backward of the LM loss.

Tolerances, and why:
- Loaded traces: everything equal (the same JSON read by two loaders).
- Calibrated traces: site keys, calls, MACs, shapes, K and config tags
  equal (they depend on shapes only), exponent ranges of the operands
  equal; magnitudes and samples within rtol 1e-5 / atol 1e-6, the port's
  native fp32 model tolerance at these sizes (XLA and PyTorch sum each
  matmul in another order), taken relative to the largest magnitude of the
  same stream, since a stream's smallest values and a sample's entries
  near zero are differences of such sums. The port's backward runs on
  another thread, as torch runs a CUDA backward on its device thread.

Modelled on ``tests/test_numerics_trace.py``."""

import collections
import glob
import json
import math
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import numerics as JN  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import qformat as JQ  # noqa: E402
from repro.models import LOCAL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import loop as JL  # noqa: E402
from repro_torch import numerics as TN  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import qformat as TQ  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
TRACES = sorted(glob.glob(os.path.join(ROOT, "examples", "plans", "traces",
                                       "*.trace.json")))
QWEN_TRACE = os.path.join(ROOT, "examples", "plans", "traces", "qwen3_0p6b.trace.json")
QWEN_PLAN = os.path.join(ROOT, "examples", "plans", "qwen3_0p6b.json")
RTOL, ATOL = 1e-5, 1e-6
# the reference's calibration shape (repro.workloads.base.PROBE_BATCH/SEQ)
CAL_BATCH, CAL_SEQ = 2, 8

COUNT_FIELDS = ("site", "calls", "macs", "max_k", "shapes", "cfg_tags")
MAG_FIELDS = ("a_abs_max", "a_abs_min_nz", "b_abs_max", "b_abs_min_nz",
              "out_abs_max", "out_abs_min_nz")
EXP_PROPS = ("a_exp_min", "a_exp_max", "b_exp_min", "b_exp_max")
DERIVED = ("prod_exp_max", "sum_growth_bits", "msb_required", "cancellation_bits")


def _derived(p) -> dict:
    d = {k: getattr(p, k) for k in EXP_PROPS + DERIVED}
    d.update(lsb_exact_24=p.lsb_exact(24), lsb_exact_8=p.lsb_exact(8),
             exact_spec_24=p.exact_spec(24).describe(),
             exact_spec_8=p.exact_spec(8).describe(),
             to_dict=p.to_dict(), describe=p.describe())
    return d


def _bytes(x):
    return None if x is None else (x.dtype.str, x.shape, x.tobytes())


def test_all_eleven_traces_are_checked_in():
    assert len(TRACES) == 11, TRACES


def test_numerics_exports_the_reference_names():
    assert sorted(TN.__all__) == sorted(JN.__all__)
    assert all(hasattr(TN, name) for name in TN.__all__)
    assert (TN.TRACE_VERSION, TN.ENVELOPE_VERSION, TN.PLAN_VERSION) == \
        (JN.TRACE_VERSION, JN.ENVELOPE_VERSION, JN.PLAN_VERSION)


@pytest.mark.parametrize("path", TRACES, ids=os.path.basename)
def test_checked_in_trace_loads_in_both_packages(path, tmp_path):
    jt, tt = JN.load_trace(path), TN.load_trace(path)
    assert tt.fingerprint == jt.fingerprint and tt.meta == jt.meta
    assert tt.sites() == jt.sites() and tt.aux_sites() == jt.aux_sites()
    for phase in ("fwd", "bwd"):
        assert tt.sites(phase) == jt.sites(phase)
    assert tt.total_macs() == jt.total_macs()
    for site in tt.sites():
        jp, tp = jt.profile(site), tt.profile(site)
        for f in COUNT_FIELDS + MAG_FIELDS:
            assert getattr(tp, f) == getattr(jp, f), (site, f)
        assert _derived(tp) == _derived(jp), site
        assert _bytes(tp.sample_a) == _bytes(jp.sample_a), site
        assert _bytes(tp.sample_b) == _bytes(jp.sample_b), site
        assert (tp.sample is None) == (jp.sample is None)
    assert tt.summary() == jt.summary() and tt.to_dict() == jt.to_dict()
    # both packages write the same document, byte for byte
    tt.save(tmp_path / "t.json")
    jt.save(tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


def _small_trace():
    """A few GEMMs under native fp32 through the port's dispatch."""
    rng = np.random.default_rng(40)
    a = torch.from_numpy(rng.standard_normal((2, 8, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 4)).astype(np.float32))
    with TN.calibrate() as tr, TD.use_policy(TD.MXU_FP32):
        TD.gemm(a, b, site="t_save")
        TD.gemm(a[0], b, site="t_save")
    return tr


def test_trace_load_rejects_mismatched_fingerprint(tmp_path):
    path = tmp_path / "t.trace.json"
    _small_trace().save(path, fingerprint="aaaa")
    with pytest.raises(ValueError, match="fingerprint.*recalibrate"):
        TN.load_trace(path, expect_fingerprint="bbbb")
    assert TN.load_trace(path).fingerprint == "aaaa"


def test_trace_load_rejects_newer_schema(tmp_path):
    path = tmp_path / "t.trace.json"
    _small_trace().save(path)
    doc = json.loads(path.read_text())
    doc["version"] = TN.TRACE_VERSION + 1
    path.write_text(json.dumps(doc))
    with pytest.raises(ValueError, match="newer"):
        TN.load_trace(path)


def test_trace_load_rejects_non_trace_document(tmp_path):
    path = tmp_path / "not_a_trace.json"
    path.write_text('{"version": 1, "name": "x", "sites": []}')
    with pytest.raises(ValueError, match="not a CalibrationTrace"):
        TN.load_trace(path)


def test_small_trace_records_the_reference_statistics():
    p = _small_trace().profile("t_save")
    assert p.calls == 2 and p.max_k == 64
    assert p.shapes == {(2, 8, 4, 64): 1, (1, 8, 4, 64): 1}
    assert p.macs == 3 * 8 * 4 * 64
    assert p.sample_a.shape == (16, 64) and p.sample_b.shape == (64, 4)
    assert p.cfg_tags == {"ieee_fp32/fp32acc/native"}


@pytest.mark.parametrize("obj", [
    {"arch": "qwen3_0p6b", "batch": 2, "seq": 8, "phases": ["bwd", "fwd"]},
    {"nested": {"b": [1, 2.5, None], "a": True}, "x": -3e-7},
    [1, "two", {"three": 3.0}],
])
def test_config_fingerprint_equal_on_json(obj):
    assert TN.config_fingerprint(obj) == JN.config_fingerprint(obj)


def test_record_aux_equal_and_refuses_gemm_keys():
    rng = np.random.default_rng(41)
    tree = {"w": rng.standard_normal((5, 7)).astype(np.float32) * 3,
            "b": [rng.standard_normal(9).astype(np.float32), np.zeros(4, np.float32)],
            "a": (rng.standard_normal((300, 40)).astype(np.float32) * 1e-3,)}
    jt, tt = JN.trace.CalibrationTrace(), TN.CalibrationTrace()
    jt.record_aux(JQ.OPT_M_SITE, jax.tree.map(jnp.asarray, tree))
    ttree = {"w": torch.from_numpy(tree["w"]), "b": tree["b"], "a": tree["a"]}
    tt.record_aux(TQ.OPT_M_SITE, ttree)
    tt.record_aux("grad_psum@coll", ttree)
    jt.record_aux("grad_psum@coll", tree)
    for site in ("opt.m@state", "grad_psum@coll"):
        jp, tp = jt.profile(site), tt.profile(site)
        assert tp.to_full_dict() == jp.to_full_dict(), site
    with pytest.raises(ValueError, match="GEMM-keyed"):
        tt.record_aux("attn_q", tree)


def test_build_envelope_equal():
    jt, tt = JN.load_trace(QWEN_TRACE), TN.load_trace(QWEN_TRACE)
    want = JN.build_envelope(jt, JN.load_plan(QWEN_PLAN))
    assert TN.build_envelope(tt, TN.load_plan(QWEN_PLAN)) == want
    assert TN.build_envelope(tt, TN.load_plan(QWEN_PLAN).to_policy()) == want
    assert TN.cfg_capacity(TD.FDP91.default) == (30, -30)
    assert TN.cfg_capacity(TD.MXU_FP32.default) == (127, None)


def test_hook_removed_after_context_and_after_exception():
    a, b = torch.ones(4, 8), torch.ones(8, 2)
    prev = TD.set_trace_hook(None)
    try:
        with TN.calibrate() as tr, TD.use_policy(TD.MXU_FP32):
            TD.gemm(a, b, site="t_inside")
        assert TD._TRACE_HOOK is None
        with TD.use_policy(TD.MXU_FP32):
            TD.gemm(a, b, site="t_after")
        assert set(tr.profiles()) == {"t_inside"}
        marker = lambda *args: None                # noqa: E731
        TD.set_trace_hook(marker)
        with pytest.raises(RuntimeError, match="boom"):
            with TN.calibrate(), TD.use_policy(TD.MXU_FP32):
                TD.gemm(a, b, site="t_exc")
                raise RuntimeError("boom")
        assert TD._PRIMARY_HOOK is marker          # the previous hook is back
    finally:
        TD.set_trace_hook(prev)
    assert TD._TRACE_HOOK is None


def test_recompute_is_not_traced_but_counted():
    """A checkpointed region's recompute during backward reaches no trace
    hook, neither the calibration nor an added one (the reference's callbacks
    do not fire in a rematerialized forward); the site registry counts it."""
    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8)
    seen = collections.Counter()
    TD.reset_sites_seen()
    remove = TD.add_trace_hook(lambda site, *args: seen.update([site]))
    try:
        with TN.calibrate() as tr, TD.use_policy(TD.MXU_FP32):
            y = TD.checkpoint(lambda h: TD.gemm(h, w, site="t_ck").relu(), x)
            y.sum().backward()
    finally:
        remove()
    assert tr.profile("t_ck").calls == 1 and tr.profile("t_ck@bwd.dB").calls == 1
    assert seen == {"t_ck": 1, "t_ck@bwd.dB": 1}
    assert TD.site_calls() == {"t_ck": 2, "t_ck@bwd.dB": 1}


# ---------------------------------------------------------------------------
# calibrate() on reduced models, against the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["qwen3-0.6b", "dbrx-132b"])
def calibrated(request):
    jc = jget(request.param).reduced(n_kv_heads=2)
    tc = tget(request.param).reduced(n_kv_heads=2)
    jp = JT.init(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    rng = np.random.default_rng(42)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (CAL_BATCH, CAL_SEQ)).astype(np.int32),
             "targets": rng.integers(0, jc.vocab_size, (CAL_BATCH, CAL_SEQ)).astype(np.int32)}

    with JN.calibrate() as jtrace, JD.use_policy(JD.MXU_FP32):
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        jax.block_until_ready(JT.forward(jp, jc, {"tokens": jb["tokens"]}, LOCAL,
                                         remat="none"))
        jax.block_until_ready(jax.value_and_grad(
            JL.make_loss_fn(jc, LOCAL, remat="none"), has_aux=True)(jp, jb))

    tb = {k: torch.from_numpy(v.copy()).long() for k, v in batch.items()}
    calls = collections.Counter()             # every dispatch a hook sees
    remove = TD.add_trace_hook(lambda site, *args: calls.update([site]))
    try:
        with TN.calibrate() as ttrace:
            with TD.use_policy(TD.MXU_FP32):
                with torch.no_grad():
                    TT.forward(tp, tc, {"tokens": tb["tokens"]}, remat="none")
                loss, _ = TL.make_loss_fn(tc, remat="none")(tp, tb)
            # off the calling thread, where torch runs a CUDA backward
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        remove()
    return jtrace, ttrace, calls


def _close(got, want, scale):
    if math.isinf(want):
        return math.isinf(got)
    return abs(got - want) <= ATOL + RTOL * max(abs(want), scale)


@pytest.mark.parametrize("phase", ["fwd", "bwd"])
def test_calibrate_matches_the_reference(calibrated, phase):
    jtrace, ttrace, calls = calibrated
    sites = ttrace.sites(phase)
    assert sites == jtrace.sites(phase) and sites
    assert ttrace.aux_sites() == [] == jtrace.aux_sites()
    for site in sites:
        jp, tp = jtrace.profile(site), ttrace.profile(site)
        for f in COUNT_FIELDS:
            assert getattr(tp, f) == getattr(jp, f), (site, f)
        assert tp.calls == calls[site], site          # one record a dispatch
        for f in EXP_PROPS:
            assert getattr(tp, f) == getattr(jp, f), (site, f)
        assert _floor(tp.out_abs_max) == _floor(jp.out_abs_max), site
        for f in MAG_FIELDS:
            # a stream's smallest |value| may be a cancellation: its error is
            # the stream's, so the tolerance scales with the stream's largest
            scale = getattr(jp, f.replace("_min_nz", "_max"))
            assert _close(getattr(tp, f), getattr(jp, f), scale), (site, f)
        for s in ("sample_a", "sample_b"):
            got, want = getattr(tp, s), getattr(jp, s)
            assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=site,
                                       atol=ATOL + RTOL * float(np.abs(want).max()))
    if phase == "bwd":
        fwd = ttrace.sites("fwd")
        assert sorted(sites) == sorted(f"{s}@bwd.{o}" for s in fwd for o in ("dA", "dB"))


def _floor(v):
    return math.frexp(v)[1] - 1 if v > 0 else None


def test_calibrated_traces_interchange(calibrated, tmp_path):
    """A trace saved by the port loads in the reference, and the reverse,
    to the same profiles; saving what was loaded writes the same bytes."""
    jtrace, ttrace, _ = calibrated
    ttrace.save(tmp_path / "port.json", fingerprint="f0", meta={"by": "port"})
    jtrace.save(tmp_path / "ref.json", fingerprint="f1", meta={"by": "reference"})
    for name, src in (("port.json", ttrace), ("ref.json", jtrace)):
        in_ref, in_port = JN.load_trace(tmp_path / name), TN.load_trace(tmp_path / name)
        for tr in (in_ref, in_port):
            assert tr.sites() == src.sites() and tr.fingerprint == src.fingerprint
            for site in src.sites():
                want = src.profile(site).to_full_dict()
                assert tr.profile(site).to_full_dict() == want, site
        in_ref.save(tmp_path / "again_ref.json")
        in_port.save(tmp_path / "again_port.json")
        assert ((tmp_path / "again_ref.json").read_bytes()
                == (tmp_path / "again_port.json").read_bytes()
                == (tmp_path / name).read_bytes())
