"""Precision plans in the port against ``repro.numerics.plan``: every
checked-in plan (and the v1 fixture) loads in both packages and deploys the
same per-site configs; the loader's migrations and refusals; the moment
formats of ``state_quant_from_policy``; serving under a plan (greedy tokens
equal to the JAX package's, logits within rtol 1e-4 / atol 1e-5, as the
other model tests); and the trace-hook seam, which must see the same site
keys with the same operand shapes as the reference's.

Modelled on ``tests/test_numerics_plan.py`` and ``tests/test_plan_zoo.py``."""

import glob
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.launch.serve import serve as jserve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.numerics import load_plan as jload  # noqa: E402
from repro.train.optimizer import state_quant_from_policy as jsq  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import formats as tfmt  # noqa: E402
from repro_torch.core.accumulator import AccumulatorSpec  # noqa: E402
from repro_torch.core.formats import BF16, FP32  # noqa: E402
from repro_torch.core.qformat import QuantConfig  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.numerics import PLAN_VERSION, PrecisionPlan, SitePlan, load_plan  # noqa: E402
from repro_torch.train.optimizer import state_quant_from_policy  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
PLANS_DIR = os.path.join(ROOT, "examples", "plans")
ZOO = sorted(p for p in glob.glob(os.path.join(PLANS_DIR, "*.json"))
             if os.path.basename(p) != "MANIFEST.json")
V1_FIXTURE = os.path.join(PLANS_DIR, "fixtures", "paper_mlp.v1.json")
QWEN_PLAN = os.path.join(PLANS_DIR, "qwen3_0p6b.json")
RTOL, ATOL = 1e-4, 1e-5


def _quant_fields(cfg):
    return None if cfg is None else (cfg.bits, cfg.block, cfg.mode, cfg.error_feedback)


def test_zoo_is_all_eleven_plans():
    assert len(ZOO) == 11, ZOO


@pytest.mark.parametrize("path", ZOO + [V1_FIXTURE], ids=os.path.basename)
def test_plan_deploys_the_reference_configs(path):
    jplan, tplan = jload(path), load_plan(path)
    jpol, tpol = jplan.to_policy(), tplan.to_policy()
    assert tplan.version == jplan.version == PLAN_VERSION
    assert tplan.meta == jplan.meta and tplan.name == jplan.name
    assert tpol.name == jpol.name
    keys = {"__unlisted__", "__unlisted__@bwd.dA", "__unlisted__@bwd.dB"}
    for s in tplan.gemm_sites():
        keys.add(s.site)
        if s.gemm_site.phase == "fwd":
            keys |= {f"{s.site}@bwd.dA", f"{s.site}@bwd.dB"}
    for key in sorted(keys):
        assert tpol.lookup(key).tag() == jpol.lookup(key).tag(), key
    aux = [s.site for s in jplan.aux_sites()]
    assert aux == [s.site for s in tplan.aux_sites()]
    for key in aux + ["opt.m@state", "opt.v@state", "grad_psum@coll"]:
        assert _quant_fields(tpol.aux_lookup(key)) == _quant_fields(jpol.aux_lookup(key))
    # the writers agree document for document, and describe() line for line
    assert json.dumps(tplan.to_json(), sort_keys=True) == \
        json.dumps(jplan.to_json(), sort_keys=True)
    assert tplan.describe() == jplan.describe()


def test_zoo_site_keys_of_unported_families_parse():
    """Every zoo plan lists sites of whisper, paligemma, mamba2 and zamba2,
    which the port cannot build yet; their keys still parse as GemmSites."""
    for path in ZOO:
        for s in load_plan(path).gemm_sites():
            assert TD.GemmSite.parse(s.site).key == s.site


def _plan():
    return PrecisionPlan(
        name="unit",
        sites=(SitePlan("attn_qk", TD.GemmConfig(FP32, AccumulatorSpec(5, 8, -40), "simulate"),
                        error_bits=24.0, energy_j=1e-4, macs=1 << 20),
               SitePlan("mlp_in", TD.GemmConfig(BF16, None, "native"), error_bits=8.5,
                        energy_j=2e-5, macs=1 << 21),
               SitePlan("opt.m@state", QuantConfig(8, 64), kind="state", bytes_total=1e3)),
        default=TD.GemmConfig(BF16, None, "native"), budget_bits=8.0,
        meta={"modeled_energy_j": 1.2e-4})


def test_round_trip_and_save(tmp_path):
    p = _plan()
    q = PrecisionPlan.from_json(json.loads(json.dumps(p.to_json())))
    assert q.sites == p.sites and q.default == p.default and q.meta == p.meta
    assert q.bwd_default == TD.widen_config(p.default)
    path = tmp_path / "plan.json"
    p.save(path)
    r = load_plan(path)
    assert r.sites == p.sites
    pol = r.to_policy()
    assert pol.lookup("attn_qk") == p.sites[0].cfg
    assert pol.lookup("attn_qk@bwd.dA") == TD.widen_config(p.default)
    assert pol.aux_lookup("opt.m@state") == QuantConfig(8, 64)
    assert pol.aux_lookup("opt.v@state") is None
    # the port's document loads in the reference unchanged
    jpol = jload(path).to_policy()
    assert jpol.lookup("attn_qk").tag() == pol.lookup("attn_qk").tag()


def test_v1_document_migrates():
    plan = load_plan(V1_FIXTURE)
    assert plan.meta["migrated_from"] == 1
    assert plan.bwd_default == TD.widen_config(plan.default)
    pol = plan.to_policy()
    for s in plan.sites:
        assert pol.lookup(s.site) == s.cfg
        assert pol.lookup(f"{s.site}@bwd.dB") == plan.bwd_default


def test_v2_document_gets_the_provenance_stamp():
    d = _plan().to_json()
    d["version"] = 2
    d["sites"] = d["sites"][:2]
    q = PrecisionPlan.from_json(d)
    assert q.meta["migrated_from"] == 2 and q.version == PLAN_VERSION
    assert q.bwd_default == TD.widen_config(q.default)


@pytest.mark.parametrize("edit,match", [
    (lambda d: d.update(version=PLAN_VERSION + 1), "newer"),
    (lambda d: d.pop("sites"), "PrecisionPlan"),
    (lambda d: d.pop("name"), "PrecisionPlan"),
    (lambda d: d["sites"][0].update(site="attn_qk@sideways.dC"), "phase"),
    (lambda d: d["sites"][2].update(kind="gemm"), "keyed as a state site"),
    (lambda d: d["sites"][0].update(cfg={"quant": {"bits": 8, "block": 64}}), "quant cfg"),
    (lambda d: d["sites"][2].update(cfg=d["sites"][1]["cfg"]), "non-quant"),
])
def test_malformed_documents_are_refused(edit, match):
    d = _plan().to_json()
    edit(d)
    with pytest.raises(ValueError, match=match):
        PrecisionPlan.from_json(d)


def test_state_quant_from_the_qwen_plan():
    want = jsq(JD.policy_from_plan(QWEN_PLAN))
    got = state_quant_from_policy(TD.policy_from_plan(QWEN_PLAN))
    assert set(got) == set(want) == {"mu", "nu"}
    for m in got:
        assert got[m].tag() == want[m].tag() == "q8b64"
    assert state_quant_from_policy(TD.MXU_FP32) is None
    fp32 = TD.MXU_FP32.with_aux("opt.m@state", QuantConfig(mode="fp32"))
    assert state_quant_from_policy(fp32) is None


def test_with_aux_replaces_and_aux_keys_never_match_gemm_sites():
    pol = TD.MXU_FP32.with_aux("opt.m@state", QuantConfig(8, 64))
    pol = pol.with_aux("opt.m@state", QuantConfig(4, 32))
    assert pol.aux == (("opt.m@state", QuantConfig(4, 32)),)
    assert pol.overrides == TD.MXU_FP32.overrides      # aux never enters overrides
    for key in ("opt.m@state", "grad_psum@coll"):      # nor parses as a GemmSite
        with pytest.raises(ValueError):
            TD.GemmSite.parse(key)
        with pytest.raises(ValueError):
            JD.GemmSite.parse(key)


def _mixed_plans(tmp_path):
    """A mixed simulate plan, written by the port and read by both packages:
    FDP91 by default, the paper's <9,6,-20> at the MLP sites, lm_head native
    fp32."""
    p91 = TD.GemmConfig(FP32, AccumulatorSpec.paper_91bit(), "simulate")
    tailored = TD.GemmConfig(FP32, AccumulatorSpec(9, 6, -20), "simulate")
    plan = PrecisionPlan(
        name="mixed", default=p91,
        sites=tuple(SitePlan(s, tailored) for s in ("mlp_in", "mlp_gate", "mlp_out"))
        + (SitePlan("lm_head", TD.GemmConfig(FP32, None, "native")),))
    path = tmp_path / "mixed.json"
    plan.save(path)
    return path


@pytest.mark.parametrize("which", ["zoo", "mixed"])
def test_serve_under_a_plan_matches_the_reference(tmp_path, which):
    path = QWEN_PLAN if which == "zoo" else _mixed_plans(tmp_path)
    jc = jget("qwen3-0.6b").reduced(n_kv_heads=2)
    tc = tget("qwen3-0.6b").reduced(n_kv_heads=2)
    jp = JT.init(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    prompts = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 4)).astype(np.int32)
    jpol, tpol = JD.policy_from_plan(path), TD.policy_from_plan(path)
    with JD.use_policy(jpol):
        want_toks = np.asarray(jserve(jc, jp, jnp.asarray(prompts), 3))
        want = np.asarray(JT.forward(jp, jc, {"tokens": jnp.asarray(prompts)}))
    with TD.use_policy(tpol):
        got_toks = TS.serve(tc, tp, torch.from_numpy(prompts), 3, device="cpu")
        got = TT.forward(tp, tc, {"tokens": torch.from_numpy(prompts).long()})
    np.testing.assert_array_equal(got_toks.numpy(), want_toks)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_serve_cli_takes_a_precision_plan(capsys):
    TS.main(["--arch", "qwen3-0.6b", "--reduced", "--batch", "2", "--prompt-len", "3",
             "--gen", "2", "--device", "cpu", "--precision-plan", QWEN_PLAN])
    out = capsys.readouterr().out
    assert "policy=plan:qwen3-0.6b-reduced device=cpu" in out and "sample:" in out
    with pytest.raises(SystemExit, match="not both"):
        TS.main(["--reduced", "--device", "cpu", "--precision-plan", QWEN_PLAN,
                 "--policy", "mxu_fp32"])


def test_train_cli_takes_a_precision_plan(capsys):
    TLT.main(["--arch", "paper-mlp", "--reduced", "--steps", "2", "--batch", "2",
              "--seq", "8", "--lr", "3e-2", "--device", "cpu", "--precision-plan", QWEN_PLAN])
    out = capsys.readouterr().out
    # the plan's opt.m@state / opt.v@state sites set the moment formats
    assert "quantized optimizer state: mu=q8b64, nu=q8b64" in out
    assert "policy=plan:qwen3-0.6b-reduced" in out
    TLT.main(["--arch", "paper-mlp", "--reduced", "--steps", "2", "--batch", "2",
              "--seq", "8", "--lr", "3e-2", "--device", "cpu", "--precision-plan", QWEN_PLAN,
              "--opt-precision", "fp32"])
    assert "quantized optimizer state" not in capsys.readouterr().out   # the flag wins
    with pytest.raises(SystemExit, match="not both"):
        TLT.main(["--reduced", "--device", "cpu", "--precision-plan", QWEN_PLAN,
                  "--policy", "mxu_fp32"])


def _shapes(x):
    return tuple(int(d) for d in x.shape)


@pytest.mark.parametrize("policy", ["native_fp32_fwd_bwd", "fdp91_fwd"])
def test_trace_hook_sees_the_reference_sites_and_shapes(policy):
    """A reduced qwen3 forward (and backward, under native fp32) reports the
    same set of (site key, operand shapes) to the trace hook in both
    packages. Sets, not sequences: the reference reports at trace time, the
    port as it runs."""
    jc = jget("qwen3-0.6b").reduced(n_kv_heads=2)
    tc = tget("qwen3-0.6b").reduced(n_kv_heads=2)
    jp = JT.init(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 5)).astype(np.int32)
    w = np.random.default_rng(6).standard_normal((2, 5, tc.padded_vocab)).astype(np.float32)
    backward = policy.endswith("bwd")
    jpol, tpol = ((JD.MXU_FP32, TD.MXU_FP32) if backward
                  else (JD.FDP91, TS.FDP91_KERNEL))

    seen = {"jax": set(), "torch": set()}

    def hook(into):
        def record(site_key, cfg, a, b, out):
            into.add((site_key, _shapes(a), _shapes(b), _shapes(out)))
        return record

    prev = JD.set_trace_hook(hook(seen["jax"]))
    try:
        def jloss(params):
            logits = JT.forward(params, jc, {"tokens": jnp.asarray(toks)})
            return jnp.sum(logits * jnp.asarray(w))
        with JD.use_policy(jpol):
            jax.grad(jloss)(jp) if backward else jloss(jp)
    finally:
        JD.set_trace_hook(prev)

    remove = TD.add_trace_hook(hook(seen["torch"]))
    try:
        with TD.use_policy(tpol):
            loss = (TT.forward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
                    * torch.from_numpy(w)).sum()
        if backward:
            # run the backward on another thread: the hook must still fire
            t = threading.Thread(target=lambda: loss.backward())
            t.start()
            t.join()
    finally:
        remove()
    assert seen["torch"] == seen["jax"]
    keys = {k for k, *_ in seen["torch"]}
    assert ("lm_head@bwd.dB" in keys) == backward and "attn_qk" in keys
    assert TD._TRACE_HOOK is None                   # the remover restored zero cost


def test_set_and_add_trace_hooks_compose():
    a, b = [], []
    rm = TD.add_trace_hook(lambda *args: a.append(args[0]))
    prev = TD.set_trace_hook(lambda *args: b.append(args[0]))
    x = torch.ones(2, 3)
    TD.gemm(x, torch.ones(3, 2), site="probe", policy=TD.MXU_FP32)
    TD.set_trace_hook(prev)
    TD.gemm(x, torch.ones(3, 2), site="probe2", policy=TD.MXU_FP32)
    rm()
    TD.gemm(x, torch.ones(3, 2), site="probe3", policy=TD.MXU_FP32)
    assert a == ["probe", "probe2"] and b == ["probe"]
    assert TD._TRACE_HOOK is None


def test_register_plan_and_quantize_inputs():
    TD.clear_plan_cache()
    spec = AccumulatorSpec.paper_91bit()
    TD.register_plan(64, 64, 256, TD.GemmPlan(16, 16, 64), fmt=FP32, spec=spec)
    plan = TD.plan_gemm(64, 64, 256, fmt=FP32, spec=spec)
    assert plan == TD.GemmPlan(16, 16, 64, source="override")
    assert TD.plan_cache_stats() == TD.PlanCacheStats(1, 1, 0, 0, 0)
    TD.clear_plan_cache()
    x = np.random.default_rng(7).standard_normal((3, 5)).astype(np.float32) * 3
    for fmt in ("bfloat16", "posit16_1", "ieee_fp32"):
        jpol = JD.NumericsPolicy(JD.GemmConfig(jfmt.get_format(fmt), None, "native"))
        tpol = TD.NumericsPolicy(TD.GemmConfig(tfmt.get_format(fmt), None, "native"))
        want = np.asarray(JD.quantize_inputs(jnp.asarray(x), "s", jpol))
        got = TD.quantize_inputs(torch.from_numpy(x), "s", tpol).numpy()
        np.testing.assert_array_equal(got, want)


def test_backward_on_another_thread_uses_the_plans_bwd_configs():
    """A loss under the zoo plan, differentiated on another thread (as torch
    runs a CUDA backward on its device thread, where use_policy is not
    installed): every backward site dispatches under the plan's config, its
    explicit @bwd assignment or the widened ``*@bwd`` fallback, never the
    thread's default."""
    tc = tget("qwen3-0.6b").reduced(n_kv_heads=2)
    from repro_torch.models import init
    tp = init(tc, seed=0, device="cpu")
    pol = TD.policy_from_plan(QWEN_PLAN)
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, tc.vocab_size, (2, 5)))
    seen = {}
    remove = TD.add_trace_hook(lambda key, cfg, *_: seen.setdefault(key, cfg))
    try:
        with TD.use_policy(pol):
            loss = TT.forward(tp, tc, {"tokens": toks}).square().mean()
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join()
    finally:
        remove()
    bwd = {k: c for k, c in seen.items() if "@bwd" in k}
    assert bwd and all(c == pol.lookup(k) for k, c in bwd.items())
    assert any(c != TD.current_policy().default for c in bwd.values())
