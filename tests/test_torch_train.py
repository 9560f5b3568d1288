"""The port's training slice against the JAX reference: the autograd
backward sites of ``gemm``, ``grouped_qk``, ``grouped_av`` and
``ragged_gemm``, the block-scaled optimizer state, AdamW, the loss and
gradients of reduced models, the train step, checkpoints and the
fault-tolerant ``Trainer``.

Tolerances, and why:
- FDP modes (``simulate``, and ``pallas``: the kernels' plain versions on
  the CPU against JAX's Pallas in interpret mode): gradients bit-equal.
  Every backward GEMM is exact in its inputs, and the unbroadcast sums of
  the broadcast case add two terms, which is order-free.
- Native fp32: each backward GEMM is an f32 sum in another order than
  XLA's, so gradients agree within rtol 1e-5 / atol 1e-6 at these sizes.
- Model loss and gradients (native fp32): rtol 1e-4 / atol 1e-5 as for
  the logits (softmax, rsqrt, rope and silu differ by ulps between XLA and
  PyTorch), taken relative to each leaf's largest gradient, since the
  smallest gradient entries are differences of such terms.
- Block-scaled carriers: bit-equal where the reference's ``jnp.exp2`` is
  exact. On XLA:CPU it is exact only for exponents near zero (measured:
  2^-20 comes out 1e-6 off), so outside that range the port, which forms
  exact powers of two, is held to its own exact contract and the reference
  within rtol 1e-5 (ROADMAP section 3 records the caveat).
"""

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import accumulator as jacc  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.core import formats as jfmt  # noqa: E402
from repro.core import qformat as JQ  # noqa: E402
from repro.models import LOCAL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import loop as JL  # noqa: E402
from repro.train import optimizer as JO  # noqa: E402
from repro_torch.checkpoint.store import CheckpointStore  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.core import qformat as TQ  # noqa: E402
from repro_torch.core.accumulator import AccumulatorSpec  # noqa: E402
from repro_torch.core.formats import BF16  # noqa: E402
from repro_torch.launch import train as TLT  # noqa: E402
from repro_torch.launch.serve import FDP91_KERNEL  # noqa: E402
from repro_torch.models import init, params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.train import loop as TL  # noqa: E402
from repro_torch.train import optimizer as TO  # noqa: E402

torch.set_num_threads(1)

NATIVE_RTOL, NATIVE_ATOL = 1e-5, 1e-6
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5
JAX_PALLAS = JD.NumericsPolicy(
    JD.GemmConfig(jfmt.FP32, jacc.AccumulatorSpec(30, 30, -30), "pallas"))
POLICIES = {"simulate": (JD.FDP91, TD.FDP91), "pallas": (JAX_PALLAS, FDP91_KERNEL),
            "native": (JD.MXU_FP32, TD.MXU_FP32)}


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _compare(got, want, mode, what):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if mode == "native":
        np.testing.assert_allclose(got, want, rtol=NATIVE_RTOL, atol=NATIVE_ATOL, err_msg=what)
    else:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=what)


def _vjp_both(jf, tf, arrays, cot_seed, mode, n_diff=None):
    """Output and cotangents of the first ``n_diff`` arrays through JAX's
    ``jax.vjp`` and torch's autograd, on the same numpy inputs and output
    cotangent; the site registries of both as well."""
    n_diff = len(arrays) if n_diff is None else n_diff
    JD.reset_sites_seen()
    out, vjp = jax.vjp(lambda *d: jf(*d, *map(jnp.asarray, arrays[n_diff:])),
                       *map(jnp.asarray, arrays[:n_diff]))
    cot = np.asarray(_f32(_rng(cot_seed), out.shape))
    jgrads = vjp(jnp.asarray(cot))
    jsites = JD.sites_seen()
    TD.reset_sites_seen()
    ts = [torch.from_numpy(a.copy()) for a in arrays]
    for t in ts[:n_diff]:
        t.requires_grad_(True)
    tout = tf(*ts)
    tgrads = torch.autograd.grad(tout, ts[:n_diff], torch.as_tensor(cot))
    tsites = TD.sites_seen()
    _compare(tout, out, mode, "forward")
    return jgrads, tgrads, jsites, tsites


# ---------------------------------------------------------------------------
# The autograd backward sites
# ---------------------------------------------------------------------------
GEMM_CASES = {"vec_vec": ((6,), (6,)), "vec_mat": ((6,), (6, 3)),
              "broadcast_batch": ((2, 3, 6), (1, 6, 4)), "weight_2d": ((2, 3, 6), (6, 4))}


@pytest.mark.parametrize("mode", list(POLICIES))
@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_grads_match_reference(case, mode):
    ash, bsh = GEMM_CASES[case]
    rng = _rng(len(case))
    jpol, tpol = POLICIES[mode]
    jg, tg, jsites, tsites = _vjp_both(
        lambda a, b: JD.gemm(a, b, site="probe", policy=jpol),
        lambda a, b: TD.gemm(a, b, site="probe", policy=tpol),
        [_f32(rng, ash), _f32(rng, bsh)], cot_seed=9, mode=mode)
    for t, j, name in zip(tg, jg, ("dA", "dB")):
        _compare(t, j, mode, f"{case} {name}")
    assert tsites == jsites == {"probe", "probe@bwd.dA", "probe@bwd.dB"}


@pytest.mark.parametrize("mode", list(POLICIES))
def test_grouped_attention_grads_match_reference(mode):
    rng = _rng(4)
    q, k, v = _f32(rng, (2, 2, 3, 5, 8)), _f32(rng, (2, 2, 7, 8)), _f32(rng, (2, 2, 7, 8))
    jpol, tpol = POLICIES[mode]

    def jf(q, k, v):
        s = JD.grouped_qk(q, k, site="attn_qk", policy=jpol)
        return JD.grouped_av(s, v, site="attn_av", policy=jpol)

    def tf(q, k, v):
        s = TD.grouped_qk(q, k, site="attn_qk", policy=tpol)
        return TD.grouped_av(s, v, site="attn_av", policy=tpol)

    jg, tg, jsites, tsites = _vjp_both(jf, tf, [q, k, v], cot_seed=5, mode=mode)
    for t, j, name in zip(tg, jg, "qkv"):
        _compare(t, j, mode, f"d{name}")
    assert tsites == jsites == {"attn_qk", "attn_av", "attn_qk@bwd.dA", "attn_qk@bwd.dB",
                                "attn_av@bwd.dA", "attn_av@bwd.dB"}


@pytest.mark.parametrize("mode", list(POLICIES))
def test_ragged_gemm_grads_match_reference(mode):
    """Zero-size groups and rows past the total: those rows get zero dX and
    add nothing to dW; group_sizes gets no gradient."""
    rng = _rng(6)
    gs = np.array([5, 0, 4, 0], np.int32)                 # 3 rows past the total
    x, w = _f32(rng, (12, 6)), _f32(rng, (4, 6, 5))
    jpol, tpol = POLICIES[mode]
    jg, tg, jsites, tsites = _vjp_both(
        lambda x, w, gs: JD.ragged_gemm(x, w, gs, site="moe_in", policy=jpol),
        lambda x, w, gs: TD.ragged_gemm(x, w, gs, site="moe_in", policy=tpol),
        [x, w, gs], cot_seed=8, mode=mode, n_diff=2)
    for t, j, name in zip(tg, jg, ("dX", "dW")):
        _compare(t, j, mode, name)
    assert not tg[0][9:].any() and not tg[1][1].any() and not tg[1][3].any()
    assert tsites == jsites == {"moe_in", "moe_in@bwd.dA", "moe_in@bwd.dB"}


def test_bwd_override_takes_effect():
    """``probe@bwd.dB`` under its own config (native bf16), while dA stays
    on the 91-bit FDP."""
    rng = _rng(10)
    a, b, g = _f32(rng, (3, 8)), _f32(rng, (8, 4)), _f32(rng, (3, 4))
    pol = TD.FDP91.with_override("probe@bwd.dB", TD.GemmConfig(BF16, None, "native"))
    ta, tb = torch.from_numpy(a).requires_grad_(), torch.from_numpy(b).requires_grad_()
    TD.reset_sites_seen()
    da, db = torch.autograd.grad(TD.gemm(ta, tb, site="probe", policy=pol), (ta, tb),
                                 torch.from_numpy(g))
    assert TD.site_calls() == {"probe": 1, "probe@bwd.dA": 1, "probe@bwd.dB": 1}
    assert torch.equal(db, torch.matmul(BF16.quantize(ta.detach()).T,
                                        BF16.quantize(torch.from_numpy(g))))
    plain_da = TD.gemm(torch.from_numpy(g), torch.from_numpy(b).T, policy=TD.FDP91)
    assert torch.equal(da, plain_da)
    jpol = JD.FDP91.with_override("probe@bwd.dB", JD.GemmConfig(jfmt.BF16, None, "native"))
    _, vjp = jax.vjp(lambda x, y: JD.gemm(x, y, site="probe", policy=jpol),
                     jnp.asarray(a), jnp.asarray(b))
    jda, jdb = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(da.numpy(), np.asarray(jda))
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=1e-6, atol=1e-6)


def _reduced(arch):
    over = {} if arch == "paper-mlp" else dict(n_kv_heads=2)
    return jget(arch).reduced(**over), tget(arch).reduced(**over)


def _batch(cfg, B, S, seed):
    rng = _rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            "loss_mask": np.ones((B, S), np.float32)}


def _tbatch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def test_backward_off_thread_uses_the_forward_policy():
    """torch runs the backward of CUDA tensors on its own device thread,
    where ``use_policy`` is not installed. Here the backward runs in a new
    thread, outside any policy, after a forward under the FDP policy with
    ``remat="block"`` (so the recompute also runs there): the gradients
    equal the in-thread ones, and differ from the default policy's."""
    _, tc = _reduced("dbrx-132b")
    params = init(tc, seed=0, device="cpu")
    batch = _tbatch(_batch(tc, 2, 6, seed=1))
    loss_fn = TL.make_loss_fn(tc, remat="block")
    leaves = list(params.parameters())

    def grads(policy, in_thread):
        with TD.use_policy(policy):
            loss, _ = loss_fn(params, batch)
        if in_thread:
            return torch.autograd.grad(loss, leaves)
        out = {}
        worker = threading.Thread(target=lambda: out.setdefault(
            "g", torch.autograd.grad(loss, leaves)))
        worker.start()
        worker.join(timeout=300)
        assert not worker.is_alive()
        return out["g"]

    TD.reset_sites_seen()
    here = grads(FDP91_KERNEL, True)
    calls_here = TD.site_calls()
    TD.reset_sites_seen()
    there = grads(FDP91_KERNEL, False)
    assert TD.site_calls() == calls_here
    assert all(torch.equal(a, b) for a, b in zip(here, there))
    default = grads(TD.current_policy(), True)
    assert not all(torch.equal(a, b) for a, b in zip(here, default))
    assert calls_here["lm_head"] == 2                     # the checkpointed recompute
    assert {"moe_in@bwd.dB", "attn_qk@bwd.dA", "lm_head@bwd.dB"} <= set(calls_here)


# ---------------------------------------------------------------------------
# Block-scaled carriers and the optimizer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bits,block,scale", [(8, 64, 1.0), (8, 64, 100.0), (4, 32, 1.0),
                                              (16, 64, 100.0)])
def test_qformat_carriers_bit_equal_to_reference(bits, block, scale):
    """Scales whose block exponents fall where the reference's exp2 is exact
    (see the module note)."""
    x = _f32(_rng(bits + block), (37, 29), scale)
    x[0, :5] = 0.0
    jc, tc = JQ.QuantConfig(bits, block), TQ.QuantConfig(bits, block)
    for rounding in ("nearest", "up"):
        jq = JQ.block_quantize(jnp.asarray(x), jc, rounding=rounding)
        tq = TQ.block_quantize(torch.from_numpy(x), tc, rounding=rounding)
        assert tq["q"].dtype == tc.storage_dtype() and tq["exp"].dtype == torch.int8
        np.testing.assert_array_equal(tq["q"].numpy(), np.asarray(jq["q"]))
        np.testing.assert_array_equal(tq["exp"].numpy(), np.asarray(jq["exp"]))
        np.testing.assert_array_equal(TQ.block_dequantize(tq, tc, x.shape).numpy(),
                                      np.asarray(JQ.block_dequantize(jq, jc, x.shape)))
    assert TQ.quant_bytes(x.size, tc) == JQ.quant_bytes(x.size, jc)
    assert TQ.parse_quant(f"{bits}x{block}+ef") == TQ.QuantConfig(bits, block,
                                                                  error_feedback=True)


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 1e5])
def test_qformat_scales_are_exact_powers_of_two(scale):
    x = _f32(_rng(3), (50, 64), scale)
    cfg = TQ.QuantConfig(8, 64)
    for rounding in ("nearest", "up"):
        q = TQ.block_quantize(torch.from_numpy(x), cfg, rounding=rounding)
        lsb = q["exp"].numpy().astype(np.int64) - 7
        want = np.ldexp(q["q"].numpy().astype(np.float64), lsb[:, None]).reshape(x.shape)
        got = TQ.block_dequantize(q, cfg, x.shape).numpy()
        np.testing.assert_array_equal(got, want.astype(np.float32))
        step = np.ldexp(1.0, lsb)[:, None].reshape(-1, 1)
        err = np.abs(got.reshape(-1, 64) - x.reshape(-1, 64))
        assert np.all(err <= step * (1.0 if rounding == "up" else 0.5))
        if rounding == "up":
            assert np.all(np.abs(got) >= np.abs(x))
    jq = JQ.quantize_roundtrip(jnp.asarray(x), JQ.QuantConfig(8, 64))
    np.testing.assert_allclose(TQ.quantize_roundtrip(torch.from_numpy(x), cfg).numpy(),
                               np.asarray(jq), rtol=1e-5, atol=0)


@pytest.mark.parametrize("quant", [None, "8x64"])
def test_adamw_updates_match_reference(quant, monkeypatch):
    """``update`` (whole leaves) against the reference; ``apply`` (in place,
    here 128 elements at a time, so leaves span several slices and a padded
    last block) torch.equal to ``update``."""
    monkeypatch.setattr(TO, "_APPLY_CHUNK", 128)
    rng = _rng(12)
    params = {"w": _f32(rng, (7, 41), 0.1), "b": _f32(rng, (40,), 0.1),
              "e": _f32(rng, (3, 64, 5), 0.1)}
    grads = [{k: _f32(rng, v.shape, 1e-2) for k, v in params.items()} for _ in range(2)]
    jsq = tsq = None
    if quant:
        jsq = {m: JQ.parse_quant(quant) for m in ("mu", "nu")}
        tsq = {m: TQ.parse_quant(quant) for m in ("mu", "nu")}
    jopt = JO.adamw(lr=JO.cosine_schedule(1e-2, 1, 10), weight_decay=0.1, clip_norm=0.05,
                    state_quant=jsq)
    topt = TO.adamw(lr=TO.cosine_schedule(1e-2, 1, 10), weight_decay=0.1, clip_norm=0.05,
                    state_quant=tsq)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tp_inplace = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts, ts2 = jopt.init(jp), topt.init(tp), topt.init(tp_inplace)
    for g in grads:
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = JO.apply_updates(jp, ju)
        tu, ts = topt.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts, tp)
        tp = TO.apply_updates(tp, tu)
        ts2 = topt.apply({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts2,
                         tp_inplace)
        for k in params:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-5, atol=1e-9)
            assert torch.equal(tp[k], tp_inplace[k])
        np.testing.assert_allclose(float(ts["grad_norm"]), float(js["grad_norm"]), rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8)
    if quant:
        cfg = tsq["mu"]
        for k, v in params.items():
            mu = TQ.block_dequantize(ts["mu"][k], cfg, v.shape).numpy()
            np.testing.assert_allclose(mu, np.asarray(JQ.block_dequantize(
                js["mu"][k], jsq["mu"], v.shape)), rtol=1e-5, atol=1e-12)
        full = TO.optimizer_state_bytes(topt.init({k: torch.zeros(v.shape)
                                                   for k, v in params.items()}))
        assert TO.optimizer_state_bytes(ts) == full
        assert full < 0.3 * 2 * 4 * sum(v.size for v in params.values())


# ---------------------------------------------------------------------------
# The model's loss and gradients, and the train step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=["dbrx-132b", "qwen3-0.6b"])
def reduced_model(request):
    jc, tc = _reduced(request.param)
    jp = JT.init(jc, jax.random.key(0))
    return jc, jp, tc, params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")


def test_loss_and_grads_match_reference(reduced_model):
    jc, jp, tc, tp = reduced_model
    batch = _batch(jc, 2, 8, seed=3)
    with JD.use_policy(JD.MXU_FP32):
        (jloss, jm), jgrads = jax.value_and_grad(
            JL.make_loss_fn(jc, LOCAL, remat="none"), has_aux=True)(
                jp, {k: jnp.asarray(v) for k, v in batch.items()})
    names, leaves = zip(*tp.named_parameters())
    with TD.use_policy(TD.MXU_FP32):
        tloss, tm = TL.make_loss_fn(tc, remat="none")(tp, _tbatch(batch))
    tgrads = dict(zip(names, torch.autograd.grad(tloss, leaves)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=MODEL_RTOL,
                               atol=MODEL_ATOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    got = jax.tree.leaves(params_to_numpy(tgrads, tc))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jgrads))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL * max(np.abs(w).max(), 1e-30))


def test_three_train_steps_match_reference():
    jc, tc = _reduced("dbrx-132b")
    jp = JT.init(jc, jax.random.key(1))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    jopt = JO.adamw(lr=JO.cosine_schedule(1e-3, 1, 3), eps=1e-3)
    topt = TO.adamw(lr=TO.cosine_schedule(1e-3, 1, 3), eps=1e-3)
    jstep = JL.make_train_step(jc, jopt, LOCAL, remat="none", donate=False,
                               numerics_policy=JD.MXU_FP32)
    tstep = TL.make_train_step(tc, topt, remat="none", numerics_policy=TD.MXU_FP32)
    jcarry, tcarry = (jp, jopt.init(jp)), (tp, topt.init(tp))
    for i in range(3):
        batch = _batch(jc, 2, 8, seed=20 + i)
        jcarry, jm = jstep(jcarry, {k: jnp.asarray(v) for k, v in batch.items()})
        tcarry, tm = tstep(tcarry, _tbatch(batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=MODEL_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=MODEL_RTOL)
    got = jax.tree.leaves(params_to_numpy(tcarry[0], tc))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jcarry[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=MODEL_RTOL, atol=MODEL_ATOL)


def _identity_opt():
    return TO.Optimizer(init=lambda p: {"grad_norm": torch.zeros(())},
                        update=lambda g, s, p: (g, s))


def test_fdp_grad_accumulation_is_order_invariant():
    """On the fixed-point grid, permuting the microbatches gives bit-equal
    gradients; 1, 2 and 4 microbatches agree within float error (each
    microbatch's gradient is a mean over its own rows, so a split is not a
    reordering and the splits are not bit-equal, in the reference either)."""
    _, tc = _reduced("paper-mlp")
    spec = AccumulatorSpec(ovf=10, msb=10, lsb=-20)
    batch = _tbatch(_batch(tc, 8, 6, seed=4))
    perm = torch.tensor([3, 1, 0, 2])
    permuted = {k: v.reshape(4, 2, *v.shape[1:])[perm].reshape(v.shape)
                for k, v in batch.items()}
    out = {}
    for name, mb, b in (("1", 1, batch), ("2", 2, batch), ("4", 4, batch),
                        ("4p", 4, permuted)):
        params = init(tc, seed=0, device="cpu")
        step = TL.make_train_step(tc, _identity_opt(), remat="none", microbatches=mb,
                                  fdp_grad_spec=spec, numerics_policy=TD.MXU_FP32)
        step((params, {"grad_norm": torch.zeros(())}), b)
        out[name] = [p.detach().clone() for p in params.parameters()]
    assert all(torch.equal(a, b) for a, b in zip(out["4"], out["4p"]))
    for name in ("2", "4"):
        for a, b in zip(out[name], out["1"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_remat_block_gradients_equal_none():
    _, tc = _reduced("dbrx-132b")
    params = init(tc, seed=2, device="cpu")
    batch = _tbatch(_batch(tc, 2, 6, seed=5))
    leaves = list(params.parameters())
    with TD.use_policy(FDP91_KERNEL):
        grads = {r: torch.autograd.grad(TL.make_loss_fn(tc, remat=r)(params, batch)[0], leaves)
                 for r in ("none", "block")}
    assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads["block"]))


# ---------------------------------------------------------------------------
# Checkpoints and the fault-tolerant Trainer
# ---------------------------------------------------------------------------
def _tree(step):
    return {"params": {"layers.0.w": torch.full((3, 4), float(step)), "b": torch.arange(5)},
            "opt_state": {"mu": {"w": {"q": torch.ones(2, 8, dtype=torch.int8),
                                       "exp": torch.zeros(2, dtype=torch.int8)}},
                          "step": torch.tensor(step, dtype=torch.int32)},
            "meta": [np.float32(1.5), (np.int64(2),)]}


def test_checkpoint_round_trip_retention_and_corruption(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        store.save(s, _tree(s), async_=s == 3)
    store.wait()
    assert store.all_steps() == [2, 3]
    step, tree = store.load_latest()
    assert step == 3
    np.testing.assert_array_equal(tree["params"]["layers.0.w"], np.full((3, 4), 3.0, np.float32))
    assert tree["opt_state"]["mu"]["w"]["q"].dtype == np.int8
    assert int(tree["opt_state"]["step"]) == 3 and isinstance(tree["meta"][1], tuple)
    with open(os.path.join(tmp_path, "step_00000003", "leaf_0000.npy"), "r+b") as f:
        f.seek(100)
        f.write(b"\x13\x37")
    assert store.load_latest()[0] == 2                    # the corrupt one is skipped
    assert sorted(os.listdir(tmp_path / "step_00000002")) == [
        "leaf_0000.npy", "leaf_0001.npy", "leaf_0002.npy", "leaf_0003.npy", "leaf_0004.npy",
        "leaf_0005.npy", "leaf_0006.npy", "manifest.json", "skeleton.json"]


def test_trainer_recovers_from_an_injected_failure(tmp_path):
    _, tc = _reduced("dbrx-132b")
    opt = TO.adamw(lr=1e-3, state_quant={m: TQ.parse_quant("8x64") for m in ("mu", "nu")})
    step_fn = TL.make_train_step(tc, opt, remat="none", numerics_policy=FDP91_KERNEL)
    batches = [_tbatch(_batch(tc, 2, 6, seed=30 + i)) for i in range(5)]
    crashed = []

    def injector(step):
        if step == 3 and not crashed:
            crashed.append(step)
            raise TL.InjectedFailure("simulated node failure")

    runs = {}
    for name, inj in (("failed", injector), ("clean", None)):
        trainer = TL.Trainer(tc, opt, batches.__getitem__, step_fn, str(tmp_path / name),
                             save_every=2, failure_injector=inj, device="cpu")
        params, _ = trainer.run(5)
        runs[name] = (params, trainer)
    assert crashed == [3] and runs["failed"][1].restarts == 1
    assert runs["clean"][1].restarts == 0
    for a, b in zip(runs["failed"][0].parameters(), runs["clean"][0].parameters()):
        assert torch.equal(a, b)
    assert [m["step"] for m in runs["failed"][1].metrics_log] == [0, 1, 2, 2, 3, 4]


def test_launch_train_runs_on_cpu(capsys):
    TLT.main(["--reduced", "--device", "cpu", "--steps", "2", "--opt-precision", "8x64"])
    out = capsys.readouterr().out
    assert "quantized optimizer state: mu=q8b64, nu=q8b64" in out and "restarts 0" in out
    with pytest.raises(ValueError, match="BITSxBLOCK"):
        TLT.parse_opt_precision("8by64")
    assert TLT.parse_opt_precision("fp32") is None
