"""The port's encoder-decoder family (whisper-large-v3) against
``repro.models`` on the CPU: the cross-attention (``attention_block`` with
``kv_override``), the cross K/V projections and ``_encoder_block``, then the
reduced model (2 + 2 layers, ``enc_seq`` 16) through ``forward``,
``prefill``, ``decode_step``, ``serve``, the loss gradients and the serve
CLI, with the reference's weights carried across by ``params_from_numpy``.

Tolerances, each relative to the largest |value| it is held against:
- the blocks within 1e-5 under native fp32; under FDP91 every dispatched
  site's output (``cross_k``, ``cross_v``, ``attn_q``/``_k``/``_v``/``_qk``/
  ``_av``/``_o``, ``mlp_*``) is equal bit for bit to the reference's
  ``dense``/``gemm`` on the same operands;
- the model's logits within 1e-4 of max |logit|, the caches after
  ``prefill`` within 1e-4 of each leaf's max |value|, greedy tokens equal,
  each gradient leaf within 1e-5 of its largest |g|.
The JAX side runs ``simulate`` for FDP91; the port runs ``FDP91_KERNEL``,
whose wrapper runs the kernel's plain version on CPU tensors."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.launch.serve import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import loop as TLOOP  # noqa: E402

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
BLOCK_TOL = 1e-5
MODEL_TOL = 1e-4
GRAD_TOL = 1e-5
POLICIES = {"native_fp32": (JD.MXU_FP32, TD.MXU_FP32),
            "fdp91": (JD.FDP91, TS.FDP91_KERNEL)}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _load(module, tree):
    """Copy a reference parameter dict (nested, numpy) into a port module."""
    flat = dict(_leaves(tree))
    own = dict(module.named_parameters())
    assert set(own) == set(flat)
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(_t(flat[k]))
    return module


@pytest.fixture
def recorded():
    """Every dispatch of the port as (site, a, b, out), from a trace hook."""
    calls = []
    remove = TD.add_trace_hook(lambda site, cfg, a, b, out: calls.append(
        (site, a.detach().numpy().copy(), b.detach().numpy().copy(),
         out.detach().numpy().copy())))
    yield calls
    remove()


def _held_bit_equal(calls, jpol):
    """Each recorded dispatch equals the reference's GEMM on its operands."""
    with JD.use_policy(jpol):
        for site, a, b, out in calls:
            want = np.asarray(JD.gemm(jnp.asarray(a), jnp.asarray(b), site=site))
            np.testing.assert_array_equal(out, want, site)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    jc, tc = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = jax.tree.map(np.asarray, JT._init_block(jax.random.key(5), jc, jnp.float32,
                                                  cross=True))
    tp = _load(TT.Block(tc, device="cpu", cross=True), jp)
    return jc, jp, tc, tp


@pytest.mark.parametrize("policy", ["native_fp32", "fdp91_simulate"])
def test_cross_attention_block(block, policy, recorded):
    """The decoder's cross-attention: K/V of an encoder output through
    ``cross_k``/``cross_v``, then ``attention_block(kv_override=)`` over 40
    keys (two chunks of the reduced config's 32, the second padded), at a
    prefill (5 queries) and a decode (1) shape."""
    jc, jp, tc, tp = block
    rng = np.random.default_rng(6)
    enc = rng.standard_normal((2, 40, jc.d_model)).astype(np.float32)
    jpol, tpol = ((JD.MXU_FP32, TD.MXU_FP32) if policy == "native_fp32"
                  else (JD.FDP91, TD.FDP91))
    for S in (5, 1):
        x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
        with JD.use_policy(jpol):
            kc = JL.dense(jnp.asarray(enc), jnp.asarray(jp["cross"]["wk"]), "cross_k")
            vc = JL.dense(jnp.asarray(enc), jnp.asarray(jp["cross"]["wv"]), "cross_v")
            kc = kc.reshape(2, -1, jc.n_kv_heads, jc.head_dim).transpose(0, 2, 1, 3)
            vc = vc.reshape(2, -1, jc.n_kv_heads, jc.head_dim).transpose(0, 2, 1, 3)
            jout, jcache = JL.attention_block(
                jnp.asarray(x), jax.tree.map(jnp.asarray, jp["cross"]), jc, JL.LOCAL,
                causal=False, kv_override=(kc, vc))
        recorded.clear()
        with TD.use_policy(tpol), torch.no_grad():
            tk, tv = TT._cross_kv(_t(enc), tp, tc)
            tout, tcache = TL.attention_block(_t(x), tp.cross, tc, causal=False,
                                              kv_override=(tk, tv))
        assert tcache is None and jcache is None
        _close(tk, kc, BLOCK_TOL, "cross K")
        _close(tv, vc, BLOCK_TOL, "cross V")
        _close(tout, jout, BLOCK_TOL, f"out, {S} queries")
        if policy == "fdp91_simulate":
            assert [c[0] for c in recorded] == ["cross_k", "cross_v", "attn_q", "attn_qk",
                                                "attn_av", "attn_qk", "attn_av", "attn_o"]
            _held_bit_equal(recorded, jpol)


def test_cross_attention_uses_no_rope(block):
    """The same queries at other positions give the same output: neither q
    nor the given K/V is rotated."""
    _, _, tc, tp = block
    rng = np.random.default_rng(7)
    x = _t(rng.standard_normal((1, 3, tc.d_model)).astype(np.float32))
    kv = tuple(_t(rng.standard_normal((1, tc.n_kv_heads, 8, tc.head_dim)).astype(np.float32))
               for _ in range(2))
    with TD.use_policy(TD.MXU_FP32), torch.no_grad():
        a, _ = TL.attention_block(x, tp.cross, tc, causal=False, kv_override=kv)
        b, _ = TL.attention_block(x, tp.cross, tc, causal=False, kv_override=kv,
                                  positions=torch.tensor([7, 9, 11]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["native_fp32", "fdp91_simulate"])
def test_encoder_block(block, policy, recorded):
    jc, jp, tc, tp = block
    x = np.random.default_rng(8).standard_normal((2, 40, jc.d_model)).astype(np.float32)
    jpol, tpol = ((JD.MXU_FP32, TD.MXU_FP32) if policy == "native_fp32"
                  else (JD.FDP91, TD.FDP91))
    with JD.use_policy(jpol):
        want = JT._encoder_block(jnp.asarray(x), jax.tree.map(jnp.asarray, jp), jc, JL.LOCAL)
    recorded.clear()
    with TD.use_policy(tpol), torch.no_grad():
        got = TT._encoder_block(_t(x), tp, tc)
    _close(got, want, BLOCK_TOL)
    if policy == "fdp91_simulate":
        assert [c[0] for c in recorded] == ["attn_q", "attn_k", "attn_v", "attn_qk", "attn_av",
                                            "attn_qk", "attn_av", "attn_o", "mlp_in",
                                            "mlp_gate", "mlp_out"]
        _held_bit_equal(recorded, jpol)


def test_layer_norm():
    rng = np.random.default_rng(9)
    x, scale, bias = (rng.standard_normal(s).astype(np.float32) for s in ((3, 5, 24), 24, 24))
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    _close(TL.layer_norm(_t(x), _t(scale), _t(bias)), want, BLOCK_TOL)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def model():
    jc, tc = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = JT.init(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    return jc, jp, tree, tc, params_from_numpy(tree, tc, device="cpu")


def _batch(cfg, B, S, seed, targets=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "frames": (0.5 * rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                      ).astype(np.float32)}
    if targets:
        out["targets"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        out["loss_mask"] = np.ones((B, S), np.float32)
    return out


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()).long() if k in ("tokens", "targets")
            else torch.from_numpy(v.copy()) for k, v in batch.items()}


def test_params_round_trip(model):
    jc, jp, tree, tc, tp = model
    back = params_to_numpy(tp, tc)
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert set(got) == set(want)
    assert {k.split(".")[0] for k in got} == {"embed", "final_norm", "lm_head", "enc_norm",
                                             "enc_layers", "dec_layers"}
    for leaf, arr in want.items():
        assert got[leaf].dtype == arr.dtype, leaf
        np.testing.assert_array_equal(got[leaf], arr, leaf)
    assert want["enc_layers.attn.wq"].shape[0] == tc.n_enc_layers
    assert want["dec_layers.cross.wk"].shape[0] == tc.n_layers
    # and the other way: the port's own draw through the tree and back
    own = TT.init(tc, seed=3, device="cpu")
    again = params_from_numpy(params_to_numpy(own, tc), tc, device="cpu")
    for (k, a), (k2, b) in zip(own.named_parameters(), again.named_parameters()):
        assert k == k2 and torch.equal(a, b), k
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in want.values())


@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_logits(model, policy):
    jc, jp, tree, tc, tp = model
    jpol, tpol = POLICIES[policy]
    batch = _batch(jc, 2, 7, seed=1)
    with JD.use_policy(jpol):
        want = np.asarray(JT.forward(jp, jc, _jb(batch)))
    with TD.use_policy(tpol), torch.no_grad():
        got = TT.forward(tp, tc, _tb(batch))
    assert got.shape == (2, 7, tc.padded_vocab)
    _close(got[..., :tc.vocab_size], want[..., :jc.vocab_size], MODEL_TOL)


def test_prefill_decode_step_and_caches(model):
    """The reference's ``test_decode_parity`` for encdec (prefill's last
    logits against forward's last position, rtol 1e-4), and both against
    the reference's; the caches leaf by leaf, the encoder's cross K/V
    included; ``decode_step`` updates them in place."""
    jc, jp, tree, tc, tp = model
    batch = _batch(jc, 2, 6, seed=2)
    nxt = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
    with JD.use_policy(JD.MXU_FP32):
        jfull = np.asarray(JT.forward(jp, jc, _jb(batch), remat="none"))
        jcache = JT.init_cache(jc, 2, 10, dtype=jnp.float32)
        jlast, jcache = JT.prefill(jp, jc, _jb(batch), jcache)
        want = dict(_leaves({k: v for k, v in jax.tree.map(np.asarray, jcache).items()
                             if k != "len"}))
        jlog, _ = JT.decode_step(jp, jc, jcache, jnp.asarray(nxt))
    with TD.use_policy(TD.MXU_FP32):
        tcache = TT.init_cache(tc, 2, 10, dtype=torch.float32, device="cpu")
        empty = dict(_leaves({k: v for k, v in tcache.items() if k != "len"}))
        tlast, tcache = TT.prefill(tp, tc, _tb(batch), tcache)
        filled = {k: v.clone() for k, v in _leaves({k: v for k, v in tcache.items()
                                                    if k != "len"})}
        tlog, after = TT.decode_step(tp, tc, tcache, torch.from_numpy(nxt).long())
        with torch.no_grad():
            full = TT.forward(tp, tc, _tb(batch), remat="none")
    assert tcache["len"] == 6 and after["len"] == 7
    V = tc.vocab_size
    np.testing.assert_allclose(np.asarray(jlast), jfull[:, -1], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tlast.numpy(), full[:, -1].numpy(), rtol=1e-4, atol=1e-4)
    _close(tlast[:, :V], np.asarray(jlast)[:, :V], MODEL_TOL, "prefill")
    _close(tlog[..., :V], np.asarray(jlog)[..., :V], MODEL_TOL, "decode_step")
    assert set(filled) == set(want) and {"cross.k", "cross.v"} <= set(want)
    assert filled["cross.k"].shape == (tc.n_layers, 2, tc.n_kv_heads, tc.enc_seq,
                                       tc.head_dim)
    for leaf, arr in want.items():
        assert filled[leaf].dtype == torch.float32, leaf
        _close(filled[leaf], arr, MODEL_TOL, leaf)
    for leaf, t in _leaves({k: v for k, v in after.items() if k != "len"}):
        assert t is empty[leaf], f"{leaf} is not the cache tensor updated in place"


@pytest.mark.parametrize("policy", ["native_fp32"])
def test_serve_tokens_equal(model, policy):
    """``serve`` gives the model zero frames, as the reference's does. (FDP91
    reaches no site here that ``test_forward_logits`` and the blocks' tests
    do not hold bit for bit; the reference's ``simulate`` serve costs ~30 s
    of compiles.)"""
    jc, jp, tree, tc, tp = model
    prompts = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 4)).astype(np.int32)
    jpol, tpol = POLICIES[policy]
    with JD.use_policy(jpol):
        want = np.asarray(jserve(jc, jp, jnp.asarray(prompts), 3))
    with TD.use_policy(tpol):
        got = TS.serve(tc, tp, torch.from_numpy(prompts), 3, device="cpu")
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_loss_and_grads_match_reference(model):
    jc, jp, tree, tc, tp = model
    batch = _batch(jc, 2, 6, seed=5, targets=True)
    with JD.use_policy(JD.MXU_FP32):
        (jloss, _), jgrads = jax.value_and_grad(
            JLOOP.make_loss_fn(jc, JL.LOCAL, remat="none"), has_aux=True)(jp, _jb(batch))
    names, leaves = zip(*tp.named_parameters())
    with TD.use_policy(TD.MXU_FP32):
        tloss, _ = TLOOP.make_loss_fn(tc, remat="block")(tp, _tb(batch))
    tgrads = dict(zip(names, torch.autograd.grad(tloss, leaves)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    got = dict(_leaves(params_to_numpy(tgrads, tc)))
    assert set(got) == set(want)
    for leaf, w in want.items():
        _close(got[leaf], w, GRAD_TOL, leaf)
    assert np.abs(got["enc_layers.attn.wq"]).max() > 0        # the encoder is trained


def test_cache_rows_checked(model):
    tc, tp = model[3:]
    cache = TT.init_cache(tc, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="1 rows of tokens, the cache holds 2"):
        TT.decode_step(tp, tc, cache, torch.zeros(1, 1, dtype=torch.long))


def test_serve_cli_reduced_on_cpu(capsys):
    """The CLI's simple engine serves the reduced model on the CPU, under the
    kernel policy and under the checked-in zoo plan, unchanged."""
    for extra in (["--policy", "fdp91_kernel"],
                  ["--precision-plan", "examples/plans/whisper_large_v3.json"]):
        TS.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "3",
                 "--gen", "2", "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert "device=cpu" in out and "sample:" in out, out
