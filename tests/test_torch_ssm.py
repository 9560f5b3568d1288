"""The port's Mamba-2 families against ``repro.models`` on the CPU: the SSD
primitives of ``models/ssm.py``, ``ssm_block`` in prefill and decode, and
the ``ssm`` (mamba2-1.3b) and ``hybrid`` (zamba2-2.7b) models through
``forward``, ``prefill``, ``decode_step`` and ``serve``, with the
reference's weights carried across by ``params_from_numpy``.

Tolerances, each relative to the largest |value| it is held against:
- the primitives (conv, segsum, chunked SSD, SSD step) within 1e-5: the same
  f32 operations, summed in other orders by the two einsum back ends;
- ``ssm_block`` within 1e-5; under FDP91 every ``dense`` site's output is
  equal bit for bit to the reference's on the same inputs;
- the models' logits within 1e-4 of max |logit|, the caches after
  ``prefill`` within 1e-4 of each leaf's max |value|; greedy tokens equal.
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
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import ssm as TSSM  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.set_num_threads(1)

PRIM_TOL = 1e-5
MODEL_TOL = 1e-4
MODELS = {"mamba2": ("mamba2-1.3b", {}),
          "zamba2": ("zamba2-2.7b", {}),                      # attn_every 1, two groups
          "zamba2_ae2": ("zamba2-2.7b", dict(n_layers=4, attn_every=2))}
POLICIES = {"native_fp32": (JD.MXU_FP32, TD.MXU_FP32),
            "fdp91": (JD.FDP91, TS.FDP91_KERNEL)}
# the JAX side compiles its simulate FDP for every model and entry point
# (15-37 s each on one CPU thread), so FDP91 runs where it reaches new code:
# the SSM sites (mamba2) and the shared block's (zamba2 with two SSM layers a
# group); ssm_block holds every SSM site bit-equal to the reference's under it
FDP91_FORWARD = ("mamba2", "zamba2_ae2")
FDP91_SERVE = ("mamba2",)


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max |diff| {err} > {tol} x {scale}"


def _t(a):
    return torch.from_numpy(np.array(a))


def _ssd_inputs(rng, b=2, l=24, h=4, p=8, g=2, n=8):
    return dict(x=rng.standard_normal((b, l, h, p)).astype(np.float32),
                dt=rng.uniform(0.1, 0.9, (b, l, h)).astype(np.float32),
                A=rng.uniform(-1, 0.5, (h,)).astype(np.float32),
                B=rng.standard_normal((b, l, g, n)).astype(np.float32),
                C=rng.standard_normal((b, l, g, n)).astype(np.float32))


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    kern = rng.standard_normal((4, 12)).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state else None
    jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(kern),
                             None if state is None else jnp.asarray(state))
    ty, ts = TSSM._causal_conv(_t(x), _t(kern), None if state is None else _t(state))
    _close(ty, jy, PRIM_TOL, "y")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))   # the trailing inputs


def test_segsum():
    a = np.random.default_rng(1).standard_normal((2, 3, 8)).astype(np.float32)
    want, got = np.asarray(JS._segsum(jnp.asarray(a))), TSSM._segsum(_t(a)).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], PRIM_TOL)


@pytest.mark.parametrize("l,chunk,with_state", [(24, 4, False), (24, 8, False),
                                                (24, 16, False), (13, 8, True)])
def test_ssd_chunked(l, chunk, with_state):
    rng = np.random.default_rng(2)
    inp = _ssd_inputs(rng, l=l)
    S0 = rng.standard_normal((2, 2, 2, 8, 8)).astype(np.float32) if with_state else None
    jy, jS = JS.ssd_chunked(*(jnp.asarray(inp[k]) for k in "x dt A B C".split()),
                            chunk=chunk, init_state=None if S0 is None else jnp.asarray(S0))
    ty, tS = TSSM.ssd_chunked(*(_t(inp[k]) for k in "x dt A B C".split()), chunk=chunk,
                              init_state=None if S0 is None else _t(S0))
    assert ty.shape == (2, l, 4, 8) and tS.dtype == torch.float32
    _close(ty, jy, PRIM_TOL, "y")
    _close(tS, jS, PRIM_TOL, "state")


def test_ssd_step():
    rng = np.random.default_rng(3)
    inp = _ssd_inputs(rng, l=1)
    S = rng.standard_normal((2, 2, 2, 8, 8)).astype(np.float32)
    args = (inp["x"][:, 0], inp["dt"][:, 0], inp["A"], inp["B"][:, 0], inp["C"][:, 0])
    jy, jS = JS.ssd_step(jnp.asarray(S), *(jnp.asarray(a) for a in args))
    ty, tS = TSSM.ssd_step(_t(S), *(_t(a) for a in args))
    _close(ty, jy, PRIM_TOL, "y")
    _close(tS, jS, PRIM_TOL, "state")


def test_ssd_step_matches_chunked():
    """The port's own step recurrence over a sequence against its chunked
    form (the reference's ``test_ssd_step_matches_chunked``, its tolerance)."""
    inp = _ssd_inputs(np.random.default_rng(4), b=1, l=12)
    x, dt, A, B, C = (_t(inp[k]) for k in "x dt A B C".split())
    y_ref, S_ref = TSSM.ssd_chunked(x, dt, A, B, C, chunk=4)
    S = torch.zeros((1, 2, 2, 8, 8))
    ys = []
    for t in range(x.shape[1]):
        y, S = TSSM.ssd_step(S, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_ref.numpy(), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(S.numpy(), S_ref.numpy(), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# ssm_block
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def block():
    jc, tc = jget("mamba2-1.3b").reduced(), tget("mamba2-1.3b").reduced()
    jp = JS.init_ssm(jax.random.key(5), jc)
    tp = TSSM.SSM(tc, device="cpu")
    assert [k for k, _ in tp.named_parameters()] == list(jp)
    with torch.no_grad():
        for k, p in tp.named_parameters():
            p.copy_(_t(jp[k]))
    return jc, jp, tc, tp


def _block_cache(cfg, rng):
    g, e = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
    w, gn = cfg.ssm_conv, cfg.ssm_groups * cfg.ssm_state
    return {"conv_x": rng.standard_normal((2, w - 1, cfg.d_inner)).astype(np.float32),
            "conv_B": rng.standard_normal((2, w - 1, gn)).astype(np.float32),
            "conv_C": rng.standard_normal((2, w - 1, gn)).astype(np.float32),
            "state": rng.standard_normal((2, g, e, cfg.ssm_head_dim,
                                          cfg.ssm_state)).astype(np.float32)}


@pytest.mark.parametrize("policy", ["native_fp32", "fdp91_simulate"])
@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_ssm_block(block, policy, mode, monkeypatch):
    jc, jp, tc, tp = block
    rng = np.random.default_rng(6)
    S = 9 if mode == "prefill" else 1
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    cache = _block_cache(jc, rng) if mode == "decode" else None
    jpol, tpol = ((JD.MXU_FP32, TD.MXU_FP32) if policy == "native_fp32"
                  else (JD.FDP91, TD.FDP91))
    sites = []
    dense = TSSM.dense

    def recording(a, w, site, *args, **kw):
        out = dense(a, w, site, *args, **kw)
        sites.append((site, a.detach().numpy().copy(), w.detach().numpy().copy(),
                      out.detach().numpy().copy()))
        return out

    monkeypatch.setattr(TSSM, "dense", recording)
    with JD.use_policy(jpol):
        jout, jcache = JS.ssm_block(jnp.asarray(x), jp, jc, JL.LOCAL,
                                    cache=None if cache is None else
                                    {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = None if cache is None else {k: _t(v.copy()) for k, v in cache.items()}
    with TD.use_policy(tpol), torch.no_grad():
        tout, ncache = TSSM.ssm_block(_t(x), tp, tc, cache=tcache)
    _close(tout, jout, PRIM_TOL, "out")
    if cache is None:
        assert ncache is None and jcache is None
    else:
        for k in TSSM.CACHE_KEYS:
            assert ncache[k] is tcache[k]                       # updated in place
            _close(tcache[k], jcache[k], PRIM_TOL, k)
    assert [s[0] for s in sites] == ["ssm_x", "ssm_z", "ssm_B", "ssm_C", "ssm_dt", "ssm_out"]
    if policy == "fdp91_simulate":
        with JD.use_policy(jpol):
            for site, a, w, out in sites:
                np.testing.assert_array_equal(
                    out, np.asarray(JL.dense(jnp.asarray(a), jnp.asarray(w), site)), site)


def test_ssm_block_refuses_a_mesh(block):
    _, _, tc, tp = block
    dist = TT.L.Distribution(mesh=object())
    with pytest.raises(NotImplementedError, match="the sharded SSM"):
        TSSM.ssm_block(torch.zeros(1, 2, tc.d_model), tp, tc, dist)


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """name -> (jax cfg, jax params, numpy tree, port cfg, port params), each
    built on first use."""
    built = {}

    def get(name):
        if name not in built:
            arch, over = MODELS[name]
            jc, tc = jget(arch).reduced(**over), tget(arch).reduced(**over)
            jp = JT.init(jc, jax.random.key(0))
            tree = jax.tree.map(np.asarray, jp)
            built[name] = (jc, jp, tree, tc, params_from_numpy(tree, tc, device="cpu"))
        return built[name]
    return get


def _policy_cases(fdp91_models):
    return [pytest.param(m, p, id=f"{m}-{p}") for m in MODELS for p in POLICIES
            if p == "native_fp32" or m in fdp91_models]


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def _cache_leaves(cache):
    return dict(_leaves({k: v for k, v in cache.items() if k != "len"}))


@pytest.mark.parametrize("name", list(MODELS))
def test_params_round_trip(models, name):
    jc, jp, tree, tc, tp = models(name)
    back = params_to_numpy(tp, tc)
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert set(got) == set(want)
    for leaf, arr in want.items():
        assert got[leaf].shape == arr.shape and got[leaf].dtype == arr.dtype, leaf
        np.testing.assert_array_equal(got[leaf], arr, leaf)
    assert sum(p.numel() for p in tp.parameters()) == sum(a.size for a in want.values())
    if tc.family == "hybrid":
        assert want["layers.ssm.in_x"].shape[:2] == (tc.n_layers // tc.attn_every,
                                                     tc.attn_every)
        np.testing.assert_array_equal(tp.shared.attn.wq.detach().numpy(),
                                      tree["shared"]["attn"]["wq"])


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_params_from_another_family_name_both_sides(models, name):
    tree = models(name)[2]
    other = tget("zamba2-2.7b" if name == "mamba2" else "mamba2-1.3b").reduced()
    with pytest.raises(ValueError, match="only in the port.*only in the tree"):
        params_from_numpy(tree, other, device="cpu")


@pytest.mark.parametrize("name,policy", _policy_cases(FDP91_FORWARD))
def test_forward_logits(models, name, policy):
    jc, jp, tree, tc, tp = models(name)
    jpol, tpol = POLICIES[policy]
    toks = _tokens(jc, (2, 11), seed=1)
    with JD.use_policy(jpol):
        want = np.asarray(JT.forward(jp, jc, {"tokens": jnp.asarray(toks)}))
    with TD.use_policy(tpol):
        got = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 11, tc.padded_vocab)
    _close(got.detach()[..., :tc.vocab_size], want[..., :jc.vocab_size], MODEL_TOL)


@pytest.mark.parametrize("name", list(MODELS))
def test_prefill_decode_step_and_caches(models, name):
    jc, jp, tree, tc, tp = models(name)
    toks, nxt = _tokens(jc, (2, 5), seed=2), _tokens(jc, (2, 1), seed=3)
    with JD.use_policy(JD.MXU_FP32):
        jcache = JT.init_cache(jc, 2, 8, dtype=jnp.float32)
        jlast, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, jcache)
        want = _cache_leaves(jax.tree.map(np.asarray, jcache))
        jlog, _ = JT.decode_step(jp, jc, jcache, jnp.asarray(nxt))
    with TD.use_policy(TD.MXU_FP32):
        tcache = TT.init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
        empty = _cache_leaves(tcache)
        tlast, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks).long()}, tcache)
        filled = {k: v.clone() for k, v in _cache_leaves(tcache).items()}
        tlog, after = TT.decode_step(tp, tc, tcache, torch.from_numpy(nxt).long())
        full = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
    assert tcache["len"] == 5 and after["len"] == 6
    V = tc.vocab_size
    _close(tlast[:, :V], np.asarray(jlast)[:, :V], MODEL_TOL, "prefill")
    _close(tlog[..., :V], np.asarray(jlog)[..., :V], MODEL_TOL, "decode_step")
    # prefill (the step SSD) against forward's last position (the chunked SSD)
    _close(tlast[:, :V], full[:, -1, :V].detach(), MODEL_TOL, "prefill vs forward")
    assert set(filled) == set(want)
    for leaf, arr in want.items():
        assert tuple(filled[leaf].shape) == arr.shape, leaf
        assert filled[leaf].dtype == torch.float32
        _close(filled[leaf], arr, MODEL_TOL, leaf)
    for leaf, t in _cache_leaves(after).items():
        assert t is empty[leaf], f"{leaf} is not the cache tensor updated in place"


@pytest.mark.parametrize("name,policy", _policy_cases(FDP91_SERVE))
def test_serve_tokens_equal(models, name, policy):
    jc, jp, tree, tc, tp = models(name)
    prompts = _tokens(jc, (2, 4), seed=4)
    jpol, tpol = POLICIES[policy]
    with JD.use_policy(jpol):
        want = np.asarray(jserve(jc, jp, jnp.asarray(prompts), 3))
    with TD.use_policy(tpol):
        got = TS.serve(tc, tp, torch.from_numpy(prompts), 3, device="cpu")
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", ["mamba2", "zamba2"])
def test_cache_rows_checked(models, name):
    tc, tp = models(name)[3:]
    cache = TT.init_cache(tc, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="1 rows of tokens, the cache holds 2"):
        TT.decode_step(tp, tc, cache, torch.zeros(1, 1, dtype=torch.long))


@pytest.mark.parametrize("arch,plan", [("mamba2-1.3b", "examples/plans/mamba2_1p3b.json"),
                                       ("zamba2-2.7b", "examples/plans/zamba2_2p7b.json")])
def test_serve_cli_reduced_on_cpu(capsys, arch, plan):
    """The CLI's simple engine serves both families reduced on the CPU, under
    the kernel policy and under the architecture's zoo plan, unchanged."""
    for extra in (["--policy", "fdp91_kernel"], ["--precision-plan", plan]):
        TS.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "3",
                 "--gen", "2", "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert "device=cpu" in out and "sample:" in out, out
