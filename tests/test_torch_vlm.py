"""The port's VLM family (paligemma-3b) against ``repro.models`` on the
CPU: the reduced model (2 layers, MQA, 8 patches) through ``forward`` (the
patches ahead of the text, a bidirectional prefix over them), ``prefill``
(which, as the reference's, reads no patches), ``decode_step``, ``serve``,
the loss gradients (text positions only), the score engine and the serve
CLI, with the reference's weights carried across by ``params_from_numpy``.

Tolerances, each relative to the largest |value| it is held against: the
logits within 1e-4 of max |logit| (FDP91: the reference in ``simulate``,
the port's ``FDP91_KERNEL`` through the kernel's plain version on CPU
tensors), the caches within 1e-4 of each leaf's max |value|, greedy tokens
equal, each gradient leaf within 1e-5 of its largest |g|."""

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
from repro_torch.models import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import loop as TLOOP  # noqa: E402

torch.set_num_threads(1)

ARCH = "paligemma-3b"
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


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


@pytest.fixture(scope="module")
def model():
    jc, tc = jget(ARCH).reduced(), tget(ARCH).reduced()
    jp = JT.init(jc, jax.random.key(0))
    tree = jax.tree.map(np.asarray, jp)
    return jc, jp, tree, tc, params_from_numpy(tree, tc, device="cpu")


def _batch(cfg, B, S, seed, targets=False):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "patches": (0.5 * rng.standard_normal((B, cfg.n_patches, cfg.d_model))
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
    assert tc.n_kv_heads == 1 and tc.n_patches == 8
    back = params_to_numpy(tp, tc)
    want, got = dict(_leaves(tree)), dict(_leaves(back))
    assert set(got) == set(want)
    for leaf, arr in want.items():
        assert got[leaf].dtype == arr.dtype, leaf
        np.testing.assert_array_equal(got[leaf], arr, leaf)
    own = TT.init(tc, seed=3, device="cpu")
    again = params_from_numpy(params_to_numpy(own, tc), tc, device="cpu")
    for (k, a), (k2, b) in zip(own.named_parameters(), again.named_parameters()):
        assert k == k2 and torch.equal(a, b), k


@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_logits(model, policy):
    jc, jp, tree, tc, tp = model
    jpol, tpol = POLICIES[policy]
    batch = _batch(jc, 2, 7, seed=1)
    with JD.use_policy(jpol):
        want = np.asarray(JT.forward(jp, jc, _jb(batch)))
    with TD.use_policy(tpol), torch.no_grad():
        got = TT.forward(tp, tc, _tb(batch))
    assert got.shape == (2, tc.n_patches + 7, tc.padded_vocab)
    _close(got[..., :tc.vocab_size], want[..., :jc.vocab_size], MODEL_TOL)


def test_prefix_changes_text_logits(model):
    """The reference's ``test_vlm_prefix_changes_text_logits``: the image
    prefix reaches the text logits (the prefix-LM wiring); and, as there,
    the prefix is bidirectional: the first patch's logits depend on the
    last patch."""
    tc, tp = model[3:]
    batch = _tb(_batch(tc, 2, 12, seed=2))
    moved = dict(batch, patches=batch["patches"] + 1.0)
    last_only = dict(batch, patches=batch["patches"].clone())
    last_only["patches"][:, -1] += 1.0
    with TD.use_policy(TD.MXU_FP32), torch.no_grad():
        l1, l2, l3 = (TT.forward(tp, tc, b) for b in (batch, moved, last_only))
    assert float((l1[:, -1] - l2[:, -1]).abs().max()) > 1e-4
    assert float((l1[:, 0] - l3[:, 0]).abs().max()) > 1e-4


def test_prefill_decode_step_and_caches(model):
    """``prefill`` reads no patches (the reference's too: its
    ``test_decode_parity`` leaves paligemma out for that reason): it equals
    the reference's and its own prefill without them; the caches leaf by
    leaf; ``decode_step`` updates them in place."""
    jc, jp, tree, tc, tp = model
    batch = _batch(jc, 2, 5, seed=3)
    nxt = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
    with JD.use_policy(JD.MXU_FP32):
        jcache = JT.init_cache(jc, 2, 8, dtype=jnp.float32)
        jlast, jcache = JT.prefill(jp, jc, _jb(batch), jcache)
        want = dict(_leaves({k: v for k, v in jax.tree.map(np.asarray, jcache).items()
                             if k != "len"}))
        jlog, _ = JT.decode_step(jp, jc, jcache, jnp.asarray(nxt))
    with TD.use_policy(TD.MXU_FP32):
        bare = TT.init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
        bare_last, _ = TT.prefill(tp, tc, {"tokens": _tb(batch)["tokens"]}, bare)
        tcache = TT.init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
        empty = dict(_leaves({k: v for k, v in tcache.items() if k != "len"}))
        tlast, tcache = TT.prefill(tp, tc, _tb(batch), tcache)
        filled = {k: v.clone() for k, v in _leaves({k: v for k, v in tcache.items()
                                                    if k != "len"})}
        tlog, after = TT.decode_step(tp, tc, tcache, torch.from_numpy(nxt).long())
    assert torch.equal(tlast, bare_last)
    assert set(filled) == set(want) == {"layers.k", "layers.v"}
    V = tc.vocab_size
    _close(tlast[:, :V], np.asarray(jlast)[:, :V], MODEL_TOL, "prefill")
    _close(tlog[..., :V], np.asarray(jlog)[..., :V], MODEL_TOL, "decode_step")
    for leaf, arr in want.items():
        _close(filled[leaf], arr, MODEL_TOL, leaf)
    for leaf, t in _leaves({k: v for k, v in after.items() if k != "len"}):
        assert t is empty[leaf], f"{leaf} is not the cache tensor updated in place"


def test_serve_tokens_equal(model):
    """``serve`` gives the model zero patches, as the reference's does."""
    jc, jp, tree, tc, tp = model
    prompts = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 4)).astype(np.int32)
    with JD.use_policy(JD.MXU_FP32):
        want = np.asarray(jserve(jc, jp, jnp.asarray(prompts), 3))
    with TD.use_policy(TD.MXU_FP32):
        got = TS.serve(tc, tp, torch.from_numpy(prompts), 3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_loss_and_grads_match_reference(model):
    """The loss scores the text positions only (the reference's
    ``make_loss_fn``)."""
    jc, jp, tree, tc, tp = model
    batch = _batch(jc, 2, 6, seed=6, targets=True)
    with JD.use_policy(JD.MXU_FP32):
        (jloss, jm), jgrads = jax.value_and_grad(
            JLOOP.make_loss_fn(jc, JL.LOCAL, remat="none"), has_aux=True)(jp, _jb(batch))
    names, leaves = zip(*tp.named_parameters())
    with TD.use_policy(TD.MXU_FP32):
        tloss, tm = TLOOP.make_loss_fn(tc, remat="block")(tp, _tb(batch))
    tgrads = dict(zip(names, torch.autograd.grad(tloss, leaves)))
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=1e-5)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    want = dict(_leaves(jax.tree.map(np.asarray, jgrads)))
    got = dict(_leaves(params_to_numpy(tgrads, tc)))
    assert set(got) == set(want)
    for leaf, w in want.items():
        _close(got[leaf], w, GRAD_TOL, leaf)


def test_score_engine_scores_the_text(model):
    """The routed tier's score engine gives the model zero patches and
    scores the text positions, as the reference's does."""
    from repro_torch.serving import Bucket, ScoreEngine
    tc, tp = model[3:]
    prompts = [[3, 7, 11, 2, 9], [5, 1, 4]]
    eng = ScoreEngine(tc, tp, Bucket(max_len=6, n_slots=2), TD.MXU_FP32)
    got = eng.score_batch(prompts)
    for p, score in zip(prompts, got):
        toks = torch.tensor([p])
        with TD.use_policy(TD.MXU_FP32), torch.no_grad():
            logits = TT.forward(tp, tc, {"tokens": toks,
                                         "patches": torch.zeros(1, tc.n_patches, tc.d_model)})
        logp = torch.log_softmax(logits[0, tc.n_patches:, :tc.vocab_size], dim=-1)
        want = float(sum(logp[i, p[i + 1]] for i in range(len(p) - 1)))
        assert abs(score - want) <= 1e-5 * abs(want), (score, want)


def test_serve_cli_reduced_on_cpu(capsys):
    """The CLI serves the reduced model on the CPU under the kernel policy,
    under the checked-in zoo plan (unchanged) and through the continuous
    engine (eager steps on the CPU), which the vlm family reaches."""
    for extra in (["--policy", "fdp91_kernel"],
                  ["--precision-plan", "examples/plans/paligemma_3b.json"],
                  ["--engine", "continuous", "--policy", "mxu_fp32"]):
        TS.main(["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len", "3",
                 "--gen", "2", "--device", "cpu", *extra])
        out = capsys.readouterr().out
        assert "device=cpu" in out and "sample:" in out, out
