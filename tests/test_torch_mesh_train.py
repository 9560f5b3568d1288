"""Data-parallel training over a gloo world of 8 CPU ranks, the port's
counterpart of the reference's ``check_mesh_reshape_logits``: reduced
paper-mlp from weights carried over from the JAX package (rank 0's,
broadcast), the ``mesh`` workload on every factorization of the world
(1x8, 2x4, 4x2, 8x1), and one ``make_mesh_train_step`` on 1x8, 2x4 and
8x1, under the zoo plan (native at every site) and under a policy written
here that puts every one of the plan's sites in ``simulate`` ⟨30,30,-30⟩
(the zoo plans exercise no FDP site, ROADMAP section 3).

The reference's own step runs in a subprocess on 8 placeholder devices
(``tests/_torch_mesh_jax.py``), started before the world and read after
it. Every spawn and subprocess has a timeout.

Tolerances, and why:
- Across factorizations: bit-equal. A rank's shapes depend only on the rank
  count and the gradient mean is an exact int32 all-reduce, so the mesh
  report reads 53.0 bits of logits and gradient agreement, every FDP site
  53.0, and the stepped parameters are equal on every mesh and rank.
- The port's 1x8 step against the reference's. Both take the fixed-point
  mean of the same eight one-sequence gradients, but each rank's local
  native GEMMs sum in another order than XLA's (ROADMAP section 3), which
  moves a rank's gradient by ulps and, now and then, onto the next 2^-20
  grid point. So:
  - the reduced gradients, leaf by leaf, within one grid point (atol
    2^-20: eight ranks, each at most one point off, over n = 8) and rtol
    1e-5, and the step's gradient norm within rtol 1e-5. These see the
    mean's scale, which the stepped parameters cannot: AdamW's first
    update is ~lr * sign(g) whatever |g|;
  - in each leaf, all but 0.1% of the parameters (at least one may
    differ) within rtol 1e-4 / atol 1e-6, and every one within 1.01 lr: a
    flip of a gradient near zero moves its parameter by up to lr
    (measured: 1 element of 16,384 in one leaf, 7.6e-4 at lr 1e-3);
  - the loss within rtol 1e-5.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402

import _torch_mesh_worker as W  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN = os.path.join(ROOT, "examples", "plans", "paper_mlp.json")
WORLD = 8
SHAPES = [(1, 8), (2, 4), (8, 1)]
LR = 1e-3
PARAM_RTOL, PARAM_ATOL, FLIPS, LOSS_RTOL = 1e-4, 1e-6, 1e-3, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 2.0 ** -20      # one point of the 2^-20 grid


def flatten(tree, prefix=""):
    """A nested dict of arrays as ``{"a/b/c": array}`` (the helper script's
    layout; it is not imported here: it sets the JAX device count)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs():
    jcfg = jget("paper-mlp").reduced()
    tree = jax.tree.map(np.asarray, JT.init(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (WORLD, 8)).astype(np.int32),
             "targets": rng.integers(0, jcfg.vocab_size, (WORLD, 8)).astype(np.int32),
             "loss_mask": np.ones((WORLD, 8), np.float32)}
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, **{f"p/{k}": v for k, v in flatten(tree).items()},
                 **{f"b/{k}": v for k, v in batch.items()})
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        env.pop("XLA_FLAGS", None)
        ref = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_mesh_jax.py"),
                                inp, out], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        try:
            res = TM.spawn(W.mesh_train, WORLD, args=(tree, batch, PLAN, SHAPES),
                           timeout=400, collective_timeout=120)
            stdout, stderr = ref.communicate(timeout=400)
        finally:
            ref.kill()
            ref.wait()
        assert ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        z = np.load(out)
        jax_step = {"loss": float(z["loss"]), "grad_norm": float(z["grad_norm"]),
                    "params": {k[2:]: z[k] for k in z.files if k.startswith("p/")},
                    "grads": {k[2:]: z[k] for k in z.files if k.startswith("g/")}}
    return res, jax_step


@pytest.mark.parametrize("policy", ["zoo", "fdp"])
def test_mesh_report_reads_every_factorization(runs, policy):
    res, _ = runs
    rep = res[0]["reports"][policy]
    assert rep["mesh"] == "1x8,2x4,4x2,8x1"
    assert rep["details"]["logits_bits"] == 53.0
    assert rep["details"]["grad_bits"] == 53.0
    assert rep["site_attribution"]["*"] == rep["site_attribution"]["*@bwd"] == 53.0
    assert all(r["reports"][policy] == rep for r in res), "ranks disagree"


def test_every_fdp_site_is_bit_identical_across_meshes(runs):
    res, _ = runs
    fdp, zoo = res[0]["reports"]["fdp"], res[0]["reports"]["zoo"]
    sites = {k: v for k, v in fdp["site_attribution"].items() if "*" not in k}
    assert len(sites) == 30 and set(sites) == {k for k in zoo["site_attribution"]
                                               if "*" not in k}
    assert all(v == 53.0 for v in sites.values()), sites
    assert fdp["details"]["bit_identical_sites"] == 30
    assert fdp["passed"] and zoo["passed"]


@pytest.mark.parametrize("policy", ["zoo", "fdp"])
def test_mesh_step_params_equal_on_every_factorization(runs, policy):
    res, _ = runs
    ref = flatten(res[0]["stepped"][f"{policy}/1x8"])
    for r in res:
        for shape in SHAPES:
            got = flatten(r["stepped"][f"{policy}/{shape[0]}x{shape[1]}"])
            assert got.keys() == ref.keys()
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{shape} {k}")
    init = flatten(jax.tree.map(np.asarray, JT.init(jget("paper-mlp").reduced(),
                                                       jax.random.key(0))))
    assert any(not np.array_equal(ref[k], init[k]) for k in ref)


def test_mesh_step_matches_the_reference_step(runs):
    res, jax_step = runs
    got = flatten(res[0]["stepped"]["zoo/1x8"])
    want = jax_step["params"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1.01 * LR, err_msg=k)
        outside = int((~np.isclose(got[k], want[k], rtol=PARAM_RTOL, atol=PARAM_ATOL)).sum())
        assert outside <= max(1, FLIPS * want[k].size), \
            f"{k}: {outside} of {want[k].size} parameters outside rtol"
    metrics = res[0]["metrics"]["zoo/1x8"]
    np.testing.assert_allclose(metrics["loss"], jax_step["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(metrics["grad_norm"], jax_step["grad_norm"], rtol=GRAD_RTOL)


def test_mesh_step_gradient_mean_matches_the_reference(runs):
    res, jax_step = runs
    want = jax_step["grads"]
    for rank, r in enumerate(res):
        got = flatten(r["grads"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=f"rank {rank} {k}")
            # every leaf is resolved: its gradients stand well above the grid
            assert np.abs(want[k]).max() > 64 * GRAD_ATOL, k
