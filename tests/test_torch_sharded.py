"""The sharded forward on gloo worlds of CPU ranks against the port's local
blocks and the JAX package: the named-axis collectives and their adjoints,
``moe_block``'s three TP branches and ``moe_block_ep``, the Megatron
``mlp_block``, the sequence-parallel ``forward`` of reduced llama3.2-3b,
``serve(..., dist=)``, the gradients of all of these, and the shape checks
that raise.

Three worlds serve the module, every case of a mesh shape in one: 2x4 (8
ranks), 2x2 (4 ranks) and a line of 2 ranks for ``gradcheck``. The rank
functions live in ``tests/_torch_shard_worker.py`` (no JAX). The
reference's sharded blocks run in a subprocess on 8 placeholder devices
(``tests/_torch_shard_jax.py``), started before the worlds and read after
them. The port's local blocks and the reference's serve run in this
process. The inputs are the reference's ``moe_tp_parity``/``moe_ep_parity``
cases (``tests/distributed_worker.py``: its ``_moe_cfg``, x (4, 8, 32)) and
``sp_forward_parity``'s (reduced llama3.2-3b on 2x4, tokens (4, 16)); the
reference's sharded forward fails in every JAX run (ROADMAP section 3), so
the port's is held to its own local forward and the reference's ``LOCAL``.

Tolerances, and why:
- Bit-equal (``torch.equal``) under FDP91 (``simulate``): EP against the
  local block (whole experts on a rank; each token's contributions summed
  in the local order, which top-4 routing sees), the Megatron MLP (its K-split summed by
  ``fdp_psum``), and the SP forward (every FDP GEMM rounds each output on
  its own, whatever rows a rank holds).
- The TP MoE branches against the reference's ``LOCAL`` and ``shard_map``
  blocks: rtol 2e-4 / atol 2e-5 (the reference's own ``moe_tp_parity``
  tolerance): the f-slices' partial outputs are summed in float.
- The SP forward under MXU_FP32 against the port's local forward and the
  reference's ``LOCAL``: rtol/atol 3e-4 (``sp_forward_parity``'s);
  measured worst |diff| in the test's message.
- Gradients under MXU_FP32 against the local block's: rtol 1e-4, atol 1e-4
  times the gradient's largest magnitude (float partial sums in another
  order).
- Serve: equal tokens.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.launch.serve import serve as jserve  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.launch.serve import serve as tserve  # noqa: E402
from repro_torch.models import LOCAL, params_from_numpy  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.transformer import block_of, forward, seq_sharded  # noqa: E402

import _torch_shard_worker as W  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE_RTOL, MOE_ATOL = 2e-4, 2e-5
SP_TOL = 3e-4
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-4          # atol: times the gradient's largest |g|
PROMPTS, GEN = (4, 4), 3


def moe_cfg(E, k=2):
    return ModelConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                       n_kv_heads=2, d_ff=64, vocab_size=64, n_experts=E, top_k=k)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def runs():
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    moe4 = np_tree(JM.init_moe(jax.random.key(0), 32, 64, 4))
    moe8 = np_tree(JM.init_moe(jax.random.key(0), 32, 64, 8))
    mlp = np_tree(JL.init_mlp(jax.random.key(2), 32, 64))
    lcfg_j, lcfg = jget("llama3.2-3b").reduced(), tget("llama3.2-3b").reduced()
    llama = np_tree(JT.init(lcfg_j, jax.random.key(0)))
    dcfg_j, dcfg = jget("dbrx-132b").reduced(), tget("dbrx-132b").reduced()
    dbrx = np_tree(JT.init(dcfg_j, jax.random.key(0)))
    x_seq = np.array(jax.random.normal(jax.random.key(1), (4, 8, 32)))
    x_dec = np.array(jax.random.normal(jax.random.key(3), (4, 1, 32)))
    tokens = np.array(jax.random.randint(jax.random.key(1), (4, 16), 0, lcfg.vocab_size))
    prompts = np.random.default_rng(4).integers(0, 256, PROMPTS).astype(np.int32)
    common = {"x_seq": x_seq, "x_dec": x_dec, "moe": moe4, "moe_cfg": moe_cfg(4)}
    with tempfile.TemporaryDirectory() as tmp:
        inp, out = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, x_seq=x_seq, x_dec=x_dec, tokens=tokens,
                 **{f"moe/{k}": v for k, v in moe4.items()},
                 **{f"moe8/{k}": v for k, v in moe8.items()},
                 **{f"llama/{k}": v for k, v in flatten(llama).items()})
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        env.pop("XLA_FLAGS", None)
        ref = subprocess.Popen([sys.executable, os.path.join(ROOT, "tests", "_torch_shard_jax.py"),
                                inp, out], env=env, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True)
        try:
            w24 = TM.spawn(W.world, 8, args=(dict(
                common, shape=(2, 4), grad=True, policies=("native", "fdp91"),
                moe8=moe8, moe8_cfg=moe_cfg(8), moe8_k4_cfg=moe_cfg(8, 4), mlp=mlp,
                mlp_cfg=moe_cfg(4),
                llama=llama, llama_cfg=lcfg, tokens=tokens),), timeout=300,
                collective_timeout=120)
            w22 = TM.spawn(W.world, 4, args=(dict(
                common, shape=(2, 2), grad=False, policies=("native",),
                serve={"llama": (lcfg, llama), "dbrx": (dcfg, dbrx)},
                profiles=("fsdp", "decode_tp"), prompts=prompts, gen=GEN),),
                timeout=300, collective_timeout=120)
            line = TM.spawn(W.collective_gradchecks, 2, timeout=300, collective_timeout=120)
            stdout, stderr = ref.communicate(timeout=300)
        finally:
            ref.kill()
            ref.wait()
        assert ref.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr}"
        z = np.load(out)
        jax_out = {k: z[k] for k in z.files}
    # the reference's serve, on one device
    jserved = {}
    with JD.use_policy(JD.MXU_FP32):
        for name, jc, tree in (("llama", lcfg_j, llama), ("dbrx", dcfg_j, dbrx)):
            jp = jax.tree.map(jnp.asarray, tree)
            jserved[name] = np.asarray(jserve(jc, jp, jnp.asarray(prompts), GEN))
    inputs = dict(moe4=moe4, moe8=moe8, mlp=mlp, llama=llama, dbrx=dbrx, x_seq=x_seq,
                  x_dec=x_dec, tokens=tokens, prompts=prompts, lcfg=lcfg, dcfg=dcfg)
    return {"2x4": w24, "2x2": w22, "line": line, "jax": jax_out, "jserve": jserved,
            "in": inputs}


def local_moe(inp, E, x, policy, k=2):
    p = W.moe_module(inp["moe4" if E == 4 else "moe8"], moe_cfg(E, k))
    with TD.use_policy(W.POLICIES[policy]), torch.no_grad():
        return TMOE.moe_block(torch.from_numpy(inp[x]), p, moe_cfg(E, k)).numpy()


def same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], first, err_msg=f"rank {r['rank']}: {key}")
    return first


@pytest.mark.parametrize("name", ["all_gather", "all_gather_untiled", "psum_scatter",
                                  "psum", "shard", "all_to_all", "all_to_all_untiled"])
def test_collective_adjoints_pass_gradcheck(runs, name):
    for r in runs["line"]:
        assert r[name], f"gradcheck of {name} failed on a rank"


def test_axis_index_and_size(runs):
    assert [r["axis_index"] for r in runs["line"]] == [(0, 2), (1, 2)]


@pytest.mark.parametrize("mesh", ["2x4", "2x2"])
@pytest.mark.parametrize("branch", ["seq", "dec", "joint"])
def test_moe_tp_matches_the_reference(runs, mesh, branch):
    got = same_on_every_rank(runs[mesh], f"{branch}/native")
    x = "x_seq" if branch == "seq" else "x_dec"
    ref_local = runs["jax"][f"local/{'seq' if branch == 'seq' else 'dec'}"]
    np.testing.assert_allclose(got, ref_local, rtol=MOE_RTOL, atol=MOE_ATOL)
    np.testing.assert_allclose(got, runs["jax"][f"{mesh}/{branch}"], rtol=MOE_RTOL,
                               atol=MOE_ATOL)
    np.testing.assert_allclose(got, local_moe(runs["in"], 4, x, "native"), rtol=MOE_RTOL,
                               atol=MOE_ATOL)


def test_moe_tp_under_fdp91_is_close_to_local(runs):
    for branch, x in (("seq", "x_seq"), ("dec", "x_dec"), ("joint", "x_dec")):
        got = same_on_every_rank(runs["2x4"], f"{branch}/fdp91")
        np.testing.assert_allclose(got, local_moe(runs["in"], 4, x, "fdp91"),
                                   rtol=MOE_RTOL, atol=MOE_ATOL, err_msg=branch)


def test_moe_ep_matches_the_reference_and_drops_nothing(runs):
    got = same_on_every_rank(runs["2x4"], "ep/native")
    np.testing.assert_allclose(got, runs["jax"]["local8/seq"], rtol=MOE_RTOL, atol=MOE_ATOL)
    np.testing.assert_allclose(got, runs["jax"]["2x4/ep"], rtol=MOE_RTOL, atol=MOE_ATOL)
    for pol in ("native", "fdp91"):
        assert all(r[f"ep/{pol}/dropped"] == 0 for r in runs["2x4"])


@pytest.mark.parametrize("case", ["ep", "ep_k4", "mlp_dec", "mlp_seq"])
def test_ep_and_megatron_are_bit_equal_under_fdp91(runs, case):
    inp = runs["in"]
    got = same_on_every_rank(runs["2x4"], f"{case}/fdp91")
    if case == "ep_k4":
        assert all(r["ep_k4/fdp91/dropped"] == 0 for r in runs["2x4"])
        np.testing.assert_array_equal(got, local_moe(inp, 8, "x_seq", "fdp91", k=4))
        return
    if case == "ep":
        want = local_moe(inp, 8, "x_seq", "fdp91")
    else:
        p = W.mlp_module(inp["mlp"], moe_cfg(4))
        x = torch.from_numpy(inp["x_dec" if case == "mlp_dec" else "x_seq"])
        with TD.use_policy(TD.FDP91), torch.no_grad():
            want = TL.mlp_block(x, p, moe_cfg(4)).numpy()
    np.testing.assert_array_equal(got, want)
    native = same_on_every_rank(runs["2x4"], f"{case}/native")
    np.testing.assert_allclose(native, want, rtol=MOE_RTOL, atol=MOE_ATOL)


def _local_forward(runs, policy):
    inp = runs["in"]
    params = params_from_numpy(inp["llama"], inp["lcfg"], device="cpu")
    with TD.use_policy(W.POLICIES[policy]), torch.no_grad():
        return forward(params, inp["lcfg"], {"tokens": torch.from_numpy(inp["tokens"])},
                       remat="none").numpy()


def test_sp_forward_matches_local_and_the_reference(runs):
    got = same_on_every_rank(runs["2x4"], "fwd/native")
    want = _local_forward(runs, "native")
    assert got.shape == want.shape == (4, 16, runs["in"]["lcfg"].padded_vocab)
    worst = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=SP_TOL, atol=SP_TOL,
                               err_msg=f"max |diff| {worst:.3e}")
    np.testing.assert_allclose(got, runs["jax"]["forward"], rtol=SP_TOL, atol=SP_TOL)


def test_sp_forward_is_bit_equal_under_fdp91(runs):
    got = same_on_every_rank(runs["2x4"], "fwd/fdp91")
    np.testing.assert_array_equal(got, _local_forward(runs, "fdp91"))


@pytest.mark.parametrize("name,profile", [("llama", "fsdp"), ("llama", "decode_tp"),
                                          ("dbrx", "fsdp"), ("dbrx", "decode_tp")])
def test_sharded_serve_gives_the_local_and_the_reference_tokens(runs, name, profile):
    inp = runs["in"]
    got = same_on_every_rank(runs["2x2"], f"serve/{name}/{profile}")
    cfg = inp["lcfg" if name == "llama" else "dcfg"]
    params = params_from_numpy(inp[name], cfg, device="cpu")
    with TD.use_policy(TD.MXU_FP32):
        local = tserve(cfg, params, torch.from_numpy(inp["prompts"]), GEN, device="cpu").numpy()
    assert got.shape == PROMPTS[:1] + (GEN,)
    np.testing.assert_array_equal(got, local)
    np.testing.assert_array_equal(got, runs["jserve"][name])


def _close(got, want, what):
    atol = GRAD_ATOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, atol=atol, err_msg=what)


@pytest.mark.parametrize("branch", ["seq", "dec", "joint", "ep"])
def test_moe_gradients_match_the_local_block(runs, branch):
    inp = runs["in"]
    E = 8 if branch == "ep" else 4
    x = torch.from_numpy(inp["x_dec" if branch in ("dec", "joint") else "x_seq"]).clone()
    x.requires_grad_()
    p = W.moe_module(inp["moe8" if E == 8 else "moe4"], moe_cfg(E))
    c = torch.linspace(-1.0, 1.0, x.numel()).reshape(x.shape)
    with TD.use_policy(TD.MXU_FP32):
        (TMOE.moe_block(x, p, moe_cfg(E)) * c).sum().backward()
    for r in runs["2x4"]:
        _close(r[f"{branch}/grad_x"], x.grad.numpy(), f"rank {r['rank']} dx")
        for name, g in r[f"{branch}/grad_w"].items():
            _close(g, getattr(p, name).grad.numpy(), f"rank {r['rank']} d{name}")


def test_forward_gradients_match_the_local_forward(runs):
    inp = runs["in"]
    cfg = inp["lcfg"]
    params = params_from_numpy(inp["llama"], cfg, device="cpu")
    toks = torch.from_numpy(inp["tokens"])
    c = torch.linspace(-1.0, 1.0, toks.numel() * cfg.padded_vocab).reshape(
        toks.shape + (cfg.padded_vocab,))
    with TD.use_policy(TD.MXU_FP32):
        y = forward(params, cfg, {"tokens": toks}, remat="none")[..., :cfg.vocab_size]
        (y * c[..., :cfg.vocab_size]).sum().backward()
    for r in runs["2x4"]:
        for name, p in params.named_parameters():
            _close(r["fwd/grad"][name], p.grad.numpy(), f"rank {r['rank']} {name}")


@pytest.mark.parametrize("case,match", [
    ("full_under_tp", r"are \(\(8, 32, 64\).*tp' on mesh 2x4 wants \(\(8, 32, 16\)"),
    ("ep_under_tp", r"are \(\(2, 32, 64\).*tp' on mesh 2x4 wants \(\(8, 32, 16\)"),
    ("ep_unsplit_sequence", "expert parallelism shards the sequence")])
def test_shape_checks_raise(runs, case, match):
    import re
    for r in runs["2x4"]:
        assert re.search(match, r["raises"][case]), r["raises"][case]


def test_block_layout_and_local_defaults():
    """Without a mesh every block is the whole batch; the sequence splits
    only when it is longer than one token and divides over tp."""
    assert block_of(LOCAL, 4, 16) == (slice(0, 4), slice(0, 16))
    assert not seq_sharded(LOCAL, 16)
    x = torch.ones(2)
    assert LOCAL.constrain(x, "data") is x and LOCAL.tp == 1
