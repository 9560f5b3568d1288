"""The port's MoE block against ``repro.models.moe`` on the reduced dbrx-132b
config (4 experts, top-2).

The JAX side initializes the parameters; the port copies them. Under native
fp32 and under the 91-bit FDP (JAX ``simulate`` against the port's kernel
policy, plain on the CPU) ``moe_block`` agrees within rtol=1e-4, atol=1e-5,
as the dense tests: the expert GEMMs are exact in their inputs, softmax and
silu differ by ulps between XLA and PyTorch, and the combine adds each
token's k contributions in the reference's order. Routing and group sizes
are equal. The block runs no host sync, and its output bits repeat."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.models import LOCAL  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.kernels import fdp_gemm as tk  # noqa: E402
from repro_torch.launch.serve import FDP91_KERNEL  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
POLICIES = {"native_fp32": (JD.MXU_FP32, TD.MXU_FP32),
            "fdp91": (JD.FDP91, FDP91_KERNEL)}
JCFG, TCFG = jget("dbrx-132b").reduced(), tget("dbrx-132b").reduced()


@pytest.fixture(scope="module")
def moe():
    jp = JM.init_moe(jax.random.key(3), JCFG.d_model, JCFG.d_ff, JCFG.n_experts)
    tp = TM.MoE(TCFG.d_model, TCFG.d_ff, TCFG.n_experts, device="cpu")
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(torch.from_numpy(np.array(jp[name])))
    x = np.random.default_rng(7).standard_normal((2, 5, JCFG.d_model)).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("policy", list(POLICIES))
def test_moe_block_matches_reference(moe, policy):
    jp, tp, x = moe
    jpol, tpol = POLICIES[policy]
    with JD.use_policy(jpol):
        want = np.asarray(JM.moe_block(jnp.asarray(x), jp, JCFG, LOCAL))
    TD.reset_sites_seen()
    with TD.use_policy(tpol):
        got = TM.moe_block(torch.from_numpy(x), tp, TCFG)
        again = TM.moe_block(torch.from_numpy(x), tp, TCFG)
    assert got.shape == want.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(got, again)
    assert TD.site_calls() == {s: 2 for s in ("moe_router", "moe_in", "moe_gate", "moe_out")}
    TD.reset_sites_seen()


def test_routing_and_group_sizes_match(moe, monkeypatch):
    jp, tp, x = moe
    xf = x.reshape(-1, JCFG.d_model)
    with JD.use_policy(JD.FDP91):
        jw, jids = (np.asarray(v) for v in JM._route(jnp.asarray(xf), jp["router"], JCFG))
    with TD.use_policy(FDP91_KERNEL):
        tw, tids = TM._route(torch.from_numpy(xf), tp.router, TCFG)
    np.testing.assert_array_equal(tids.numpy(), jids)
    np.testing.assert_allclose(tw.detach().numpy(), jw, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw.sum(-1).detach().numpy(), 1.0, rtol=1e-6)
    want = np.bincount(jids.reshape(-1), minlength=JCFG.n_experts)
    calls = []
    real = TD.ragged_gemm

    def spy(x, w, group_sizes, **kw):
        calls.append(group_sizes)
        return real(x, w, group_sizes, **kw)

    monkeypatch.setattr(TD, "ragged_gemm", spy)
    with TD.use_policy(FDP91_KERNEL):
        TM.moe_block(torch.from_numpy(x), tp, TCFG)
    TD.reset_sites_seen()
    assert len(calls) == 3
    for gs in calls:
        assert gs.dtype == torch.int32
        np.testing.assert_array_equal(gs.numpy(), want)


def test_moe_block_reads_nothing_on_the_host(moe, monkeypatch):
    """Around the kernel, the block asks no tensor for a Python value: no
    ``.item()``, ``.tolist()``, ``nonzero``, ``bincount`` or boolean-mask
    indexing, each of which waits for the device on a card. The kernel's
    plain version reads the group sizes on the host, so it is replaced here
    by a sync-free stand-in; ``test_torch_kernel_cuda.py`` runs the block
    under ``torch.cuda.set_sync_debug_mode("error")`` on the card."""
    jp, tp, x = moe
    seen = []
    for name in ("item", "tolist", "nonzero"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _n=name, _f=real, **kw:
                            seen.append(_n) or _f(self, *a, **kw))
    real_getitem = torch.Tensor.__getitem__

    def getitem(self, idx):
        items = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in items):
            seen.append("mask")
        return real_getitem(self, idx)

    monkeypatch.setattr(torch.Tensor, "__getitem__", getitem)
    real_bincount = torch.bincount
    monkeypatch.setattr(torch, "bincount",
                        lambda *a, **kw: seen.append("bincount") or real_bincount(*a, **kw))
    native = TD.GemmConfig(TD.FP32, None, "native")
    monkeypatch.setattr(
        tk, "fdp_ragged_gemm_plain",
        lambda x, w, gs, **kw: TD._ragged_execute(TD.GemmSite("stand_in"), native, x, w, gs))
    with TD.use_policy(FDP91_KERNEL):
        TM.moe_block(torch.from_numpy(x), tp, TCFG)
    TD.reset_sites_seen()
    assert seen == []


def test_params_from_numpy_carries_the_moe_subtree():
    cfg_j, cfg_t = jget("dbrx-132b").reduced(n_kv_heads=2), tget("dbrx-132b").reduced(n_kv_heads=2)
    jparams = JT.init(cfg_j, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg_t, device="cpu")
    assert not hasattr(tparams.layers[0], "mlp")
    for name in ("router", "w_in", "w_gate", "w_out"):
        np.testing.assert_array_equal(np.asarray(jparams["layers"]["moe"][name][1]),
                                      getattr(tparams.layers[1].moe, name).detach().numpy())
    n_jax = sum(np.asarray(v).size for v in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in tparams.parameters()) == n_jax
