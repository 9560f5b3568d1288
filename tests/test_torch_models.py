"""The port's dense and MoE models against ``repro.models`` on reduced
configs.

The JAX side initializes the parameters; ``params_from_numpy`` hands them
to the port. Logits agree within rtol=1e-4, atol=1e-5: every GEMM is exact
in its inputs (FDP modes) or within f32 reordering error (native), while
softmax, rsqrt, rope and silu differ by ulps between XLA and PyTorch. At
model level the JAX side runs ``simulate`` (FDP91), which the JAX package's
own tests hold bit-identical to its Pallas kernel; the port runs ``pallas``
mode, which on CPU tensors is the kernel's plain version. Greedy tokens of
``serve`` are equal."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.launch.serve import FDP91_KERNEL  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
# reduced qwen3 keeps qk_norm and gets GQA (2 KV heads for 4 query heads);
# reduced dbrx (MoE: 4 experts, top-2) gets the same GQA
REDUCED = {"qwen3-0.6b": dict(n_kv_heads=2), "paper-mlp": {},
           "dbrx-132b": dict(n_kv_heads=2)}
POLICIES = {"native_fp32": (JD.MXU_FP32, TD.MXU_FP32),
            "fdp91": (JD.FDP91, FDP91_KERNEL)}


@pytest.fixture(scope="module", params=list(REDUCED))
def model(request):
    arch = request.param
    jc = jget(arch).reduced(**REDUCED[arch])
    tc = tget(arch).reduced(**REDUCED[arch])
    jp = JT.init(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    return jc, jp, tc, tp


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_params_map_one_to_one(model):
    jc, jp, tc, tp = model
    assert tc.n_kv_heads < tc.n_heads or tc.name.startswith("paper-mlp")
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    assert sum(p.numel() for p in tp.parameters()) == n_jax
    np.testing.assert_array_equal(np.asarray(jp["layers"]["attn"]["wq"][1]),
                                  tp.layers[1].attn.wq.detach().numpy())


@pytest.mark.parametrize("policy", list(POLICIES))
def test_forward_logits(model, policy):
    jc, jp, tc, tp = model
    jpol, tpol = POLICIES[policy]
    toks = _tokens(jc, (2, 7), seed=1)
    with JD.use_policy(jpol):
        want = np.asarray(JT.forward(jp, jc, {"tokens": jnp.asarray(toks)}))
    with TD.use_policy(tpol):
        got = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == want.shape == (2, 7, tc.padded_vocab)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)


def test_prefill_and_decode_step(model):
    jc, jp, tc, tp = model
    toks = _tokens(jc, (2, 5), seed=2)
    nxt = _tokens(jc, (2, 1), seed=3)
    with JD.use_policy(JD.MXU_FP32):
        jcache = JT.init_cache(jc, 2, 8, dtype=jnp.float32)
        jlast, jcache = JT.prefill(jp, jc, {"tokens": jnp.asarray(toks)}, jcache)
        jlog, _ = JT.decode_step(jp, jc, jcache, jnp.asarray(nxt))
    with TD.use_policy(TD.MXU_FP32):
        tcache = TT.init_cache(tc, 2, 8, dtype=torch.float32, device="cpu")
        tlast, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks).long()}, tcache)
        tlog, tcache = TT.decode_step(tp, tc, tcache, torch.from_numpy(nxt).long())
    assert tcache["len"] == 6
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=RTOL, atol=ATOL)
    # prefill's last logits are forward's last position
    with TD.use_policy(TD.MXU_FP32):
        full = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(tlast.numpy(), full[:, -1].detach().numpy(), rtol=RTOL, atol=ATOL)
