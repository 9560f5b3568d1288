"""Greedy serving: the port's ``serve`` returns the same tokens as
``repro.launch.serve.serve`` for the same prompts and parameters, under
native fp32 and under the 91-bit FDP (JAX ``simulate`` FDP91 against the
port's kernel policy, plain on the CPU)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.core import dispatch as JD  # noqa: E402
from repro.launch.serve import serve as jserve  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402

torch.set_num_threads(1)

CASES = [("qwen3-0.6b", "fdp91"), ("paper-mlp", "fdp91"), ("qwen3-0.6b", "native_fp32"),
         ("dbrx-132b", "fdp91"), ("dbrx-132b", "native_fp32")]
# GQA (2 KV heads for 4 query heads) on the reduced attention models
OVERRIDES = {"qwen3-0.6b": dict(n_kv_heads=2), "dbrx-132b": dict(n_kv_heads=2)}
POLICIES = {"native_fp32": (JD.MXU_FP32, TD.MXU_FP32),
            "fdp91": (JD.FDP91, TS.FDP91_KERNEL)}


@pytest.mark.parametrize("arch,policy", CASES)
def test_serve_tokens_equal(arch, policy):
    over = OVERRIDES.get(arch, {})
    jc, tc = jget(arch).reduced(**over), tget(arch).reduced(**over)
    jp = JT.init(jc, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    prompts = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 4)).astype(np.int32)
    jpol, tpol = POLICIES[policy]
    with JD.use_policy(jpol):
        want = np.asarray(jserve(jc, jp, jnp.asarray(prompts), 3))
    with TD.use_policy(tpol):
        got = TS.serve(tc, tp, torch.from_numpy(prompts), 3, device="cpu")
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ["paper-mlp", "dbrx-132b"])
def test_main_runs_reduced_on_cpu(capsys, arch):
    TS.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "3",
             "--gen", "2", "--device", "cpu", "--policy", "fdp91_kernel"])
    out = capsys.readouterr().out
    assert "policy=fdp91_kernel device=cpu" in out and "sample:" in out
