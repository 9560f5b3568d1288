"""A world of ranks sharing one card (skips without one): four ranks on
``cuda:0`` over gloo (NCCL refuses ranks that share a device), each
``fdp_psum`` of its K-shard torch.equal the dense kernel's unsharded
output, and reduced paper-mlp's fixed-point mesh step under the 91-bit
kernel policy equal on 1x4 and 2x2, on every rank, with the dense kernel's
launches equal to the FDP dispatches; and the sharded model's collectives
(``all_gather``, ``psum_scatter``, ``all_to_all``, ``axis_index``) on CUDA
tensors equal to the same on host tensors, whatever gloo stages.

This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_mesh_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import mesh as TM  # noqa: E402

import _torch_mesh_worker as W  # noqa: E402


@pytest.mark.cuda
def test_four_ranks_share_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share cuda:0")
    from repro_torch.kernels import fdp_gemm as K
    K.load()                      # built once here, not by four ranks at once
    assert TM.backend_for(TM.rank_devices("cuda:0", 4)) == "gloo"
    res = TM.spawn(W.mesh_step_card, 4, device="cuda:0", args=([(1, 4), (2, 2)],),
                   timeout=600, collective_timeout=300)
    ref = res[0]["stepped"]["1x4"]
    for r in res:
        assert r["fdp_psum_equals_kernel"]
        assert r["backends"] == {"1x4": {"model": "gloo"},
                                 "2x2": {"data": "gloo", "model": "gloo"}}
        (n14, d14), (n22, d22) = r["launches"]["1x4"], r["launches"]["2x2"]
        assert 0 < n14 == d14 == n22 == d22
        for shape in ("1x4", "2x2"):
            for k, v in r["stepped"][shape].items():
                np.testing.assert_array_equal(v, ref[k], err_msg=f"{shape} {k}")


@pytest.mark.cuda
def test_sharded_collectives_on_the_card_equal_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ranks share cuda:0")
    res = TM.spawn(W.sharded_collectives_card, 4, device="cuda:0", timeout=300,
                   collective_timeout=120)
    for r in res:
        assert r["equal"] and all(r["equal"].values()), r["equal"]
        assert set(r["staged"]) == {"all_gather", "reduce_scatter", "all_to_all"}
        assert r["staged"] == res[0]["staged"]
