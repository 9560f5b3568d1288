"""The reference's sharded blocks on 8 placeholder CPU devices, run as a
script by ``tests/test_torch_sharded.py`` (as ``tests/test_distributed.py``
runs its worker), all under ``MXU_FP32``: ``moe_block`` on ``LOCAL`` and in
its ``shard_map`` branches (sequence-sharded, decode, ``joint_tp``) on the
2x4 and 2x2 meshes, ``moe_block_ep`` on 2x4 (capacity factor 8), and the
``LOCAL`` forward of a dense model.

    python tests/_torch_shard_jax.py IN.npz OUT.npz

IN holds ``moe/<leaf>`` (E=4, top-2), ``moe8/<leaf>`` (E=8, top-2),
``llama/<path>`` (the dense model's tree, ``/``-joined), ``x_seq``,
``x_dec`` and ``tokens``; OUT gets one array per case, named as the test
reads them.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.dispatch import MXU_FP32, use_policy  # noqa: E402
from repro.models import forward  # noqa: E402
from repro.models import moe as MOE  # noqa: E402
from repro.models.config import ModelConfig  # noqa: E402
from repro.models.layers import LOCAL, Distribution  # noqa: E402


def moe_cfg(E):
    """The reference's own ``_moe_cfg`` (tests/distributed_worker.py)."""
    return ModelConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                       n_kv_heads=2, d_ff=64, vocab_size=64, n_experts=E, top_k=2)


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def main(inp, out):
    z = np.load(inp)
    tree = lambda pre: unflatten({k[len(pre) + 1:]: z[k] for k in z.files
                                  if k.startswith(pre + "/")})
    p4, p8, llama = tree("moe"), tree("moe8"), tree("llama")
    x_seq, x_dec = jnp.asarray(z["x_seq"]), jnp.asarray(z["x_dec"])
    res = {}
    with use_policy(MXU_FP32):
        for tag, x in (("seq", x_seq), ("dec", x_dec)):
            res[f"local/{tag}"] = MOE.moe_block(x, p4, moe_cfg(4), LOCAL)
        res["local8/seq"] = MOE.moe_block(x_seq, p8, moe_cfg(8), LOCAL)
        for shape in ((2, 4), (2, 2)):
            mesh = jax.make_mesh(shape, ("data", "model"))
            name = f"{shape[0]}x{shape[1]}"
            tp = Distribution(mesh=mesh, dp_axes=("data",), tp_axis="model")
            joint = Distribution(mesh=mesh, dp_axes=("data",), tp_axis="model",
                                 joint_tp=True)
            for tag, d, x in (("seq", tp, x_seq), ("dec", tp, x_dec),
                              ("joint", joint, x_dec)):
                res[f"{name}/{tag}"] = jax.jit(
                    lambda x, d=d: MOE.moe_block(x, p4, moe_cfg(4), d))(x)
            if shape == (2, 4):
                res[f"{name}/ep"] = jax.jit(lambda x: MOE.moe_block_ep(
                    x, p8, moe_cfg(8), tp, capacity_factor=8.0))(x_seq)
        cfg = get_config("llama3.2-3b").reduced()
        res["forward"] = forward(llama, cfg, {"tokens": jnp.asarray(z["tokens"])}, LOCAL,
                                 remat="none")
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
