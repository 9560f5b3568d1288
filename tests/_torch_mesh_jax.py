"""The reference's data-parallel step on 8 placeholder CPU devices, run as a
script by ``tests/test_torch_mesh_train.py`` (as ``tests/test_distributed.py``
runs its worker): one ``make_mesh_train_step`` of reduced paper-mlp on the
1x8 mesh under the zoo plan, with the fixed-point gradient mean, from the
weights and the batch in an .npz, and the reduced gradients of that step
(``sharded_value_and_grad`` in a ``shard_map`` over the same mesh).

    python tests/_torch_mesh_jax.py IN.npz OUT.npz

IN holds ``p/<path>`` (the parameter tree, ``/``-joined) and ``b/<key>``
(the global batch); OUT gets ``p/<path>`` of the stepped parameters,
``g/<path>`` of the reduced gradients, ``loss`` and ``grad_norm``.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.accumulator import AccumulatorSpec  # noqa: E402
from repro.core.dispatch import policy_from_plan, use_policy  # noqa: E402
from repro.launch.sharding import distribution_for  # noqa: E402
from repro.models import layers as L  # noqa: E402
from repro.parallel.compat import shard_map_unchecked  # noqa: E402
from repro.train.loop import (make_loss_fn, make_mesh_train_step,  # noqa: E402
                              sharded_value_and_grad)
from repro.train.optimizer import adamw  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


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
    params = unflatten({k[2:]: z[k] for k in z.files if k.startswith("p/")})
    batch = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("b/")}
    cfg = get_config("paper-mlp").reduced()
    policy = policy_from_plan(os.path.join(ROOT, "examples", "plans", "paper_mlp.json"))
    mesh = jax.make_mesh((1, 8), ("data", "model"))
    axes = tuple(mesh.axis_names)
    grad_spec = AccumulatorSpec(10, 10, -20)
    vg = sharded_value_and_grad(make_loss_fn(cfg, L.LOCAL, remat="none"), axes,
                                fdp_grad_spec=grad_spec)
    reduced = jax.jit(shard_map_unchecked(lambda p, b: vg(p, b)[1], mesh=mesh,
                                          in_specs=(P(), P(axes)), out_specs=P()))
    with use_policy(policy):
        grads = reduced(params, batch)
    dist = distribution_for(mesh, "ddp", numerics_policy=policy)
    opt = adamw(lr=1e-3)
    step = make_mesh_train_step(cfg, opt, dist, fdp_grad_spec=grad_spec)
    (params, _), metrics = step((params, opt.init(params)), batch)
    np.savez(out, loss=np.asarray(metrics["loss"]),
             grad_norm=np.asarray(metrics["grad_norm"]),
             **{f"p/{k}": v for k, v in flatten(params).items()},
             **{f"g/{k}": v for k, v in flatten(grads).items()})


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
