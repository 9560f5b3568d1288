"""The reference's placement on 8 placeholder CPU devices, run as a script
by ``tests/test_torch_placement.py`` (as ``tests/_torch_shard_jax.py`` runs
for ``tests/test_torch_sharded.py``): ``param_shardings`` of reduced
llama3.2-3b and reduced dbrx-132b under every profile on 2x2 and 2x4, each
leaf's addressable shard at every mesh position; the reference's ``--mesh``
serve path (``device_put(params, param_shardings(...))`` under
``distribution_for``, then ``serve``) on 2x2 under ``fsdp`` and
``decode_tp``; and ``device_put`` of reduced llama3.2-3b on a 3x1 mesh,
whose fsdp split of d_model 64 over 3 must be refused.

    python tests/_torch_place_jax.py IN.npz OUT.npz

The meshes are built with ``jax.make_mesh`` over the first R*C devices with
``Auto`` axes: the reference's ``make_mesh`` wants exactly R*C devices, and
its serve needs ``Auto`` axes in this JAX (with the default axis types the
embedding's gather raises a ``ShardingTypeError``). IN holds
``llama/<path>`` and ``dbrx/<path>`` (the trees, ``/``-joined) and
``prompts``; OUT gets ``<model>/<RxC>/<profile>/<path>/<i>,<j>`` (the shard
at ``mesh.devices[i, j]``), ``serve/<model>/<profile>`` and
``refused_3x1`` (the error's text, empty when nothing raised).
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.dispatch import MXU_FP32, use_policy  # noqa: E402
from repro.launch import sharding as shd  # noqa: E402
from repro.launch.serve import serve  # noqa: E402

MODELS = {"llama": "llama3.2-3b", "dbrx": "dbrx-132b"}
GEN = 3


def mesh_of(r, c):
    return jax.make_mesh((r, c), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:r * c])


def unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    return tree


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def main(inp, out):
    z = np.load(inp)
    res = {}
    prompts = jnp.asarray(z["prompts"])
    for tag, arch in MODELS.items():
        cfg = get_config(arch).reduced()
        params = unflatten({k[len(tag) + 1:]: z[k] for k in z.files
                            if k.startswith(tag + "/")})
        for r, c in ((2, 2), (2, 4)):
            mesh = mesh_of(r, c)
            pos = {d.id: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}
            for profile in shd.PROFILES:
                placed = jax.device_put(params, shd.param_shardings(cfg, params, mesh,
                                                                    profile=profile))
                for path, arr in flatten(placed).items():
                    for s in arr.addressable_shards:
                        i, j = pos[s.device.id]
                        res[f"{tag}/{r}x{c}/{profile}/{path}/{i},{j}"] = np.asarray(s.data)
                if (r, c) == (2, 2) and profile in ("fsdp", "decode_tp"):
                    # the reference's --mesh serve path (launch/serve.py)
                    with use_policy(MXU_FP32):
                        dist = shd.distribution_for(mesh, profile, numerics_policy=MXU_FP32)
                        res[f"serve/{tag}/{profile}"] = np.asarray(
                            serve(cfg, placed, prompts, GEN, dist))
    cfg = get_config(MODELS["llama"]).reduced()
    params = unflatten({k[6:]: z[k] for k in z.files if k.startswith("llama/")})
    try:
        jax.block_until_ready(jax.device_put(
            params, shd.param_shardings(cfg, params, mesh_of(3, 1), profile="fsdp")))
        res["refused_3x1"] = np.array("")
    except ValueError as e:
        res["refused_3x1"] = np.array(str(e))
    np.savez(out, **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
