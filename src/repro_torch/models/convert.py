"""Parameters handed over from and back to the JAX reference.

``params_from_numpy(tree, cfg, device)`` takes the reference's parameter
tree as a nested dict of numpy arrays (the caller runs
``jax.tree.map(np.asarray, params)`` on its side, so this package never sees
JAX), unstacks the leading layer axis of ``tree["layers"]`` and copies every
array into the port's ``Transformer``. ``params_to_numpy`` is its inverse:
the reference's tree of numpy arrays, from the module's parameters or from
any ``{parameter name: tensor}`` dict (gradients, optimizer moments), so
two trees can be compared leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .transformer import Transformer


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    dev = resolve_device(device)
    model = Transformer(cfg, gen=None, dtype=getattr(torch, cfg.param_dtype),
                        device=dev)
    flat = {"embed": tree["embed"], "final_norm": tree["final_norm"],
            "lm_head": tree["lm_head"]}

    def walk(prefix, node, index):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val, index)
            else:
                flat[f"{prefix}{key}"] = np.asarray(val)[index]

    for i in range(cfg.n_layers):
        walk(f"layers.{i}.", tree["layers"], i)
    own = dict(model.named_parameters())
    if set(own) != set(flat):
        raise ValueError(f"parameter trees differ: only in the port "
                         f"{sorted(set(own) - set(flat))}, only in the tree "
                         f"{sorted(set(flat) - set(own))}")
    with torch.no_grad():
        for name, p in own.items():
            arr = np.asarray(flat[name])
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr)))
    return model


def params_to_numpy(params, cfg: ModelConfig) -> dict:
    """The reference's parameter tree (nested dicts of numpy arrays, every
    ``layers`` leaf stacked over a leading layer axis) from a ``Transformer``
    or from a ``{name: tensor}`` dict keyed by its parameter names."""
    named = (dict(params.named_parameters()) if isinstance(params, torch.nn.Module)
             else dict(params))
    tree: dict = {}
    per_layer: dict = {}
    for name, t in named.items():
        arr = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] == "layers":
            per_layer.setdefault(tuple(parts[2:]), {})[int(parts[1])] = arr
        else:
            tree[name] = arr
    layers: dict = {}
    for path, by_index in per_layer.items():
        if sorted(by_index) != list(range(cfg.n_layers)):
            raise ValueError(f"layers.*.{'.'.join(path)}: layers {sorted(by_index)}, "
                             f"expected {cfg.n_layers}")
        node = layers
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([by_index[i] for i in range(cfg.n_layers)])
    tree["layers"] = layers
    return tree
