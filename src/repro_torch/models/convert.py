"""Parameters handed over from and back to the JAX reference.

``params_from_numpy(tree, cfg, device)`` takes the reference's parameter
tree as a nested dict of numpy arrays (the caller runs
``jax.tree.map(np.asarray, params)`` on its side, so this package never sees
JAX), unstacks the leading layer axes of ``tree["layers"]`` (one, or two for
``hybrid``: group, then position in the group) and copies every array into
the port's ``Transformer``; an encdec tree's ``enc_layers`` and
``dec_layers`` carry one layer axis each (``LAYER_STACKS``); other subtrees
(the hybrid's ``shared`` block, ``enc_norm``) carry none. ``params_to_numpy`` is its inverse: the reference's
tree of numpy arrays, from the module's parameters or from any
``{parameter name: tensor}`` dict (gradients, optimizer moments), so two
trees can be compared leaf by leaf. ``reference_path`` names a parameter's
leaf in the reference's tree (``launch.sharding.param_specs`` reads the
reference's rules through it).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .transformer import Transformer, n_groups


# the reference's subtrees whose leaves stack their layers
LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def _layer_axes(cfg: ModelConfig, stack: str = "layers") -> tuple:
    """The leading axes of the leaves of the reference's ``stack``."""
    if stack == "enc_layers":
        return (cfg.n_enc_layers,)
    if cfg.family == "hybrid":
        return (n_groups(cfg), cfg.attn_every)
    return (cfg.n_layers,)


def _n_layers(cfg: ModelConfig, stack: str) -> int:
    return cfg.n_enc_layers if stack == "enc_layers" else cfg.n_layers


def reference_path(name: str, cfg: ModelConfig) -> tuple:
    """(path, lead): the reference's ``/``-joined path of the port's
    parameter ``name`` ("layers.3.attn.wq" -> "layers/attn/wq") and the
    leading layer axes its leaf stacks there (``()`` outside a stack)."""
    parts = name.split(".")
    if parts[0] in LAYER_STACKS:
        return "/".join([parts[0]] + parts[2:]), _layer_axes(cfg, parts[0])
    return "/".join(parts), ()


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> Transformer:
    dev = resolve_device(device)
    model = Transformer(cfg, gen=None, dtype=getattr(torch, cfg.param_dtype),
                        device=dev)
    flat = {}

    def walk(prefix, node, index=()):
        for key, val in node.items():
            if isinstance(val, dict):
                walk(f"{prefix}{key}.", val, index)
            else:
                flat[f"{prefix}{key}"] = np.asarray(val)[index]

    for key, val in tree.items():
        if key in LAYER_STACKS:
            for i in range(_n_layers(cfg, key)):
                walk(f"{key}.{i}.", val, np.unravel_index(i, _layer_axes(cfg, key)))
        elif isinstance(val, dict):
            walk(f"{key}.", val)
        else:
            flat[key] = val
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
    ``layers`` leaf stacked over the leading layer axes) from a
    ``Transformer`` or from a ``{name: tensor}`` dict keyed by its parameter
    names."""
    named = (dict(params.named_parameters()) if isinstance(params, torch.nn.Module)
             else dict(params))
    tree: dict = {}
    per_layer: dict = {}

    def put(node, path, arr):
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr

    for name, t in named.items():
        arr = t.detach().cpu().numpy()
        parts = name.split(".")
        if parts[0] in LAYER_STACKS:
            per_layer.setdefault((parts[0], *parts[2:]), {})[int(parts[1])] = arr
        else:
            put(tree, parts, arr)
    stacks = ("enc_layers", "dec_layers") if cfg.family == "encdec" else ("layers",)
    for stack in stacks:
        tree[stack] = {}
    for (stack, *path), by_index in per_layer.items():
        n = _n_layers(cfg, stack)
        if sorted(by_index) != list(range(n)):
            raise ValueError(f"{stack}.*.{'.'.join(path)}: layers {sorted(by_index)}, "
                             f"expected {n}")
        stacked = np.stack([by_index[i] for i in range(n)])
        put(tree.setdefault(stack, {}), path,
            stacked.reshape(_layer_axes(cfg, stack) + stacked.shape[1:]))
    return tree
