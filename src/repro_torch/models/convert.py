"""Parameters handed over from the JAX reference.

``params_from_numpy(tree, cfg, device)`` takes the reference's parameter
tree as a nested dict of numpy arrays (the caller runs
``jax.tree.map(np.asarray, params)`` on its side, so this package never sees
JAX), unstacks the leading layer axis of ``tree["layers"]`` and copies every
array into the port's ``Transformer``.
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
