"""Rank function of the placement tests (``tests/test_torch_placement.py``).
``repro_torch.launch.mesh.spawn`` starts the ranks, which import this module
(never a test file): torch and the port only, never JAX. ``world`` runs on
every rank of a 2x2 world and returns numpy arrays and plain values; the
tests hold them against the port in one process and the JAX package.
"""

import numpy as np
import torch

from repro_torch.core import dispatch as TD
from repro_torch.launch.serve import serve
from repro_torch.launch.sharding import (distribution_for, make_mesh, param_shardings, place,
                                         shard_params)
from repro_torch.models import init, params_from_numpy, prefill
from repro_torch.models.transformer import (block_of, forward, gather_block, init_abstract,
                                            init_cache)
from repro_torch.parallel.placement import STATS, placed_bytes

POLICIES = {"native": TD.MXU_FP32, "fdp91": TD.FDP91}


def _np(t):
    return t.detach().cpu().numpy()


def _run(cfg, params, dist, prompts, gen, policy) -> dict:
    """Tokens of ``serve``, the last logits of ``prefill`` (the rank's rows)
    and the forward's logits (gathered) under ``policy``, with the gathers'
    counters over the serve."""
    out = {}
    with TD.use_policy(POLICIES[policy]):
        STATS.reset()
        out["tokens"] = _np(serve(cfg, params, prompts, gen, device="cpu", dist=dist))
        out["stats"] = STATS.snapshot()
        rows = block_of(dist, prompts.shape[0], 1)[0]
        cache = init_cache(cfg, rows.stop - rows.start, prompts.shape[1], dtype=torch.float32,
                           device="cpu")
        out["prefill"] = _np(prefill(params, cfg, {"tokens": prompts}, cache, dist)[0])
        with torch.no_grad():
            y = forward(params, cfg, {"tokens": prompts}, dist, remat="none")
        out["forward"] = _np(gather_block(y, dist, prompts.shape[1]))
    return out


def world(dev, data: dict) -> dict:
    """Every placement case of the 2x2 world: for each model and profile,
    the placed parameters at rest (``place`` of the reference's weights and
    ``init(..., profile=)`` against ``place`` of a full seed-0 draw), their
    bytes against ``param_shardings``, and for the served profiles the
    placed and the replicated sharded runs (``_run``) under each policy."""
    torch.manual_seed(0)
    mesh = make_mesh((2, 2))
    prompts = torch.from_numpy(data["prompts"]).long()
    out = {"rank": mesh.rank, "coords": mesh.coords}
    for name, (cfg, tree) in data["models"].items():
        full_bytes = placed_bytes(params_from_numpy(tree, cfg, device="cpu"))
        for profile in ("fsdp", "ddp", "decode_tp"):
            d = distribution_for(mesh, profile)
            key = f"{name}/{profile}"
            placed = place(params_from_numpy(tree, cfg, device="cpu"), cfg, d, profile)
            shardings = param_shardings(cfg, init_abstract(cfg), mesh, profile)
            drawn = init(cfg, seed=0, device="cpu", dist=d, profile=profile)
            cut = place(init(cfg, seed=0, device="cpu"), cfg, d, profile)
            out[key] = {
                "blocks": {k: _np(p) for k, p in placed.named_parameters()},
                "bytes": placed_bytes(placed),
                "spec_bytes": sum(pl.nbytes() for pl in shardings.values()),
                "full_bytes": full_bytes,
                "init_equal": all(torch.equal(p, dict(cut.named_parameters())[k])
                                  for k, p in drawn.named_parameters()),
            }
            if profile not in data["served"]:
                continue
            replicated = shard_params(params_from_numpy(tree, cfg, device="cpu"), cfg, d)
            for policy in data["policies"]:
                out[key][policy] = {"placed": _run(cfg, placed, d, prompts, data["gen"], policy),
                                    "replicated": _run(cfg, replicated, d, prompts,
                                                       data["gen"], policy)}
            out[key]["live_after"] = STATS.live
    return out

