"""Mesh-reshape stability: the same bits on every factorization of a mesh
(counterpart of ``repro.workloads.mesh``).

The FDP's associativity makes one kernel's result independent of its
K-reduction order; this workload lifts the claim to a whole world of ranks.
Each deployed site's GEMM runs K-sharded over the flattened (data, model)
axes of every factorization of the world (8 ranks: 1x8, 2x4, 4x2, 8x1),
rank r holding K-shard r, with the cross-rank reduction dispatched through
``gemm(..., reduce_axis=...)``: FDP sites through the exact limb-summed
``fdp_psum``, native sites through a float all-reduce. Each is scored in
bits of agreement against the unsharded result. FDP sites land bit-equal
by construction; native sites measure their real drift (the staged
all-reduce of ``launch.mesh`` sums in another order on each
factorization).

When the context is model-bound and the world has more than one rank, the
workload also runs the end-to-end contract: forward logits and the
fixed-point loss gradients of one data-parallel step
(``sharded_value_and_grad``) on probe batches of one sequence a rank,
compared across every factorization. A rank's shapes depend only on the
rank count, so the comparison isolates the collective layer. Logits are
each rank's own; their deviation and scale are maxima over the world, so
every rank reports the same score.

Run it on every rank of a world (``launch.mesh.spawn``): building a mesh
is collective. Outside a world it is the degenerate 1x1 mesh and has no
model part, as the reference on one device. Registered as "mesh", opt-in:
it is not in ``DEFAULT_VALIDATORS``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import gemm, use_policy
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import DeviceMesh, world_rank, world_size
from repro_torch.numerics.search import _check_full_fp32
from repro_torch.parallel.axes import use_mesh

from .base import (PROBE_SEQ, ValidationReport, Validator, WorkloadContext,
                   make_probe_batch, probed_sites, register)

MESH_CAP_BITS = 53.0

# fixed-point grid for the cross-rank gradient mean in the end-to-end probe
# (the spec the train CLI's --fdp-grad uses)
_GRAD_OVF, _GRAD_MSB, _GRAD_LSB = 10, 10, -20
_AXES = ("data", "model")


def mesh_shapes(n_devices: int) -> list:
    """Every (R, C) factorization of ``n_devices`` (8 -> 1x8, 2x4, 4x2,
    8x1; 1 -> the degenerate 1x1)."""
    return [(r, n_devices // r) for r in range(1, n_devices + 1)
            if n_devices % r == 0]


def _bits(dev: float, scale: float) -> float:
    if dev == 0.0:
        return MESH_CAP_BITS
    if scale == 0.0:
        return 0.0
    return float(np.clip(-np.log2(dev / scale), 0.0, MESH_CAP_BITS))


def _deviation(ref: torch.Tensor, other: torch.Tensor) -> float:
    """max |other - ref| in float64 (the difference of two float32 values is
    exact there); no float64 copy where the two are equal."""
    if torch.equal(ref, other):
        return 0.0
    return float((other.to(torch.float64) - ref.to(torch.float64)).abs().max())


def _agreement_bits(ref, others) -> float:
    """Bits of agreement between ``ref`` and each of ``others`` (the
    K-reorder stability formula, applied across mesh shapes)."""
    ref = torch.as_tensor(ref)
    dev = max((_deviation(ref, torch.as_tensor(o)) for o in others), default=0.0)
    return _bits(dev, float(ref.abs().max()) if dev else 0.0)


def _world_max(values, device) -> list:
    """Each of ``values`` maximized over the world's ranks (exact)."""
    t = torch.tensor(values, dtype=torch.float64, device=device)
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


@register
class MeshReshapeStability(Validator):

    name = "mesh"
    phases = ("fwd", "bwd")

    def __init__(self, *, cfg=None, params=None, m: int = 8, n: int = 8,
                 k: int = 256, seed: int = 0, threshold: float = 10.0,
                 device=None):
        rng = np.random.default_rng(seed)
        self.device = resolve_device(device)
        self.a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(self.device)
        self.b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(self.device)
        self.cfg, self.params, self.seed = cfg, params, seed
        self.threshold = float(threshold)
        self.shapes = mesh_shapes(world_size())
        self._meshes = None

    @classmethod
    def from_context(cls, ctx: WorkloadContext) -> "MeshReshapeStability":
        # model binding is optional: without it the workload still probes
        # every deployed site's K-sharded contraction
        return cls(cfg=ctx.cfg, params=ctx.params, seed=ctx.seed,
                   threshold=ctx.budget_bits, device=ctx.device)

    def meshes(self) -> list:
        """One ``DeviceMesh`` a factorization, built on first use (building
        is collective: every rank runs the validator)."""
        if self._meshes is None:
            self._meshes = [DeviceMesh(s, _AXES) for s in self.shapes]
        return self._meshes

    # -- per-site K-sharded contraction probe -------------------------------
    def _site_bits(self, site: str, policy) -> float:
        n, r = world_size(), world_rank()
        kb = self.a.shape[1] // n
        al, bl = self.a[:, r * kb:(r + 1) * kb], self.b[r * kb:(r + 1) * kb]
        with torch.no_grad():
            ref = gemm(self.a, self.b, site=site, policy=policy)
            outs = []
            for mesh in self.meshes():
                with use_mesh(mesh):
                    outs.append(gemm(al, bl, site=site, policy=policy, reduce_axis=_AXES))
        return _agreement_bits(ref, outs)

    # -- end-to-end: logits + loss gradients across mesh shapes --------------
    def _model_bits(self, policy) -> dict:
        from repro_torch.models import forward
        from repro_torch.train.loop import make_loss_fn, sharded_value_and_grad

        n, r = world_size(), world_rank()
        batch = make_probe_batch(self.cfg, batch_size=n, seq=PROBE_SEQ,
                                 seed=self.seed + 1, with_targets=True, device=self.device)
        local = {k: v[r:r + 1] for k, v in batch.items()}
        grad_spec = AccumulatorSpec(ovf=_GRAD_OVF, msb=_GRAD_MSB, lsb=_GRAD_LSB)
        vg = sharded_value_and_grad(make_loss_fn(self.cfg, remat="none"), _AXES,
                                    fdp_grad_spec=grad_spec)
        logits0 = grads0 = None
        dev_l = dev_g = 0.0
        for mesh in self.meshes():
            with use_mesh(mesh), use_policy(policy):
                with torch.no_grad():
                    logits = forward(self.params, self.cfg, local, remat="none")
                _, grads = vg(self.params, local)
            if logits0 is None:
                logits0, grads0 = logits, grads
                continue
            dev_l = max(dev_l, _deviation(logits0, logits))
            dev_g = max(dev_g, max(_deviation(grads0[k], g) for k, g in grads.items()))
            del grads
        # logits are each rank's own; gradients are the same on every rank
        scale_l = float(logits0.abs().max())
        scale_g = max(float(g.abs().max()) for g in grads0.values())
        dev_l, scale_l, dev_g, scale_g = _world_max([dev_l, scale_l, dev_g, scale_g],
                                                    self.device)
        return {"logits_bits": _bits(dev_l, scale_l), "grad_bits": _bits(dev_g, scale_g)}

    def run(self, policy) -> ValidationReport:
        _check_full_fp32(self.device)
        sites = probed_sites(policy) or ["workload_probe"]
        attribution = {s: self._site_bits(s, policy) for s in sites}
        details = {"mesh_shapes": ",".join(f"{r}x{c}" for r, c in self.shapes),
                   "n_sites_probed": len(sites),
                   "bit_identical_sites":
                       sum(v >= MESH_CAP_BITS for v in attribution.values())}

        model_bound = (self.cfg is not None and self.params is not None
                       and world_size() > 1)
        if model_bound:
            mb = self._model_bits(policy)
            details.update(mb)
            # whole-namespace deficits the upgrade loop can act on: forward
            # sites move the logits, backward sites move the gradients
            attribution["*"] = mb["logits_bits"]
            attribution["*@bwd"] = mb["grad_bits"]

        weakest = min(attribution, key=attribution.get)
        details["weakest_site"] = weakest
        return ValidationReport(
            workload=self.name, score=attribution[weakest],
            threshold=self.threshold, site_attribution=dict(attribution),
            details=details, mesh=details["mesh_shapes"])
