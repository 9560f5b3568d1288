"""PrecisionPlan: the deployable output of the tailoring search (counterpart
of ``repro.numerics.plan``, the loader and its writer).

A plan is a versioned JSON document mapping GEMM call-sites to the
⟨format, accumulator, backend⟩ each one earned in the search, plus the
modeled-energy/accuracy bookkeeping that justified the choice. Loading a plan
yields a ``NumericsPolicy`` with per-site overrides, consumed by the launch
drivers via ``--precision-plan`` — the same artifact moves from the search
notebook to serving without translation.

Schema v2 (phase-aware sites)
-----------------------------
Site keys are canonical ``GemmSite`` strings: forward sites stay plain names
("attn_qk"), backward sites are phase-qualified ("attn_qk@bwd.dA"). A v2
document additionally carries ``bwd_default`` — the widened fallback config
that the deployed policy installs as a ``*@bwd`` wildcard override, so any
gradient GEMM the search did not assign runs wide instead of silently
inheriting its forward twin's (possibly narrow) datapath.

Schema v3 (aux precision sites)
-------------------------------
v3 adds non-GEMM *aux* sites: optimizer-state (``opt.m@state``) and
collective (``grad_psum@coll``) assignments whose cfg is a block-scaled
``repro_torch.core.qformat.QuantConfig`` (serialized under a ``quant`` key, so a
site's cfg shape says which config family it is). Each ``SitePlan`` carries
``kind`` ("gemm" | "state" | "collective") and, for aux sites,
``bytes_total`` — the modeled resident/wire bytes that are the search's
Pareto cost for that site. ``to_policy`` routes aux assignments into
``NumericsPolicy.aux`` (never ``overrides``: aux keys are not GemmSites).
v2 documents are pure-GEMM and load transparently.

v1 documents load transparently: their plain-name assignments become
forward-only under the phase-aware policy lookup (exactly the v1 dispatch
semantics), ``bwd_default`` is synthesized by widening the plan default
(``repro_torch.core.dispatch.widen_config``), and ``meta.migrated_from`` records
the up-conversion. Saving a migrated plan writes a v2 document.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from repro_torch.core.accumulator import AccumulatorSpec
from repro_torch.core.dispatch import (GemmConfig, GemmSite, NumericsPolicy,
                                       widen_config)
from repro_torch.core.formats import get_format
from repro_torch.core.qformat import QuantConfig, site_kind

PLAN_VERSION = 3


def _cfg_to_json(cfg) -> dict:
    if isinstance(cfg, QuantConfig):
        return {"quant": {"bits": cfg.bits, "block": cfg.block,
                          "mode": cfg.mode,
                          "error_feedback": cfg.error_feedback}}
    acc = None
    if cfg.acc is not None:
        acc = {"ovf": cfg.acc.ovf, "msb": cfg.acc.msb, "lsb": cfg.acc.lsb,
               "round_mode": cfg.acc.round_mode,
               "overflow_mode": cfg.acc.overflow_mode}
    return {"fmt": cfg.fmt.name, "acc": acc, "mode": cfg.mode}


def _cfg_from_json(d: dict):
    if "quant" in d:
        q = d["quant"]
        return QuantConfig(bits=int(q.get("bits", 8)),
                           block=int(q.get("block", 64)),
                           mode=q.get("mode", "block"),
                           error_feedback=bool(q.get("error_feedback",
                                                     False)))
    acc = None
    if d.get("acc") is not None:
        a = d["acc"]
        acc = AccumulatorSpec(ovf=int(a["ovf"]), msb=int(a["msb"]),
                              lsb=int(a["lsb"]),
                              round_mode=a.get("round_mode", "trunc"),
                              overflow_mode=a.get("overflow_mode", "wrap"))
    return GemmConfig(get_format(d["fmt"]), acc, d.get("mode", "native"))


@dataclasses.dataclass(frozen=True)
class SitePlan:
    """One call-site's assignment plus its search-time evidence. ``site`` is
    the canonical GemmSite key (phase-qualified for backward sites)."""

    site: str
    cfg: object                            # GemmConfig | QuantConfig (aux)
    kind: str = "gemm"                     # "gemm" | "state" | "collective"
    error_bits: Optional[float] = None     # vs the site's bit-exact oracle
    energy_j: Optional[float] = None       # modeled, at traced MAC count
    macs: int = 0                          # aux sites: element count
    latency_us: Optional[float] = None
    bytes_total: Optional[float] = None    # aux sites: modeled resident/wire

    @property
    def gemm_site(self) -> GemmSite:
        if self.kind != "gemm":
            raise ValueError(f"{self.site!r} is a {self.kind} site, "
                             "not a GemmSite")
        return GemmSite.parse(self.site)

    @property
    def phase(self) -> str:
        """Autodiff phase for GEMM sites; aux sites report their kind (they
        live outside the fwd/bwd namespace, so ``phase_sites`` never
        captures them)."""
        if self.kind != "gemm":
            return self.kind
        return self.gemm_site.phase

    def to_json(self) -> dict:
        d = {"site": self.site, "cfg": _cfg_to_json(self.cfg),
             "macs": self.macs}
        if self.kind != "gemm":
            d["kind"] = self.kind
        for k in ("error_bits", "energy_j", "latency_us", "bytes_total"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    @classmethod
    def from_json(cls, d: dict) -> "SitePlan":
        return cls(site=d["site"], cfg=_cfg_from_json(d["cfg"]),
                   kind=d.get("kind", "gemm"),
                   error_bits=d.get("error_bits"),
                   energy_j=d.get("energy_j"), macs=int(d.get("macs", 0)),
                   latency_us=d.get("latency_us"),
                   bytes_total=d.get("bytes_total"))


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Versioned, serializable per-site numerics assignment."""

    name: str
    sites: tuple = ()                      # tuple[SitePlan]
    default: GemmConfig = GemmConfig()     # unlisted fwd sites (native bf16)
    bwd_default: Optional[GemmConfig] = None  # unlisted bwd sites (widened)
    budget_bits: Optional[float] = None
    version: int = PLAN_VERSION
    meta: dict = dataclasses.field(default_factory=dict)

    def site(self, name: str) -> Optional[SitePlan]:
        for s in self.sites:
            if s.site == name:
                return s
        return None

    def phase_sites(self, phase: str) -> tuple:
        return tuple(s for s in self.sites if s.phase == phase)

    def gemm_sites(self) -> tuple:
        return tuple(s for s in self.sites if s.kind == "gemm")

    def aux_sites(self) -> tuple:
        return tuple(s for s in self.sites if s.kind != "gemm")

    def to_policy(self) -> NumericsPolicy:
        """The NumericsPolicy this plan deploys: exact-match per-site
        overrides over the plan default, with the ``*@bwd`` widened fallback
        appended last (lowest precedence) so explicitly-searched bwd sites
        always win over it. A plan constructed without ``bwd_default``
        deploys ``widen_config(default)`` there — the invariant holds for
        in-memory plans exactly as for loaded ones, so ``to_policy`` and
        save→load→``to_policy`` agree on every site. Aux (state/collective)
        assignments deploy through the policy's ``aux`` channel, read by the
        optimizer and the mesh train step — never through ``overrides``."""
        overrides = [(s.site, s.cfg) for s in self.gemm_sites()]
        overrides.append(
            ("*@bwd", self.bwd_default or widen_config(self.default)))
        return NumericsPolicy(
            default=self.default,
            overrides=tuple(overrides),
            name=f"plan:{self.name}",
            aux=tuple((s.site, s.cfg) for s in self.aux_sites()))

    # -- serialization -----------------------------------------------------
    def to_json(self) -> dict:
        doc = {
            "version": self.version,
            "kind": "repro.numerics.PrecisionPlan",
            "name": self.name,
            "budget_bits": self.budget_bits,
            "default": _cfg_to_json(self.default),
            "sites": [s.to_json() for s in self.sites],
            "meta": self.meta,
        }
        if self.bwd_default is not None:
            doc["bwd_default"] = _cfg_to_json(self.bwd_default)
        return doc

    @classmethod
    def from_json(cls, d: dict) -> "PrecisionPlan":
        version = int(d.get("version", 0))
        if version > PLAN_VERSION:
            raise ValueError(
                f"precision plan version {version} is newer than this "
                f"library's {PLAN_VERSION}; refusing to guess its semantics")
        if "sites" not in d or "name" not in d:
            raise ValueError("not a PrecisionPlan document "
                             "(missing 'name'/'sites')")
        default = (_cfg_from_json(d["default"]) if "default" in d
                   else GemmConfig())
        sites = tuple(SitePlan.from_json(s) for s in d["sites"])
        for s in sites:
            # reject malformed/mislabeled site keys early: the key's grammar
            # must agree with the stored kind, GEMM keys must parse, and the
            # cfg family must match the kind.
            k = site_kind(s.site)
            if k != s.kind:
                raise ValueError(
                    f"site {s.site!r} is keyed as a {k} site but the "
                    f"document labels it {s.kind!r}")
            if k == "gemm":
                GemmSite.parse(s.site)
                if isinstance(s.cfg, QuantConfig):
                    raise ValueError(f"GEMM site {s.site!r} carries a quant "
                                     "cfg")
            elif not isinstance(s.cfg, QuantConfig):
                raise ValueError(f"aux site {s.site!r} carries a non-quant "
                                 "cfg")
        meta = dict(d.get("meta", {}))
        if version <= 1:
            # v1 -> v2 up-conversion: plain-name assignments are forward-only
            # under phase-aware lookup (no rewrite needed), and the backward
            # namespace falls to the *widened* default — gradients never
            # silently inherit a narrow forward datapath.
            bwd_default = widen_config(default)
            meta.setdefault("migrated_from", version or 1)
        elif version < PLAN_VERSION:
            # v2 -> v3 is additive (aux site kinds + bytes axes); pure-GEMM
            # documents only need the provenance stamp.
            meta.setdefault("migrated_from", version)
            bwd_default = (_cfg_from_json(d["bwd_default"])
                           if d.get("bwd_default") is not None
                           else widen_config(default))
        elif d.get("bwd_default") is not None:
            bwd_default = _cfg_from_json(d["bwd_default"])
        else:
            # a v2 document with the key stripped (hand-authored, tooling)
            # gets the same treatment as v1: loading NEVER yields a policy
            # whose unassigned gradient GEMMs inherit the forward default.
            bwd_default = widen_config(default)
        return cls(
            name=d["name"],
            sites=sites,
            default=default,
            bwd_default=bwd_default,
            budget_bits=d.get("budget_bits"),
            version=PLAN_VERSION,
            meta=meta,
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")

    def describe(self) -> str:
        bwd = (f", bwd default {self.bwd_default.tag()}"
               if self.bwd_default else "")
        lines = [f"PrecisionPlan {self.name!r} v{self.version} "
                 f"(budget {self.budget_bits} bits, "
                 f"default {self.default.tag()}{bwd})"]
        for s in self.sites:
            bits = f"{s.error_bits:5.1f}b" if s.error_bits is not None else ""
            lines.append(f"  {s.site:22s} {s.cfg.tag():40s} {bits}")
        return "\n".join(lines)


def load_plan(path) -> PrecisionPlan:
    with open(path) as f:
        return PrecisionPlan.from_json(json.load(f))
