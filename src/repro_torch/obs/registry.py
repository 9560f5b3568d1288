"""repro_torch.obs.registry — the unified metrics registry (a copy of
``repro.obs.registry``; the port imports nothing of the JAX package).

One process-wide, thread-safe home for every operational number the port
emits: typed counter/gauge/histogram families with labels, a
Prometheus-style text exposition, and a JSON snapshot. The plan-cache
counters of ``core.dispatch`` (``plan_cache_stats``) are a view over it.
Metric names and the snapshot's ``kind`` are the reference's
(``repro_*``, ``repro.obs.MetricsSnapshot``), so one dashboard reads both
packages.

Zero dependencies beyond the stdlib by design: the registry is importable
from ``repro_torch.core.dispatch`` (the lowest layer) without pulling in
torch.

Conventions
-----------
* Metric names are ``repro_``-prefixed snake_case; counters end in ``_total``,
  histograms carry a unit suffix (``_seconds``).
* Label values are stringified; a family's label *names* are fixed at creation
  and re-registration with a different shape is a :class:`MetricError` — the
  registry is the schema.
* ``Registry.reset()`` zeroes values but keeps families, so long-lived handles
  held by components survive test isolation. Counters are therefore only
  monotonic *between* resets; exposition notes this is a process-local
  registry, not a durable time series.
"""

from __future__ import annotations

import json
import threading

REGISTRY_KIND = "repro.obs.MetricsSnapshot"
REGISTRY_VERSION = 1

# latency-flavoured default buckets (seconds): sub-ms dispatch up to minute-
# scale AOT compiles land in distinct buckets on CPU CI machines
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class MetricError(ValueError):
    """Schema violation: kind/label mismatch or unknown label key."""


class Metric:
    """One metric family: a name, fixed label names, and per-labelset values.

    Subclasses define the value shape; all mutation goes through the owning
    registry's lock so concurrent serving and train threads (and autograd's
    device thread) can hit the same family safely.
    """

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str = "",
                 labels: tuple = ()):
        self._registry = registry
        self._lock = registry._lock
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._values: dict = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.label_names):
            raise MetricError(
                f"{self.name}: labels {sorted(labels)} do not match the "
                f"registered label names {sorted(self.label_names)}")
        return tuple(str(labels[k]) for k in self.label_names)

    def _labelset(self, key: tuple) -> dict:
        return dict(zip(self.label_names, key))

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    # subclass API ---------------------------------------------------------
    def _sample_json(self, key: tuple, value) -> dict:
        raise NotImplementedError

    def _sample_text(self, key: tuple, value) -> list:
        raise NotImplementedError

    def to_json(self) -> dict:
        with self._lock:
            items = sorted(self._values.items())
            return {"kind": self.kind, "help": self.help,
                    "label_names": list(self.label_names),
                    "values": [self._sample_json(k, v) for k, v in items]}

    def _label_text(self, key: tuple, extra: tuple = ()) -> str:
        pairs = list(zip(self.label_names, key)) + list(extra)
        if not pairs:
            return ""
        body = ",".join(f'{k}="{_escape(v)}"' for k, v in pairs)
        return "{" + body + "}"


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n",
                                                                   r"\n")


class Counter(Metric):
    """Monotonic event count (until ``Registry.reset()``)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise MetricError(f"{self.name}: counters only go up "
                              f"(inc({amount}))")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def total(self) -> float:
        """Sum over every labelset — 'how many, regardless of breakdown'."""
        with self._lock:
            return sum(self._values.values())

    def _sample_json(self, key, value) -> dict:
        return {"labels": self._labelset(key), "value": value}

    def _sample_text(self, key, value) -> list:
        return [f"{self.name}{self._label_text(key)} {_fmt(value)}"]


class Gauge(Metric):
    """Point-in-time value (set/add; last write wins)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels):
        key = self._key(labels)
        with self._lock:
            return self._values.get(key)

    def _sample_json(self, key, value) -> dict:
        return {"labels": self._labelset(key), "value": value}

    def _sample_text(self, key, value) -> list:
        return [f"{self.name}{self._label_text(key)} {_fmt(value)}"]


class Histogram(Metric):
    """Cumulative-bucket distribution (Prometheus semantics: each ``le``
    bucket counts observations ≤ its bound, plus ``+Inf``/sum/count)."""

    kind = "histogram"

    def __init__(self, registry, name, help="", labels=(),
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                state = {"counts": [0] * (len(self.buckets) + 1),
                         "sum": 0.0, "count": 0}
                self._values[key] = state
            for i, b in enumerate(self.buckets):
                if value <= b:
                    state["counts"][i] += 1
                    break
            else:
                state["counts"][-1] += 1
            state["sum"] += value
            state["count"] += 1

    def value(self, **labels):
        key = self._key(labels)
        with self._lock:
            state = self._values.get(key)
            if state is None:
                return None
            return {"sum": state["sum"], "count": state["count"]}

    def _sample_json(self, key, state) -> dict:
        cum, buckets = 0, {}
        for b, n in zip(self.buckets, state["counts"]):
            cum += n
            buckets[str(b)] = cum
        buckets["+Inf"] = state["count"]
        return {"labels": self._labelset(key), "count": state["count"],
                "sum": state["sum"], "buckets": buckets}

    def _sample_text(self, key, state) -> list:
        lines, cum = [], 0
        for b, n in zip(self.buckets, state["counts"]):
            cum += n
            lines.append(f"{self.name}_bucket"
                         f"{self._label_text(key, (('le', _fmt(b)),))} {cum}")
        lines.append(f"{self.name}_bucket"
                     f"{self._label_text(key, (('le', '+Inf'),))} "
                     f"{state['count']}")
        lines.append(f"{self.name}_sum{self._label_text(key)} "
                     f"{_fmt(state['sum'])}")
        lines.append(f"{self.name}_count{self._label_text(key)} "
                     f"{state['count']}")
        return lines


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class Registry:
    """A named collection of metric families with atomic get-or-create.

    ``counter``/``gauge``/``histogram`` are idempotent: the first call fixes
    the family's kind + label names, later calls return the same handle and
    any mismatch is a loud :class:`MetricError` rather than a silently forked
    schema.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: dict = {}

    def _get_or_create(self, cls, name, help, labels, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, help=help, labels=tuple(labels), **kw)
                self._metrics[name] = m
                return m
            if not isinstance(m, cls):
                raise MetricError(f"{name} is registered as a {m.kind}, "
                                  f"not a {cls.kind}")
            if m.label_names != tuple(labels):
                raise MetricError(
                    f"{name} is registered with labels {m.label_names}, "
                    f"not {tuple(labels)}")
            return m

    def counter(self, name: str, help: str = "", labels=()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels=()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels=(),
                  buckets: tuple = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name: str):
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> list:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Zero every family's values, keeping the families (and any handles
        components hold) alive — the test-isolation primitive."""
        with self._lock:
            for m in self._metrics.values():
                m.clear()

    # -- exposition --------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able snapshot of every family (the reference's
        ``--metrics-dump`` payload has this shape)."""
        with self._lock:
            metrics = {name: m.to_json()
                       for name, m in sorted(self._metrics.items())}
        return {"kind": REGISTRY_KIND, "version": REGISTRY_VERSION,
                "metrics": metrics}

    def snapshot_json(self, indent: int = 1) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def exposition(self) -> str:
        """Prometheus text exposition (process-local; counters reset with
        ``Registry.reset()``, so scrapers should treat restarts normally)."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {_escape(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            with self._lock:
                items = sorted(m._values.items())
            for key, value in items:
                lines.extend(m._sample_text(key, value))
        return "\n".join(lines) + ("\n" if lines else "")


# The process default: components resolve this unless handed an explicit
# registry (tests pass their own for isolation).
_DEFAULT = Registry()


def default_registry() -> Registry:
    return _DEFAULT
