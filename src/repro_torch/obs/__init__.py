# repro_torch.obs — observability of the port (counterpart of repro.obs).
#
#   registry - unified typed metrics (counters/gauges/histograms with labels,
#              Prometheus text exposition + JSON snapshot); the plan-cache
#              stats of core.dispatch are a view over it
#   spans    - lightweight trace spans (the continuous batcher's runs)
#              exporting Chrome-trace/Perfetto JSON, with per-plan energy
#              attribution
#   export   - the Chrome-trace writer and a /metrics HTTP endpoint
#
# ``registry``/``spans`` import eagerly (stdlib-only, safe from the lowest
# layers — core.dispatch keeps its plan-cache counters here). ``export``
# resolves lazily, as in the reference. The reference's live envelope
# monitor (``monitor``: NumericsMonitor, monitoring, the status constants)
# is not ported yet: its names raise AttributeError naming the ROADMAP item.
from .registry import (Counter, Gauge, Histogram, MetricError, Registry,
                       default_registry)
from .spans import (Span, SpanRecorder, current_span, plan_energy_per_token,
                    recorder, span, start_span)

_LAZY = {
    "export": ".export",
    "chrome_trace": ".export", "save_chrome_trace": ".export",
    "start_metrics_server": ".export",
}
# the reference's monitor names, with the ROADMAP item that brings them
_NOT_PORTED = ("monitor", "NumericsMonitor", "monitoring", "SiteStats",
               "cfg_capacity", "INSIDE", "NEAR_EDGE", "VIOLATED", "UNMONITORED",
               "STATUS_CODE")
_MONITOR_ITEM = "ROADMAP queue 1, *Serving tier*, second half"

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricError", "Registry",
    "default_registry",
    "Span", "SpanRecorder", "current_span", "plan_energy_per_token",
    "recorder", "span", "start_span",
    *sorted(set(_LAZY) - {"export"}),
]


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"repro_torch.obs.{name}: the numerics monitor is not ported yet "
            f"({_MONITOR_ITEM})")
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib
    module = importlib.import_module(mod, __name__)
    if name == "export":
        return module
    return getattr(module, name)
