# repro_torch.obs — observability of the port (counterpart of repro.obs).
#
#   registry - unified typed metrics (counters/gauges/histograms with labels,
#              Prometheus text exposition + JSON snapshot); the plan-cache
#              stats of core.dispatch are a view over it
#   monitor  - live calibration-envelope monitoring per GEMM site through the
#              dispatch trace-hook seam: inside / near-edge / violated, with
#              overflow counting and pluggable alert sinks; the hook queues
#              device scalars and folds them on the host when read
#   spans    - lightweight trace spans (the continuous batcher's runs, the
#              serving tier's requests) exporting Chrome-trace/Perfetto JSON,
#              with per-plan energy attribution
#   export   - the Chrome-trace writer and a /metrics HTTP endpoint
#
# ``registry``/``spans`` import eagerly (stdlib-only, safe from the lowest
# layers — core.dispatch keeps its plan-cache counters here). ``monitor``
# and ``export`` resolve lazily, as in the reference: monitor imports
# core.dispatch, which imports this package.
from .registry import (Counter, Gauge, Histogram, MetricError, Registry,
                       default_registry)
from .spans import (Span, SpanRecorder, current_span, plan_energy_per_token,
                    recorder, span, start_span)

_LAZY = {
    "monitor": ".monitor", "export": ".export",
    "NumericsMonitor": ".monitor", "monitoring": ".monitor",
    "SiteStats": ".monitor", "cfg_capacity": ".monitor",
    "INSIDE": ".monitor", "NEAR_EDGE": ".monitor", "VIOLATED": ".monitor",
    "UNMONITORED": ".monitor", "STATUS_CODE": ".monitor",
    "chrome_trace": ".export", "save_chrome_trace": ".export",
    "start_metrics_server": ".export",
}

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricError", "Registry",
    "default_registry",
    "Span", "SpanRecorder", "current_span", "plan_energy_per_token",
    "recorder", "span", "start_span",
    *sorted(set(_LAZY) - {"monitor", "export"}),
]


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'repro_torch.obs' has no attribute {name!r}")
    import importlib
    module = importlib.import_module(mod, __name__)
    if name in ("monitor", "export"):
        return module
    return getattr(module, name)
