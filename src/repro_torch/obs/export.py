"""repro_torch.obs.export — Chrome-trace/Perfetto JSON export for recorded
spans, and a metrics endpoint (a copy of ``repro.obs.export``).

The Trace Event Format's complete-event (``"ph": "X"``) flavour: one object
per finished span with microsecond ``ts``/``dur``. The output loads directly
in ``chrome://tracing`` and https://ui.perfetto.dev.
"""

from __future__ import annotations

import json

from .spans import recorder


def chrome_trace(events=None) -> dict:
    """Render span events (default: the process recorder's) as a Chrome
    trace document. Span attrs become the event's ``args`` payload, shown in
    the viewer's detail pane."""
    from_recorder = events is None
    if from_recorder:
        events = recorder().events()
    trace_events = [{
        "name": ev["name"],
        "cat": ev["name"].split(".", 1)[0],
        "ph": "X",
        "ts": ev["ts_us"],
        "dur": ev["dur_us"],
        "pid": ev["pid"],
        "tid": ev["tid"],
        "args": ev.get("args", {}),
    } for ev in events]
    doc = {"traceEvents": trace_events, "displayTimeUnit": "ms"}
    dropped = recorder().dropped if from_recorder else 0
    if dropped:
        doc["otherData"] = {"dropped_spans": dropped}
    return doc


def save_chrome_trace(path: str, events=None) -> int:
    """Write the trace document; returns the event count."""
    doc = chrome_trace(events)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return len(doc["traceEvents"])


def start_metrics_server(port: int, registry=None):
    """Serve the unified registry over HTTP on a daemon thread (stdlib only):
    ``/metrics`` is Prometheus text exposition, ``/metrics.json`` the typed
    snapshot. Returns the ``http.server`` instance — call ``.shutdown()`` to
    stop; pass ``port=0`` to bind an ephemeral port (``server_port`` has the
    real one)."""
    import http.server
    import threading

    from .registry import default_registry
    reg = registry if registry is not None else default_registry()

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith("/metrics.json"):
                body = json.dumps(reg.snapshot(), indent=1,
                                  sort_keys=True).encode()
                ctype = "application/json"
            elif self.path.startswith("/metrics"):
                body = reg.exposition().encode()
                ctype = "text/plain; version=0.0.4"
            else:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):           # keep the CLI output clean
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="repro-torch-obs-metrics").start()
    return srv
