"""Prometheus text exposition over the obs registry (mirrors
``traceweaver_tpu/obs/exposition.py``).

:func:`render_metrics` renders the registry in the Prometheus text
format 0.0.4 (``# HELP``/``# TYPE`` then one ``name{labels} value`` line
per sample, label values escaped, families and samples sorted so scrapes
diff cleanly). :func:`start_metrics_server` runs a stdlib sidecar
exporter on a daemon thread: the batch CLI's ``--metrics_port``.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Iterable, Optional

from traceweaver_tpu_torch.obs.registry import MetricsRegistry, get_registry

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_value(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value in (float("inf"), float("-inf")):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer():
        return str(int(value))
    return repr(float(value))


def render_metrics(registry: Optional[MetricsRegistry] = None,
                   extra: Iterable = ()) -> str:
    """Render the registry (plus ``extra`` collector-style families —
    ``(name, kind, help, [(labels, value), ...])`` tuples) as the
    Prometheus text format."""
    registry = registry if registry is not None else get_registry()
    lines = []
    families = list(registry.collect()) + list(extra)
    for name, kind, help_text, samples in families:
        if help_text:
            lines.append("# HELP %s %s"
                         % (name, help_text.replace("\n", " ")))
        lines.append("# TYPE %s %s" % (name, kind))
        for labels, value in samples:
            labels = dict(labels)
            sample_name = labels.pop("__name__", name)
            if labels:
                body = ",".join('%s="%s"' % (k, _escape_label(v))
                                for k, v in sorted(labels.items()))
                lines.append("%s{%s} %s"
                             % (sample_name, body, _fmt_value(value)))
            else:
                lines.append("%s %s" % (sample_name, _fmt_value(value)))
    return "\n".join(lines) + "\n"


class _ExporterHandler(BaseHTTPRequestHandler):
    server_version = "traceweaver-metrics/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 — scrapes are chatty
        pass

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            body = b"try /metrics\n"
            self.send_response(404)
        else:
            srv = self.server  # type: ignore[assignment]
            extra = srv.extra_fn() if srv.extra_fn is not None else ()
            body = render_metrics(srv.registry, extra).encode("utf-8")
            self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class MetricsExporter(ThreadingHTTPServer):
    """Sidecar ``/metrics`` server bound to one registry."""

    daemon_threads = True

    def __init__(self, registry: MetricsRegistry, host: str, port: int,
                 extra_fn=None) -> None:
        self.registry = registry
        self.extra_fn = extra_fn
        super().__init__((host, port), _ExporterHandler)

    @property
    def port(self) -> int:
        return self.server_address[1]


def start_metrics_server(port: int, host: str = "127.0.0.1",
                         registry: Optional[MetricsRegistry] = None,
                         extra_fn=None) -> MetricsExporter:
    """Bind and serve ``/metrics`` on a daemon thread (port 0 =
    ephemeral, the test mode). Returns the server; call ``shutdown()``
    +``server_close()`` to stop it."""
    exporter = MetricsExporter(
        registry if registry is not None else get_registry(),
        host, port, extra_fn=extra_fn)
    thread = threading.Thread(target=exporter.serve_forever,
                              kwargs=dict(poll_interval=0.2),
                              name="tw-metrics-exporter", daemon=True)
    thread.start()
    return exporter
