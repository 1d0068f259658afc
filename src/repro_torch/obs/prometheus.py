"""Prometheus text exposition (format 0.0.4) + a background scrape server
(a copy of ``repro.obs.prometheus``).

``render`` turns a :class:`~repro_torch.obs.metrics.MetricsRegistry` into the
plaintext format; :class:`MetricsServer` serves it from a daemon thread
on ``GET /metrics`` so a live engine can be scraped (or curl'd) without
touching the tick loop.  Stdlib ``http.server`` only — no new deps.
"""
from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

from .metrics import MetricsRegistry

__all__ = ["render", "MetricsServer", "CONTENT_TYPE"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt_num(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, v.replace("\\", r"\\").replace('"', r"\"")
                         .replace("\n", r"\n"))
        for k, v in key)
    return "{" + body + "}"


def render(registry: MetricsRegistry) -> str:
    """Registry -> Prometheus plaintext exposition."""
    lines = []
    for fam in registry.families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        for key, series in sorted(fam.series.items()):
            lbl = _fmt_labels(key)
            if fam.kind == "histogram":
                for bound, cum in series.cumulative_buckets():
                    bkey = key + (("le", _fmt_num(bound)),)
                    lines.append(
                        f"{fam.name}_bucket{_fmt_labels(bkey)} {cum}")
                lines.append(f"{fam.name}_sum{lbl} {_fmt_num(series.sum)}")
                lines.append(f"{fam.name}_count{lbl} {series.count}")
            else:
                lines.append(f"{fam.name}{lbl} {_fmt_num(series.value)}")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Daemon-thread HTTP server exposing ``/metrics``.

    ``port=0`` binds an ephemeral port; read it back from ``.port`` (the
    tests and ``serve --metrics-port 0`` both do).
    """

    def __init__(self, registry: MetricsRegistry, port: int = 0,
                 host: str = "127.0.0.1") -> None:
        self.registry = registry

        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (http.server API)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = render(outer.registry).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass  # scrapes must not spam the serving stdout

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter",
            daemon=True)
        self._started = False

    def start(self) -> "MetricsServer":
        if not self._started:
            self._thread.start()
            self._started = True
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        if self._started:
            self._server.shutdown()
            self._thread.join(timeout=5.0)
            self._started = False
        self._server.server_close()
