"""Live scrape endpoint — a tiny stdlib HTTP listener serving the process
metric registry.

``/metrics`` answers Prometheus text exposition (the same document
``obs.export.prometheus_text`` writes, but LIVE — a scraper watches the
scheduler's counters climb while queries run); ``/healthz`` answers a
small JSON liveness document with the session's active-query count.

Enabled by ``spark.rapids.tpu.metrics.httpPort``: a positive port binds it
there, ``-1`` binds an ephemeral port (tests/ops probes), ``0`` (default)
keeps it off. A session starts it at construction when the conf asks, at
most one listener per session (``ensure_scrape``); ``session.close()``
stops it.

stdlib-only on purpose (``http.server`` + the existing exporters): a hung
query must not hang the scrape — the handler reads registry snapshots,
never engine locks.

Copied from ``spark_rapids_tpu/obs/scrape.py``; the serving front-end's
readiness fields wait for the serving slice.
"""
from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

_log = logging.getLogger(__name__)


class ScrapeServer:
    """One HTTP listener over the process registry. ``session`` (optional)
    contributes its last plan's per-operator series and circuit-breaker
    state to ``/metrics`` and its active-query count to ``/healthz``."""

    def __init__(self, session=None, host: str = "127.0.0.1", port: int = 0):
        self.session = session
        self.host = host
        self.port = max(0, int(port))
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ── lifecycle ───────────────────────────────────────────────────────
    def start(self) -> tuple:
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = outer._metrics_text().encode("utf-8")
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif self.path.split("?")[0] == "/healthz":
                        body = json.dumps(outer._health()).encode("utf-8")
                        ctype = "application/json"
                    else:
                        self.send_error(404, "unknown path")
                        return
                except Exception as e:  # noqa: BLE001 - scrape never crashes
                    self.send_error(500, str(e)[:200])
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # quiet: scrapes are periodic
                _log.debug("scrape: " + fmt, *args)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="srt-metrics-scrape",
            daemon=True,
        )
        self._thread.start()
        _log.info("metrics scrape on http://%s:%d/metrics", self.host, self.port)
        return self.host, self.port

    def stop(self) -> None:
        httpd = self._httpd
        if httpd is None:
            return
        self._httpd = None
        httpd.shutdown()
        httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "ScrapeServer":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # ── documents ───────────────────────────────────────────────────────
    def _metrics_text(self) -> str:
        from .export import prometheus_text

        plan = getattr(self.session, "_last_plan", None)
        return prometheus_text(plan=plan, session=self.session)

    def _health(self) -> dict:
        out = {"status": "ok", "live": True}
        sess = self.session
        if sess is not None:
            try:
                out["active_queries"] = len(sess.active_queries())
            except Exception:  # noqa: BLE001 - health must answer regardless
                pass
        return out


def ensure_scrape(session) -> Optional[ScrapeServer]:
    """Start (once per session) the scrape listener the conf asks for:
    ``spark.rapids.tpu.metrics.httpPort`` > 0 binds that port, ``-1`` an
    ephemeral one, ``0`` disables. Returns the live ScrapeServer or None.
    Bind failures log and disable rather than failing the session — an
    occupied metrics port must not take down queries."""
    from .. import config as cfg

    existing = getattr(session, "_scrape_server", None)
    if existing is not None:
        return existing
    conf_port = cfg.METRICS_HTTP_PORT.get(session.conf)
    if conf_port == 0:
        return None
    srv = ScrapeServer(session=session, port=0 if conf_port < 0 else conf_port)
    try:
        srv.start()
    except OSError as e:
        _log.warning("metrics scrape bind failed (disabled): %s", e)
        return None
    session._scrape_server = srv
    return srv
