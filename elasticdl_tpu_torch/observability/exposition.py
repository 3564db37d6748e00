"""Prometheus text-format rendering + the stdlib-only /metrics endpoint.

A copy of elasticdl_tpu/observability/exposition.py: the port keeps its own.

``render_prometheus`` turns registry snapshots (``registry.snapshot()``
dicts) into Prometheus exposition format 0.0.4: one ``# HELP`` /
``# TYPE`` pair per family, escaped label values, and cumulative
histogram ``_bucket``/``_sum``/``_count`` series with ``le`` labels.
Worker snapshots get a ``worker="<id>"`` label so the cluster view
keeps per-worker series apart (and a departed worker's series simply
stop appearing once the aggregator ages it out).

``MetricsHTTPServer`` serves ``/metrics`` and ``/healthz`` from a
``http.server.ThreadingHTTPServer`` on a daemon thread — no new
dependency, ephemeral-port friendly (``port=0``), scrapeable by real
Prometheus or ``tools/dump_metrics.py``. With a ``traces`` callable it
also serves ``/traces``: the process flight recorder / master trace
collection as JSON, for ``tools/dump_metrics.py --traces``.
"""

import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("metrics_http")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# Exemplars are only legal in the OpenMetrics wire format — a classic
# 0.0.4 parser rejects the mid-line `#` — so /metrics serves them only
# to clients that ASK via Accept (exactly Prometheus's negotiation),
# terminated by the mandatory `# EOF`.
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label_value(value: str) -> str:
    return (
        value.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    )


def _format_value(value: float) -> str:
    if value == float("inf"):
        return "+Inf"
    if value == float("-inf"):
        return "-Inf"
    if float(value) == int(value) and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


def _label_str(labelnames, labelvalues, extra: Dict[str, str]) -> str:
    parts = [
        f'{name}="{_escape_label_value(str(value))}"'
        for name, value in list(zip(labelnames, labelvalues))
        + sorted(extra.items())
    ]
    return "{%s}" % ",".join(parts) if parts else ""


def _exemplar_suffix(series: dict, index: int) -> str:
    """OpenMetrics exemplar rendering for one bucket line:
    `` # {trace_id="..."} value timestamp`` — how a scrape links a
    histogram bucket to one concrete trace (docs/observability.md
    "Continuous profiling & exemplars"). Empty when the series carries
    no exemplar for that bucket."""
    exemplars = series.get("exemplars")
    if not exemplars:
        return ""
    entry = exemplars.get(str(index))
    if not entry:
        return ""
    value, trace_id, ts = entry
    return (
        f' # {{trace_id="{_escape_label_value(str(trace_id))}"}}'
        f" {_format_value(float(value))} {float(ts):.3f}"
    )


def _render_series(lines, family: dict, series: dict,
                   extra: Dict[str, str], exemplars: bool = False):
    name = family["name"]
    labelnames = family.get("labelnames", [])
    values = series.get("labels", [])
    if family["kind"] == "histogram":
        cumulative = 0
        for i, (ub, n) in enumerate(
            zip(family["buckets"], series["buckets"])
        ):
            cumulative += n
            le = {"le": _format_value(ub)}
            suffix = _exemplar_suffix(series, i) if exemplars else ""
            lines.append(
                f"{name}_bucket"
                f"{_label_str(labelnames, values, {**extra, **le})}"
                f" {cumulative}{suffix}"
            )
        suffix = (
            _exemplar_suffix(series, len(family["buckets"]))
            if exemplars else ""
        )
        lines.append(
            f"{name}_bucket"
            f"{_label_str(labelnames, values, {**extra, 'le': '+Inf'})}"
            f" {series['count']}{suffix}"
        )
        lines.append(
            f"{name}_sum{_label_str(labelnames, values, extra)}"
            f" {_format_value(series['sum'])}"
        )
        lines.append(
            f"{name}_count{_label_str(labelnames, values, extra)}"
            f" {series['count']}"
        )
    else:
        lines.append(
            f"{name}{_label_str(labelnames, values, extra)}"
            f" {_format_value(series['value'])}"
        )


def render_prometheus(
    local_snapshot: Optional[dict] = None,
    worker_snapshots: Optional[Dict[int, dict]] = None,
    exemplars: bool = False,
) -> str:
    """Render the master-local snapshot plus per-worker snapshots.

    Families appearing in several snapshots (every worker instruments
    the same code) emit ONE ``# HELP``/``# TYPE`` header; worker series
    carry a ``worker`` label, master-local series none.

    ``exemplars=True`` renders captured histogram exemplars as
    OpenMetrics bucket-line suffixes — ONLY legal on the OpenMetrics
    content type (the /metrics handler negotiates via Accept); the
    classic 0.0.4 rendering must stay exemplar-free or standard
    Prometheus parsers reject the whole scrape.
    """
    # family name -> (family dict, [(series, extra_labels)])
    merged: Dict[str, tuple] = {}

    def _ingest(snapshot: dict, extra: Dict[str, str]):
        for family in snapshot.get("families", []):
            entry = merged.get(family["name"])
            if entry is None:
                entry = merged[family["name"]] = (family, [])
            for series in family.get("series", []):
                entry[1].append((family, series, extra))

    if local_snapshot:
        _ingest(local_snapshot, {})
    # key=str: reporter keys mix worker ints with named components
    # ("router-0") since the snapshot piggyback grew beyond workers.
    for worker_id in sorted(worker_snapshots or {}, key=str):
        _ingest(worker_snapshots[worker_id], {"worker": str(worker_id)})

    lines = []
    for name in sorted(merged):
        family, series_list = merged[name]
        lines.append(f"# HELP {name} {_escape_help(family.get('help', ''))}")
        lines.append(f"# TYPE {name} {family['kind']}")
        for owning_family, series, extra in series_list:
            _render_series(lines, owning_family, series, extra,
                           exemplars=exemplars)
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    # Populated per-server via functools.partial-style subclassing in
    # MetricsHTTPServer.start().
    render: Callable[[], str] = staticmethod(lambda: "")
    # OpenMetrics rendering (with exemplars) served when the client's
    # Accept names it; None = classic only.
    render_openmetrics: Optional[Callable[[], str]] = None
    traces: Optional[Callable[[], dict]] = None
    # path -> callable(query_params_dict) -> JSON-able object; how the
    # SLO plane mounts /timeseries and /alerts without this module
    # knowing either (docs/observability.md).
    json_routes: Dict[str, Callable[[dict], object]] = {}
    # Mutable holder {"fn": callable or None}: when set, /healthz
    # serves fn()'s JSON verdict with HTTP 200/503 on its "ok" key —
    # how the synthetic-probe plane (observability/prober.py) turns
    # the static liveness endpoint into an aggregated readiness
    # verdict. Holder (not a bare callable) so it can be mounted on a
    # server that already started, like json_routes.
    health: Dict[str, Optional[Callable[[], dict]]] = {}

    def _reply(self, body: bytes, content_type: str):
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (BaseHTTPRequestHandler API)
        path, _, query = self.path.partition("?")
        routes = type(self).json_routes
        if path == "/metrics":
            om = type(self).render_openmetrics
            accept = self.headers.get("Accept", "") or ""
            try:
                if om is not None and "openmetrics" in accept:
                    body = (om() + "# EOF\n").encode("utf-8")
                    self._reply(body, OPENMETRICS_CONTENT_TYPE)
                    return
                body = type(self).render().encode("utf-8")
            except Exception as exc:
                self.send_error(500, f"{type(exc).__name__}: {exc}")
                return
            self._reply(body, CONTENT_TYPE)
        elif path == "/traces" and type(self).traces is not None:
            try:
                body = json.dumps(type(self).traces()).encode("utf-8")
            except Exception as exc:
                self.send_error(500, f"{type(exc).__name__}: {exc}")
                return
            self._reply(body, "application/json")
        elif path in routes:
            params = {
                k: v[-1]
                for k, v in urllib.parse.parse_qs(query).items()
            }
            try:
                body = json.dumps(routes[path](params)).encode("utf-8")
            except Exception as exc:
                self.send_error(500, f"{type(exc).__name__}: {exc}")
                return
            self._reply(body, "application/json")
        elif path == "/healthz":
            health_fn = type(self).health.get("fn")
            if health_fn is None:
                self._reply(b"ok\n", "text/plain; charset=utf-8")
                return
            try:
                verdict = health_fn()
            except Exception as exc:
                self.send_error(500, f"{type(exc).__name__}: {exc}")
                return
            body = json.dumps(verdict).encode("utf-8")
            # An unhealthy verdict must be machine-visible from the
            # status line alone (load balancers, kubelet probes).
            status = 200 if verdict.get("ok", True) else 503
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            known = ", ".join(
                ["/metrics", "/traces", "/healthz"] + sorted(routes)
            )
            self.send_error(404, f"try {known}")

    def log_message(self, fmt, *args):
        logger.debug("metrics http: " + fmt, *args)


class MetricsHTTPServer:
    """``/metrics`` + ``/healthz`` on a daemon thread.

    ``render`` is a zero-arg callable returning the exposition text
    (typically ``MetricsPlane.render``); evaluated per scrape so gauges
    with pull-time callbacks stay live.
    """

    def __init__(self, render: Callable[[], str], port: int = 0,
                 host: str = "",
                 traces: Optional[Callable[[], dict]] = None,
                 json_routes: Optional[
                     Dict[str, Callable[[dict], object]]] = None,
                 render_openmetrics: Optional[
                     Callable[[], str]] = None,
                 health: Optional[Callable[[], dict]] = None):
        self._render = render
        self._render_openmetrics = render_openmetrics
        self._traces = traces
        self._json_routes = dict(json_routes or {})
        self._health = {"fn": health}
        self._host = host
        self._requested_port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsHTTPServer":
        handler = type("_BoundHandler", (_Handler,), {
            "render": staticmethod(self._render),
            "render_openmetrics": (
                staticmethod(self._render_openmetrics)
                if self._render_openmetrics is not None else None
            ),
            "traces": (
                staticmethod(self._traces)
                if self._traces is not None else None
            ),
            "json_routes": self._json_routes,
            "health": self._health,
        })
        self._httpd = ThreadingHTTPServer(
            (self._host, self._requested_port), handler
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-http",
        )
        self._thread.start()
        logger.info("/metrics serving on port %d", self.port)
        return self

    def set_health(self, fn: Optional[Callable[[], dict]]):
        """(Re)mount the /healthz verdict callable — live on a running
        server (the holder dict is shared by reference)."""
        self._health["fn"] = fn

    @property
    def port(self) -> int:
        return self._httpd.server_address[1] if self._httpd else 0

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
