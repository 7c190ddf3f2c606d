"""Dashboard: HTTP observability + REST job API on the head.

The lightweight analog of the reference dashboard head
(Ray's python/ray/dashboard/head.py, aiohttp) and its job REST
module (dashboard/modules/job/): JSON state endpoints, a Prometheus
text exposition endpoint (the metrics-agent scrape surface,
_private/metrics_agent.py), and job submit/list/logs over HTTP.

Port of ``ray_tpu/cluster/dashboard.py``. The reference serves from
aiohttp; the port serves the same 14 routes, status codes and bodies
from the standard library's ``http.server.ThreadingHTTPServer`` on a
daemon thread, so the head needs no package beyond its own. Each request
runs on its own server thread, which is where the blocking head calls
(the node-debug agent RPC, ``metrics_text``) run: the reference moves
them off its event loop into an executor for the same reason.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional, Tuple

_NOT_FOUND = (404, "text/plain", b"404: Not Found")
_NOT_ALLOWED = (405, "text/plain", b"405: Method Not Allowed")
_SERVER_ERROR = (
    500,
    "text/plain",
    b"500 Internal Server Error\n\nServer got itself in trouble",
)


class Dashboard:
    def __init__(self, head, host: str = "127.0.0.1", port: int = 0):
        self.head = head
        self.host = host
        self._port = port
        self.port: Optional[int] = None
        self._server: Optional[ThreadingHTTPServer] = None
        self._started = threading.Event()
        self.error: Optional[BaseException] = None
        self._routes = self._route_table()
        self._thread = threading.Thread(
            target=self._serve, name="dashboard", daemon=True
        )
        self._thread.start()
        self._started.wait(timeout=10)
        if self.error is not None:
            raise RuntimeError(
                f"dashboard failed to start on {host}:{port}"
            ) from self.error
        if self.port is None:
            raise RuntimeError("dashboard did not start within 10s")

    # ------------------------------------------------------------------
    def _route_table(self) -> List[Tuple[str, "re.Pattern", Callable]]:
        table = [
            ("GET", "/", self._index),
            ("GET", "/ui", self._ui),
            ("GET", "/api/cluster_status", self._cluster_status),
            ("GET", "/api/nodes", self._nodes),
            ("GET", "/api/nodes/{node_id}/debug", self._node_debug),
            ("GET", "/api/rpc_stats", self._rpc_stats),
            ("GET", "/api/actors", self._actors),
            ("GET", "/api/objects", self._objects),
            ("GET", "/api/placement_groups", self._pgs),
            ("GET", "/api/jobs", self._jobs),
            ("POST", "/api/jobs", self._submit_job),
            ("GET", "/api/jobs/{job_id}", self._job_status),
            ("GET", "/api/jobs/{job_id}/logs", self._job_logs),
            ("GET", "/metrics", self._metrics),
        ]
        out = []
        for method, path, handler in table:
            pattern = re.sub(r"\{(\w+)\}", r"(?P<\1>[^{}/]+)", path)
            out.append((method, re.compile(f"^{pattern}$"), handler))
        return out

    def _dispatch(self, method: str, path: str, body: bytes) -> tuple:
        """``(status, content_type, body_bytes)`` for one request: the
        route table's handler, 405 for a known path under another method,
        404 for an unknown path, 500 when a handler raises."""
        path = path.split("?", 1)[0]
        # a GET route answers HEAD too, as aiohttp's web.get does
        want = "GET" if method == "HEAD" else method
        known_path = False
        for route_method, pattern, handler in self._routes:
            m = pattern.match(path)
            if m is None:
                continue
            known_path = True
            if route_method != want:
                continue
            try:
                return handler(m.groupdict(), body)
            except Exception:  # noqa: BLE001 - reported as a 500
                return _SERVER_ERROR
        return _NOT_ALLOWED if known_path else _NOT_FOUND

    def _serve(self) -> None:
        dashboard = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def _respond(self, method: str) -> None:
                n = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(n) if n > 0 else b""
                status, ctype, data = dashboard._dispatch(method, self.path, body)
                self.send_response(status)
                self.send_header("Content-Type", f"{ctype}; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                if method != "HEAD":
                    self.wfile.write(data)

            def do_GET(self) -> None:  # noqa: N802 - http.server's name
                self._respond("GET")

            def do_HEAD(self) -> None:  # noqa: N802
                self._respond("HEAD")

            def do_POST(self) -> None:  # noqa: N802
                self._respond("POST")

            def log_message(self, fmt, *args) -> None:
                pass  # no per-request line on stderr (aiohttp logs none here)

        try:
            server = ThreadingHTTPServer((self.host, self._port), _Handler)
            server.daemon_threads = True
            self._server = server
            self.port = server.server_address[1]
        except Exception as exc:  # noqa: BLE001 - surfaced to the constructor
            self.error = exc
            self._started.set()
            return
        self._started.set()
        try:
            server.serve_forever(poll_interval=0.2)
        finally:
            server.server_close()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------
    @staticmethod
    def _json(data) -> tuple:
        return (
            200,
            "application/json",
            json.dumps(data, default=str).encode(),
        )

    def _ui(self, match, body) -> tuple:
        """Self-contained live dashboard page (dashboard/client analog —
        one HTML file polling the JSON APIs; no external assets)."""
        from .dashboard_ui import UI_HTML

        return 200, "text/html", UI_HTML.encode()

    def _index(self, match, body) -> tuple:
        info = self.head._h_query_state({"kind": "summary"})
        html = (
            "<html><head><title>ray_tpu dashboard</title></head><body>"
            "<h1>ray_tpu cluster</h1>"
            f"<pre>{json.dumps(info, indent=2, default=str)}</pre>"
            "<p>endpoints: /api/cluster_status /api/nodes "
            "/api/nodes/&lt;id&gt;/debug /api/rpc_stats /api/actors "
            "/api/objects /api/placement_groups /api/jobs /metrics</p>"
            "</body></html>"
        )
        return 200, "text/html", html.encode()

    def _cluster_status(self, match, body) -> tuple:
        info = self.head._h_cluster_info(None)
        info["head_address"] = self.head.address
        info["leases"] = self.head._h_query_state({"kind": "leases"})
        return self._json(info)

    def _node_debug(self, match, body) -> tuple:
        """Proxy one agent's DebugState (node_manager DebugString analog):
        ledger availability, store stats, OOM kills, in-flight queues,
        per-RPC-handler timings."""
        node_id = match["node_id"]
        client = self.head._clients.get(node_id)
        if client is None:
            return self._json({"error": f"unknown node {node_id}"})
        try:
            return self._json(client.call("DebugState", timeout=10.0))
        except Exception as exc:  # noqa: BLE001
            return self._json({"error": repr(exc)})

    def _rpc_stats(self, match, body) -> tuple:
        """The head's own per-handler timings (instrumented_io_context
        stats analog)."""
        from .rpc import HANDLER_STATS

        return self._json(HANDLER_STATS.snapshot())

    def _nodes(self, match, body) -> tuple:
        return self._json(self.head._h_cluster_info(None)["nodes"])

    def _actors(self, match, body) -> tuple:
        return self._json(self.head._h_query_state({"kind": "actors"}))

    def _objects(self, match, body) -> tuple:
        return self._json(self.head._h_query_state({"kind": "objects"}))

    def _pgs(self, match, body) -> tuple:
        return self._json(self.head._h_query_state({"kind": "placement_groups"}))

    def _jobs(self, match, body) -> tuple:
        return self._json(self.head.jobs.list())

    def _submit_job(self, match, body) -> tuple:
        req = json.loads(body)
        job_id = self.head.jobs.submit(
            entrypoint=req["entrypoint"],
            runtime_env=req.get("runtime_env"),
            submission_id=req.get("submission_id"),
            metadata=req.get("metadata"),
        )
        return self._json({"job_id": job_id})

    def _job_status(self, match, body) -> tuple:
        try:
            return self._json(self.head.jobs.status(match["job_id"]))
        except ValueError:
            return _NOT_FOUND

    def _job_logs(self, match, body) -> tuple:
        try:
            logs = self.head.jobs.logs(match["job_id"])
        except ValueError:
            return _NOT_FOUND
        return 200, "text/plain", logs.encode()

    def _metrics(self, match, body) -> tuple:
        """Prometheus text exposition: the head's federated registry —
        typed HELP/TYPE, histograms with buckets, every sample labeled
        node/role, agents' and workers' shipped deltas included.
        Rendering does one cluster-info pass plus a registry walk, on
        this request's own server thread."""
        return 200, "text/plain", self.head.metrics_text().encode()
