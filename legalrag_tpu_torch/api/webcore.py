"""Minimal stdlib HTTP framework, the serving substrate (port of
``legalrag_tpu/api/webcore.py``).

Route patterns with path params, JSON bodies, streaming (SSE) responses,
multipart/form-data parsing, CORS, a global exception handler (an
exception in a handler, a CUDA error included, becomes a 500), a threaded
HTTP server, and a TestClient that drives the same dispatch path
in-process. No FastAPI: the card's machine and the serving image have none.
"""

from __future__ import annotations

import json
import re
import threading
import traceback
import urllib.parse
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.webcore")


# --------------------------------------------------------------------------
@dataclass
class Request:
    method: str
    path: str
    headers: Dict[str, str]
    query: Dict[str, str]
    body: bytes = b""
    params: Dict[str, str] = field(default_factory=dict)

    def json(self) -> Any:
        if not self.body:
            return {}
        try:
            return json.loads(self.body.decode("utf-8"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise HTTPError(400, f"invalid JSON body: {e}")

    def form(self) -> Dict[str, Any]:
        """Parse multipart/form-data; file fields become
        {"filename": str, "content": bytes}."""
        ctype = self.headers.get("content-type", "")
        m = re.search(r'boundary="?([^";]+)"?', ctype)
        if not m:
            return {}
        boundary = ("--" + m.group(1)).encode()
        out: Dict[str, Any] = {}
        for part in self.body.split(boundary):
            part = part.strip(b"\r\n")
            if not part or part == b"--":
                continue
            if b"\r\n\r\n" not in part:
                continue
            head, content = part.split(b"\r\n\r\n", 1)
            head_text = head.decode("utf-8", "replace")
            name_m = re.search(r'name="([^"]+)"', head_text)
            if not name_m:
                continue
            fname_m = re.search(r'filename="([^"]*)"', head_text)
            if fname_m:
                out[name_m.group(1)] = {"filename": fname_m.group(1),
                                        "content": content}
            else:
                out[name_m.group(1)] = content.decode("utf-8", "replace")
        return out


@dataclass
class Response:
    content: Any = None
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    media_type: Optional[str] = None

    def encode(self) -> Tuple[bytes, str]:
        if isinstance(self.content, bytes):
            return self.content, self.media_type or "application/octet-stream"
        if isinstance(self.content, str):
            return self.content.encode("utf-8"), self.media_type or "text/plain; charset=utf-8"
        return (json.dumps(self.content, ensure_ascii=False).encode("utf-8"),
                self.media_type or "application/json")


@dataclass
class StreamingResponse:
    """Chunked streaming body; for SSE set the standard headers."""

    iterator: Iterable[bytes]
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    media_type: str = "text/event-stream"


def sse_event(event: str, data: Any) -> bytes:
    return (f"event: {event}\ndata: "
            f"{json.dumps(data, ensure_ascii=False)}\n\n").encode("utf-8")


class HTTPError(Exception):
    def __init__(self, status: int, detail: str):
        super().__init__(detail)
        self.status = status
        self.detail = detail


# --------------------------------------------------------------------------
class App:
    def __init__(self, cors_allow_all: bool = True):
        self.routes: List[Tuple[str, re.Pattern, List[str], Callable]] = []
        self.cors = cors_allow_all

    def route(self, method: str, pattern: str):
        names = re.findall(r"{(\w+)}", pattern)
        regex = re.compile(
            "^" + re.sub(r"{(\w+)}", r"(?P<\1>[^/]+)", pattern) + "$")

        def deco(fn: Callable) -> Callable:
            self.routes.append((method.upper(), regex, names, fn))
            return fn

        return deco

    def get(self, pattern: str):
        return self.route("GET", pattern)

    def post(self, pattern: str):
        return self.route("POST", pattern)

    # ---------------------------------------------------------------- dispatch
    def dispatch(self, req: Request):
        if req.method == "OPTIONS" and self.cors:
            return Response("", status=204, headers=self._cors_headers())
        for method, regex, _names, fn in self.routes:
            m = regex.match(req.path)
            if m and method == req.method:
                req.params = m.groupdict()
                try:
                    resp = fn(req)
                except HTTPError as e:
                    resp = Response({"detail": e.detail}, status=e.status)
                except Exception:
                    log.error("handler error on %s %s\n%s", req.method,
                              req.path, traceback.format_exc())
                    resp = Response({"detail": "internal server error"},
                                    status=500)
                if self.cors:
                    resp.headers.update(self._cors_headers())
                return resp
        allowed = [m for m, rx, _n, _f in self.routes if rx.match(req.path)]
        if allowed:
            return Response({"detail": "method not allowed"}, status=405)
        return Response({"detail": "not found"}, status=404)

    def _cors_headers(self) -> Dict[str, str]:
        return {"Access-Control-Allow-Origin": "*",
                "Access-Control-Allow-Headers": "*",
                "Access-Control-Allow-Methods": "*"}

    # ------------------------------------------------------------------ serve
    def serve(self, host: str = "0.0.0.0", port: int = 8000) -> ThreadingHTTPServer:
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            timeout = 120  # per-connection socket timeout
            MAX_BODY = 64 << 20  # uploads cap (PDFs)

            def log_message(self, fmt, *args):
                msg = fmt % args
                if "/ready" not in msg and "/health" not in msg:
                    log.info("%s %s", self.address_string(), msg)

            def _request(self) -> Request:
                parsed = urllib.parse.urlsplit(self.path)
                length = int(self.headers.get("Content-Length") or 0)
                if length > self.MAX_BODY:
                    raise ValueError("request body too large")
                body = self.rfile.read(length) if length else b""
                return Request(
                    method=self.command,
                    path=parsed.path,
                    headers={k.lower(): v for k, v in self.headers.items()},
                    query=dict(urllib.parse.parse_qsl(parsed.query)),
                    body=body)

            def _respond(self, resp) -> None:
                if isinstance(resp, StreamingResponse):
                    self.send_response(resp.status)
                    self.send_header("Content-Type", resp.media_type)
                    self.send_header("Cache-Control", "no-cache")
                    self.send_header("Connection", "keep-alive")
                    self.send_header("X-Accel-Buffering", "no")
                    self.send_header("Transfer-Encoding", "chunked")
                    for k, v in resp.headers.items():
                        self.send_header(k, v)
                    self.end_headers()
                    try:
                        for chunk in resp.iterator:
                            self.wfile.write(b"%x\r\n" % len(chunk))
                            self.wfile.write(chunk + b"\r\n")
                            self.wfile.flush()
                        self.wfile.write(b"0\r\n\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                    return
                body, ctype = resp.encode()
                self.send_response(resp.status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in resp.headers.items():
                    self.send_header(k, v)
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _handle(self) -> None:
                try:
                    try:
                        req = self._request()
                    except ValueError as e:
                        self._respond(Response({"detail": str(e)}, status=413))
                        return
                    self._respond(app.dispatch(req))
                except (BrokenPipeError, ConnectionResetError):
                    pass

            do_GET = do_POST = do_PUT = do_DELETE = do_OPTIONS = do_HEAD = _handle

        server = ThreadingHTTPServer((host, port), Handler)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        log.info("serving on http://%s:%d", host, port)
        return server


# --------------------------------------------------------------------------
class TestClient:
    """Drives App.dispatch in-process (the FastAPI-TestClient analogue)."""

    __test__ = False  # not a pytest collectable

    def __init__(self, app: App):
        self.app = app

    def request(self, method: str, path: str, json_body: Any = None,
                body: bytes = b"", headers: Optional[Dict[str, str]] = None):
        parsed = urllib.parse.urlsplit(path)
        hdrs = {k.lower(): v for k, v in (headers or {}).items()}
        if json_body is not None:
            body = json.dumps(json_body, ensure_ascii=False).encode("utf-8")
            hdrs.setdefault("content-type", "application/json")
        req = Request(method=method.upper(), path=parsed.path, headers=hdrs,
                      query=dict(urllib.parse.parse_qsl(parsed.query)),
                      body=body)
        return TestResponse(self.app.dispatch(req))

    def get(self, path: str, **kw):
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw):
        return self.request("POST", path, **kw)


class TestResponse:
    def __init__(self, resp):
        self.raw = resp
        self.status = resp.status
        if isinstance(resp, StreamingResponse):
            self.body = b"".join(resp.iterator)
        else:
            self.body, _ = resp.encode()

    def json(self) -> Any:
        return json.loads(self.body.decode("utf-8"))

    @property
    def text(self) -> str:
        return self.body.decode("utf-8")

    def sse_events(self) -> List[Tuple[str, Any]]:
        events = []
        for block in self.text.split("\n\n"):
            ev, data = None, None
            for line in block.splitlines():
                if line.startswith("event: "):
                    ev = line[7:]
                elif line.startswith("data: "):
                    data = line[6:]
            if ev is not None:
                try:
                    data = json.loads(data) if data else None
                except json.JSONDecodeError:
                    pass
                events.append((ev, data))
        return events
