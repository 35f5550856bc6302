"""REST backend (C20): the port's copy of ``vct/serve/backend.py``, on the
port's ``ServeConfig``, store and queue. ``python -m vct_torch.serve.backend``
runs it.

The reference's Flask app (``backend.py:36-118``) on the stdlib threading
HTTP server (Flask is not a dependency):

    POST /classify          {url, labels, scores?, timestamp?} -> store insert
    GET  /video_labels?url= lookup -> {url, labels} | {"error": ...} 404
    GET  /get_labels?url=   lookup-or-enqueue: on miss, PUSH the url to the
                            worker queue and poll the store until the result
                            lands (the reference busy-polls Mongo 30000 times,
                            backend.py:100-112 — here the poll sleeps and has
                            a wall-clock timeout instead of a spin).
"""

from __future__ import annotations

import json
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from vct_torch.core.config import ServeConfig
from vct_torch.serve.queue import QueuePush
from vct_torch.serve.store import ResultStore

__all__ = ["make_server", "run_backend"]


def make_handler(store: ResultStore, push: Optional[QueuePush], poll_timeout: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            parsed = urlparse(self.path)
            if parsed.path != "/classify":
                return self._json(404, {"error": "not found"})
            length = int(self.headers.get("Content-Length", 0))
            try:
                doc = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError:
                return self._json(400, {"error": "invalid JSON"})
            url, labels = doc.get("url"), doc.get("labels")
            if not url or labels is None:
                # backend.py:40-47 validates url+labels presence
                return self._json(400, {"error": "url and labels are required"})
            store.insert(url, labels, doc.get("scores"), doc.get("timestamp", ""))
            return self._json(200, {"message": "Classification result saved"})

        def do_GET(self):
            parsed = urlparse(self.path)
            query = parse_qs(parsed.query)
            url = (query.get("url") or [None])[0]
            if parsed.path == "/video_labels":
                if not url:
                    return self._json(400, {"error": "url parameter is required"})
                doc = store.find_one(url)
                if doc is None:
                    return self._json(404, {"error": "URL not classified yet"})
                return self._json(200, {"url": doc["url"], "labels": doc["labels"]})
            if parsed.path == "/get_labels":
                if not url:
                    return self._json(400, {"error": "url parameter is required"})
                doc = store.find_one(url)
                if doc is None and push is not None:
                    try:
                        push.send(url)
                    except OSError as e:
                        return self._json(503, {"error": f"queue unavailable: {e}"})
                    deadline = time.time() + poll_timeout
                    while doc is None and time.time() < deadline:
                        time.sleep(0.1)
                        doc = store.find_one(url)
                if doc is None:
                    return self._json(
                        404, {"error": "classification timed out or unavailable"}
                    )
                return self._json(200, {"url": doc["url"], "labels": doc["labels"]})
            return self._json(404, {"error": "not found"})

    return Handler


def make_server(
    cfg: ServeConfig,
    store: Optional[ResultStore] = None,
    with_queue: bool = True,
    poll_timeout: float = 120.0,
) -> ThreadingHTTPServer:
    store = store or ResultStore(cfg.db_path)
    push = QueuePush(port=cfg.queue_port) if with_queue else None
    handler = make_handler(store, push, poll_timeout)
    return ThreadingHTTPServer((cfg.backend_host, cfg.backend_port), handler)


def run_backend(cfg: Optional[ServeConfig] = None) -> None:
    cfg = cfg or ServeConfig()
    server = make_server(cfg)
    print(f"backend listening on {cfg.backend_host}:{cfg.backend_port}")
    server.serve_forever()


if __name__ == "__main__":
    run_backend()
