"""Minimal HTTP serving front end, standard library only (counterpart of
``aread_tpu/serve/server.py``).

POST /predict   {"x": [[...int feature ids...], ...]} -> {"prob": [...]}
GET  /healthz   -> {"status": "ok"}

Rows use the canonical encoded layout (the one-hot columns, then the
flattened padded history-sequence ids: ``data.loader.tensorize``). The
Predictor pads a request to its bucket, so any request size runs one of a
few fixed shapes.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def make_server(predictor, host: str = "127.0.0.1", port: int = 0
                ) -> ThreadingHTTPServer:
    """Build (not start) a ThreadingHTTPServer bound to host:port (port 0
    picks a free port; see ``.server_address``)."""
    lock = threading.Lock()  # one request on the device at a time

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._json(200, {"status": "ok"})
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/predict":
                return self._json(404, {"error": "not found"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                x = np.asarray(req["x"], dtype=np.int64)
                if x.ndim != 2:
                    raise ValueError(f"x must be 2-D, got shape {x.shape}")
                with lock:
                    prob = predictor.predict(x)
                return self._json(200, {"prob": [float(p) for p in prob]})
            except Exception as e:  # noqa: BLE001 — surface to the client
                return self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return ThreadingHTTPServer((host, port), Handler)


def serve_forever(predictor, host: str = "0.0.0.0", port: int = 8000):
    srv = make_server(predictor, host, port)
    print(f"serving on http://{srv.server_address[0]}:{srv.server_address[1]}"
          f"  (POST /predict, GET /healthz)")
    srv.serve_forever()
