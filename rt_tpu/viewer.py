"""Live progressive preview.

Reference analog: the winit + pixels preview window (window.rs:33-217) —
a 30 FPS framebuffer fed by the render thread, with click-to-inspect.

An accelerator host has no desktop; the rt_tpu equivalent is an HTTP viewer: the
progressive engine pushes each sweep's image into this server, and any
browser shows the latest frame (auto-refreshing) with click-to-probe wired
to the same debug probe as the reference's mouse handler
(window.rs:141-172 -> rt_tpu/debug.py).  Gamma correction is applied for
display — fixing the reference's known ungamma'd-preview TODO
(window.rs:32, 196-202) — while accumulation stays linear.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!doctype html>
<html><head><title>rt_tpu preview</title><style>
body { background: #111; color: #ddd; font-family: monospace; }
img { image-rendering: pixelated; max-width: 95vw; }
#info { white-space: pre; }
</style></head><body>
<div id="status">waiting for first sweep...</div>
<img id="frame" src="/frame.png">
<div id="info"></div>
<script>
const img = document.getElementById('frame');
setInterval(() => { img.src = '/frame.png?' + Date.now(); fetch('/status')
  .then(r => r.json()).then(s => {
    document.getElementById('status').textContent = JSON.stringify(s);
  }); }, 1000);
img.addEventListener('click', (e) => {
  const r = img.getBoundingClientRect();
  const x = Math.floor((e.clientX - r.left) / r.width * img.naturalWidth);
  const y = Math.floor((e.clientY - r.top) / r.height * img.naturalHeight);
  fetch(`/probe?x=${x}&y=${y}`).then(r => r.json()).then(d => {
    document.getElementById('info').textContent = JSON.stringify(d, null, 2);
  });
});
</script></body></html>"""


class PreviewServer:
    """Serves the latest progressive frame; optionally wires a probe
    callback (scene click-debug parity)."""

    def __init__(self, port: int = 8000, probe=None):
        self._png: bytes | None = None
        self._status: dict = {}
        self._probe = probe
        self._lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with server._lock:
                        payload = server._png
                    if payload is None:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.end_headers()
                    self.wfile.write(payload)
                elif self.path.startswith("/status"):
                    with server._lock:
                        body = json.dumps(server._status).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path.startswith("/probe") and server._probe is not None:
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    x = float(q.get("x", [0])[0])
                    y = float(q.get("y", [0])[0])
                    info = server._probe(x, y) or {"miss": "hit the skybox"}
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(json.dumps(info).encode())
                else:
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(_PAGE.encode())

        self._httpd = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self.port = self._httpd.server_address[1]

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()

    def update(self, image_linear: np.ndarray, status: dict | None = None):
        """Push a new frame (linear f32[H,W,3]); encoded gamma-corrected."""
        from rt_tpu import color as color_mod
        from rt_tpu.io.png_io import encode_png

        rgb = np.asarray(color_mod.to_u8_gamma(np.asarray(image_linear, np.float32)))
        png = encode_png(rgb)
        with self._lock:
            self._png = png
            if status is not None:
                self._status = status
