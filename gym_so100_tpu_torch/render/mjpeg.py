"""Reusable MJPEG-over-HTTP streaming server (stdlib only).

The port's copy of `gym_so100_tpu/render/mjpeg.py` (host Python, unchanged
in behaviour).  On a headless host the visual channel is a browser: a tiny
ThreadingHTTPServer streams frames pushed via `publish()` as
multipart/x-mixed-replace JPEG, and forwards browser keydowns to an
optional `key_handler`.  Used by `scripts/viewer.py` (interactive viewer)
and `scripts/record_teleop.py --watch` (live demo-recording feedback).
PIL is imported only when a frame is encoded.
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!doctype html>
<html><head><title>%(title)s</title><style>
body { background:#111; color:#ddd; font-family: monospace; text-align:center }
img { image-rendering: pixelated; width: 640px; border: 1px solid #444 }
</style></head><body>
<h3>%(title)s</h3>
<img src="/stream">
<p id="st">%(help)s</p>
<script>
document.addEventListener('keydown', (e) => {
  fetch('/key', {method: 'POST', body: JSON.stringify({key: e.key})});
});
</script></body></html>"""


class MjpegServer:
    """Serves `/` (page), `/stream` (MJPEG), `/key` (POST keydown).

    publish(frame): push an (H, W, 3) uint8 array to all stream clients.
    key_handler: optional callable(str) invoked for each browser keydown.
    """

    def __init__(self, port=8000, fps=15.0, title="gym_so100_tpu",
                 help_text="", key_handler=None):
        self.fps = fps
        self._lock = threading.Lock()
        self._frame = None
        self._key_handler = key_handler
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/":
                    body = (_PAGE % dict(title=title, help=help_text)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    try:
                        while True:
                            jpg = outer._jpeg()
                            if jpg is not None:
                                self.wfile.write(b"--frame\r\n")
                                self.send_header("Content-Type", "image/jpeg")
                                self.send_header(
                                    "Content-Length", str(len(jpg))
                                )
                                self.end_headers()
                                self.wfile.write(jpg)
                                self.wfile.write(b"\r\n")
                            time.sleep(1.0 / outer.fps)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path == "/key":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        key = json.loads(self.rfile.read(n))["key"]
                        if outer._key_handler is not None:
                            outer._key_handler(key)
                    except Exception:
                        pass
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        self._srv = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._srv.server_address[1]   # resolved (0 -> ephemeral)
        self._thread = None

    def _jpeg(self):
        with self._lock:
            frame = self._frame
        if frame is None:
            return None
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, "JPEG", quality=85)
        return buf.getvalue()

    def publish(self, frame):
        with self._lock:
            self._frame = frame

    def start(self):
        self._thread = threading.Thread(
            target=self._srv.serve_forever, daemon=True
        )
        self._thread.start()
        return self

    def stop(self):
        self._srv.shutdown()
        self._srv.server_close()

    def serve_forever(self):
        self._srv.serve_forever()
