"""Scene viewer CLI for the PyTorch/CUDA port, the counterpart of
``tools/view.py`` (the reference's Perf.WindowsForms viewer, headless):
renders a scene to PNG (or TGA), optionally as an orbit turntable sequence,
or serves a live orbiting view to a browser.

Usage:
    python tools/torch_view.py [--scene sphere_repeat] [--size 960x540]
                               [--out view.png] [--orbit N] [--serve PORT]
                               [--device cuda|cpu]

It renders on the card unless ``--device cpu`` asks for the CPU; with no
card it raises. A frame is ``RayMarcher.render``, the image forward kernel
on the card. Frames are quantised to 8 bits on the render's device and
encoded as PNG by ``sdfkit_tpu_torch.io.png`` (no image library): the live
stream is ``multipart/x-mixed-replace`` of PNG parts, which browsers play as
they play MJPEG.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import sdfkit_tpu_torch as st  # noqa: E402
from sdfkit_tpu_torch import scenes as named_scenes  # noqa: E402
from sdfkit_tpu_torch.io.png import encode_png, quantize_tensor, write_png  # noqa: E402
from sdfkit_tpu_torch.io.tga import write_tga  # noqa: E402


def scenes(device=None):
    """Scene name -> constructor of the scene on ``device`` (the package's
    default device, the card, when None); ``tools/view.py``'s four."""
    return {
        "sphere_repeat": lambda: named_scenes.sphere_repeat_scene(device),
        "sphere": lambda: st.sphere(1.0, color=(0.9, 0.4, 0.2), device=device),
        "csg": lambda: st.sphere(1.0, color=(0.9, 0.3, 0.2), device=device).smooth_union(
            st.box(0.8, color=(0.2, 0.5, 0.9), device=device).translate(1.0, 0, 0), 0.3
        ),
        "torus": lambda: st.torus(1.0, 0.35, color=(0.4, 0.8, 0.5), device=device).rotate_x(0.7),
    }


def save(path, img: torch.Tensor) -> None:
    """An (H, W, 3) float frame in [0, 1] as TGA (``.tga``) or PNG."""
    if path.endswith(".tga"):
        write_tga(path, img.detach().cpu().numpy())
        return
    write_png(path, quantize_tensor(img).cpu().numpy())


def orbit_view(distance: float, angle: float, device) -> torch.Tensor:
    """The view from ``(d sin a, 2, d cos a)`` at the origin, +Y up."""
    return st.look_at((distance * math.sin(angle), 2.0, distance * math.cos(angle)),
                      (0, 0, 0), (0, 1, 0), device=device)


class LiveViewer:
    """Live in-browser viewer, the analogue of the reference's windowed
    Perf.WindowsForms viewer (MainForm.cs:17-84: background-task render,
    blit to the window, elapsed seconds in the title). Here the window is a
    browser tab: a stream of PNG frames of a continuous camera orbit at
    ``/stream``, a single ``/frame.png``, and ``/stats`` (last render ms and
    effective Mrays/s, the title-text analogue, polled by the index page)."""

    # Streams are paced so a backgrounded tab doesn't keep the device
    # rendering at full rate; N viewers share one render loop via the lock.
    MAX_STREAM_FPS = 10.0
    # zlib's fastest level: the encode, on the host, sets the stream's pace
    # (83-86 ms a 1080p frame on the H100's host; level 6, write_png's,
    # 152-162 ms: PERF.md).
    PNG_LEVEL = 1

    def __init__(self, scene, width: int, height: int, distance: float = 5.0):
        import threading

        self.width, self.height, self.distance = width, height, distance
        self.marcher = st.RayMarcher(width, height, scene)
        self.frame_index = 0
        self.last_render_ms = 0.0
        # ThreadingHTTPServer handles each connection on its own thread;
        # the lock serializes device renders and the stats they update.
        self._lock = threading.Lock()

    def view(self, frame_index: int) -> torch.Tensor:
        """The orbit's view of frame ``frame_index``, on the marcher's device."""
        return orbit_view(self.distance, 0.03 * frame_index, self.marcher.device)

    def render_frame(self) -> bytes:
        """Next orbit frame as PNG bytes; updates the stats."""
        import time

        with self._lock:
            view = self.view(self.frame_index)
            self.frame_index += 1
            # The clock spans the render and the copy of the quantised frame,
            # which waits for the device: the device's work is inside it.
            t0 = time.perf_counter()
            with torch.no_grad():
                rgb = quantize_tensor(self.marcher.render(camera=view)).cpu().numpy()
            self.last_render_ms = (time.perf_counter() - t0) * 1e3
        return encode_png(rgb, self.PNG_LEVEL)

    def stats(self) -> dict:
        ms = self.last_render_ms
        return {
            "frame": self.frame_index,
            "render_ms": round(ms, 2),
            "mrays_per_s": round(
                self.width * self.height / max(ms, 1e-9) / 1e3, 1
            ),
        }


_INDEX_HTML = """<!doctype html><title>sdfkit_tpu_torch viewer</title>
<body style="margin:0;background:#111;color:#ddd;font:14px monospace">
<div id=t style="padding:6px">sdfkit_tpu_torch</div>
<img src="/stream" style="max-width:100%">
<script>
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('t').textContent =
    `sdfkit_tpu_torch - frame ${s.frame} - ${s.render_ms} ms (${s.mrays_per_s} Mrays/s)`;
  document.title = `${s.render_ms} ms`;
}, 500);
</script>"""


def serve(viewer: LiveViewer, port: int = 0):
    """Start the HTTP viewer; returns the (bound) server. Call
    ``serve_forever`` on it (the CLI does) or drive it from a thread."""
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, content_type: str, body: bytes) -> None:
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send("text/html", _INDEX_HTML.encode())
            elif self.path.startswith("/frame"):
                self._send("image/png", viewer.render_frame())
            elif self.path.startswith("/stats"):
                self._send("application/json", json.dumps(viewer.stats()).encode())
            elif self.path.startswith("/stream"):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=frame",
                )
                self.end_headers()
                try:
                    import socket as _socket
                    import time as _time

                    # A client that stalls without closing must not pin
                    # this thread rendering device frames forever: time out
                    # the socket writes, and honor the server's shutdown
                    # flag (ThreadingHTTPServer's shutdown() does not
                    # interrupt in-flight handlers).
                    self.connection.settimeout(10.0)
                    period = 1.0 / viewer.MAX_STREAM_FPS
                    while not getattr(self.server, "_sdfkit_down", False):
                        t0 = _time.perf_counter()
                        png = viewer.render_frame()
                        self.wfile.write(
                            b"--frame\r\nContent-Type: image/png\r\n"
                            + f"Content-Length: {len(png)}\r\n\r\n".encode()
                        )
                        self.wfile.write(png)
                        self.wfile.write(b"\r\n")
                        sleep = period - (_time.perf_counter() - t0)
                        if sleep > 0:
                            _time.sleep(sleep)
                except (BrokenPipeError, ConnectionResetError,
                        _socket.timeout, TimeoutError):
                    pass  # tab closed or stalled
            else:
                self.send_error(404)

    class _Server(ThreadingHTTPServer):
        def shutdown(self):
            # Signal in-flight /stream handler loops (base shutdown() only
            # stops accepting new connections).
            self._sdfkit_down = True
            super().shutdown()

    return _Server(("127.0.0.1", port), Handler)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="sphere_repeat", choices=sorted(scenes("cpu")))
    ap.add_argument("--size", default="960x540")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "sdfkit_view.png"))
    ap.add_argument("--orbit", type=int, default=0, metavar="N",
                    help="render N frames orbiting the origin (out gets -000 suffixes)")
    ap.add_argument("--distance", type=float, default=5.0)
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve a live orbiting PNG stream at "
                         "http://127.0.0.1:PORT/ instead of writing files")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to render: the card (raises without one) or the CPU")
    args = ap.parse_args(argv)

    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        with st.use_device(None):  # the card, whatever default an embedding process set
            device = st.default_device()
    w, h = (int(v) for v in args.size.split("x"))
    scene = scenes(device)[args.scene]()

    if args.serve is not None:
        viewer = LiveViewer(scene, w, h, distance=args.distance)
        server = serve(viewer, args.serve)
        print(f"live view: http://127.0.0.1:{server.server_address[1]}/")
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    with torch.no_grad():
        if args.orbit <= 0:
            save(args.out, st.render(scene, w, h, camera_position=(-2, 2, 4)))
            print(args.out)
            return 0

        root, ext = os.path.splitext(args.out)
        marcher = st.RayMarcher(w, h, scene)
        for i in range(args.orbit):
            frame = marcher.render(camera=orbit_view(args.distance, 2.0 * math.pi * i / args.orbit,
                                                     device))
            path = f"{root}-{i:03d}{ext}"
            save(path, frame)
            print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
