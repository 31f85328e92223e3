"""The port's scene viewer (``tools/torch_view.py``) on the CPU: the live
HTTP viewer (as ``tests/test_viewer.py`` checks ``tools/view.py``), its four
scenes and its orbit against ``tools/view.py``'s through the JAX package,
the 8-bit quantisation on the render's device against ``write_png``'s, the
PNG encoder, the CLI, and that the tool needs neither JAX nor an image
library and does not fall back to the CPU by itself."""

import json
import math
import pathlib
import socket
import subprocess
import sys
import textwrap
import threading
import urllib.request

import numpy as np
import pytest
import torch

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu.io import png as jax_png
from sdfkit_tpu_torch.io import png
from sdfkit_tpu_torch.io.tga import read_tga

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import torch_view  # noqa: E402
import view as jax_view  # noqa: E402

SCENES = ("sphere_repeat", "sphere", "csg", "torus")
TIMEOUT = 60


@pytest.fixture
def served():
    """A 64x48 LiveViewer of a sphere on the CPU behind a server thread:
    (viewer, server, base URL, server thread)."""
    viewer = torch_view.LiveViewer(st.sphere(1.0, color=(0.8, 0.3, 0.2)), 64, 48)
    server = torch_view.serve(viewer, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield viewer, server, f"http://127.0.0.1:{server.server_address[1]}", thread
    finally:
        if not getattr(server, "_sdfkit_down", False):
            server.shutdown()
        server.server_close()


def get(url: str) -> bytes:
    return urllib.request.urlopen(url, timeout=TIMEOUT).read()


def test_live_viewer_frame_and_stats(served):
    viewer, _, base, _ = served
    data = get(f"{base}/frame.png")
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    frame = png.decode_png(data)
    assert frame.shape == (48, 64, 3) and frame.dtype == np.uint8
    assert b"/stream" in get(f"{base}/")
    stats = json.loads(get(f"{base}/stats"))
    assert stats["frame"] >= 1 and stats["render_ms"] > 0
    assert set(stats) == {"frame", "render_ms", "mrays_per_s"}
    # The first frame is the orbit's view 0, quantised as write_png does.
    with torch.no_grad():
        want = viewer.marcher.render(camera=viewer.view(0)).numpy()
    np.testing.assert_array_equal(frame, png.quantize(want))


def read_part(f) -> tuple[dict, bytes]:
    """One part of a multipart stream: (headers, body)."""
    assert f.readline() == b"--frame\r\n"
    headers = {}
    while (line := f.readline()) != b"\r\n":
        key, value = line.decode().split(":", 1)
        headers[key.strip().lower()] = value.strip()
    body = f.read(int(headers["content-length"]))
    assert f.read(2) == b"\r\n"
    return headers, body


def test_stream_serves_png_parts_and_ends_on_shutdown(served):
    _, server, base, server_thread = served
    before = set(threading.enumerate())
    sock = socket.create_connection(server.server_address, timeout=TIMEOUT)
    try:
        sock.sendall(b"GET /stream HTTP/1.1\r\nHost: localhost\r\n\r\n")
        f = sock.makefile("rb")
        status = f.readline()
        assert b"200" in status
        while (line := f.readline()) != b"\r\n":
            if line.lower().startswith(b"content-type"):
                assert b"multipart/x-mixed-replace" in line
        for _ in range(2):
            headers, body = read_part(f)
            assert headers["content-type"] == "image/png"
            assert png.decode_png(body).shape == (48, 64, 3)
        handlers = [t for t in threading.enumerate() if t not in before]
        assert handlers
        # The client keeps the connection open: only the shutdown flag ends
        # the handler's loop.
        server.shutdown()
        for t in handlers + [server_thread]:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    finally:
        sock.close()


def assert_matches_tools_view(name, rgb, jrgb, depth, jdepth):
    """The parity contract (``torch_parity``) on depth and RGB. SphereRepeat
    seen from above shows rays that end far away: its RGB is held to
    ``torch_parity.assert_rgb_close_but_far`` (ROADMAP C.15)."""
    tp.assert_depth_close(depth, jdepth)
    if name != "sphere_repeat":
        tp.assert_rgb_close(rgb, jrgb)
        return
    tp.assert_rgb_close_but_far(rgb, jrgb, depth)


@pytest.mark.parametrize("name", SCENES)
def test_scenes_match_tools_view(name):
    """tools/view.py's frame of each scene (the JAX package's render at
    (-2, 2, 4)) against the port's, and their depths."""
    scene = torch_view.scenes("cpu")[name]()
    with torch.no_grad():
        rgb = st.render(scene, 40, 24, camera_position=(-2, 2, 4)).numpy()
        view = st.look_at((-2, 2, 4), (0, 0, 0), (0, 1, 0))
        depth = st.render_depth(scene, 40, 24, view=view).numpy()
    jscene = jax_view.scenes()[name]()
    jrgb = np.asarray(sk.render(jscene, 40, 24, camera_position=(-2, 2, 4)))
    jdepth = np.asarray(sk.render_depth(jscene, 40, 24, view=sk.look_at((-2, 2, 4), (0, 0, 0),
                                                                           (0, 1, 0))))
    assert rgb.shape == (24, 40, 3)
    assert_matches_tools_view(name, rgb, jrgb, depth, jdepth)


@pytest.mark.parametrize("name", SCENES)
def test_orbit_view_matches_tools_view(name):
    """Frame 7 of the live orbit (a = 0.03 * 7) through RayMarcher.render(camera=)."""
    viewer = torch_view.LiveViewer(torch_view.scenes("cpu")[name](), 40, 24)
    with torch.no_grad():
        rgb = viewer.marcher.render(camera=viewer.view(7)).numpy()
        depth = viewer.marcher.render_depth(camera=viewer.view(7)).numpy()
    a = 0.03 * 7
    jview = sk.look_at((5.0 * math.sin(a), 2.0, 5.0 * math.cos(a)), (0, 0, 0), (0, 1, 0))
    jm = sk.RayMarcher(40, 24, jax_view.scenes()[name]())
    assert_matches_tools_view(name, rgb, np.asarray(jm.render(camera=jview)), depth,
                              np.asarray(jm.render_depth(camera=jview)))


def boundary_floats(seed: int) -> np.ndarray:
    """Seeded floats around [0, 1], each k/255 and each rounding boundary
    (k - 0.5)/255 with its neighbours one ulp away, and values outside."""
    rng = np.random.default_rng(seed)
    k = np.arange(256, dtype=np.float32)
    marks = np.concatenate([k / np.float32(255), (k - np.float32(0.5)) / np.float32(255)])
    near = np.concatenate([marks, np.nextafter(marks, np.float32(-np.inf)),
                           np.nextafter(marks, np.float32(np.inf))])
    return np.concatenate([
        rng.uniform(-0.25, 1.25, 30_000).astype(np.float32), near,
        np.array([-1.0, -0.0, 0.0, 1.0, 2.0, 255.0, -np.inf, np.inf, 1e30, -1e30],
                 np.float32)])


def test_device_quantisation_equals_write_pngs():
    x = boundary_floats(0)
    img = x[: (x.size // 3) * 3].reshape(1, -1, 3)
    got = png.quantize_tensor(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, png.quantize(img))
    # write_png's formula as it was written there, in numpy.
    np.testing.assert_array_equal(got, (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))


def test_encode_png_is_write_pngs_file(tmp_path):
    rng = np.random.default_rng(1)
    rgb = rng.uniform(-0.1, 1.1, (7, 5, 3)).astype(np.float32)
    gray = rng.uniform(0.0, 1.0, (4, 9)).astype(np.float32)
    for i, img in enumerate((rgb, gray)):
        ours, theirs = tmp_path / f"ours{i}.png", tmp_path / f"theirs{i}.png"
        png.write_png(ours, img)
        jax_png.write_png(theirs, img)  # the writer as it was before encode_png
        assert png.encode_png(img) == ours.read_bytes() == theirs.read_bytes()
        assert png.encode_png(png.quantize(img)) == ours.read_bytes()
        np.testing.assert_array_equal(png.decode_png(ours.read_bytes()), png.quantize(img))
        np.testing.assert_array_equal(png.read_png(ours), png.quantize(img) / np.float32(255))
    fast = png.encode_png(rgb, level=1)
    np.testing.assert_array_equal(png.decode_png(fast), png.quantize(rgb))


def test_cli_writes_an_orbit_of_pngs(tmp_path):
    out = tmp_path / "orbit.png"
    assert torch_view.main(["--orbit", "2", "--size", "16x8", "--device", "cpu",
                            "--out", str(out)]) == 0
    frames = sorted(p.name for p in tmp_path.iterdir())
    assert frames == ["orbit-000.png", "orbit-001.png"]
    scene = torch_view.scenes("cpu")["sphere_repeat"]()
    for i, name in enumerate(frames):
        with torch.no_grad():
            want = st.RayMarcher(16, 8, scene).render(
                camera=torch_view.orbit_view(5.0, 2.0 * math.pi * i / 2, "cpu")).numpy()
        np.testing.assert_array_equal(png.decode_png((tmp_path / name).read_bytes()),
                                      png.quantize(want))


def test_cli_writes_a_tga_that_reads_back(tmp_path):
    out = tmp_path / "frame.tga"
    assert torch_view.main(["--scene", "torus", "--size", "16x8", "--device", "cpu",
                            "--out", str(out)]) == 0
    with torch.no_grad():
        want = st.render(torch_view.scenes("cpu")["torus"](), 16, 8,
                         camera_position=(-2, 2, 4)).numpy()
    back = read_tga(out)
    assert back.shape == (8, 16, 3)
    np.testing.assert_array_equal(np.round(back * 255).astype(np.uint8), png.quantize(want))


NO_JAX_NO_PIL = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
    sys.modules["PIL"] = None
    sys.path.insert(0, {tools!r})
    import torch_scaling
    import torch_view
    viewer = torch_view.LiveViewer(torch_view.scenes("cpu")["csg"](), 8, 4)
    assert viewer.render_frame()[:8] == b"\\x89PNG\\r\\n\\x1a\\n"
    bad = [m for m, mod in sys.modules.items() if mod is not None
           and (m in ("sdfkit_tpu", "bench", "PIL") or m.startswith(("sdfkit_tpu.", "PIL.")))]
    assert not bad, bad
    print("ok")
""")


def test_tools_import_neither_jax_nor_pil():
    code = NO_JAX_NO_PIL.format(tools=str(REPO / "tools"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_tools_without_a_card_raise(monkeypatch, tmp_path):
    """No --device cpu and no card: the package's default device raises,
    whatever default this process set."""
    import torch_scaling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        torch_view.main(["--size", "4x2", "--out", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="card"):
        torch_scaling.main(["--devices", "1", "--width", "4", "--height", "2"])
    assert list(tmp_path.iterdir()) == []
