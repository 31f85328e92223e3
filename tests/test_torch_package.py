"""The port as a package: no JAX, no nvcc at import, and the backend choice
on a machine without CUDA."""

import subprocess
import sys
import textwrap

import pytest
import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig

# The tensors here are small: torch's intra-op thread pool costs more than it
# saves, and on a loaded CPU its hand-offs made single ops take ~15 ms.
torch.set_num_threads(1)

NO_JAX = textwrap.dedent("""
    import subprocess, sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
    def refuse(*a, **k):
        raise AssertionError(f"a process was started while importing: {a!r}")
    subprocess.run = subprocess.Popen = refuse
    import torch
    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import build, raymarch_kernel
    from sdfkit_tpu_torch.io import png
    with torch.no_grad():
        img = st.render(scenes.sphere_repeat_scene(), 16, 8, camera_position=(-2, 2, 4))
        depth = st.render_depth(st.sphere(1.0), 16, 8)
    assert img.shape == (8, 16, 3) and bool(torch.isfinite(img).all())
    assert depth.shape == (8, 16)
    assert build.BUILDS == 0 and raymarch_kernel.LAUNCHES == 0
    assert not any(m == "sdfkit_tpu" or m.startswith("sdfkit_tpu.") for m in sys.modules)
    print("ok")
""")


def test_imports_and_renders_without_jax_or_nvcc():
    proc = subprocess.run([sys.executable, "-c", NO_JAX], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_auto_picks_the_plain_path_on_the_cpu():
    m = st.RayMarcher(8, 4, st.sphere(1.0))
    assert m.backend == "torch" and m.device.type == "cpu"


def test_kernel_backend_raises_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        st.RayMarcher(8, 4, st.sphere(1.0), backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        st.RayMarcher(8, 4, st.sphere(1.0), backend="fused")


def test_kernel_wrapper_rejects_cpu_tensors_without_building():
    builds, launches = build.BUILDS, rk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        rk.render_image_kernel(st.sphere(1.0), st.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0)),
                               RenderConfig(8, 4))
    assert (build.BUILDS, rk.LAUNCHES) == (builds, launches)


def test_kernel_backward_is_not_a_silent_fallback():
    with pytest.raises(NotImplementedError, match="_pallas_render_image_bwd"):
        rk._RenderImage.backward(None, torch.zeros(1))


def test_view_on_another_device_or_shape_raises():
    with pytest.raises(ValueError, match="4, 4"):
        st.RayMarcher(8, 4, st.sphere(1.0), view=torch.eye(3))
    meta = torch.eye(4, device="meta")
    with pytest.raises(ValueError, match="device|is on"):
        st.RayMarcher(8, 4, st.sphere(1.0), view=meta)
