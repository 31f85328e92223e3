"""Host milliseconds a frame spends inside ``RayMarcher.render(camera=)``,
from its call to its return, before the synchronise: the wrappers' work
(the view's preparation, the scene's flat parameters, the launch), taken
by the benchmark's clock around the call, averaged over the traced
window's frames."""


def read(ctx):
    if ctx["loop"] != "frames" or not ctx["count"]:
        return None
    return ctx["host_render_s"] / ctx["count"] * 1e3
