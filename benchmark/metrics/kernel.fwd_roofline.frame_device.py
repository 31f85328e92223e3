"""``kernel.fwd_roofline.frame``, its arithmetic and its reader, in the
cells that report ``frame_device_ms``."""

from benchmark.harness import spec

read = spec.metric_reader("kernel.fwd_roofline.frame")
