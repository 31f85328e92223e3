"""``fit.optimizer_host_ms.fit``, its arithmetic and its reader, in the cells that report
``step_ms.small``."""

from benchmark.harness import spec

read = spec.metric_reader("fit.optimizer_host_ms.fit")
