"""The observability plane (torch counterpart of presto_tpu/obs/): span
trees, the metrics registry and the kernel profile.

`Trace`/`TRACES` keep per-query span trees that survive retries and
merge across the fleet, `METRICS` is the process-wide registry rendered
as Prometheus text, and `KERNEL_PROFILE` splits kernel-library builds
("compile") from hand-kernel launches timed by CUDA events ("execute").
"""

from .kernelprof import KERNEL_PROFILE, KernelProfile
from .metrics import METRICS, MetricsRegistry
from .span import (
    TRACES,
    Span,
    Trace,
    TraceStore,
    render_critical_path,
)

__all__ = [
    "KERNEL_PROFILE",
    "KernelProfile",
    "METRICS",
    "MetricsRegistry",
    "TRACES",
    "Span",
    "Trace",
    "TraceStore",
    "render_critical_path",
]
