"""Profiling: named trace scopes + device trace capture.

The reference's observability is the hierarchical named timer tree
(`sdp_Timers`, utility/sdp_timer.h:20-148, wall-clock or CUDA-event
backends) — mirrored by :mod:`.timers`. Here the equivalent of the
CUDA-event backend is the JAX profiler: `trace()` captures a device
trace viewable in XProf/TensorBoard, and `annotate()` labels named
regions inside it (the SDP_TMR_PUSH/POP analogue on the device
timeline).
"""

import contextlib
import os
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Capture a device trace for the enclosed block.

    Yields the directory the trace is written to (default
    ``$SKA_SDP_FUNC_JAX_TRACE_DIR`` or /tmp/ska_sdp_func_jax_trace).
    """
    log_dir = log_dir or os.environ.get(
        "SKA_SDP_FUNC_JAX_TRACE_DIR", "/tmp/ska_sdp_func_jax_trace")
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region on the device timeline (and a Python context
    manager): the `SDP_TMR_PUSH/POP` analogue for traces."""
    return jax.profiler.TraceAnnotation(name)


__all__ = ["annotate", "trace"]
