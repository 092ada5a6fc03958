"""Utility layer: array contracts, coordinates, errors, logging, timers.

Replacement for the reference's `utility/` runtime
(sdp_Mem / device wrapper / checks — see SURVEY.md §2.1): jax.Arrays carry
dtype/shape/sharding natively, so the tensor wrapper reduces to validation
helpers, and the CUDA isolation layer is subsumed by XLA/Pallas.
"""

from .constants import C_0
from .data_model import (
    check_uvw,
    check_vis,
    check_weights,
    get_uvw_metadata,
    get_vis_metadata,
)
from .errors import (
    CError,
    SdpError,
    SdpDataTypeError,
    SdpInvalidArgumentError,
    SdpMemLocationError,
    SdpRuntimeError,
    SdpShapeError,
)
from .logging import get_logger, log_debug, log_info, log_warning, log_error, log_critical
from .profiling import annotate, trace
from .sky_coord import SkyCoord
from .timers import Timer, Timers, TimerType

__all__ = [
    "C_0",
    "CError",
    "SdpError",
    "SdpDataTypeError",
    "SdpInvalidArgumentError",
    "SdpMemLocationError",
    "SdpRuntimeError",
    "SdpShapeError",
    "SkyCoord",
    "annotate",
    "trace",
    "Timer",
    "Timers",
    "TimerType",
    "check_uvw",
    "check_vis",
    "check_weights",
    "get_logger",
    "get_uvw_metadata",
    "get_vis_metadata",
    "log_debug",
    "log_info",
    "log_warning",
    "log_error",
    "log_critical",
]
