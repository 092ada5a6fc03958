"""Error model.

The reference threads an `sdp_Error*` status through every call
(utility/sdp_errors.h:13-35) and its Python layer converts non-zero codes to
a `CError` exception. This framework is Python/JAX end-to-end, so the
idiomatic equivalent is an exception hierarchy raised eagerly at trace time
(shape/dtype problems are static under `jit`, so they surface exactly where
the reference's check macros would).
"""


class SdpError(RuntimeError):
    """Base class for all framework errors (maps sdp_Error != SDP_SUCCESS)."""


class SdpRuntimeError(SdpError):
    """Generic runtime failure (SDP_ERR_RUNTIME)."""


class SdpInvalidArgumentError(SdpError, ValueError):
    """Invalid function argument (SDP_ERR_INVALID_ARGUMENT)."""


class SdpDataTypeError(SdpError, TypeError):
    """Unsupported data type (SDP_ERR_DATA_TYPE)."""


class SdpMemLocationError(SdpError):
    """Unsupported device placement (SDP_ERR_MEM_LOCATION).

    Mostly vestigial here — XLA moves data — but raised when an operation
    requires committed device placement (e.g. donated buffers) that the
    inputs do not satisfy.
    """


# Alias matching the reference Python package's exception name
# (utility/error_checking.py:30-46 raises `CError` for any non-zero
# sdp_Error) so users of the reference can except the same symbol.
CError = SdpError


class SdpShapeError(SdpInvalidArgumentError):
    """Array has the wrong number of dimensions or extent."""
