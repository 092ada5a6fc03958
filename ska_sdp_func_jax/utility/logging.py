"""SKA-format logging.

Reference: utility/sdp_logging.{h,c} emits pipe-delimited
``1|<timestamp>|<severity>|<thread>|<function>|<file>#<line>|<tag>|<message>``
records with the level filtered by the ``SKA_SDP_FUNC_LOG_LEVEL`` env var
(sdp_logging.c:26-56). This module reproduces the format on top of Python
logging; the env var ``SKA_SDP_FUNC_JAX_LOG_LEVEL`` (falling back to the
reference's name) selects the threshold: debug/info/warn/err/crit.
"""

import inspect
import logging
import os
import sys
import time

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "err": logging.ERROR,
    "error": logging.ERROR,
    "crit": logging.CRITICAL,
    "critical": logging.CRITICAL,
}

_SEVERITY = {
    logging.DEBUG: "DEBUG",
    logging.INFO: "INFO",
    logging.WARNING: "WARNING",
    logging.ERROR: "ERROR",
    logging.CRITICAL: "CRITICAL",
}


class _SkaFormatter(logging.Formatter):
    """SKA log message format, version 1 (pipe-delimited)."""

    def format(self, record):
        utc = time.gmtime(record.created)
        frac = f"{record.created % 1.0:.3f}"[1:]
        timestamp = time.strftime("%Y-%m-%dT%H:%M:%S", utc) + frac + "Z"
        severity = _SEVERITY.get(record.levelno, "INFO")
        func = getattr(record, "src_func", record.funcName) or ""
        path = getattr(record, "src_file", record.pathname) or ""
        line = getattr(record, "src_line", record.lineno)
        return (
            f"1|{timestamp}|{severity}||{func}|{path}#{line}|"
            f"ska-sdp-func-jax|{record.getMessage()}"
        )


def _env_level() -> int:
    value = os.environ.get(
        "SKA_SDP_FUNC_JAX_LOG_LEVEL",
        os.environ.get("SKA_SDP_FUNC_LOG_LEVEL", "info"),
    )
    return _LEVELS.get(value.strip().lower(), logging.INFO)


_logger = None


def get_logger() -> logging.Logger:
    """Return the framework logger, configuring it on first use."""
    global _logger
    if _logger is None:
        logger = logging.getLogger("ska_sdp_func_jax")
        if not logger.handlers:
            # INFO and below to stdout, warnings and above to stderr,
            # mirroring the reference (sdp_logging.c uses stdout/stderr).
            out = logging.StreamHandler(sys.stdout)
            out.addFilter(lambda r: r.levelno < logging.WARNING)
            err = logging.StreamHandler(sys.stderr)
            err.setLevel(logging.WARNING)
            for handler in (out, err):
                handler.setFormatter(_SkaFormatter())
                logger.addHandler(handler)
            logger.setLevel(_env_level())
            logger.propagate = False
        _logger = logger
    return _logger


def _log(level: int, message: str, *args) -> None:
    logger = get_logger()
    if not logger.isEnabledFor(level):
        return
    frame = inspect.currentframe().f_back.f_back
    extra = {}
    if frame is not None:
        extra = {
            "src_func": frame.f_code.co_name,
            "src_file": os.path.basename(frame.f_code.co_filename),
            "src_line": frame.f_lineno,
        }
    logger.log(level, message % args if args else message, extra=extra)


def log_debug(message: str, *args) -> None:
    _log(logging.DEBUG, message, *args)


def log_info(message: str, *args) -> None:
    _log(logging.INFO, message, *args)


def log_warning(message: str, *args) -> None:
    _log(logging.WARNING, message, *args)


def log_error(message: str, *args) -> None:
    _log(logging.ERROR, message, *args)


def log_critical(message: str, *args) -> None:
    _log(logging.CRITICAL, message, *args)
