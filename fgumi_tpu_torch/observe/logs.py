"""Logging setup: ``--log-level`` / ``FGUMI_TPU_LOG`` / ``-v`` with a format
carrying elapsed time and thread name, so the lines of the stage runner's
reader, writer and resolve threads and of the BGZF pool are attributable::

    12:34:56 INFO fgumi_tpu_torch [fgumi-writer +3.214s]: ...

``+3.214s`` is seconds since logging was set up (process-relative, so the
stages of one ``pipeline`` run share one clock).
"""

import logging
import os
import time

LEVELS = ("debug", "info", "warning", "error")

LOGGER = "fgumi_tpu_torch"

_FORMAT = ("%(asctime)s %(levelname)s %(name)s [%(threadName)s "
           "%(elapsed)s]: %(message)s")


class ElapsedFormatter(logging.Formatter):
    """Formatter injecting ``%(elapsed)s`` = +seconds since construction."""

    default_time_format = "%H:%M:%S"
    default_msec_format = None

    def __init__(self, fmt=_FORMAT):
        super().__init__(fmt)
        self._t0 = time.monotonic()

    def format(self, record):
        record.elapsed = f"+{time.monotonic() - self._t0:.3f}s"
        return super().format(record)


def resolve_level(log_level: str = None, verbose: bool = False) -> int:
    """The effective level: an explicit --log-level wins, then
    ``FGUMI_TPU_LOG``, then -v (debug), else info. An unknown environment
    value falls back to info with a warning."""
    name = log_level or os.environ.get("FGUMI_TPU_LOG", "").strip().lower()
    if name not in LEVELS:
        if name:
            logging.getLogger(LOGGER).warning(
                "FGUMI_TPU_LOG=%s: unknown level (expected one of %s); "
                "using info", name, "/".join(LEVELS))
        name = "debug" if verbose else "info"
    return getattr(logging, name.upper())


class FlightLogHandler(logging.Handler):
    """Feeds every WARNING+ record into the flight recorder's ring (one
    handler dispatch per WARNING+ record; never the hot path)."""

    def __init__(self):
        super().__init__(level=logging.WARNING)

    def emit(self, record):
        try:
            from .flight import FLIGHT

            FLIGHT.note("log", level=record.levelname, logger=record.name,
                        msg=record.getMessage()[:300])
        except Exception:  # noqa: BLE001 - evidence must never crash logging
            pass


def _install_flight_handler(root):
    if not any(isinstance(h, FlightLogHandler) for h in root.handlers):
        root.addHandler(FlightLogHandler())


def setup_logging(log_level: str = None, verbose: bool = False) -> int:
    """Install the elapsed/thread-aware format on the root logger.

    Safe to call repeatedly in one process (the staged ``pipeline``
    re-enters ``main`` per stage): the handler is installed once and the
    level updated on each call. When someone else configured logging
    first (pytest, an embedding application), their handlers stay and only
    the levels change. Returns the effective level."""
    level = resolve_level(log_level, verbose)
    root = logging.getLogger()
    _install_flight_handler(root)
    handler = None
    for h in root.handlers:
        if getattr(h, "_fgumi_observe", False):
            handler = h
            break
    if handler is None:
        # the flight handler is ours and writes nowhere visible: only a
        # foreign handler means someone else owns the logging config
        if any(not isinstance(h, FlightLogHandler) for h in root.handlers):
            root.setLevel(min(root.level or level, level))
            logging.getLogger(LOGGER).setLevel(level)
            return level
        handler = logging.StreamHandler()
        handler.setFormatter(ElapsedFormatter())
        handler._fgumi_observe = True
        root.addHandler(handler)
    root.setLevel(level)
    logging.getLogger(LOGGER).setLevel(level)
    return level
