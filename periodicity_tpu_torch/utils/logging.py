"""Structured logging of estimator runs (grid sizes, gridder choice).

Port of ``periodicity_tpu.utils.logging``. Estimators call ``log_event``
with their run parameters. Events are JSON lines on the
``periodicity_tpu_torch`` logger at INFO level; the library is quiet by
default (WARNING threshold) — call ``set_verbosity("info")`` or configure
the logger to see them.
"""

import json
import logging

__all__ = ["get_logger", "log_event", "set_verbosity"]

_LOGGER = None


def get_logger():
    global _LOGGER
    if _LOGGER is None:
        logger = logging.getLogger("periodicity_tpu_torch")
        if not logger.handlers:
            # a NullHandler: the library never writes into a host
            # application's output unless asked to
            logger.addHandler(logging.NullHandler())
        logger.setLevel(logging.WARNING)
        _LOGGER = logger
    return _LOGGER


def set_verbosity(level="info"):
    """Set the event-log threshold ('debug'|'info'|'warning'|...) and
    attach the library's own stderr handler (propagation is disabled at
    that point so records are not also emitted via the root logger)."""
    logger = get_logger()
    if not any(
        isinstance(h, logging.StreamHandler) for h in logger.handlers
    ):
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(getattr(logging, level.upper()))


def log_event(event, **fields):
    """Emit one structured (JSON) log line, e.g.
    log_event("gls", n=1e5, nf=1e6, nfft=2**23)."""
    logger = get_logger()
    if logger.isEnabledFor(logging.INFO):
        logger.info(json.dumps({"event": event, **fields}, default=str))
