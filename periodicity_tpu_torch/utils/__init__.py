"""Auxiliary subsystems: structured logging, dtype rules and sampler
checkpoints."""

from .logging import get_logger, log_event, set_verbosity

__all__ = ["get_logger", "log_event", "set_verbosity"]
