"""Auxiliary subsystems: structured logging and dtype rules."""

from .logging import get_logger, log_event, set_verbosity

__all__ = ["get_logger", "log_event", "set_verbosity"]
