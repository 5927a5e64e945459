"""Auxiliary subsystems: profiling, structured logging, checkpointing and
dtype rules."""

from .checkpoint import load_state, save_state
from .logging import get_logger, log_event, set_verbosity
from .profiling import timer, trace

__all__ = ["trace", "timer", "get_logger", "log_event",
           "set_verbosity", "save_state", "load_state"]
