"""Profiling helpers: torch.profiler traces and wall-clock timers.

Port of ``periodicity_tpu/utils/profiling.py``. ``trace`` records the
CPU and, where a card is present, its kernels, and writes one Chrome trace
(view it in Perfetto or TensorBoard) into the directory. ``timer`` waits
for the card with ``torch.cuda.synchronize``, which on a local GPU is all
a wall-clock time needs; the JAX package's read-back of a value (a
workaround for a remote TPU) has no counterpart, though ``result["value"]``
is accepted.
"""

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

__all__ = ["trace", "timer"]


@contextlib.contextmanager
def trace(logdir):
    """Capture a torch.profiler trace into ``logdir`` (created if needed)
    as ``<host>_<pid>.<ms>.pt.trace.json``; yields the profiler.

    >>> with trace("/tmp/periodicity-trace"):   # doctest: +SKIP
    ...     gls_power(...)
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(str(logdir), exist_ok=True)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) \
            as prof:
        yield prof


@contextlib.contextmanager
def timer(label=None, sink=None, sync=True):
    """Wall-clock timer that waits for outstanding device work.

    Yields a dict whose 'seconds' key is filled on exit, after
    ``torch.cuda.synchronize()`` when CUDA is initialized and ``sync``;
    ``sink(result)`` is called with it last.
    """
    result = {"label": label, "seconds": None}
    t0 = time.perf_counter()
    try:
        yield result
    finally:
        if sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        result["seconds"] = time.perf_counter() - t0
        if sink is not None:
            sink(result)
