"""Profiling + numeric-debug utilities.

SURVEY §5 aux-subsystem equivalents:
  tracing   — the reference has wall-clock Timers only
              (lib/utils/timer.py); here: `profile_trace` wraps a
              region in a jax.profiler trace viewable in TensorBoard/
              Perfetto, plus the same running-average Timer
              (utils/timer.py).
  sanitizer — the reference checks CUDA errors and exits
              (checkCuda, average_distance_loss_op_gpu.cu.cc:23-32);
              XLA is deterministic so the debug-build equivalent is
              finite-checking: `finite_check` wraps a function with
              jax.experimental.checkify NaN/inf checks.
"""

from __future__ import annotations

import contextlib
from typing import Callable


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a device trace for the enclosed region into log_dir:

        with profile_trace("output/trace"):
            state, _ = train_step(state, batch, rng)
            jax.block_until_ready(state)
    """
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def finite_check(fn: Callable) -> Callable:
    """Wrap a jittable function with NaN/inf checking (debug builds):

        checked = finite_check(train_step)
        err, out = checked(...)   # err.throw() raises on NaN/inf
    """
    from jax.experimental import checkify

    return checkify.checkify(fn, errors=checkify.float_checks)
