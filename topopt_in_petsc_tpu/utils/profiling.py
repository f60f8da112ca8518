"""Profiler trace capture (SURVEY §5 'tracing/profiling').

The reference has only manual wall-clock prints; `-profile_dir` adds a
`jax.profiler` trace of the run, readable in TensorBoard or Perfetto.
"""

from __future__ import annotations

from contextlib import contextmanager

import jax


@contextmanager
def trace_to(logdir: str):
    """Capture a jax.profiler trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
