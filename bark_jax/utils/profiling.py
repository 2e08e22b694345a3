"""Tracing / profiling hooks: device traces, annotations, throughput meters.

The reference has no profiler beyond wall timers (SURVEY.md §5 — two ad-hoc
Timer classes, src/bark/utils/timer.py:6-22, logger.py:12-103). The
replacements here:

  - :func:`trace` — capture a ``jax.profiler`` device trace (XLA op
    timeline, HBM usage) viewable in Perfetto/TensorBoard;
  - :func:`annotate` — named TraceAnnotation region so BO phases (fit /
    acquire / predict) are visible inside the device trace;
  - :class:`ThroughputMeter` — running samples/s / steps/s meter feeding
    the bench metrics, with correct async-dispatch handling (one
    ``block_until_ready`` at the end of the timed region, so per-call
    dispatch latency is not timed as device work).
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int = 2):
    """Capture a device trace of the enclosed block into ``log_dir``.

    Usage::

        with profiling.trace("/tmp/jax-trace"):
            samples = run_bark_sampler(...)
            jax.block_until_ready(samples)

    The trace contains the XLA op timeline per device; open with
    ``tensorboard --logdir`` (profile plugin) or upload the contained
    ``.trace.json.gz`` to Perfetto.
    """
    jax.profiler.start_trace(log_dir, create_perfetto_link=False)
    try:
        yield
    finally:
        jax.effects_barrier()
        jax.profiler.stop_trace()


@contextlib.contextmanager
def annotate(name: str):
    """Named region inside a device trace (wraps TraceAnnotation)."""
    with jax.profiler.TraceAnnotation(name):
        yield


class ThroughputMeter:
    """Running throughput meter: ``meter.start(); ... ; meter.stop(n_units)``.

    Times with async dispatch in flight and synchronizes only at stop, so
    in-graph pipelining is included (standalone per-call timings are
    floored at dispatch latency and overstate cost — measure marginal
    in-graph throughput instead).
    """

    def __init__(self):
        self.total_units = 0.0
        self.total_seconds = 0.0
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, n_units: float, result=None):
        if result is not None:
            jax.block_until_ready(result)
        else:
            jax.effects_barrier()
        dt = time.perf_counter() - self._t0
        self.total_units += n_units
        self.total_seconds += dt
        return n_units / dt

    @property
    def rate(self) -> float:
        return self.total_units / max(self.total_seconds, 1e-12)
