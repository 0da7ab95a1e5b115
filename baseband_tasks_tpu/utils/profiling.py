"""Observability: per-stage throughput counters and JAX profiler traces.

The reference has no tracing/profiling hooks (SURVEY.md §5); this package
provides: (1) ``monitor(stream)`` — wraps any stream node so reads are
counted and timed, with a pipeline-wide report; (2) ``trace(path)`` — a
context manager around ``jax.profiler`` for device traces.
"""

from __future__ import annotations

import contextlib
import time

from . import units as u

__all__ = ["monitor", "StreamMonitor", "trace"]


class StreamMonitor:
    """Counts samples and wall time of every ``read``/``_read_frame``."""

    def __init__(self, stream, name=None):
        self.stream = stream
        self.name = name or type(stream).__name__
        self.samples = 0
        self.frames = 0
        self.seconds = 0.0
        orig = stream._read_frame

        def counted(frame_index):
            t0 = time.perf_counter()
            out = orig(frame_index)
            self.seconds += time.perf_counter() - t0
            self.frames += 1
            self.samples += len(out)
            return out

        stream._read_frame = counted

    @property
    def samples_per_second(self):
        return self.samples / self.seconds if self.seconds else 0.0

    @property
    def realtime_factor(self):
        """Processing speed relative to the stream's own sample rate."""
        rate = self.stream.sample_rate.to_value(u.Hz)
        return self.samples_per_second / rate if rate else 0.0

    def report(self):
        return (f"{self.name}: {self.samples} samples in {self.frames} "
                f"frames, {self.seconds:.3f} s "
                f"({self.samples_per_second:.3e} samples/s, "
                f"{self.realtime_factor:.2f}x realtime)")

    def __repr__(self):
        return f"<StreamMonitor {self.report()}>"


def monitor(stream, whole_chain=True):
    """Attach monitors to a stream (and, by default, its whole ih chain).

    Returns a list of :class:`StreamMonitor`, tail first.
    """
    monitors = []
    node = stream
    seen = set()
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        monitors.append(StreamMonitor(node))
        if not whole_chain:
            break
        node = getattr(node, "ih", None)
        if node is None:
            ihs = getattr(monitors[-1].stream, "ihs", None)
            if ihs:
                for sub in ihs:
                    monitors.extend(monitor(sub, whole_chain=True))
            break
    return monitors


@contextlib.contextmanager
def trace(path="/tmp/jax-trace"):
    """Capture a device profiler trace around a block of work."""
    import jax
    jax.profiler.start_trace(path)
    try:
        yield path
    finally:
        jax.profiler.stop_trace()
