"""Reduce a ``jax.profiler`` trace to device metrics.

    busy_ns, window_ns, kernels = device_time(xplane_path)

``busy_ns`` is the union of the intervals in which any operation ran on
the device planes (``/device:GPU:*`` by default), ``window_ns`` the span
from the first to the last such operation, and ``kernels`` the summed
device duration per operation name.  Only the per-stream lines of a
device plane are read (lines named ``Stream ...`` when the plane has
them): module- and step-level lines span whole programs and would hide
the gaps between kernels.
"""

from __future__ import annotations

import glob
import os

__all__ = ["device_time", "find_xplane", "union_ns"]


def find_xplane(log_dir):
    """The newest ``*.xplane.pb`` under a ``jax.profiler.trace`` dir."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {log_dir}")
    return max(paths, key=os.path.getmtime)


def union_ns(intervals):
    """Total length of the union of ``(start, end)`` intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_time(path, plane_prefix="/device:GPU"):
    """(busy_ns, window_ns, {op name: device ns}) of one trace file."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    intervals = []
    kernels = {}
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        lines = list(plane.lines)
        streams = [ln for ln in lines if ln.name.startswith("Stream")]
        for line in streams or lines:
            for ev in line.events:
                if ev.duration_ns <= 0:
                    continue
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                kernels[ev.name] = kernels.get(ev.name, 0.0) \
                    + ev.duration_ns
    if not intervals:
        raise ValueError(f"no device events on planes {plane_prefix!r}")
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    return union_ns(intervals), window, kernels
