"""Device-mesh construction helpers."""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, PartitionSpec as P

__all__ = ["make_mesh", "time_chan_specs"]


def make_mesh(time=1, chan=1, devices=None):
    """Build a (time, chan) mesh over the available devices.

    ``time`` shards the sample axis of overlap-save ops (halo exchange
    between neighbours); ``chan`` shards frequency channels (no
    communication).  Pass
    ``time=-1`` or ``chan=-1`` to absorb all remaining devices.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if time == -1 and chan == -1:
        raise ValueError("only one of time/chan may be -1")
    if time == -1:
        time = n // chan
    if chan == -1:
        chan = n // time
    if time < 1 or chan < 1:
        raise ValueError(f"mesh axes must be positive, got "
                         f"time={time}, chan={chan}")
    if time * chan > n:
        raise ValueError(f"mesh {time}x{chan} needs {time * chan} devices, "
                         f"have {n}")
    grid = devices[:time * chan].reshape(time, chan)
    return Mesh(grid, ("time", "chan"))


def time_chan_specs(mesh):
    """Standard PartitionSpecs for (samples, chan, pol[, pair]) blocks."""
    data = P("time", "chan")
    per_chan = P(None, "chan")
    profile = P(None, "chan")
    return {"data": data, "per_chan": per_chan, "profile": profile}
