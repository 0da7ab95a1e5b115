"""Time ↔ frequency corner turn: the channelizer's resharding collective.

Channelization (``Channelize``, reference channelize.py:12) is local —
each length-``n`` spectrum uses ``n`` consecutive samples.  What needs
communication on a mesh is the *reshard* that follows: spectra start out
sharded along time (each chip holds all channels of its own time slice),
but downstream per-channel work (dedispersion chirps, PFB gains, fold)
wants channels sharded and time replicated-or-rechunked.  That transition
is a classic FFT "corner turn", and on a device mesh it is exactly one
``jax.lax.all_to_all`` (SURVEY.md §5: "all_to_all for
channelize/dechannelize resharding").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

__all__ = ["corner_turn", "sharded_channelize", "sharded_dechannelize"]


def corner_turn(x, axis_name="time", *, chan_axis=1, time_axis=0):
    """Inside ``shard_map``: trade a time shard for a channel shard.

    Each device sends everyone its slice of the channel axis and receives
    everyone's slice of the time axis: local ``(T_l, C, ...)`` becomes
    ``(T_l * S, C / S, ...)`` with one all_to_all.
    """
    return jax.lax.all_to_all(x, axis_name, split_axis=chan_axis,
                              concat_axis=time_axis, tiled=True)


def sharded_channelize(mesh, n, *, axis_name="time", inverse_turn=False):
    """Build a sharded channelizer with the corner-turn reshard.

    Returns ``fn(x)`` taking a global ``(T, ...)`` array time-sharded over
    ``axis_name`` and returning the ``(T // n, n, ...)`` channelized
    array with the *channel* axis sharded over the same devices (time
    replicated across them in chunks): reshape → FFT → all_to_all.

    The per-shard sample count must divide by ``n`` and the mesh size
    must divide ``n``.
    """
    n_shards = mesh.shape[axis_name]
    if n % n_shards:
        raise ValueError(f"n={n} must divide over {n_shards} shards")

    def local(xl):
        t_l = xl.shape[0]
        if t_l % n:
            raise ValueError(f"local block {t_l} not a multiple of n={n}")
        spectra = jnp.fft.fft(
            xl.reshape((t_l // n, n) + xl.shape[1:]), axis=1)
        return corner_turn(spectra, axis_name)

    in_spec = P(axis_name)
    out_spec = P(None, axis_name)

    def fn(x):
        return jax.shard_map(local, mesh=mesh, in_specs=(in_spec,),
                             out_specs=out_spec)(x)

    return fn


def sharded_dechannelize(mesh, *, axis_name="time"):
    """Inverse of :func:`sharded_channelize`: chan-sharded spectra back to
    a time-sharded raw stream (all_to_all back, then inverse FFT)."""

    def local(xl):
        spectra = jax.lax.all_to_all(xl, axis_name, split_axis=0,
                                     concat_axis=1, tiled=True)
        raw = jnp.fft.ifft(spectra, axis=1)
        return raw.reshape((-1,) + raw.shape[2:])

    in_spec = P(None, axis_name)
    out_spec = P(axis_name)

    def fn(x):
        return jax.shard_map(local, mesh=mesh, in_specs=(in_spec,),
                             out_specs=out_spec)(x)

    return fn
