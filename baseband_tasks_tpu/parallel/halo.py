"""Halo exchange for time-sharded overlap-save processing.

The reference's ``PaddedTaskBase`` (base.py:709-795) pads every frame by
re-reading overlapping input on one host.  Sharded across devices, the same
overlap becomes a neighbor exchange: each time-shard sends its edge samples
to adjacent shards with ``jax.lax.ppermute`` (NCCL over NVLink on GPUs) —
ring-style neighbor
communication, the convolution analogue of ring attention (SURVEY.md §5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

__all__ = ["halo_exchange", "sharded_overlap_save"]


def halo_exchange(x, pad_start, pad_end, axis_name="time", periodic=False,
                  axis=0):
    """Extend a per-shard block with neighbors' edge samples along ``axis``.

    Inside ``shard_map``: returns an array of
    ``pad_start + local_n + pad_end`` samples along ``axis``.  Non-periodic
    edge shards receive zeros (matching a zero-padded stream edge); with
    ``periodic=True`` the ring wraps.
    """
    n_shards = jax.lax.axis_size(axis_name)
    local_n = x.shape[axis]

    def edge(start, stop):
        return jax.lax.slice_in_dim(x, start, stop, axis=axis)

    def zeros(n):
        shape = list(x.shape)
        shape[axis] = n
        return jnp.zeros(tuple(shape), x.dtype)

    if (pad_start > local_n or pad_end > local_n) and \
            (n_shards > 1 or periodic):
        # a neighbor (or the wrap-around self) only holds local_n samples
        raise ValueError(
            f"halo ({pad_start},{pad_end}) exceeds local block {local_n}; "
            f"use fewer shards or larger blocks")
    if pad_start + pad_end == 0 or n_shards == 1:
        if pad_start or pad_end:
            # a single periodic shard is its own neighbor: wrap edges
            front = (edge(local_n - pad_start, local_n) if periodic
                     else zeros(pad_start)) if pad_start else zeros(0)
            back = (edge(0, pad_end) if periodic
                    else zeros(pad_end)) if pad_end else zeros(0)
            return jnp.concatenate([front, x, back], axis=axis)
        return x
    pieces = [x]
    if pad_start:
        # my left neighbor's trailing pad_start samples
        fwd = [(i, i + 1) for i in range(n_shards - 1)]
        if periodic:
            fwd.append((n_shards - 1, 0))
        from_left = jax.lax.ppermute(edge(local_n - pad_start, local_n),
                                     axis_name, perm=fwd)
        pieces.insert(0, from_left)
    if pad_end:
        # my right neighbor's leading pad_end samples
        bwd = [(i + 1, i) for i in range(n_shards - 1)]
        if periodic:
            bwd.append((0, n_shards - 1))
        from_right = jax.lax.ppermute(edge(0, pad_end), axis_name, perm=bwd)
        pieces.append(from_right)
    return jnp.concatenate(pieces, axis=axis)


def sharded_overlap_save(fn, mesh, pad_start, pad_end, *, in_spec=None,
                         out_spec=None, periodic=False):
    """Lift a padded-window function to a time-sharded array.

    ``fn(window)`` consumes ``pad_start + local_n + pad_end`` samples and
    returns ``local_n`` samples (the valid region) — exactly the
    single-device overlap-save ``task`` contract of ``PaddedTaskBase``.
    The returned callable takes a globally sharded array (samples on mesh
    axis 'time', channels on 'chan') and runs ``fn`` per shard after a
    halo exchange.
    """
    in_spec = in_spec if in_spec is not None else P("time", "chan")
    out_spec = out_spec if out_spec is not None else in_spec

    def sharded(x):
        def local(xl):
            window = halo_exchange(xl, pad_start, pad_end,
                                   periodic=periodic)
            return fn(window)
        return jax.shard_map(local, mesh=mesh, in_specs=in_spec,
                             out_specs=out_spec)(x)

    return sharded
