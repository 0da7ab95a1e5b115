"""Mesh-sharded execution of any compiled task graph.

:class:`~.compiled.CompiledPipeline` turns a lazy stream chain into one
``(carry, block) -> (carry, out)`` step driven by ``lax.scan`` — on a
single device.  :class:`ShardedPipeline` lifts that same step onto a
``jax.sharding.Mesh``: each scan step processes ``S`` consecutive blocks
at once, one per device along the mesh's time axis, with the
overlap-save carries turned into a ring halo exchange
(``jax.lax.ppermute``, NCCL over NVLink on GPUs — the sharded
generalization of the
reference's ``PaddedTaskBase`` re-read, base.py:709-795, prescribed as a
*layer* by SURVEY.md §7 step 10).

How the carry becomes a halo
----------------------------
In the single-device scan, each padded stage carries the last ``pad``
samples of its own input; block ``k``'s window is ``[carry_k, x_k]``.
Sharded, the blocks of one step are *consecutive in time* across the
mesh: shard ``i`` holds block ``sS + i``.  Its window front is therefore

* shard ``i > 0``: the tail of shard ``i-1``'s input **this step** —
  one neighbor ``ppermute``;
* shard ``0``: the scan carry (shard ``S-1``'s tail from the previous
  step).

A single *ring* permute delivers both: shard 0 receives shard ``S-1``'s
current tail, which is exactly the **next** step's carry, recovered as a
replicated value with a masked ``psum``.  Every per-shard stage ``task``
then traces with the same shapes as the single-device step, so the
sharded output equals the single-device compiled output to float
roundoff (bit-exact in practice — the per-shard programs are identical).

An absorbed trailing Integrate/Fold/PulseStack reduction rides on top:
the tail output of each super-step is segment-summed into the global
bin accumulators exactly as in ``CompiledPipeline.run_fn`` — XLA
inserts the cross-shard gather/psum for the sharded scatter-add.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["ShardedPipeline"]


class ShardedPipeline:
    """Run a compiled task graph time-sharded over a device mesh.

    Parameters
    ----------
    cp : CompiledPipeline
        The compiled graph.  Reused as-is — block bookkeeping, fusions,
        caches and the absorbed reduction all carry over.
    mesh : jax.sharding.Mesh
        Device mesh.  Blocks are sharded along ``axis_name``; any other
        mesh axes replicate (shard those via the graph's own sample
        shape, e.g. a chan-sharded source).
    axis_name : str
        The mesh axis carrying consecutive time blocks.

    Notes
    -----
    ``S = mesh.shape[axis_name]`` consecutive source blocks form one
    scan super-step, so ``run_blocks`` wants ``n_blocks`` a multiple of
    ``S``.  Every padded stage must satisfy ``pad <= block`` at its
    point in the chain (its neighbor only holds one block of history);
    construct stages with larger ``samples_per_frame`` otherwise — the
    same constraint as ``parallel.halo.halo_exchange``.
    """

    def __init__(self, cp, mesh, *, axis_name="time"):
        if axis_name not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis_name!r}; "
                             f"axes are {tuple(mesh.shape)}")
        self.cp = cp
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_shards = int(mesh.shape[axis_name])
        self._run_cache = {}

    # -- the halo hook ---------------------------------------------------
    def _pad_hook(self):
        axis = self.axis_name

        def hook(st, c, x):
            pad = st.pad
            if not pad:
                window = jnp.concatenate([c, x], axis=0)
                return window, window[:0]
            n = x.shape[0]
            if pad > n:
                # the left neighbor only holds one block of history
                raise ValueError(
                    f"stage {type(st.node).__name__}: pad {pad} exceeds "
                    f"its per-shard block {n}; increase "
                    f"samples_per_frame or use fewer time shards")
            tail = jax.lax.slice_in_dim(x, n - pad, n, axis=0)
            S = jax.lax.axis_size(axis)
            perm = [(i, (i + 1) % S) for i in range(S)]
            received = jax.lax.ppermute(tail, axis, perm=perm)
            idx = jax.lax.axis_index(axis)
            front = jnp.where(idx == 0, c, received)
            # shard 0 received shard S-1's tail == next step's carry;
            # masked psum re-replicates it across the axis
            new_c = jax.lax.psum(
                jnp.where(idx == 0, received, jnp.zeros_like(received)),
                axis)
            return jnp.concatenate([front, x], axis=0), new_c

        return hook

    # -- sharded step ------------------------------------------------------
    def sharded_step(self):
        """(carry, xs, caches) -> (carry, y): one super-step.

        ``xs`` is a global array of ``S * block_samples`` source samples
        (a tuple of such for multi-source graphs) sharded along the time
        mesh axis; ``y`` comes back sharded the same way
        (``S * tail_block`` tail samples).  Carries and caches are
        replicated.
        """
        cp = self.cp
        step = cp.step_fn(pad_hook=self._pad_hook())
        bindings, leaves = cp.cache_bindings()
        multi = len(cp.sources) > 1
        mesh = self.mesh
        ax = self.axis_name

        n_carries = len(cp.init_carry())
        carry_specs = (P(),) * n_carries
        x_specs = (P(ax),) * len(cp.sources) if multi else P(ax)
        cache_specs = (P(),) * len(leaves)

        def inner(carry, xs, caches):
            with cp._bind(bindings, caches):
                return step(carry, xs)

        smapped = jax.shard_map(
            inner, mesh=mesh,
            in_specs=(carry_specs, x_specs, cache_specs),
            out_specs=(carry_specs, P(ax)),
            check_vma=False)  # carry replication is guaranteed by the
        # hook's masked psum
        return smapped, leaves

    def _shard_blocks(self, blocks):
        """Host block stack (n_blocks, block, ...) -> device-placed
        (n_steps, S*block, ...) sharded along the time axis.

        Works leaf-wise over pytrees, so packed-source stacks
        (``(carrier, mask)`` from ``read_source_blocks``) shard the same
        way: each leaf's per-block leading axis is contiguous in time,
        so S consecutive blocks concatenate and split evenly across the
        mesh axis, and each shard decodes exactly its own block inside
        the compiled step (ops/unpack_device.py)."""
        S = self.n_shards
        spec = NamedSharding(self.mesh, P(None, self.axis_name))

        def one(leaf):
            leaf = jnp.asarray(leaf)
            n_blocks = leaf.shape[0]
            if n_blocks % S:
                raise ValueError(
                    f"n_blocks={n_blocks} must be a multiple of "
                    f"the {S} time shards")
            stacked = leaf.reshape((n_blocks // S, S * leaf.shape[1])
                                   + leaf.shape[2:])
            return jax.device_put(stacked, spec)

        return jax.tree.map(one, blocks)

    def run_fn(self, n_blocks):
        """Jitted sharded scan over ``n_blocks`` source blocks (must be a
        multiple of the time-shard count).  Call signature and outputs
        match ``CompiledPipeline.run_fn``: ``run(blocks)`` with blocks of
        shape ``(n_blocks, block_samples) + sample_shape`` per source,
        returning the concatenated tail output, or ``(sums, counts)``
        with an absorbed reduction."""
        S = self.n_shards
        if n_blocks % S:
            raise ValueError(f"n_blocks={n_blocks} must be a multiple of "
                             f"the {S} time shards")
        cached = self._run_cache.get(int(n_blocks))
        if cached is not None:
            return cached
        cp = self.cp
        n_steps = n_blocks // S
        smapped, leaves = self.sharded_step()
        multi = len(cp.sources) > 1
        red = cp.reduction

        if red is None:
            @jax.jit
            def jrun(stacked, *caches):
                carry = cp.init_carry()
                carry, ys = jax.lax.scan(
                    lambda c, x: smapped(c, x, caches), carry, stacked)
                return ys.reshape((-1,) + ys.shape[2:])

            def fn(blocks):
                stacked = (tuple(self._shard_blocks(b) for b in blocks)
                           if multi else self._shard_blocks(blocks))
                return jrun(stacked, *leaves)

            self._run_cache[int(n_blocks)] = fn
            return fn

        # absorbed reduction: same segment-sum accumulators as the
        # single-device path, over S*tail_block samples per step
        ids_f, n_seg = cp.segment_ids_f(n_blocks)
        ids_f = ids_f.reshape((n_steps, S * cp.tail_block)
                              + ids_f.shape[2:])
        from .compiled import (decode_segment_ids, init_reduction_acc,
                               make_reduction_update)
        sample_shape = cp._tail.sample_shape
        update = make_reduction_update(red)

        def red_step(carry, xs, caches):
            data_carry, sums, counts = carry[:-2], carry[-2], carry[-1]
            blocks, idf = xs
            new_carry, y = smapped(data_carry, blocks, caches)
            sums, counts = update(sums, counts, y,
                                  decode_segment_ids(idf))
            return new_carry + (sums, counts), 0

        @jax.jit
        def jrun(stacked, ids, *caches):
            carry = cp.init_carry() + init_reduction_acc(
                red, sample_shape, n_seg)
            carry, _ = jax.lax.scan(
                lambda c, x: red_step(c, x, caches), carry,
                (stacked, ids))
            sums, counts = carry[-2], carry[-1]
            return (cp._shape_reduced(sums[:-1]),
                    cp._shape_reduced_counts(counts[:-1]))

        def fn(blocks):
            stacked = (tuple(self._shard_blocks(b) for b in blocks)
                       if multi else self._shard_blocks(blocks))
            return jrun(stacked, ids_f, *leaves)

        self._run_cache[int(n_blocks)] = fn
        return fn

    def run_blocks(self, blocks):
        """Run the sharded graph over stacked source blocks (tuple of
        stacks for multi-source graphs, pytrees for packed sources);
        see ``run_fn``."""
        if len(self.cp.sources) > 1:
            blocks = tuple(blocks)  # per-source stacks (or pytrees)
            n_blocks = jax.tree.leaves(blocks[0])[0].shape[0]
        else:
            n_blocks = jax.tree.leaves(blocks)[0].shape[0]
        return self.run_fn(int(n_blocks))(blocks)

    def run_reduced(self, blocks):
        """Averaged (sums/counts) result of the absorbed reduction, like
        ``CompiledPipeline.run_reduced``."""
        if self.cp.reduction is None:
            raise ValueError("no reduction to run")
        sums, counts = self.run_blocks(blocks)
        shaped = counts[(...,) + (None,) * (sums.ndim - counts.ndim)]
        out = sums / jnp.maximum(shaped, 1)
        if bool(getattr(self.cp.reduction, "_masked", False)):
            # fully-flagged cells: NaN, matching the eager node (see
            # integration.py Integrate._read_frame)
            out = jnp.where(shaped > 0, out, jnp.nan)
        return out, counts
