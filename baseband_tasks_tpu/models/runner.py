"""Double-buffered streaming execution: host I/O overlapped with device
compute.

SURVEY.md §7 prescribes double-buffered host→device feeding for
production ingest: while the device processes block ``i``, the host
reads/decodes block ``i+1`` and ships it, so the pipeline is bounded by
max(host rate, device rate) instead of their sum.  The reference's
analogue is the pull-based ``Base.read`` loop (base.py:389-438), which
is strictly serial.

:class:`StreamRunner` drives a :class:`~.compiled.CompiledPipeline` (or
any ``(carry, block) -> (carry, out)`` step) from its source stream:

- a reader thread pulls source blocks (file decode, bit-unpack — all
  host work) ``prefetch`` blocks ahead;
- each block is shipped with ``jax.device_put`` as soon as it is read
  (transfers overlap compute on platforms with async dispatch);
- the jitted per-block step keeps the overlap-save carries on device;
  nothing synchronizes until the final fetch.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["StreamRunner"]

#: jitted complex recombine (module-level so the jit cache is shared)
_jcomplex = jax.jit(jax.lax.complex)


class StreamRunner:
    """Run a compiled pipeline over a source stream with prefetch.

    Parameters
    ----------
    cp : CompiledPipeline
        The compiled graph (single-source).  Its ``cached_step`` is used,
        so device caches travel as jit arguments.
    prefetch : int
        Blocks the reader thread may run ahead (>= 1; 2 = classic double
        buffering).
    planes : bool
        Ship complex blocks as two float32 re/im planes and run the
        pipeline's planes-interchange step (``cached_planes_step``);
        outputs come back as an ``(re, im)`` pair of float32 arrays
        (``im`` ``None`` for real tails).
    """

    def __init__(self, cp, prefetch=2, planes=False):
        if len(cp.sources) != 1:
            raise ValueError("StreamRunner drives single-source graphs")
        self.cp = cp
        self.prefetch = max(int(prefetch), 1)
        self.planes = bool(planes)
        self.packed = cp._decoders[0] is not None
        if self.packed and self.planes:
            raise ValueError("packed ingest and planes interchange are "
                             "mutually exclusive (carriers are already "
                             "float32 on the boundary)")
        if self.planes:
            step_p, caches = cp.cached_planes_step()
            self._caches = caches

            @jax.jit
            def jstep(carry, br, bi, *cs):
                return step_p(carry, (br, bi), None, cs)

            @jax.jit
            def jstep_real(carry, br, *cs):
                return step_p(carry, (br, None), None, cs)

            self._jstep_real = jstep_real
        else:
            step_c, caches = cp.cached_step()
            self._caches = caches

            @jax.jit
            def jstep(carry, block, *cs):
                return step_c(carry, block, cs)

        self._jstep = jstep

        if cp.reduction is not None:
            # absorbed Integrate/Fold: per block, segment-sum the tail
            # output into the bin accumulators — the SAME accumulator
            # as CompiledPipeline.run_fn / ShardedPipeline (shared so
            # masked semantics cannot diverge between executors)
            from .compiled import (decode_segment_ids,
                                   make_reduction_update)
            update = make_reduction_update(cp.reduction)

            @jax.jit
            def jreduce(sums, counts, y, idf):
                return update(sums, counts, y, decode_segment_ids(idf))

            self._jreduce = jreduce

    def _reader(self, n_blocks, offset, q, stop):
        src = self.cp.source
        block = self.cp.block_samples
        try:
            # source_offsets folds any compiled GetSlice time shift in
            base = self.cp.source_offsets[0] + offset
            if self.packed:
                # raw payload bits only: host work is file I/O, the
                # decode runs inside the compiled step on device
                for k in range(n_blocks):
                    shipped = jax.tree.map(
                        jax.device_put,
                        src.read_packed(base + k * block, block))
                    while not stop.is_set():
                        try:
                            q.put(shipped, timeout=0.2)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                return
            src.seek(base)
            for _ in range(n_blocks):
                data = np.asarray(src.read(block))
                if self.planes:
                    # two float32 transfers (the planes interchange)
                    if np.iscomplexobj(data):
                        shipped = (jax.device_put(
                                       np.ascontiguousarray(data.real)),
                                   jax.device_put(
                                       np.ascontiguousarray(data.imag)))
                    else:
                        shipped = (jax.device_put(data), None)
                else:
                    shipped = jax.device_put(data)
                # bounded put that re-checks the stop flag, so a failed
                # consumer can never leave this thread blocked forever
                while not stop.is_set():
                    try:
                        # ship immediately; on async platforms the
                        # transfer overlaps the device's current step
                        q.put(shipped, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except Exception as exc:  # surface in the consumer
            while not stop.is_set():
                try:
                    q.put(exc, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def run(self, n_blocks, offset=0):
        """Process ``n_blocks`` source blocks.

        Without an absorbed reduction, returns the concatenated tail-rate
        output (device array).  With one (the graph was built from an
        ``Integrate``/``Fold``/``PulseStack`` tail), returns the same
        ``(sums, counts)`` accumulators as
        ``CompiledPipeline.run_fn(n_blocks)`` — the reduction is applied
        per block as it streams; ``offset`` must then be a whole number
        of source blocks so the eager timeline stays block-aligned.
        """
        red = self.cp.reduction
        if red is not None:
            if offset % self.cp.block_samples:
                raise ValueError(
                    "with an absorbed reduction, offset must be a "
                    f"multiple of block_samples ({self.cp.block_samples})")
            tail_off = offset // self.cp.block_samples * self.cp.tail_block
            # per-block id planes, placed on device before the reader
            # thread starts
            ids_np, n_seg = self.cp.segment_ids_np(n_blocks, tail_off)
            ids_f = [jax.device_put(ids_np[i]) for i in range(n_blocks)]
            jax.block_until_ready(ids_f)
            from .compiled import init_reduction_acc
            sums, counts = init_reduction_acc(
                red, self.cp._tail.sample_shape, n_seg)
        carry = self.cp.init_carry(planes=self.planes)
        q = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._reader,
                             args=(n_blocks, offset, q, stop), daemon=True)
        t.start()
        outs = []
        try:
            for i in range(n_blocks):
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                if self.planes:
                    br, bi = item
                    if bi is None:
                        carry, y = self._jstep_real(carry, br,
                                                    *self._caches)
                    else:
                        carry, y = self._jstep(carry, br, bi,
                                               *self._caches)
                else:
                    carry, y = self._jstep(carry, item, *self._caches)
                if red is not None:
                    if self.planes:
                        # device-side recombine is fine (only boundary
                        # transfers are restricted to f32); jitted so it
                        # cannot race the reader thread's device_put
                        y = y[0] if y[1] is None \
                            else _jcomplex(y[0], y[1])
                    sums, counts = self._jreduce(sums, counts, y, ids_f[i])
                else:
                    outs.append(y)
        finally:
            stop.set()
            t.join(timeout=60)
            if t.is_alive():
                # surface a reader stuck in a transfer instead of
                # leaving it running silently
                import warnings
                warnings.warn(
                    "StreamRunner reader thread still alive after "
                    "60 s join (device transfer hung?); subsequent "
                    "eager device ops may race it", RuntimeWarning,
                    stacklevel=2)
        if red is not None:
            return (self.cp._shape_reduced(sums[:-1]),
                    self.cp._shape_reduced_counts(counts[:-1]))
        if self.planes:
            yr = jnp.concatenate([o[0] for o in outs], axis=0)
            if outs[0][1] is None:
                return yr, None
            return yr, jnp.concatenate([o[1] for o in outs], axis=0)
        return jnp.concatenate(outs, axis=0)
