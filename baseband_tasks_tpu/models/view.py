"""Read-compatible compiled view of a task chain: ``stream.compile()``.

The eager ``Base.read`` loop dispatches every frame from the host, one
device call per frame per stage.  :class:`CompiledStreamView` replaces
that with the compiled scan behind the same API: it wraps a
:class:`~.compiled.CompiledPipeline` behind the same filehandle protocol
as the stream it compiles (``seek``/``read``/``tell``/``shape``/meta all
preserved — the reference's whole usage model rides that protocol,
reference base.py:389-438), so switching to the fast path is one call::

    view = chain.compile()
    data = view.read(n)        # == chain.read(n), but device-resident

Warmup and delay are handled internally: the compiled scan's output
index ``i`` equals the eager chain's sample ``i - delay``, and its first
``warmup`` outputs are affected by the zero-initialized overlap-save
carries.  The view therefore serves

- ``[0, warmup - delay)``       from the eager chain (exact),
- the compiled midsection        from the device scan (equal to eager to
  the streaming-exactness contract, compiled.py:35-47),
- the final partial block        from the eager chain again,

so ``view.read(n) == chain.read(n)`` over the *whole* stream, and the
compiled path serves everything except a bounded head and tail.

Reads are streamed: overlap-save carries persist on device between
calls, so sequential reads never recompute history.  Seeking backward
past retained output resets the scan to block 0 (cheap — compile caches
are reused; only the blocks up to the seek point are re-run).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..base import Base
from ..integration import Integrate

__all__ = ["CompiledStreamView", "compile_stream"]


class CompiledStreamView(Base):
    """A stream head with the eager chain's API and the compiled scan's
    speed (see module docstring).

    Parameters
    ----------
    tail : task chain head (non-reduction)
        The chain to compile.  Trailing ``Integrate``/``Fold``/
        ``PulseStack`` reductions are handled by :func:`compile_stream`
        (re-binding the reduction over a compiled view of its input);
        this class itself rejects them.
    block_samples
        Passed to :class:`~.compiled.CompiledPipeline`.
    """

    #: source samples per streamed step when nothing pins the block
    _TARGET_BLOCK = 1 << 16

    def __init__(self, tail, *, block_samples=None, mesh=None,
                 shard_axis="time"):
        from .compiled import CompiledPipeline

        cp = CompiledPipeline(tail, block_samples=block_samples)
        if block_samples is None and cp.block_samples < self._TARGET_BLOCK:
            # unpinned chains get the minimal legal block (one frame
            # group); a streamed view wants big steps to amortize the
            # per-step dispatch, so scale up where the stream allows.
            B = cp.block_samples
            avail = min((src.shape[0] - extra)
                        for src, extra in zip(cp.sources,
                                              cp.source_offsets))
            big = -(-self._TARGET_BLOCK // B) * B
            big = max(min(big, avail // B * B), B)
            if big > B:
                try:
                    cp = CompiledPipeline(tail, block_samples=big)
                except ValueError:
                    pass  # a padded stage pins the block; keep default
        if cp.reduction is not None:
            raise ValueError(
                "CompiledStreamView does not take reduction tails "
                "directly; use stream.compile() / compile_stream()")
        if cp.delay != int(cp.delay):
            raise ValueError(
                f"chain has fractional streaming delay {cp.delay}; "
                "choose samples_per_frame values with an integral "
                "delay to compile a read-compatible view")
        self.cp = cp
        self._tail = tail
        self._delay = int(cp.delay)
        self._wu = int(cp.warmup)
        # mesh=None: one block per device step.  With a mesh, each step
        # processes S consecutive blocks, one per device along
        # ``shard_axis`` (ShardedPipeline's super-step: halo exchange
        # replaces the overlap-save carries between shards).
        self._S = 1
        self._in_sharding = None
        if mesh is not None:
            from .sharded import ShardedPipeline
            sp = ShardedPipeline(cp, mesh, axis_name=shard_axis)
            self._S = sp.n_shards
        # full source blocks available from each source's folded offset
        avail = min((src.shape[0] - extra) // cp.block_samples
                    for src, extra in zip(cp.sources, cp.source_offsets))
        # with a mesh only whole super-steps run compiled; the remainder
        # (< S blocks) is served eagerly like any partial tail
        self._max_blocks = max(int(avail) // self._S * self._S, 0)
        attrs = tail.meta.get("__attributes__", {})
        super().__init__(
            shape=tail.shape, start_time=tail.start_time,
            sample_rate=tail.sample_rate,
            samples_per_frame=cp.tail_block, dtype=tail.dtype,
            frequency=attrs.get("frequency"),
            sideband=attrs.get("sideband"),
            polarization=attrs.get("polarization"))

        self._multi = len(cp.sources) > 1
        if mesh is None:
            step_c, leaves = cp.cached_step()

            @jax.jit
            def jstep(carry, xs, *cs):
                return step_c(carry, xs, cs)
        else:
            from jax.sharding import NamedSharding, PartitionSpec
            smapped, leaves = sp.sharded_step()
            self._in_sharding = NamedSharding(mesh,
                                              PartitionSpec(shard_axis))

            @jax.jit
            def jstep(carry, xs, *cs):
                return smapped(carry, xs, cs)

        self._caches = leaves
        self._jstep = jstep
        self._reset_scan()

    # -- streaming state ---------------------------------------------------
    def _reset_scan(self):
        self._carry = self.cp.init_carry()
        self._next_step = 0      # device steps taken (S blocks each)
        self._bufs = []          # per-step outputs, compiled coords
        self._buf_start = 0      # compiled index of _bufs[0][0]

    def _read_next_source_block(self):
        cp = self.cp
        n = self._S * cp.block_samples
        blocks = []
        for src, extra in zip(cp.sources, cp.source_offsets):
            src.seek(extra + self._next_step * n)
            x = jnp.asarray(src.read(n))
            if self._in_sharding is not None:
                x = jax.device_put(x, self._in_sharding)
            blocks.append(x)
        self._next_step += 1
        return tuple(blocks) if self._multi else blocks[0]

    def _compiled_read(self, c0, c1):
        """Compiled outputs [c0, c1) (compiled coordinates)."""
        tb = self._S * self.cp.tail_block
        if c0 < self._buf_start:
            self._reset_scan()
        # drop whole retained step outputs that precede c0
        while self._bufs and self._buf_start + tb <= c0:
            self._bufs.pop(0)
            self._buf_start += tb
        if not self._bufs:
            skip = c0 // tb
            while self._next_step < skip:
                xs = self._read_next_source_block()
                self._carry, _ = self._jstep(self._carry, xs,
                                             *self._caches)
            self._buf_start = self._next_step * tb
        while self._next_step * tb < c1:
            xs = self._read_next_source_block()
            self._carry, y = self._jstep(self._carry, xs, *self._caches)
            self._bufs.append(y)
        buf = self._bufs[0] if len(self._bufs) == 1 \
            else jnp.concatenate(list(self._bufs), axis=0)
        return buf[c0 - self._buf_start:c1 - self._buf_start]

    def _eager_read(self, s0, s1):
        self._tail.seek(s0)
        return self._tail.read(s1 - s0)

    # -- Base hook ---------------------------------------------------------
    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        s0 = frame_index * spf
        s1 = min(s0 + spf, self._shape[0])
        d, w = self._delay, self._wu
        lo = w - d                                  # >= 0: warmup >= delay
        hi = self._max_blocks * self.cp.tail_block - d
        pieces = []
        i = s0
        if i < lo:                                  # warmup head: eager
            j = min(s1, lo)
            pieces.append(jnp.asarray(self._eager_read(i, j)))
            i = j
        if i < s1 and i < hi:                       # compiled midsection
            j = min(s1, hi)
            pieces.append(self._compiled_read(i + d, j + d))
            i = j
        if i < s1:                                  # partial last block
            pieces.append(jnp.asarray(self._eager_read(i, s1)))
        return pieces[0] if len(pieces) == 1 \
            else jnp.concatenate(pieces, axis=0)

    def close(self):
        self._bufs = []
        super().close()

    def __repr__(self):
        shard = (f", shards={self._S}" if self._S > 1 else "")
        return (f"CompiledStreamView({self._tail!r},\n"
                f"    block_samples={self.cp.block_samples}, "
                f"delay={self._delay}, warmup={self._wu}{shard})")


def compile_stream(tail, *, block_samples=None, mesh=None,
                   shard_axis="time"):
    """``tail.compile()`` implementation: a read-compatible compiled view.

    Trailing reductions (``Integrate``/``Fold``/``PulseStack``) keep
    their host bin bookkeeping but pull from a compiled view of their
    input chain — the heavy per-sample work (FFTs, chirps, FIRs,
    detection) runs in the device scan; use
    :meth:`CompiledPipeline.run_reduced` to also fold on device.

    With ``mesh``, each device step runs ``S = mesh.shape[shard_axis]``
    consecutive blocks, one per device, via
    :class:`~.sharded.ShardedPipeline` — the one-call path from any
    library chain to multi-chip execution.
    """
    if isinstance(tail, Integrate):
        import copy

        view = compile_stream(tail.ih, block_samples=block_samples,
                              mesh=mesh, shard_axis=shard_axis)
        new = copy.copy(tail)
        new.ih = view
        new._frame = None
        new._frame_index = None
        new._offset = 0
        return new
    return CompiledStreamView(tail, block_samples=block_samples,
                              mesh=mesh, shard_axis=shard_axis)
