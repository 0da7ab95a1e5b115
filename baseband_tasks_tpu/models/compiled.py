"""Scan-driven compiled execution of lazy stream chains.

The lazy Stream API (base.py) drives each node's frame from the host —
right for interactive use, wrong for production throughput (every stage is
a separate dispatch).  :class:`CompiledPipeline` walks a task graph and
compiles the whole thing into a single per-block step function, then
drives it with ``jax.lax.scan`` over time blocks, with overlap-save pads
carried as scan state instead of re-read — the declarative
"pipeline graph → scan over blocks" design of SURVEY.md §7.

Supported graphs:

* linear sequences of ``TaskBase`` subclasses whose ``task`` is a pure
  device function (Channelize, Dechannelize, Square, Power, Real2Complex,
  Task, SetAttribute, Convolve, Disperse/Dedisperse, ShiftAndResample,
  ShiftSamples, PFBs...);
* multi-input graphs: ``CombineStreamsBase`` nodes (CombineStreams,
  Concatenate, Stack) join several such chains; the compiled step takes
  one source block per input stream (reference combining.py:11-128).
  Branches may arrive with different streaming delays (unequal pads) and
  start offsets: both are absorbed as per-source read offsets, provided
  the required shifts are integral in source samples;
* ``GetSlice`` time slices anywhere in the graph: a slice is a pure
  shift of the stream timeline, so it compiles to a per-source read
  offset (``source_offsets``) rather than device work; the slice's
  ``stop`` is not enforced — the scan processes however many blocks the
  caller feeds it (reference shaping.py:358-416);
* a trailing ``Integrate`` / ``Fold`` / ``PulseStack`` reduction: its
  per-sample bin assignment is evaluated on the host at two-double Phase
  precision (reference integration.py:174-228,380-395), shipped to the
  device as per-block segment-id planes, and accumulated across the scan
  with ``segment_sum`` — so folding is part of the single compiled loop
  instead of a separate host-driven pass.

Streaming semantics: each padded stage carries its last ``pad`` input
samples; it therefore needs one window of history before its output
matches the offline (eager) computation.  ``warmup`` gives the number of
leading output samples affected by the zero-initialized carries; outputs
beyond it are identical to the eager chain's.

Exactness: when every padded stage's ``samples_per_frame`` divides its
``pad``, each streaming window [k·spf − pad, k·spf + spf) coincides with
an eager frame window, so compiled output equals the eager output delayed
by ``delay`` samples *to float roundoff* — not just up to overlap-save
truncation leakage.  For other frame sizes the windows sit at different
offsets and outputs agree only to the task's leakage level (for chirp
tasks, the Gibbs-tail margin).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

import jax
import jax.numpy as jnp

from ..base import BaseTaskBase, PaddedTaskBase, SetAttribute, TaskBase
from ..combining import CombineStreamsBase
from ..integration import Fold, Integrate
from ..shaping import GetSlice
from ..utils import units as u

__all__ = ["CompiledPipeline"]


class _Stage:
    __slots__ = ("node", "padded", "pad", "in_block", "out_block",
                 "in_sample_shape", "in_dtype")

    def __init__(self, node, padded, pad, in_block, out_block):
        self.node = node
        self.padded = padded
        self.pad = pad
        self.in_block = in_block
        self.out_block = out_block
        self.in_sample_shape = node.ih.sample_shape
        self.in_dtype = node.ih.dtype


def decode_segment_ids(idf):
    """float32 segment-id planes -> int32 segment ids (two planes carry
    (coarse, fine) bins when ids exceed float32's exact integer range)."""
    if idf.shape[-1] == 2:
        return (idf[..., 0].astype(jnp.int32) << 12) \
            | idf[..., 1].astype(jnp.int32)
    return idf[..., 0].astype(jnp.int32)


def init_reduction_acc(red, sample_shape, n_seg):
    """Zeroed (sums, counts) accumulators for an absorbed reduction.
    Masked reductions carry per-cell counts (the sample shape)."""
    masked = bool(getattr(red, "_masked", False))
    return (jnp.zeros((n_seg + 1,) + tuple(sample_shape), red._acc_dtype()),
            jnp.zeros((n_seg + 1,) + (tuple(sample_shape) if masked
                                      else ()), jnp.int32))


def make_reduction_update(red):
    """The ONE absorbed-reduction accumulator, shared by
    CompiledPipeline.run_fn, ShardedPipeline, and StreamRunner —
    ``update(sums, counts, y, seg) -> (sums, counts)``.  With a masked
    reduction, NaN-flagged cells (rfi.py fill=nan) drop out per cell."""
    acc_dtype = red._acc_dtype()
    masked = bool(getattr(red, "_masked", False))

    def update(sums, counts, y, seg):
        n = sums.shape[0]
        if masked:
            valid = jnp.isfinite(y)
            y = jnp.where(valid, y, 0)
            counts = counts + jax.ops.segment_sum(
                valid.astype(jnp.int32), seg, num_segments=n)
        else:
            counts = counts + jax.ops.segment_sum(
                jnp.ones(y.shape[0], jnp.int32), seg, num_segments=n)
        sums = sums + jax.ops.segment_sum(
            y.astype(acc_dtype), seg, num_segments=n)
        return sums, counts

    return update


def _lcm(a, b):
    return int(np.lcm(int(a), int(b)))


class CompiledPipeline:
    """Compile a lazy task graph into one jitted block step.

    Parameters
    ----------
    tail : stream
        The graph's last node; its input ancestry is walked up to the
        source stream(s).  Sources themselves are *not* compiled — blocks
        of source samples are the step input (one block per source).  A
        trailing Integrate/Fold/PulseStack is absorbed as an in-scan
        reduction (see module docstring).
    """

    def __init__(self, tail, *, block_samples=None, packed=False):
        self._run_cache = {}  # n_blocks -> compiled run closure
        # Split off a trailing reduction (Integrate and subclasses).
        self.reduction = None
        if isinstance(tail, Integrate):
            self.reduction = tail
            tail = tail.ih
        self._tail = tail

        # -- walk the graph into a post-order program --------------------
        # entries: ("input", source_index) pushes a source block;
        #          ("op", _Stage) transforms the top of stack;
        #          ("combine", node, k) pops k values, pushes task(list).
        program = []
        sources = []

        def build(node):
            if isinstance(node, CombineStreamsBase):
                for ih in node.ihs:
                    build(ih)
                program.append(("combine", node, len(node.ihs)))
            elif isinstance(node, BaseTaskBase):
                build(node.ih)
                program.append(("entry", node))
            else:
                sources.append(node)
                program.append(("input", len(sources) - 1))

        build(tail)
        if len(program) == 1:
            raise ValueError("tail has no task nodes to compile")
        self.sources = sources
        self.source = sources[0]

        # -- block-size constraints, in units of the tail block B --------
        # Every point p in the program carries block_p = coef_p * B (an
        # exact Fraction of the unknown tail block).  Non-padded
        # rate-changing stages add a granularity requirement (whole groups
        # of `q` inputs); padded stages pin block_p to samples_per_frame.
        # Walk tail->sources to get coefficients, then sources->tail to
        # collect constraints.
        stages = []       # _Stage in program order (entry ops only)
        pinned = None     # exact B from padded stages
        constraints = []  # (coef, granularity): coef*B % gran == 0
        delay_stack = []
        warmup_stack = []
        coef_stack = []
        srcs_stack = []   # source indices feeding the branch
        source_offsets = [0] * len(sources)

        for kind, *rest in program:
            if kind == "input":
                coef_stack.append(Fraction(1))
                delay_stack.append(Fraction(0))
                warmup_stack.append(Fraction(0))
                srcs_stack.append([rest[0]])
                continue
            if kind == "combine":
                node, k = rest
                coefs = coef_stack[-k:]
                delays = delay_stack[-k:]
                warmups = warmup_stack[-k:]
                branch_srcs = srcs_stack[-k:]
                del coef_stack[-k:], delay_stack[-k:], srcs_stack[-k:]
                del warmup_stack[-k:]
                srcs_stack.append([i for lst in branch_srcs for i in lst])
                if len(set(coefs)) != 1:
                    raise ValueError(
                        "combined branches arrive with different block "
                        "sizes; give their stages matching frame sizes")
                # Branches may arrive with different streaming delays
                # (pads consumed so far) and the eager node may align
                # them with per-branch start offsets.  Both reduce to a
                # per-branch timeline shift, absorbed by reading that
                # branch's sources later: with branch value at compiled
                # index t = eager_b[t - d_b + o_b*coef], combining
                # eager_b[t - D + offset_b] for a common D needs
                # o_b = (d_b + offset_b - D) / coef; D = min keeps all
                # o_b >= 0 (sources cannot be read before their start).
                totals = [d + off for d, off in zip(delays, node._offsets)]
                d_common = min(totals)
                for lst, tot in zip(branch_srcs, totals):
                    extra = tot - d_common
                    if not extra:
                        continue
                    shift = Fraction(extra) / coefs[0]
                    if shift.denominator != 1:
                        raise ValueError(
                            f"combined branches misaligned by {extra} "
                            f"samples = {float(shift)} source samples — "
                            f"not a whole number; adjust pads/slices so "
                            f"branch shifts are integral in source "
                            f"samples")
                    for i in lst:
                        source_offsets[i] += int(shift)
                coef_stack.append(coefs[0])
                delay_stack.append(d_common)
                # validity is set by the slowest branch's carries: its
                # first max(w_b) samples are garbage regardless of how
                # the timelines were shifted into alignment
                warmup_stack.append(max(warmups))
                stages.append(_CombineStage(node, k))
                continue
            n = rest[0]
            if isinstance(n, SetAttribute):
                stages.append(_Stage(n, False, 0, None, None))
                continue
            if isinstance(n, GetSlice):
                # A time slice is a pure shift: start samples at this
                # point of the chain map back to start/coef source
                # samples, folded into the branch's read offset.
                shift = Fraction(n._start) / coef_stack[-1]
                if shift.denominator != 1:
                    raise ValueError(
                        f"GetSlice start {n._start} is not a whole "
                        f"number of source samples (stage rate ratio "
                        f"{coef_stack[-1]}); slice at a multiple of "
                        f"{coef_stack[-1].numerator} samples instead")
                for i in srcs_stack[-1]:
                    source_offsets[i] += int(shift)
                stages.append(_Stage(n, False, 0, None, None))
                continue
            if isinstance(n, PaddedTaskBase):
                # block at this point must equal samples_per_frame
                need = Fraction(n.samples_per_frame) / coef_stack[-1]
                if need.denominator != 1:
                    raise ValueError("incompatible frame sizes along the "
                                     "chain")
                need = int(need)
                if pinned is None:
                    pinned = need
                elif pinned != need:
                    raise ValueError(
                        f"padded stages disagree on block size: "
                        f"{pinned} vs {need} source samples; "
                        f"construct them with matching samples_per_frame")
                stages.append(_Stage(n, True, n.pad_start + n.pad_end,
                                     n.samples_per_frame,
                                     n.samples_per_frame))
                delay_stack[-1] += n.pad_start + n.pad_end
                warmup_stack[-1] += n.pad_start + n.pad_end
                continue
            if isinstance(n, TaskBase):
                import inspect
                if "task" in n.__dict__ and inspect.ismethod(n.task):
                    # method-style Task callables receive the node and
                    # typically read tell()/time — position-dependent
                    # state a traced step would freeze at construction
                    raise ValueError(
                        "cannot compile a Task with a method-style "
                        "callable (it sees the stream position, which "
                        "is not defined inside the compiled scan); "
                        "generate position-dependent data in the source "
                        "(StreamGenerator) instead")
                ratio = Fraction(n.samples_per_frame,
                                 n._ih_samples_per_frame)
                stages.append(_Stage(n, False, 0, ratio.denominator,
                                     ratio.numerator))
                # tasks with an internal block grid (e.g. the spectral-
                # kurtosis excision's n-sample decision blocks) declare
                # it via _task_granularity so scan blocks land on that
                # grid and compiled == eager decision-for-decision
                group = int(getattr(n, "_task_granularity", 1))
                constraints.append((coef_stack[-1],
                                    _lcm(ratio.denominator, group)))
                coef_stack[-1] *= ratio
                delay_stack[-1] *= ratio
                warmup_stack[-1] *= ratio
                continue
            raise ValueError(f"cannot compile node {type(n).__name__}")

        tail_coef = coef_stack[-1]
        delay = delay_stack[-1]
        warmup = max(warmup_stack[-1], delay)
        # Block at point p is coef_p * B with B the (common) source block.
        # coef_p*B must be an integer multiple of gran for each constraint
        # (n/d)*B ≡ 0 mod g  ⇔  B multiple of g·d / gcd(n, g·d).
        from math import gcd
        B = 1
        for coef, gran in constraints:
            n_, d_ = coef.numerator, coef.denominator
            B = _lcm(B, gran * d_ // gcd(n_, gran * d_))
        if pinned is not None:
            if pinned % B:
                raise ValueError(
                    f"block of {pinned} source samples does not hold "
                    f"whole groups for all rate-changing stages (need a "
                    f"multiple of {B})")
            B = pinned
        if block_samples is not None:
            # caller-chosen block (e.g. to amortize per-step dispatch
            # cost); must keep every constraint and any pinned size
            if block_samples % B or (pinned is not None
                                     and block_samples != pinned):
                raise ValueError(
                    f"block_samples={block_samples} incompatible: needs "
                    f"a multiple of {B}"
                    + (f" and padded stages pin {pinned}"
                       if pinned is not None else ""))
            B = int(block_samples)

        self.program = program
        self.stages = stages
        #: per-source extra read offset (source samples) from GetSlice
        self.source_offsets = source_offsets
        self.block_samples = B
        self._tail_coef = tail_coef
        t = tail_coef * B
        if t.denominator != 1:
            raise ValueError("tail block is not integral; incompatible "
                             "frame sizes")
        self.tail_block = int(t)
        self.delay = delay  # exact, in tail samples (may be fractional if
        #                     a rate change follows a padded stage)
        self.warmup = int(np.ceil(warmup))

        # -- packed-payload ingest ----------------------------------------
        # With packed=True, sources that expose read_packed /
        # packed_decode_fn (e.g. io/vdif.py) ship raw payload words and
        # are decoded *inside* the compiled step
        # (ops/unpack_device.py) — 4-16x fewer boundary bytes and no host
        # decode, matching the reference's decode-inside-the-pipeline
        # design (reference io/hdf5/payload.py:164-178).
        self.packed = bool(packed)
        self._decoders = [None] * len(sources)
        if packed:
            for i, (src, extra) in enumerate(zip(sources, source_offsets)):
                make = getattr(src, "packed_decode_fn", None)
                if make is None:
                    continue  # this source stays on the float path
                align = src.packed_alignment
                if self.block_samples % align or extra % align:
                    raise ValueError(
                        f"packed ingest needs frame-aligned blocks: "
                        f"block_samples {self.block_samples} and source "
                        f"offset {extra} must be multiples of the file's "
                        f"{align} samples/frame")
                self._decoders[i] = make()
            if not any(d is not None for d in self._decoders):
                raise ValueError(
                    "packed=True but no source supports packed reads "
                    "(needs read_packed/packed_decode_fn)")


    # -- the compiled step ----------------------------------------------
    def init_carry(self, planes=False):
        carries = []
        for st in self.stages:
            if isinstance(st, _Stage) and st.padded:
                shape = (st.pad,) + st.in_sample_shape
                if planes:
                    z = jnp.zeros(shape, jnp.float32)
                    carries.append(
                        (z, z if np.dtype(st.in_dtype).kind == "c"
                         else None))
                else:
                    carries.append(jnp.zeros(shape, st.in_dtype))
        return tuple(carries)

    #: node attributes holding device-resident cache arrays
    _CACHE_ATTRS = ("_chirp_cache", "_ft_response_cache", "_gain_cache",
                    "_lo_cache", "_phase_cache", "_taps", "_mat",
                    "_rel_index")

    def _prepare_caches(self):
        """Materialize lazy device caches eagerly: built inside a traced
        step they would capture tracers (chirps, response FTs, gains)."""
        for st in self.stages:
            if not isinstance(st, _Stage):
                continue
            n = st.node
            if getattr(n, "_chirp_cache", 1) is None:
                n._chirp_cache = n._chirp()
            if getattr(n, "_ft_response_cache", 1) is None:
                n._ft_response_cache = n._ft_response()
            if getattr(n, "_gain_cache", 1) is None and \
                    hasattr(n, "_make_gain"):
                n._gain_cache = n._make_gain(
                    n._padded_samples_per_frame // n._n)
            from ..utils.device import device_complex
            if getattr(n, "_lo_factor", None) is not None and \
                    getattr(n, "_lo_cache", 1) is None:
                n._lo_cache = device_complex(np.broadcast_to(
                    n._lo_factor, n.sample_shape).copy())
            if getattr(n, "_phase_factor", None) is not None and \
                    getattr(n, "_phase_cache", 1) is None:
                n._phase_cache = device_complex(np.broadcast_to(
                    n._phase_factor, n.sample_shape).copy())

    def cache_bindings(self):
        """(bindings, leaves): every device cache array of the graph, to
        be passed as explicit jit arguments.

        A device array captured as a jit *closure constant* is copied
        back to the host and embedded in the compiled program; passing
        the caches as arguments keeps them device-resident and out of
        the program.
        ``bindings`` is a list of (node, attr, treedef); ``leaves`` the
        flat tuple of arrays in matching order.
        """
        self._prepare_caches()
        bindings = []
        leaves = []
        for st in self.stages:
            if not isinstance(st, _Stage):
                continue
            n = st.node
            for attr in self._CACHE_ATTRS:
                v = getattr(n, attr, None)
                if v is None or isinstance(v, (int, float)):
                    continue
                flat, treedef = jax.tree_util.tree_flatten(v)
                if flat and all(isinstance(x, jax.Array) for x in flat):
                    bindings.append((n, attr, treedef, len(flat)))
                    leaves.extend(flat)
        return bindings, tuple(leaves)

    @staticmethod
    def _bind(bindings, leaves):
        """Context manager: temporarily set the cache attributes to
        (possibly traced) values during step tracing."""
        import contextlib

        @contextlib.contextmanager
        def ctx():
            olds = []
            i = 0
            for n, attr, treedef, k in bindings:
                olds.append(getattr(n, attr))
                setattr(n, attr, jax.tree_util.tree_unflatten(
                    treedef, list(leaves[i:i + k])))
                i += k
            try:
                yield
            finally:
                for (n, attr, _, _), old in zip(bindings, olds):
                    setattr(n, attr, old)

        return ctx()

    def cached_step(self):
        """(step_c, cache_leaves): like :meth:`step_fn`, but the step
        takes the flat cache tuple as a third argument so callers can
        thread it through jit boundaries:

            step_c, caches = cp.cached_step()
            @jax.jit
            def run(blocks, *caches):
                carry, ys = lax.scan(
                    lambda c, x: step_c(c, x, caches), carry0, blocks)
            run(blocks, *caches)
        """
        step = self.step_fn()
        bindings, leaves = self.cache_bindings()

        def step_c(carry, x, caches):
            with self._bind(bindings, caches):
                return step(carry, x)

        return step_c, leaves

    def step_fn(self, pad_hook=None):
        """(carry, blocks) -> (carry, out_block), jittable.

        ``blocks`` is a single source block for single-source graphs, or
        a tuple of blocks (program input order) for multi-source graphs.

        ``pad_hook(stage, carry_entry, x) -> (window, new_carry_entry)``
        overrides how a padded stage assembles its overlap-save window
        from the carried history and the new block — the sharded
        executor (models/sharded.py) substitutes a ppermute halo
        exchange here; the default is the single-device concatenate.
        """
        self._prepare_caches()
        stages = self.stages
        program = self.program
        multi = len(self.sources) > 1

        def default_hook(st, c, x):
            window = jnp.concatenate([c, x], axis=0)
            return window, (window[-st.pad:] if st.pad else window[:0])

        hook = pad_hook if pad_hook is not None else default_hook

        decoders = self._decoders

        def step(carry, xs):
            inputs = xs if multi else (xs,)
            stack = []
            new_carry = []
            ci = 0
            si = 0
            for kind, *rest in program:
                if kind == "input":
                    x = inputs[rest[0]]
                    dec = decoders[rest[0]]
                    stack.append(dec(x) if dec is not None else x)
                    continue
                st = stages[si]
                si += 1
                if isinstance(st, _CombineStage):
                    args = stack[-st.k:]
                    del stack[-st.k:]
                    stack.append(st.node.task(list(args)))
                    continue
                if isinstance(st.node, (SetAttribute, GetSlice)):
                    continue
                fn = st.node
                x = stack.pop()
                if st.padded:
                    window, nc = hook(st, carry[ci], x)
                    new_carry.append(nc)
                    ci += 1
                    x = fn.task(window)
                else:
                    x = fn.task(x)
                stack.append(x)
            return tuple(new_carry), stack[-1]

        return step

    # -- planes-interchange step ------------------------------------------
    def planes_step(self):
        """(carry, xs, scale) -> (carry, (yr, yi)): the step with values
        flowing as separate float32 re/im planes.

        A plane pair is ``(re, im)`` with ``im = None`` for real streams.
        Stages that implement ``task_planes`` (real-linear FIRs, Faraday
        rotation) run on the planes directly; any other
        stage goes through one complex recombination.  ``scale`` (scalar
        or None) multiplies the input of the first compute stage, so
        benchmark-style per-iteration variation needs no separate pass.
        """
        self._prepare_caches()
        if any(d is not None for d in self._decoders):
            raise NotImplementedError(
                "packed ingest is not wired into the planes-interchange "
                "step; use the normal step")
        stages = self.stages
        program = self.program
        multi = len(self.sources) > 1

        def to_pair(x):
            if isinstance(x, tuple):
                return x
            x = jnp.asarray(x)
            if jnp.iscomplexobj(x):
                return jnp.real(x), jnp.imag(x)
            return x, None

        def to_complex(pair):
            re, im = pair
            return re if im is None else jax.lax.complex(re, im)

        def scaled(pair, s):
            if s is None:
                return pair
            return (pair[0] * s, None if pair[1] is None else pair[1] * s)

        def step(carry, xs, scale=None):
            inputs = xs if multi else (xs,)
            stack = []
            new_carry = []
            ci = 0
            si = 0
            pending_scale = scale
            for kind, *rest in program:
                if kind == "input":
                    stack.append(to_pair(inputs[rest[0]]))
                    continue
                st = stages[si]
                si += 1
                if isinstance(st, _CombineStage):
                    args = [to_complex(p) for p in stack[-st.k:]]
                    del stack[-st.k:]
                    if pending_scale is not None:
                        args = [a * pending_scale for a in args]
                        pending_scale = None
                    stack.append(to_pair(st.node.task(args)))
                    continue
                if isinstance(st.node, (SetAttribute, GetSlice)):
                    continue
                fn = st.node
                x = stack.pop()
                if st.padded:
                    c = carry[ci]
                    ci += 1
                    x = scaled(x, pending_scale)
                    pending_scale = None
                    wr = jnp.concatenate([c[0], x[0]], axis=0)
                    wi = None if x[1] is None else \
                        jnp.concatenate([jnp.zeros_like(c[0])
                                         if c[1] is None else c[1],
                                         x[1]], axis=0)
                    pad = st.pad
                    new_carry.append(
                        (wr[-pad:], None if wi is None else wi[-pad:])
                        if pad else (wr[:0], None if wi is None
                                     else wi[:0]))
                    x = (wr, wi)
                else:
                    x = scaled(x, pending_scale)
                    pending_scale = None
                y = NotImplemented
                planes_fn = getattr(fn, "task_planes", None)
                if planes_fn is not None:
                    y = planes_fn(x)
                if y is NotImplemented:
                    y = to_pair(fn.task(to_complex(x)))
                stack.append(y)
            return tuple(new_carry), stack[-1]

        return step

    def cached_planes_step(self):
        """(step_c, cache_leaves) for :meth:`planes_step`, with the
        device caches as explicit arguments (see :meth:`cached_step`):

            step_c(carry, xs, scale, caches)
        """
        step = self.planes_step()
        bindings, leaves = self.cache_bindings()

        def step_c(carry, xs, scale, caches):
            with self._bind(bindings, caches):
                return step(carry, xs, scale)

        return step_c, leaves

    # -- reduction (Integrate / Fold / PulseStack) -----------------------
    def _segment_ids(self, start, n):
        """Flat segment id per *eager-timeline* tail sample in
        [start, start+n), computed on the host at full (two-double) phase
        precision (reference integration.py:174-228,380-395).  Samples
        outside every bin (incl. negative warmup indices) get id
        ``n_segments`` — a trash segment dropped on device.  Returns
        (ids_int64, n_segments)."""
        red = self.reduction
        sample = np.arange(start, start + n, dtype=np.int64)
        rel = sample - red._ih_start
        fine = red.n_phase if _pulse_like(red) else 1
        edges = red._get_offsets(np.arange(red.shape[0] * fine + 1))
        time_bins = np.searchsorted(edges, rel, side="right") - 1
        n_time = len(edges) - 1
        valid = (rel >= edges[0]) & (rel < edges[-1])
        time_bins = np.clip(time_bins, 0, n_time - 1)
        if _fold_like(red):
            ih = red.ih
            ih_rate = ih.sample_rate.to_value(u.Hz)
            t0 = ih._tell_time(red._ih_start)
            t = t0 + u.Quantity(rel / ih_rate, u.s)
            from ..integration import _phase_to_cycles
            hi, lo = _phase_to_cycles(red._phase(t))
            frac = (hi - np.floor(hi)) + lo
            frac = frac - np.floor(frac)
            phase_bins = np.minimum((frac * red.n_phase).astype(np.int64),
                                    red.n_phase - 1)
            ids = time_bins * red.n_phase + phase_bins
            n_seg = n_time * red.n_phase
        else:
            ids = time_bins
            n_seg = n_time
        ids = np.where(valid, ids, n_seg)
        return ids, n_seg

    def segment_ids_f(self, n_blocks, tail_offset=0):
        """Device-ready per-block segment-id planes for the absorbed
        reduction: ``(ids_f, n_seg)`` with ``ids_f`` of shape
        ``(n_blocks, tail_block, 1 or 2)`` float32 (ids >= 2^24 ship as
        an exact 12-bit hi/lo split).  ``tail_offset`` shifts the eager
        timeline by whole tail samples (for resumed runs)."""
        ids_f, n_seg = self.segment_ids_np(n_blocks, tail_offset)
        return jnp.asarray(ids_f), n_seg

    def segment_ids_np(self, n_blocks, tail_offset=0):
        """:meth:`segment_ids_f`'s planes kept on the host (numpy), for
        consumers that ship them block by block (StreamRunner)."""
        if self.delay != int(self.delay):
            raise ValueError(
                "cannot absorb a reduction after a fractional-delay "
                "chain; choose frame sizes with integral delay")
        ids, n_seg = self._segment_ids(tail_offset - int(self.delay),
                                       n_blocks * self.tail_block)
        # samples still inside the carry warmup map to valid eager
        # indices but hold garbage — trash them.  From tail_offset 0 the
        # first ``delay`` samples already land at negative eager indices
        # (invalid); a resumed run starts with fresh carries, so its full
        # ``warmup`` window is garbage.
        w_extra = (self.warmup - int(self.delay) if tail_offset == 0
                   else self.warmup)
        if w_extra > 0:
            ids = ids.copy()
            ids[:w_extra] = n_seg
        ids2 = ids.reshape(n_blocks, self.tail_block)
        if n_seg < (1 << 24):
            ids_f = ids2.astype(np.float32)[..., np.newaxis]
        else:
            ids_f = np.stack([(ids2 >> 12).astype(np.float32),
                              (ids2 & 0xFFF).astype(np.float32)],
                             axis=-1)
        return ids_f, n_seg

    def run_fn(self, n_blocks):
        """Jitted scan over ``n_blocks`` source blocks.

        Without a reduction, returns ``run(blocks) -> out`` where
        ``blocks`` has shape ``(n_blocks, block_samples) + sample_shape``
        per source (a tuple of such stacks for multi-source graphs) and
        ``out`` is the concatenated tail-rate output.

        With an absorbed reduction, returns
        ``run(blocks) -> (sums, counts)`` with the same bin layout as the
        eager node's non-averaged read ((bins, [n_phase,] ...) data and
        counts); averaging divides afterwards (`run_reduced` does both).

        The returned closure (and its jit executable) is cached per
        ``n_blocks``, so repeated calls with the same block count reuse
        one compile and one segment-id table.
        """
        cached = self._run_cache.get(int(n_blocks))
        if cached is not None:
            return cached
        step_c, cache_leaves = self.cached_step()
        red = self.reduction

        if red is None:
            @jax.jit
            def jrun(blocks, *caches):
                carry = self.init_carry()
                carry, ys = jax.lax.scan(
                    lambda c, x: step_c(c, x, caches), carry, blocks)
                return ys.reshape((-1,) + ys.shape[2:])

            fn = lambda blocks: jrun(blocks, *cache_leaves)  # noqa: E731
            self._run_cache[int(n_blocks)] = fn
            return fn

        # host-precomputed per-block segment ids (float32 planes).
        # Compiled sample k is eager sample k - delay; warmup samples
        # land in the trash bin.
        ids_f, n_seg = self.segment_ids_f(n_blocks)
        sample_shape = self._tail.sample_shape
        update = make_reduction_update(red)

        def red_step(carry, xs, caches):
            data_carry, sums, counts = carry[:-2], carry[-2], carry[-1]
            blocks, idf = xs
            new_carry, y = step_c(data_carry, blocks, caches)
            sums, counts = update(sums, counts, y,
                                  decode_segment_ids(idf))
            return new_carry + (sums, counts), 0

        @jax.jit
        def jrun(blocks, ids, *caches):
            carry = self.init_carry() + init_reduction_acc(
                red, sample_shape, n_seg)
            carry, _ = jax.lax.scan(
                lambda c, x: red_step(c, x, caches), carry,
                (blocks, ids))
            sums, counts = carry[-2], carry[-1]
            return (self._shape_reduced(sums[:-1]),
                    self._shape_reduced_counts(counts[:-1]))

        fn = lambda blocks: jrun(blocks, ids_f, *cache_leaves)  # noqa: E731
        self._run_cache[int(n_blocks)] = fn
        return fn

    def _shape_reduced(self, sums):
        red = self.reduction
        if _fold_like(red):
            return sums.reshape((-1, red.n_phase) + sums.shape[1:])
        if _pulse_like(red):
            return sums.reshape((-1, red.n_phase) + sums.shape[1:])
        return sums

    def _shape_reduced_counts(self, counts):
        red = self.reduction
        if _fold_like(red) or _pulse_like(red):
            # masked reductions carry per-cell counts (sample shape)
            return counts.reshape((-1, red.n_phase) + counts.shape[1:])
        return counts

    def run_reduced(self, blocks):
        """Run with the absorbed reduction and return what the eager
        node's averaged ``read`` would: sums/counts (or plain sums when
        ``average=False`` semantics are wanted, use :meth:`run_fn`)."""
        if self.reduction is None:
            raise ValueError("no reduction to run")
        if len(self.sources) == 1:
            blocks = self._prep_blocks(blocks, 0)
            n_blocks = self._stack_len(blocks)
        else:
            blocks = tuple(self._prep_blocks(b, i)
                           for i, b in enumerate(blocks))
            n_blocks = self._stack_len(blocks[0])
        sums, counts = self.run_fn(n_blocks)(blocks)
        shaped = counts[(...,) + (None,) * (sums.ndim - counts.ndim)]
        out = sums / jnp.maximum(shaped, 1)
        if bool(getattr(self.reduction, "_masked", False)):
            # fully-flagged cells: NaN, matching the eager node (see
            # integration.py Integrate._read_frame)
            out = jnp.where(shaped > 0, out, jnp.nan)
        return out, counts

    def _prep_blocks(self, blocks, i):
        """Normalize one source's block stack (packed pytree or array)."""
        if self._decoders[i] is not None:
            return jax.tree.map(jnp.asarray, blocks)
        return jnp.asarray(blocks)

    @staticmethod
    def _stack_len(prepped):
        return jax.tree.leaves(prepped)[0].shape[0]

    def run_blocks(self, blocks):
        """Convenience: run the compiled graph over stacked source blocks
        (a tuple of stacks for multi-source graphs; packed sources take
        ``(carrier, mask)`` stacks from :meth:`read_source_blocks`)."""
        if len(self.sources) > 1:
            blocks = tuple(self._prep_blocks(b, i)
                           for i, b in enumerate(blocks))
            return self.run_fn(self._stack_len(blocks[0]))(blocks)
        blocks = self._prep_blocks(blocks, 0)
        return self.run_fn(self._stack_len(blocks))(blocks)

    def read_source_blocks(self, n_blocks, offset=0):
        """Read ``n_blocks`` blocks from the graph's source stream(s),
        stacked for :meth:`run_blocks` (a tuple for multi-source).

        Packed sources (``packed=True``) come back as ``(carrier, mask)``
        stacks of raw payload carriers — no host decode happens here.
        """
        B = self.block_samples
        stacks = []
        for i, (src, extra) in enumerate(zip(self.sources,
                                             self.source_offsets)):
            if self._decoders[i] is not None:
                packs = [src.read_packed(extra + offset + k * B, B)
                         for k in range(n_blocks)]
                stacks.append(jax.tree.map(
                    lambda *xs: jnp.stack(xs), *packs))
                continue
            src.seek(extra + offset)
            stacks.append(jnp.stack(
                [jnp.asarray(src.read(B)) for _ in range(n_blocks)]))
        return tuple(stacks) if len(stacks) > 1 else stacks[0]


class _CombineStage:
    __slots__ = ("node", "k")

    def __init__(self, node, k):
        self.node = node
        self.k = k


def _fold_like(red):
    return isinstance(red, Fold)


def _pulse_like(red):
    from ..integration import PulseStack
    return isinstance(red, PulseStack)
