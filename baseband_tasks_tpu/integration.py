"""Integration over time or pulse phase; pulsar folding and pulse stacks.

Counterpart of `/root/reference/baseband_tasks/integration.py` (``Integrate``
integration.py:52, ``Fold`` integration.py:306, ``PulseStack``
integration.py:398).

Device-side redesign of the binning machinery: the reference pushes input
frames through ``np.add.reduceat``/``np.add.at`` host scatter loops (the
``_FakeOutput`` trick, integration.py:18-39); here each input piece gets
per-sample bin indices from static arithmetic and is reduced with
``jax.ops.segment_sum`` on device — while the variable-bin bookkeeping
(phase → offset inversion)
stays on the host at frame granularity, as SURVEY.md §7 prescribes.
"""

from __future__ import annotations

import operator
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from .base import BaseTaskBase
from .utils import Time, units as u

__all__ = ["is_index", "Integrate", "Fold", "PulseStack", "Stack"]


def is_index(n):
    """Whether ``n`` is usable as an integer index (reference
    integration.py:42-49)."""
    try:
        operator.index(n)
    except TypeError:
        return False
    return True


class _FakeOutput:
    """Output-shaped object whose item assignment calls a function.

    Passed as ``out=`` to ``ih.read`` so each underlying frame piece is
    binned as it is produced, without materializing the full input range
    (reference integration.py:18-39).
    """

    def __init__(self, setitem, first_sample):
        self._setitem = setitem
        self._first = first_sample

    def __setitem__(self, item, data):
        # item is a slice local to the current read; make it global.
        start = item.start if isinstance(item, slice) else item
        self._setitem(self._first + (start or 0), data)


#: module-level jit (a per-call wrapper would retrace every frame)
def _fetch_counts(dev_counts):
    """Device int32 piece counts -> host int64."""
    return np.asarray(dev_counts).astype(np.int64)


def _phase_to_cycles(ph):
    """Coerce a phase callable's result to float64 cycles (host array)."""
    try:
        from .phases import Phase
    except ImportError:  # phases subsystem optional at this layer
        Phase = ()
    if Phase and isinstance(ph, Phase):
        return ph.cycle_pair
    if isinstance(ph, u.Quantity):
        val = np.asarray(ph.to_value(u.cycle), dtype=np.float64)
        return val, np.zeros_like(val)
    val = np.asarray(ph, dtype=np.float64)
    return val, np.zeros_like(val)


class Integrate(BaseTaskBase):
    """Integrate a stream in steps of time, samples, or pulse phase.

    Parameters
    ----------
    ih : stream
        Input handle.
    step : int, Quantity, optional
        Bin size: integer number of input samples, a time Quantity, or a
        phase Quantity in cycles (requires ``phase``).  Default: the whole
        stream in one bin.
    phase : callable, optional
        Maps :class:`~baseband_tasks_tpu.utils.Time` (array) to phase
        (Quantity in cycles or :class:`~baseband_tasks_tpu.phases.Phase`).
    start : Time or int, optional
        Start of the first bin (default: current/start of stream).
    average : bool
        If True (default) divide sums by counts; else ``read`` returns a
        structured array with ``data`` and ``count`` fields.
    masked : bool
        If True, non-finite input cells (NaN from upstream flagging,
        e.g. ``ExciseSpectralKurtosis(fill=nan)``) are excluded per
        *cell*: counts gain the sample shape and averages stay unbiased
        where data was excised.  Beyond the reference (whose counts are
        per time bin only, integration.py:154-160).
    samples_per_frame : int
        Output bins per frame.
    """

    def __init__(self, ih, step=None, phase=None, *, start=0, average=True,
                 masked=False, samples_per_frame=1, dtype=None):
        self._masked = bool(masked)
        self.ih = ih
        if isinstance(start, Time):
            ih_start = ih.seek(start)
        else:
            ih_start = operator.index(start)
        if not 0 <= ih_start <= ih.shape[0]:
            # explicit bound check like the reference (integration.py:113);
            # seek itself allows out-of-range pointers (start == end is a
            # legal zero-length window, as in the reference)
            raise ValueError("'start' is not within the underlying stream.")
        self._ih_start = ih_start
        n_avail = ih.shape[0] - ih_start

        self._phase = phase
        self._average = bool(average)

        # Decide the stepping mode.
        if step is None:
            if phase is None:
                mode = "sample"
                step = n_avail
            else:
                raise ValueError("phase integration needs an explicit step "
                                 "in cycles.")
        elif isinstance(step, u.Quantity):
            if step.unit.is_equivalent(u.s):
                mode = "time"
            elif step.unit.is_equivalent(u.cycle):
                if phase is None:
                    raise ValueError("step in cycles requires a phase "
                                     "callable.")
                mode = "phase"
            else:
                raise ValueError(f"cannot step by {step.unit}")
        else:
            mode = "sample"
            step = operator.index(step)
        self._mode = mode
        self._step = step

        ih_rate = ih.sample_rate.to_value(u.Hz)
        if mode == "sample":
            self._samples_per_bin = float(step)
            n_bins = n_avail // step
            sample_rate = ih.sample_rate / step
        elif mode == "time":
            spb = step.to_value(u.s) * ih_rate
            self._samples_per_bin = spb
            n_bins = int(np.floor(n_avail / spb + 1e-9))
            sample_rate = 1.0 / step
        else:  # phase
            # Evaluate phase at stream start/end to bound the bin count and
            # get a mean spin rate for the iterative inversion.
            t_first = ih._tell_time(ih_start)
            t_last = ih._tell_time(ih.shape[0])
            ph0_hi, ph0_lo = _phase_to_cycles(phase(t_first))
            ph1_hi, ph1_lo = _phase_to_cycles(phase(t_last))
            self._phase0 = (float(ph0_hi), float(ph0_lo))
            total_cycles = (ph1_hi - ph0_hi) + (ph1_lo - ph0_lo)
            step_cyc = float(step.to_value(u.cycle))
            self._step_cycles = step_cyc
            n_bins = int(np.floor(total_cycles / step_cyc))
            self._mean_f = total_cycles / ((t_last - t_first).sec)  # Hz
            sample_rate = 1.0 / step
        if n_bins < 1:
            raise ValueError("stream too short for even one integration bin")

        n_frames, extra = divmod(n_bins, samples_per_frame)
        if n_frames == 0:
            samples_per_frame = n_bins
            n_frames, extra = 1, 0

        super().__init__(
            ih, shape=(n_bins,) + ih.sample_shape,
            sample_rate=sample_rate,
            samples_per_frame=samples_per_frame,
            start_time=ih._tell_time(ih_start),
            dtype=dtype)
        self._sum_dtype = np.dtype(self._dtype)  # complex stays complex
        self._count_dtype = np.int32
        self._out_dtype = np.dtype(
            {"names": ["data", "count"],
             "formats": [self._sum_dtype, self._count_dtype]})

    @property
    def average(self):
        return self._average

    @property
    def dtype(self):
        return self._sum_dtype if self._average else self._out_dtype

    def _tell_time(self, offset):
        if self._mode == "phase":
            offsets = self._get_offsets(np.array([offset], dtype=np.float64))
            return self.ih._tell_time(self._ih_start + int(offsets[0]))
        return self.ih._tell_time(
            self._ih_start + int(round(offset * self._samples_per_bin)))

    # -- bin-edge → input-offset mapping --------------------------------
    def _get_offsets(self, bins):
        """Input sample offsets (relative to _ih_start) of given bin edges."""
        bins = np.asarray(bins, dtype=np.float64)
        if self._mode != "phase":
            n_avail = self.ih.shape[0] - self._ih_start
            # the bin-count floor uses a small fudge, so the last edge
            # can land one sample past the stream: clamp
            return np.minimum(
                np.round(bins * self._samples_per_bin).astype(np.int64),
                n_avail)
        # Iterative inversion of the phase model (reference
        # integration.py:174-228): find t with phase(t) = phase0 + b*step.
        ih_rate = self.ih.sample_rate.to_value(u.Hz)
        target = bins * self._step_cycles  # cycles since phase0
        offsets = target * (ih_rate / self._mean_f)
        t0 = self.ih._tell_time(self._ih_start)
        max_offset = self.ih.shape[0] - self._ih_start
        # Tolerance, all in cycles: 1e-9 of a step, plus the phase
        # advanced in 1e-3 input sample (cycles/sample = mean_f / rate).
        cycles_per_sample = self._mean_f / ih_rate
        tol_cycles = 1e-9 * self._step_cycles + 1e-3 * cycles_per_sample
        for _ in range(10):
            offsets = np.clip(offsets, 0.0, float(max_offset))
            t = t0 + u.Quantity(offsets / ih_rate, u.s)
            hi, lo = _phase_to_cycles(self._phase(t))
            achieved = (hi - self._phase0[0]) + (lo - self._phase0[1])
            err = target - achieved
            if np.all(np.abs(err) < tol_cycles):
                break
            offsets = offsets + err / cycles_per_sample
        else:
            # residual in input samples: err [cycles] / (cycles/sample)
            if np.any(np.abs(err) / cycles_per_sample > 0.5):
                warnings.warn("phase-to-offset inversion did not converge "
                              "to within half a sample.")
        out = np.round(np.clip(offsets, 0, max_offset)).astype(np.int64)
        # Bin edges must be non-decreasing even when some targets are
        # unreachable (phase glitch/discontinuity): oscillating estimates
        # would corrupt the searchsorted binning downstream.  Clamp
        # unreachable edges to the last reachable offset.
        if out.ndim:
            out = np.maximum.accumulate(out)
        return out

    # -- frame computation ----------------------------------------------
    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        bin0 = frame_index * spf
        n_bins = min(spf, self._shape[0] - bin0)
        return self._integrate_bins(bin0, n_bins)

    def _integrate_bins(self, bin0, n_bins):
        """Accumulate ``n_bins`` bins starting at ``bin0`` on the
        step grid.  Explicit geometry (instead of deriving it from
        ``_shape``/``_samples_per_frame``) keeps this reentrant, so
        subclasses with a different output layout (PulseStack's
        (pulse, phase) frames) can delegate without mutating state."""
        edges = self._get_offsets(bin0 + np.arange(n_bins + 1))
        start, stop = int(edges[0]), int(edges[-1])
        edges = edges - start

        sums = jnp.zeros((n_bins,) + self.ih.sample_shape, self._acc_dtype())
        # device pieces count in int32; the running total accumulates on
        # the host in int64, so bins beyond 2^31 samples cannot wrap
        counts = np.zeros((n_bins,) + (self.ih.sample_shape
                                       if self._masked else ()), np.int64)
        state = [sums, counts]

        def accumulate(first, data):
            idx0 = first - start
            piece_np = np.clip(
                np.searchsorted(edges, idx0 + np.arange(len(data)),
                                side="right") - 1, 0, n_bins - 1)
            piece_bins = jnp.asarray(piece_np.astype(np.int32))
            d = jnp.asarray(data)
            if self._masked:
                valid = jnp.isfinite(d)
                d = jnp.where(valid, d, 0)
                state[1] = state[1] + _fetch_counts(
                    jax.ops.segment_sum(valid.astype(jnp.int32),
                                        piece_bins, num_segments=n_bins))
            else:
                # counts are known on the host: tally there in int64
                state[1] = state[1] + np.bincount(piece_np,
                                                  minlength=n_bins)
            state[0] = state[0] + jax.ops.segment_sum(
                d.astype(self._acc_dtype()), piece_bins,
                num_segments=n_bins)

        fake = _FakeOutput(accumulate, first_sample=start)
        self.ih.seek(self._ih_start + start)
        self.ih.read(stop - start, out=fake)
        sums, counts = state

        if self._average:
            shape_count = counts if self._masked else counts.reshape(
                (n_bins,) + (1,) * len(self.ih.sample_shape))
            # divide on the host: feeding the int64 tally to jnp under
            # x32 would truncate it to int32 (wrapping beyond 2^31)
            out = np.asarray(sums) / np.maximum(shape_count, 1)
            if self._masked:
                # a fully-flagged cell has no data at all: NaN, not a
                # silent 0.0 masquerading as measured zero power (the
                # NaN also re-flags the cell for downstream masked
                # consumers)
                out = np.where(shape_count > 0, out, np.nan)
            return out.astype(self._sum_dtype)
        result = np.zeros((n_bins,) + self.ih.sample_shape, self._out_dtype)
        result["data"] = np.asarray(sums).astype(self._sum_dtype)
        result["count"] = np.asarray(counts) if self._masked else \
            np.asarray(counts)[
                (slice(None),) + (None,) * len(self.ih.sample_shape)]
        return result

    def _acc_dtype(self):
        # With x64 enabled, honor 64-bit stream dtypes; with x64 off
        # (the default) these canonicalize to 32-bit anyway.
        if self._sum_dtype.itemsize >= 8 and \
                jax.dtypes.canonicalize_dtype(np.float64) == np.float64:
            return jnp.complex128 if self._sum_dtype.kind == "c" \
                else jnp.float64
        return jnp.complex64 if self._sum_dtype.kind == "c" else jnp.float32


class Fold(Integrate):
    """Fold a stream on a pulsar phase model.

    Output sample shape gains a leading phase axis of ``n_phase`` bins;
    each time step accumulates samples into the phase bin of their
    (fractional) model phase (reference integration.py:306-395).
    """

    def __init__(self, ih, n_phase, phase, step=None, *, start=0,
                 average=True, masked=False, samples_per_frame=1,
                 dtype=None):
        self._n_phase = operator.index(n_phase)
        if isinstance(step, u.Quantity) and step.unit.is_equivalent(u.cycle):
            raise ValueError("Fold steps in time; use PulseStack for "
                             "phase-stepped profiles.")
        super().__init__(ih, step=step, phase=None,
                         start=start, average=average, masked=masked,
                         samples_per_frame=samples_per_frame, dtype=dtype)
        # Fold always needs the phase callable for binning, even when
        # stepping in time.
        self._phase = phase
        self._shape = (self._shape[0], self._n_phase) + self.ih.sample_shape
        self._out_dtype = np.dtype(
            {"names": ["data", "count"],
             "formats": [self._sum_dtype, self._count_dtype]})

    @property
    def n_phase(self):
        return self._n_phase

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        bin0 = frame_index * spf
        n_bins = min(spf, self._shape[0] - bin0)
        edges = self._get_offsets(bin0 + np.arange(n_bins + 1))
        start, stop = int(edges[0]), int(edges[-1])
        edges_local = edges - start
        n_phase = self._n_phase
        ih_rate = self.ih.sample_rate.to_value(u.Hz)
        t0 = self.ih._tell_time(self._ih_start)

        total = n_bins * n_phase
        sums = jnp.zeros((total,) + self.ih.sample_shape, self._acc_dtype())
        # like Integrate: tally counts on the host in int64, so a
        # (time, phase) cell beyond 2^31 samples cannot wrap
        counts = np.zeros((total,) + (self.ih.sample_shape
                                      if self._masked else ()), np.int64)
        state = [sums, counts]

        def accumulate(first, data):
            idx0 = first - start
            n = len(data)
            sample_idx = idx0 + np.arange(n)
            time_bins = np.searchsorted(edges_local, sample_idx,
                                        side="right") - 1
            time_bins = np.clip(time_bins, 0, n_bins - 1)
            # Phase of each sample (host, f64 two-double safe).
            t = t0 + u.Quantity((start + sample_idx) / ih_rate, u.s)
            hi, lo = _phase_to_cycles(self._phase(t))
            frac = (hi - np.floor(hi)) + lo
            frac = frac - np.floor(frac)
            phase_bins = np.minimum((frac * n_phase).astype(np.int64),
                                    n_phase - 1)
            flat_np = (time_bins * n_phase + phase_bins).astype(np.int64)
            flat = jnp.asarray(flat_np.astype(np.int32))
            d = jnp.asarray(data)
            if self._masked:
                valid = jnp.isfinite(d)
                d = jnp.where(valid, d, 0)
                state[1] = state[1] + _fetch_counts(
                    jax.ops.segment_sum(valid.astype(jnp.int32), flat,
                                        num_segments=total))
            else:
                state[1] = state[1] + np.bincount(flat_np, minlength=total)
            state[0] = state[0] + jax.ops.segment_sum(
                d.astype(self._acc_dtype()), flat, num_segments=total)

        fake = _FakeOutput(accumulate, first_sample=start)
        self.ih.seek(self._ih_start + start)
        self.ih.read(stop - start, out=fake)
        sums = state[0].reshape((n_bins, n_phase) + self.ih.sample_shape)
        counts = state[1].reshape((n_bins, n_phase)
                                  + (self.ih.sample_shape
                                     if self._masked else ()))

        if self._average:
            shaped = counts if self._masked else counts[
                (...,) + (None,) * len(self.ih.sample_shape)]
            # host division (int64 counts must not pass through x32 jnp)
            out = np.asarray(sums) / np.maximum(shaped, 1)
            if self._masked:
                # fully-flagged (time, phase) cells: NaN (see Integrate)
                out = np.where(shaped > 0, out, np.nan)
            return out.astype(self._sum_dtype)
        result = np.zeros((n_bins, n_phase) + self.ih.sample_shape,
                          self._out_dtype)
        result["data"] = np.asarray(sums).astype(self._sum_dtype)
        result["count"] = np.asarray(counts) if self._masked else \
            np.asarray(counts)[
                (...,) + (None,) * len(self.ih.sample_shape)]
        return result


class PulseStack(Integrate):
    """Stack of single-pulse profiles: integrate in phase steps of
    ``1/n_phase`` cycle and reshape to (pulse, phase) (reference
    integration.py:398-474)."""

    def __init__(self, ih, n_phase, phase, *, start=0, average=True,
                 masked=False, samples_per_frame=1, dtype=None):
        self._n_phase = operator.index(n_phase)
        super().__init__(ih, step=u.Quantity(1.0 / n_phase, u.cycle),
                         phase=phase, start=start, average=average,
                         masked=masked,
                         samples_per_frame=samples_per_frame * n_phase,
                         dtype=dtype)
        n_pulse = self._shape[0] // n_phase
        self._shape = (n_pulse, self._n_phase) + self.ih.sample_shape
        # One output sample = one full pulse.
        self._sample_rate = self._sample_rate / n_phase
        self._samples_per_frame = max(self._samples_per_frame // n_phase, 1)

    @property
    def n_phase(self):
        return self._n_phase

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        pulse0 = frame_index * spf
        n_pulse = min(spf, self._shape[0] - pulse0)
        # Delegate to Integrate on the fine (phase-step) bin grid.
        frame = self._integrate_bins(pulse0 * self._n_phase,
                                     n_pulse * self._n_phase)
        return frame.reshape((n_pulse, self._n_phase)
                             + self.ih.sample_shape)

    def _tell_time(self, offset):
        return Integrate._tell_time(self, offset * self._n_phase)


def Stack(*args, **kwargs):
    """Deprecated alias of :class:`PulseStack` (reference
    integration.py:480-482)."""
    warnings.warn("Stack is deprecated; use PulseStack.", DeprecationWarning)
    return PulseStack(*args, **kwargs)
