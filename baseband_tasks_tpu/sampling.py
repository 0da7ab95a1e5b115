"""Time-shifting and resampling tasks.

Counterpart of `/root/reference/baseband_tasks/sampling.py`
(``ShiftAndResample`` sampling.py:63, ``Resample`` sampling.py:230,
``TimeDelay`` sampling.py:315, ``ShiftSamples`` sampling.py:380).

Fractional delays use a Hann-windowed sinc interpolation kernel of
half-width ``pad`` (default 64, better than 0.1% accurate, cf. reference
sampling.py:108-109) applied through the FFT overlap-save machinery; pure
integer shifts use a per-channel gather.  Positive shift delays the signal
(a feature at time t appears at t + shift).
"""

from __future__ import annotations

import operator

import jax
import jax.numpy as jnp
import numpy as np

from .base import PaddedTaskBase, getattr_if_none
from .convolution import Convolve
from .utils import Time, units as u
from .utils.device import device_complex

__all__ = ["ShiftAndResample", "Resample", "TimeDelay", "ShiftSamples",
           "seek_float", "to_sample"]


def to_sample(ih, offset):
    """A (possibly time-unit) offset in units of samples of ``ih``
    (reference sampling.py:17-20)."""
    if isinstance(offset, u.Quantity):
        if offset.unit.is_equivalent(u.s):
            return np.asarray(offset.to_value(u.s)) \
                * ih.sample_rate.to_value(u.Hz)
        return np.asarray(offset.to_value(u.one), dtype=np.float64)
    return np.asarray(offset, dtype=np.float64)


def seek_float(ih, offset, whence=0):
    """Convert a possibly-quantity offset to a float number of samples."""
    if isinstance(offset, Time):
        dt = offset - ih.start_time
        hi, lo = dt.sec_pair
        rate = ih.sample_rate.to_value(u.Hz)
        return hi * rate + lo * rate
    if isinstance(offset, u.Quantity):
        if offset.unit.is_equivalent(u.s):
            offset = offset.to_value(u.s) * ih.sample_rate.to_value(u.Hz)
        else:
            offset = np.asarray(offset.to_value(u.one))
    offset = np.asarray(offset, dtype=np.float64)
    if whence in (1, "current"):
        offset = offset + ih.tell()
    elif whence in (2, "end"):
        offset = offset + ih.shape[0]
    elif whence not in (0, "start"):
        raise ValueError("invalid 'whence'")
    return offset


class ShiftAndResample(Convolve):
    """Shift a stream by (possibly per-channel, fractional) amounts and
    resample onto a (possibly offset-anchored) grid.

    Parameters
    ----------
    ih : stream
        Input (complex or real).
    shift : array-like or Quantity
        Delay per channel: time Quantity or number of samples; broadcastable
        against the sample shape.  Positive delays the signal.
    offset : Time, Quantity or float, optional
        Anchor: ensure an output sample lands exactly on this input-stream
        offset (plus integer sample counts).  Default: shift the output
        grid by the *mean* shift, so only the per-channel residuals are
        interpolated (a uniform shift is then a pure relabelling with no
        interpolation error — reference sampling.py:147-175 semantics).
    lo : Quantity, optional
        Local-oscillator frequency for complex baseband data: after a time
        shift dt the data are rotated by exp(-2j pi lo dt sideband) so sky
        phases stay coherent (reference sampling.py:211-220).  Requires
        ``sideband`` (from the stream or explicit).
    pad : int
        Half-width of the interpolation kernel (default 64).
    """

    def __init__(self, ih, shift, offset=None, whence=0, *, lo=None,
                 pad=64, samples_per_frame=None, sideband=None):
        shift_samples = to_sample(ih, shift)
        # Output-grid shift d_time (in input samples): by default the mean
        # shift — so only per-channel residuals are interpolated; with an
        # anchor, the nearest value congruent to ``offset`` (mod 1), so an
        # output sample lands exactly on the requested offset (reference
        # sampling.py:151-175).
        mean_shift = float(np.mean(shift_samples))
        if offset is not None:
            off_f = float(np.mean(seek_float(ih, offset, whence)))
            d_time = off_f + float(np.round(mean_shift - off_f))
        else:
            d_time = mean_shift
        self._grid_offset = d_time
        # Effective per-channel delay relative to the shifted grid.
        eff = np.atleast_1d(shift_samples - d_time)
        k_min = int(np.floor(eff.min())) - pad + 1
        k_max = int(np.floor(eff.max())) + pad
        k = np.arange(k_min, k_max + 1)
        arg = k.reshape((-1,) + (1,) * eff.ndim) - eff
        window = np.where(np.abs(arg) < pad,
                          np.cos(np.pi * arg / (2 * pad)) ** 2, 0.0)
        response = np.sinc(arg) * window
        sample_shape = ih.sample_shape
        if response.ndim - 1 < len(sample_shape):
            response = response.reshape(
                response.shape[:1] + (1,) * (len(sample_shape)
                                             - (response.ndim - 1))
                + response.shape[1:])
        elif response.ndim - 1 > len(sample_shape):
            # scalar shift on a scalar-sample-shape stream: drop the
            # singleton channel axis atleast_1d introduced
            response = response.reshape(response.shape[:1] + sample_shape)
        self._shift_samples = shift_samples
        self._pad_sinc = pad
        self._lo = lo
        if lo is not None:
            sideband = getattr_if_none(ih, "sideband", sideband)
            dt = shift_samples / ih.sample_rate.to_value(u.Hz)
            phase = -2j * np.pi * np.asarray(lo.to_value(u.Hz)) * dt \
                * np.asarray(sideband, dtype=float)
            self._lo_factor = np.exp(phase).astype(np.complex64)
            self._lo_cache = None
        else:
            self._lo_factor = None
        super().__init__(ih, response, offset=-k_min,
                         samples_per_frame=samples_per_frame)
        # The output grid is the input grid shifted by d_time samples:
        # relabel the start time accordingly.
        if d_time:
            self._start_time = self._start_time + self._samples_to_timedelta(
                1, ih.sample_rate) * d_time

    def task(self, data):
        out = super().task(data)
        if self._lo_factor is not None:
            if self._lo_cache is None:
                self._lo_cache = device_complex(
                    np.broadcast_to(self._lo_factor,
                                    out.shape[1:]).copy())
            out = out * self._lo_cache
        return out


class Resample(ShiftAndResample):
    """Resample so that a sample lands exactly at the requested offset.

    After construction the stream pointer is at that sample (reference
    sampling.py:308-312).
    """

    def __init__(self, ih, offset, whence=0, *, pad=64,
                 samples_per_frame=None):
        super().__init__(ih, 0, offset=offset, whence=whence, pad=pad,
                         samples_per_frame=samples_per_frame)
        target = seek_float(ih, offset, whence)
        # Position the pointer on the anchored sample.
        self.seek(int(round(float(np.mean(target)) - self._grid_offset))
                  - self._pad_start)


class TimeDelay(PaddedTaskBase):
    """Delay a complex stream purely by relabelling time, with the
    corresponding local-oscillator phase rotation (reference
    sampling.py:315-377).  No resampling occurs.
    """

    def __init__(self, ih, delay, *, lo, frequency=None, sideband=None):
        if ih.dtype.kind != "c":
            raise ValueError("TimeDelay requires complex (analytic) data")
        super().__init__(ih, pad_start=0, pad_end=0,
                         samples_per_frame=getattr(ih, "samples_per_frame",
                                                   1),
                         frequency=frequency, sideband=sideband)
        # reference semantics (sampling.py:359-365): a bare float delay
        # is in SAMPLES; time Quantities convert via the sample rate.
        # ``lo`` is required — None means data were recorded without
        # mixing (CHIME-like) and get no phase rotation; for channelized
        # data the true LO frequency must be passed explicitly.
        delay_samples = float(to_sample(ih, delay))
        rate_hz = ih.sample_rate.to_value(u.Hz)
        from .utils.time import TimeDelta
        self._start_time = self._start_time \
            + TimeDelta.from_samples(delay_samples, rate_hz)
        if lo is not None:
            sideband = getattr_if_none(ih, "sideband", sideband)
            delay_s = delay_samples / rate_hz
            phase = -2j * np.pi * np.asarray(lo.to_value(u.Hz)) \
                * delay_s * np.asarray(sideband, dtype=float)
            self._phase_factor = np.exp(phase).astype(np.complex64)
            self._phase_cache = None
        else:
            self._phase_factor = None

    def task(self, data):
        if self._phase_factor is None:
            return data
        if self._phase_cache is None:
            self._phase_cache = device_complex(
                np.broadcast_to(self._phase_factor,
                                data.shape[1:]).copy())
        return data * self._phase_cache


class ShiftSamples(PaddedTaskBase):
    """Shift each channel by an integer number of samples.

    Positive shifts delay the channel.  Implemented as a static per-channel
    gather from the padded window (reference sampling.py:410-425 builds an
    advanced index once).  Shifts may be given in samples (any fractional
    part is rounded to the nearest integer, reference sampling.py:396,411)
    or as a time Quantity; use :class:`ShiftAndResample` to apply the
    fractional part instead of rounding it.
    """

    def __init__(self, ih, shift, *, samples_per_frame=None):
        shift = np.round(np.asarray(to_sample(ih, shift))).astype(np.int64)
        pad_start = max(int(shift.max()), 0)
        pad_end = max(-int(shift.min()), 0)
        super().__init__(ih, pad_start=pad_start, pad_end=pad_end,
                         samples_per_frame=samples_per_frame)
        # Gather index per channel: out[j, c] = window[j + pad_start - s_c, c]
        # Standard numpy TRAILING-axis broadcast against the sample shape
        # (reference sampling.py:412: shift of shape (N, 1) addresses the
        # one-but-last axis); leading-axis alignment would silently shift
        # the wrong axis.
        try:
            full_shift = np.broadcast_to(shift, ih.sample_shape)
        except ValueError:
            raise ValueError(
                f"shift shape {shift.shape} cannot broadcast to sample "
                f"shape {ih.sample_shape}") from None
        # a uniform shift is a static slice (free under XLA); only
        # per-channel shifts need the gather
        self._uniform = int(full_shift.flat[0]) if full_shift.size \
            and np.all(full_shift == full_shift.flat[0]) else None
        self._rel_index = jnp.asarray(
            (pad_start - full_shift).astype(np.int32))

    def task(self, data):
        n_out = data.shape[0] - self._pad_start - self._pad_end
        if self._uniform is not None:
            start = self._pad_start - self._uniform
            return jax.lax.slice_in_dim(data, start, start + n_out,
                                        axis=0)
        j = jnp.arange(n_out).reshape((-1,) + (1,) * (data.ndim - 1))
        idx = j + self._rel_index
        return jnp.take_along_axis(data, idx, axis=0)
