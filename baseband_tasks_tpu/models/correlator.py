"""FX correlator: multi-station cross-correlation to visibilities.

The reference package is built as the reduction layer for VLBI and
pulsar work (its tasks are exactly an FX correlator's stages) but ships
no correlator; this model composes the library into one:

  per station:  [ShiftAndResample(-delay, lo=...)]   delay + fringe stop
                 -> Channelize(n_chan)               the "F" stage
  Stack(axis=1)                                      (time, station, chan)
  CrossMultiply                                      the "X" stage
  Integrate(n_avg)                                   visibility dump

Everything is an ordinary stream node, so the result seeks by absolute
`Time`, carries per-channel frequencies, and can feed any downstream
task or I/O writer.  On device the cross products are a gather +
elementwise complex multiply over the 128-lane channel axis (HBM-bound;
the integration's segment-sum supplies the accumulate).

Conventions
-----------
``delays[k]`` is the known signal arrival delay at station k (the
wavefront reaches station k that much later than the reference epoch);
the correlator *advances* each stream by its delay so wavefronts align.
With ``lo`` set, the advance also rotates by
exp(+2j pi lo delay sideband) — fringe stopping for a signal that was
mixed down from sky frequency ``lo`` (same convention as
:class:`~baseband_tasks_tpu.sampling.ShiftAndResample`, reference
sampling.py:211-220).
"""

from __future__ import annotations

import operator

import numpy as np

import jax.numpy as jnp

from ..base import SetAttribute, Task, TaskBase
from ..channelize import Channelize
from ..utils import units as u
from ..combining import Stack
from ..integration import Integrate
from ..sampling import ShiftAndResample, ShiftSamples

__all__ = ["CrossMultiply", "fx_correlate"]


class CrossMultiply(TaskBase):
    """Station-pair products ``V_b = X_i conj(X_j)`` along a sample axis.

    Parameters
    ----------
    ih : stream
        Input with the station axis first in the sample shape
        (i.e. data blocks ``(time, station, ...)``).
    baselines : list of (i, j), optional
        Station index pairs.  Default: all pairs with ``i <= j``
        (autocorrelations included, in packed upper-triangle order).
    """

    def __init__(self, ih, baselines=None):
        if ih.dtype.kind != "c":
            raise ValueError("CrossMultiply needs complex (voltage "
                             "spectra) input.")
        n_st = ih.sample_shape[0]
        if baselines is None:
            baselines = [(i, j) for i in range(n_st)
                         for j in range(i, n_st)]
        pairs = [(operator.index(i), operator.index(j))
                 for i, j in baselines]
        for i, j in pairs:
            if not (0 <= i < n_st and 0 <= j < n_st):
                raise ValueError(f"baseline ({i}, {j}) outside the "
                                 f"{n_st} stations")
        self._baselines = tuple(pairs)
        # host arrays on purpose: a device-array closure constant is
        # copied back to the host and embedded at jit-lowering time
        self._bi = np.array([p[0] for p in pairs])
        self._bj = np.array([p[1] for p in pairs])
        # meta attributes spanning the station axis cannot broadcast to
        # the baseline axis: all stations observe the same sky, so
        # require identical labels and keep one station's copy
        kw = {}
        nss = len(ih.sample_shape)
        for name in ("frequency", "sideband", "polarization"):
            value = getattr(ih, name, None)
            if value is not None:
                arr = np.asarray(getattr(value, "value", value))
                if arr.ndim >= nss and arr.shape[-nss] == n_st != 1:
                    st_axis = arr.ndim - nss
                    first = value[(slice(None),) * st_axis + (0,)]
                    f_arr = np.asarray(getattr(first, "value", first))
                    if not np.all(arr == np.expand_dims(f_arr, st_axis)):
                        raise ValueError(
                            f"stations disagree on {name}; correlation "
                            f"needs identical channel labels")
                    value = first
            kw[name] = value
        super().__init__(ih, dtype=np.complex64, **kw)

    @property
    def baselines(self):
        return self._baselines

    def _output_sample_shape(self, ih):
        return (len(self._baselines),) + ih.sample_shape[1:]

    def task(self, data):
        x = jnp.asarray(data)
        return x[:, self._bi] * jnp.conj(x[:, self._bj])


def _aligned_spectra(streams, n_chan, *, delays, lo,
                     samples_per_frame, method):
    """Delay-align each station, channelize, and stack to a
    ``(time, station, n_chan, ...)`` stream (shared by
    :func:`fx_correlate` and :func:`tied_array_beam`)."""
    if len(streams) < 1:
        raise ValueError("need at least one stream")
    if method not in ("sinc", "phase"):
        raise ValueError(f"method={method!r} must be 'sinc' or 'phase'")
    anchor = streams[0].start_time
    rate_hz = float(streams[0].sample_rate.to_value(u.Hz))
    for k, s in enumerate(streams[1:], start=1):
        if float(s.sample_rate.to_value(u.Hz)) != rate_hz:
            raise ValueError(
                f"stations must share one sample rate; stream {k} has "
                f"{s.sample_rate} vs stream 0's {streams[0].sample_rate}")
    channelized = []
    for k, s in enumerate(streams):
        d = None if delays is None else delays[k]
        rotate = None
        if d is not None and method == "phase":
            # required *data* advance on the anchor grid: the stream's
            # label offset already accounts for part of the delay
            # (out index k must hold the station signal at anchor
            # time k + tau = label lab + (k + ishift) + frac)
            tau = float(d.to_value(u.s)) * rate_hz       # samples
            lab = float((s.start_time - anchor).sec) * rate_hz
            eff = tau - lab
            ishift = int(round(eff))
            frac = eff - ishift
            if ishift:
                # frame must hold whole channelizer groups (compiled
                # runs pin the block to it); default to a healthy size
                spf = samples_per_frame or 128 * n_chan
                spf = -(-spf // n_chan) * n_chan
                s = ShiftSamples(s, -ishift, samples_per_frame=spf)
            # the gather's output at label t holds the station content of
            # label t + ishift; the anchor-grid value we want at time k
            # therefore sits at label k + lab — remove the (fractional)
            # label offset so the samples land on the anchor grid (a
            # delaying gather keeps its own +pad_start label shift)
            if lab:
                s = SetAttribute(
                    s, start_time=s.start_time
                    - lab / streams[0].sample_rate)
            # per-channel slope for the fractional advance, plus the
            # fringe-stopping rotation for the full delay (the same
            # exp(+2 pi i lo tau sideband) ShiftAndResample applies)
            fk = np.fft.fftfreq(n_chan)                  # cycles/sample
            rot = np.exp(2j * np.pi * fk * frac)
            if lo is not None:
                sb = np.asarray(getattr(s, "sideband", 1))
                if sb.ndim:
                    raise ValueError("method='phase' fringe stopping "
                                     "needs a scalar sideband")
                rot = rot * np.exp(2j * np.pi
                                   * float(lo.to_value(u.Hz))
                                   * float(d.to_value(u.s)) * float(sb))
            rotate = rot.astype(np.complex64)
        elif d is not None:
            s = ShiftAndResample(s, -d, offset=anchor, lo=lo,
                                 samples_per_frame=samples_per_frame)
            # re-size the resampler so its frame holds whole channelizer
            # groups (CompiledPipeline pins the block to this frame) and
            # its padded window is an FFT-fast length
            pads = s.pad_start + s.pad_end
            spf = s.samples_per_frame
            from ..fourier.base import next_fast_len
            w = spf + pads
            for _ in range(64):
                w = next_fast_len(w)
                if (w - pads) % n_chan == 0:
                    spf = w - pads
                    break
                w += 1
            else:
                spf = -(-spf // n_chan) * n_chan
            if spf != s.samples_per_frame:
                s = ShiftAndResample(streams[k], -d, offset=anchor,
                                     lo=lo, samples_per_frame=spf)
        # align the F-stage block grid across stations: trim so each
        # stream's first spectrum starts a whole number of n_chan raw
        # samples from the anchor (delay compensation can leave the
        # stream head anywhere on the raw grid)
        koff = int(round(float((s.start_time - anchor).sec) * rate_hz))
        trim = (-koff) % n_chan
        if trim:
            s = s[trim:]
        ch = Channelize(s, n_chan)
        if rotate is not None:
            # host constant (see CrossMultiply note on closure constants)
            rv = rotate.reshape((n_chan,)
                                + (1,) * (len(ch.sample_shape) - 1))
            ch = Task(ch, lambda data, rv=rv: data * rv)
        channelized.append(ch)
    stacked = channelized[0] if len(channelized) == 1 \
        else Stack(channelized, axis=1)
    if len(channelized) == 1:
        # single station: insert the station axis explicitly
        from ..shaping import Reshape
        stacked = Reshape(stacked, (1,) + stacked.sample_shape)
    return stacked


def fx_correlate(streams, n_chan, n_avg, *, delays=None, lo=None,
                 baselines=None, average=True, samples_per_frame=None,
                 method="sinc"):
    """Build a lazy FX-correlator chain over ``streams``.

    Parameters
    ----------
    streams : list of stream
        Station voltage streams (complex, equal sample rates).
    n_chan : int
        Channels per spectrum (the F stage).
    n_avg : int
        Spectra averaged per visibility dump (the integration).
    delays : list of Quantity or None, optional
        Known arrival delay per station (see module docstring); each
        stream is advanced by its delay (with fringe stopping when
        ``lo`` is given).  None entries are left untouched.
    lo : Quantity, optional
        Local-oscillator (sky) frequency used in the downconversion;
        enables fringe stopping of the delay corrections.
    baselines : list of (i, j), optional
        Passed to :class:`CrossMultiply`.
    average : bool, optional
        If True (default) visibilities are means; else structured
        {data, count} sums (reference integration.py:154-160 semantics).
    method : 'sinc' or 'phase', optional
        How the fractional part of each delay is applied.  'sinc'
        (default) resamples in the time domain
        (:class:`~baseband_tasks_tpu.sampling.ShiftAndResample`) —
        exact, at the cost of an overlap-save window per station.
        'phase' is the production FX-correlator scheme: the integer
        part shifts whole samples before the F stage
        (:class:`~baseband_tasks_tpu.sampling.ShiftSamples`), the
        fractional part becomes a per-channel phase slope
        ``exp(2 pi i f_k tau_frac)`` after it — exact for the
        cross-spectrum expectation of band-limited channels, with no
        large FFT windows, so it block-pins cheaply in compiled runs.

    Returns
    -------
    stream with samples ``(n_baseline, n_chan) + trailing``, one per
    ``n_avg`` spectra.
    """
    stacked = _aligned_spectra(streams, n_chan, delays=delays, lo=lo,
                               samples_per_frame=samples_per_frame,
                               method=method)
    prods = CrossMultiply(stacked, baselines=baselines)
    return Integrate(prods, n_avg, average=average)
