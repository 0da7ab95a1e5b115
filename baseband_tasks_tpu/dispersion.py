"""Coherent and incoherent dispersion/dedispersion.

Counterpart of `/root/reference/baseband_tasks/dispersion.py` (``Disperse``
dispersion.py:16, ``Dedisperse`` dispersion.py:149, ``DisperseSamples``/
``DedisperseSamples`` dispersion.py:193,253).

Coherent path: one jitted frame function
fft → multiply-cached-chirp → ifft → static trim, in overlap-save windows
whose total padding equals the dispersion smearing across the band; the
chirp (exp(2πi φ_DM(f) · sideband)) is built once on host in float64 and
cached on device as complex64.
"""

from __future__ import annotations

import numpy as np

from .base import PaddedTaskBase, getattr_if_none
from .dm import DispersionMeasure
from .fourier import fft_maker
from .sampling import ShiftSamples
from .utils import units as u
from .utils.device import device_complex

__all__ = ["Disperse", "Dedisperse", "DisperseSamples", "DedisperseSamples"]


class Disperse(PaddedTaskBase):
    """Coherently disperse a (complex baseband) stream.

    Each spectral component acquires the cold-plasma group delay relative
    to ``reference_frequency`` (which itself stays fixed in time); positive
    DM delays lower frequencies more.

    Parameters
    ----------
    ih : stream
        Input; each sample-shape channel has a carrier ``frequency`` and
        ``sideband`` (from the stream or passed explicitly).
    dm : DispersionMeasure or Quantity
        Dispersion measure (pc/cm³).  Negative values dedisperse.
    reference_frequency : Quantity, optional
        Frequency that stays aligned in time.  Default: midpoint of the
        full band edges (reference dispersion.py:68-77).
    """

    def __init__(self, ih, dm, *, reference_frequency=None,
                 samples_per_frame=None, frequency=None, sideband=None,
                 pad_margin=256):
        frequency = getattr_if_none(ih, "frequency", frequency)
        sideband = getattr_if_none(ih, "sideband", sideband)
        if not isinstance(dm, u.Quantity):
            dm = DispersionMeasure(dm)
        elif not isinstance(dm, DispersionMeasure):
            dm = DispersionMeasure(dm.to_value(u.DM), u.DM)
        self._dm = dm
        sample_shape = ih.sample_shape if ih.sample_shape else (1,)
        freq = u.Quantity(np.broadcast_to(
            np.asarray(frequency.value, dtype=np.float64), sample_shape),
            frequency.unit)
        sb = np.broadcast_to(np.asarray(sideband), sample_shape)
        rate = ih.sample_rate

        # Band edges per channel (complex data spans ±B/2 around the
        # carrier; real data spans half the rate on the sideband's side;
        # reference dispersion.py:55-61).
        half = 0.5 * rate
        if ih.dtype.kind == "c":
            f_low = freq - half
            f_high = freq + half
        else:
            f_low = freq + np.minimum(sb, 0) * half
            f_high = freq + np.maximum(sb, 0) * half
        edges = np.concatenate([np.ravel(f_low.to_value(u.MHz)),
                                np.ravel(f_high.to_value(u.MHz))])
        if reference_frequency is None:
            # mean of the per-channel band centers (reference :63-64)
            centers = (f_low.to_value(u.MHz)
                       + f_high.to_value(u.MHz)) / 2.0
            reference_frequency = u.Quantity(float(np.mean(centers)),
                                             u.MHz)
        self.reference_frequency = reference_frequency

        # Delay extremes across the whole band set the padding.
        delays = dm.time_delay(u.Quantity(edges, u.MHz),
                               reference_frequency).to_value(u.s)
        rate_hz = rate.to_value(u.Hz)
        d_max = float(np.max(delays)) * rate_hz
        d_min = float(np.min(delays)) * rate_hz
        # Extra discard beyond the nominal smearing: the discrete chirp's
        # impulse response has band-edge (Gibbs) tails of a few hundred
        # samples at ~1e-3..1e-4 amplitude regardless of DM; discarding
        # them keeps overlap-save ghosts below the 60 dB noise floor.
        margin = int(pad_margin)
        pad_start = max(int(np.ceil(d_max)), 0) + margin
        pad_end = max(int(np.ceil(-d_min)), 0) + margin
        self._freq = freq
        self._sb = sb
        self._chirp_cache = None
        super().__init__(ih, pad_start=pad_start, pad_end=pad_end,
                         samples_per_frame=samples_per_frame,
                         next_fast_len=fft_maker.get().next_fast_len)

    def _chirp(self):
        """Device chirp exp(2πi φ(f_sky) · sb) over the padded window."""
        n = self._padded_samples_per_frame
        sample_shape = self.ih.sample_shape if self.ih.sample_shape else (1,)
        fft = fft_maker((n,) + sample_shape, self.ih.dtype,
                        axis=0, sample_rate=self.ih.sample_rate)
        # baseband offsets -> sky frequency per (bin, channel...)
        offset = fft.frequency  # Quantity (nfreq, 1, ..)
        f_sky = self._freq + offset * self._sb
        phase = self._dm.phase_delay(f_sky, self.reference_frequency)
        cycles = np.asarray(phase.to_value(u.cycle), dtype=np.float64)
        cycles = cycles - np.round(cycles)
        factor = np.exp(2j * np.pi * cycles * np.asarray(self._sb))
        return device_complex(factor.astype(np.complex64))

    def task(self, data):
        if self._chirp_cache is None:
            self._chirp_cache = self._chirp()
        squeeze = data.ndim == 1
        if squeeze:
            data = data[:, None]
        n = data.shape[0]
        fft = fft_maker((n,) + data.shape[1:], data.dtype, axis=0,
                        sample_rate=self.ih.sample_rate)
        ft = fft(data)
        ft = ft * self._chirp_cache
        out = fft.inverse()(ft)
        out = out[self._pad_start:self._pad_start + self._samples_per_frame]
        if squeeze:
            out = out[:, 0]
        return out

    @property
    def dm(self):
        return self._dm

    @property
    def dedispersion_measure(self):
        return DispersionMeasure(-self._dm.to_value(u.DM), u.DM)


class Dedisperse(Disperse):
    """Coherently dedisperse: remove the dispersion of ``dm``
    (sign-flip wrapper, reference dispersion.py:182-190)."""

    def __init__(self, ih, dm, *, reference_frequency=None,
                 samples_per_frame=None, frequency=None, sideband=None,
                 pad_margin=256):
        if not isinstance(dm, u.Quantity):
            dm = DispersionMeasure(dm)
        negated = DispersionMeasure(-dm.to_value(u.DM), u.DM)
        super().__init__(ih, negated,
                         reference_frequency=reference_frequency,
                         samples_per_frame=samples_per_frame,
                         frequency=frequency, sideband=sideband,
                         pad_margin=pad_margin)

    @property
    def dm(self):
        # the reference's Dedisperse.dm returns the *positive* value
        # passed in (dispersion.py:188-190): undo the internal negation
        return DispersionMeasure(-self._dm.to_value(u.DM), u.DM)

    @property
    def dedispersion_measure(self):
        return self._dm


class DisperseSamples(ShiftSamples):
    """Incoherently disperse: shift each channel by its integer-sample
    mid-channel dispersion delay (reference dispersion.py:193-250)."""

    def __init__(self, ih, dm, *, reference_frequency=None,
                 samples_per_frame=None, frequency=None, sideband=None):
        frequency = getattr_if_none(ih, "frequency", frequency)
        sideband = getattr_if_none(ih, "sideband", sideband)
        if not isinstance(dm, DispersionMeasure):
            dm = DispersionMeasure(dm if not isinstance(dm, u.Quantity)
                                   else dm.to_value(u.DM))
        self._dm = dm
        sample_shape = ih.sample_shape if ih.sample_shape else (1,)
        freq = u.Quantity(np.broadcast_to(
            np.asarray(frequency.value, dtype=np.float64), sample_shape),
            frequency.unit)
        if ih.dtype.kind != "c":
            # real data: labels are band edges; delays act at the
            # mid-channel frequency (reference dispersion.py:236-238)
            sb = np.broadcast_to(np.asarray(sideband), sample_shape)
            freq = freq + sb * ih.sample_rate / 2.0
        if reference_frequency is None:
            reference_frequency = u.Quantity(
                float(np.mean(freq.value)), freq.unit)
        self.reference_frequency = reference_frequency
        # Mid-channel delay -> whole-sample shift per channel.
        delay = dm.time_delay(freq, reference_frequency).to_value(u.s)
        shift = np.round(delay * ih.sample_rate.to_value(u.Hz)).astype(int)
        super().__init__(ih, shift, samples_per_frame=samples_per_frame)

    @property
    def dm(self):
        return self._dm


class DedisperseSamples(DisperseSamples):
    """Incoherently dedisperse (sign-flip wrapper, reference
    dispersion.py:253-300)."""

    def __init__(self, ih, dm, *, reference_frequency=None,
                 samples_per_frame=None, frequency=None, sideband=None):
        if not isinstance(dm, u.Quantity):
            dm = DispersionMeasure(dm)
        negated = DispersionMeasure(-dm.to_value(u.DM), u.DM)
        super().__init__(ih, negated,
                         reference_frequency=reference_frequency,
                         samples_per_frame=samples_per_frame,
                         frequency=frequency, sideband=sideband)

    @property
    def dm(self):
        # positive value passed in (reference dispersion.py:298-300)
        return DispersionMeasure(-self._dm.to_value(u.DM), u.DM)

    @property
    def dedispersion_measure(self):
        return self._dm
