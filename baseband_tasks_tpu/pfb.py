"""Polyphase filter banks and their inversion.

Counterpart of `/root/reference/baseband_tasks/pfb.py` (``sinc_hamming``
pfb.py:14, ``PolyphaseFilterBankSamples`` pfb.py:48, ``PolyphaseFilterBank``
pfb.py:103, ``InversePolyphaseFilterBank`` pfb.py:157).

Mechanics: the PFB FIR is a direct tap-sum over 4-12 shifted block views
(XLA fuses it into one elementwise pass ahead of the channelizing FFT — no
Fourier-domain tap convolution needed as in the reference's numpy path);
the inverse runs per-polyphase Wiener deconvolution as a batch FFT along
the block axis, with windows kept block-aligned so phases never shift.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .base import PaddedTaskBase
from .channelize import Channelize, Dechannelize
from .fourier import fft_maker, next_fast_len
from .utils.device import device_complex
__all__ = ["sinc_hamming", "PolyphaseFilterBank",
           "PolyphaseFilterBankSamples", "InversePolyphaseFilterBank"]


def sinc_hamming(n_tap, n_sample, sc=None, *, sinc_scale=1.0):
    """Sinc-Hamming polyphase prototype filter.

    ``h(x) = sinc(scale * x) * hamming`` over ``n_tap * n_sample`` points
    with x spanning tap units symmetrically (CHIME uses 4 taps x 2048
    samples, GUPPI 12 x 64 with scale 0.95; reference pfb.py:37-45, whose
    keyword spelling ``sinc_scale`` is accepted alongside ``sc``).
    Matches GUPPI's shipped ``get_pfb_coeffs`` table to float32 rounding
    (tests/test_golden_data.py).

    Returns an array of shape ``(n_tap, n_sample)``.
    """
    if sc is None:
        sc = sinc_scale
    n = n_tap * n_sample
    i = np.arange(n)
    x = sc * (i / n_sample - n_tap / 2.0)
    h = np.sinc(x) * np.hamming(n)
    return h.reshape(n_tap, n_sample).astype(np.float32)


class _PolyphaseFIR(PaddedTaskBase):
    """Blockwise FIR at the raw rate: z[k*n + j] = sum_t h[t, j] x[(k+t)*n + j].

    Padding is (n_tap - 1) * n samples at the end (the FIR looks forward
    across taps); windows stay multiples of n so polyphase indices never
    shift.
    """

    def __init__(self, ih, response, *, samples_per_frame=None):
        response = np.asarray(response)
        n_tap, n = response.shape[:2]
        self._n = n
        self._n_tap = n_tap
        pad = (n_tap - 1) * n
        if samples_per_frame is not None:
            samples_per_frame *= n

        fast_len = fft_maker.get().next_fast_len

        def block_fast_len(size):
            return n * fast_len(-(-size // n))

        if pad % 2:
            raise ValueError("(n_tap - 1) * n must be even (reference "
                             "pfb.py:78)")
        # centered pads: output spectra are stamped mid-FIR, matching
        # the reference's (and instruments') time convention
        # (reference pfb.py:80-84)
        super().__init__(ih, pad_start=pad // 2, pad_end=pad // 2,
                         samples_per_frame=samples_per_frame,
                         next_fast_len=block_fast_len)
        if self._samples_per_frame % n:
            raise ValueError(
                f"frame of {self._samples_per_frame} samples does not "
                f"hold whole blocks of n={n} (stream too short?); pass "
                f"samples_per_frame explicitly")
        # device-resident taps, broadcastable against trailing sample dims
        extra = len(ih.sample_shape)
        self._taps = jnp.asarray(
            response.reshape((n_tap, 1, n) + (1,) * extra))

    def task(self, data):
        n = self._n
        xr = data.reshape((-1, n) + data.shape[1:])
        m_out = xr.shape[0] - self._n_tap + 1
        acc = self._taps[0] * xr[:m_out]
        for t in range(1, self._n_tap):
            acc = acc + self._taps[t] * xr[t:t + m_out]
        return acc.reshape((-1,) + data.shape[1:])

    def task_planes(self, pair):
        """Planes-interchange form: the FIR has real taps, so it applies
        to the re/im planes independently (models/compiled.py)."""
        return (self.task(pair[0]),
                None if pair[1] is None else self.task(pair[1]))


class PolyphaseFilterBankSamples(Channelize):
    """Polyphase filter bank: blockwise FIR then channelization.

    ``response`` has shape ``(n_tap, n)``; output channels are as for
    :class:`~baseband_tasks_tpu.channelize.Channelize` of ``n`` samples
    (reference pfb.py:48-100).
    """

    def __init__(self, ih, response, samples_per_frame=None, *,
                 frequency=None, sideband=None):
        response = np.asarray(response)
        n = response.shape[1]
        fir = _PolyphaseFIR(ih, response,
                            samples_per_frame=samples_per_frame)
        self._response = response
        super().__init__(fir, n,
                         samples_per_frame=fir.samples_per_frame // n,
                         frequency=frequency, sideband=sideband)

    @property
    def response(self):
        return self._response


class PolyphaseFilterBank(PolyphaseFilterBankSamples):
    """Polyphase filter bank (identical output to the Samples variant).

    The reference distinguishes a Fourier-domain tap convolution
    (pfb.py:103-154) from the time-domain one purely for numpy efficiency;
    on device the direct tap-sum fuses into one pass, so both classes share
    one implementation.
    """


class InversePolyphaseFilterBank(PaddedTaskBase):
    """Invert a polyphase filter bank by per-phase Wiener deconvolution.

    Dechannelizes the spectra back to the FIR'd raw stream, then divides
    out the prototype filter per polyphase slice with signal-to-noise
    regularization ``sn`` (reference pfb.py:157-255):
    ``G = H / (|H|^2 + 1/sn^2)``.

    Parameters
    ----------
    ih : stream
        Channelized (PFB) stream.
    response : array (n_tap, n)
        The analysis prototype filter.
    sn : float
        Assumed signal-to-noise regularizer (CHIME ~10, GUPPI ~30).
    pad_start, pad_end : int
        Discarded blocks (spectra) on each side of every frame
        (default 128 each, cf. reference pfb.py:212-228).
    dtype : dtype, optional
        Output dtype; pass float32 to reconstruct a real stream.
    """

    def __init__(self, ih, response, *, sn=10.0, pad_start=128, pad_end=128,
                 samples_per_frame=None, dtype=None, frequency=None,
                 sideband=None):
        response = np.asarray(response)
        n_tap, n = response.shape[:2]
        self._n = n
        self._n_tap = n_tap
        self._sn = float(sn)
        dech = Dechannelize(ih, n=n, dtype=dtype, frequency=frequency,
                            sideband=sideband)
        if samples_per_frame is not None:
            samples_per_frame *= n

        fast_len = fft_maker.get().next_fast_len

        def block_fast_len(size):
            return n * fast_len(-(-size // n))

        super().__init__(dech, pad_start=(int(pad_start)) * n,
                         pad_end=(int(pad_end) + n_tap - 1) * n,
                         samples_per_frame=samples_per_frame,
                         next_fast_len=block_fast_len)
        self._response = response
        self._gain_cache = None
        # the forward PFB stamps spectra mid-FIR (centered pads); the
        # reconstruction's content is aligned to the FIR window START,
        # so shift the labels back by half the FIR span to make output
        # sample t equal raw(t) (the reference reads its comparison
        # data at pad*n + (n_tap-1)*n/2 for the same reason,
        # tests/test_pfb.py:172-177)
        self._start_time = self._start_time \
            - self._samples_to_timedelta(1, self.sample_rate) \
            * ((n_tap - 1) * n // 2)
        # plan the per-phase batch transforms through the active engine
        m = self._padded_samples_per_frame // n
        shape = (m, n) + tuple(dech.sample_shape)
        self._batch_fft = fft_maker(shape, np.complex64, axis=0)
        self._batch_ifft = self._batch_fft.inverse()

    def _gain_np(self, m):
        """Wiener gain per (block-frequency, phase) as complex128 (m, n).

        The dechannelized stream per phase j is the correlation
        z_j[k] = sum_t h[t, j] x_j[k + t], i.e. Z = conj(H) X in the
        M-point DFT; the regularized inverse is
        G = H / (|H|² + 1/sn²) (reference pfb.py:243-255).
        """
        resp = np.zeros((m, self._n), dtype=np.float64)
        resp[:self._n_tap] = self._response
        hbar = np.conj(np.fft.fft(resp, axis=0))
        inv_sn2 = 1.0 / self._sn ** 2
        # the (1 + 1/sn^2) factor keeps unit gain where |H| = 1
        # (reference pfb.py:252-255)
        return (np.conj(hbar) / (np.abs(hbar) ** 2 + inv_sn2)
                * (1.0 + inv_sn2))

    def _make_gain(self, m):
        return device_complex(self._gain_np(m).astype(np.complex64))

    def task(self, data):
        n = self._n
        sample_shape = data.shape[1:]
        z = data.reshape((-1, n) + sample_shape)
        m = z.shape[0]
        if self._gain_cache is None or self._gain_cache.shape[0] != m:
            self._gain_cache = self._make_gain(m)
        gain = self._gain_cache.reshape((m, n) + (1,) * len(sample_shape))
        zc = z.astype(jnp.complex64)
        if m == self._batch_fft.time_shape[0]:
            Z = self._batch_fft(zc)
            x = self._batch_ifft(Z * gain)
        else:  # off-plan window (a short stream's clamped frame)
            Z = jnp.fft.fft(zc, axis=0)
            x = jnp.fft.ifft(Z * gain, axis=0)
        out = x.reshape((-1,) + sample_shape)
        out = out[self._pad_start:self._pad_start + self._samples_per_frame]
        if self.dtype.kind != "c":
            out = out.real
        return out.astype(self.dtype)
