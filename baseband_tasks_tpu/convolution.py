"""Convolution tasks: direct (time-domain) and FFT overlap-save.

Counterpart of `/root/reference/baseband_tasks/convolution.py`
(``ConvolveSamples`` convolution.py:23, ``Convolve`` convolution.py:65).

Mechanics: the direct path lowers to a depthwise
``lax.conv_general_dilated``, the FFT path to
fft → multiply-by-cached-response-FT → ifft, fused by XLA inside one
jitted frame function.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import PaddedTaskBase, check_broadcast_to
from .fourier import fft_maker
from .utils.device import device_complex

__all__ = ["adjust_response_dims", "Convolve", "ConvolveSamples"]


def adjust_response_dims(response, ih):
    """Give a 1-D response trailing singleton axes so it broadcasts
    against the sample shape of ``ih``; otherwise check it broadcasts
    as-is (reference convolution.py:13-20)."""
    if response.ndim == 1 and ih.ndim > 1:
        response = response.reshape(response.shape[:1]
                                    + (1,) * (ih.ndim - 1))
    else:
        check_broadcast_to(response, response.shape[:1] + ih.sample_shape)
    return response


class _ConvolveBase(PaddedTaskBase):
    """Common setup: response array, padding split, time alignment.

    ``response`` has the convolution kernel along axis 0 and must broadcast
    against the sample shape on trailing axes.  ``offset`` positions the
    kernel relative to the output grid: the output at sample ``i`` is
    ``sum_k data[i + k] * response[::-1][k]`` with the kernel's ``offset``
    element aligned to ``i`` (cf. reference convolution.py:23-64).
    """

    def __init__(self, ih, response, *, offset=0, samples_per_frame=None,
                 **kwargs):
        response = np.asarray(response)
        if response.ndim < 1:
            raise ValueError("response must have at least 1 dimension")
        response = adjust_response_dims(response, ih)
        pad = response.shape[0] - 1
        super().__init__(ih, pad_start=pad - offset, pad_end=offset,
                         samples_per_frame=samples_per_frame,
                         next_fast_len=fft_maker.get().next_fast_len,
                         **kwargs)

        if np.asarray(response).dtype.kind == "c" and \
                self.dtype.kind != "c":
            # the reference fails loudly here too (complex assigned into
            # a real output array); silently taking .real would corrupt
            raise ValueError(
                "complex response with a real output dtype would discard "
                "the imaginary part; pass dtype=complex64 or convert the "
                "stream (e.g. Real2Complex) first")
        self._response = response
        self._response_offset = offset

    @property
    def response(self):
        return self._response


class ConvolveSamples(_ConvolveBase):
    """Convolve a stream with a response directly in the time domain."""

    def task(self, data):
        resp = self._response
        n_in = data.shape[0]
        sample_shape = data.shape[1:]
        c = int(np.prod(sample_shape)) if sample_shape else 1
        # Broadcast response over all sample dims -> (r, C)
        rfull = np.broadcast_to(
            resp.reshape(resp.shape[:1] + (1,) * (len(sample_shape)
                                                  - (resp.ndim - 1))
                         + resp.shape[1:]),
            (resp.shape[0],) + sample_shape).reshape(resp.shape[0], c)
        x = data.reshape(n_in, c)
        if data.dtype.kind == "c":
            re = self._conv_real(x.real, rfull.real) - \
                self._conv_real(x.imag, rfull.imag)
            im = self._conv_real(x.real, rfull.imag) + \
                self._conv_real(x.imag, rfull.real)
            out = jax.lax.complex(re, im)
        else:
            out = self._conv_real(x, rfull.astype(x.dtype))
        return out.reshape((out.shape[0],) + sample_shape)

    @staticmethod
    def _conv_real(x, r):
        """Valid-mode convolution along axis 0, depthwise per channel.

        x: (n, C), r: (rlen, C) -> (n - rlen + 1, C)
        """
        n, c = x.shape
        lhs = x.T[None]                      # (1, C, n)
        rhs = jnp.asarray(r[::-1].T[:, None, :])  # (C, 1, rlen)
        out = jax.lax.conv_general_dilated(
            lhs.astype(jnp.float32), rhs.astype(jnp.float32),
            window_strides=(1,), padding="VALID",
            feature_group_count=c)
        return out[0].T                       # (n_out, C)


class Convolve(_ConvolveBase):
    """Convolve via FFT overlap-save with a cached response transform.

    The padded-frame FT of the response is computed once and cached on
    device (reference caches it as a lazyproperty, convolution.py:108-114).
    """

    _ft_response_cache = None

    def _ft_response(self):
        """FT of the zero-padded response, aligned so that trimming
        ``pad_start`` from the IFFT start yields the convolution."""
        n = self._padded_samples_per_frame
        sample_shape = self.ih.sample_shape
        resp = self._response
        full_shape = (n,) + sample_shape
        padded = np.zeros(full_shape, dtype=np.complex64)
        r = resp.reshape(resp.shape[:1] + (1,) * (len(sample_shape)
                                                  - (resp.ndim - 1))
                         + resp.shape[1:])
        padded[:resp.shape[0]] = np.broadcast_to(
            r, (resp.shape[0],) + sample_shape)
        fft = fft_maker(full_shape, np.complex64, axis=0)
        return device_complex(np.asarray(fft(padded)))

    def task(self, data):
        if self._ft_response_cache is None:
            self._ft_response_cache = self._ft_response()
        n = data.shape[0]
        fft = fft_maker((n,) + data.shape[1:], np.complex64, axis=0,
                        sample_rate=self.ih.sample_rate)
        ft = fft(data.astype(jnp.complex64))
        ft = ft * self._ft_response_cache
        out = fft.inverse()(ft)
        # Convolution output index i depends on inputs [i-rlen+1 .. i];
        # valid region starts at rlen-1 = pad_start + pad_end.
        out = out[self._pad_start + self._pad_end:]
        if self.dtype.kind != "c":
            out = out.real.astype(self.dtype)
        return out
