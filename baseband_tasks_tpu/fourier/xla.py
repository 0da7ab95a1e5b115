"""XLA (jnp.fft) engine — the default, device-executing FFT.

Device counterpart of the reference's pyfftw engine
(`/root/reference/baseband_tasks/fourier/pyfftw.py`): where FFTW needs
explicit planning and buffer sharing, XLA gets both from jit tracing and
fusion.  A module-level jitted function keyed on static (axis, direction,
ortho, n) lets every FFT instance share the compilation cache.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .base import FFTBase, FFTMakerBase

__all__ = ["XLAFFTMaker", "XLAFFTBase"]


@partial(jax.jit, static_argnames=("axis", "ortho", "real", "direction", "n"))
def _xla_fft(data, *, axis, ortho, real, direction, n):
    norm = "ortho" if ortho else None
    if direction == "forward":
        if real:
            return jnp.fft.rfft(data, axis=axis, norm=norm)
        return jnp.fft.fft(data, axis=axis, norm=norm)
    else:
        if real:
            out = jnp.fft.irfft(data, n=n, axis=axis, norm=norm)
            return out.astype(jnp.float32 if data.dtype == jnp.complex64
                              else jnp.float64)
        return jnp.fft.ifft(data, axis=axis, norm=norm)


class XLAFFTBase(FFTBase):
    """One planned transform executing on device via jnp.fft (cuFFT on
    the GPU, at every length)."""

    def _fft(self, data):
        if self._direction == "forward":
            expected = self._time_dtype
        else:
            expected = self._frequency_dtype
        data = jnp.asarray(data)
        if data.dtype != expected:
            data = data.astype(expected)
        out = _xla_fft(data, axis=self._axis, ortho=self._ortho,
                       real=self.real_input, direction=self._direction,
                       n=self._time_shape[self._axis])
        return out


class XLAFFTMaker(FFTMakerBase):
    """Engine factory for device FFTs (registered as 'xla')."""

    _fft_class = XLAFFTBase
