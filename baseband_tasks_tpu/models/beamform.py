"""Tied-array beamforming: phased (coherent) or incoherent summation
of multi-station voltage streams.

Beyond the reference (which ships the ingredients — delays, resampling,
channelization, combining — but no beamformer).  Shares the station
alignment of :func:`~.models.correlator.fx_correlate`: each station is
advanced by its known geometric/instrumental delay (with fringe
stopping when ``lo`` is given), channelized, and stacked to
``(time, station, n_chan, ...)``; the beam is then

* ``mode='coherent'``:  ``B_k = sum_a w_[a,k] X_[a,k]`` — the tied-array
  (phased-sum) beam, complex spectra out, S/N growing as n_st for a
  point source at the phase centre;
* ``mode='incoherent'``: ``B_k = sum_a w_[a,k] |X_[a,k]|**2`` — detected
  power out, S/N growing as sqrt(n_st) but over the full primary beam.

``weights`` are per-station (n_st,) or per-(station, channel)
(n_st, n_chan) complex calibration weights — e.g. the inverse of gain
solutions derived from an :func:`fx_correlate` run on a calibrator —
defaulting to 1/n_st.  On device the sum is a tiny station-axis
contraction that XLA fuses with its neighbours.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from ..base import TaskBase
from .correlator import _aligned_spectra

__all__ = ["BeamformStations", "tied_array_beam"]


class BeamformStations(TaskBase):
    """Weighted sum over the leading station axis of the sample shape.

    Parameters
    ----------
    ih : stream
        Complex spectra with samples ``(n_st, n_chan, ...)``.
    weights : array, optional
        (n_st,) or (n_st, n_chan) complex weights (default uniform
        1/n_st).  Stored as a host constant.
    mode : {'coherent', 'incoherent'}
        Sum voltages, or detect then sum (real output).
    """

    def __init__(self, ih, weights=None, *, mode="coherent"):
        if ih.dtype.kind != "c":
            raise ValueError("BeamformStations needs complex (voltage "
                             "spectra) input")
        if mode not in ("coherent", "incoherent"):
            raise ValueError(f"unknown mode {mode!r}")
        n_st = ih.sample_shape[0]
        if weights is None:
            weights = np.full(n_st, 1.0 / n_st)
        weights = np.asarray(weights)
        if weights.ndim not in (1, 2) or weights.shape[0] != n_st:
            raise ValueError(f"weights shape {weights.shape} does not "
                             f"lead with the {n_st} stations")
        if mode == "incoherent" and np.iscomplexobj(weights):
            raise ValueError("incoherent weights must be real")
        extra = len(ih.sample_shape) - weights.ndim
        self._w = (weights.astype(np.float32) if mode == "incoherent"
                   else weights.astype(np.complex64)
                   ).reshape((1,) + weights.shape + (1,) * extra)
        self._mode = mode
        real_dtype = np.empty(0, dtype=ih.dtype).real.dtype
        super().__init__(ih, dtype=(real_dtype if mode == "incoherent"
                                    else ih.dtype))

    @property
    def mode(self):
        return self._mode

    def _output_sample_shape(self, ih):
        return ih.sample_shape[1:]

    def task(self, data):
        x = jnp.asarray(data)
        if self._mode == "incoherent":
            x = x.real ** 2 + x.imag ** 2
        return jnp.sum(x * self._w, axis=1)


def tied_array_beam(streams, n_chan, *, weights=None, mode="coherent",
                    delays=None, lo=None, samples_per_frame=None,
                    method="phase"):
    """Build a lazy tied-array (or incoherent) beam over station
    voltage streams.

    Parameters mirror :func:`~.models.correlator.fx_correlate`
    (``delays``/``lo``/``method`` do the same alignment + fringe
    stopping); ``weights``/``mode`` as in :class:`BeamformStations`.

    Returns a stream of beam spectra, samples ``(n_chan,) + trailing``
    — feed it to ``Dechannelize`` for a beamformed voltage time series,
    or ``Square``/``Fold`` for tied-array pulsar observing.
    """
    stacked = _aligned_spectra(streams, n_chan, delays=delays, lo=lo,
                               samples_per_frame=samples_per_frame,
                               method=method)
    return BeamformStations(stacked, weights, mode=mode)
