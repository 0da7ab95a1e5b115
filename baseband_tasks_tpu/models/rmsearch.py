"""Rotation-measure synthesis: the Faraday depth spectrum as one matmul
over channels.

Beyond the reference.  Faraday rotation winds the complex linear
polarization ``P(lambda**2) = Q + iU`` as ``exp(2 i phi lambda**2)``
for emission at Faraday depth ``phi``; RM synthesis (Burn 1966;
Brentjens & de Bruyn 2005) inverts that by correlating against a bank
of trial depths:

    F(phi) = sum_k w_k P_k exp(-2 i phi (lambda_k^2 - lambda_0^2))
             / sum_k w_k

On device the whole bank is a single ``(..., n_chan) @ (n_chan, n_phi)``
matmul — the same shape that makes :class:`~.models.DMTrialSearch` fast —
at ``Precision.HIGHEST`` (full float32 products).  Sign conventions match
:class:`~.faraday.FaradayRotate` (psi = RM lambda**2, P winding 2 psi),
so a voltage stream rotated by ``rm`` peaks at ``phi = rm``
(tests/test_faraday.py runs that end to end).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..faraday import C_M_PER_S, _rm_to_value
from ..utils import units as u

__all__ = ["RMSynthesis"]


class RMSynthesis:
    """Faraday-depth transform of per-channel Stokes Q/U.

    Parameters
    ----------
    frequency : Quantity
        Per-channel frequencies, shape (n_chan,).
    phis : array or Quantity
        Trial Faraday depths (rad/m^2), shape (n_phi,).
    weights : array, optional
        Per-channel weights (default uniform); zero out flagged
        channels here.
    reference_lambda2 : {'mean', float}
        lambda_0^2 derotation point.  'mean' (default) uses the
        weighted mean of lambda^2 — the standard choice that minimizes
        position-angle winding of the RMSF.
    """

    def __init__(self, frequency, phis, *, weights=None,
                 reference_lambda2="mean"):
        freq_hz = np.asarray(frequency.to_value(u.Hz), dtype=np.float64)
        if freq_hz.ndim != 1:
            raise ValueError("frequency must be one-dimensional "
                             "(per channel)")
        self.lam2 = (C_M_PER_S / freq_hz) ** 2
        if isinstance(phis, u.Quantity):
            phis = phis.to_value(u.rad / u.m ** 2)
        self.phis = np.asarray(phis, dtype=np.float64)
        w = (np.ones_like(self.lam2) if weights is None
             else np.asarray(weights, dtype=np.float64))
        if w.shape != self.lam2.shape:
            raise ValueError("weights must match the channel count")
        self.weights = w
        wsum = w.sum()
        if not wsum > 0:
            raise ValueError("weights sum to zero")
        if reference_lambda2 == "mean":
            self.lam2_0 = float((w * self.lam2).sum() / wsum)
        else:
            self.lam2_0 = float(reference_lambda2)
        theta = -2.0 * np.outer(self.lam2 - self.lam2_0, self.phis)
        self._tr = jnp.asarray((w[:, None] * np.cos(theta) / wsum)
                               .astype(np.float32))
        self._ti = jnp.asarray((w[:, None] * np.sin(theta) / wsum)
                               .astype(np.float32))

    @property
    def n_phi(self):
        return self.phis.size

    @staticmethod
    def _fdf_impl(q, u_, tr, ti):
        def dot(x, m):
            return jax.lax.dot_general(
                x, m, (((x.ndim - 1,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST)

        fr = dot(q, tr) - dot(u_, ti)
        fi = dot(q, ti) + dot(u_, tr)
        return jax.lax.complex(fr, fi)

    def fdf(self, q, u_):
        """Faraday dispersion function F(phi) of Stokes planes.

        ``q``/``u_`` have channels on the LAST axis (any leading axes);
        returns complex (..., n_phi).
        """
        return self._fdf_impl(jnp.asarray(q, jnp.float32),
                              jnp.asarray(u_, jnp.float32),
                              self._tr, self._ti)

    def fdf_sharded(self, q, u_, mesh, *, axis_name="phi"):
        """:meth:`fdf` with the trial-depth bank sharded across a mesh
        axis: each device holds ``n_phi / shards`` columns of the
        (n_chan, n_phi) transfer tables and computes its slice of the
        Faraday spectrum — the phi axis is a pure output axis of the
        matmul, so there is ZERO communication and a depth grid too
        large for one chip scales across the mesh.  A grid that does
        not divide the shard count is zero-padded internally and
        trimmed from the returned (..., n_phi) spectrum (sharded on
        its last axis).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .meshtools import (mesh_cache_key, pad_to_multiple,
                                require_mesh_axis)

        n_shards = require_mesh_axis(mesh, axis_name)
        key = mesh_cache_key(mesh, axis_name)
        cached = getattr(self, "_sharded_cache", {}).get(key)
        if cached is None:
            n_phi = self.n_phi
            pad = pad_to_multiple(n_phi, n_shards)
            tr, ti = np.asarray(self._tr), np.asarray(self._ti)
            if pad:
                z = np.zeros((tr.shape[0], pad), tr.dtype)
                tr = np.concatenate([tr, z], axis=1)
                ti = np.concatenate([ti, z], axis=1)
            bank_spec = NamedSharding(mesh, P(None, axis_name))
            trd = jax.device_put(jnp.asarray(tr), bank_spec)
            tid = jax.device_put(jnp.asarray(ti), bank_spec)
            fn = jax.jit(self._fdf_impl)
            cached = (fn, trd, tid, NamedSharding(mesh, P()), n_phi)
            if not hasattr(self, "_sharded_cache"):
                self._sharded_cache = {}
            self._sharded_cache[key] = cached
        fn, trd, tid, rep, n_phi = cached
        f = fn(jax.device_put(jnp.asarray(q, jnp.float32), rep),
               jax.device_put(jnp.asarray(u_, jnp.float32), rep),
               trd, tid)
        return f[..., :n_phi] if f.shape[-1] != n_phi else f

    def rmsf(self, oversample=2):
        """RM spread function (the transform of the weights alone) over
        a ``oversample``-times-wider depth grid, as (phis, complex)."""
        span = self.phis.max() - self.phis.min()
        mid = 0.5 * (self.phis.max() + self.phis.min())
        # odd point count -> the grid contains the exact midpoint
        # (where the RMSF peaks for symmetric trial grids)
        phis = np.linspace(mid - oversample * span / 2,
                           mid + oversample * span / 2,
                           oversample * max(self.phis.size, 2) + 1)
        theta = -2.0 * np.outer(phis, self.lam2 - self.lam2_0)
        w = self.weights / self.weights.sum()
        return phis, (np.exp(1j * theta) @ w)

    def candidates(self, q, u_, threshold=5.0):
        """(phi, |F|, snr) rows where ``|F(phi)|`` exceeds ``threshold``
        times the median |F| (host-side; for survey-scale use `fdf`
        under jit and threshold on device)."""
        f = np.asarray(self.fdf(q, u_))
        mag = np.abs(f).reshape(-1, self.n_phi)
        med = np.median(mag, axis=-1, keepdims=True)
        snr = mag / np.maximum(med, 1e-30)
        out = []
        for row in range(mag.shape[0]):
            for j in np.flatnonzero(snr[row] > threshold):
                out.append((float(self.phis[j]), float(mag[row, j]),
                            float(snr[row, j])))
        return out

    @staticmethod
    def stokes_qu(power_data, pol_axis=-1):
        """(Q, U) from :class:`~.functions.Power` output components
        ``[XX, YY, Re(XY*), Im(XY*)]`` (linear feeds): Q = XX - YY,
        U = 2 Re(X Y*)."""
        p = jnp.moveaxis(jnp.asarray(power_data), pol_axis, -1)
        return p[..., 0] - p[..., 1], 2.0 * p[..., 2]
