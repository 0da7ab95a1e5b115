"""Incoherent DM-trial search: many trial dedispersions as one matmul.

The classic FRB/pulsar search operation: given channelized power
(intensity) data, dedisperse at ``n_dm`` trial dispersion measures and
look for pulses.  CPU codes shift-and-add per trial (or use subband
trees); on device the whole trial bank becomes two FFTs and one matmul:

    P(t, c)  --rfft_t-->  P(f, c)
    D(f, j)  =  sum_c P(f, c) · exp(-2πi f τ(c, DM_j))     (matmul!)
    d(t, j)  --irfft_f--  dedispersed time series per trial

The phase matrix exp(-2πi f τ) implements the per-channel *fractional*
sample shifts exactly (no rounding to integer samples, unlike
shift-and-add), and the sum over channels is a batched matmul at
``Precision.HIGHEST`` (full float32: at lower precisions an H100 may
round the operands to TF32).

Reference scope: baseband-tasks has no DM search (its DisperseSamples
applies one DM, dispersion.py:193); this is new capability in the same
domain.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..dm import DispersionMeasure
from ..utils import units as u

__all__ = ["DMTrialSearch"]


class DMTrialSearch:
    """A compiled trial-dedispersion bank over channelized power data.

    Parameters
    ----------
    frequency : Quantity (n_chan,)
        Channel centre frequencies.
    sample_rate : Quantity
        Time resolution of the input power samples.
    dms : array-like or DispersionMeasure (n_dm,)
        Trial dispersion measures.
    n_time : int
        Samples per processed block (power of two recommended).
    reference_frequency : Quantity, optional
        Delays are relative to this frequency (default: max channel, so
        all trial delays are positive).

    Call :meth:`search` with a ``(n_time, n_chan)`` float32 block to get
    ``(n_time, n_dm)`` trial-dedispersed time series.  The tail
    ``max_delay_samples`` of each output column wraps (circular FFT
    convention) — feed overlapping blocks and discard the tail, exactly
    like overlap-save.
    """

    def __init__(self, frequency, sample_rate, dms, n_time, *,
                 reference_frequency=None):
        freq = u.Quantity(np.atleast_1d(np.asarray(
            frequency.to_value(u.MHz), dtype=np.float64)), u.MHz)
        if not isinstance(dms, DispersionMeasure):
            dms = DispersionMeasure(np.atleast_1d(np.asarray(dms,
                                                             dtype=float)))
        if reference_frequency is None:
            reference_frequency = u.Quantity(
                freq.to_value(u.MHz).max(), u.MHz)
        self.frequency = freq
        self.dms = dms
        self.reference_frequency = reference_frequency
        self.sample_rate = sample_rate
        self.n_time = int(n_time)
        rate_hz = sample_rate.to_value(u.Hz)
        # delay per (chan, trial) in samples
        tau = dms.time_delay(freq[:, np.newaxis],
                             reference_frequency).to_value(u.s) * rate_hz
        self.max_delay_samples = int(np.ceil(np.abs(tau).max()))
        if self.max_delay_samples >= self.n_time:
            raise ValueError(
                f"n_time {n_time} shorter than the maximum trial delay "
                f"({self.max_delay_samples} samples); raise n_time or "
                f"lower the DM range")
        f = np.fft.rfftfreq(self.n_time)[:, np.newaxis, np.newaxis]
        # advancing channel c by its delay tau removes the dispersion:
        # y(t) = x(t + tau)  <->  X(f)·exp(+2πi f tau)
        phase = np.exp(+2j * np.pi * f * tau[np.newaxis]) \
            .astype(np.complex64)                  # (n_freq, n_chan, n_dm)
        self._n_freq = phase.shape[0]
        # float32 planes of the complex phase table
        self._phase_r = jnp.asarray(phase.real)
        self._phase_i = jnp.asarray(phase.imag)
        self._jsearch = jax.jit(self._search_impl)
        self._detect_cache = {}  # widths tuple -> jitted boxcar kernel

    def _search_impl(self, power, pr, pi):
        ft = jnp.fft.rfft(power.astype(jnp.float32), axis=0)
        fr = jnp.real(ft)
        fi = jnp.imag(ft)

        # D(f, j) = sum_c F(f, c)·(pr + i·pi)(f, c, j): real batched
        # matmuls (batch = frequency bin)
        def bmm(a, b):
            return jax.lax.dot_general(
                a[:, None, :], b, dimension_numbers=(((2,), (1,)),
                                                     ((0,), (0,))),
                precision=jax.lax.Precision.HIGHEST,
                preferred_element_type=jnp.float32)[:, 0, :]

        dr = bmm(fr, pr) - bmm(fi, pi)
        di = bmm(fr, pi) + bmm(fi, pr)
        return jnp.fft.irfft(jax.lax.complex(dr, di), n=self.n_time,
                             axis=0)

    def search(self, power):
        """Trial-dedisperse one block: (n_time, n_chan) -> (n_time, n_dm).

        Only rows ``[0, n_time - max_delay_samples)`` are valid
        (the rest wrap circularly).
        """
        power = jnp.asarray(power)
        if power.shape != (self.n_time, len(self.frequency)):
            raise ValueError(
                f"expected block shape ({self.n_time}, "
                f"{len(self.frequency)}), got {power.shape}")
        return self._jsearch(power, self._phase_r, self._phase_i)

    def search_sharded(self, power, mesh, *, axis_name="dm"):
        """Trial-dedisperse one block with the DM trials sharded across
        a device mesh axis (SURVEY §7 step 10's "config 5" ambition for
        the search models).

        Each device holds ``n_dm / shards`` trial chirps and computes
        its own slice of the trial bank — the input block and its time
        FFT are replicated (they are shared work at 1/n_dm of the matmul
        cost), the (n_freq, n_chan, n_dm) phase tables and the
        (n_time, n_dm) output are sharded on the trial axis, so the
        bank's memory and matmul work scale down per device.  Returns the
        same (n_time, n_dm) array as :meth:`search` (sharded on its
        last axis).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        if axis_name not in mesh.shape:
            raise ValueError(f"mesh has no axis {axis_name!r}; "
                             f"axes are {tuple(mesh.shape)}")
        n_shards = int(mesh.shape[axis_name])
        n_dm = len(self.dms)
        if n_dm % n_shards:
            raise ValueError(f"n_dm {n_dm} must divide over the "
                             f"{n_shards} {axis_name!r} shards")
        power = jnp.asarray(power)
        if power.shape != (self.n_time, len(self.frequency)):
            raise ValueError(
                f"expected block shape ({self.n_time}, "
                f"{len(self.frequency)}), got {power.shape}")
        # cache the jit wrapper AND the sharded trial tables per mesh:
        # re-placing the (n_freq, n_chan, n_dm) tables and re-tracing
        # per block would dominate a survey loop
        key = (tuple(mesh.shape.items()), tuple(mesh.devices.flat),
               axis_name)
        cached = getattr(self, "_sharded_cache", {}).get(key)
        if cached is None:
            trial_spec = NamedSharding(mesh, P(None, None, axis_name))
            pr = jax.device_put(self._phase_r, trial_spec)
            pi = jax.device_put(self._phase_i, trial_spec)
            fn = jax.jit(self._search_impl,
                         out_shardings=NamedSharding(
                             mesh, P(None, axis_name)))
            cached = (fn, pr, pi, NamedSharding(mesh, P()))
            if not hasattr(self, "_sharded_cache"):
                self._sharded_cache = {}
            self._sharded_cache[key] = cached
        fn, pr, pi, rep = cached
        return fn(jax.device_put(power, rep), pr, pi)

    def detect(self, power, widths=(1, 2, 4, 8, 16, 32)):
        """Matched-filter the trial bank with boxcars and return S/N.

        For each trial DM and boxcar width ``w`` (samples), computes the
        running ``w``-sample mean via cumulative sums (O(1) per width, no
        convolutions), normalizes by the per-trial off-pulse noise
        (median/MAD-free: mean and std over the valid region), and
        returns the best S/N over widths.

        Returns ``(snr, best_width)``: two (n_valid, n_dm) float32
        arrays, where ``snr[t, j]`` is the significance of a pulse
        *starting* at sample ``t`` in trial ``j``.
        """
        d = self.search(power)
        valid = self.n_time - self.max_delay_samples
        d = d[:valid]
        widths = tuple(int(w) for w in widths)
        cached = self._detect_cache.get(widths)
        if cached is not None:
            snr, bw = cached(d)
            return np.asarray(snr), np.asarray(bw)

        @jax.jit
        def _detect(d):
            mu = jnp.mean(d, axis=0, keepdims=True)
            sd = jnp.std(d, axis=0, keepdims=True) + 1e-30
            z = (d - mu) / sd
            c = jnp.concatenate(
                [jnp.zeros((1,) + z.shape[1:], z.dtype),
                 jnp.cumsum(z, axis=0)])
            best_snr = jnp.full(z.shape, -jnp.inf, z.dtype)
            best_w = jnp.zeros(z.shape, jnp.float32)
            for w in widths:
                # sum over [t, t+w) then back to significance: the sum of
                # w unit-variance samples has std sqrt(w)
                s = (c[w:] - c[:-w]) / np.sqrt(w)
                s = jnp.concatenate(
                    [s, jnp.full((w - 1,) + s.shape[1:], -jnp.inf,
                                 s.dtype)]) if w > 1 else s
                take = s > best_snr
                best_snr = jnp.where(take, s, best_snr)
                best_w = jnp.where(take, jnp.float32(w), best_w)
            return best_snr, best_w

        self._detect_cache[widths] = _detect
        snr, bw = _detect(d)
        return np.asarray(snr), np.asarray(bw)

    def candidates(self, power, threshold=8.0,
                   widths=(1, 2, 4, 8, 16, 32), time_tol=None,
                   dm_tol=None):
        """Clustered single-pulse candidates from one block.

        Runs :meth:`detect`, thresholds the (time, trial) S/N map, and
        clusters the hits greedily by descending S/N (heimdall-style,
        time-first): each unclaimed peak becomes a candidate and claims
        every hit within ``time_tol`` samples across ALL trial DMs — a
        bright pulse crosses the threshold over a wide swath of
        mismatched trials whose peaks drift in time (the DM-time
        "bowtie"), so the default tolerance is the search's own
        ``max_delay_samples`` (or twice the summed boxcar widths if
        larger), and DM is not a clustering axis unless ``dm_tol``
        (trials) is given.

        Returns a list of dicts, strongest first:
        ``{'time_sample', 'dm', 'snr', 'width', 'n_hits'}`` with ``dm``
        in the trial units (pc/cm^3).
        """
        snr, bw = self.detect(power, widths)
        tj = np.argwhere(snr > threshold)
        if tj.size == 0:
            return []
        s = snr[tj[:, 0], tj[:, 1]]
        w = bw[tj[:, 0], tj[:, 1]]
        order = np.argsort(-s)
        t, j = tj[order, 0], tj[order, 1]
        s, w = s[order], w[order]
        claimed = np.zeros(t.size, bool)
        dmv = np.asarray(self.dms.value if hasattr(self.dms, "value")
                         else self.dms).reshape(-1)
        out = []
        for i in range(t.size):
            if claimed[i]:
                continue
            tol = (time_tol if time_tol is not None
                   else np.maximum(2 * (max(w[i], 1) + np.maximum(w, 1)),
                                   self.max_delay_samples))
            near = ~claimed & (np.abs(t - t[i]) <= tol)
            if dm_tol is not None:
                near &= np.abs(j - j[i]) <= dm_tol
            claimed |= near
            out.append({"time_sample": int(t[i]),
                        "dm": float(dmv[j[i]]),
                        "snr": float(s[i]), "width": int(w[i]),
                        "n_hits": int(near.sum())})
        return out

    def search_stream(self, ih, count=None):
        """Overlap-save search over a stream of channelized power.

        Reads successive overlapping ``n_time`` windows from ``ih``
        (shape (n, n_chan)), discards the wrapped tail, and concatenates
        ``count`` valid output samples (default: as many as available).
        """
        valid = self.n_time - self.max_delay_samples
        n_avail = ih.shape[0] - ih.tell() - self.max_delay_samples
        if count is None:
            count = n_avail
        count = min(count, n_avail)
        if count <= 0:
            raise ValueError(
                f"no valid output available: the stream must have more "
                f"than max_delay_samples ({self.max_delay_samples}) "
                f"samples beyond the current position")
        outs = []
        got = 0
        while got < count:
            start = ih.tell()
            block = np.asarray(ih.read(min(self.n_time,
                                           ih.shape[0] - start)))
            if block.shape[0] < self.n_time:
                pad = np.zeros((self.n_time - block.shape[0],)
                               + block.shape[1:], block.dtype)
                block = np.concatenate([block, pad])
            take = min(valid, count - got)
            outs.append(np.asarray(self.search(block))[:take])
            got += take
            ih.seek(start + take)
        return np.concatenate(outs)
