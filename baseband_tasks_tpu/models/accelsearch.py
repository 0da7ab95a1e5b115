"""Fourier-domain acceleration search: drifting-tone matched filters.

A pulsar in a compact binary drifts in spin frequency during an
observation; its power smears over ``z = f_dot T**2`` Fourier bins and a
plain FFT search loses it.  The standard recovery (Ransom, Eikenberry &
Middleditch 2002; PRESTO's ``accelsearch``; GPU formulation in
arXiv:1711.10855) correlates the complex spectrum with a bank of
constant-``f_dot`` templates — the Fourier response of a linearly
drifting tone — and searches the resulting (frequency, z) map.

Two engines compute the same map.  'xla' (the default, ``engine='auto'``)
is overlap-save in the Fourier domain: FFT each spectrum segment,
multiply by every template's transfer function, inverse FFT.  'mx' uses
that the template span is short (m = 256 taps at z_max 64): the
per-segment correlation against the whole bank is one matmul, with
overlap-save windows of L = 2m spectrum bins (built by two shifted
reshapes — no gather) contracted against the device-resident banded
operator ``M_z[f, k] = conj(t_z)[f-k]``; the m-fold im2col duplication
lives in that constant, not in the data.  Its matmuls run at
``Precision.HIGHEST`` (full float32 products; lower precisions round
the operands to TF32 or bfloat16 on an H100).

Beyond-reference scope: baseband-tasks has no searching at all; this
composes with :class:`~baseband_tasks_tpu.models.dmsearch.DMTrialSearch`
(incoherent DM trials) for the full FRB/binary-pulsar survey chain.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..utils import units as u

__all__ = ["FourierDomainAccelSearch", "accel_template"]


def accel_template(z, m):
    """Fourier response of a unit tone drifting ``z`` bins, length ``m``.

    The DFT of ``exp(2πi (b0 t + z t²/2))`` over a unit observation,
    sampled at integer bin offsets ``b - b0`` in [-m/2, m/2): the
    complex Fresnel kernel the spectrum must be correlated with to
    concentrate a drifting tone back into one bin.  Computed by direct
    numerical integration (512 steps — relative error < 1e-4 for
    |z| < ~200, ample for matched filtering).
    """
    offs = np.arange(m) - m // 2
    t = (np.arange(512) + 0.5) / 512.0
    # response at bin offset b: mean_t exp(2πi (z t²/2 - b t))
    phase = 2j * np.pi * (0.5 * z * t[np.newaxis] ** 2
                          - offs[:, np.newaxis] * t[np.newaxis])
    return np.exp(phase).mean(axis=1).astype(np.complex64)


class FourierDomainAccelSearch:
    """A compiled (frequency, z) correlation search.

    Parameters
    ----------
    n_time : int
        Length of the input time series (power samples).
    sample_rate : Quantity
        Rate of the input time series.
    z_max : float
        Largest drift searched, in Fourier bins over the observation
        (``z = f_dot T²``); the bank covers ``[-z_max, z_max]``.
    z_step : float
        Bank spacing in bins (2 is the classic choice: the response
        half-width).
    seg_len : int
        Spectrum segment length for the overlap-save correlation
        (power of two recommended).

    Call :meth:`search` with the ``(n_time,)`` float series to get the
    ``(n_freq, n_z)`` normalized power map, or :meth:`candidates` for
    thresholded peaks.
    """

    def __init__(self, n_time, sample_rate, *, z_max=64.0, z_step=2.0,
                 seg_len=4096, engine="auto"):
        self.n_time = int(n_time)
        self.sample_rate = sample_rate
        self.zs = np.arange(-z_max, z_max + 0.5 * z_step, z_step)
        # template width: the response spans ~|z| bins plus wings
        self.m = int(2 ** np.ceil(np.log2(max(2 * z_max + 32, 64))))
        if seg_len <= self.m:
            raise ValueError(f"seg_len {seg_len} must exceed the "
                             f"template span {self.m}")
        if engine not in ("auto", "mx", "xla"):
            raise ValueError(f"engine={engine!r}: 'auto', 'mx' or 'xla'")
        #: 'xla' -> overlap-save FFT (broadcast-multiply + batched
        #: IFFT); 'mx' -> the banded-operator bank matmul
        #: (_search_impl_mx); 'auto' -> 'xla'
        self.engine = "xla" if engine == "auto" else engine
        self.seg_len = int(seg_len)
        self.n_freq = self.n_time // 2 + 1
        # template transfer functions at the segment length: correlation
        # = IFFT(FFT(segment) * conj(FFT(template)))
        bank = np.stack([accel_template(z, self.m) for z in self.zs])
        padded = np.zeros((len(self.zs), self.seg_len), np.complex64)
        padded[:, :self.m] = bank
        tf = np.conj(np.fft.fft(padded, axis=1)).astype(np.complex64)
        self._tf_r = jnp.asarray(tf.real)
        self._tf_i = jnp.asarray(tf.imag)
        # conjugate template taps for the mx engine: (n_z, m) f32
        # planes, kr + i*ki = conj(t)
        self._taps_r = jnp.asarray(np.ascontiguousarray(
            bank.real.astype(np.float32)))
        self._taps_i = jnp.asarray(np.ascontiguousarray(
            (-bank.imag).astype(np.float32)))
        self._valid = self.seg_len - self.m
        self._n_seg = -(-self.n_freq // self._valid)
        self._jsearch = jax.jit(functools.partial(self._search_impl))
        self._jsearch_mx = None
        self._mx_cache = None

    @property
    def freqs(self):
        """Centre frequency of every row of the map."""
        return u.Quantity(
            np.arange(self.n_freq)
            * self.sample_rate.to_value(u.Hz) / self.n_time, u.Hz)

    @property
    def z_values(self):
        return self.zs

    def _search_impl(self, x, tf_r, tf_i):
        # spectrum normalized so each bin's noise power is ~1
        # (chi^2_2/2); overlap-save segments along frequency with the
        # template span m at the FRONT of each window (correlation
        # trims the first m-1 lags)
        segs = self._segments(x)                   # (n_seg, seg_len)
        F = jnp.fft.fft(segs, axis=1)
        tf = jax.lax.complex(tf_r, tf_i)           # (n_z, seg_len)
        prod = F[:, None, :] * tf[None, :, :]
        corr = jnp.fft.ifft(prod, axis=2)          # (n_seg, n_z, seg_len)
        # circular cross-correlation lag j sums spec[s·valid + j + offs]
        # over template offsets (the pad//2 front zeros and the
        # template's m//2 centre offset cancel against pad = m), so
        # lag j IS spectrum bin s·valid + j: keep the first `valid` lags
        # (j <= seg_len - m never wraps)
        valid = corr[:, :, :self._valid]
        power = jnp.abs(valid) ** 2
        # bank size from the tables themselves: search_sharded may pad
        # the bank to a multiple of the shard count
        zmap = power.transpose(0, 2, 1).reshape(-1, tf_r.shape[0])
        return zmap[:self.n_freq]

    def _spectrum(self, x):
        """Bin-noise-normalized rfft of the (mean-removed) series."""
        x = x.astype(jnp.float32)
        x = x - jnp.mean(x)
        spec = jnp.fft.rfft(x)
        norm = jnp.sqrt(jnp.mean(jnp.abs(spec[1:]) ** 2) + 1e-30)
        return spec / norm

    def _segments(self, x):
        """Normalize the spectrum and cut overlap-save segments."""
        spec = self._spectrum(x)
        pad = self.m
        total = self._n_seg * self._valid + pad
        specp = jnp.concatenate(
            [jnp.zeros(pad // 2, spec.dtype), spec,
             jnp.zeros(total - self.n_freq - pad // 2, spec.dtype)])
        idx = (jnp.arange(self._n_seg)[:, None] * self._valid
               + jnp.arange(self.seg_len)[None, :])
        return specp[idx]                          # (n_seg, seg_len)

    def _mx_planes(self):
        """f32 planes of the banded correlation operator
        ``M_z[f, k] = conj(t_z)[f - k]`` (zero outside ``0 <= f-k < m``)
        stored as (L, m, n_z) Karatsuba planes, L = 2m — so that
        ``corr[s, z, k] = sum_f segs[s, f] M_z[f, k]
                        = sum_j segs[s, k+j] conj(t_z)[j]``
        IS the correlation lag ``k`` of segment ``s``.  The m-fold
        "im2col" duplication lives in this device-resident constant
        (n_z * L * m floats, ~34 MB/plane at z_max 64), not in the
        data: the spectrum is read once per search.  Built on host."""
        if self._mx_cache is None:
            L = 2 * self.m
            kr = np.asarray(self._taps_r)      # conj-tap planes (n_z, m)
            ki = np.asarray(self._taps_i)
            f = np.arange(L)[:, None]
            k = np.arange(self.m)[None, :]
            d = f - k                          # (L, m) tap index
            band = (d >= 0) & (d < self.m)
            dc = np.clip(d, 0, self.m - 1)
            mr = np.where(band[None], kr[:, dc], 0.0).astype(np.float32)
            mi = np.where(band[None], ki[:, dc], 0.0).astype(np.float32)
            # (f, k, z) axis order so the dot output is (s, k, z) and
            # the final (n_freq, n_z) reshape is layout-free — the
            # (s, z, k) ordering paid a 2 x 545 MB transpose
            # round-trip at 2^22.  Three Karatsuba planes (a, b, c):
            #   t = (fr+fi) @ a;  u = fi @ b;  v = fr @ c
            #   cr = t - u;       ci = t + v
            # (3 dots + 3 outputs instead of 4, exact in f32)
            mr = mr.transpose(1, 2, 0)         # (L, m, n_z)
            mi = mi.transpose(1, 2, 0)
            self._mx_cache = tuple(
                jnp.asarray(np.ascontiguousarray(p.astype(np.float32)))
                for p in (mr, mr + mi, mi - mr))
        return self._mx_cache

    def _search_impl_mx(self, x, ka, kb, kc):
        """Matmul path: overlap-save correlation as one bank matmul.

        Windows of ``L = 2m`` spectrum bins advance by ``valid = m``,
        so each segment is the concatenation of two adjacent rows of
        the (n_seg+1, m)-reshaped padded spectrum — two shifted
        reshapes, no gather.  The template product and inverse DFT are
        folded into the per-template constant ``M_z``
        (:meth:`_mx_planes`), so the whole bank correlation is three
        Karatsuba ``einsum('sf,fkz->skz')`` dots — (n_seg x L) @
        (L x m*n_z) matmuls with contraction L = 512, with the
        (s, k, z) output order making the final (n_freq, n_z) reshape
        layout-free."""
        m = self.m
        valid = m
        n_seg = -(-self.n_freq // valid)
        total = (n_seg + 1) * valid
        front = m // 2
        spec = self._spectrum(x)

        def segs(p):
            p = jnp.concatenate(
                [jnp.zeros(front, p.dtype), p,
                 jnp.zeros(total - front - self.n_freq, p.dtype)])
            rows = p.reshape(n_seg + 1, valid)
            return jnp.concatenate([rows[:-1], rows[1:]], axis=1)

        fr, fi = segs(jnp.real(spec)), segs(jnp.imag(spec))
        def dot(x_, p):
            return jnp.einsum("sf,fkz->skz", x_, p,
                              precision=jax.lax.Precision.HIGHEST)

        # Karatsuba complex correlation: 3 dots instead of 4
        t = dot(fr + fi, ka)
        u = dot(fi, kb)
        v = dot(fr, kc)
        cr = t - u
        ci = t + v
        power = cr * cr + ci * ci                   # (n_seg, m, n_z)
        zmap = power.reshape(-1, ka.shape[-1])
        return zmap[:self.n_freq]

    def _use_mx(self):
        return self.engine == "mx"

    def search(self, x):
        """(n_freq, n_z) normalized drift-corrected power map of the
        ``(n_time,)`` real time series (noise bins ~ chi²₂/2 ≈ 1)."""
        x = jnp.asarray(x)
        if x.shape != (self.n_time,):
            raise ValueError(f"expected shape ({self.n_time},), got "
                             f"{x.shape}")
        if self._use_mx():
            if self._jsearch_mx is None:
                planes = tuple(jnp.asarray(p) for p in self._mx_planes())
                self._jsearch_mx = jax.jit(
                    lambda xx: self._search_impl_mx(xx, *planes))
            return self._jsearch_mx(x)
        return self._jsearch(x, self._tf_r, self._tf_i)

    def search_sharded(self, x, mesh, *, axis_name="z"):
        """:meth:`search` with the template bank sharded across a mesh
        axis (SURVEY §7 step 10: blind-search trial banks are the
        embarrassingly parallel multi-chip workload).

        The z axis is a pure batch axis of the whole computation — each
        device holds ``n_z / shards`` template transfer functions and
        correlates the (replicated) spectrum segments against its own
        slice, ZERO communication — so a ``z_max`` too big for one
        chip's HBM scales across the mesh.  A bank whose size does not
        divide the shard count is zero-padded internally (padded
        templates are all-zero -> zero power) and the pad is trimmed
        from the returned map.  Returns the same (n_freq, n_z) map as
        :meth:`search`, sharded on its z axis.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .meshtools import (mesh_cache_key, pad_to_multiple,
                                require_mesh_axis)

        n_shards = require_mesh_axis(mesh, axis_name)
        x = jnp.asarray(x)
        if x.shape != (self.n_time,):
            raise ValueError(f"expected shape ({self.n_time},), got "
                             f"{x.shape}")
        key = mesh_cache_key(mesh, axis_name)
        cached = getattr(self, "_sharded_cache", {}).get(key)
        if cached is None:
            n_z = len(self.zs)
            pad = pad_to_multiple(n_z, n_shards)
            # the mx engine shards identically (the bank axis is the
            # LAST axis of its operator planes); each engine keeps its
            # own arithmetic so sharded and single-device paths agree
            if self.engine == "xla":
                impl = self._search_impl
                planes = (np.asarray(self._tf_r),
                          np.asarray(self._tf_i))
                bank_axis = 0
                bank_spec = NamedSharding(mesh, P(axis_name, None))
            else:
                impl = self._search_impl_mx
                planes = tuple(np.asarray(p) for p in self._mx_planes())
                bank_axis = 2
                bank_spec = NamedSharding(mesh,
                                          P(None, None, axis_name))
            if pad:
                def padz(p):
                    w = [(0, 0)] * p.ndim
                    w[bank_axis] = (0, pad)
                    return np.pad(p, w)
                planes = tuple(padz(p) for p in planes)
            dev = tuple(jax.device_put(jnp.asarray(p), bank_spec)
                        for p in planes)
            fn = jax.jit(impl,
                         out_shardings=NamedSharding(
                             mesh, P(None, axis_name)))
            cached = (fn, dev, NamedSharding(mesh, P()), n_z)
            if not hasattr(self, "_sharded_cache"):
                self._sharded_cache = {}
            self._sharded_cache[key] = cached
        fn, dev, rep, n_z = cached
        zmap = fn(jax.device_put(x, rep), *dev)
        return zmap[:, :n_z] if zmap.shape[1] != n_z else zmap

    def harmonic_sum(self, zmap, n_harm=4):
        """Incoherent harmonic summing of a (frequency, z) map.

        A pulsed (non-sinusoidal) signal puts power in harmonics: the
        k-th harmonic of a tone at (f, z) sits at (k·f, k·z).  Summing
        ``zmap[k·f, nearest(k·z)]`` for k = 1..n_harm (the classic
        PRESTO scheme) recovers that power; the summed map's noise is
        ~chi²(2·n_harm)/2, so thresholds scale accordingly.

        Returns the (n_freq, n_z) summed map (host array; rows whose
        k-th harmonic falls off the spectrum keep partial sums).
        """
        zmap = np.asarray(zmap)
        nf, nz = zmap.shape
        out = zmap.copy()
        for k in range(2, int(n_harm) + 1):
            fi = np.arange(nf) * k
            ok = fi < nf
            # column of the k-scaled drift, clipped to the bank edge
            zi = np.abs(self.zs[:, None] * k
                        - self.zs[None, :]).argmin(axis=1)
            out[ok] += zmap[fi[ok]][:, zi]
        return out

    def candidates(self, x, threshold=25.0, exclude_dc=16):
        """Thresholded peaks of the z-map.

        Returns a list of ``(frequency Quantity, z_bins, power)`` sorted
        by power, keeping one entry per local maximum above
        ``threshold`` (normalized power; ~chi²₂/2 units).  The first
        ``exclude_dc`` frequency bins are skipped (red noise / DC).
        """
        # np.asarray of a device array is read-only; take a real copy
        work = np.array(self.search(x))
        work[:exclude_dc] = 0.0
        out = []
        rate = self.sample_rate.to_value(u.Hz)
        while True:
            i, j = np.unravel_index(np.argmax(work), work.shape)
            p = work[i, j]
            if p < threshold:
                break
            out.append((u.Quantity(i * rate / self.n_time, u.Hz),
                        float(self.zs[j]), float(p)))
            lo = max(i - self.m // 2, 0)
            work[lo:i + self.m // 2 + 1] = 0.0
        return out
