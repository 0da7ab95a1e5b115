"""Fast Folding Algorithm: all trial periods in [p, p+1) at once.

The FFA (Staelin 1969) folds a time series of ``m`` consecutive
segments of ``p`` samples at ``m`` trial periods between ``p`` and
``p + 1`` samples in ``log2(m)`` pairwise-combination stages — the
standard deep search for long-period / high-duty-cycle pulsars where
the FFT-based search (models/accelsearch.py) loses sensitivity to the
sparse harmonic comb.  CPU implementations (e.g. riptide) walk the
recursion per profile; here every stage is one vectorized
``take_along_axis`` + add over the whole (groups, profiles, phase)
array, so the full trial bank advances in ``log2(m)`` fused device
passes of O(m·p) work each — O(m·p·log m) total vs O(m²·p) direct.

Trial ``s`` (0..m-1) aligns segment ``i`` by rotating it back by
``~ i·s/(m-1)`` samples, i.e. it folds at period ``p + s/(m-1)``
samples.  The combination rule per stage (profiles ``j`` of the top and
bottom half-blocks, ``rot(b, k)[phi] = b[(phi + k) mod p]``)::

    out[2j]   = top[j] + rot(bottom[j], j)
    out[2j+1] = top[j] + rot(bottom[j], j + 1)

Reference scope: baseband-tasks has no period search at all; this is
new capability in the same domain, composing with
``DMTrialSearch`` (fold its dedispersed trial series — the batch axis
broadcasts) and ``Integrate`` (producing the input subintegrations).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..utils import units as u

__all__ = ["FastFoldingSearch", "ffa_fold", "ffa_survey"]


def _is_pow2(n):
    return n > 0 and (n & (n - 1)) == 0


@jax.jit
def _ffa(x):
    """Core FFA over the last two axes: (..., m, p) -> (..., m, p)
    profiles, trial s on the m axis (m a power of two, static)."""
    m, p = x.shape[-2], x.shape[-1]
    # state: (..., groups, k profiles, p); start with m groups of 1
    s = x.reshape(x.shape[:-2] + (m, 1, p))
    phase = jax.lax.broadcasted_iota(jnp.int32, (1, p), 1)
    while s.shape[-3] > 1:
        k = s.shape[-2]
        top = s[..., 0::2, :, :]
        bot = s[..., 1::2, :, :]
        j = jax.lax.broadcasted_iota(jnp.int32, (k, 1), 0)
        idx0 = (phase + j) % p            # rotate back by j
        idx1 = (phase + j + 1) % p        # ... by j + 1
        shape = (1,) * (bot.ndim - 2) + (k, p)
        r0 = jnp.take_along_axis(bot, idx0.reshape(shape), axis=-1)
        r1 = jnp.take_along_axis(bot, idx1.reshape(shape), axis=-1)
        # interleave: even trials from (top + r0), odd from (top + r1)
        out = jnp.stack([top + r0, top + r1], axis=-2)
        s = out.reshape(out.shape[:-4] + (s.shape[-3] // 2, 2 * k, p))
    return s[..., 0, :, :]


def ffa_fold(x, p):
    """Fold ``x`` (..., n) at all periods in [p, p+1) samples.

    The last axis is cropped to ``m*p`` with ``m`` the largest power of
    two (the FFA stage structure needs pow2 segment counts); returns
    ``(..., m, p)`` profiles, trial ``s`` = period ``p + s/(m-1)``.
    """
    p = int(p)
    n = x.shape[-1]
    m = n // p
    if m < 2:
        raise ValueError(f"need at least 2 periods of {p} samples, "
                         f"have {n}")
    m = 1 << (m.bit_length() - 1)
    x = x[..., :m * p].reshape(x.shape[:-1] + (m, p))
    return _ffa(x)


class FastFoldingSearch:
    """A compiled FFA trial-period bank.

    Parameters
    ----------
    base_period : int
        Trial-bank start period in samples (``p``).
    n_time : int
        Samples per processed block; the largest pow2 number ``m`` of
        whole base periods is used, giving ``m`` trials with period
        resolution ``1/(m-1)`` samples across ``[p, p+1)``.
    sample_rate : Quantity, optional
        If given, :attr:`trial_periods` comes back as a time Quantity.

    ``fold(x)`` folds a block; ``snr(x, widths=...)`` scores every
    (trial, phase) cell with boxcar matched filters and returns the
    best-width S/N per trial; ``candidates(x, threshold)`` the trials
    exceeding it.  To cover periods beyond ``[p, p+1)``, run one
    instance per integer ``p`` (the standard FFA survey loop), or
    downsample by 2 between octaves.
    """

    def __init__(self, base_period, n_time, *, sample_rate=None):
        self.p = int(base_period)
        if self.p < 2:
            raise ValueError("base_period must be at least 2 samples")
        m = int(n_time) // self.p
        if m < 2:
            raise ValueError(f"n_time={n_time} holds fewer than 2 base "
                             f"periods of {base_period}")
        self.m = 1 << (m.bit_length() - 1)
        self.n_time = int(n_time)
        self.sample_rate = sample_rate
        self._snr_cache = {}

    @property
    def trial_periods(self):
        """Trial periods: samples (or seconds with a sample_rate)."""
        ps = self.p + np.arange(self.m) / max(self.m - 1, 1)
        if self.sample_rate is None:
            return ps
        return u.Quantity(ps / self.sample_rate.to_value(u.Hz), u.s)

    def _check_block(self, x):
        """Validate/crop a block so ``ffa_fold`` lands on exactly this
        instance's ``m`` trials: a shorter block would silently fold at
        a coarser trial grid than :attr:`trial_periods` reports, a
        longer one at a finer grid with more trials than reported."""
        n = x.shape[-1]
        need = self.m * self.p
        if n < need:
            raise ValueError(
                f"block has {n} samples; this search needs at least "
                f"m*p = {self.m}*{self.p} = {need} (constructed for "
                f"n_time={self.n_time}); a shorter block would fold on "
                f"a different trial-period grid")
        return x[..., :need]

    def fold(self, x):
        """(..., n_time) -> (..., m, p) trial profiles."""
        return ffa_fold(self._check_block(jnp.asarray(x)), self.p)

    def _snr_fn(self, widths):
        # a boxcar must stay well under one period: w >= p would wrap
        # a full turn (w >= p crashes, p/2 < w < p silently truncates)
        widths = tuple(w for w in widths if w <= self.p // 2) or (1,)
        cached = self._snr_cache.get(widths)
        if cached is not None:
            return cached
        m, p = self.m, self.p

        @jax.jit
        def fn(x):
            prof = ffa_fold(x, p)
            # robust per-profile baseline and noise (median / MAD): a
            # bright pulse must not inflate its own noise estimate
            base = jnp.median(prof, axis=-1, keepdims=True)
            d = prof - base
            sigma = 1.4826 * jnp.median(jnp.abs(d), axis=-1,
                                        keepdims=True)
            best = None
            for w in widths:
                # circular boxcar of width w via cumsum difference
                c = jnp.cumsum(
                    jnp.concatenate([d, d[..., :w]], axis=-1), axis=-1)
                box = c[..., w:] - c[..., :-w] if w > 1 else d
                # matched-filter normalization: std of a w-bin sum is
                # sqrt(w) · sigma; the boxcar removes w·base exactly.
                # A zero MAD (constant or mostly-zero profile, e.g.
                # zero-filled excision output) carries no noise
                # estimate — score those trials 0, not ~1e30
                s = jnp.where(sigma > 0,
                              box / jnp.maximum(np.sqrt(w) * sigma,
                                                1e-30), 0.0)
                peak = jnp.max(s, axis=-1)
                best = peak if best is None else jnp.maximum(best, peak)
            return best

        self._snr_cache[widths] = fn
        return fn

    def snr(self, x, widths=(1, 2, 4, 8, 16)):
        """Best boxcar-matched S/N per trial: (..., m)."""
        x = self._check_block(jnp.asarray(x))
        return self._snr_fn(tuple(int(w) for w in widths))(x)

    def snr_sharded(self, x, mesh, *, axis_name="batch",
                    widths=(1, 2, 4, 8, 16)):
        """:meth:`snr` of a BATCH of series, sharded across a mesh axis.

        The FFA's m-trial axis is *generated* by the pairwise recursion
        — trials couple across segment halves at every stage, so
        sharding it would cost an exchange per stage.  The
        zero-communication axis of an FFA survey is the batch instead:
        independent series (DM trials from
        :class:`~.models.dmsearch.DMTrialSearch`, beams, polarizations)
        spread over the mesh and each device runs the full recursion on
        its own rows.  ``x`` is ``(n_batch, n_time)``; a batch that
        does not divide the shard count is zero-padded (zero rows have
        zero MAD and score S/N 0) and trimmed from the returned
        ``(n_batch, m)`` map (sharded on its batch axis).
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        from .meshtools import pad_to_multiple, require_mesh_axis

        n_shards = require_mesh_axis(mesh, axis_name)
        x = self._check_block(jnp.asarray(x))
        if x.ndim != 2:
            raise ValueError("snr_sharded wants a (n_batch, n_time) "
                             "stack of series")
        n_batch = x.shape[0]
        pad = pad_to_multiple(n_batch, n_shards)
        if pad:
            x = jnp.concatenate(
                [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
        # the snr function is jitted and batched on axis 0 throughout:
        # placing the input sharded makes GSPMD keep every intermediate
        # (and the output) sharded on that axis, no re-jit needed
        spec = NamedSharding(mesh, P(axis_name))
        s = self._snr_fn(tuple(int(w) for w in widths))(
            jax.device_put(x, spec))
        return s[:n_batch] if pad else s

    def candidates(self, x, threshold=7.0, widths=(1, 2, 4, 8, 16)):
        """Trials whose best S/N exceeds ``threshold``, as a list of
        ``{trial, period, snr}`` dicts sorted by descending S/N (host
        post-processing of the device S/N map)."""
        s = np.asarray(self.snr(x, widths))
        if s.ndim != 1:
            raise ValueError("candidates() wants a single time series; "
                             "loop batch axes on the host")
        periods = self.trial_periods
        hits = np.flatnonzero(s > threshold)
        out = [{"trial": int(t), "period": periods[t],
                "snr": float(s[t])} for t in hits]
        out.sort(key=lambda c: -c["snr"])
        return out


def ffa_survey(x, p_min, p_max, *, sample_rate=None, threshold=7.0,
               widths=(1, 2, 4, 8, 16)):
    """Survey all trial periods in ``[p_min, p_max)`` samples.

    The standard FFA survey loop: one :class:`FastFoldingSearch` per
    integer base period within an octave, downsampling the series by 2
    between octaves so the per-octave work stays ~constant (the classic
    riptide/FFA strategy; time resolution halves per octave, which the
    trial periods and reported candidate periods account for).

    Returns all candidates across the range, sorted by descending S/N,
    each ``{period, snr, trial, base_period, octave}`` with ``period``
    in *original* samples (or a time Quantity with ``sample_rate``).
    """
    x = jnp.asarray(x)
    if x.ndim != 1:
        raise ValueError("ffa_survey wants a single time series")
    p_min, p_max = int(p_min), int(p_max)
    if not 2 <= p_min < p_max:
        raise ValueError("need 2 <= p_min < p_max")
    out = []
    octave = 0
    scale = 1            # original samples per current sample
    lo = p_min
    while lo < p_max:
        hi = min(2 * p_min, (p_max + scale - 1) // scale)
        for p in range(lo, hi):
            if x.shape[-1] < 2 * p:
                break
            f = FastFoldingSearch(p, x.shape[-1])
            s = np.asarray(f.snr(x, widths))
            for t in np.flatnonzero(s > threshold):
                period = (p + t / max(f.m - 1, 1)) * scale
                if period >= p_max:
                    # the last base period's trial bank spans [p, p+1)
                    # in coarse samples; keep the documented range
                    continue
                out.append({"period": period, "snr": float(s[t]),
                            "trial": int(t), "base_period": p,
                            "octave": octave})
        # next octave at half the time resolution
        n2 = x.shape[-1] // 2 * 2
        x = x[:n2].reshape(-1, 2).sum(-1)
        scale *= 2
        octave += 1
        lo = p_min  # base periods repeat per octave on the coarser grid
        if scale * p_min >= p_max:
            break
    if sample_rate is not None:
        rate = sample_rate.to_value(u.Hz)
        for c in out:
            c["period"] = u.Quantity(c["period"] / rate, u.s)
    out.sort(key=lambda c: -c["snr"])
    return out
