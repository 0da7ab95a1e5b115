"""Phase-binned accumulation (the fold hot loop) and its fixed-point
phase encoding.

The reference folds with host ``np.add.at`` scatter (integration.py:380-395).
On device the fold is written as a one-hot matmul,
``profile[b, ...] = sum_t onehot[t, b] * power[t, ...]`` = ``onehot^T @
power``, a tall skinny product XLA hands to cuBLAS; ``method='segment'``
is the scatter-add form (``segment_sum``).  The one-hot product runs at
``Precision.HIGHEST``: at the default precision a float32 dot on an
H100 may round its operands to TF32 (10-bit mantissa), which would
quantize every power sample before it is summed.

Pulse phase is binned with a *fixed-point* linear map: the phase at local
sample ``t`` is ``((i0_fx + t * p_fx) mod 2^31) / 2^31`` cycles, with
``i0_fx`` and ``p_fx`` int32 in units of 2^-31 cycle
(:func:`fold_phase_vector`).  Every per-sample operation is then an
integer multiply, mask and shift, exact and identical on every backend.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["fold_accumulate", "fold_bins", "fold_bins_ref",
           "fold_phase_vector", "FX_ONE", "FX_MASK"]

_FX_BITS = 31
FX_ONE = 1 << _FX_BITS          # one pulse cycle in fixed-point units
FX_MASK = FX_ONE - 1


def fold_phase_vector(phase0_cycles, rate_cycles_per_sample):
    """Host-side encoder of the (3,) int32 fixed-point fold vector
    ``[i0_fx, p_fx, 0]``: ``i0_fx`` is the phase at t=0 and ``p_fx`` the
    phase rate, both in units of 2^-31 cycle (the third slot is
    reserved).  Rounding is exact given float64 inputs (31 < 53 bits).
    """
    i0 = int(round((float(phase0_cycles) % 1.0) * FX_ONE)) & FX_MASK
    p = int(round((float(rate_cycles_per_sample) % 1.0) * FX_ONE)) \
        & FX_MASK
    return np.array([i0, p, 0], dtype=np.int32)


def fold_bins(fold, t, n_phase):
    """Phase bin of each int32 sample index ``t`` under the fold vector
    ``fold`` (jit-side): bin = floor(frac * n_phase), computed with a
    16-bit split so every intermediate fits int32 (exact for
    ``n_phase <= 2^15``)."""
    num = (fold[0] + t * fold[1]) & FX_MASK
    hi = num >> 16
    lo = num & 0xFFFF
    return ((hi * n_phase) + ((lo * n_phase) >> 16)) >> 15


def fold_bins_ref(fold, t, n_phase):
    """Numpy mirror of :func:`fold_bins` in int64, for tests and
    validation."""
    fold = np.asarray(fold, np.int64)
    num = (fold[0] + np.asarray(t, np.int64) * fold[1]) & FX_MASK
    hi = num >> 16
    lo = num & 0xFFFF
    return ((hi * n_phase) + ((lo * n_phase) >> 16)) >> 15


def fold_accumulate(power, bins, n_phase, *, with_counts=True,
                    method="onehot"):
    """Accumulate samples into phase bins.

    Parameters
    ----------
    power : (T, ...) float array
    bins : (T,) int32 array of phase-bin indices in [0, n_phase)
    n_phase : int
    method : 'onehot' (matmul at HIGHEST precision, default) or
        'segment' (``segment_sum``)

    Returns
    -------
    profile : (n_phase, ...) sums
    counts : (n_phase,) float32 sample counts (if ``with_counts``)
    """
    T = power.shape[0]
    if method == "segment":
        prof = jax.ops.segment_sum(power, bins, num_segments=n_phase)
        if not with_counts:
            return prof
        cnt = jax.ops.segment_sum(jnp.ones((T,), jnp.float32), bins,
                                  num_segments=n_phase)
        return prof, cnt
    if method != "onehot":
        raise ValueError(f"method={method!r}: 'onehot' or 'segment'")
    onehot = (bins[:, None] == jnp.arange(n_phase, dtype=bins.dtype)[None]
              ).astype(power.dtype)
    flat = power.reshape(T, -1)
    prof = jax.lax.dot_general(
        onehot, flat, dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32)
    prof = prof.reshape((n_phase,) + power.shape[1:])
    if not with_counts:
        return prof
    cnt = jnp.sum(onehot, axis=0).astype(jnp.float32)
    return prof, cnt
