"""Host-side drifting-phase fold models for the wideband pipeline.

The wideband step bins pulse phase with a *fixed-point* linear map:
frac(t) = ((i0_fx + t·p_fx) mod 2^31) / 2^31 cycles, with (i0_fx, p_fx)
runtime int32 scalars in units of 2^-31 cycle (ops/fold.py).  The
power-of-two modulus makes every per-sample op a multiply/mask/shift.

A real pulsar's apparent spin frequency drifts (Doppler from the Earth's
motion, spindown), so the reference folds arbitrary polyco/PINT phases
per sample (/root/reference/baseband_tasks/integration.py:380-395).
:class:`FoldModel` closes that gap: per block it linearizes the phase
model at full host precision (two-double Phase arithmetic) and re-encodes
it as a fresh (i0_fx, p_fx) pair:

- ``p_fx`` = round(frac(cycles-per-sample)·2^31): quantization error is
  at most 2^-32 cycle/sample, i.e. ~3e-5 cycle across a 2^17-sample
  block — far below a phase bin (>= 2^-15 cycle) and *not* cumulative,
  because every block re-evaluates the model.
- ``i0_fx`` = round(frac(φ₀)·2^31) from the two-double phase at the
  block's first sample (error 2^-32 cycle).

Within-block curvature (fdot over <~1 s) is below 1e-12 cycles and is
ignored.  The device needs only a (4,) float32 vector per block: i0_fx
and p_fx ride as exact 16-bit halves ``[i0_hi, i0_lo, p_hi, p_lo]``
(each < 2^16, so exact in float32) and are recombined by shift-or inside
jit.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..ops.fold import fold_phase_vector
from ..utils import units as u

__all__ = ["FoldModel", "best_rational", "fixedpoint_foldv"]


def fixedpoint_foldv(phase0_cycles, rate_cycles_per_sample):
    """(4,) float32 ``[i0_hi, i0_lo, p_hi, p_lo]`` fixed-point fold
    encoding for the wideband pipeline: the 31-bit fixed-point
    phase/rate of :func:`~..ops.fold.fold_phase_vector` (the single
    source of that encoding) split into 16-bit halves, each exact in
    float32."""
    i0, p, _ = (int(v) for v in
                fold_phase_vector(phase0_cycles, rate_cycles_per_sample))
    return np.array([i0 >> 16, i0 & 0xFFFF, p >> 16, p & 0xFFFF],
                    dtype=np.float32)


def best_rational(x, max_pq=(1 << 31) - (1 << 20), max_q=1 << 23):
    """Best rational p/q ≈ x (0 < x) subject to p·q < max_pq, q <= max_q.

    Walks the continued-fraction convergents of ``x`` and returns the
    last one satisfying both bounds; the classic convergent bound gives
    |x - p/q| <= 1/q².  Exact rationals with a small denominator are
    returned exactly.  Used for exact-rational period bookkeeping (e.g.
    :class:`WidebandPulsarPipeline`'s fixed-period mode).
    """
    if not np.isfinite(x) or x <= 0:
        raise ValueError(f"fold rate must be positive and finite, got {x}")
    frac = Fraction(float(x))  # exact binary expansion of the float
    p_prev, q_prev = 0, 1
    p_cur, q_cur = 1, 0
    num, den = frac.numerator, frac.denominator
    while den:
        a = num // den
        num, den = den, num - a * den
        p_next = a * p_cur + p_prev
        q_next = a * q_cur + q_prev
        if (p_next * q_next >= max_pq or q_next > max_q) and q_cur:
            break
        p_prev, q_prev = p_cur, q_cur
        p_cur, q_cur = p_next, q_next
    if q_cur == 0:
        raise ValueError(f"cannot approximate {x} under p*q < {max_pq}")
    return p_cur, q_cur


class FoldModel:
    """Per-block fixed-point fold parameters from a phase callable.

    Parameters
    ----------
    phase : callable
        ``phase(t) -> Phase`` plus ``apparent_spin_freq(t) -> Quantity``
        (e.g. :class:`~baseband_tasks_tpu.phases.PolycoPhase`).
    start_time : Time
        Time of global sample 0 of the (channelized) stream being folded.
    sample_rate : Quantity
        Per-channel complex sample rate.
    n_phase : int
        Phase bins the fold will use (<= 2^15 for the exact int32 bin
        extraction).
    """

    def __init__(self, phase, start_time, sample_rate, n_phase=64):
        if not 0 < int(n_phase) <= (1 << 15):
            raise ValueError(f"n_phase={n_phase} must be in [1, 32768]")
        self.phase = phase
        self.start_time = start_time
        self.sample_rate = sample_rate
        self._rate = float(sample_rate.to_value(u.Hz))

    def _time_at(self, offset):
        # two-double time arithmetic: offset/rate split into hi+lo
        from ..utils.time import TimeDelta
        hi = offset / self._rate
        lo = (offset - hi * self._rate) / self._rate
        return self.start_time + TimeDelta.from_sec(hi, lo)

    def foldv(self, offset, n_window):
        """(4,) float32 fold halves for a block of ``n_window`` valid
        samples starting at global sample ``offset``.

        The phase is linearized about the block start using the apparent
        spin frequency at mid-block (halves the curvature error); the
        device step adds the per-shard offset before binning.
        """
        from ..integration import _phase_to_cycles
        t_mid = self._time_at(offset + n_window / 2)
        f_app = float(np.atleast_1d(
            self.phase.apparent_spin_freq(t_mid).to_value(u.Hz))[0])
        a1 = f_app / self._rate                    # cycles per sample
        hi, lo = _phase_to_cycles(self.phase(self._time_at(offset)))
        hi = float(np.atleast_1d(hi)[0])
        lo = float(np.atleast_1d(lo)[0])
        frac0 = (hi - np.floor(hi)) + lo
        frac0 -= np.floor(frac0)
        return fixedpoint_foldv(frac0, a1)

    def table(self, offsets, n_window):
        """(len(offsets), 4) float32 fold-parameter table for a device
        loop (one row per block; rows are selected inside the jitted loop
        so the host never re-enters between iterations)."""
        return np.stack([self.foldv(off, n_window) for off in offsets])
