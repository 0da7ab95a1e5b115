"""Drifting-pulsar folding in the wideband pipeline (models/foldmodel.py).

The pipeline folds with a fixed-point linear phase map (power-of-two
modulus; ops/fold.py); FoldModel re-encodes a drifting polyco phase as
per-block fixed-point halves.  These tests pin (a) the fixed-point
encoding itself, (b) agreement of the pipeline's fold with host
two-double Phase binning at bench scale (>= 1e7 samples, >= 60 dB), and
(c) agreement with the eager library Fold + PolycoPhase (reference
integration.py:306-395 semantics).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from baseband_tasks_tpu.models import WidebandPulsarPipeline
from baseband_tasks_tpu.models.foldmodel import (
    FoldModel, best_rational, fixedpoint_foldv)
from baseband_tasks_tpu.ops.fold import fold_bins_ref
from baseband_tasks_tpu.phases import Polyco, PolycoPhase
from baseband_tasks_tpu.utils import Time, units as u

TMID = 58000.0
RATE = 250e3  # Hz, per-channel


def make_polyco(f0=641.928123, rphase_frac=0.3217, c2=0.5):
    """Single-entry polyco with a quadratic drift term: polyco
    coefficients are [c0, c1, c2] with phase = RPHASE + 60 f0 dt + Σ cᵏdtᵏ
    (dt in minutes), so ``c2`` cycles/min² drifts the apparent frequency
    by 2 c2 dt/60 Hz — astronomically large values are used to make the
    drift visible over seconds of simulated data."""
    text = ("B1937+21    9-AUG-18  120000.00   "
            f"{TMID:.11f}            71.019700              "
            "0.000000   0.000\n"
            f"123456789.{int(rphase_frac * 1e6):06d}  {f0:.12E}"
            "   ao  1440    3   1400.000\n"
            "0.00000000000000000D+00 0.00000000000000000D+00 "
            f"{c2:.17E}\n"
            ).replace("E+", "D+").replace("E-", "D-")
    return PolycoPhase(Polyco(text))


class TestBestRational:
    def test_exact_small_rational(self):
        assert best_rational(3 / 8) == (3, 8)
        assert best_rational(1 / 3) == (1, 3)

    def test_convergent_quality(self):
        x = 641.928123 / RATE
        p, q = best_rational(x)
        assert p * q < 1 << 31
        assert abs(x - p / q) < 1.0 / q ** 2
        # good enough that 2^18 samples stay within 1e-5 cycles
        assert abs(x - p / q) * (1 << 18) < 1e-5

    def test_q_bound(self):
        p, q = best_rational(np.pi / 1e6, max_q=10000)
        assert q <= 10000

    def test_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            best_rational(0.0)
        with pytest.raises(ValueError):
            best_rational(-1.0)


def _halves_bins(foldv, t, n_phase):
    """Bins via the pipeline's exact fixed-point map from (4,) halves."""
    h = np.asarray(foldv, np.int64)
    return fold_bins_ref([(h[0] << 16) | h[1], (h[2] << 16) | h[3], 0],
                         t, n_phase)


class TestFoldModelEncoding:
    def test_matches_host_phase(self):
        """Fixed-point bins reproduce two-double Phase bins except for
        rare bin-boundary flips."""
        pp = make_polyco()
        t0 = Time.from_mjd(TMID)
        n_phase = 64
        fm = FoldModel(pp, t0, u.Quantity(RATE, u.Hz), n_phase)
        T = 1 << 16
        for offset in (0, 10 * T, 100 * T):
            foldv = fm.foldv(offset, T)
            t = np.arange(T)
            bins = _halves_bins(foldv, t, n_phase)
            # host truth at two-double precision
            from baseband_tasks_tpu.integration import _phase_to_cycles
            times = t0 + u.Quantity((offset + t) / RATE, u.s)
            hi, lo = _phase_to_cycles(pp(times))
            frac = (hi - np.floor(hi)) + lo
            frac -= np.floor(frac)
            ref = np.minimum((frac * n_phase).astype(np.int64), n_phase - 1)
            # mismatches can only be bin-boundary flips; the linear
            # drift is bounded by the 2^-32 cycle/sample rate
            # quantization (~2^-16 cycle over the block) plus the
            # model's within-block curvature
            bad = bins != ref
            assert bad.mean() < 5e-4
            if bad.any():
                diff = (bins[bad] - ref[bad]) % n_phase
                assert np.all((diff == 1) | (diff == n_phase - 1))

    def test_f32_roundtrip_exact(self):
        """Halves must survive the f32-only device boundary exactly."""
        pp = make_polyco()
        fm = FoldModel(pp, Time.from_mjd(TMID), u.Quantity(RATE, u.Hz), 64)
        foldv = fm.foldv(12345, 1 << 14)
        assert foldv.dtype == np.float32
        assert foldv.shape == (4,)
        assert np.all(foldv == np.round(foldv))
        assert np.all(foldv < 1 << 16)
        assert np.all(foldv >= 0)

    def test_fixedpoint_encoding_precision(self):
        """fixedpoint_foldv quantizes phase/rate to 2^-31 cycle."""
        phase0, rate = 0.123456789, 2.5e-3
        h = np.asarray(fixedpoint_foldv(phase0, rate), np.int64)
        i0 = (h[0] << 16) | h[1]
        p = (h[2] << 16) | h[3]
        assert abs(i0 / 2 ** 31 - phase0) <= 2 ** -32
        assert abs(p / 2 ** 31 - rate) <= 2 ** -32


def _profile_snr_db(ref, test):
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    sig = np.sum((ref - ref.mean()) ** 2)
    err = np.sum((ref - test) ** 2)
    if err == 0:
        return np.inf
    return 10 * np.log10(sig / err)


class TestFusedPolycoFold:
    """Fused integer-modular drifting fold vs host-precision binning and
    the eager library Fold, at bench scale (VERDICT round-1 item 2)."""

    def _make_pipe(self, **kw):
        args = dict(n_chan=4, n_pol=1, dm=0.5, freq_center=600 * u.MHz,
                    chan_rate=u.Quantity(RATE, u.Hz), n_phase=64,
                    block_samples=16384,
                    phase_model=make_polyco(),
                    start_time=Time.from_mjd(TMID))
        args.update(kw)
        return WidebandPulsarPipeline(**args)

    def test_matches_host_bins_60db_at_1e7_samples(self):
        pipe = self._make_pipe()
        pp = pipe.fold_model.phase
        t0 = pipe.fold_model.start_time
        T = pipe.global_block
        n_blocks = int(np.ceil(1e7 / (T * pipe.n_chan * pipe.n_pol)))
        assert n_blocks * T * pipe.n_chan * pipe.n_pol >= 1e7
        step_fold = pipe.step_fn()
        step_bins = pipe.step_bins_fn()
        rng = np.random.default_rng(7)
        prof_a = np.zeros((pipe.n_phase, pipe.n_chan, pipe.n_pol))
        cnt_a = np.zeros(pipe.n_phase)
        prof_b = np.zeros_like(prof_a)
        cnt_b = np.zeros_like(cnt_a)
        for k in range(n_blocks):
            offset = k * T
            bins = pipe.phase_bins(pp, t0, offset=offset)
            # noise + a strong pulse riding the *drifting* phase model
            xf = rng.standard_normal(
                (T, pipe.n_chan, pipe.n_pol, 2)).astype(np.float32)
            pulse = (bins.astype(int) == 17)
            xf[pulse] += 6.0
            foldv = pipe.fold_model.foldv(offset, T)
            pa, ca = step_fold(jnp.asarray(xf), jnp.asarray(foldv))
            pb, cb = step_bins(jnp.asarray(xf), jnp.asarray(bins))
            prof_a += np.asarray(pa)
            cnt_a += np.asarray(ca)
            prof_b += np.asarray(pb)
            cnt_b += np.asarray(cb)
        # identical samples, identical dedispersion; only the binning
        # differs -> demand 60 dB on the per-channel profiles
        snr = _profile_snr_db(prof_b, prof_a)
        assert snr >= 60.0, f"profile SNR {snr:.1f} dB < 60 dB"
        # counts: nearly all samples land in the same bins
        assert np.abs(cnt_a - cnt_b).sum() / cnt_b.sum() < 1e-3
        # and the pulse actually shows up where injected
        peak = prof_b.sum(axis=(1, 2)).argmax()
        assert peak == 17

    def test_drift_matters(self):
        """A fixed-period fold of the same drifting pulsar smears: the
        polyco-driven fold must beat it decisively (sanity that the test
        above is non-trivial)."""
        pipe = self._make_pipe(phase_model=make_polyco(c2=50.0))
        pp = pipe.fold_model.phase
        t0 = pipe.fold_model.start_time
        T = pipe.global_block
        # fixed rational period from the *initial* apparent frequency
        f0 = float(pp.apparent_spin_freq(t0).to_value(u.Hz))
        p_fix, q_fix = best_rational(f0 / RATE)
        step = pipe.step_fn()
        rng = np.random.default_rng(3)
        prof_poly = np.zeros((pipe.n_phase,))
        prof_fix = np.zeros((pipe.n_phase,))
        n_blocks = 40
        stride = 24  # sample sparsely across ~60 s: the quadratic drift
        #              sweeps ~40 cycles, fully smearing the fixed fold
        for k in range(n_blocks):
            offset = k * stride * T
            bins = pipe.phase_bins(pp, t0, offset=offset)
            xf = rng.standard_normal(
                (T, pipe.n_chan, pipe.n_pol, 2)).astype(np.float32)
            xf[bins.astype(int) == 17] += 6.0
            foldv = pipe.fold_model.foldv(offset, T)
            pa, _ = step(jnp.asarray(xf), jnp.asarray(foldv))
            fixed = fixedpoint_foldv(offset * p_fix % q_fix / q_fix,
                                     p_fix / q_fix)
            pf, _ = step(jnp.asarray(xf), jnp.asarray(fixed))
            prof_poly += np.asarray(pa).sum(axis=(1, 2))
            prof_fix += np.asarray(pf).sum(axis=(1, 2))

        def contrast(p):
            return (p.max() - np.median(p)) / np.median(p)

        assert contrast(prof_poly) > 5 * contrast(prof_fix)

    def test_matches_eager_fold(self):
        """Fused profile == eager Square->Fold(PolycoPhase) on the same
        samples (dm tiny so dedispersion is a near-identity; compare a
        single block's fold)."""
        from baseband_tasks_tpu import Fold, Square, StreamGenerator
        pipe = self._make_pipe(dm=1e-4, n_chan=1)
        pp = pipe.fold_model.phase
        t0 = pipe.fold_model.start_time
        T = pipe.global_block
        bins = pipe.phase_bins(pp, t0, offset=0)
        rng = np.random.default_rng(11)
        data = rng.standard_normal((T, 1, 1, 2)).astype(np.float32)
        data[bins.astype(int) == 5] += 6.0
        z = (data[..., 0] + 1j * data[..., 1]).astype(np.complex64)

        # eager chain on the identical voltages
        def gen(sh):
            o = sh.tell()
            n = min(sh.samples_per_frame, sh.shape[0] - o)
            return jnp.asarray(z[o:o + n, 0])

        sh = StreamGenerator(gen, shape=(T, 1), start_time=t0,
                             sample_rate=u.Quantity(RATE, u.Hz),
                             samples_per_frame=4096, dtype=np.complex64)
        fold = Fold(Square(sh), pipe.n_phase, pp,
                    step=u.Quantity(T / RATE, u.s), average=False)
        out = fold.read(1)
        eager_prof = out["data"][0, :, 0]
        eager_cnt = out["count"][0, :, 0]

        foldv = pipe.fold_model.foldv(0, T)
        pa, ca = pipe.step_fn()(jnp.asarray(data), jnp.asarray(foldv))
        fused_prof = np.asarray(pa)[:, 0, 0]
        # dm=1e-4 still smears a little; compare at modest tolerance and
        # demand identical counts up to rare boundary flips
        assert np.abs(np.asarray(ca) - eager_cnt).sum() / T < 1e-3
        snr = _profile_snr_db(eager_prof, fused_prof)
        assert snr >= 30.0

    def test_run_fn_uses_fold_table(self):
        """run_fn with a phase model: counts per profile equal the valid
        block size and profiles accumulate across iterations."""
        pipe = self._make_pipe(n_chan=8, n_pol=2, block_samples=1024,
                               dm=0.5)
        run = pipe.run_fn(3)
        prof, cnt = run(0)
        total = np.asarray(cnt).sum()
        assert total == pytest.approx(3 * pipe.global_block, rel=1e-6)
