"""Fourier-domain acceleration search (models/accelsearch.py).

Closed-form validation: a drifting tone whose power a plain FFT smears
over z bins must be recovered at full strength in the matching z row,
and at the correct frequency.
"""

import numpy as np
import pytest

from baseband_tasks_tpu.models.accelsearch import (
    FourierDomainAccelSearch, accel_template)
from baseband_tasks_tpu.utils import units as u


def drifting_tone(n, f0_bins, z_bins, amp=1.0):
    """Real tone at f0 (bins) drifting z bins over the observation."""
    t = np.arange(n) / n
    phase = 2 * np.pi * (f0_bins * t + 0.5 * z_bins * t ** 2)
    return amp * np.cos(phase)


class TestTemplate:
    def test_zero_drift_is_sinc(self):
        """z=0: response is the Dirichlet kernel — unity at offset 0,
        ~zero at other integer offsets."""
        w = accel_template(0.0, 64)
        assert abs(w[32]) == pytest.approx(1.0, abs=1e-3)
        others = np.delete(np.abs(w), 32)
        assert others.max() < 1e-2

    def test_drift_spreads_and_conserves_power(self):
        w0 = accel_template(0.0, 128)
        w20 = accel_template(20.0, 128)
        # drifting response is wide but carries the same total power
        assert np.abs(w20).max() < 0.5
        assert np.sum(np.abs(w20) ** 2) == pytest.approx(
            np.sum(np.abs(w0) ** 2), rel=0.05)


class TestAccelSearch:
    def _search(self, z_signal, n=1 << 14, f0=1234.0, amp=1.0, seed=0):
        rng = np.random.default_rng(seed)
        x = drifting_tone(n, f0, z_signal, amp=amp) \
            + rng.standard_normal(n).astype(np.float64) * 0.5
        s = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=32, z_step=2,
                                     seg_len=1024)
        return s, np.asarray(s.search(x))

    def test_zero_drift_peak(self):
        s, zmap = self._search(0.0)
        i, j = np.unravel_index(np.argmax(zmap), zmap.shape)
        assert i == 1234
        assert s.z_values[j] == pytest.approx(0.0, abs=2.0)

    @pytest.mark.parametrize("z", [8.0, -16.0, 24.0])
    def test_drift_recovered_in_matching_row(self, z):
        s, zmap = self._search(z)
        i, j = np.unravel_index(np.argmax(zmap), zmap.shape)
        # the template convention recenters the tone at its STARTING
        # frequency; the correct z row wins by a wide margin over z=0
        assert abs(i - 1234) <= 1
        assert abs(s.z_values[j] - z) <= 2.0
        j0 = int(np.argmin(np.abs(s.z_values)))
        band = zmap[1234 - 8: 1234 + int(abs(z)) + 8]
        assert band[:, j].max() > 2.0 * band[:, j0].max()

    def test_candidates(self):
        s, _ = self._search(16.0, amp=2.0)
        rng = np.random.default_rng(0)
        x = drifting_tone(1 << 14, 1234.0, 16.0, amp=2.0) \
            + rng.standard_normal(1 << 14) * 0.5
        cands = s.candidates(x, threshold=50.0)
        assert cands, "no candidates found"
        f, z, p = cands[0]
        f_expect = 1234.0 / (1 << 14) * 1e3  # starting frequency, Hz
        assert abs(f.to_value(u.Hz) - f_expect) < 2 * 1e3 / (1 << 14)
        assert abs(z - 16.0) <= 2.0

    def test_noise_map_is_normalized(self):
        rng = np.random.default_rng(3)
        n = 1 << 13
        s = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=16, z_step=4,
                                     seg_len=1024)
        zmap = np.asarray(s.search(rng.standard_normal(n)))
        # chi^2_2/2 noise: mean ~1, and no huge spurious peaks
        assert 0.5 < float(zmap[16:].mean()) < 2.0
        assert float(zmap[16:].max()) < 30.0

    def test_validation(self):
        s = FourierDomainAccelSearch(1 << 12, 1 * u.kHz, seg_len=1024)
        with pytest.raises(ValueError, match="expected shape"):
            s.search(np.zeros(100))
        with pytest.raises(ValueError, match="must exceed"):
            FourierDomainAccelSearch(1 << 12, 1 * u.kHz, z_max=1000,
                                     seg_len=1024)


class TestHarmonicSum:
    def test_pulse_train_gains_from_harmonics(self):
        """A narrow drifting pulse train spreads power over harmonics;
        the 4-harmonic sum at (f0, z) must clearly beat the fundamental
        alone."""
        n = 1 << 14
        t = np.arange(n) / n
        f0, z = 500.0, 8.0
        phase = (f0 * t + 0.5 * z * t ** 2) % 1.0
        x = np.where(phase < 0.1, 1.0, 0.0) \
            + np.random.default_rng(2).standard_normal(n) * 0.2
        s = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=40, z_step=2,
                                     seg_len=1024)
        zmap = np.asarray(s.search(x))
        hmap = s.harmonic_sum(zmap, n_harm=4)
        j = int(np.argmin(np.abs(s.z_values - z)))
        assert hmap[500, j] > 1.5 * zmap[500, j]
        # and the peak of the summed map is at the right place
        i, jj = np.unravel_index(np.argmax(hmap[16:4000]), 
                                 hmap[16:4000].shape)
        assert abs((i + 16) - 500) <= 1
        assert abs(s.z_values[jj] - z) <= 2.0

    def test_single_harmonic_is_identity(self):
        s = FourierDomainAccelSearch(1 << 12, 1 * u.kHz, z_max=8,
                                     z_step=4, seg_len=1024)
        zmap = np.random.default_rng(1).random((s.n_freq, len(s.zs)))
        np.testing.assert_array_equal(s.harmonic_sum(zmap, 1), zmap)


class TestPallasEngine:
    """Both engines compute the same (frequency, z) map bin for bin."""

    def test_matches_xla_engine(self):
        n = 1 << 13
        t = np.arange(n) / n
        rng = np.random.default_rng(9)
        x = (np.cos(2 * np.pi * (700 * t + 0.5 * 10.0 * t ** 2))
             + rng.standard_normal(n) * 0.3).astype(np.float32)
        sx = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=24, z_step=2,
                                      seg_len=512, engine="xla")
        sp = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=24, z_step=2,
                                      seg_len=512)
        assert sp.engine == "xla"         # 'auto' is the FFT engine
        ref = np.asarray(sx.search(x))
        got = np.asarray(sp.search(x))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-3)
        i, j = np.unravel_index(np.argmax(got), got.shape)
        assert i == 700 and sp.z_values[j] == 10.0

    def test_mx_engine_matches_xla(self):
        """The banded-operator bank matmul (engine='mx') must match the
        overlap-save FFT engine bin for bin."""
        n = 1 << 13
        t = np.arange(n) / n
        rng = np.random.default_rng(9)
        x = (np.cos(2 * np.pi * (700 * t + 0.5 * 10.0 * t ** 2))
             + rng.standard_normal(n) * 0.3).astype(np.float32)
        sx = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=24, z_step=2,
                                      seg_len=512, engine="xla")
        sc = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=24, z_step=2,
                                      seg_len=512, engine="mx")
        ref = np.asarray(sx.search(x))
        got = np.asarray(sc.search(x))
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
        i, j = np.unravel_index(np.argmax(got), got.shape)
        assert i == 700 and sc.z_values[j] == 10.0
        # odd template count and a non-pow2 user window are fine: the
        # mx engine fixes its own L = 2m window
        s2 = FourierDomainAccelSearch(n, 1 * u.kHz, z_max=30, z_step=4,
                                      seg_len=500, engine="mx")
        z2 = np.asarray(s2.search(x))
        assert z2.shape == (n // 2 + 1, len(s2.zs))

    def test_bank_wider_than_lanes_chunks(self):
        """A wide bank (161 z-trials): both engines, same map."""
        n = 1 << 12
        rng = np.random.default_rng(3)
        x = rng.standard_normal(n).astype(np.float32)
        kw = dict(z_max=160, z_step=2.0, seg_len=1024)
        sx = FourierDomainAccelSearch(n, 1 * u.kHz, engine="xla", **kw)
        sp = FourierDomainAccelSearch(n, 1 * u.kHz, engine="mx", **kw)
        assert len(sp.zs) == 161
        np.testing.assert_allclose(np.asarray(sp.search(x)),
                                   np.asarray(sx.search(x)),
                                   rtol=2e-3, atol=2e-3)

    def test_validation(self):
        for engine in ("cuda", "pallas"):
            with pytest.raises(ValueError, match="engine"):
                FourierDomainAccelSearch(1 << 12, 1 * u.kHz, engine=engine)
