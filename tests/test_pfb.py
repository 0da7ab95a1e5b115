"""PFB tests: first prove the math with plain numpy, then check the
implementation matches ('understanding' tests, reference tests/test_pfb.py:55-81),
plus inversion round trips."""

import jax.numpy as jnp
import numpy as np
import pytest

from baseband_tasks_tpu import (sinc_hamming, PolyphaseFilterBank,
                                PolyphaseFilterBankSamples,
                                InversePolyphaseFilterBank, NoiseGenerator,
                                SetAttribute)
from baseband_tasks_tpu.utils import Time, units as u

START = Time("2018-01-01T00:00:00.000000000")


def noise(shape, dtype=np.complex64, spf=None, seed=33, rate=1 * u.MHz):
    return NoiseGenerator(shape=shape, start_time=START, sample_rate=rate,
                          samples_per_frame=spf or shape[0], dtype=dtype,
                          seed=seed)


class TestSincHamming:
    def test_shape_and_symmetry(self):
        h = sinc_hamming(4, 32)
        assert h.shape == (4, 32)
        flat = h.ravel()
        # nearly symmetric (hamming is symmetric; sinc centered)
        np.testing.assert_allclose(flat[1:], flat[1:][::-1], atol=2e-2)

    def test_guppi_style_scale(self):
        h = sinc_hamming(12, 64, sc=0.95)
        assert h.shape == (12, 64)
        assert np.argmax(h.ravel()) == pytest.approx(12 * 64 / 2, abs=1)


class TestPolyphaseFilterBank:
    def test_matches_numpy_reference_math(self):
        """PFB output spectrum k = FFT over n of sum_t h[t]*x_block[k+t]."""
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        sh = noise((2048,))
        raw = np.asarray(sh.read())
        sh.seek(0)
        pfb = PolyphaseFilterBank(sh, h)
        data = np.asarray(pfb.read(8))
        xr = raw.reshape(-1, n)
        expected = np.stack(
            [np.fft.fft((h * xr[k:k + n_tap]).sum(0)) for k in range(8)])
        np.testing.assert_allclose(data, expected, rtol=1e-4, atol=1e-3)

    def test_samples_and_fourier_agree(self):
        n, n_tap = 16, 4
        h = sinc_hamming(n_tap, n)
        a = np.asarray(PolyphaseFilterBank(noise((1024,)), h).read())
        b = np.asarray(PolyphaseFilterBankSamples(noise((1024,)), h).read())
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)

    def test_shape_rate_and_channels(self):
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        sh = noise((4096, 2))
        pfb = PolyphaseFilterBank(sh, h)
        assert pfb.shape[1:] == (32, 2)
        assert pfb.sample_rate.to_value(u.kHz) == pytest.approx(1000 / 32)
        # (4096/32 - 3) usable spectra at most; frame sizing may trim fewer
        assert 0 < pfb.shape[0] <= 4096 // 32 - (n_tap - 1)

    def test_real_input(self):
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        sh = noise((4096,), dtype=np.float32)
        pfb = PolyphaseFilterBank(sh, h)
        assert pfb.shape[1] == 17  # n//2 + 1
        data = np.asarray(pfb.read(4))
        raw = np.asarray(noise((4096,), dtype=np.float32).read())
        xr = raw.reshape(-1, n)
        expected = np.stack(
            [np.fft.rfft((h * xr[k:k + n_tap]).sum(0)) for k in range(4)])
        np.testing.assert_allclose(data, expected, rtol=1e-4, atol=1e-3)

    def test_frequency_labels(self):
        n, n_tap = 8, 4
        h = sinc_hamming(n_tap, n)
        sh = SetAttribute(noise((4096,)), frequency=400 * u.MHz, sideband=1)
        pfb = PolyphaseFilterBank(sh, h)
        freq = pfb.frequency.to_value(u.MHz)
        offs = np.fft.fftfreq(n)
        np.testing.assert_allclose(freq, 400 + offs, rtol=1e-9)


class TestInversePFB:
    @pytest.mark.parametrize("dtype", [np.complex64, np.float32])
    def test_roundtrip(self, dtype):
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        sh = noise((65536,), dtype=dtype, seed=5)
        raw = np.asarray(sh.read())
        sh.seek(0)
        pfb = PolyphaseFilterBank(sh, h)
        inv = InversePolyphaseFilterBank(pfb, h, sn=1e4, dtype=dtype)
        assert inv.dtype == np.dtype(dtype)
        assert inv.sample_rate == sh.sample_rate
        data = np.asarray(inv.read(4096))
        # align: output labels are offset by the total lead-in
        dt_samples = int(round(float(
            ((inv.start_time - START).sec) * 1e6)))
        expected = raw[dt_samples:dt_samples + 4096]
        err = np.mean(np.abs(data - expected) ** 2) \
            / np.mean(np.abs(expected) ** 2)
        # default 128-block pads: recovery well beyond the 60 dB bar
        assert err < 1e-6

    @pytest.mark.parametrize("dtype", [np.complex64, np.float32])
    def test_pallas_engine_roundtrip(self, dtype):
        """The 512-spectra-row window (32-row pads, 448-row frames) the
        power-of-two geometry used recovers the raw stream."""
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        sh = noise((65536,), dtype=dtype, seed=5)
        raw = np.asarray(sh.read())
        sh.seek(0)
        pfb = PolyphaseFilterBank(sh, h)
        inv = InversePolyphaseFilterBank(pfb, h, sn=1e4, dtype=dtype,
                                         pad_start=32, pad_end=32 - 3,
                                         samples_per_frame=448)
        rows = inv._padded_samples_per_frame // n
        assert rows == 512
        data = np.asarray(inv.read(2048))
        dt_samples = int(round(float(
            ((inv.start_time - START).sec) * 1e6)))
        expected = raw[dt_samples:dt_samples + 2048]
        err = np.mean(np.abs(data - expected) ** 2) \
            / np.mean(np.abs(expected) ** 2)
        assert err < 1e-6

    def test_higher_sn_better_recovery(self):
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)

        def run(sn, pad):
            sh = noise((65536,), seed=5)
            raw = np.asarray(sh.read())
            sh.seek(0)
            inv = InversePolyphaseFilterBank(
                PolyphaseFilterBank(sh, h), h, sn=sn, pad_start=pad,
                pad_end=pad)
            data = np.asarray(inv.read(4096))
            dt = int(round(float((inv.start_time - START).sec) * 1e6))
            expected = raw[dt:dt + 4096]
            return float(np.mean(np.abs(data - expected) ** 2)
                         / np.mean(np.abs(expected) ** 2))

        assert run(1e4, 64) < run(10, 64)


class TestPFBDedispersionChain:
    def test_burst_through_pfb_dedisperse_inverse(self):
        """CHIME-style chain: disperse -> PFB -> per-channel dedisperse ->
        inverse PFB.  The burst re-concentrates; a few samples of residual
        offset remain from dispersing across PFB transition bands (known
        physics of critically-sampled PFB dedispersion, not a bookkeeping
        error — the chain without dispersion restores to 0 offset)."""
        import jax.numpy as jnp
        from baseband_tasks_tpu import Disperse, Dedisperse, SetAttribute, \
            StreamGenerator
        from baseband_tasks_tpu.utils import Time
        START2 = Time("2018-01-01T00:00:00.0")
        center = 60000

        def burst(sh):
            o = sh.tell()
            n = min(sh.samples_per_frame, sh.shape[0] - o)
            i = jnp.arange(o, o + n, dtype=jnp.float32)
            env = jnp.exp(-0.5 * ((i - center) / 96) ** 2)
            return (env * jnp.exp(2j * jnp.pi * 0.31 * i)
                    ).astype(jnp.complex64)

        sh = SetAttribute(
            StreamGenerator(burst, (1 << 18,), START2, 1 * u.MHz,
                            samples_per_frame=1 << 18, dtype=np.complex64),
            frequency=300 * u.MHz, sideband=1)
        disp = Disperse(sh, 1.0)
        h = sinc_hamming(4, 32)
        pfb = PolyphaseFilterBank(disp, h)
        ded = Dedisperse(pfb, 1.0,
                         reference_frequency=disp.reference_frequency)
        inv = InversePolyphaseFilterBank(ded, h, sn=1e3,
                                         dtype=np.complex64)
        data = np.asarray(inv.read())
        peak = int(np.argmax(np.abs(data)))
        dt = (inv.start_time - START2).sec
        expected = center - round(dt * 1e6)
        assert abs(peak - expected) <= 12
        assert abs(data[peak]) > 0.8


def digitize(ft, level):
    """Round FT components to multiples of ``level`` (reference
    tests/test_pfb.py:22-23), the reference's 2-bit-style quantizer."""
    ft = np.asarray(ft)
    f = ft.view(ft.real.dtype)
    return jnp.asarray((np.round(f / level) * level).view(ft.dtype))


class TestInversionTelescopeConfigs:
    """The reference's documented S/N guidance, validated end-to-end
    (reference pfb.py:170-181 + tests/test_pfb.py:170-243): CHIME-style
    4x2048 real PFB inverts cleanly at sn=100 and survives digitization
    at sn=10; GUPPI-style 12x64 at sn=30."""

    def _recover(self, h, n, *, sn, pad, n_out, dig_sn=None, spf_pfb=64):
        from baseband_tasks_tpu import Task
        sh = noise((n * (n_out // n + 4 * pad),), dtype=np.float32, seed=7,
                   spf=8192)
        raw = np.asarray(sh.read())
        sh.seek(0)
        pfb = PolyphaseFilterBank(sh, h, samples_per_frame=spf_pfb)
        if dig_sn is not None:
            level = float(np.asarray(pfb.read(spf_pfb)).real.std()) / dig_sn
            pfb.seek(0)
            pfb = Task(pfb, lambda ft: digitize(ft, level),
                       samples_per_frame=spf_pfb)
        inv = InversePolyphaseFilterBank(
            pfb, h, sn=sn, pad_start=pad, pad_end=pad, dtype=np.float32)
        out = np.asarray(inv.read(n_out))
        dt = int(round(float((inv.start_time - START).sec) * 1e6))
        return out, raw[dt:dt + n_out]

    @staticmethod
    def _recoverable_phases(h, m, floor=0.05):
        """Phases whose block-frequency response has no near-null.

        The prototype's center phases are nearly symmetric, so their
        response crosses ~zero at block-frequency pi: that content is
        *mathematically* unrecoverable (Wiener or otherwise) and the
        reference's sn guidance applies to the other phases."""
        resp = np.zeros((m, h.shape[1]))
        resp[:h.shape[0]] = h
        return np.abs(np.fft.fft(resp, axis=0)).min(axis=0) > floor

    def test_chime_clean(self):
        h = np.asarray(sinc_hamming(4, 2048)).reshape(4, 2048)
        out, expected = self._recover(h, 2048, sn=100,
                                      pad=48, n_out=32 * 2048)
        # floor 0.15: at sn=100 the Wiener residual 1/(1+(sn*|H|)^2)
        # is <0.5% of the signal only where |H| >~ 0.15
        ok = self._recoverable_phases(h, 256, floor=0.15)
        ok[:50] = ok[-50:] = False
        np.testing.assert_allclose(
            out.reshape(-1, 2048)[:, ok],
            expected.reshape(-1, 2048)[:, ok], atol=0.01)
        # the null phases stay bounded (content suppressed, not blown up)
        assert np.abs(out - expected).max() < 1.5

    def test_chime_digitized(self):
        h = sinc_hamming(4, 2048)
        out, expected = self._recover(h.reshape(4, 2048), 2048, sn=10,
                                      pad=32, n_out=32 * 2048, dig_sn=3.0)
        # digitization at level sigma/3 leaves ~0.125 sigma residual
        # (reference tests/test_pfb.py:185-203)
        resid = (out - expected).std()
        assert np.isclose(resid, 0.125, atol=0.015), resid
        np.testing.assert_allclose(out, expected, atol=1.1)

    def test_guppi_clean(self):
        h = np.asarray(sinc_hamming(12, 64, sinc_scale=0.95)).reshape(12, 64)
        out, expected = self._recover(h, 64, sn=30,
                                      pad=128, n_out=256 * 64,
                                      spf_pfb=256)
        ok = self._recoverable_phases(h, 512)
        np.testing.assert_allclose(out.reshape(-1, 64)[:, ok],
                                   expected.reshape(-1, 64)[:, ok],
                                   atol=0.15)

    def test_guppi_high_sn_interior(self):
        h = np.asarray(sinc_hamming(12, 64, sinc_scale=0.95)).reshape(12, 64)
        out, expected = self._recover(h, 64, sn=1e9,
                                      pad=128, n_out=256 * 64,
                                      spf_pfb=256)
        ok = self._recoverable_phases(h, 512)
        ok[:2] = ok[-2:] = False
        np.testing.assert_allclose(out.reshape(-1, 64)[:, ok],
                                   expected.reshape(-1, 64)[:, ok],
                                   atol=0.02)
