"""Dispersion tests: giant-pulse/tone-burst streams whose dispersed arrival
times are analytically predictable (reference strategy:
tests/test_dispersion.py:25-47)."""

import jax.numpy as jnp
import numpy as np
import pytest

from baseband_tasks_tpu import (Disperse, Dedisperse, DisperseSamples,
                                DedisperseSamples, DispersionMeasure,
                                SetAttribute, StreamGenerator, NoiseGenerator)
from baseband_tasks_tpu.utils import Time, units as u

START = Time("2018-01-01T00:00:00.000000000")
RATE = 1 * u.MHz
F0 = 300 * u.MHz  # carrier
DM = DispersionMeasure(1.0)


def tone_burst(nu_offset_cps, center, width=64, shape=(16384,), spf=16384):
    """Gaussian envelope (center, width in samples) on a complex tone at
    baseband frequency nu_offset_cps (cycles/sample)."""
    def f(sh):
        o = sh.tell()
        n = min(sh.samples_per_frame, sh.shape[0] - o)
        i = jnp.arange(o, o + n, dtype=jnp.float32)
        env = jnp.exp(-0.5 * ((i - center) / width) ** 2)
        return (env * jnp.exp(2j * jnp.pi * nu_offset_cps * i)
                ).astype(jnp.complex64)
    return StreamGenerator(f, shape, START, RATE, samples_per_frame=spf,
                           dtype=np.complex64)


def envelope_peak(x):
    """Sub-sample peak position of |x| via quadratic interpolation."""
    a = np.abs(x)
    k = int(np.argmax(a))
    if 0 < k < len(a) - 1:
        denom = a[k - 1] - 2 * a[k] + a[k + 1]
        if denom != 0:
            return k + 0.5 * (a[k - 1] - a[k + 1]) / denom
    return float(k)


class TestCoherentDisperse:
    @pytest.mark.parametrize("nu", [-0.25, 0.0, 0.25])
    def test_group_delay_of_tone_burst(self, nu):
        center = 8192
        sh = SetAttribute(tone_burst(nu, center), frequency=F0, sideband=1)
        disp = Disperse(sh, DM)
        # burst at sky frequency F0 + nu*RATE should arrive later by the
        # group delay relative to the reference frequency
        f_sky = F0 + u.Quantity(nu, u.one) * RATE
        delay = DM.time_delay(f_sky, disp.reference_frequency)
        delay_samples = float(delay.to_value(u.s)) * 1e6
        disp.seek(0)
        data = np.asarray(disp.read())
        # output index of input sample `center` is center - pad_start
        peak = envelope_peak(data)
        expected = center - disp.pad_start + delay_samples
        assert peak == pytest.approx(expected, abs=1.0)

    def test_roundtrip(self):
        sh = SetAttribute(
            NoiseGenerator(shape=(16384,), start_time=START, sample_rate=RATE,
                           samples_per_frame=16384, dtype=np.complex64,
                           seed=4),
            frequency=F0, sideband=1)
        raw = np.asarray(sh.read())
        sh.seek(0)
        disp = Disperse(sh, DM, samples_per_frame=8192)
        dedisp = Dedisperse(disp, DM, samples_per_frame=8192)
        data = np.asarray(dedisp.read())
        # output labels start at total pad_start offset into the input
        q0 = disp.pad_start + dedisp.pad_start
        expected = raw[q0:q0 + len(data)]
        power_err = np.mean(np.abs(data - expected) ** 2) \
            / np.mean(np.abs(expected) ** 2)
        # steady-state overlap-save truncation error scales as 1/spf;
        # ~7e-5 at spf 8192 (same algorithm class as the reference)
        assert power_err < 2e-4

    def test_impulse_roundtrip_off_pulse_clean(self):
        # reference-style test (tests/test_dispersion.py): a giant pulse
        # keeps its shape and position; off-pulse residuals are small
        center = 8192
        def impulse(sh):
            o = sh.tell()
            n = min(sh.samples_per_frame, sh.shape[0] - o)
            i = jnp.arange(o, o + n)
            return jnp.where(i == center, 1.0 + 0j, 0j).astype(jnp.complex64)
        sh = SetAttribute(
            StreamGenerator(impulse, (16384,), START, RATE,
                            samples_per_frame=16384, dtype=np.complex64),
            frequency=F0, sideband=1)
        disp = Disperse(sh, DM, samples_per_frame=4096)
        dedisp = Dedisperse(disp, DM, samples_per_frame=4096)
        data = np.asarray(dedisp.read())
        q0 = disp.pad_start + dedisp.pad_start
        k = center - q0
        assert abs(data[k]) == pytest.approx(1.0, abs=1e-3)
        off = np.abs(np.concatenate([data[:k - 32], data[k + 32:]]))
        assert off.max() < 1e-3
        assert (off ** 2).sum() < 2e-4

    def test_sideband_flip(self):
        # same burst, opposite sideband: sky freq = F0 - nu*RATE
        nu = 0.25
        center = 8192
        sh = SetAttribute(tone_burst(nu, center), frequency=F0, sideband=-1)
        disp = Disperse(sh, DM)
        f_sky = F0 - u.Quantity(nu, u.one) * RATE
        delay_samples = float(
            DM.time_delay(f_sky, disp.reference_frequency).to_value(u.s)) * 1e6
        data = np.asarray(disp.read())
        peak = envelope_peak(data)
        expected = center - disp.pad_start + delay_samples
        assert peak == pytest.approx(expected, abs=1.0)

    def test_reference_frequency_default_and_attrs(self):
        sh = SetAttribute(tone_burst(0.0, 8192), frequency=F0, sideband=1)
        disp = Disperse(sh, DM)
        assert disp.reference_frequency.to_value(u.MHz) == pytest.approx(300.0)
        assert disp.dm.to_value(u.DM) == 1.0
        d2 = Dedisperse(sh, DM)
        # the reference's Dedisperse.dm returns the +dm passed in
        # (dispersion.py:188-190); the internal chirp uses its negation
        assert d2.dm.to_value(u.DM) == 1.0
        assert d2.dedispersion_measure.to_value(u.DM) == -1.0

    def test_start_time_shift(self):
        sh = SetAttribute(tone_burst(0.0, 8192), frequency=F0, sideband=1)
        disp = Disperse(sh, DM)
        assert abs((disp.start_time - START).sec
                   - disp.pad_start * 1e-6) < 1e-10


class TestIncoherentDispersion:
    def make_multichannel(self, seed=8):
        # 4 channels at distinct frequencies
        sh = NoiseGenerator(shape=(8192, 4), start_time=START,
                            sample_rate=100 * u.kHz, samples_per_frame=1024,
                            dtype=np.complex64, seed=seed)
        freq = [310.0, 320.0, 330.0, 340.0] * u.MHz
        return SetAttribute(sh, frequency=freq, sideband=1)

    def test_channels_shift_by_predicted_samples(self):
        sh = self.make_multichannel()
        raw = np.asarray(sh.read())
        sh.seek(0)
        dm = DispersionMeasure(0.5)
        disp = DisperseSamples(sh, dm)
        freq = [310.0, 320.0, 330.0, 340.0] * u.MHz
        delay = dm.time_delay(freq, disp.reference_frequency)
        shift = np.round(delay.to_value(u.s) * 1e5).astype(int)
        data = np.asarray(disp.read(1000))
        for c in range(4):
            # out[q, c] = raw[q - shift_c] with labels starting at pad_start
            q = np.arange(1000) + disp.pad_start
            np.testing.assert_allclose(data[:, c], raw[q - shift[c], c],
                                       atol=1e-6)

    def test_roundtrip(self):
        sh = self.make_multichannel()
        raw = np.asarray(sh.read())
        sh.seek(0)
        dm = DispersionMeasure(0.5)
        rt = DedisperseSamples(DisperseSamples(sh, dm), dm)
        data = np.asarray(rt.read(1000))
        q0 = rt.pad_start + rt.ih.pad_start
        np.testing.assert_allclose(data, raw[q0:q0 + 1000], atol=1e-6)


class TestEngines:
    def test_pallas_matches_xla_engine(self):
        """The default (XLA) engine matches the host numpy engine on the
        same window and chirp, to float noise."""
        from baseband_tasks_tpu.fourier import fft_maker

        def mk():
            return SetAttribute(
                NoiseGenerator(shape=(8192,), start_time=START,
                               sample_rate=RATE, samples_per_frame=8192,
                               dtype=np.complex64, seed=6),
                frequency=F0, sideband=1)
        d_xla = Dedisperse(mk(), DM, samples_per_frame=1024)
        a = np.asarray(d_xla.read(2048))
        with fft_maker.set("numpy"):
            d_np = Dedisperse(mk(), DM, samples_per_frame=1024)
            assert (d_np._padded_samples_per_frame
                    == d_xla._padded_samples_per_frame)
            b = np.asarray(d_np.read(2048))
        assert d_xla.start_time == d_np.start_time
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=2e-4)

    @pytest.mark.parametrize("engine", ["pallas", "xla", "auto"])
    def test_pallas_rejects_real(self, engine):
        """The engine option is gone (one implementation)."""
        sh = SetAttribute(
            NoiseGenerator(shape=(8192,), start_time=START, sample_rate=RATE,
                           samples_per_frame=8192, dtype=np.float32, seed=6),
            frequency=F0, sideband=1)
        with pytest.raises(TypeError):
            Disperse(sh, DM, engine=engine)


class TestChannelizedDedispersion:
    """BASELINE config 2 topology: full-band dispersion corrected
    per-channel after channelization (global reference frequency), then
    dechannelized."""

    def test_burst_restored_through_channelizer(self):
        center = 40000

        def burst(sh):
            o = sh.tell()
            n = min(sh.samples_per_frame, sh.shape[0] - o)
            i = jnp.arange(o, o + n, dtype=jnp.float32)
            env = jnp.exp(-0.5 * ((i - center) / 128) ** 2)
            return (env * jnp.exp(2j * jnp.pi * 0.13 * i)
                    ).astype(jnp.complex64)

        from baseband_tasks_tpu import Channelize, Dechannelize
        sh = SetAttribute(
            StreamGenerator(burst, (1 << 17,), START, RATE,
                            samples_per_frame=1 << 17, dtype=np.complex64),
            frequency=F0, sideband=1)
        disp = Disperse(sh, 2.0)
        ch = Channelize(disp, 32)
        ded = Dedisperse(ch, 2.0,
                         reference_frequency=disp.reference_frequency)
        out = Dechannelize(ded, 32)
        data = np.asarray(out.read())
        peak = int(np.argmax(np.abs(data)))
        dt = (out.start_time - START).sec
        expected = center - round(dt * 1e6)
        assert abs(peak - expected) <= 2
        assert abs(data[peak]) > 1.0  # burst re-concentrated


class TestRealInputAndEdgeCases:
    """Reference scenarios: dispersion of real-valued streams
    (test_dispersion.py:206-306), negative DM, and an out-of-band
    reference frequency."""

    def _impulse(self, dtype, n=1 << 17, at=40000, rate=32 * u.kHz):
        def f(sh):
            o = sh.tell()
            m = min(sh.samples_per_frame, sh.shape[0] - o)
            idx = jnp.arange(o, o + m)
            v = jnp.where(idx == at, 1.0, 0.0).astype(jnp.float32)
            if np.dtype(dtype).kind == "c":
                v = v.astype(jnp.complex64)
            return v
        return SetAttribute(
            StreamGenerator(f, (n,), START, rate,
                            samples_per_frame=1 << 14, dtype=dtype),
            frequency=F0, sideband=1)

    @pytest.mark.parametrize("dtype", [np.float32, np.complex64])
    def test_roundtrip_impulse_at_absolute_time(self, dtype):
        rate = 32 * u.kHz
        src = self._impulse(dtype)
        rt = Dedisperse(Disperse(src, 10.0, samples_per_frame=1 << 14),
                        10.0, samples_per_frame=1 << 14)
        assert rt.dtype == np.dtype(dtype)
        rt.seek(START + 40000 / rate)
        rt.seek(-5000, 1)
        x = np.asarray(rt.read(10000))
        peak = int(np.argmax(np.abs(x)))
        assert peak == 5000          # lands exactly on its absolute time
        assert abs(x[peak]) > 0.999  # and keeps its amplitude

    def test_negative_dm_is_inverse(self):
        """Disperse(-dm) undoes Disperse(+dm) (the reference's Dedisperse
        is literally a sign flip, dispersion.py:182-190)."""
        rate = 32 * u.kHz
        src = self._impulse(np.complex64)
        chain = Disperse(Disperse(src, 7.5, samples_per_frame=1 << 14),
                         -7.5, samples_per_frame=1 << 14)
        chain.seek(START + 40000 / rate)
        chain.seek(-100, 1)
        x = np.asarray(chain.read(200))
        assert int(np.argmax(np.abs(x))) == 100
        assert abs(x[100]) > 0.999

    def test_out_of_band_reference_frequency(self):
        """Dedispersing to a reference far outside the band still places
        the impulse at its delayed absolute time (reference
        dispersion.py:78-93 integer-offset shortcut)."""
        rate = 32 * u.kHz
        dm = DispersionMeasure(5.0)
        ref = 350 * u.MHz  # band is ~300 MHz +- 16 kHz
        src = self._impulse(np.complex64)
        d = Disperse(src, dm, reference_frequency=ref,
                     samples_per_frame=1 << 14)
        # the impulse moves by the delay between its own frequency and ref
        delay = dm.time_delay(F0, ref)
        t_exp = START + 40000 / rate + delay
        d.seek(t_exp)
        d.seek(-100, 1)
        x = np.asarray(d.read(200))
        peak = envelope_peak(x)
        assert abs(peak - 100) < 1.0
        # the delay to an out-of-band reference is generally fractional,
        # so the unit impulse interpolates across neighbors: check energy
        assert (np.abs(x[97:104]) ** 2).sum() > 0.99


class TestRealDataConventions:
    """Real-dtype band-edge and mid-channel conventions (reference
    dispersion.py:55-64, 236-247)."""

    def test_real_band_edges_use_half_rate(self):
        def real_noise(sh):
            import jax.numpy as jnp
            return jnp.zeros((sh.samples_per_frame,) + sh.sample_shape,
                             jnp.float32)
        sh = StreamGenerator(real_noise, (16384,), START, 1 * u.MHz,
                             samples_per_frame=16384, dtype=np.float32)
        sh = SetAttribute(sh, frequency=300 * u.MHz, sideband=1)
        d = Disperse(sh, DM, pad_margin=0)
        # band = [300, 300.5] MHz -> default reference at its center
        assert d.reference_frequency.to_value(u.MHz) \
            == pytest.approx(300.25)
        # pads follow delays at the band edges relative to the center
        dm = DispersionMeasure(1.0)
        dmax = dm.time_delay(300.0 * u.MHz,
                             300.25 * u.MHz).to_value(u.s) * 1e6
        assert d.pad_start == int(np.ceil(dmax))

    def test_incoherent_mid_channel_for_real(self):
        def real_noise(sh):
            import jax.numpy as jnp
            return jnp.zeros((sh.samples_per_frame,) + sh.sample_shape,
                             jnp.float32)
        sh = StreamGenerator(real_noise, (4096, 4), START, 1 * u.MHz,
                             samples_per_frame=1024, dtype=np.float32)
        freqs = np.array([300., 301., 302., 303.])
        sh = SetAttribute(sh, frequency=u.Quantity(freqs, u.MHz),
                          sideband=1)
        d = DisperseSamples(sh, DM)
        # delays evaluated at mid-channel (f + rate/2), reference at
        # their mean
        mid = freqs + 0.5
        assert d.reference_frequency.to_value(u.MHz) \
            == pytest.approx(mid.mean())
        assert d.dm.to_value(u.DM) == 1.0
        d2 = DedisperseSamples(sh, DM)
        assert d2.dm.to_value(u.DM) == 1.0
