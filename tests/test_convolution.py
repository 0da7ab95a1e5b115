import numpy as np
import pytest

from baseband_tasks_tpu import Convolve, ConvolveSamples, NoiseGenerator, \
    StreamGenerator
from baseband_tasks_tpu.utils import Time, units as u

START = Time("2018-01-01T00:00:00.000000000")


def noise(shape=(2000, 2), dtype=np.complex64, spf=500):
    return NoiseGenerator(shape=shape, start_time=START,
                          sample_rate=1 * u.kHz, samples_per_frame=spf,
                          dtype=dtype, seed=21)


@pytest.mark.parametrize("cls", [Convolve, ConvolveSamples])
class TestConvolution:
    def test_matches_numpy_convolve(self, cls):
        sh = noise(dtype=np.float32)
        raw = np.asarray(sh.read())
        sh.seek(0)
        response = np.array([0.25, 0.5, 0.25], np.float32)
        ct = cls(sh, response, samples_per_frame=512)
        assert ct.shape == (1998, 2)
        data = np.asarray(ct.read())
        expected = np.stack(
            [np.convolve(raw[:, i], response, mode="valid")
             for i in range(2)], axis=1)
        np.testing.assert_allclose(data, expected, rtol=1e-4, atol=1e-4)

    def test_complex(self, cls):
        sh = noise(dtype=np.complex64)
        raw = np.asarray(sh.read())
        sh.seek(0)
        response = np.array([0.5, 0.5j, -0.25], np.complex64)
        ct = cls(sh, response, samples_per_frame=512)
        data = np.asarray(ct.read())
        expected = np.stack(
            [np.convolve(raw[:, i], response, mode="valid")
             for i in range(2)], axis=1)
        np.testing.assert_allclose(data, expected, rtol=1e-3, atol=1e-3)

    def test_per_channel_response(self, cls):
        sh = noise(dtype=np.float32)
        raw = np.asarray(sh.read())
        sh.seek(0)
        response = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]], np.float32)
        ct = cls(sh, response, samples_per_frame=512)
        data = np.asarray(ct.read())
        for i in range(2):
            expected = np.convolve(raw[:, i], response[:, i], mode="valid")
            np.testing.assert_allclose(data[:, i], expected, rtol=1e-4,
                                       atol=1e-4)

    def test_start_time_shift(self, cls):
        sh = noise()
        ct = cls(sh, np.ones(5, np.float32) / 5, samples_per_frame=512)
        # pad_start = 4 samples at 1 kHz
        assert abs((ct.start_time - START).sec - 4e-3) < 1e-12

    def test_offset_kernel(self, cls):
        sh = noise(dtype=np.float32)
        raw = np.asarray(sh.read())
        sh.seek(0)
        # delta kernel at its offset element = identity
        response = np.zeros(7, np.float32)
        response[3] = 1.0
        ct = cls(sh, response, offset=3, samples_per_frame=512)
        data = np.asarray(ct.read())
        # label of out[0] is input index pad_start = 3
        np.testing.assert_allclose(data, raw[3:3 + len(data)], rtol=1e-4,
                                   atol=1e-4)


class TestCrossImplementation:
    def test_fft_matches_direct(self):
        sh1 = noise()
        sh2 = noise()
        rng = np.random.default_rng(3)
        response = rng.standard_normal(33).astype(np.float32)
        a = np.asarray(Convolve(sh1, response, samples_per_frame=500).read())
        b = np.asarray(ConvolveSamples(sh2, response,
                                       samples_per_frame=500).read())
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


class TestEngines:
    def test_pallas_matches_xla(self):
        """Convolve on the default (XLA) engine == the numpy engine."""
        from baseband_tasks_tpu.fourier import fft_maker
        r = np.zeros(33, np.complex64)
        r[0], r[7], r[32] = 0.5, 1.0, -0.25

        def mk():
            return NoiseGenerator(shape=(8192, 8), start_time=START,
                                  sample_rate=1 * u.kHz,
                                  samples_per_frame=8192,
                                  dtype=np.complex64, seed=11)
        c_xla = Convolve(mk(), r, samples_per_frame=1024)
        a = np.asarray(c_xla.read(2048))
        with fft_maker.set("numpy"):
            c_np = Convolve(mk(), r, samples_per_frame=1024)
            b = np.asarray(c_np.read(2048))
        assert c_np.start_time == c_xla.start_time
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-3)

    @pytest.mark.parametrize("engine", ["pallas", "xla"])
    def test_pallas_rejects_real(self, engine):
        """The engine option is gone (one implementation)."""
        sh = NoiseGenerator(shape=(4096,), start_time=START,
                            sample_rate=1 * u.kHz, samples_per_frame=4096,
                            dtype=np.float32, seed=2)
        with pytest.raises(TypeError):
            Convolve(sh, np.ones(9, np.float32), engine=engine)

