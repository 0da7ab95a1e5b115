import numpy as np
import pytest

from baseband_tasks_tpu.fourier import (
    fft_maker, FFT_MAKER_CLASSES, next_fast_len, NumpyFFTMaker, XLAFFTMaker)
from baseband_tasks_tpu.utils import units as u


class TestNextFastLen:
    @pytest.mark.parametrize("n,expected", [
        (1, 1), (7, 8), (8, 8), (9, 9), (10, 10), (11, 12), (13, 15),
        (17, 18), (1000, 1000), (1001, 1024), (7919, 8000),
    ])
    def test_values(self, n, expected):
        got = next_fast_len(n)
        assert got == expected

    def test_smoothness(self):
        for n in [123, 457, 12345, 99999]:
            m = next_fast_len(n)
            assert m >= n
            x = m
            for p in (2, 3, 5):
                while x % p == 0:
                    x //= p
            assert x == 1


class TestRegistry:
    def test_engines_registered(self):
        assert "xla" in FFT_MAKER_CLASSES
        assert "numpy" in FFT_MAKER_CLASSES

    def test_default_engine_is_xla(self):
        assert isinstance(fft_maker.get(), XLAFFTMaker)

    def test_set_context_manager(self):
        with fft_maker.set("numpy"):
            assert isinstance(fft_maker.get(), NumpyFFTMaker)
        assert isinstance(fft_maker.get(), XLAFFTMaker)


@pytest.mark.parametrize("maker_name", ["xla", "numpy"])
class TestFFTEngines:
    def _maker(self, name):
        return FFT_MAKER_CLASSES[name]()

    def test_complex_roundtrip(self, maker_name):
        maker = self._maker(maker_name)
        rng = np.random.default_rng(1)
        x = (rng.standard_normal((64, 4)) + 1j * rng.standard_normal((64, 4))
             ).astype(np.complex64)
        fft = maker(x.shape, x.dtype, axis=0)
        X = np.asarray(fft(x))
        np.testing.assert_allclose(X, np.fft.fft(x, axis=0), rtol=2e-4,
                                   atol=1e-3)
        back = np.asarray(fft.inverse()(X))
        np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)

    def test_real_rfft(self, maker_name):
        maker = self._maker(maker_name)
        rng = np.random.default_rng(2)
        x = rng.standard_normal((128, 2)).astype(np.float32)
        fft = maker(x.shape, x.dtype, axis=0)
        assert fft.frequency_shape == (65, 2)
        X = np.asarray(fft(x))
        np.testing.assert_allclose(X, np.fft.rfft(x, axis=0), rtol=2e-4,
                                   atol=2e-3)
        back = np.asarray(fft.inverse()(X))
        np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)

    def test_axis1(self, maker_name):
        maker = self._maker(maker_name)
        rng = np.random.default_rng(3)
        x = (rng.standard_normal((8, 32, 2)) + 0j).astype(np.complex64)
        fft = maker(x.shape, x.dtype, axis=1)
        X = np.asarray(fft(x))
        np.testing.assert_allclose(X, np.fft.fft(x, axis=1), rtol=2e-4,
                                   atol=1e-3)

    def test_ortho_norm(self, maker_name):
        maker = self._maker(maker_name)
        x = np.ones((16,), dtype=np.complex64)
        fft = maker(x.shape, x.dtype, ortho=True)
        X = np.asarray(fft(x))
        assert X[0] == pytest.approx(4.0)  # 16/sqrt(16)

    def test_odd_and_prime_sizes(self, maker_name):
        maker = self._maker(maker_name)
        rng = np.random.default_rng(4)
        for n in (15, 17, 251):
            x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
                 ).astype(np.complex64)
            fft = maker(x.shape, x.dtype)
            np.testing.assert_allclose(np.asarray(fft(x)), np.fft.fft(x),
                                       rtol=1e-3, atol=2e-3)

    def test_frequency_axis(self, maker_name):
        maker = self._maker(maker_name)
        fft = maker((32, 2), np.complex64, sample_rate=32 * u.Hz)
        freq = fft.frequency
        assert freq.shape == (32, 1)
        assert freq[1, 0].to_value(u.Hz) == pytest.approx(1.0)
        assert freq[31, 0].to_value(u.Hz) == pytest.approx(-1.0)

    def test_frequency_real(self, maker_name):
        maker = self._maker(maker_name)
        fft = maker((32,), np.float32, sample_rate=32 * u.Hz)
        freq = fft.frequency
        assert freq.shape == (17,)
        assert freq[16].to_value(u.Hz) == pytest.approx(16.0)

    def test_cross_engine_match(self, maker_name):
        rng = np.random.default_rng(5)
        x = (rng.standard_normal((96, 3)) + 1j * rng.standard_normal((96, 3))
             ).astype(np.complex64)
        ours = np.asarray(self._maker(maker_name)(x.shape, x.dtype, axis=0)(x))
        host = np.asarray(NumpyFFTMaker()(x.shape, x.dtype, axis=0)(x))
        np.testing.assert_allclose(ours, host, rtol=2e-4, atol=2e-3)


class TestXLAEngineShapes:
    """The XLA engine (cuFFT on the GPU) at the shapes the removed
    'pallas' engine used to take, and engine switching."""

    def test_registered(self):
        from baseband_tasks_tpu.fourier import FFT_MAKER_CLASSES
        assert "pallas" not in FFT_MAKER_CLASSES
        with pytest.raises((KeyError, ValueError)):
            with fft_maker.set("pallas"):
                pass

    @pytest.mark.parametrize("ortho", [False, True])
    def test_forward_inverse_match_numpy(self, ortho):
        maker = XLAFFTMaker()
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((1024, 16))
             + 1j * rng.standard_normal((1024, 16))).astype(np.complex64)
        fwd = maker((1024, 16), np.complex64, ortho=ortho)
        got = np.asarray(fwd(x))
        norm = "ortho" if ortho else None
        np.testing.assert_allclose(got, np.fft.fft(x, axis=0, norm=norm),
                                   rtol=1e-3, atol=1e-2)
        back = np.asarray(fwd.inverse()(got))
        np.testing.assert_allclose(back, x, rtol=1e-3, atol=1e-3)

    def test_fallback_paths(self):
        """Non-power-of-two lengths and real input."""
        maker = XLAFFTMaker()
        rng = np.random.default_rng(1)
        x = rng.standard_normal((600, 16)).astype(np.float32)
        fft = maker((600, 16), np.float32)
        np.testing.assert_allclose(np.asarray(fft(x)),
                                   np.fft.rfft(x, axis=0),
                                   rtol=1e-4, atol=1e-3)

    def test_with_fft_maker_context(self):
        rng = np.random.default_rng(2)
        x = (rng.standard_normal((512, 8))
             + 1j * rng.standard_normal((512, 8))).astype(np.complex64)
        with fft_maker.set("numpy"):
            fft = fft_maker((512, 8), np.complex64)
            got = np.asarray(fft(x))
        np.testing.assert_allclose(got, np.fft.fft(x, axis=0),
                                   rtol=1e-3, atol=1e-2)

    def test_channelize_under_pallas_engine(self):
        """Channelize(512) on the default engine against numpy."""
        from baseband_tasks_tpu import Channelize, NoiseGenerator
        from baseband_tasks_tpu.utils import Time, units as u
        sh = NoiseGenerator(shape=(16384,),
                            start_time=Time("2018-01-01T00:00:00.0"),
                            sample_rate=1 * u.MHz, samples_per_frame=16384,
                            dtype=np.complex64, seed=7)
        raw = np.asarray(sh.read())
        sh.seek(0)
        ch = Channelize(sh, 512)
        data = np.asarray(ch.read(8))
        expected = np.fft.fft(raw[:8 * 512].reshape(8, 512), axis=1)
        np.testing.assert_allclose(data, expected, rtol=1e-3, atol=1e-2)

    def test_pfb_under_pallas_engine(self):
        """PolyphaseFilterBank + inverse roundtrip under the 'numpy'
        engine: the global engine switch leaves the whole PFB stack
        numerically intact."""
        from baseband_tasks_tpu import (sinc_hamming, PolyphaseFilterBank,
                                        InversePolyphaseFilterBank,
                                        NoiseGenerator)
        from baseband_tasks_tpu.utils import Time, units as u
        h = sinc_hamming(4, 32)
        with fft_maker.set("numpy"):
            sh = NoiseGenerator(shape=(65536,),
                                start_time=Time("2018-01-01T00:00:00.0"),
                                sample_rate=1 * u.MHz,
                                samples_per_frame=65536,
                                dtype=np.complex64, seed=5)
            raw = np.asarray(sh.read())
            sh.seek(0)
            pfb = PolyphaseFilterBank(sh, h)
            inv = InversePolyphaseFilterBank(pfb, h, sn=1e4,
                                             dtype=np.complex64)
            data = np.asarray(inv.read(4096))
        dt = int(round(float((inv.start_time
                              - sh.start_time).sec) * 1e6))
        expected = raw[dt:dt + 4096]
        err = np.mean(np.abs(data - expected) ** 2) \
            / np.mean(np.abs(expected) ** 2)
        assert err < 1e-6


class TestChannelizePlanes:
    """Channelize and Dechannelize in the compiled planes step (re/im
    planes recombined around the engine's FFT) against the eager chain
    on the numpy engine, at the channelizer lengths of the benchmarks
    (and a non-smooth one)."""

    @pytest.mark.parametrize("n", [16, 64, 100, 256])
    @pytest.mark.parametrize("inverse", [False, True])
    def test_matches_numpy_engine(self, n, inverse):
        from baseband_tasks_tpu import Channelize, NoiseGenerator
        from baseband_tasks_tpu.fourier import fft_maker
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.models.runner import StreamRunner
        from baseband_tasks_tpu.utils import Time, units as u

        def tail():
            sh = NoiseGenerator(shape=(64 * n,),
                                start_time=Time("2018-01-01T00:00:00.0"),
                                sample_rate=1 * u.MHz,
                                samples_per_frame=16 * n,
                                dtype=np.complex64, seed=11)
            ch = Channelize(sh, n)
            return ch.inverse(ch) if inverse else ch

        cp = CompiledPipeline(tail())
        yr, yi = StreamRunner(cp, planes=True).run(2)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        with fft_maker.set("numpy"):
            ref = np.asarray(tail().read(len(got)))
        np.testing.assert_allclose(got, ref, rtol=2e-5,
                                   atol=2e-5 * np.abs(ref).max())


class TestXLAEngineMatmulGate:
    """The XLA engine runs its FFT (cuFFT on the GPU) at every length:
    on an H100 cuFFT beat the DFT matmul at Channelize(256) (PERF.md)."""

    def test_gate_logic(self, monkeypatch):
        import jax
        maker = XLAFFTMaker()
        fft = maker((40, 256), np.complex64, axis=1)
        assert not hasattr(fft, "_use_matmul")
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((40, 256))
             + 1j * rng.standard_normal((40, 256))).astype(np.complex64)
        np.testing.assert_allclose(np.asarray(fft(x)),
                                   np.fft.fft(x, axis=1),
                                   rtol=2e-4, atol=2e-3)


class TestNegativeAxis:
    def test_axis_minus_one(self):
        from baseband_tasks_tpu.fourier import fft_maker
        fft = fft_maker((64, 4), "float32", axis=-1)
        assert fft.frequency_shape == (64, 3)
        x = np.random.default_rng(0).standard_normal((64, 4)
                                                     ).astype(np.float32)
        np.testing.assert_allclose(np.asarray(fft(x)),
                                   np.fft.rfft(x, axis=-1), rtol=1e-5,
                                   atol=1e-5)


class TestFrequencyInfoValidation:
    def test_empty_shape_rejected(self):
        from baseband_tasks_tpu.fourier import fft_maker
        with pytest.raises(ValueError, match="empty shape"):
            fft_maker.get().get_frequency_data_info((), "complex64")

    def test_axis_out_of_bounds(self):
        from baseband_tasks_tpu.fourier import fft_maker
        with pytest.raises(ValueError, match="out of bounds"):
            fft_maker.get().get_frequency_data_info((8, 4), "complex64",
                                                    axis=2)
