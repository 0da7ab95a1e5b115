"""Kernel tests with dummy tasks, mirroring the reference test strategy
(SURVEY.md §4: dummy task subclasses to test the kernel in isolation)."""

import jax.numpy as jnp
import numpy as np
import pytest

from baseband_tasks_tpu import (
    Base, TaskBase, PaddedTaskBase, Task, SetAttribute, StreamGenerator,
    EmptyStreamGenerator, NoiseGenerator)
from baseband_tasks_tpu.utils import Time, units as u

START = Time("2018-01-01T00:00:00.000000000")


def make_counter(shape=(1000, 2), spf=100, rate=1 * u.kHz):
    """Stream whose data equals its sample index (analytically checkable)."""
    def counter(sh):
        o = sh.tell()
        n = min(sh.samples_per_frame, sh.shape[0] - o)
        idx = jnp.arange(o, o + n, dtype=jnp.float32)
        return jnp.broadcast_to(idx[:, None], (n,) + sh.sample_shape)
    return StreamGenerator(counter, shape, START, rate,
                           samples_per_frame=spf, dtype=np.float32)


class TestBaseProtocol:
    def test_shape_props(self):
        sh = make_counter()
        assert sh.shape == (1000, 2)
        assert sh.sample_shape == (2,)
        assert sh.size == 2000
        assert sh.ndim == 2
        assert not sh.complex_data

    def test_read_all(self):
        sh = make_counter()
        data = np.asarray(sh.read())
        np.testing.assert_array_equal(data[:, 0], np.arange(1000))

    def test_read_across_frames(self):
        sh = make_counter()
        sh.seek(95)
        data = np.asarray(sh.read(10))
        np.testing.assert_array_equal(data[:, 0], np.arange(95, 105))

    def test_seek_variants(self):
        sh = make_counter()
        assert sh.seek(10) == 10
        assert sh.seek(5, 1) == 15
        assert sh.seek(-10, 2) == 990
        assert sh.seek(100 * u.ms) == 100  # 1 kHz
        assert sh.seek(START + 250 * u.ms) == 250
        # reference semantics (base.py:343-353): out-of-range pointers
        # are allowed, like a regular filehandle; reading validates
        assert sh.seek(-1) == -1
        with pytest.raises(OSError):
            sh.read(1)
        sh.seek(0)

    def test_tell_time(self):
        sh = make_counter()
        sh.seek(500)
        assert abs((sh.time - START).sec - 0.5) < 1e-12
        assert abs((sh.stop_time - START).sec - 1.0) < 1e-12

    def test_eof(self):
        sh = make_counter()
        sh.seek(990)
        with pytest.raises(EOFError):
            sh.read(100)

    def test_read_rest(self):
        sh = make_counter()
        sh.seek(990)
        assert len(sh.read()) == 10

    def test_array_conversion(self):
        sh = make_counter(shape=(30, 2), spf=10)
        arr = np.asarray(sh)
        assert arr.shape == (30, 2)
        np.testing.assert_array_equal(arr[:, 1], np.arange(30))

    def test_close(self):
        sh = make_counter()
        with sh:
            sh.read(10)
        assert sh.closed
        with pytest.raises(ValueError):
            sh.read(1)


class ReshapeTime(TaskBase):
    """Dummy: groups n samples into a new axis (sample rate /n)."""

    def __init__(self, ih, n, **kwargs):
        self._n = n
        super().__init__(ih, sample_rate=ih.sample_rate / n,
                         ih_samples_per_frame=ih.samples_per_frame // n * n,
                         **kwargs)

    def _output_sample_shape(self, ih):
        return (self._n,) + ih.sample_shape

    def task(self, data):
        return data.reshape((-1, self._n) + data.shape[1:])


class Multiply(TaskBase):
    def __init__(self, ih, factor, **kwargs):
        self._factor = factor
        super().__init__(ih, **kwargs)

    def task(self, data):
        return data * self._factor


class TestTaskBase:
    def test_multiply(self):
        sh = make_counter()
        task = Multiply(sh, 3.0)
        assert task.shape == sh.shape
        assert task.sample_rate == sh.sample_rate
        data = np.asarray(task.read(10))
        np.testing.assert_allclose(data[:, 0], 3.0 * np.arange(10))

    def test_reshape_time(self):
        sh = make_counter(shape=(1000, 2), spf=100)
        task = ReshapeTime(sh, 4)
        assert task.shape == (250, 4, 2)
        assert task.sample_rate.to_value(u.Hz) == pytest.approx(250)
        data = np.asarray(task.read(2))
        np.testing.assert_array_equal(data[0, :, 0], [0, 1, 2, 3])
        np.testing.assert_array_equal(data[1, :, 0], [4, 5, 6, 7])

    def test_partial_last_frame(self):
        # 1030 samples, spf 100, n=4: last 30 -> 7 groups of 4, 2 unused
        sh = make_counter(shape=(1030, 2), spf=100)
        task = ReshapeTime(sh, 4)
        assert task.shape == (257, 4, 2)
        task.seek(250)
        data = np.asarray(task.read())
        assert data.shape == (7, 4, 2)
        np.testing.assert_array_equal(data[-1, :, 0], [1024, 1025, 1026, 1027])

    def test_time_propagation(self):
        sh = make_counter()
        task = ReshapeTime(sh, 4)
        assert task.start_time == sh.start_time
        task.seek(10)
        assert abs((task.time - START).sec - 10 / 250) < 1e-12

    def test_chained(self):
        sh = make_counter()
        task = Multiply(Multiply(sh, 2.0), 5.0)
        data = np.asarray(task.read(5))
        np.testing.assert_allclose(data[:, 0], 10.0 * np.arange(5))


class SquareHat(PaddedTaskBase):
    """Dummy: 3-sample moving sum (pad 1 each side)."""

    def __init__(self, ih, **kwargs):
        super().__init__(ih, pad_start=1, pad_end=1, **kwargs)

    def task(self, data):
        return data[:-2] + data[1:-1] + data[2:]


class TestPaddedTaskBase:
    def test_moving_sum(self):
        sh = make_counter(shape=(1000, 2), spf=100)
        task = SquareHat(sh, samples_per_frame=100)
        assert task.shape == (998, 2)
        data = np.asarray(task.read(5))
        # sum of (i-1, i, i+1) centered at i+1 in input indexing
        np.testing.assert_allclose(data[:, 0], [3, 6, 9, 12, 15])

    def test_start_time_shift(self):
        sh = make_counter()
        task = SquareHat(sh, samples_per_frame=100)
        assert abs((task.start_time - START).sec - 1e-3) < 1e-12

    def test_full_read_and_end(self):
        sh = make_counter(shape=(250, 2), spf=250)
        task = SquareHat(sh, samples_per_frame=64)
        data = np.asarray(task.read())
        assert data.shape == (248, 2)
        np.testing.assert_allclose(data[:, 0], 3 * (np.arange(248) + 1))

    def test_default_sizing_efficiency(self):
        sh = make_counter(shape=(10000, 2), spf=100)
        task = SquareHat(sh)
        pad = task.pad_start + task.pad_end
        assert task.samples_per_frame >= 3 * pad

    def test_inefficiency_warning(self):
        sh = make_counter(shape=(1000, 2), spf=100)
        with pytest.warns(UserWarning, match="efficiency"):
            SquareHat(sh, samples_per_frame=2)


class TestTaskFunction:
    def test_function_task(self):
        sh = make_counter()
        task = Task(sh, lambda data: data + 1.0)
        np.testing.assert_allclose(np.asarray(task.read(3))[:, 0], [1, 2, 3])

    def test_method_task(self):
        sh = make_counter()

        def method_task(self, data):
            return data * float(self.sample_rate.to_value(u.kHz))

        task = Task(sh, method_task)
        np.testing.assert_allclose(np.asarray(task.read(3))[:, 0], [0, 1, 2])


class TestSetAttribute:
    def test_override_frequency(self):
        sh = make_counter()
        freq = [400.0, 400.0] * u.MHz
        task = SetAttribute(sh, frequency=freq, sideband=1)
        assert task.frequency.to_value(u.MHz) == pytest.approx(400.0)
        assert task.sideband == 1
        np.testing.assert_array_equal(np.asarray(task.read(4)),
                                      np.asarray(make_counter().read(4)))

    def test_override_start_time(self):
        sh = make_counter()
        t_new = START + 1 * u.s
        task = SetAttribute(sh, start_time=t_new)
        assert task.start_time == t_new
        sh2 = make_counter()
        np.testing.assert_array_equal(np.asarray(task.read(4)),
                                      np.asarray(sh2.read(4)))

    def test_attribute_propagation(self):
        sh = make_counter()
        task1 = SetAttribute(sh, frequency=[400.0, 401.0] * u.MHz, sideband=1)
        task2 = Multiply(task1, 2.0)
        np.testing.assert_allclose(task2.frequency.to_value(u.MHz),
                                   [400.0, 401.0])
        assert np.all(task2.sideband == 1)


class TestGenerators:
    def test_empty_stream(self):
        sh = EmptyStreamGenerator((100, 4), START, 1 * u.kHz,
                                  samples_per_frame=10, dtype=np.float32)
        data = np.asarray(sh.read())
        assert data.shape == (100, 4)
        assert np.all(data == 0)

    def test_noise_reproducible_random_access(self):
        kwargs = dict(shape=(1000, 2), start_time=START,
                      sample_rate=1 * u.kHz, samples_per_frame=100, seed=7)
        sh1 = NoiseGenerator(**kwargs)
        sh2 = NoiseGenerator(**kwargs)
        # read out of order; frames must match bit-for-bit
        sh1.seek(500)
        a = np.asarray(sh1.read(100))
        sh2.seek(0)
        np.asarray(sh2.read(300))
        sh2.seek(500)
        b = np.asarray(sh2.read(100))
        np.testing.assert_array_equal(a, b)

    def test_noise_64bit_dtypes_need_x64(self):
        """Without jax x64 mode, float64/complex128 requests must raise
        instead of silently downcasting (VERDICT r1 weak #8)."""
        import jax
        for dtype in (np.float64, np.complex128):
            sh = NoiseGenerator(shape=(100,), start_time=START,
                                sample_rate=1 * u.kHz,
                                samples_per_frame=100, seed=1, dtype=dtype)
            if jax.config.jax_enable_x64:
                assert np.asarray(sh.read(100)).dtype == dtype
            else:
                with pytest.raises(ValueError, match="x64"):
                    sh.read(100)

    def test_noise_statistics(self):
        sh = NoiseGenerator(shape=(20000,), start_time=START,
                            sample_rate=1 * u.kHz, samples_per_frame=2000,
                            seed=3)
        data = np.asarray(sh.read())
        assert data.dtype == np.complex64
        # complex: unit variance per component
        assert np.std(data.real) == pytest.approx(1.0, rel=0.05)
        assert np.std(data.imag) == pytest.approx(1.0, rel=0.05)
        assert np.mean(data) == pytest.approx(0.0, abs=0.05)

    def test_different_seeds_differ(self):
        kwargs = dict(shape=(100,), start_time=START, sample_rate=1 * u.kHz,
                      samples_per_frame=100)
        a = np.asarray(NoiseGenerator(seed=1, **kwargs).read())
        b = np.asarray(NoiseGenerator(seed=2, **kwargs).read())
        assert not np.allclose(a, b)

    def test_noise_frames_do_not_repeat(self):
        """Consecutive frames must be fresh draws (reference
        test_generators.py:280-298)."""
        sh = NoiseGenerator(shape=(600, 2), start_time=START,
                            sample_rate=1 * u.kHz, samples_per_frame=100,
                            seed=11)
        data = np.asarray(sh.read())
        frames = data.reshape(6, 100, 2)
        for i in range(6):
            for j in range(i + 1, 6):
                assert not np.allclose(frames[i], frames[j])

    def test_generator_meta_attributes(self):
        """frequency/sideband/polarization set at construction propagate
        (reference test_generators.py:49-90)."""
        def ones(sh):
            return jnp.ones((sh.samples_per_frame,) + sh.sample_shape,
                            jnp.complex64)
        sh = StreamGenerator(ones, (100, 2, 2), START, 1 * u.kHz,
                             samples_per_frame=10,
                             frequency=[[311.25], [312.]] * u.MHz,
                             sideband=np.array([[1], [-1]]),
                             polarization=["L", "R"])
        np.testing.assert_allclose(
            sh.frequency.to_value(u.MHz), [[311.25], [312.]])
        np.testing.assert_array_equal(sh.sideband, [[1], [-1]])
        assert list(np.asarray(sh.polarization)) == ["L", "R"]

    def test_generator_getitem_slice(self):
        """fh[a:b] time slicing works directly on a generator
        (reference test_generators.py:91-109)."""
        def counter(sh):
            o = sh.tell()
            n = min(sh.samples_per_frame, sh.shape[0] - o)
            idx = jnp.arange(o, o + n, dtype=jnp.float32)
            return jnp.broadcast_to(idx[:, None], (n,) + sh.sample_shape)
        sh = StreamGenerator(counter, (1000, 2), START, 1 * u.kHz,
                             samples_per_frame=100, dtype=np.float32)
        sliced = sh[250:750]
        assert sliced.shape == (500, 2)
        assert abs((sliced.start_time - START).sec - 0.25) < 1e-12
        np.testing.assert_array_equal(np.asarray(sliced.read(5))[:, 0],
                                      np.arange(250, 255))

    def test_generator_exceptions(self):
        """Mis-shaped generator output fails on read (reference
        test_generators.py:110-131)."""
        def bad(sh):
            return jnp.zeros((sh.samples_per_frame, 7), jnp.complex64)
        sh = StreamGenerator(bad, (100, 2), START, 1 * u.kHz,
                             samples_per_frame=10)
        with pytest.raises(Exception):
            np.asarray(sh.read(10))

    def test_generator_short_frame_rejected(self):
        """A function returning fewer than samples_per_frame samples for
        a non-final frame must raise (a short frame would silently
        misalign every later sample)."""
        def short(sh):
            n = 9 if sh.tell() == 0 else sh.samples_per_frame
            return jnp.zeros((n, 2), jnp.complex64)
        sh = StreamGenerator(short, (100, 2), START, 1 * u.kHz,
                             samples_per_frame=10)
        with pytest.raises(ValueError, match="9 samples"):
            sh.read(20)


class TestRateRatio:
    """Exact rate-ratio derivation (VERDICT r1 weak #3): integer-valued
    rates must produce the exact reduced fraction with no float rounding;
    decimal float noise snaps to the intended simple fraction."""

    def _ratio(self, a, b):
        from fractions import Fraction
        r = TaskBase._rate_ratio(a, b)
        assert isinstance(r, Fraction)
        return r

    def test_audio_ratio_exact(self):
        r = self._ratio(44100 * u.Hz, 48000 * u.Hz)
        assert (r.numerator, r.denominator) == (147, 160)

    def test_near_unity_pathological(self):
        # float reconstruction cannot distinguish these; exact integer
        # arithmetic can
        big = 10 ** 9
        r = self._ratio((big + 1) * u.Hz, big * u.Hz)
        assert (r.numerator, r.denominator) == (big + 1, big)

    def test_cross_unit_exact(self):
        r = self._ratio(1 * u.MHz, 250 * u.kHz)
        assert (r.numerator, r.denominator) == (4, 1)

    def test_decimal_float_noise_snaps(self):
        # 44.1 kHz is not an exact binary float; the intended 147/160
        # must still come out
        r = self._ratio(44.1 * u.kHz, 48 * u.kHz)
        assert (r.numerator, r.denominator) == (147, 160)

    def test_prime_ratio(self):
        r = self._ratio(7919 * u.Hz, 7907 * u.Hz)
        assert (r.numerator, r.denominator) == (7919, 7907)

    def test_rejects_nonpositive(self):
        with pytest.raises(ValueError):
            self._ratio(-1 * u.Hz, 10 * u.Hz)


class TestGeneratorScenarios:
    """Reference scenarios (test_generators.py:216-317): an
    EmptyStreamGenerator + Task fill behaves like a file to downstream
    consumers; noise frames never repeat across offsets."""

    def test_empty_plus_task_as_source(self):
        from baseband_tasks_tpu import (EmptyStreamGenerator, Square,
                                        Task)

        tone = np.zeros((1000,), dtype=np.complex64)
        tone[200] = 1.0

        def set_tone(data):
            return jnp.broadcast_to(jnp.asarray(tone), data.shape)

        eh = EmptyStreamGenerator(shape=(10, 1000), start_time=START,
                                  sample_rate=10 * u.Hz,
                                  samples_per_frame=2,
                                  dtype=np.complex64)
        st = Square(Task(eh, set_tone))
        data1 = np.asarray(st.read())
        assert st.tell() == st.shape[0]
        assert abs((st.time - st.start_time).sec - 1.0) < 1e-9
        assert np.all(data1 == np.abs(tone) ** 2)
        st.seek(-3, 2)
        assert st.tell() == st.shape[0] - 3
        data2 = np.asarray(st.read())
        assert data2.shape[0] == 3
        assert np.all(data2 == np.abs(tone) ** 2)

    def test_noise_no_repetition(self):
        from baseband_tasks_tpu import NoiseGenerator

        nh = NoiseGenerator(shape=(64, 4, 2), start_time=START,
                            sample_rate=u.Quantity(10, u.kHz),
                            samples_per_frame=1, seed=1234567,
                            dtype=np.complex64)
        d0 = np.asarray(nh.read(1))
        nh.seek(3)
        d3 = np.asarray(nh.read(1))
        nh.seek(2)
        d2 = np.asarray(nh.read(1))
        d3_2 = np.asarray(nh.read(1))
        d4 = np.asarray(nh.read(1))
        assert not np.any(d0 == d3)
        assert not np.any(d3 == d2)
        assert not np.any(d3 == d4)
        # out-of-order reads must not reset the counter state
        assert not np.any(d2 == d4)
        assert np.all(d3 == d3_2)

    def test_generator_slice(self):
        from baseband_tasks_tpu import NoiseGenerator

        nh = NoiseGenerator(shape=(256, 2), start_time=START,
                            sample_rate=u.Quantity(1, u.kHz),
                            samples_per_frame=32, seed=5,
                            dtype=np.complex64)
        whole = np.asarray(nh.read())
        sl = nh[100:180]
        assert sl.shape == (80, 2)
        assert abs((sl.start_time - START).sec - 0.1) < 1e-9
        np.testing.assert_array_equal(np.asarray(sl.read()),
                                      whole[100:180])


class TestReferenceBaseSemantics:
    """Behaviors the reference pins in test_base.py that involve the
    array protocol, attribute pairing, and Task introspection."""

    def test_need_both_frequency_and_sideband(self):
        sh = make_counter()
        with pytest.raises(ValueError, match="both"):
            SetAttribute(sh, frequency=np.arange(2.) * u.MHz)
        with pytest.raises(ValueError, match="both"):
            SetAttribute(sh, sideband=np.array([1, -1]))

    def test_fail_on_unknown_attribute(self):
        sh = make_counter()
        with pytest.raises(TypeError):
            SetAttribute(sh, freq=1.0 * u.MHz)

    def test_no_implicit_array(self):
        """ufuncs/array functions must not materialize the stream
        (reference base.py:482-486); explicit np.asarray still works."""
        sh = make_counter(shape=(30, 2), spf=10)
        with pytest.raises(TypeError):
            np.sin(sh)
        with pytest.raises(TypeError):
            np.array(1.0) | sh
        with pytest.raises(TypeError):
            np.rot90(sh)
        assert np.asarray(sh).shape == (30, 2)

    def test_task_argspec_rules(self):
        """1 required arg = function, 2 = method, else raise
        (reference base.py:866-884 + test_base.py:468-490)."""
        import inspect
        sh = make_counter()
        with pytest.raises(TypeError):
            Task(sh, object())

        def trial(data, bla=1):
            return data

        with Task(sh, trial) as th:
            assert not inspect.ismethod(th.task)

        def trial2(data, bla, bla2=1):
            return data

        with Task(sh, trial2) as th2:
            assert inspect.ismethod(th2.task)

        def trial3(data, bla, bla2, bla3=1):
            return data

        with pytest.raises(TypeError):
            Task(sh, trial3)


class TestTaskBoundMethods:
    """Bound methods: inspect.signature already excludes self, unlike
    the reference's getfullargspec (base.py:869-874) — the counting must
    agree with the reference's net result."""

    class Proc:
        def one(self, data):
            return data * 2.0

        def two(self, fh, data):
            # bound + 2 free args = method: the Task instance arrives
            # as the first free argument (reference base.py:879-882)
            assert isinstance(fh, Task)
            return data

    def test_bound_one_arg_is_function(self):
        import inspect
        sh = make_counter()
        th = Task(sh, self.Proc().one)
        assert not inspect.ismethod(th.task) or \
            th.task.__self__ is not th  # bound to Proc, not to the Task
        np.testing.assert_allclose(np.asarray(th.read(3))[:, 0],
                                   [0, 2, 4])

    def test_bound_two_arg_is_method(self):
        sh = make_counter()
        th = Task(sh, self.Proc().two)
        np.testing.assert_allclose(np.asarray(th.read(3))[:, 0],
                                   [0, 1, 2])


class TestPerformanceHint:
    """Long eager reads through task chains on an accelerator backend
    emit a one-time CompiledPipeline hint."""

    def _chain(self, n=1 << 14, spf=256):
        from baseband_tasks_tpu import NoiseGenerator, Square
        from baseband_tasks_tpu.utils import Time, units as u
        src = NoiseGenerator(shape=(n,), start_time=Time.from_mjd(58000.),
                             sample_rate=1 * u.MHz, samples_per_frame=spf,
                             seed=0)
        return Square(src)

    def test_hint_emitted_once(self, monkeypatch):
        import jax
        import warnings as w
        from baseband_tasks_tpu.base import Base, PerformanceHint
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(Base, "_hinted_compiled", False)
        sq = self._chain()
        with pytest.warns(PerformanceHint, match=r"\.compile\(\)"):
            sq.read(1 << 14)
        # once per process only
        sq.seek(0)
        with w.catch_warnings():
            w.simplefilter("error", PerformanceHint)
            sq.read(1 << 14)

    def test_no_hint_for_short_reads_or_sources(self, monkeypatch):
        import jax
        import warnings as w
        from baseband_tasks_tpu.base import Base, PerformanceHint
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(Base, "_hinted_compiled", False)
        sq = self._chain()
        with w.catch_warnings():
            w.simplefilter("error", PerformanceHint)
            sq.read(1024)          # few frames: no hint
            sq.ih.seek(0)
            sq.ih.read(1 << 14)    # source node (no ih): no hint
