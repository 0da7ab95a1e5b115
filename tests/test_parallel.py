"""Sharding tests on the virtual 8-device CPU mesh: sharded outputs must
bit-match single-device computation (SURVEY.md §4)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from baseband_tasks_tpu.parallel import (make_mesh, halo_exchange,
                                         sharded_overlap_save)
from baseband_tasks_tpu.models import WidebandPulsarPipeline
from baseband_tasks_tpu.utils import units as u


class TestMesh:
    def test_make_mesh(self):
        mesh = make_mesh(time=4, chan=2)
        assert mesh.shape == {"time": 4, "chan": 2}

    def test_absorb_remaining(self):
        mesh = make_mesh(time=-1, chan=2)
        assert mesh.shape["time"] == 4

    def test_too_many(self):
        with pytest.raises(ValueError):
            make_mesh(time=16, chan=2)

    def test_both_unknown_rejected(self):
        with pytest.raises(ValueError, match="one of"):
            make_mesh(time=-1, chan=-1)

    def test_nonpositive_rejected(self):
        with pytest.raises(ValueError, match="positive"):
            make_mesh(time=0, chan=2)


class TestHaloExchange:
    def test_matches_global_slices(self):
        mesh = make_mesh(time=4, chan=1)
        x = np.arange(64, dtype=np.float32).reshape(64, 1)
        pad_s, pad_e = 3, 2

        def local(xl):
            return halo_exchange(xl, pad_s, pad_e)

        out = jax.shard_map(local, mesh=mesh, in_specs=P("time", "chan"),
                            out_specs=P("time", "chan"))(jnp.asarray(x))
        out = np.asarray(out).reshape(4, 16 + pad_s + pad_e)
        # interior shard 1 must see [16-3 .. 32+2)
        np.testing.assert_array_equal(out[1], np.arange(13, 34))
        # edge shards see zeros beyond the stream
        np.testing.assert_array_equal(out[0][:pad_s], 0)
        np.testing.assert_array_equal(out[3][-pad_e:], 0)

    def test_periodic(self):
        mesh = make_mesh(time=4, chan=1)
        x = np.arange(16, dtype=np.float32).reshape(16, 1)

        def local(xl):
            return halo_exchange(xl, 1, 1, periodic=True)

        out = jax.shard_map(local, mesh=mesh, in_specs=P("time", "chan"),
                            out_specs=P("time", "chan"))(jnp.asarray(x))
        out = np.asarray(out).reshape(4, 6)
        assert out[0][0] == 15  # wrapped from the last shard

    def test_oversized_halo_rejected_in_edges_too(self):
        """An oversized trailing pad is refused like a leading one (an
        unguarded lax.slice would wrap and exchange wrong data)."""
        mesh = make_mesh(time=4, chan=1)
        x = jnp.asarray(np.arange(40, dtype=np.float32).reshape(40, 1))

        with pytest.raises(ValueError, match="exceeds local block"):
            jax.shard_map(lambda xl: halo_exchange(xl, 2, 13), mesh=mesh,
                          in_specs=P("time", "chan"),
                          out_specs=P("time", "chan"))(x)


class TestShardedOverlapSave:
    def test_moving_average_matches_single_device(self):
        """3-tap moving sum via sharded overlap-save == direct numpy."""
        mesh = make_mesh(time=4, chan=2)
        rng = np.random.default_rng(0)
        x = rng.standard_normal((256, 2)).astype(np.float32)

        def fn(window):
            return window[:-2] + window[1:-1] + window[2:]

        sharded = sharded_overlap_save(fn, mesh, pad_start=1, pad_end=1)
        out = np.asarray(sharded(jnp.asarray(x)))
        xp = np.pad(x, ((1, 1), (0, 0)))
        expected = xp[:-2] + xp[1:-1] + xp[2:]
        np.testing.assert_allclose(out, expected, rtol=1e-6, atol=1e-6)


class TestWidebandPipeline:
    def make(self, mesh, **kw):
        args = dict(n_chan=8, n_pol=2, dm=5.0, freq_center=600 * u.MHz,
                    chan_rate=250 * u.kHz, period_samples=(800, 1),
                    n_phase=16, block_samples=2048, mesh=mesh)
        args.update(kw)
        return WidebandPulsarPipeline(**args)

    def test_chan_sharded_matches_unsharded(self):
        """Channel sharding must be bit-compatible with one device."""
        single = self.make(make_mesh(time=1, chan=1))
        multi = self.make(make_mesh(time=1, chan=2))
        assert multi.global_block == single.global_block
        rng = np.random.default_rng(1)
        T = multi.global_block
        xf = rng.standard_normal((T, 8, 2, 2)).astype(np.float32)
        prof_m, cnt_m = multi.step_fn()(
            jax.device_put(xf, NamedSharding(multi.mesh,
                                             P("time", "chan"))),
            jnp.float32(0))
        prof_s, cnt_s = single.step_fn()(jnp.asarray(xf), jnp.float32(0))
        np.testing.assert_array_equal(np.asarray(cnt_m), np.asarray(cnt_s))
        np.testing.assert_allclose(np.asarray(prof_m), np.asarray(prof_s),
                                   rtol=1e-5, atol=1e-4)

    def test_time_sharded_matches_closed_form(self):
        """With dm=0 the chirp is unity, so per-shard fft/ifft round-trips
        and the folded profile equals a direct numpy fold."""
        multi = self.make(make_mesh(time=4, chan=2), dm=0.0)
        rng = np.random.default_rng(2)
        T = multi.global_block
        xf = rng.standard_normal((T, 8, 2, 2)).astype(np.float32)
        prof, cnt = multi.step_fn()(
            jax.device_put(xf, NamedSharding(multi.mesh,
                                             P("time", "chan"))),
            jnp.float32(0))
        power = xf[..., 0] ** 2 + xf[..., 1] ** 2
        bins = (np.arange(T) % 800) * 16 // 800
        expected = np.zeros((16, 8, 2), np.float32)
        np.add.at(expected, bins, power)
        np.testing.assert_allclose(np.asarray(prof), expected, rtol=1e-3,
                                   atol=1e-2)
        counts = np.bincount(bins, minlength=16).astype(np.float32)
        np.testing.assert_array_equal(np.asarray(cnt), counts)

    @pytest.mark.parametrize("option", [dict(halo="remote"),
                                        dict(use_pallas=True),
                                        dict(ingest_bits=8),
                                        dict(fft_pow2=True)])
    def test_removed_options_raise(self, option):
        """The options that only chose the removed kernel paths are
        gone: passing one is a TypeError, not a silent fallback."""
        with pytest.raises(TypeError):
            self.make(make_mesh(time=1, chan=1), **option)

    def test_production_shape_factorizations(self):
        """Production shapes (n_chan=128, 2^15-sample shards, n_phase=64)
        across (time, chan) mesh factorizations.

        With dm=0 (unit chirp: fft·ifft is an identity to roundoff, so
        overlap-save window placement cannot matter) every factorization
        must match the single-device (1,1) profile bit-for-bit-level;
        with dm=50 the chan resharding at fixed time sharding must stay
        bit-compatible.  Counts are exact everywhere."""
        rng = np.random.default_rng(7)
        n_chan, n_phase = 128, 64
        block = 1 << 15

        def run(t, c, dm, x=None):
            pipe = self.make(make_mesh(time=t, chan=c), n_chan=n_chan,
                             n_phase=n_phase, dm=dm,
                             freq_center=1400 * u.MHz,
                             # per_q a power of two: the kernel's 2^-31
                             # fixed-point phase rate is then EXACT, so
                             # the closed-form integer bins match it
                             # sample-for-sample
                             period_samples=(16384, 3),
                             block_samples=block)
            T = pipe.global_block
            if x is None:
                x = rng.standard_normal(
                    (T, n_chan, 2, 2)).astype(np.float32)
            prof, cnt = pipe.step_fn()(
                jax.device_put(x, NamedSharding(pipe.mesh,
                                                P("time", "chan"))),
                jnp.float32(0))
            assert float(np.asarray(cnt).sum()) == float(T)
            return np.asarray(prof), x, pipe

        # dm=0: window placement is irrelevant -> every factorization
        # equals single-device (each processes its own T; same per-shard
        # block so (t, c) with equal t share T; compare via per-sample
        # normalized closed-form fold)
        for t, c in ((4, 2), (2, 4), (4, 1)):
            prof, x, pipe = run(t, c, 0.0)
            T = x.shape[0]
            power = x[..., 0] ** 2 + x[..., 1] ** 2
            bins = (np.arange(T) * 3 % 16384) * n_phase // 16384
            expected = np.zeros((n_phase, n_chan, 2), np.float32)
            np.add.at(expected, bins, power)
            np.testing.assert_allclose(prof, expected, rtol=2e-3,
                                       atol=0.05)
        # dm=50: chan resharding bit-compatibility at fixed time shards
        prof_a, x, _ = run(4, 2, 50.0)
        prof_b, _, _ = run(4, 1, 50.0, x=x)
        np.testing.assert_allclose(prof_a, prof_b, rtol=1e-6, atol=1e-3)

    def test_production_shape_corner_turn(self):
        """Corner-turn reshard at a production shape: 8-way sharded
        channelize (FFT + all_to_all) equals the local computation."""
        from baseband_tasks_tpu.parallel.corner import sharded_channelize
        mesh = Mesh(np.array(jax.devices()[:8]), ("time",))
        n = 256
        t_total = 8 * (1 << 14)
        rng = np.random.default_rng(9)
        x = (rng.standard_normal(t_total)
             + 1j * rng.standard_normal(t_total)).astype(np.complex64)
        got = np.asarray(sharded_channelize(mesh, n)(
            jax.device_put(x, NamedSharding(mesh, P("time")))))
        expect = np.fft.fft(x.reshape(-1, n), axis=1)
        np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-2)

    def test_step_shapes(self):
        pipe = self.make(make_mesh(time=2, chan=2))
        xf, off = pipe.example_inputs()
        prof, cnt = pipe.step_fn()(xf, off)
        assert prof.shape == (16, 8, 2)
        assert cnt.shape == (16,)
        assert int(np.asarray(cnt).sum()) == pipe.global_block

    def test_fold_bins_follow_offset(self):
        pipe = self.make(make_mesh(time=1, chan=1))
        xf, _ = pipe.example_inputs()
        _, cnt0 = pipe.step_fn()(xf, jnp.float32(0))
        _, cnt1 = pipe.step_fn()(xf, jnp.float32(400))
        # shifting by half a period rotates the bin occupancy
        assert not np.array_equal(np.asarray(cnt0), np.asarray(cnt1)) \
            or np.allclose(np.asarray(cnt0), np.asarray(cnt0).mean())

    def test_dedispersion_does_something(self):
        # dispersed impulse concentrates only after dedispersion
        pipe = self.make(make_mesh(time=1, chan=1), dm=0.0)
        # pads are rounded up to 128-sample alignment
        assert pipe.pad_start == 128 and pipe.pad_end >= 128
        # window is 2/3/5-smooth
        m = pipe._n_fft
        for p in (2, 3, 5):
            while m % p == 0:
                m //= p
        assert m == 1

    def test_pads_on_the_side_of_the_delay(self):
        """Removing the dispersion advances the low channels: a window
        reads the largest delay after its block and the most negative
        one before it, as Dedisperse pads its frames (a 100 MHz band,
        whose edge delays differ by ~1300 samples)."""
        from baseband_tasks_tpu import Dedisperse, NoiseGenerator, SetAttribute
        from baseband_tasks_tpu.utils import Time
        pipe = WidebandPulsarPipeline(
            n_chan=16, n_pol=1, dm=5.0, freq_center=100 * u.MHz,
            block_samples=1 << 16, mesh=make_mesh(time=1, chan=1))
        src = NoiseGenerator(shape=(1 << 18, 16), start_time=Time.from_mjd(
            58000.0), sample_rate=pipe.chan_rate, samples_per_frame=1 << 16)
        ded = Dedisperse(SetAttribute(src, frequency=pipe.freqs, sideband=1),
                         5.0, reference_frequency=pipe.reference_frequency,
                         pad_margin=0)
        assert ded.pad_end - ded.pad_start > 1000
        # the pipeline adds 64 samples and rounds up to a multiple of 128
        assert 0 <= pipe.pad_start - 64 - ded.pad_start < 128
        assert 0 <= pipe.pad_end - 64 - ded.pad_end < 128


def _words_and_floats(pipe, bits, seed):
    """Random packed words for ``pipe`` and the float32 pairs they
    decode to (the step's scaled units), from the numpy decode."""
    from baseband_tasks_tpu.ops.unpack_device import pack_time_words
    rng = np.random.default_rng(seed)
    T = pipe.global_block
    shape = (T, pipe.n_chan, pipe.n_pol)
    fr = rng.integers(0, 1 << bits, size=shape)
    fi = rng.integers(0, 1 << bits, size=shape)
    levels = {2: np.array([-3.3359, -1.0, 1.0, 3.3359], np.float32)}

    def dec(f):
        if bits == 1:
            return np.where(f == 0, -1.0, 1.0).astype(np.float32)
        if bits == 2:
            return levels[2][f]
        off = {4: 7.5, 8: 127.5}[bits]
        return (f - off).astype(np.float32) / {4: 4.0, 8: 64.0}[bits]

    xf = np.stack([dec(fr), dec(fi)], axis=-1).astype(np.float32)
    sh = NamedSharding(pipe.mesh, P("time", "chan"))
    return (jax.device_put(pack_time_words(fr, bits), sh),
            jax.device_put(pack_time_words(fi, bits), sh),
            jax.device_put(xf, sh))


class TestPackedStep:
    """Packed words decoded inside the XLA step (the path that replaced
    the fused stage-A kernel's decode)."""

    KW = dict(n_chan=8, n_pol=2, dm=1.0, freq_center=600 * u.MHz,
              chan_rate=250 * u.kHz, period_samples=(800, 1),
              n_phase=16, block_samples=1024)

    @pytest.mark.parametrize("bits", [1, 2, 4, 8])
    @pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
    def test_packed_step_matches_float_step(self, bits, mesh_shape):
        """The packed step equals the float step on the numpy decode of
        the same words, at every bit depth and mesh layout."""
        pipe = WidebandPulsarPipeline(mesh=make_mesh(*mesh_shape),
                                      **self.KW)
        wr, wi, xf = _words_and_floats(pipe, bits, seed=bits)
        pp, cp = pipe.packed_step_fn(bits)(wr, wi, jnp.float32(0))
        pr, cr = pipe.step_fn()(xf, jnp.float32(0))
        np.testing.assert_array_equal(np.asarray(cp), np.asarray(cr))
        np.testing.assert_allclose(np.asarray(pp), np.asarray(pr),
                                   rtol=1e-5, atol=1e-4)

    def test_run_fn_packed_counts(self):
        pipe = WidebandPulsarPipeline(mesh=make_mesh(time=2, chan=2),
                                      **self.KW)
        prof, cnt = pipe.run_fn(2, ingest_bits=8)()
        assert np.isfinite(np.asarray(prof)).all()
        assert float(np.asarray(cnt).sum()) == 2 * pipe.global_block

    @pytest.mark.parametrize("bits", [None, 8])
    def test_run_fn_matches_step_on_its_inputs(self, bits):
        """One run_fn iteration (scale 1, offset 0) equals the step on
        the block ``run.inputs`` reports."""
        pipe = WidebandPulsarPipeline(mesh=make_mesh(time=2, chan=2),
                                      **self.KW)
        run = pipe.run_fn(1, ingest_bits=bits)
        prof, cnt = run(7)
        if bits:
            ref = pipe.packed_step_fn(bits)(*run.inputs(7), jnp.float32(0))
        else:
            ref = pipe.step_fn()(*run.inputs(7), jnp.float32(0))
        np.testing.assert_array_equal(np.asarray(cnt), np.asarray(ref[1]))
        np.testing.assert_allclose(np.asarray(prof), np.asarray(ref[0]),
                                   rtol=1e-5, atol=1e-4)

    @pytest.mark.parametrize("bits", [0, 3, 16])
    def test_bad_bit_depth_raises(self, bits):
        pipe = WidebandPulsarPipeline(mesh=make_mesh(time=1, chan=1),
                                      **self.KW)
        with pytest.raises(ValueError, match="ingest_bits"):
            pipe.run_fn(1, ingest_bits=bits)

    def test_block_divides_every_bit_depth(self):
        """Pads and window sit on a 128-sample grid, so every packed
        depth's samples-per-word divides the valid block."""
        for dm in (0.0, 1.0, 7.3):
            pipe = WidebandPulsarPipeline(
                mesh=make_mesh(time=1, chan=1), **dict(self.KW, dm=dm))
            assert pipe.block_samples % 128 == 0


class TestCompiledPipeline:
    """Scan-compiled chains must match the eager Stream computation."""

    def _source_blocks(self, sh, n_blocks, block):
        sh.seek(0)
        return np.stack([np.asarray(sh.read(block))
                         for _ in range(n_blocks)])

    def test_plain_chain_matches_eager(self):
        from baseband_tasks_tpu import (Channelize, NoiseGenerator,
                                        SetAttribute, Square)
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.utils import Time
        t0 = Time("2020-01-01T00:00:00.0")
        src = NoiseGenerator(shape=(8192,), start_time=t0,
                             sample_rate=u.Quantity(1 << 20, u.Hz),
                             samples_per_frame=2048, seed=5)
        tail = Square(Channelize(src, 64))
        cp = CompiledPipeline(tail)
        assert cp.warmup == 0
        block = int(np.lcm(cp.block_samples, 1024))
        blocks = self._source_blocks(src, 8192 // block, block)
        out = np.asarray(cp.run_blocks(blocks))
        tail.seek(0)
        eager = np.asarray(tail.read(len(out)))
        np.testing.assert_allclose(out, eager, rtol=1e-4, atol=1e-3)

    @staticmethod
    def _snr_db(ref, test):
        ref = np.asarray(ref, np.float64)
        err = np.sum((ref - np.asarray(test, np.float64)) ** 2)
        if err == 0:
            return np.inf
        return 10 * np.log10(np.sum(ref ** 2) / err)

    def test_padded_chain_matches_eager_after_delay(self):
        """With the padded stage's frame size dividing its pad, each
        compiled streaming window coincides exactly with an eager frame
        window (window_k = [k·spf - pad, k·spf + spf) = eager window
        k - pad/spf), so compiled output must equal the eager output
        delayed by ``pad`` to float roundoff — no leakage tolerance."""
        from baseband_tasks_tpu import (Dedisperse, NoiseGenerator,
                                        SetAttribute, Square)
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.utils import Time
        t0 = Time("2020-01-01T00:00:00.0")

        def make_src():
            return SetAttribute(
                NoiseGenerator(shape=(65536,), start_time=t0,
                               sample_rate=1 * u.MHz,
                               samples_per_frame=8192, seed=9),
                frequency=600 * u.MHz, sideband=1)

        probe = Dedisperse(make_src(), 1.0)
        pad = probe.pad_start + probe.pad_end
        tail = Square(Dedisperse(make_src(), 1.0, samples_per_frame=pad))
        cp = CompiledPipeline(tail)
        delay = int(cp.delay)
        assert delay == pad
        n_blocks = 12
        blocks = self._source_blocks(make_src(), n_blocks, cp.block_samples)
        out = np.asarray(cp.run_blocks(blocks))
        tail.seek(0)
        eager = np.asarray(tail.read(len(out) - delay))
        assert self._snr_db(eager, out[delay:]) >= 60.0

    def test_three_stage_padded_chain_exact(self):
        """Dedisperse → Convolve → Square with every pad a multiple of
        the frame size: still exact after the combined delay."""
        from baseband_tasks_tpu import (Convolve, Dedisperse,
                                        NoiseGenerator, SetAttribute,
                                        Square)
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.utils import Time
        t0 = Time("2020-01-01T00:00:00.0")

        def make_src():
            return SetAttribute(
                NoiseGenerator(shape=(65536,), start_time=t0,
                               sample_rate=1 * u.MHz,
                               samples_per_frame=8192, seed=21),
                frequency=600 * u.MHz, sideband=1)

        probe = Dedisperse(make_src(), 0.25)
        spf = probe.pad_start + probe.pad_end
        rng = np.random.default_rng(2)
        resp = (rng.standard_normal(spf + 1) / spf).astype(np.float32)

        def make_tail():
            d = Dedisperse(make_src(), 0.25, samples_per_frame=spf)
            c = Convolve(d, resp, samples_per_frame=spf)
            return Square(c)

        tail = make_tail()
        cp = CompiledPipeline(tail)
        delay = int(np.ceil(cp.delay))
        n_blocks = 12
        blocks = self._source_blocks(make_src(), n_blocks, cp.block_samples)
        out = np.asarray(cp.run_blocks(blocks))
        tail.seek(0)
        eager = np.asarray(tail.read(len(out) - delay))
        assert self._snr_db(eager, out[delay:]) >= 60.0

    def test_incompatible_padded_stages_raise(self):
        from baseband_tasks_tpu import Convolve, Dedisperse, NoiseGenerator, \
            SetAttribute
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.utils import Time
        t0 = Time("2020-01-01T00:00:00.0")
        src = SetAttribute(
            NoiseGenerator(shape=(65536,), start_time=t0,
                           sample_rate=1 * u.MHz, samples_per_frame=8192,
                           seed=9), frequency=600 * u.MHz, sideband=1)
        d1 = Dedisperse(src, 1.0, samples_per_frame=4096)
        c2 = Convolve(d1, np.ones(17, np.float32) / 17,
                      samples_per_frame=1000)
        with pytest.raises(ValueError, match="disagree|incompatible"):
            CompiledPipeline(c2)

    def test_read_source_blocks_from_file(self, tmp_path):
        """Compiled chain fed from an HDF5 recording."""
        import jax.numpy as jnp
        from baseband_tasks_tpu import (Channelize, NoiseGenerator,
                                        SetAttribute, Square)
        from baseband_tasks_tpu.io import hdf5
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.utils import Time
        t0 = Time("2020-01-01T00:00:00.0")
        src = SetAttribute(
            NoiseGenerator(shape=(8192,), start_time=t0,
                           sample_rate=u.Quantity(1 << 20, u.Hz),
                           samples_per_frame=2048, seed=4),
            frequency=600 * u.MHz, sideband=1)
        path = str(tmp_path / "rec.h5")
        with hdf5.open(path, "w", template=src) as fw:
            fw.write(np.asarray(src.read()))
        recorded = hdf5.open(path)
        tail = Square(Channelize(recorded, 64))
        cp = CompiledPipeline(tail)
        blocks = cp.read_source_blocks(4, offset=0)
        out = np.asarray(cp.run_blocks(blocks))
        tail.seek(0)
        eager = np.asarray(tail.read(len(out)))
        np.testing.assert_allclose(out, eager, rtol=1e-4, atol=1e-3)


class TestExternalBinsFold:
    def test_bins_fold_matches_numpy(self):
        """dm=0 + external bins: profile equals a direct numpy fold."""
        pipe = WidebandPulsarPipeline(
            n_chan=8, n_pol=2, dm=0.0, freq_center=600 * u.MHz,
            chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
            block_samples=1024, mesh=make_mesh(time=2, chan=2))
        T = pipe.global_block
        rng = np.random.default_rng(7)
        xf = rng.standard_normal((T, 8, 2, 2)).astype(np.float32)
        bins = rng.integers(0, 8, T).astype(np.float32)
        step = pipe.step_bins_fn()
        prof, cnt = step(
            jax.device_put(xf, NamedSharding(pipe.mesh, P("time", "chan"))),
            jnp.asarray(bins))
        power = xf[..., 0] ** 2 + xf[..., 1] ** 2
        expected = np.zeros((8, 8, 2), np.float32)
        np.add.at(expected, bins.astype(int), power)
        np.testing.assert_allclose(np.asarray(prof), expected, rtol=1e-3,
                                   atol=1e-2)
        np.testing.assert_array_equal(
            np.asarray(cnt), np.bincount(bins.astype(int), minlength=8))

    def test_phase_bins_from_polyco(self):
        """Host bins from a linear polyco match the integer-modular fold."""
        from baseband_tasks_tpu.phases import Polyco, PolycoPhase
        from baseband_tasks_tpu.utils import Time
        pipe = WidebandPulsarPipeline(
            n_chan=8, n_pol=2, dm=0.0, freq_center=600 * u.MHz,
            chan_rate=250 * u.kHz, period_samples=(1000, 1), n_phase=10,
            block_samples=1024, mesh=make_mesh(time=1, chan=1))
        tmid = 58000.0
        f0 = 250e3 / 1000.0
        text = ("FAKE        1-JAN-18  000000.00   "
                f"{tmid:.11f}  0.0 0.0 0.0\n"
                f"0.050000  {f0:.12E}   xx  1440    1   600.000\n"
                "0.00000000000000000D+00\n").replace("E+", "D+")
        pp = PolycoPhase(Polyco(text))
        bins = pipe.phase_bins(pp, Time.from_mjd(tmid), offset=0)
        # phase = idx/1000 + 0.05 -> bin = floor(frac*10)
        idx = np.arange(pipe.global_block)
        expected = np.minimum(
            ((idx % 1000) / 1000.0 + 0.05) % 1.0 * 10, 9.999).astype(int)
        # boundary samples may flip by one bin through float rounding
        assert np.mean(bins.astype(int) != expected) < 0.02


class TestCornerTurn:
    """all_to_all channelize reshard (SURVEY §5 corner turn)."""

    def test_channelize_matches_local(self):
        import jax
        import jax.numpy as jnp
        from baseband_tasks_tpu.parallel import (sharded_channelize,
                                                 sharded_dechannelize)
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("time",))
        n = 8
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((1024, 2))
             + 1j * rng.standard_normal((1024, 2))).astype(np.complex64)
        fn = sharded_channelize(mesh, n)
        got = np.asarray(jax.jit(fn)(jnp.asarray(x)))
        expected = np.fft.fft(x.reshape(128, 8, 2), axis=1)
        np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)

    def test_roundtrip(self):
        import jax
        import jax.numpy as jnp
        from baseband_tasks_tpu.parallel import (sharded_channelize,
                                                 sharded_dechannelize)
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("time",))
        rng = np.random.default_rng(1)
        x = (rng.standard_normal((512,))
             + 1j * rng.standard_normal((512,))).astype(np.complex64)
        ch = sharded_channelize(mesh, 16)
        de = sharded_dechannelize(mesh)
        back = np.asarray(jax.jit(lambda v: de(ch(v)))(jnp.asarray(x)))
        np.testing.assert_allclose(back, x, rtol=1e-4, atol=1e-4)

    def test_output_sharding(self):
        import jax
        import jax.numpy as jnp
        from baseband_tasks_tpu.parallel import sharded_channelize
        from jax.sharding import Mesh
        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("time",))
        fn = sharded_channelize(mesh, 8)
        out = jax.jit(fn)(jnp.ones((256,), jnp.complex64))
        assert out.shape == (32, 8)
        # channel axis sharded over the former time axis
        spec = out.sharding.spec
        assert tuple(spec) [1] == "time"

    def test_split_step_matches_pairs(self):
        """The packed run loop on a (time, chan) mesh folds exactly what
        the packed step folds on the same words (iteration scale 1)."""
        pipe = WidebandPulsarPipeline(
            n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
            chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
            block_samples=1024, mesh=make_mesh(time=2, chan=2))
        run = pipe.run_fn(1, ingest_bits=4)
        prof_a, cnt_a = run(3)
        prof_b, cnt_b = pipe.packed_step_fn(4)(*run.inputs(3),
                                               jnp.float32(0))
        np.testing.assert_array_equal(np.asarray(cnt_a), np.asarray(cnt_b))
        np.testing.assert_allclose(np.asarray(prof_a), np.asarray(prof_b),
                                   rtol=1e-5, atol=1e-4)


class TestCompiledDedisperseChain:
    def test_dedisperse_chain_matches_eager(self):
        """CompiledPipeline over a Dedisperse chain: the scan-compiled
        output must equal the eager stream."""
        from baseband_tasks_tpu import Dedisperse, NoiseGenerator, \
            SetAttribute, Square
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.utils import Time

        def make_src():
            return SetAttribute(
                NoiseGenerator(shape=(65536,),
                               start_time=Time("2020-01-01T00:00:00.0"),
                               sample_rate=1 * u.MHz,
                               samples_per_frame=8192, seed=9),
                frequency=600 * u.MHz, sideband=1)

        # pad_margin chosen so pad_start = pad_end = 256: total pad 512
        # is a multiple of samples_per_frame=512 (compiled windows then
        # coincide with eager frame windows — exact to roundoff) and the
        # window 512+512 = 1024 is FFT-fast.
        tail = Square(Dedisperse(make_src(), 1.0, samples_per_frame=512,
                                 pad_margin=236))
        ded = tail.ih
        assert (ded.pad_start + ded.pad_end) % ded.samples_per_frame == 0
        cp = CompiledPipeline(tail)
        delay = int(cp.delay)
        n_blocks = 24
        src = make_src()
        src.seek(0)
        blocks = np.stack([np.asarray(src.read(cp.block_samples))
                           for _ in range(n_blocks)])
        out = np.asarray(cp.run_blocks(blocks))
        tail.seek(0)
        eager = np.asarray(tail.read(len(out) - delay))
        err = np.sum((out[delay:] - eager) ** 2)
        snr_db = 10 * np.log10(np.sum(eager ** 2) / max(err, 1e-30))
        assert snr_db >= 60.0, snr_db


class TestStreamRunner:
    def test_matches_run_blocks(self, tmp_path):
        """Double-buffered streaming (reader thread + device_put ahead)
        must produce exactly what the batch scan produces, including
        from a real on-disk source (VDIF file)."""
        from baseband_tasks_tpu import (Dedisperse, NoiseGenerator,
                                        SetAttribute, Square)
        from baseband_tasks_tpu.io import vdif
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.models.runner import StreamRunner
        from baseband_tasks_tpu.utils import Time

        t0 = Time("2020-01-01T00:00:00.0")
        gen = NoiseGenerator(shape=(40000,), start_time=t0,
                             sample_rate=u.Quantity(100, u.kHz),
                             samples_per_frame=10000, seed=21)
        path = str(tmp_path / "runner.vdif")
        with vdif.open(path, "w", template=gen, bps=8,
                       samples_per_frame=2000) as wh:
            gen.seek(0)
            wh.write(np.asarray(gen.read(40000)) * 0.2)
        rh = vdif.open(path, sample_rate=u.Quantity(100, u.kHz))
        try:
            src = SetAttribute(rh, frequency=600 * u.MHz, sideband=1)
            tail = Square(Dedisperse(src, 0.05, samples_per_frame=4096))
            cp = CompiledPipeline(tail)
            n_blocks = 40000 // cp.block_samples
            batch = np.asarray(
                cp.run_blocks(cp.read_source_blocks(n_blocks)))
            out = np.asarray(StreamRunner(cp, prefetch=2).run(n_blocks))
            np.testing.assert_array_equal(out, batch)
        finally:
            rh.close()

    def test_reader_errors_propagate(self):
        from baseband_tasks_tpu import Channelize, NoiseGenerator, Square
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.models.runner import StreamRunner
        from baseband_tasks_tpu.utils import Time

        src = NoiseGenerator(shape=(4096,),
                             start_time=Time("2020-01-01T00:00:00.0"),
                             sample_rate=1 * u.MHz,
                             samples_per_frame=1024, seed=2)
        cp = CompiledPipeline(Square(Channelize(src, 64)))
        runner = StreamRunner(cp)
        with pytest.raises(EOFError):
            runner.run(10_000)  # far beyond the stream

    def test_absorbed_reduction_applied(self):
        """A graph built from a Fold tail must stream the reduction too
        (sums/counts identical to the batch run_fn), not silently return
        the pre-fold stream."""
        from baseband_tasks_tpu import (Channelize, Fold, NoiseGenerator,
                                        Square)
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.models.runner import StreamRunner
        from baseband_tasks_tpu.utils import Time

        t0 = Time("2020-01-01T00:00:00.0")
        src = NoiseGenerator(shape=(16384,), start_time=t0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=2048, seed=13)
        f0 = 123.456
        tail = Fold(Square(Channelize(src, 16)), 8,
                    lambda t: u.Quantity((t - t0).sec * f0, u.cycle),
                    samples_per_frame=1)
        cp = CompiledPipeline(tail)
        n_blocks = (16384 // 16) // cp.tail_block
        sums_b, counts_b = cp.run_fn(n_blocks)(
            cp.read_source_blocks(n_blocks))
        sums_s, counts_s = StreamRunner(cp).run(n_blocks)
        np.testing.assert_array_equal(np.asarray(counts_s),
                                      np.asarray(counts_b))
        np.testing.assert_allclose(np.asarray(sums_s), np.asarray(sums_b),
                                   rtol=1e-6, atol=1e-6)

    def test_getslice_offset_applied(self):
        """A compiled GetSlice shifts where the reader starts."""
        from baseband_tasks_tpu import Channelize, NoiseGenerator, Square
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.models.runner import StreamRunner
        from baseband_tasks_tpu.shaping import GetSlice
        from baseband_tasks_tpu.utils import Time

        src = NoiseGenerator(shape=(8192,),
                             start_time=Time("2020-01-01T00:00:00.0"),
                             sample_rate=1 * u.MHz,
                             samples_per_frame=1024, seed=4)
        tail = Square(Channelize(GetSlice(src, slice(128, None)), 64))
        cp = CompiledPipeline(tail)
        out = np.asarray(StreamRunner(cp).run(3))
        tail.seek(0)
        eager = np.asarray(tail.read(len(out)))
        np.testing.assert_allclose(out, eager, rtol=1e-5, atol=1e-5)


class TestStokesDetection:
    """detect='stokes' folds [XX, YY, Re(XY*), Im(XY*)] per channel
    (reference functions.py:132-143 semantics inside the fused step)."""

    KW = dict(n_chan=8, n_pol=2, dm=1.0, freq_center=600 * u.MHz,
              chan_rate=250 * u.kHz, period_samples=(800, 1),
              n_phase=16, block_samples=1024)

    def _input(self, pipe, seed=7):
        rng = np.random.default_rng(seed)
        return jnp.asarray(rng.standard_normal(
            (pipe.global_block, 8, 2, 2)).astype(np.float32))

    def test_xla_stokes_consistent_with_power(self):
        mesh = make_mesh(time=1, chan=1)
        pw = WidebandPulsarPipeline(mesh=mesh, **self.KW)
        st = WidebandPulsarPipeline(mesh=mesh, detect="stokes", **self.KW)
        xf = self._input(pw)
        p_pow, c_pow = pw.step_fn()(xf, jnp.float32(0))
        p_st, c_st = st.step_fn()(xf, jnp.float32(0))
        assert np.asarray(p_st).shape == (16, 8, 4)
        np.testing.assert_array_equal(np.asarray(c_pow), np.asarray(c_st))
        # XX + YY == total power
        np.testing.assert_allclose(
            np.asarray(p_st)[..., 0] + np.asarray(p_st)[..., 1],
            np.asarray(p_pow).sum(-1), rtol=1e-5, atol=1e-4)
        # cross terms bounded by the Cauchy-Schwarz power product
        cross2 = np.asarray(p_st)[..., 2:].astype(np.float64)
        assert np.all(np.square(cross2).sum(-1) <=
                      (np.asarray(p_st)[..., 0].astype(np.float64)
                       * np.asarray(p_st)[..., 1] * (1 + 1e-5)))

    def test_packed_stokes_matches_float(self):
        mesh = make_mesh(time=1, chan=1)
        pipe = WidebandPulsarPipeline(mesh=mesh, detect="stokes",
                                      **self.KW)
        wr, wi, xf = _words_and_floats(pipe, 8, seed=5)
        pr, cr = pipe.step_fn()(xf, jnp.float32(0))
        pp, cp = pipe.packed_step_fn(8)(wr, wi, jnp.float32(0))
        np.testing.assert_array_equal(np.asarray(cr), np.asarray(cp))
        np.testing.assert_allclose(np.asarray(pp), np.asarray(pr),
                                   rtol=1e-5, atol=1e-4)

    def test_run_loop_stokes_matches_step(self):
        """The run_fn loop with Stokes detection: shapes, counts, and
        the Cauchy-Schwarz bound on the cross terms."""
        mesh = make_mesh(time=1, chan=1)
        pal = WidebandPulsarPipeline(mesh=mesh, detect="stokes",
                                     **self.KW)
        run = pal.run_fn(2)
        prof, cnt = run(3)
        prof, cnt = np.asarray(prof), np.asarray(cnt)
        assert prof.shape == (16, 8, 4)
        assert cnt.sum() == 2 * pal.global_block
        # XX, YY nonnegative; cross bounded
        assert (prof[..., :2] >= 0).all()
        assert np.all(np.square(prof[..., 2:].astype(np.float64)).sum(-1)
                      <= prof[..., 0].astype(np.float64) * prof[..., 1]
                      * (1 + 1e-5))

    def test_stokes_requires_dual_pol(self):
        with pytest.raises(ValueError, match="dual polarization"):
            WidebandPulsarPipeline(mesh=make_mesh(time=1, chan=1),
                                   n_chan=8, n_pol=4, detect="stokes",
                                   freq_center=600 * u.MHz,
                                   chan_rate=250 * u.kHz,
                                   period_samples=(800, 1), n_phase=8,
                                   block_samples=1024)

    def test_precision_bins_stokes(self):
        """step_bins_fn honors detect='stokes' too."""
        mesh = make_mesh(time=1, chan=1)
        pal = WidebandPulsarPipeline(mesh=mesh, detect="stokes",
                                     **self.KW)
        xf = self._input(pal, seed=9)
        bins = jnp.asarray(
            (np.arange(pal.global_block) % 16).astype(np.float32))
        prof, cnt = pal.step_bins_fn()(xf, bins)
        assert np.asarray(prof).shape == (16, 8, 4)
        st = np.asarray(prof)
        assert np.all(np.square(st[..., 2:].astype(np.float64)).sum(-1)
                      <= st[..., 0].astype(np.float64) * st[..., 1]
                      * (1 + 1e-5))


class TestStreamRunnerPlanes:
    """StreamRunner(planes=True): blocks ship as two f32 planes, the
    planes-interchange step runs, and outputs return as a plane pair.
    Must match the complex-interchange runner."""

    def _cp(self):
        from baseband_tasks_tpu import (Dechannelize, Dedisperse,
                                        NoiseGenerator, SetAttribute)
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.utils import Time
        T0 = Time("2020-01-01T00:00:00.0")
        n_chan = 8
        freq = (400 + (np.arange(n_chan) - 4) * 0.25) * u.MHz
        src = SetAttribute(
            NoiseGenerator(shape=(1 << 14, n_chan), start_time=T0,
                           sample_rate=250 * u.kHz,
                           samples_per_frame=2048, seed=17),
            frequency=freq, sideband=1)
        return CompiledPipeline(Dechannelize(Dedisperse(
            src, 5.0, samples_per_frame=1024)))

    def test_matches_complex_runner(self):
        from baseband_tasks_tpu.models.runner import StreamRunner
        ref = np.asarray(StreamRunner(self._cp()).run(3))
        yr, yi = StreamRunner(self._cp(), planes=True).run(3)
        got = np.asarray(yr) + 1j * np.asarray(yi)
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    def test_real_tail(self):
        from baseband_tasks_tpu import Channelize, NoiseGenerator, Square
        from baseband_tasks_tpu.models.compiled import CompiledPipeline
        from baseband_tasks_tpu.models.runner import StreamRunner
        from baseband_tasks_tpu.utils import Time
        src = NoiseGenerator(shape=(1 << 13,),
                             start_time=Time("2020-01-01T00:00:00.0"),
                             sample_rate=1 * u.MHz,
                             samples_per_frame=2048,
                             dtype=np.complex64, seed=18)
        cp = CompiledPipeline(Square(Channelize(src, 64)))
        ref = np.asarray(StreamRunner(cp).run(2))
        yr, yi = StreamRunner(cp, planes=True).run(2)
        assert yi is None
        np.testing.assert_allclose(np.asarray(yr), ref,
                                   rtol=1e-5, atol=1e-6)
