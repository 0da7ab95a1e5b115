"""On-device bit-unpack (ops/unpack_device.py) vs the host C decoder.

The device decode must be bit-identical to native/unpack.c for every
possible input byte.  Packed payloads are uint32 words; float32
carriers holding the same bit pattern are still accepted and must
survive jit exactly, including patterns whose float32 reading is
NaN/Inf.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from baseband_tasks_tpu import native
from baseband_tasks_tpu.ops.unpack_device import (
    VDIF_2BIT_LEVELS, f32_payload_device, pack_bytes, pack_time_words,
    unpack_1bit_device, unpack_2bit_device, unpack_4bit_device,
    unpack_8bit_device, unpack_time_words, words)


def pack_bytes_to_f32(raw):
    """The same words viewed as float32 carriers."""
    return pack_bytes(raw).view(np.float32)


def all_bytes():
    """Every byte value in every lane position, plus random payloads."""
    rng = np.random.default_rng(42)
    seq = np.arange(256, dtype=np.uint8)
    return np.concatenate([
        seq, seq[::-1], np.repeat(seq, 4)[:1024],
        rng.integers(0, 256, 4096, dtype=np.uint8)])


class TestCarrier:
    @pytest.mark.parametrize("carrier", [pack_bytes, pack_bytes_to_f32])
    def test_roundtrip_bits(self, carrier):
        raw = all_bytes()
        w = np.asarray(jax.jit(words)(carrier(raw)))
        assert w.dtype == np.uint32
        np.testing.assert_array_equal(w.view(np.uint8)[:raw.size], raw)

    def test_nan_payload_survives(self):
        # bytes forming sNaN/qNaN/Inf float32 patterns
        raw = np.array([1, 0, 128, 127,     # 0x7F800001 sNaN
                        0, 0, 192, 127,     # 0x7FC00000 qNaN
                        0, 0, 128, 255],    # 0xFF800000 -Inf
                       dtype=np.uint8)
        xf = pack_bytes_to_f32(raw)
        w = np.asarray(jax.jit(words)(xf))
        np.testing.assert_array_equal(w.view(np.uint8), raw)

    def test_padding(self):
        w = pack_bytes(np.array([1, 2, 3, 4, 5], np.uint8))
        assert w.dtype == np.uint32 and w.size == 2  # padded to 8 bytes

    def test_f32_payload_bitcast(self):
        """32-bit float payloads reinterpret the words bit for bit."""
        x = np.array([1.5, -2.25, np.inf, 3e-40], np.float32)
        got = np.asarray(jax.jit(f32_payload_device)(x.view(np.uint32)))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      x.view(np.uint32))


class TestAgainstHostDecoder:
    def test_8bit(self):
        raw = all_bytes()
        host = native.unpack_8bit(raw)
        dev = np.asarray(jax.jit(unpack_8bit_device)(
            pack_bytes_to_f32(raw)))[:raw.size]
        np.testing.assert_array_equal(dev, host)

    def test_4bit(self):
        raw = all_bytes()
        host = native.unpack_4bit(raw)
        dev = np.asarray(jax.jit(unpack_4bit_device)(
            pack_bytes_to_f32(raw)))[:raw.size * 2]
        np.testing.assert_array_equal(dev, host)

    def test_2bit(self):
        raw = all_bytes()
        host = native.unpack_2bit(raw, VDIF_2BIT_LEVELS)
        dev = np.asarray(jax.jit(unpack_2bit_device)(
            pack_bytes_to_f32(raw)))[:raw.size * 4]
        np.testing.assert_array_equal(dev, host)

    def test_2bit_custom_levels(self):
        raw = all_bytes()
        levels = np.array([-7.0, -2.0, 2.0, 7.0], np.float32)
        host = native.unpack_2bit(raw, levels)
        fn = jax.jit(lambda x: unpack_2bit_device(x, levels))
        dev = np.asarray(fn(pack_bytes_to_f32(raw)))[:raw.size * 4]
        np.testing.assert_array_equal(dev, host)

    def test_1bit(self):
        raw = np.array([0b10110001, 0xFF, 0x00, 0x55], np.uint8)
        dev = np.asarray(jax.jit(unpack_1bit_device)(
            pack_bytes_to_f32(raw)))[:32]
        bits = np.unpackbits(raw, bitorder="little").astype(np.float32)
        np.testing.assert_array_equal(dev, bits * 2 - 1)


class TestShapes:
    def test_batched_carrier(self):
        """Leading axes pass through; expansion is on the last axis."""
        rng = np.random.default_rng(3)
        raw = rng.integers(0, 256, (2, 3, 64), dtype=np.uint8)
        xf = np.stack([np.stack([pack_bytes_to_f32(raw[i, j])
                                 for j in range(3)])
                       for i in range(2)])
        out = np.asarray(jax.jit(unpack_8bit_device)(xf))
        assert out.shape == (2, 3, 64)
        host = native.unpack_8bit(raw.ravel()).reshape(2, 3, 64)
        np.testing.assert_array_equal(out, host)

    def test_decode_feeds_pipeline_dtype(self):
        x = pack_bytes_to_f32(all_bytes())
        out = jax.jit(lambda v: unpack_2bit_device(v) ** 2)(x)
        assert out.dtype == jnp.float32


class TestTimeWords:
    """The wideband pipeline's packed layout: ``32/bits`` time-
    consecutive samples per uint32 word, decoded inside the step."""

    @staticmethod
    def _host(c, bits):
        if bits == 2:
            return VDIF_2BIT_LEVELS[c]
        if bits == 1:
            return np.where(c == 0, -1.0, 1.0).astype(np.float32)
        return c.astype(np.float32) - (127.5 if bits == 8 else 7.5)

    @pytest.mark.parametrize("bits", [1, 2, 4, 8])
    def test_roundtrip_matches_host_decode(self, bits):
        rng = np.random.default_rng(bits)
        c = rng.integers(0, 1 << bits, (512, 4, 2))
        w = pack_time_words(c, bits)
        assert w.dtype == np.uint32 and w.shape == (512 * bits // 32, 4, 2)
        got = np.asarray(jax.jit(unpack_time_words,
                                 static_argnums=1)(w, bits))
        np.testing.assert_array_equal(got, self._host(c, bits))

    def test_8bit_matches_native(self):
        """Byte k of each word is sample 4w + k: the native decoder on
        the words' little-endian bytes reads the same time series."""
        rng = np.random.default_rng(0)
        w = rng.integers(0, 1 << 32, (64, 3), dtype=np.uint32)
        got = np.asarray(jax.jit(unpack_time_words,
                                 static_argnums=1)(w, 8))
        raw = np.moveaxis(w[..., None].view(np.uint8), -1, 1)
        host = native.unpack_8bit(raw.ravel()).reshape(256, 3)
        np.testing.assert_array_equal(got, host)

    @pytest.mark.parametrize("bad", ["length", "range", "bits"])
    def test_pack_validates(self, bad):
        c = np.zeros((16, 2), np.uint8)
        with pytest.raises(ValueError):
            if bad == "length":
                pack_time_words(c[:15], 8)
            elif bad == "range":
                pack_time_words(c + 4, 2)
            else:
                pack_time_words(c, 3)

    def test_packed_pipeline_matches_float_on_mesh(self):
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from baseband_tasks_tpu.models import WidebandPulsarPipeline
        from baseband_tasks_tpu.utils import units as u

        mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                    ("time", "chan"))
        pipe = WidebandPulsarPipeline(
            n_chan=8, n_pol=2, dm=0.5, freq_center=600 * u.MHz,
            chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
            block_samples=1024, mesh=mesh)
        T = pipe.global_block
        rng = np.random.default_rng(1)
        br = rng.integers(0, 256, (T, 8, 2), dtype=np.uint8)
        bi = rng.integers(0, 256, (T, 8, 2), dtype=np.uint8)
        xf = np.stack([(br.astype(np.float32) - 127.5) / 64.0,
                       (bi.astype(np.float32) - 127.5) / 64.0], axis=-1)
        sh = NamedSharding(mesh, P("time", "chan"))
        prof_ref, cnt_ref = pipe.step_fn()(jax.device_put(xf, sh),
                                           jnp.float32(0))
        prof_p, cnt_p = pipe.packed_step_fn(8)(
            jax.device_put(pack_time_words(br, 8), sh),
            jax.device_put(pack_time_words(bi, 8), sh), jnp.float32(0))
        np.testing.assert_array_equal(np.asarray(cnt_ref),
                                      np.asarray(cnt_p))
        np.testing.assert_allclose(np.asarray(prof_ref),
                                   np.asarray(prof_p),
                                   rtol=1e-5, atol=1e-3)

    def test_run_fn_2bit_smoke(self):
        from jax.sharding import Mesh
        from baseband_tasks_tpu.models import WidebandPulsarPipeline
        from baseband_tasks_tpu.utils import units as u

        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("time", "chan"))
        pipe = WidebandPulsarPipeline(
            n_chan=8, n_pol=2, dm=0.1, freq_center=600 * u.MHz,
            chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
            block_samples=3584, mesh=mesh)
        run = pipe.run_fn(2, ingest_bits=2)
        prof, cnt = run(3)
        assert float(np.asarray(cnt).sum()) == 2 * pipe.global_block
        assert np.isfinite(np.asarray(prof)).all()

    def test_run_fn_bits_bound_at_creation(self):
        """A later run_fn with a different bit depth must not change the
        decode of a run closure created earlier (bits is bound into the
        step, not read off self at trace time)."""
        from jax.sharding import Mesh
        from baseband_tasks_tpu.models import WidebandPulsarPipeline
        from baseband_tasks_tpu.utils import units as u

        mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                    ("time", "chan"))

        def make():
            return WidebandPulsarPipeline(
                n_chan=8, n_pol=2, dm=0.1, freq_center=600 * u.MHz,
                chan_rate=250 * u.kHz, period_samples=(512, 1), n_phase=8,
                block_samples=3584, mesh=mesh)

        pipe = make()
        run2 = pipe.run_fn(1, ingest_bits=2)   # not yet traced
        pipe.run_fn(1, ingest_bits=8)          # must not poison run2
        prof, cnt = run2(5)
        ref_prof, ref_cnt = make().run_fn(1, ingest_bits=2)(5)
        np.testing.assert_array_equal(np.asarray(cnt), np.asarray(ref_cnt))
        np.testing.assert_allclose(np.asarray(prof), np.asarray(ref_prof),
                                   rtol=1e-6, atol=1e-6)
