"""Packed payloads from file readers to the device (VERDICT round-3
item 2).

The reader ships raw payload words (uint32); the decode runs inside the
compiled step (ops/unpack_device.py), bit-exact against the host LUT
path — the reference's decode-inside-the-pipeline design (reference
io/hdf5/payload.py:164-178) on the device.
"""

import numpy as np
import pytest

import jax

from baseband_tasks_tpu import Channelize, Integrate, Square
from baseband_tasks_tpu import NoiseGenerator
from baseband_tasks_tpu.io import vdif
from baseband_tasks_tpu.models.compiled import CompiledPipeline
from baseband_tasks_tpu.models.runner import StreamRunner
from baseband_tasks_tpu.utils import Time, units as u

START = Time("2018-06-15T07:00:00.000000000")
RATE = u.Quantity(1 << 20, u.Hz)


def write_vdif(tmp_path, bps, shape=(32768, 2), dtype=np.complex64,
               scale=16):
    sh = NoiseGenerator(shape=shape, start_time=START, sample_rate=RATE,
                        samples_per_frame=8192, dtype=dtype, seed=23)
    data = np.asarray(sh.read()) * scale
    path = str(tmp_path / f"p{bps}.vdif")
    with vdif.open(path, "w", template=sh, bps=bps) as fw:
        fw.write(data)
    return path


class TestPackedDecodeBitExact:
    @pytest.mark.parametrize("bps", [2, 4, 8, 16])
    def test_dual_pol_complex(self, tmp_path, bps):
        path = write_vdif(tmp_path, bps,
                          scale={8: 16, 4: 2, 2: 1, 16: 1000}[bps])
        with vdif.open(path, sample_rate=RATE) as fr:
            spf = fr.packed_alignment
            n = 4 * spf
            fr.seek(0)
            host = np.asarray(fr.read(n))
            packed = fr.read_packed(0, n)
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(packed))
        assert dev.dtype == host.dtype
        np.testing.assert_array_equal(dev, host)

    def test_real_single_channel(self, tmp_path):
        path = write_vdif(tmp_path, 8, shape=(16384,), dtype=np.float32)
        with vdif.open(path, sample_rate=RATE) as fr:
            host = np.asarray(fr.read(fr.shape[0]))
            packed = fr.read_packed(0, fr.shape[0])
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(packed))
        np.testing.assert_array_equal(dev, host)

    def test_offset_reads(self, tmp_path):
        path = write_vdif(tmp_path, 8)
        with vdif.open(path, sample_rate=RATE) as fr:
            spf = fr.packed_alignment
            fr.seek(2 * spf)
            host = np.asarray(fr.read(2 * spf))
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(
                fr.read_packed(2 * spf, 2 * spf)))
        np.testing.assert_array_equal(dev, host)

    def test_missing_frame_zero_filled(self, tmp_path):
        path = write_vdif(tmp_path, 8)
        with vdif.open(path, sample_rate=RATE) as fr:
            spf = fr.packed_alignment
            # simulate a dropped frame: both paths consult _frame_locs
            del fr._frame_locs[(1, 0)]
            fr.seek(0)
            host = np.asarray(fr.read(3 * spf))
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(
                fr.read_packed(0, 3 * spf)))
        assert np.all(host[spf:2 * spf, 0] == 0)  # (time, thread) shape
        np.testing.assert_array_equal(dev, host)

    def test_unaligned_read_rejected(self, tmp_path):
        path = write_vdif(tmp_path, 8)
        with vdif.open(path, sample_rate=RATE) as fr:
            with pytest.raises(ValueError, match="frame-aligned"):
                fr.read_packed(100, fr.packed_alignment)

    def test_transfer_byte_ratio(self, tmp_path):
        """The whole point: an 8-bit complex block crosses the boundary
        at ~1/4 the bytes of its complex64 representation."""
        path = write_vdif(tmp_path, 8)
        with vdif.open(path, sample_rate=RATE) as fr:
            n = 4 * fr.packed_alignment
            carrier, mask = fr.read_packed(0, n)
            f32_bytes = n * int(np.prod(fr.sample_shape)) * 8  # c64
            packed_bytes = carrier.nbytes + mask.nbytes
        assert packed_bytes * 3 < f32_bytes  # ~4x less, mask slack


class TestPackedCompiled:
    def _chain(self, path):
        fr = vdif.open(path, sample_rate=RATE)
        return fr, Integrate(Square(Channelize(fr, 64)), 16)

    @pytest.mark.parametrize("bps", [2, 8])
    def test_pipeline_equals_float_path(self, tmp_path, bps):
        path = write_vdif(tmp_path, bps, scale=16 if bps == 8 else 1)
        fr, tail = self._chain(path)
        cpf = CompiledPipeline(tail, block_samples=8192)
        cpp = CompiledPipeline(tail, block_samples=8192, packed=True)
        assert cpp._decoders[0] is not None
        n_blocks = 4
        ref = cpf.run_reduced(cpf.read_source_blocks(n_blocks))
        got = cpp.run_reduced(cpp.read_source_blocks(n_blocks))
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(ref[1]))
        fr.close()

    def test_streamrunner_packed(self, tmp_path):
        path = write_vdif(tmp_path, 8)
        fr, tail = self._chain(path)
        cpf = CompiledPipeline(tail, block_samples=8192)
        cpp = CompiledPipeline(tail, block_samples=8192, packed=True)
        ref = StreamRunner(cpf).run(4)
        got = StreamRunner(cpp).run(4)
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(ref[0]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(got[1]),
                                      np.asarray(ref[1]))
        fr.close()

    def test_packed_requires_capability(self):
        sh = NoiseGenerator(shape=(16384,), start_time=START,
                            sample_rate=RATE, samples_per_frame=4096,
                            dtype=np.complex64, seed=5)
        with pytest.raises(ValueError, match="no source supports"):
            CompiledPipeline(Square(Channelize(sh, 64)), packed=True)

    def test_misaligned_block_rejected(self, tmp_path):
        path = write_vdif(tmp_path, 8)
        fr = vdif.open(path, sample_rate=RATE)
        tail = Square(Channelize(fr, 64))
        with pytest.raises(ValueError, match="frame-aligned"):
            # 1536 is a legal block for the chain (24 channelizer
            # groups) but not a multiple of the file's 1024-sample frame
            CompiledPipeline(tail, block_samples=1536, packed=True)
        fr.close()


class TestMark5BPacked:
    @pytest.mark.parametrize("bps", [1, 2, 4, 8])
    def test_bit_exact(self, tmp_path, bps):
        from baseband_tasks_tpu.io import mark5b
        # 10 MHz divides every frame size 80000/(bps*nchan)
        rate = u.Quantity(10_000_000, u.Hz)
        nchan = 4
        sh = NoiseGenerator(shape=(40000, nchan), start_time=START,
                            sample_rate=rate, samples_per_frame=10000,
                            dtype=np.float32, seed=7)
        data = np.asarray(sh.read()) * (16 if bps == 8 else
                                        2 if bps == 4 else 1)
        path = str(tmp_path / f"m{bps}.m5b")
        with mark5b.open(path, "w", template=sh, bps=bps) as fw:
            fw.write(data)
        with mark5b.open(path, nchan=nchan, bps=bps, ref_time=START,
                         sample_rate=rate) as fr:
            spf = fr.packed_alignment
            n = (fr.shape[0] // spf) * spf
            host = np.asarray(fr.read(n))
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(
                fr.read_packed(0, n)))
        np.testing.assert_array_equal(dev, host)

    def test_dropped_frame(self, tmp_path):
        from baseband_tasks_tpu.io import mark5b
        rate = u.Quantity(10_000_000, u.Hz)
        sh = NoiseGenerator(shape=(40000, 4), start_time=START,
                            sample_rate=rate, samples_per_frame=10000,
                            dtype=np.float32, seed=7)
        data = np.asarray(sh.read()) * 16
        path = str(tmp_path / "drop.m5b")
        with mark5b.open(path, "w", template=sh, bps=8) as fw:
            fw.write(data)
        with mark5b.open(path, nchan=4, bps=8, ref_time=START,
                         sample_rate=rate) as fr:
            spf = fr.packed_alignment
            del fr._frame_locs[1]
            host = np.asarray(fr.read(3 * spf))
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(
                fr.read_packed(0, 3 * spf)))
        assert np.all(host[spf:2 * spf] == 0)
        np.testing.assert_array_equal(dev, host)


class TestDADAPacked:
    @pytest.mark.parametrize("nbit", [8, 32])
    def test_bit_exact_complex(self, tmp_path, nbit):
        from baseband_tasks_tpu.io import dada
        t0 = Time("2020-01-01T12:34:56.0")
        sh = NoiseGenerator(shape=(4000, 2), start_time=t0,
                            sample_rate=u.Quantity(100, u.kHz),
                            samples_per_frame=1000, seed=9,
                            dtype=np.complex64)
        data = np.asarray(sh.read()) * (10.0 if nbit == 8 else 1.0)
        path = str(tmp_path / f"d{nbit}.dada")
        with dada.open(path, "w", template=sh, nbit=nbit) as wh:
            wh.write(data)
        rh = dada.open(path)
        host = np.asarray(rh.read(4000))
        dev = np.asarray(jax.jit(rh.packed_decode_fn())(
            rh.read_packed(0, 4000)))
        rh.close()
        assert dev.dtype == host.dtype
        np.testing.assert_array_equal(dev, host)

    def test_offset_read(self, tmp_path):
        from baseband_tasks_tpu.io import dada
        t0 = Time("2020-01-01T12:34:56.0")
        sh = NoiseGenerator(shape=(4000, 2), start_time=t0,
                            sample_rate=u.Quantity(100, u.kHz),
                            samples_per_frame=1000, seed=9,
                            dtype=np.complex64)
        data = np.asarray(sh.read()) * 10.0
        path = str(tmp_path / "off.dada")
        with dada.open(path, "w", template=sh, nbit=8) as wh:
            wh.write(data)
        rh = dada.open(path)
        align = rh.packed_alignment
        off = 10 * align
        rh.seek(off)
        host = np.asarray(rh.read(20 * align))
        dev = np.asarray(jax.jit(rh.packed_decode_fn())(
            rh.read_packed(off, 20 * align)))
        rh.close()
        np.testing.assert_array_equal(dev, host)


class TestGUPPIPacked:
    def test_bit_exact(self, tmp_path):
        from baseband_tasks_tpu import SetAttribute
        from baseband_tasks_tpu.io import guppi
        t0 = Time("2021-06-01T10:00:00.0")
        src = SetAttribute(
            NoiseGenerator(shape=(8192, 4, 2), start_time=t0,
                           sample_rate=u.Quantity(3, u.MHz),
                           samples_per_frame=2048, seed=5),
            frequency=(1500 + np.arange(4)[:, None] * 3) * u.MHz,
            sideband=1)
        data = np.asarray(src.read(8192)) * 0.2
        path = str(tmp_path / "g.raw")
        with guppi.open(path, "w", template=src,
                        samples_per_block=2048) as wh:
            wh.write(data)
        rh = guppi.open(path)
        step = rh.packed_alignment
        n = 3 * step
        rh.seek(step)
        host = np.asarray(rh.read(n))
        dev = np.asarray(jax.jit(rh.packed_decode_fn())(
            rh.read_packed(step, n)))
        rh.close()
        assert dev.dtype == host.dtype
        np.testing.assert_array_equal(dev, host)

    def test_beyond_blocks_rejected(self, tmp_path):
        from baseband_tasks_tpu import SetAttribute
        from baseband_tasks_tpu.io import guppi
        t0 = Time("2021-06-01T10:00:00.0")
        src = SetAttribute(
            NoiseGenerator(shape=(8192, 4, 2), start_time=t0,
                           sample_rate=u.Quantity(3, u.MHz),
                           samples_per_frame=2048, seed=5),
            frequency=(1500 + np.arange(4)[:, None] * 3) * u.MHz,
            sideband=1)
        data = np.asarray(src.read(8192)) * 0.2
        path = str(tmp_path / "g2.raw")
        with guppi.open(path, "w", template=src,
                        samples_per_block=2048) as wh:
            wh.write(data)
        rh = guppi.open(path)
        step = rh.packed_alignment
        with pytest.raises(ValueError, match="whole raw blocks"):
            rh.read_packed(0, (len(rh._blocks) + 1) * step)
        rh.close()


class TestHDF5Packed:
    """Packed ingest of the HDF5 container's bit-packed payloads — the
    reference's own bps-encoded format (reference io/hdf5/payload.py:
    164-178), decoded inside the compiled step."""

    def write_h5(self, tmp_path, bps, shape=(8192, 4), invalid=False):
        pytest.importorskip("h5py")
        from baseband_tasks_tpu.io import hdf5
        sh = NoiseGenerator(shape=shape, start_time=START,
                            sample_rate=RATE, samples_per_frame=2048,
                            dtype=np.complex64, seed=31)
        data = np.asarray(sh.read())
        path = str(tmp_path / f"h{bps}.h5")
        with hdf5.open(path, "w", template=sh, bps=bps) as fw:
            fw.write(data[:2048])
            fw.write(data[2048:4096], valid=not invalid)
            fw.write(data[4096:])
        return path

    @pytest.mark.parametrize("bps", [2, 4, 8])
    def test_bit_exact(self, tmp_path, bps):
        from baseband_tasks_tpu.io import hdf5
        path = self.write_h5(tmp_path, bps)
        with hdf5.open(path) as fr:
            n = fr.shape[0]
            assert n % fr.packed_alignment == 0
            host = np.asarray(fr.read(n))
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(
                fr.read_packed(0, n)))
        assert dev.dtype == host.dtype
        np.testing.assert_array_equal(dev, host)

    def test_invalid_range_masked(self, tmp_path):
        from baseband_tasks_tpu.io import hdf5
        path = self.write_h5(tmp_path, 8, invalid=True)
        with hdf5.open(path) as fr:
            host = np.asarray(fr.read(fr.shape[0]))
            packed = fr.read_packed(0, fr.shape[0])
            assert len(packed) == 2  # carrier + per-sample mask plane
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(packed))
        assert np.all(host[2048:4096] == 0)
        np.testing.assert_array_equal(dev, host)

    def test_unaligned_rejected(self, tmp_path):
        from baseband_tasks_tpu.io import hdf5
        # single real channel at 2 bit: 16 samples per carrier word
        pytest.importorskip("h5py")
        sh = NoiseGenerator(shape=(4096,), start_time=START,
                            sample_rate=RATE, samples_per_frame=1024,
                            dtype=np.float32, seed=32)
        path = str(tmp_path / "h1.h5")
        with hdf5.open(path, "w", template=sh, bps=2) as fw:
            fw.write(np.asarray(sh.read()))
        with hdf5.open(path) as fr:
            assert fr.packed_alignment == 16
            with pytest.raises(ValueError, match="aligned"):
                fr.read_packed(8, 16)

    def test_raw_encoding_rejected(self, tmp_path):
        from baseband_tasks_tpu.io import hdf5
        pytest.importorskip("h5py")
        sh = NoiseGenerator(shape=(1024, 2), start_time=START,
                            sample_rate=RATE, samples_per_frame=512,
                            dtype=np.complex64, seed=33)
        path = str(tmp_path / "hraw.h5")
        with hdf5.open(path, "w", template=sh) as fw:
            fw.write(np.asarray(sh.read()))
        with hdf5.open(path) as fr:
            with pytest.raises(ValueError, match="bit-packed"):
                fr.read_packed(0, 512)

    def test_compiled_pipeline_packed(self, tmp_path):
        from baseband_tasks_tpu.io import hdf5
        path = self.write_h5(tmp_path, 8)
        with hdf5.open(path) as fr:
            tail = Integrate(Square(Channelize(fr, 64)), 8)
            cpf = CompiledPipeline(tail, block_samples=2048)
            cpp = CompiledPipeline(tail, block_samples=2048, packed=True)
            assert cpp._decoders[0] is not None
            ref = cpf.run_reduced(cpf.read_source_blocks(4))
            got = cpp.run_reduced(cpp.read_source_blocks(4))
            np.testing.assert_allclose(np.asarray(got[0]),
                                       np.asarray(ref[0]),
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(np.asarray(got[1]),
                                          np.asarray(ref[1]))
