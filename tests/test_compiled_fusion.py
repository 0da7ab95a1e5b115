"""Compiled overlap-save chains and the planes-interchange step.

The chains a compiled pipeline streams stage by stage:

* Disperse → Dechannelize
* PolyphaseFilterBank → InversePolyphaseFilterBank (forward FIR, channel
  DFT, inverse DFT, Wiener deconvolution)
* Convolve

These tests check that the compiled execution reproduces the eager
Stream computation, in both the complex-interchange and
planes-interchange steps, and that the time-sharded executor
(ShardedPipeline) computes the same blocks as the single-device one.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from baseband_tasks_tpu import (Dechannelize, Dedisperse,
                                InversePolyphaseFilterBank,
                                NoiseGenerator, PolyphaseFilterBank,
                                SetAttribute, sinc_hamming)
from baseband_tasks_tpu.models.compiled import CompiledPipeline
from baseband_tasks_tpu.models.sharded import ShardedPipeline
from baseband_tasks_tpu.parallel import make_mesh
from baseband_tasks_tpu.utils import Time, units as u

T0 = Time("2020-01-01T00:00:00.0")


def _chan_noise(seed, n_chan=8, n=1 << 14):
    freq = (400 + (np.arange(n_chan) - n_chan / 2) * 0.25) * u.MHz
    return SetAttribute(
        NoiseGenerator(shape=(n, n_chan), start_time=T0,
                       sample_rate=250 * u.kHz, samples_per_frame=2048,
                       seed=seed),
        frequency=freq, sideband=1)


def _run_compiled(cp, n_blocks, planes=False, stream_scale=None):
    blocks = cp.read_source_blocks(n_blocks)
    if planes:
        step_c, caches = cp.cached_planes_step()
        carry = cp.init_carry(planes=True)
        outs = []
        for k in range(n_blocks):
            x = np.asarray(blocks[k])
            pair = (jnp.asarray(x.real), jnp.asarray(x.imag)
                    if np.iscomplexobj(x) else None)
            carry, y = step_c(carry, pair, stream_scale, caches)
            yr, yi = y
            outs.append(np.asarray(yr) + (1j * np.asarray(yi)
                                          if yi is not None else 0))
        return np.concatenate(outs, axis=0)
    step_c, caches = cp.cached_step()
    carry = cp.init_carry()
    outs = []
    for k in range(n_blocks):
        carry, y = step_c(carry, blocks[k], caches)
        outs.append(np.asarray(y))
    return np.concatenate(outs, axis=0)


def _compare_sharded(cp, n_blocks=4, n_shards=2):
    """ShardedPipeline over a time mesh == the single-device run."""
    blocks = np.asarray(cp.read_source_blocks(n_blocks))
    ref = np.asarray(cp.run_blocks(blocks))
    got = np.asarray(ShardedPipeline(cp, make_mesh(time=n_shards))
                     .run_blocks(blocks))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def _compare_eager(got, cp, tail, rtol=1e-3, atol=2e-3):
    """Compiled sample k (k >= warmup) equals eager sample k - delay."""
    delay = int(cp.delay)
    tail.seek(0)
    eager = np.asarray(tail.read(got.shape[0] - delay))
    np.testing.assert_allclose(got[cp.warmup:],
                               eager[cp.warmup - delay:],
                               rtol=rtol, atol=atol)


class TestDisperseDechanFusion:
    def _make(self):
        src = _chan_noise(3)
        ded = Dedisperse(src, 5.0, samples_per_frame=1024)
        tail = Dechannelize(ded)
        return CompiledPipeline(tail), tail

    def test_fusion_applied(self):
        """The pair-fusion option is gone: every stage runs its own
        task, and ``fuse=`` is rejected."""
        cp, tail = self._make()
        assert [st.node for st in cp.stages] == [tail.ih.ih, tail.ih,
                                                 tail]
        with pytest.raises(TypeError):
            CompiledPipeline(tail, fuse=True)

    def test_matches_eager_exact(self):
        # spf dividing the pad makes streaming windows coincide with
        # eager frames -> agreement to float roundoff (module docstring)
        src = _chan_noise(4)
        with pytest.warns(Warning, match="efficiency"):
            ded = Dedisperse(src, 5.0, samples_per_frame=1)
        assert (ded.pad_start + ded.pad_end) % ded.samples_per_frame == 0
        tail = Dechannelize(ded)
        cp = CompiledPipeline(tail)
        # warmup spans delay = pad samples -> several blocks
        n_blocks = cp.warmup // cp.tail_block + 4
        got = _run_compiled(cp, n_blocks)
        _compare_eager(got, cp, tail, rtol=1e-4, atol=1e-4)

    def test_planes_matches_complex(self):
        cp, _ = self._make()
        a = _run_compiled(cp, 3, planes=False)
        b = _run_compiled(cp, 3, planes=True)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    def test_matches_unfused(self):
        _compare_sharded(self._make()[0])

    def test_stream_path_with_scale(self):
        """The in-kernel scale must multiply only the CURRENT block: a
        run with per-iteration scales must equal a run over pre-scaled
        inputs on EVERY block (the carry keeps its own iteration's
        scale — regression for the round-3 review finding where the
        whole window, carry included, was scaled)."""
        cp, _ = self._make()
        blocks = [np.asarray(b) for b in cp.read_source_blocks(3)]
        scales = [0.5, 2.0, 4.0]
        step_c, caches = cp.cached_planes_step()
        ca = cp.init_carry(planes=True)
        cb = cp.init_carry(planes=True)
        for x, s in zip(blocks, scales):
            ca, ya = step_c(ca, (jnp.asarray(x.real),
                                 jnp.asarray(x.imag)),
                            jnp.float32(s), caches)
            cb, yb = step_c(cb, (jnp.asarray(s * x.real),
                                 jnp.asarray(s * x.imag)), None, caches)
            np.testing.assert_allclose(np.asarray(ya[0]),
                                       np.asarray(yb[0]),
                                       rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(np.asarray(ya[1]),
                                       np.asarray(yb[1]),
                                       rtol=1e-4, atol=1e-5)


class TestDechanInvPFBFusion:
    def _make(self):
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        src = NoiseGenerator(shape=(1 << 16, 2), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=8192, seed=5)
        # 448-spectra frames in both stages, 16-spectra Wiener pads
        pfb = PolyphaseFilterBank(src, h, samples_per_frame=448)
        inv = InversePolyphaseFilterBank(
            pfb, h, sn=1e3, pad_start=16, pad_end=16,
            samples_per_frame=448, dtype=src.dtype)
        assert inv.samples_per_frame == 448 * n
        return CompiledPipeline(inv), inv

    def test_fusion_applied(self):
        """Unfused: the inverse PFB carries its overlap-save history in
        the dechannelized (sample) domain."""
        cp, inv = self._make()
        st = [st for st in cp.stages if st.node is inv][0]
        assert st.padded and st.pad == inv.pad_start + inv.pad_end
        assert st.in_sample_shape == inv.ih.sample_shape

    @pytest.mark.parametrize("planes", [False, True])
    def test_roundtrip_recovery(self, planes):
        """The compiled fused chain recovers the raw stream (same bar as
        the eager round-trip test)."""
        cp, inv = self._make()
        src = cp.source
        src.seek(0)
        raw = np.asarray(src.read(None))
        src.seek(0)
        n_blocks = 4
        got = _run_compiled(cp, n_blocks, planes=planes)
        # compiled sample k (past warmup) = eager sample k - delay;
        # eager sample j = raw[j + lead] with the start_time offset
        lead = int(round(float(((inv.start_time - T0).sec) * 1e6)))
        delay = int(cp.delay)
        k0 = cp.warmup
        expect = raw[lead + k0 - delay: lead + got.shape[0] - delay]
        err = (np.mean(np.abs(got[k0:] - expect) ** 2)
               / np.mean(np.abs(expect) ** 2))
        # 32-row pads at sn=1e3 leave ~6e-4 Wiener edge leakage — the
        # same level the eager windows show averaged over a full frame
        # (it decays ~16x per pad doubling; production sizings use
        # 128-row pads, cf. reference pfb.py:170-181)
        assert err < 1.5e-3

    def test_planes_matches_complex(self):
        cp, _ = self._make()
        a = _run_compiled(cp, 3, planes=False)
        b = _run_compiled(cp, 3, planes=True)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    def test_matches_unfused(self):
        _compare_sharded(self._make()[0])


class TestPFBForwardFusion:
    """_PolyphaseFIR → Channelize: the planes step (real-tap FIR on each
    plane, then the channel FFT) against the complex step (cuFFT), the
    sharded executor and the eager stream; scale semantics."""

    def _make(self):
        n, n_tap = 64, 8
        h = sinc_hamming(n_tap, n)
        src = NoiseGenerator(shape=(1 << 18, 2), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=8192, seed=7)
        pfb = PolyphaseFilterBank(src, h, samples_per_frame=448)
        return CompiledPipeline(pfb), pfb

    def test_fusion_applied(self):
        """The FIR and the channelizing DFT run as two stages."""
        from baseband_tasks_tpu.pfb import _PolyphaseFIR
        cp, pfb = self._make()
        assert [type(st.node) for st in cp.stages] == [_PolyphaseFIR,
                                                       type(pfb)]

    def test_planes_kernel_matches_complex(self):
        cp, _ = self._make()
        a = _run_compiled(cp, 3, planes=False)   # FFT channelizer
        b = _run_compiled(cp, 3, planes=True)    # planes interchange
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-3)

    def test_matches_unfused(self):
        _compare_sharded(self._make()[0])

    def test_matches_eager(self):
        cp, tail = self._make()
        n_blocks = cp.warmup // cp.tail_block + 3
        got = _run_compiled(cp, n_blocks, planes=True)
        _compare_eager(got, cp, tail)

    def test_stream_scale_block_only(self):
        """Per-iteration scale multiplies only the current block (the
        carry holds its own iteration's scale)."""
        cp, _ = self._make()
        blocks = [np.asarray(b) for b in cp.read_source_blocks(3)]
        scales = [0.5, 2.0, 4.0]
        step_c, caches = cp.cached_planes_step()
        ca = cp.init_carry(planes=True)
        cb = cp.init_carry(planes=True)
        for x, s in zip(blocks, scales):
            ca, ya = step_c(ca, (jnp.asarray(x.real),
                                 jnp.asarray(x.imag)),
                            jnp.float32(s), caches)
            cb, yb = step_c(cb, (jnp.asarray(s * x.real),
                                 jnp.asarray(s * x.imag)), None, caches)
            np.testing.assert_allclose(np.asarray(ya[0]),
                                       np.asarray(yb[0]),
                                       rtol=1e-4, atol=1e-3)
            np.testing.assert_allclose(np.asarray(ya[1]),
                                       np.asarray(yb[1]),
                                       rtol=1e-4, atol=1e-3)

    @staticmethod
    def _roundtrip():
        n, n_tap = 64, 8
        h = sinc_hamming(n_tap, n)
        src = NoiseGenerator(shape=(1 << 18, 2), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=8192, seed=9)
        pfb = PolyphaseFilterBank(src, h, samples_per_frame=416)
        inv = InversePolyphaseFilterBank(
            pfb, h, sn=1e3, pad_start=32, pad_end=32,
            samples_per_frame=416, dtype=src.dtype)
        return src, inv

    def test_quad_fusion_cancels_dft_pair(self):
        """PFB → inverse round trip: the planes step equals the complex
        step (cuFFT)."""
        _, inv = self._roundtrip()
        cp = CompiledPipeline(inv)
        a = _run_compiled(cp, 3, planes=False)
        b = _run_compiled(cp, 3, planes=True)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    def test_full_roundtrip_both_fusions(self):
        """PFB forward + Wiener inverse compiled recovers the raw stream
        (config-3 shape, small)."""
        src, inv = self._roundtrip()
        assert inv.samples_per_frame == 416 * 64
        cp = CompiledPipeline(inv)
        got = _run_compiled(cp, 4, planes=True)
        # it recovers the raw stream at this geometry's leakage
        # level (8-tap Wiener edges at 32-row pads, streaming windows
        # off the eager frame grid — production sizings use 128-row
        # pads, reference pfb.py:170-181)
        src.seek(0)
        raw = np.asarray(src.read(None))
        lead = int(round(float(((inv.start_time - T0).sec) * 1e6)))
        delay = int(cp.delay)
        k0 = cp.warmup
        expect = raw[lead + k0 - delay: lead + got.shape[0] - delay]
        err = (np.mean(np.abs(got[k0:] - expect) ** 2)
               / np.mean(np.abs(expect) ** 2))
        assert err < 1e-2


class TestConvolveStream:
    """Convolve in the planes-interchange step (complex recombination
    around the FFT overlap-save) must match the complex path and the
    eager stream."""

    def _make(self):
        rng = np.random.default_rng(8)
        r = (rng.standard_normal(33)
             + 1j * rng.standard_normal(33)).astype(np.complex64) * 0.2
        from baseband_tasks_tpu import Convolve
        src = NoiseGenerator(shape=(1 << 14, 8), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=4096,
                             dtype=np.complex64, seed=13)
        conv = Convolve(src, r, samples_per_frame=1024)
        return CompiledPipeline(conv), conv

    def test_planes_matches_complex(self):
        cp, _ = self._make()
        a = _run_compiled(cp, 3, planes=False)
        b = _run_compiled(cp, 3, planes=True)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)

    def test_matches_eager(self):
        # convolution responses are finite: pads fully contain them, so
        # streaming windows equal eager output exactly past warmup
        cp, conv = self._make()
        got = _run_compiled(cp, 3, planes=True)
        _compare_eager(got, cp, conv, rtol=1e-4, atol=1e-4)


class TestPlanesFallbacks:
    """planes_step must handle stages without planes support (complex
    recombination fallback) and real-valued streams (im=None pairs)."""

    def test_mixed_chain_with_fallback_node(self):
        from baseband_tasks_tpu import Channelize, Task

        def swap_sign(data):
            return -data

        src = NoiseGenerator(shape=(1 << 13,), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=2048,
                             dtype=np.complex64, seed=21)
        # Task has no task_planes -> recombine fallback mid-chain
        tail = Channelize(Task(src, swap_sign), 64)
        cp = CompiledPipeline(tail)
        a = _run_compiled(cp, 2, planes=False)
        b = _run_compiled(cp, 2, planes=True)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_real_stream_planes(self):
        from baseband_tasks_tpu import Channelize
        src = NoiseGenerator(shape=(1 << 13,), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=2048,
                             dtype=np.float32, seed=22)
        tail = Channelize(src, 64)   # real input -> rfft (fallback)
        cp = CompiledPipeline(tail)
        a = _run_compiled(cp, 2, planes=False)
        b = _run_compiled(cp, 2, planes=True)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def test_scale_applied_once_at_first_stage(self):
        from baseband_tasks_tpu import Channelize, Square
        src = NoiseGenerator(shape=(1 << 13,), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=2048,
                             dtype=np.complex64, seed=23)
        tail = Square(Channelize(src, 64))
        cp = CompiledPipeline(tail)
        step_c, caches = cp.cached_planes_step()
        x = np.asarray(cp.read_source_blocks(1)[0])
        pair = (jnp.asarray(x.real), jnp.asarray(x.imag))
        _, y1 = step_c(cp.init_carry(planes=True), pair,
                       jnp.float32(2.0), caches)
        _, y2 = step_c(cp.init_carry(planes=True),
                       (pair[0] * 2.0, pair[1] * 2.0), None, caches)
        np.testing.assert_allclose(np.asarray(y1[0]), np.asarray(y2[0]),
                                   rtol=1e-5, atol=1e-5)


class TestPadZeroStream:
    def test_single_tap_convolve_planes(self):
        """pad == 0 padded stages (single-tap response): the [-0:]
        carry slice must not return the whole block."""
        from baseband_tasks_tpu import Convolve
        src = NoiseGenerator(shape=(1 << 12, 8), start_time=T0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=1024,
                             dtype=np.complex64, seed=31)
        conv = Convolve(src, np.array([0.5 + 0.25j], np.complex64),
                        samples_per_frame=512)
        assert conv.pad_start + conv.pad_end == 0
        cp = CompiledPipeline(conv)
        a = _run_compiled(cp, 2, planes=False)
        b = _run_compiled(cp, 2, planes=True)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


class TestFusedRunFn:
    def test_scan_run_fn_matches_stepwise(self):
        """run_fn's lax.scan over a padded chain equals the manual
        step loop (the scan carries the same overlap-save state)."""
        src = _chan_noise(6)
        ded = Dedisperse(src, 5.0, samples_per_frame=1024)
        cp = CompiledPipeline(Dechannelize(ded))
        blocks = cp.read_source_blocks(3)
        via_scan = np.asarray(cp.run_fn(3)(blocks))
        via_steps = _run_compiled(cp, 3)
        np.testing.assert_allclose(via_scan, via_steps,
                                   rtol=1e-5, atol=1e-6)
