"""Smoke test of the main path on the GPU: dedisperse -> detect -> fold.

    python chip_smoke.py           # one GPU
    python chip_smoke.py --four    # the sharded path on four GPUs

One card runs the flagship deployment (64 channels x 250 kHz x 2
polarizations, DM 500, ~2^17-sample blocks, 64 phase bins, a drifting
polyco fold, from packed 8-bit samples) two ways, each compared with the
plain reference on the same input — the eager library chain on the numpy
FFT engine — against the repo's 60 dB SNR bar:

(a) ``WidebandPulsarPipeline.run_fn(ingest_bits=8)`` on a 1x1 mesh, the
    8-bit decode inside the jitted step;
(b) an 8-bit VDIF file read back as ``vdif.open`` -> ``SetAttribute`` ->
    ``Dedisperse`` -> ``Square`` -> ``Fold``, through ``.compile()`` and a
    packed-ingest ``StreamRunner`` pulling blocks from the file.

It also checks the on-device 8-bit decode bit for bit against the host
decoder.  ``--four`` instead runs the wideband pipeline at its 1024 x
4-pol, DM 500 shape on every (time, chan) factorization of four cards,
and a library chain through ``ShardedPipeline`` on a 4-card time ring,
each against the one-card result on the same input; the wideband
pipeline's edge channels also against the numpy-engine chain.

Every phase raises on failure; the script exits non-zero when JAX finds
no GPU.  The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import warnings
from dataclasses import dataclass, replace

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SNR_BAR_DB = 60.0


@dataclass(frozen=True)
class Shape:
    """One deployment shape and how long each phase runs."""
    n_chan: int = 64
    n_pol: int = 2
    dm: float = 500.0
    freq_mhz: float = 1400.0    # band centre; 250 kHz channels
    block: int = 1 << 17
    n_phase: int = 64
    n_iter: int = 64        # (a): pipeline steps per timed dispatch
    repeats: int = 3        # (a), --four: timed dispatches
    lib_blocks: int = 4     # (b): blocks the StreamRunner pulls
    max_file_spf: int = 1000    # (b): largest VDIF frame, in samples


FULL = Shape()
#: the four-card shape: the pipeline's own 1024 x 4-pol DM 500 layout,
#: with blocks long enough for its ~99k-sample overlap-save pads
FULL4 = Shape(n_chan=1024, n_pol=4, block=100_000, n_phase=64, repeats=10)


def snr_db(got, ref):
    """10 log10(mean|ref|^2 / mean|got - ref|^2) (tests/test_snr_bars)."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.mean(np.abs(got - ref) ** 2)
    sig = np.mean(np.abs(ref) ** 2)
    return float(10 * np.log10(sig / err)) if err > 0 else float("inf")


def check(name, got, ref, bar=SNR_BAR_DB):
    """Print the SNR and max error of ``got`` against ``ref``; raise
    when the SNR misses ``bar``."""
    s = snr_db(got, ref)
    err = float(np.max(np.abs(np.asarray(got, np.float64)
                              - np.asarray(ref, np.float64))))
    scale = float(np.max(np.abs(ref)))
    print(f"{name}: SNR {s:.1f} dB vs reference (bar {bar:.0f} dB), "
          f"max error {err:.3g} (max |ref| {scale:.3g})", flush=True)
    if not s >= bar:
        raise AssertionError(f"{name}: SNR {s:.1f} dB < {bar} dB")
    return s


def _t0():
    from baseband_tasks_tpu.utils import Time
    return Time.from_mjd(58000.0)


def _polyco():
    from bench import b1937_polyco
    return b1937_polyco()


def _ready(x):
    import jax
    return jax.block_until_ready(x)


@contextlib.contextmanager
def _numpy_reference():
    """The plain reference: the eager chain on the numpy FFT engine.
    Its frame-at-a-time reads are slow on purpose, so the one-time hint
    that suggests compiling them is silenced."""
    from baseband_tasks_tpu.base import PerformanceHint
    from baseband_tasks_tpu.fourier import fft_maker
    with warnings.catch_warnings(), fft_maker.set("numpy"):
        warnings.simplefilter("ignore", PerformanceHint)
        yield


def _rate_line(name, samples, seconds, shape):
    realtime = shape.n_chan * 250e3 * shape.n_pol
    rate = samples / seconds
    print(f"{name}: {rate:.4g} samples/s = {rate / realtime:.3g}x real "
          f"time ({samples} samples in {seconds:.4g} s)", flush=True)
    return rate


# -- the plain reference -------------------------------------------------
def eager_power(x, freqs, rate, dm, ref_freq, block):
    """|dedispersed x|^2 of an isolated (T, C, P) block, zero outside it,
    through the eager library chain on the numpy FFT engine (numpy FFTs
    in double precision), read in frames of ``block`` samples that start
    at the block's first sample.  Returns float64 (T, C, P)."""
    from baseband_tasks_tpu import (Dedisperse, SetAttribute, Square,
                                    StreamGenerator)

    T = x.shape[0]

    def chain(src):
        return Dedisperse(SetAttribute(src, frequency=freqs, sideband=1),
                          dm, reference_frequency=ref_freq,
                          samples_per_frame=block)

    with _numpy_reference():
        probe = chain(StreamGenerator(
            lambda sh: None, shape=(8 * T,) + x.shape[1:],
            start_time=_t0(), sample_rate=rate, samples_per_frame=block,
            dtype=np.complex128))
        # output sample 0 is input sample pad_start: the block's start
        data = np.zeros((probe.pad_start + T + probe.pad_end + block,)
                        + x.shape[1:], np.complex128)
        data[probe.pad_start:probe.pad_start + T] = x
        src = StreamGenerator(
            lambda sh: data[sh.tell():sh.tell() + block],
            shape=data.shape, start_time=_t0(), sample_rate=rate,
            samples_per_frame=block, dtype=np.complex128)
        return np.asarray(Square(chain(src)).read(T), np.float64)


def decode_words_host(w, bits=8):
    """Host decode of ``pack_time_words`` words with the native LUT
    decoder (8-bit: ``byte - 127.5``): (T*bits/32, ...) -> (T, ...)."""
    from baseband_tasks_tpu import native
    w = np.ascontiguousarray(np.asarray(w, np.uint32))
    raw = w[..., np.newaxis].view(np.uint8)        # (W, ..., 4) LE bytes
    raw = np.moveaxis(raw, -1, 1).reshape((-1,) + w.shape[1:])
    return native.unpack_8bit(raw.ravel()).reshape(raw.shape)


def wideband_reference(pipe, wr, wi, n_blocks):
    """Profile and counts that ``pipe.run_fn(n_blocks, ingest_bits=8)``
    must produce for the packed block ``(wr, wi)``: host decode, eager
    numpy-engine dedispersion of the zero-padded block, the run's
    per-iteration scale, and the pipeline's own fixed-point phase bins
    (ops/fold.fold_bins_ref)."""
    from baseband_tasks_tpu.ops.fold import fold_bins_ref
    from baseband_tasks_tpu.utils import units as u

    x = (decode_words_host(wr).astype(np.float64)
         + 1j * decode_words_host(wi)) / 64.0
    freqs = u.Quantity(pipe.freqs.to_value(u.MHz)[:, np.newaxis], u.MHz)
    power = eager_power(x, freqs, pipe.chan_rate, pipe.dm,
                        pipe.reference_frequency, pipe.block_samples)
    T = pipe.global_block
    table = pipe.fold_model.table(np.arange(n_blocks) * T, T)
    prof = np.zeros((pipe.n_phase,) + power.shape[1:])
    cnt = np.zeros(pipe.n_phase)
    off = np.float32(0)
    t = np.arange(T)
    for k in range(n_blocks):
        h = table[k].astype(np.int64)
        foldv = [(h[0] << 16) | h[1], (h[2] << 16) | h[3], 0]
        bins = fold_bins_ref(foldv, t, pipe.n_phase)
        scale = np.float64(np.float32(1) + np.float32(1e-6) * off)
        np.add.at(prof, bins, power * scale ** 2)
        cnt += np.bincount(bins, minlength=pipe.n_phase)
        off = np.float32(np.mod(off + np.float32(T),
                                np.float32(pipe._per_q)))
    return prof, cnt


# -- phases --------------------------------------------------------------
def phase_decode(shape=FULL, seed=5):
    """On-device 8-bit decode, bit for bit against the host decoder."""
    import jax
    from baseband_tasks_tpu.ops.unpack_device import unpack_time_words

    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 32, size=(shape.block // 4, shape.n_chan,
                                       shape.n_pol), dtype=np.uint32)
    dev = np.asarray(jax.jit(unpack_time_words, static_argnums=1)(w, 8))
    host = decode_words_host(w)
    if not np.array_equal(dev, host):
        raise AssertionError("8-bit device decode differs from the host "
                             "decoder")
    print(f"decode: 8-bit device decode bit-exact against "
          f"native.unpack_8bit ({host.size} samples)", flush=True)


def phase_main(shape=FULL, seed=1):
    """(a) the packed-8-bit ``run_fn`` on a 1x1 mesh: timed, then two
    full blocks against the reference."""
    from baseband_tasks_tpu.models import WidebandPulsarPipeline
    from baseband_tasks_tpu.utils import units as u

    pipe = WidebandPulsarPipeline(
        n_chan=shape.n_chan, n_pol=shape.n_pol, dm=shape.dm,
        freq_center=shape.freq_mhz * u.MHz, chan_rate=250 * u.kHz,
        period_samples=(160000, 3), n_phase=shape.n_phase,
        block_samples=shape.block, phase_model=_polyco(),
        start_time=_t0())
    run = pipe.run_fn(shape.n_iter, ingest_bits=8)
    t0 = time.perf_counter()
    _ready(run(seed))
    print(f"(a) compile + first run {time.perf_counter() - t0:.3g} s; "
          f"block {pipe.block_samples} samples, window {pipe._n_fft}",
          flush=True)
    t0 = time.perf_counter()
    for _ in range(shape.repeats):
        out = run(seed)
    _ready(out)
    dt = time.perf_counter() - t0
    n = shape.repeats * shape.n_iter * pipe.block_samples \
        * shape.n_chan * shape.n_pol
    rate = _rate_line("(a) run_fn, packed 8-bit", n, dt, shape)

    run2 = pipe.run_fn(2, ingest_bits=8)
    prof, cnt = (np.asarray(a) for a in _ready(run2(seed)))
    wr, wi = (np.asarray(a) for a in run2.inputs(seed))
    ref_prof, ref_cnt = wideband_reference(pipe, wr, wi, 2)
    if not np.array_equal(cnt, ref_cnt):
        raise AssertionError("(a) fold counts differ from the reference")
    check("(a) two-block profile", prof, ref_prof)
    return rate


def _library_block(shape, rate, freqs, dm, ref_freq):
    """(block, pad_margin, file_spf): a Dedisperse frame of 1 to 1.25
    times ``shape.block`` samples whose padded window is 2/3/5-smooth,
    and the largest VDIF frame (at most ``shape.max_file_spf`` samples,
    dividing the sample rate and the block, so packed reads stay
    frame-aligned)."""
    from baseband_tasks_tpu import Dedisperse, NoiseGenerator, SetAttribute
    from baseband_tasks_tpu.fourier import next_fast_len
    from baseband_tasks_tpu.utils import units as u

    probe = Dedisperse(SetAttribute(
        NoiseGenerator(shape=(8 * shape.block, shape.n_chan, shape.n_pol),
                       start_time=_t0(), sample_rate=rate,
                       samples_per_frame=shape.block),
        frequency=freqs, sideband=1), dm, reference_frequency=ref_freq,
        samples_per_frame=shape.block, pad_margin=0)
    pad0 = probe.pad_start + probe.pad_end
    hz = int(round(rate.to_value(u.Hz)))
    best = None
    for margin in range(256, 320):
        pad = pad0 + 2 * margin
        n = next_fast_len(shape.block + pad)
        while n - pad <= 1.25 * shape.block:
            block = n - pad
            spf = max(d for d in range(1, shape.max_file_spf + 1)
                      if hz % d == 0 and block % d == 0)
            if best is None or spf > best[2]:
                best = (block, margin, spf)
            n = next_fast_len(n + 1)
    return best


def _write_vdif(path, shape, n_samples, rate, file_spf, seed):
    """An 8-bit complex VDIF file of Gaussian noise, (chan, pol) as
    (channels, threads)."""
    from baseband_tasks_tpu import StreamGenerator
    from baseband_tasks_tpu.io import vdif

    template = StreamGenerator(
        lambda sh: None, shape=(n_samples, shape.n_chan, shape.n_pol),
        start_time=_t0(), sample_rate=rate, samples_per_frame=1,
        dtype=np.complex64)
    rng = np.random.default_rng(seed)
    chunk = 1 << 14
    with vdif.open(path, "w", template=template, bps=8,
                   samples_per_frame=file_spf) as fw:
        for start in range(0, n_samples, chunk):
            m = min(chunk, n_samples - start)
            z = rng.standard_normal((m, shape.n_chan, shape.n_pol, 2),
                                    dtype=np.float32) * 16
            fw.write(z[..., 0] + 1j * z[..., 1])


def phase_library(shape=FULL, seed=2):
    """(b) VDIF file -> SetAttribute -> Dedisperse -> Square -> Fold,
    compiled, against the eager numpy-engine chain on the same file."""
    import jax
    from baseband_tasks_tpu import Dedisperse, Fold, SetAttribute, Square
    from baseband_tasks_tpu.io import vdif
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.models.runner import StreamRunner
    from baseband_tasks_tpu.utils import units as u

    rate = 250 * u.kHz
    fc = shape.freq_mhz * u.MHz
    idx = np.arange(shape.n_chan) - shape.n_chan / 2 + 0.5
    freqs = u.Quantity((shape.freq_mhz + 0.25 * idx)[:, np.newaxis], u.MHz)
    block, margin, file_spf = _library_block(shape, rate, freqs, shape.dm,
                                             fc)
    polyco = _polyco()

    def chain(fh):
        ded = Dedisperse(SetAttribute(fh, frequency=freqs, sideband=1),
                         shape.dm, reference_frequency=fc,
                         samples_per_frame=block, pad_margin=margin)
        step = u.Quantity(block / rate.to_value(u.Hz), u.s)
        return Fold(Square(ded), shape.n_phase, polyco, step,
                    average=False)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flagship.vdif")
        t0 = time.perf_counter()
        _write_vdif(path, shape, (shape.lib_blocks + 1) * block, rate,
                    file_spf, seed)
        print(f"(b) wrote {os.path.getsize(path)} bytes of 8-bit VDIF "
              f"({file_spf}-sample frames) in "
              f"{time.perf_counter() - t0:.3g} s; block {block} samples",
              flush=True)

        with vdif.open(path, sample_rate=rate) as fr:
            n = 4 * file_spf
            dev = np.asarray(jax.jit(fr.packed_decode_fn())(
                fr.read_packed(0, n)))
            if not np.array_equal(dev, np.asarray(fr.read(n))):
                raise AssertionError("(b) VDIF packed decode differs from "
                                     "the host read")
        print("(b) VDIF 8-bit packed device decode bit-exact against the "
              "host read", flush=True)

        # the file side: packed payload words -> device decode -> chain
        with vdif.open(path, sample_rate=rate) as fr:
            runner = StreamRunner(CompiledPipeline(chain(fr), packed=True))
            t0 = time.perf_counter()
            _ready(runner.run(shape.lib_blocks))
            print(f"(b) compile + first run "
                  f"{time.perf_counter() - t0:.3g} s", flush=True)
            t0 = time.perf_counter()
            sums, counts = _ready(runner.run(shape.lib_blocks))
            dt = time.perf_counter() - t0
        rate_b = _rate_line(
            "(b) VDIF -> StreamRunner, packed 8-bit",
            shape.lib_blocks * block * shape.n_chan * shape.n_pol, dt,
            shape)
        sums, counts = np.asarray(sums), np.asarray(counts)

        # the read-compatible compiled view
        with vdif.open(path, sample_rate=rate) as fv:
            got = chain(fv).compile().read()

        with _numpy_reference(), vdif.open(path, sample_rate=rate) as fe:
            ref = chain(fe).read()

    if not np.array_equal(got["count"], ref["count"]):
        raise AssertionError("(b) .compile() fold counts differ")
    check("(b) .compile() fold", got["data"], ref["data"])
    # the runner's first bins include the zero-initialized overlap-save
    # warmup, which it drops; every bin it fully counts must match
    ref_cnt = ref["count"].reshape(ref["count"].shape[:2] + (-1,))[..., 0]
    k = min(sums.shape[0], ref_cnt.shape[0])
    full = np.all(counts[:k] == ref_cnt[:k], axis=1)
    if not full.any():
        raise AssertionError("(b) StreamRunner: no fully counted bin")
    check(f"(b) StreamRunner fold ({int(full.sum())} of {k} bins)",
          sums[:k][full], ref["data"][:k][full])
    return rate_b


def _one_card_profile(pipe, xf, chunk, device):
    """What the time x chan sharded ``pipe`` must fold for the global
    block ``xf``, evaluated on one device with no collectives: each time
    shard's overlap-save window is cut from the zero-extended block
    (neighbours' samples in place of the halo exchange), dedispersed
    with the same chirp and window length, folded with that shard's
    phase offset, and summed — channel chunk by channel chunk."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.ops.fold import fold_accumulate, fold_bins

    T, ps, pe = pipe.block_samples, pipe.pad_start, pipe.pad_end
    foldv = pipe._fixed_foldv(jnp.float32(0))

    @jax.jit
    def shard_profile(win, chirp, shard):
        y = jnp.fft.ifft(jnp.fft.fft(win, axis=0) * chirp, axis=0)
        power = pipe._detect(y[ps:ps + T])
        bins = fold_bins(pipe._shard_fold3(foldv, shard, T),
                         jnp.arange(T, dtype=jnp.int32), pipe.n_phase)
        return fold_accumulate(power, bins, pipe.n_phase)[0]

    profs = []
    for c0 in range(0, pipe.n_chan, chunk):
        x = jax.device_put(xf[:, c0:c0 + chunk], device)
        x = jnp.pad(jax.lax.complex(x[..., 0], x[..., 1]),
                    ((ps, pe),) + ((0, 0),) * (x.ndim - 2))
        c = jax.device_put(pipe._chirp_np[:, c0:c0 + chunk], device)
        prof = sum(shard_profile(x[s * T:s * T + ps + T + pe], c,
                                 jnp.int32(s))
                   for s in range(pipe.n_time_shards))
        profs.append(np.asarray(prof))
    return np.concatenate(profs, axis=1)


def _numpy_slice_profile(pipe, xf, chans):
    """The plain reference for channels ``chans`` of the fixed-period
    ``pipe``: the eager numpy-engine chain over its global block ``xf``
    (zero outside it), in frames aligned with the pipeline's time shards,
    folded on the pipeline's phase bins (ops/fold.fold_bins_ref)."""
    import jax.numpy as jnp
    from baseband_tasks_tpu.ops.fold import fold_bins_ref
    from baseband_tasks_tpu.utils import units as u

    x = np.asarray(jnp.take(xf, jnp.asarray(chans), axis=1), np.float64)
    x = x[..., 0] + 1j * x[..., 1]
    freqs = u.Quantity(pipe.freqs.to_value(u.MHz)[chans, np.newaxis],
                       u.MHz)
    power = eager_power(x, freqs, pipe.chan_rate, pipe.dm,
                        pipe.reference_frequency, pipe.block_samples)
    bins = fold_bins_ref([0, pipe._p_fx, 0], np.arange(len(x)),
                         pipe.n_phase)
    prof = np.zeros((pipe.n_phase,) + power.shape[1:])
    np.add.at(prof, bins, power)
    return prof


def phase_four_wideband(shape=FULL4, devices=None, chunk=128, seed=3):
    """The wideband pipeline on every (time, chan) factorization of four
    devices, each against the one-device evaluation of the same
    overlap-save windows on the same input (``_one_card_profile``), and
    its four lowest and four highest channels, where the dispersion
    delays are largest, against the numpy-engine library chain."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from baseband_tasks_tpu.models import WidebandPulsarPipeline
    from baseband_tasks_tpu.ops.fold import fold_bins_ref
    from baseband_tasks_tpu.utils import units as u

    devices = list(devices if devices is not None else jax.devices()[:4])
    kw = dict(n_chan=shape.n_chan, n_pol=shape.n_pol, dm=shape.dm,
              n_phase=shape.n_phase, freq_center=shape.freq_mhz * u.MHz)
    chans = np.r_[0:4, shape.n_chan - 4:shape.n_chan]
    n = len(devices)
    for c in (1, 2, 4):
        if n % c:
            continue
        mesh = Mesh(np.asarray(devices).reshape(n // c, c),
                    ("time", "chan"))
        pipe = WidebandPulsarPipeline(mesh=mesh, block_samples=shape.block,
                                      **kw)
        G = pipe.global_block
        sh = NamedSharding(mesh, P("time", "chan"))
        gen = jax.jit(lambda k: jax.random.normal(
            jax.random.key(k), (G, shape.n_chan, shape.n_pol, 2),
            jnp.float32), out_shardings=sh, static_argnums=0)
        xf = gen(seed)
        step = pipe.step_fn()
        prof, cnt = _ready(step(xf, jnp.float32(0)))
        t0 = time.perf_counter()
        for _ in range(shape.repeats):
            out = step(xf, jnp.float32(0))
        _ready(out)
        dt = time.perf_counter() - t0
        name = f"four: wideband {n // c}x{c} (time x chan)"
        _rate_line(f"{name} step, {shape.repeats} calls",
                   shape.repeats * G * shape.n_chan * shape.n_pol, dt,
                   shape)
        want = np.bincount(fold_bins_ref([0, pipe._p_fx, 0], np.arange(G),
                                         shape.n_phase),
                           minlength=shape.n_phase)
        if not np.array_equal(np.asarray(cnt), want):
            raise AssertionError(f"four: {n // c}x{c} fold counts")
        prof = np.asarray(prof)
        check(f"{name} vs one card", prof,
              _one_card_profile(pipe, xf, chunk, devices[0]))
        check(f"{name} channels {chans.tolist()} vs numpy chain",
              prof[:, chans], _numpy_slice_profile(pipe, xf, chans))


def phase_four_library(shape=FULL, devices=None, seed=4):
    """A Dedisperse -> Square -> Fold library chain through
    ``ShardedPipeline`` on a time ring of the devices, against the
    single-device ``CompiledPipeline`` on the same blocks."""
    import jax
    from jax.sharding import Mesh
    from baseband_tasks_tpu import (Dedisperse, Fold, NoiseGenerator,
                                    SetAttribute, Square)
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.models.sharded import ShardedPipeline
    from baseband_tasks_tpu.utils import units as u

    devices = list(devices if devices is not None else jax.devices()[:4])
    n = len(devices)
    rate = 250 * u.kHz
    idx = np.arange(shape.n_chan) - shape.n_chan / 2 + 0.5
    freqs = u.Quantity((1400 + 0.25 * idx)[:, np.newaxis], u.MHz)
    src = NoiseGenerator(shape=((n + 1) * shape.block, shape.n_chan,
                                shape.n_pol),
                         start_time=_t0(), sample_rate=rate,
                         samples_per_frame=shape.block, seed=seed)
    ded = Dedisperse(SetAttribute(src, frequency=freqs, sideband=1),
                     shape.dm, reference_frequency=1400 * u.MHz,
                     samples_per_frame=shape.block)
    tail = Fold(Square(ded), shape.n_phase, _polyco(),
                u.Quantity(shape.block / 250e3, u.s), average=False)
    cp = CompiledPipeline(tail)
    blocks = cp.read_source_blocks(n)
    ref_s, ref_c = (np.asarray(a) for a in cp.run_blocks(blocks))
    ring = Mesh(np.asarray(devices), ("time",))
    sp = ShardedPipeline(cp, ring)
    _ready(sp.run_blocks(blocks))
    t0 = time.perf_counter()
    got_s, got_c = _ready(sp.run_blocks(blocks))
    dt = time.perf_counter() - t0
    _rate_line(f"four: ShardedPipeline {n}-device time ring",
               n * shape.block * shape.n_chan * shape.n_pol, dt, shape)
    if not np.array_equal(np.asarray(got_c), ref_c):
        raise AssertionError("four: ShardedPipeline fold counts")
    check(f"four: ShardedPipeline {n}-device ring vs one device",
          np.asarray(got_s), ref_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded path only")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from baseband_tasks_tpu.utils.runtime import (
        configure_compile_cache, device_summary, gpu_name_and_power_limit,
        require_gpu)

    cache = configure_compile_cache(ROOT)
    devices = require_gpu(4 if args.four else 1)
    dev = device_summary()
    print(f"device: platform {dev['platform']}, kind {dev['kind']}, "
          f"count {dev['count']}; compile cache {cache}", flush=True)
    print(gpu_name_and_power_limit(), flush=True)
    t0 = time.perf_counter()
    if args.four:
        phase_four_wideband(FULL4, devices)
        phase_four_library(FULL, devices)
    else:
        phase_decode(FULL)
        phase_main(FULL)
        phase_library(FULL)
    print(f"all phases passed in {time.perf_counter() - t0:.4g} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))


#: small shapes for rehearsing every phase on the CPU (tests)
SMALL = replace(FULL, n_chan=8, dm=5.0, block=1 << 14, n_phase=16,
                n_iter=2, repeats=1, lib_blocks=3)
#: a low band whose dispersion delays differ by ~1300 samples between
#: its edges, so an overlap-save pad on the wrong side shows
SMALL4 = replace(FULL4, n_chan=16, n_pol=2, dm=5.0, freq_mhz=100.0,
                 block=1 << 16, n_phase=64, repeats=1)

if __name__ == "__main__":
    main()
