"""Full baseline table on one GPU: throughput of BASELINE.json configs
1-4, the flagship at each ingest depth, and the search/correlator rows.

Each subcommand prints one JSON line naming the device (platform, device
kind, count, and nvidia-smi's card name and power limit) and the
same-run bandwidth of a plain 1 GiB copy (``copy_GBps``) for context:

    python tools/bench_full.py config1|config2|config3|config4|...
    python tools/bench_full.py all

Every timing is the mean over repeated calls after a warm-up call, each
ending in ``block_until_ready``; inputs are generated on the device
outside the timed region.  Exits non-zero without a GPU, or when any row
fails (the failing rows print an ``error``).
"""

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_ITER = 32
REPEATS = 3


def _time(fn, n=REPEATS):
    """Mean seconds per call of ``fn`` (which returns device arrays),
    after one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


_COPY = {}


def copy_GBps():
    """Same-run bandwidth of ``y = x * s`` over 1 GiB (read + write)."""
    if "GBps" not in _COPY:
        import jax
        import jax.numpy as jnp
        x = jnp.ones((1 << 28,), jnp.float32)
        f = jax.jit(lambda a: a * 1.0001)
        _COPY["GBps"] = 2 * x.size * 4 / _time(lambda: f(x), n=10) / 1e9
    return _COPY["GBps"]


def _row(row):
    from baseband_tasks_tpu.utils.runtime import (
        device_summary, gpu_name_and_power_limit)
    row["device"] = dict(device_summary(),
                         nvidia_smi=gpu_name_and_power_limit())
    row["copy_GBps"] = copy_GBps()
    return row


def _complex_noise(key, shape):
    import jax
    import jax.numpy as jnp
    kr, ki = jax.random.split(key)
    return jax.lax.complex(jax.random.normal(kr, shape, jnp.float32),
                           jax.random.normal(ki, shape, jnp.float32))


def _source_noise(cp, key):
    """One device block per source of a compiled graph: complex or real
    Gaussian noise of each source's block shape."""
    import jax
    import jax.numpy as jnp
    blocks = []
    for i, src in enumerate(cp.sources):
        shape = (cp.block_samples,) + tuple(src.sample_shape)
        k = jax.random.fold_in(key, i)
        if np.dtype(src.dtype).kind == "c":
            blocks.append(_complex_noise(k, shape))
        else:
            blocks.append(jax.random.normal(k, shape, jnp.float32))
    return tuple(blocks) if len(blocks) > 1 else blocks[0]


def _timed_chain(cp, n_iter=N_ITER):
    """Seconds per block of a compiled graph's step in a device scan:
    each iteration scales the (device-resident) source block(s) by
    ``1 + 1e-6 i`` so nothing is hoisted, and reduces the output to a
    checksum."""
    import jax
    import jax.numpy as jnp
    step_c, caches = cp.cached_step()
    x0 = _source_noise(cp, jax.random.key(1))
    jax.block_until_ready(x0)

    @jax.jit
    def run(x0, *cs):
        def s(carry, i):
            f = 1.0 + 1e-6 * i.astype(jnp.float32)
            xs = jax.tree.map(lambda a: a * f, x0)
            carry, y = step_c(carry, xs, cs)
            return carry, jnp.sum(jnp.abs(y) ** 2)
        _, ys = jax.lax.scan(s, cp.init_carry(),
                             jnp.arange(n_iter, dtype=jnp.int32))
        return jnp.sum(ys)

    return _time(lambda: run(x0, *caches)) / n_iter


def config1():
    """Noise -> Channelize(256) -> Square -> Integrate(16): the eager
    (frame-at-a-time) read rate and the compiled scan rate.  Samples =
    source samples."""
    from baseband_tasks_tpu import (Channelize, Integrate, NoiseGenerator,
                                    Square)
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    n, spf = 1 << 22, 1 << 16

    def source():
        return NoiseGenerator(shape=(n,), start_time=Time.from_mjd(58000.0),
                              sample_rate=16 * u.MHz,
                              samples_per_frame=spf, seed=7)

    tail = Integrate(Square(Channelize(source(), 256)), 16)
    tail.seek(0)
    tail.read(64)  # warm compile caches
    tail.seek(0)
    t0 = time.perf_counter()
    tail.read(tail.shape[0] - 64)
    eager_dt = time.perf_counter() - t0
    eager_rate = (tail.shape[0] - 64) * 256 * 16 / eager_dt

    cp = CompiledPipeline(Integrate(Square(Channelize(source(), 256)), 16),
                          block_samples=1 << 23)
    cp_chain = CompiledPipeline(Square(Channelize(source(), 256)),
                                block_samples=1 << 23)
    dt = _timed_chain(cp_chain)
    return _row({"config": 1, "eager_samples_per_s": eager_rate,
                 "compiled_samples_per_s": cp.block_samples / dt,
                 "block": cp.block_samples})


def config2(spf=1 << 17):
    """Coherent dedispersion DM=29.7 + Dechannelize, 16 MHz band
    (128 x 125 kHz complex channels).  ``spf`` sets the dedispersion
    frame (config2big doubles it), grown so the padded window is
    2/3/5-smooth."""
    from baseband_tasks_tpu import (Dechannelize, Dedisperse,
                                    NoiseGenerator, SetAttribute)
    from baseband_tasks_tpu.fourier import next_fast_len
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    n_chan = 128
    freq = (1400 + (np.arange(n_chan) - n_chan / 2) * 0.125) * u.MHz
    src = SetAttribute(
        NoiseGenerator(shape=(1 << 23, n_chan),
                       start_time=Time.from_mjd(58000.0),
                       sample_rate=125 * u.kHz, samples_per_frame=8192,
                       seed=1),
        frequency=freq, sideband=1)
    probe = Dedisperse(src, 29.7, samples_per_frame=spf)
    pad = probe.pad_start + probe.pad_end
    ded = Dedisperse(src, 29.7,
                     samples_per_frame=next_fast_len(spf + pad) - pad)
    cp = CompiledPipeline(Dechannelize(ded))
    dt = _timed_chain(cp)
    rate = cp.block_samples * n_chan / dt
    return _row({"config": 2, "samples_per_s": rate,
                 "block": cp.block_samples, "ms_per_block": dt * 1e3,
                 "vs_realtime": rate / 16e6})


def config3(spf=32256, pad_start=128, pad_end=128):
    """PFB (8 taps x 256 chan sinc-hamming) + Wiener inverse round trip,
    dual-pol complex.  ``spf``/pads (spectra) set the deconvolution
    window (config3big uses a 4x larger one); ``spf`` is trimmed so the
    window is 2/3/5-smooth."""
    from baseband_tasks_tpu import (InversePolyphaseFilterBank,
                                    NoiseGenerator, PolyphaseFilterBank,
                                    sinc_hamming)
    from baseband_tasks_tpu.fourier import next_fast_len
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    n_tap, n_chan = 8, 256
    rows = pad_start + pad_end + n_tap - 1
    spf = next_fast_len(spf + rows) - rows
    h = sinc_hamming(n_tap, n_chan)
    n_src = max(1 << 24, 1 << (int(np.ceil(np.log2(spf * 256))) + 1))
    src = NoiseGenerator(shape=(n_src, 2),
                         start_time=Time.from_mjd(58000.0),
                         sample_rate=4 * u.MHz, samples_per_frame=1 << 16,
                         seed=2)
    pfb = PolyphaseFilterBank(src, h, samples_per_frame=spf)
    inv = InversePolyphaseFilterBank(
        pfb, h, sn=30, pad_start=pad_start, pad_end=pad_end,
        samples_per_frame=spf, dtype=src.dtype)
    cp = CompiledPipeline(inv)
    dt = _timed_chain(cp)
    rate = cp.block_samples * 2 / dt
    return _row({"config": 3, "samples_per_s": rate,
                 "block": cp.block_samples, "ms_per_block": dt * 1e3})


def config4():
    """Full pipeline from stored 8-bit baseband: VDIF on disk -> host C
    LUT decode -> float32 pairs -> device dedisperse+fold.  Reports the
    host decode rate and the sustained end-to-end rate (host decode and
    host->device transfer included)."""
    import tempfile

    import jax
    from baseband_tasks_tpu import NoiseGenerator, native
    from baseband_tasks_tpu.io import vdif
    from baseband_tasks_tpu.models import WidebandPulsarPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    n_chan, n_pol = 16, 2
    block = 1 << 15
    src = NoiseGenerator(shape=(block * 4, n_chan * n_pol),
                         start_time=Time.from_mjd(58000.0),
                         sample_rate=250 * u.kHz,
                         samples_per_frame=8192, seed=3)
    rng = np.random.default_rng(3)
    path = os.path.join(tempfile.mkdtemp(), "bench4.vdif")
    with vdif.open(path, "w", template=src, bps=8,
                   samples_per_frame=2500) as wh:
        for _ in range(4):
            x = (rng.standard_normal((block, n_chan * n_pol, 2))
                 .astype(np.float32) * 0.25)
            wh.write((x[..., 0] + 1j * x[..., 1]).astype(np.complex64))

    raw = np.fromfile(path, np.uint8)
    t0 = time.perf_counter()
    for _ in range(8):
        native.unpack_8bit(raw)
    host_decode_Bps = 8 * raw.size / (time.perf_counter() - t0)

    rh = vdif.open(path, sample_rate=250 * u.kHz)
    pipe = WidebandPulsarPipeline(
        n_chan=n_chan, n_pol=n_pol, dm=29.7, freq_center=1400 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(8000, 3), n_phase=32,
        block_samples=block)
    step = pipe.step_fn()

    def read_block(i):
        rh.seek((i % 4) * block)
        x = np.asarray(rh.read(block)).reshape(block, n_chan, n_pol)
        return np.stack([x.real, x.imag], -1).astype(np.float32)

    xf = np.zeros((pipe.global_block, n_chan, n_pol, 2), np.float32)
    xf[:block] = read_block(0)
    jax.block_until_ready(step(xf, np.float32(0)))
    t0 = time.perf_counter()
    n_rep = 4
    for i in range(n_rep):
        xf[:block] = read_block(i)  # VDIF frame decode incl. C LUT
        out = step(xf, np.float32(i))
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / n_rep
    return _row({"config": 4,
                 "sustained_samples_per_s": block * n_chan * n_pol / dt,
                 "host_decode_GBps": host_decode_Bps / 1e9,
                 "note": "sustained number includes host decode and the "
                         "host->device transfer"})


def config4_packed():
    """Config 4 through the packed ingest path: raw 8-bit VDIF payload
    words cross to the device and decode INSIDE the compiled step
    (ops/unpack_device.py), vs the host-LUT float path through the
    identical chain, same run.

    Chain: VDIF (16 threads = 8 chan x 2 pol) -> Dedisperse(DM=29.7)
    -> Square -> Integrate, driven by StreamRunner (prefetching reader
    thread, carries on device).  Reports sustained samples/s for both
    paths, the transferred bytes per block for both, and asserts the two
    paths agree to float roundoff."""
    import tempfile
    import warnings

    from baseband_tasks_tpu import (Dedisperse, Integrate, NoiseGenerator,
                                    SetAttribute, Square)
    from baseband_tasks_tpu.io import vdif
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.models.runner import StreamRunner
    from baseband_tasks_tpu.utils import Time, units as u

    n_thread = 16            # 8 channels x 2 pols as VDIF threads
    n_blocks = 6
    rate = u.Quantity(1 << 18, u.Hz)  # pow2 so spf divides the second
    freq = (1400 + 0.262144 * (np.arange(n_thread) // 2)) * u.MHz

    # the padded stage pins the compiled block; probe it, then size the
    # file frames to the largest pow2 that divides it so read_packed
    # stays frame-aligned
    probe_src = NoiseGenerator(shape=(1 << 20, n_thread),
                               start_time=Time.from_mjd(58000.0),
                               sample_rate=rate, samples_per_frame=8192,
                               dtype=np.complex64, seed=11)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ded_probe = Dedisperse(
            SetAttribute(probe_src, frequency=freq, sideband=1),
            29.7, samples_per_frame=1 << 16)
    block = int(ded_probe.samples_per_frame)
    spf = min(4096, block & -block)  # largest pow2 divisor, capped
    assert (1 << 18) % spf == 0 and block % spf == 0

    src = NoiseGenerator(shape=(n_blocks * block, n_thread),
                         start_time=Time.from_mjd(58000.0),
                         sample_rate=rate, samples_per_frame=8192,
                         dtype=np.complex64, seed=11)
    rng = np.random.default_rng(11)
    path = os.path.join(tempfile.mkdtemp(), "bench4p.vdif")
    with vdif.open(path, "w", template=src, bps=8,
                   samples_per_frame=spf) as wh:
        for _ in range(n_blocks):
            x = rng.standard_normal((block, n_thread, 2)).astype(
                np.float32) * 16
            wh.write((x[..., 0] + 1j * x[..., 1]).astype(np.complex64))

    def chain():
        fr = vdif.open(path, sample_rate=rate)
        ded = Dedisperse(SetAttribute(fr, frequency=freq, sideband=1),
                         29.7, samples_per_frame=block)
        return fr, Integrate(Square(ded), 4096)

    fr_f, tail_f = chain()
    cp_f = CompiledPipeline(tail_f, block_samples=block)
    fr_p, tail_p = chain()
    cp_p = CompiledPipeline(tail_p, block_samples=block, packed=True)

    carrier, mask = fr_p.read_packed(0, block)
    packed_bytes = carrier.nbytes + mask.nbytes
    planes_bytes = block * n_thread * 8  # complex64

    runner_p = StreamRunner(cp_p)
    runner_f = StreamRunner(cp_f)
    s_p, c_p = (np.asarray(a) for a in runner_p.run(n_blocks))
    s_f, c_f = (np.asarray(a) for a in runner_f.run(n_blocks))
    np.testing.assert_allclose(s_p, s_f, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(c_p, c_f)

    dt_p = _time(lambda: runner_p.run(n_blocks))
    dt_f = _time(lambda: runner_f.run(n_blocks))
    n_samp = n_blocks * block * n_thread
    return _row({"config": "config4_packed",
                 "packed_samples_per_s": n_samp / dt_p,
                 "float_samples_per_s": n_samp / dt_f,
                 "transfer_bytes_per_block": {"packed": int(packed_bytes),
                                              "complex64":
                                                  int(planes_bytes)},
                 "note": "packed ships raw payload words; the decode "
                         "runs inside the compiled step"})


def flagship(ingest_bits=None, detect="power"):
    """The bench.py configuration at an ingest depth (None = float32)."""
    import bench as bench_mod
    rate = bench_mod.measure(bench_mod.flagship_pipeline(detect=detect),
                             ingest_bits=ingest_bits)
    name = f"ingest_{ingest_bits}bit" if ingest_bits else \
        ("flagship_stokes" if detect == "stokes" else "flagship_f32")
    return _row({"config": name, "samples_per_s": rate,
                 "vs_baseline": rate / 3.2e8})


def correlator():
    """FX correlator throughput: 2 stations x 16 MHz, 256 chan, one
    fractional geometric delay compensated with sinc resampling, cross
    products + visibility integration absorbed into the compiled scan.
    Samples = station baseband samples (2 per timestep)."""
    from baseband_tasks_tpu import NoiseGenerator
    from baseband_tasks_tpu.models import fx_correlate
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    n = 1 << 24
    rate = 16 * u.MHz
    tau = 37.25 / rate

    def mk(seed):
        return NoiseGenerator(shape=(n,), start_time=Time.from_mjd(58000.0),
                              sample_rate=rate, samples_per_frame=1 << 16,
                              seed=seed)

    # integer gather + per-channel phase slope (no big overlap-save
    # windows); big blocks amortize the per-step cost
    vis = fx_correlate([mk(3), mk(4)], 256, 256, delays=[None, tau],
                       method="phase", samples_per_frame=1 << 21)
    cp = CompiledPipeline(vis, block_samples=1 << 21)
    dt = _timed_chain(cp)
    return _row({"config": "correlator",
                 "station_samples_per_s": 2 * cp.block_samples / dt,
                 "block": cp.block_samples})


def beamform():
    """Tied-array beamformer throughput: 4 stations x 16 MHz, 256 chan,
    one fractional delay each, coherent sum, compiled.  Samples =
    station baseband samples (4 per timestep)."""
    from baseband_tasks_tpu import NoiseGenerator
    from baseband_tasks_tpu.models import tied_array_beam
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    n_st = 4
    n = 1 << 24
    rate = 16 * u.MHz

    def mk(seed):
        return NoiseGenerator(shape=(n,),
                              start_time=Time.from_mjd(58000.0),
                              sample_rate=rate,
                              samples_per_frame=1 << 16, seed=seed)

    delays = [None] + [(11.25 + 7 * k) / rate for k in range(1, n_st)]
    beam = tied_array_beam([mk(3 + k) for k in range(n_st)], 256,
                           delays=delays, method="phase",
                           samples_per_frame=1 << 21)
    cp = CompiledPipeline(beam, block_samples=1 << 21)
    dt = _timed_chain(cp)
    return _row({"config": "beamform", "n_stations": n_st,
                 "station_samples_per_s": n_st * cp.block_samples / dt,
                 "block": cp.block_samples})


def accel(engine="auto", n=1 << 22, z_max=64, n_scan=8):
    """Fourier-domain acceleration search throughput: 2^22-sample power
    series x 65 z-trials (z_max 64, step 2), one jit, for the given
    engine ('auto' = 'xla', the overlap-save FFT; 'mx', the banded
    bank matmul)."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.models import FourierDomainAccelSearch
    from baseband_tasks_tpu.utils import units as u

    s = FourierDomainAccelSearch(
        n, 1 * u.MHz, z_max=z_max, z_step=2,
        seg_len=4096 if engine == "mx" else 8192, engine=engine)
    x = jax.random.normal(jax.random.key(1), (n,), jnp.float32)
    if s._use_mx():
        planes = s._mx_planes()
        impl = lambda xx: s._search_impl_mx(xx, *planes)  # noqa: E731
    else:
        impl = lambda xx: s._search_impl(xx, s._tf_r, s._tf_i)  # noqa

    @jax.jit
    def run(x):
        def step(carry, i):
            zmap = impl(x * (1.0 + 1e-6 * i.astype(jnp.float32)))
            return carry, jnp.sum(zmap)
        _, ys = jax.lax.scan(step, 0.0,
                             jnp.arange(n_scan, dtype=jnp.int32))
        return jnp.sum(ys)

    dt = _time(lambda: run(x)) / n_scan
    return _row({"config": "accelsearch",
                 "sample_trials_per_s": n * len(s.zs) / dt,
                 "n_z": len(s.zs), "engine": s.engine})


def ffa(n=1 << 22, p0=16, n_octave_p=16):
    """FFA survey rate across one octave of base periods: every p in
    [p0, 2·p0) folds its full (m, p) trial bank over the same
    2^22-sample series (the ffa_survey inner loop, distinct compiled
    shapes per p).  trial·samples/s = sum_p m_p · n / t_total — the
    standard FFA survey throughput metric (each of m_p trials inspects
    all n samples; the recursion does it in n·log2(m) work)."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.models import FastFoldingSearch

    x = jax.random.normal(jax.random.key(1), (n,), jnp.float32)
    searches = [FastFoldingSearch(p, n) for p in range(p0, p0 + n_octave_p)]
    fns = []
    trial_samples = 0
    for s in searches:
        fn = s._snr_fn((1, 2, 4, 8, 16))
        # warm/compile each distinct (m, p) shape
        jax.block_until_ready(fn(x[:s.m * s.p]))
        fns.append((fn, s.m, s.p))
        trial_samples += s.m * n

    dt = _time(lambda: [fn(x[:m * p]) for fn, m, p in fns])
    return _row({"config": "ffa_octave",
                 "trial_samples_per_s": trial_samples / dt,
                 "n_series_samples": n, "octave": [p0, 2 * p0],
                 "n_searches": len(fns),
                 "n_trials_total": int(sum(s.m for s in searches))})


def rmsearch(batch=4096, n_chan=1024, n_phi=1024, n_scan=16):
    """RM synthesis throughput: (batch, n_chan) Q/U planes against an
    n_phi-depth bank — one matmul per Stokes component.
    trial-samples/s = batch · n_chan · n_phi / t."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.models import RMSynthesis
    from baseband_tasks_tpu.utils import units as u

    freq = (1200 + 0.25 * np.arange(n_chan)) * u.MHz
    rm = RMSynthesis(freq, np.linspace(-500, 500, n_phi))

    qu = jax.random.normal(jax.random.key(1), (2, batch, n_chan),
                           jnp.float32)
    q, u_ = qu[0], qu[1]

    @jax.jit
    def run(q, u_, tr, ti):
        def step(carry, i):
            f = RMSynthesis._fdf_impl(
                q * (1.0 + 1e-6 * i.astype(jnp.float32)), u_, tr, ti)
            return carry, jnp.sum(jnp.abs(f))
        _, ys = jax.lax.scan(step, 0.0,
                             jnp.arange(n_scan, dtype=jnp.int32))
        return jnp.sum(ys).reshape(1)

    dt = _time(lambda: run(q, u_, rm._tr, rm._ti)) / n_scan
    return _row({"config": "rmsynthesis",
                 "trial_samples_per_s": batch * n_chan * n_phi / dt,
                 "batch": batch, "n_chan": n_chan, "n_phi": n_phi})


def secondary(n_t=4096, n_f=2048, n_scan=8):
    """Secondary (delay-Doppler) spectrum of an (n_t, n_f) dynamic
    spectrum: 2-D FFT + |.|^2 + fftshift (models/scintillation.py)."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.models import secondary_spectrum

    d = jax.random.normal(jax.random.key(1), (n_t, n_f),
                          jnp.float32) + 10.0

    @jax.jit
    def run(d):
        def step(carry, i):
            s, _, _ = secondary_spectrum(
                d * (1.0 + 1e-6 * i.astype(jnp.float32)))
            return carry, jnp.sum(s)
        _, ys = jax.lax.scan(step, 0.0,
                             jnp.arange(n_scan, dtype=jnp.int32))
        return jnp.sum(ys).reshape(1)

    dt = _time(lambda: run(d)) / n_scan
    return _row({"config": "secondary_spectrum",
                 "samples_per_s": n_t * n_f / dt, "shape": [n_t, n_f]})


def _fold_chain_rate(masked, n_blocks=16, block=1 << 14, n_chan=128):
    """Device-resident masked/unmasked fold-chain rate: float32
    (block, n_chan) blocks -> Square -> Fold(masked=...) through
    CompiledPipeline.run_fn (the general executor, not the bespoke
    flagship), blocks generated on device."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu import Fold, Square, StreamGenerator
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    t0 = Time("2020-01-01")
    n = n_blocks * block
    src = StreamGenerator(lambda sh: np.zeros((block, n_chan),
                                              np.float32),
                          shape=(n, n_chan), start_time=t0,
                          sample_rate=1 * u.MHz, samples_per_frame=block,
                          dtype=np.float32)
    f0 = 12345.6
    phase = (lambda t: u.Quantity((t - t0).sec * f0, u.cycle))
    tail = Fold(Square(src), 64, phase, u.Quantity(block / 1e6, u.s),
                samples_per_frame=1, masked=masked, average=False)
    cp = CompiledPipeline(tail, block_samples=block)
    run = cp.run_fn(n_blocks)

    blocks = jax.random.normal(jax.random.key(1), (n_blocks, block, n_chan),
                               jnp.float32)
    return n * n_chan / _time(lambda: run(blocks))


def maskedfold():
    """Masked-fold overhead: the identical general-executor fold chain
    with masked=True (per-cell isfinite counts) vs masked=False
    (host-tallied counts)."""
    r_plain = _fold_chain_rate(False)
    r_masked = _fold_chain_rate(True)
    return _row({"config": "maskedfold", "samples_per_s": r_masked,
                 "unmasked_samples_per_s": r_plain,
                 "masked_overhead": r_plain / r_masked - 1})


def polarization(n_blocks=64, block=1 << 18, n_chan=128, n_scan=4):
    """ConvertPolarization + ApplyJones in-chain cost: the same
    channelize-detect-integrate chain with and without the two
    polarization stages, device-resident blocks.

    Sizing: 64 x 2^18-sample dual-pol blocks (268 MB complex) per jit
    call, so the per-call dispatch cost is a small share."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu import (ApplyJones, Channelize,
                                    ConvertPolarization, Integrate,
                                    NoiseGenerator, Square)
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    from baseband_tasks_tpu.utils import Time, units as u

    t0 = Time("2020-01-01")
    n = n_blocks * block

    def make(with_pol):
        src = NoiseGenerator(shape=(n, 2), start_time=t0,
                             sample_rate=1 * u.MHz,
                             samples_per_frame=block,
                             dtype=np.complex64, seed=3,
                             polarization=np.array(["X", "Y"]))
        ch = Channelize(src, n_chan)
        if with_pol:
            jones = np.tile(np.array([[1.0, 0.05j], [-0.05j, 1.0]],
                                     np.complex64), (n_chan, 1, 1))
            ch = ApplyJones(ConvertPolarization(ch, "circular"), jones,
                            inverse=True)
        tail = Integrate(Square(ch), 64, average=False)
        return CompiledPipeline(tail, block_samples=block)

    rates = {}
    for key, with_pol in (("plain", False), ("with_pol", True)):
        cp = make(with_pol)
        run = cp.run_fn(n_blocks)

        blocks = _complex_noise(jax.random.key(1),
                                (n_blocks, block, 2))
        rates[key] = n * 2 / _time(lambda: run(blocks))
    return _row({"config": "polarization_chain",
                 "samples_per_s": rates["with_pol"],
                 "plain_samples_per_s": rates["plain"],
                 "pol_overhead": rates["plain"] / rates["with_pol"] - 1})


def _cmds():
    return {
        "config1": config1, "config2": config2, "config3": config3,
        "config2big": lambda: dict(config2(spf=1 << 18),
                                   config="config2big"),
        "config3big": lambda: dict(config3(spf=130048, pad_start=1024,
                                           pad_end=1024),
                                   config="config3big"),
        "config4": config4, "config4_packed": config4_packed,
        "flagship": flagship,
        "ingest": lambda: flagship(ingest_bits=8),
        "ingest2": lambda: flagship(ingest_bits=2),
        "stokes": lambda: flagship(detect="stokes"),
        "correlator": correlator,
        "accel": accel,
        "accel_mx": lambda: dict(accel(engine="mx"),
                                 config="accelsearch_mx"),
        "beamform": beamform,
        "ffa": ffa, "rmsearch": rmsearch, "secondary": secondary,
        "maskedfold": maskedfold, "polarization": polarization}


def main():
    from baseband_tasks_tpu.utils.runtime import (configure_compile_cache,
                                                  require_gpu)
    configure_compile_cache(ROOT)
    require_gpu()
    cmds = _cmds()
    names = sys.argv[1:] or ["all"]
    if names == ["all"]:
        names = list(cmds)
    failed = []
    for name in names:
        try:
            res = cmds[name]()
        except Exception as exc:  # report the row, fail at the end
            import traceback
            failed.append(name)
            res = {"config": name, "error": f"{type(exc).__name__}: {exc}",
                   "traceback": traceback.format_exc().splitlines()[-12:]}
        print(json.dumps(res), flush=True)
    if failed:
        raise SystemExit(f"failed rows: {failed}")


if __name__ == "__main__":
    main()
