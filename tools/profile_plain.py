"""Time what XLA makes of the plain version of each stage on one GPU.

    python tools/profile_plain.py [name ...]

For each stage at its benchmark shape: the time per call (host clock
around calls ending in ``block_until_ready``), the device busy time per
call from one ``jax.profiler`` trace (tools/trace_reduce.py), the bytes
the stage must move (a byte model computed from its shapes, kept here),
and the share of the H100's HBM roofline those bytes give.  Also the
precision experiments: the fold's one-hot product against
``segment_sum``, and the short-DFT matmul at each precision against
cuFFT.  One JSON row per measurement goes to stdout and to
``chiprun_out/profile_plain.jsonl``; every row names the device.

Exits non-zero without a GPU.
"""

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

#: published dense peaks by ``device_kind`` (NVIDIA H100 data sheet; the
#: SXM part at its 700 W limit): HBM bytes/s, bf16 and float32 FLOP/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_Bps": 3.35e12, "bf16_flops": 989e12,
                              "f32_flops": 67e12},
}

N_CALLS = 10


def _peaks():
    import jax
    kind = jax.devices()[0].device_kind
    if kind not in PEAKS:
        raise SystemExit(f"no peak table entry for device kind {kind!r}")
    return PEAKS[kind]


def timed(fn, *args, n=N_CALLS):
    """Seconds per call of a jitted ``fn`` (after one warm call)."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def traced(fn, *args, n=3):
    """(busy s per call, idle share, top kernels) from one trace of
    ``n`` calls."""
    import jax
    from trace_reduce import device_time, find_xplane
    d = tempfile.mkdtemp()
    try:
        jax.block_until_ready(fn(*args))
        with jax.profiler.trace(d):
            for _ in range(n):
                out = fn(*args)
            jax.block_until_ready(out)
        busy, window, kern = device_time(find_xplane(d))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:6]
    return (busy / n * 1e-9, 1.0 - busy / window,
            [[k[:80], v / n * 1e-9] for k, v in top])


def row(name, fn, args, bytes_moved, extra=None):
    """A measured row: time, busy time, roofline share of its bytes."""
    peaks = _peaks()
    dt = timed(fn, *args)
    busy, idle, top = traced(fn, *args)
    bound = bytes_moved / peaks["hbm_Bps"]
    r = {"stage": name, "s_per_call": dt, "busy_s_per_call": busy,
         "idle_share_in_trace": idle, "model_bytes": bytes_moved,
         "achieved_GBps": bytes_moved / busy / 1e9,
         "hbm_roofline_share": bound / busy, "top_kernels": top}
    r.update(extra or {})
    return r


def copy_probe():
    import jax
    import jax.numpy as jnp
    x = jnp.ones((1 << 28,), jnp.float32)
    f = jax.jit(lambda a: a * 1.0001)
    return row("copy_1GiB", f, (x,), 2 * x.size * 4)


def matmul_probe():
    import jax
    import jax.numpy as jnp
    a = jnp.ones((8192, 8192), jnp.bfloat16)
    f = jax.jit(lambda p, q: p @ q)
    dt = timed(f, a, a)
    return {"stage": "bf16_matmul_8192", "s_per_call": dt,
            "TFLOPs": 2 * 8192 ** 3 / dt / 1e12,
            "bf16_peak_share": 2 * 8192 ** 3 / dt / _peaks()["bf16_flops"]}


def flagship_step():
    """One packed-8-bit dedisperse->detect->fold step (the main path)."""
    import bench
    pipe = bench.flagship_pipeline()
    n_iter = 16
    run = pipe.run_fn(n_iter, ingest_bits=8)
    inputs = run.inputs(1)
    T, L, n = pipe.block_samples, pipe.n_chan * pipe.n_pol, pipe._n_fft

    def f(seed):
        return run(seed)
    r = row("dedisperse_step (flagship, per 16 steps)", f, (1,),
            n_iter * (2 * T * L            # packed bytes (re, im)
                      + 8 * n * pipe.n_chan),   # chirp
            {"note": "model bytes = packed input + chirp: the fused "
                     "single-pass lower bound"})
    # the plain chain's own passes: window write, FFT r+w, chirp multiply
    # r+w (+chirp), IFFT r+w, detect/fold read — 8 B complex each
    chain = n_iter * (2 * T * L + 8 * n * L * 7 + 8 * n * pipe.n_chan)
    r["chain_model_bytes"] = chain
    r["chain_roofline_share"] = chain / _peaks()["hbm_Bps"] \
        / r["busy_s_per_call"]
    r["samples_per_s"] = n_iter * T * L / r["s_per_call"]
    del inputs
    return r


def fft_long():
    import jax
    import jax.numpy as jnp
    import bench
    n = bench.flagship_pipeline()._n_fft
    x = jnp.ones((n, 128), jnp.complex64)
    f = jax.jit(lambda a: jnp.fft.fft(a, axis=0))
    return row(f"fft c64 ({n}, 128) axis 0", f, (x,), 2 * 8 * x.size)


def _compiled_rate(name, tail, block, n_blocks=8):
    """A compiled chain's per-block step, input from device noise."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.models.compiled import CompiledPipeline
    cp = CompiledPipeline(tail, block_samples=block)
    step_c, caches = cp.cached_step()
    shape = (cp.block_samples,) + tuple(cp.source.sample_shape)
    key = jax.random.key(0)
    x0 = jax.lax.complex(jax.random.normal(key, shape),
                         jax.random.normal(jax.random.fold_in(key, 1),
                                           shape))

    @jax.jit
    def run(x0, *cs):
        def s(carry, i):
            carry, y = step_c(carry, x0 * (1.0 + 1e-6 * i), cs)
            return carry, jnp.sum(jnp.abs(y) ** 2)
        _, ys = jax.lax.scan(s, cp.init_carry(),
                             jnp.arange(n_blocks, dtype=jnp.float32))
        return jnp.sum(ys)
    n_samp = n_blocks * int(np.prod(shape))
    r = row(name, run, (x0,) + tuple(caches), n_blocks * 16 * int(
        np.prod(shape)), {"note": "model bytes = complex64 block in + "
                                  "out per step"})
    r["samples_per_s"] = n_samp / r["s_per_call"]
    return r


def config2():
    """Overlap-save chirp filter + Dechannelize (the spectral-filter
    kernel's Disperse/Convolve job), 128 x 125 kHz, DM 29.7."""
    from baseband_tasks_tpu import (Dechannelize, Dedisperse,
                                    NoiseGenerator, SetAttribute)
    from baseband_tasks_tpu.utils import Time, units as u
    n_chan = 128
    freq = (1400 + (np.arange(n_chan) - n_chan / 2) * 0.125) * u.MHz
    src = SetAttribute(NoiseGenerator(
        shape=(1 << 23, n_chan), start_time=Time.from_mjd(58000.0),
        sample_rate=125 * u.kHz, samples_per_frame=8192, seed=1),
        frequency=freq, sideband=1)
    ded = Dedisperse(src, 29.7, samples_per_frame=1 << 17)
    return _compiled_rate("config2 Dedisperse+Dechannelize per 8 blocks",
                          Dechannelize(ded), ded.samples_per_frame)


def config3():
    """Forward PFB (8 taps x 256) + Wiener inverse, dual-pol (the
    spectral-filter and PFB kernels' jobs)."""
    from baseband_tasks_tpu import (InversePolyphaseFilterBank,
                                    NoiseGenerator, PolyphaseFilterBank,
                                    sinc_hamming)
    from baseband_tasks_tpu.utils import Time, units as u
    h = sinc_hamming(8, 256)
    src = NoiseGenerator(shape=(1 << 24, 2),
                         start_time=Time.from_mjd(58000.0),
                         sample_rate=4 * u.MHz, samples_per_frame=1 << 16,
                         seed=2)
    pfb = PolyphaseFilterBank(src, h, samples_per_frame=32256)
    inv = InversePolyphaseFilterBank(pfb, h, sn=30, pad_start=128,
                                     pad_end=128, samples_per_frame=32256,
                                     dtype=src.dtype)
    out = [_compiled_rate("config3 PFB + inverse PFB per 8 blocks", inv,
                          inv.samples_per_frame)]
    pfb2 = PolyphaseFilterBank(NoiseGenerator(
        shape=(1 << 24, 2), start_time=Time.from_mjd(58000.0),
        sample_rate=4 * u.MHz, samples_per_frame=1 << 16, seed=3), h,
        samples_per_frame=1 << 14)
    out.append(_compiled_rate("forward PFB (FIR tap-sum + channelize) "
                              "per 8 blocks", pfb2,
                              pfb2.samples_per_frame * 256))
    return out


def accel():
    """Acceleration search at the bench shape, both engines."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.models import FourierDomainAccelSearch
    from baseband_tasks_tpu.utils import units as u
    n = 1 << 22
    x = jax.random.normal(jax.random.key(3), (n,), jnp.float32)
    out = []
    maps = {}
    for engine, seg in (("xla", 8192), ("mx", 4096)):
        s = FourierDomainAccelSearch(n, 1 * u.MHz, z_max=64, z_step=2,
                                     seg_len=seg, engine=engine)
        f = s.search
        r = row(f"accelsearch {engine} 2^22 x {len(s.zs)}", f, (x,),
                4 * n + 4 * s.n_freq * len(s.zs),
                {"note": "model bytes = series in + map out"})
        r["sample_trials_per_s"] = n * len(s.zs) / r["s_per_call"]
        maps[engine] = np.asarray(f(x))
        out.append(r)
    from chip_smoke import snr_db
    out.append({"stage": "accelsearch mx vs xla map",
                "snr_db": snr_db(maps["mx"], maps["xla"])})
    return out


def fold_choice():
    """The fold's one-hot product (HIGHEST) vs segment_sum, against a
    float64 fold."""
    import jax
    import jax.numpy as jnp
    from baseband_tasks_tpu.ops.fold import fold_accumulate
    from chip_smoke import snr_db
    T, L, nph = 1 << 17, 128, 64
    rng = np.random.default_rng(0)
    p = rng.exponential(size=(T, L)).astype(np.float32)
    b = rng.integers(0, nph, T).astype(np.int32)
    ref = np.zeros((nph, L))
    np.add.at(ref, b, p.astype(np.float64))
    out = []
    for method in ("onehot", "segment"):
        f = jax.jit(lambda pp, bb, m=method: fold_accumulate(
            pp, bb, nph, method=m))
        r = row(f"fold {method} ({T}, {L}) -> {nph}", f,
                (jnp.asarray(p), jnp.asarray(b)), 4 * T * L + 4 * T)
        r["snr_db_vs_f64"] = snr_db(np.asarray(f(p, b)[0]), ref)
        out.append(r)
    return out


def dft_choice():
    """Channelize(256): cuFFT vs a DFT matmul (four real matmuls on the
    re/im planes) at each precision, against a float64 numpy FFT."""
    import jax
    import jax.numpy as jnp
    from chip_smoke import snr_db
    rows_, n = 1 << 16, 256
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((rows_, n, 2))
         + 1j * rng.standard_normal((rows_, n, 2))).astype(np.complex64)
    ref = np.fft.fft(x.astype(np.complex128), axis=1)
    xd = jnp.asarray(x)
    f = jax.jit(lambda a: jnp.fft.fft(a, axis=1))
    r = row("channelize 256 cuFFT", f, (xd,), 16 * x.size)
    r["snr_db_vs_f64"] = snr_db(np.asarray(f(xd)), ref)
    out = [r]
    theta = -2 * np.pi / n * np.outer(np.arange(n), np.arange(n))
    fr, fi = (jnp.asarray(m, jnp.float32)
              for m in (np.cos(theta), np.sin(theta)))
    for prec in ("default", "high", "highest"):
        def g(a, prec=prec):
            def dot(p, m):
                return jnp.einsum("rnp,nk->rkp", p, m, precision=prec)
            return jax.lax.complex(dot(a.real, fr) - dot(a.imag, fi),
                                   dot(a.real, fi) + dot(a.imag, fr))
        g = jax.jit(g)
        r = row(f"channelize 256 DFT matmul {prec}", g, (xd,), 16 * x.size)
        r["snr_db_vs_f64"] = snr_db(np.asarray(g(xd)), ref)
        out.append(r)
    return out


STAGES = {"copy": copy_probe, "matmul": matmul_probe,
          "flagship": flagship_step, "fft": fft_long, "config2": config2,
          "config3": config3, "accel": accel, "fold": fold_choice,
          "dft": dft_choice}


def main():
    from baseband_tasks_tpu.utils.runtime import (
        configure_compile_cache, device_summary, gpu_name_and_power_limit,
        require_gpu)
    configure_compile_cache(ROOT)
    require_gpu()
    dev = dict(device_summary(), nvidia_smi=gpu_name_and_power_limit())
    names = sys.argv[1:] or list(STAGES)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_plain.jsonl"),
              "a") as fh:
        for name in names:
            res = STAGES[name]()
            for r in res if isinstance(res, list) else [res]:
                r["device"] = dev
                line = json.dumps(r)
                print(line, flush=True)
                fh.write(line + "\n")


if __name__ == "__main__":
    main()
