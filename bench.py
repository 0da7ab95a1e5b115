"""Benchmark: coherent dedispersion + detection + fold throughput per GPU.

Runs the flagship WidebandPulsarPipeline on one GPU: DM=500, 16 MHz total
band (64 x 250 kHz channels), dual polarization, a drifting polyco fold,
from packed 8-bit samples decoded inside the step — BASELINE.json's
north-star configuration.  The input block is generated on the device
outside the timed loop; every timed dispatch runs 64 pipeline steps and
ends in ``block_until_ready``.

Prints ONE json line:
  value       = complex baseband samples processed per second
                (valid output samples x channels x polarizations / time)
  vs_baseline = value / (10x real time for the 16 MHz dual-pol band)
                = value / 3.2e8
  device      = JAX's platform, device kind and count, and nvidia-smi's
                card name and power limit

Exits non-zero without a GPU.
"""

import json
import os
import time


ROOT = os.path.dirname(os.path.abspath(__file__))


def b1937_polyco():
    """Synthetic single-entry polyco with B1937+21-like spin parameters:
    the flagship folds a *drifting* phase model (the per-block (i0, p, q)
    re-encoding of models/foldmodel.py), not a fixed rational period."""
    from baseband_tasks_tpu.phases import Polyco, PolycoPhase
    f0 = 641.928123
    # ~0.5 cycle/min^2 apparent quadratic drift (Doppler-scale)
    text = ("B1937+21    9-AUG-18  120000.00   58000.00000000000"
            "            71.019700              0.000000   0.000\n"
            f"123456789.321700  {f0:.12E}   ao  1440    3   1400.000\n"
            "0.00000000000000000D+00 0.00000000000000000D+00 "
            "5.00000000000000000D-01\n").replace("E+", "D+")
    return PolycoPhase(Polyco(text))


def flagship_pipeline(detect="power"):
    """The flagship WidebandPulsarPipeline on one device."""
    from baseband_tasks_tpu.models import WidebandPulsarPipeline
    from baseband_tasks_tpu.utils import Time, units as u
    return WidebandPulsarPipeline(
        n_chan=64, n_pol=2, dm=500.0, freq_center=1400 * u.MHz,
        chan_rate=250 * u.kHz, period_samples=(160000, 3), n_phase=64,
        block_samples=1 << 17, phase_model=b1937_polyco(),
        start_time=Time.from_mjd(58000.0), detect=detect)


def measure(pipe, ingest_bits=8, n_iter=64, repeats=3):
    """Samples/s of ``pipe.run_fn(n_iter, ingest_bits)`` over ``repeats``
    timed dispatches after one warm-up."""
    import jax
    run = pipe.run_fn(n_iter, ingest_bits=ingest_bits)
    jax.block_until_ready(run(1))
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = run(1)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / repeats
    return n_iter * pipe.block_samples * pipe.n_chan * pipe.n_pol / dt


def main():
    from baseband_tasks_tpu.utils.runtime import (
        configure_compile_cache, device_summary, gpu_name_and_power_limit,
        require_gpu)
    configure_compile_cache(ROOT)
    require_gpu()
    rate = measure(flagship_pipeline(), ingest_bits=8)
    realtime_x10 = 10.0 * (64 * 250e3) * 2
    print(json.dumps({
        "metric": "baseband samples/sec/GPU (coherent dedisperse+detect"
                  "+fold, DM=500, 16 MHz x 2 pol, from packed 8-bit "
                  "baseband)",
        "value": rate,
        "unit": "samples/s",
        "vs_baseline": rate / realtime_x10,
        "device": dict(device_summary(),
                       nvidia_smi=gpu_name_and_power_limit()),
    }))


if __name__ == "__main__":
    main()
