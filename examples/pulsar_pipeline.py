"""End-to-end example: simulate, record, dedisperse, fold, write PSRFITS.

Run on CPU:  JAX_PLATFORMS=cpu python examples/pulsar_pipeline.py
(on a GPU host just run it plainly; the stream API is backend
agnostic).
"""

import os
import tempfile

import numpy as np

import jax
import jax.numpy as jnp

from baseband_tasks_tpu import (Channelize, Dedisperse, Disperse, Fold,
                                SetAttribute, Square, StreamGenerator)
from baseband_tasks_tpu.io import hdf5, psrfits
from baseband_tasks_tpu.phases import Polyco, PolycoPhase
from baseband_tasks_tpu.utils import Time, units as u


def main():
    t0 = Time("2020-06-01T00:00:00.000000000")
    rate = 1 * u.MHz
    period_samples = 1000          # 1 kHz pulsar at 1 MHz sampling
    n = 1 << 19

    # --- simulate a pulsar: periodic pulses + noise, then disperse ------
    def pulsar(sh):
        o = sh.tell()
        m = min(sh.samples_per_frame, sh.shape[0] - o)
        i = jnp.arange(o, o + m)
        key = jax.random.fold_in(jax.random.key(42), o)
        noise = jax.random.normal(key, (m, 2)) * 0.05
        pulse = jnp.where(i % period_samples == 350, 5.0, 0.0)
        return (noise[:, 0] + 1j * noise[:, 1] + pulse).astype(jnp.complex64)

    sky = SetAttribute(
        StreamGenerator(pulsar, (n,), t0, rate, samples_per_frame=1 << 17,
                        dtype=np.complex64),
        frequency=600 * u.MHz, sideband=1)
    telescope = Disperse(sky, dm=5.0)      # the ISM disperses the signal

    # --- record 2-bit voltages to HDF5, reopen ---------------------------
    workdir = tempfile.mkdtemp()
    raw_path = os.path.join(workdir, "voltages.h5")
    with hdf5.open(raw_path, "w", template=telescope, bps=2) as fw:
        fw.write(np.asarray(telescope.read()))
    recorded = hdf5.open(raw_path)
    print("recorded:", recorded.shape, recorded.bps, "bit,",
          recorded.start_time.isot)

    # --- dedisperse and fold with a polyco phase model -------------------
    tmid = t0.mjd
    f0 = rate.to_value(u.Hz) / period_samples
    polyco_text = (
        f"FAKEPSR     1-JUN-20  000000.00   {tmid:.11f}  5.0 0.0 0.0\n"
        f"0.000000  {f0:.12E}   xx  1440    1   600.000\n"
        "0.00000000000000000D+00\n").replace("E+", "D+")
    phase = PolycoPhase(Polyco(polyco_text))

    dedispersed = Dedisperse(recorded, dm=5.0)
    folded = Fold(Square(dedispersed), 64, phase, step=0.1 * u.s)
    profiles = np.asarray(folded.read())
    print("profiles:", profiles.shape,
          "peak bin:", int(np.argmax(profiles.mean(axis=0))))

    # --- write fold-mode PSRFITS ----------------------------------------
    fits_path = os.path.join(workdir, "fold.fits")
    with psrfits.open(fits_path, "w", template=folded, source="FAKEPSR",
                      telescope="GBT") as fw:
        fw.write(profiles)
    back = psrfits.open(fits_path)
    print("psrfits:", back.shape, back.source,
          "| start:", back.start_time.isot)


if __name__ == "__main__":
    main()
