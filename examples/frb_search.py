"""FRB single-pulse search: simulate a dispersed burst, build the
channelized power stream with library tasks, then sweep a DM trial bank
with :class:`models.DMTrialSearch` (the whole bank is one matmul in the
Fourier domain) and matched-filter for the burst.

The pipeline (mirrors a real search backend):

  complex voltage band (simulated burst + noise)
    -> Disperse(dm_true)          physical dispersion in the voltage data
    -> Channelize(n_chan)         filterbank
    -> Square                     detected power
    -> DMTrialSearch.detect       trial-DM sweep + boxcar S/N

Run on CPU:  JAX_PLATFORMS=cpu python examples/frb_search.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import jax

if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

from baseband_tasks_tpu import (Channelize, Disperse, Noise,
                                SetAttribute, Square, StreamGenerator)
from baseband_tasks_tpu.models import DMTrialSearch
from baseband_tasks_tpu.utils import Time, units as u

T0 = Time("2021-03-01T00:00:00.0")
RATE = 16 * u.MHz
N_CHAN = 128
DM_TRUE = 26.7
BURST_AT = 200_000         # raw sample index of the burst


def make_band(seed=42):
    """Noise plus one ~40-sigma, few-sample-wide burst.

    The burst depends on absolute stream position, so it lives in the
    source generator (which sees ``fh.tell()``), not in a Task.
    """
    noise = Noise(seed)

    def burst(fh):
        data = noise(fh)
        i0 = fh.tell()
        idx = np.arange(i0, i0 + len(data), dtype=np.float64)
        amp = 40.0 * np.exp(-0.5 * ((idx - BURST_AT) / 3.0) ** 2)
        return data + amp.astype(np.float32)

    gen = StreamGenerator(burst, (1 << 19,), T0, RATE,
                          samples_per_frame=1 << 15, dtype=np.complex64)
    return SetAttribute(gen, frequency=800 * u.MHz, sideband=1)


def main():
    # physical dispersion, then a filterbank
    dispersed = Disperse(make_band(), DM_TRUE)
    power = Square(Channelize(dispersed, N_CHAN))

    # DM-trial sweep over the detected filterbank
    search = DMTrialSearch(power.frequency.reshape(-1), power.sample_rate,
                           dms=np.linspace(0, 60, 121),
                           n_time=int(power.shape[0]))
    power.seek(0)
    block = np.asarray(power.read(search.n_time))
    snr, width = search.detect(block)

    best = np.unravel_index(np.argmax(snr), snr.shape)
    t_best, dm_best = int(best[0]), float(search.dms[best[1]].value)
    print(f"peak S/N {snr[best]:.1f} at trial DM {dm_best:.1f} pc/cm^3, "
          f"boxcar {int(width[best])} samp, "
          f"t = {t_best} filterbank samples")
    # Where the burst should appear: the trial bank dedisperses to its
    # reference (the highest channel), where the dispersed burst arrives
    # time_delay(ref, band_center) earlier than the injected sample;
    # Disperse also trims pad_start raw samples from the stream front.
    from baseband_tasks_tpu import DispersionMeasure
    shift = (DispersionMeasure(DM_TRUE)
             .time_delay(search.reference_frequency, 800 * u.MHz)
             .to_value(u.s)) * RATE.to_value(u.Hz)
    expected_t = int((BURST_AT + shift - dispersed.pad_start) / N_CHAN)
    assert abs(dm_best - DM_TRUE) <= 1.0, (dm_best, DM_TRUE)
    assert abs(t_best - expected_t) < 40, (t_best, expected_t)
    print("burst recovered at the true DM and arrival time - OK")


if __name__ == "__main__":
    main()
