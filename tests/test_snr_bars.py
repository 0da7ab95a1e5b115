"""The BASELINE.json correctness bar, asserted as SNR.

"Match reference outputs within 60 dB SNR": each reversible pipeline
round-trips white noise at its recommended sizing and the residual
power must sit >= 60 dB below the signal power.  The measured SNRs are
printed by chip_smoke.py on the card.

SNR here = 10 log10( mean|signal|^2 / mean|out - signal|^2 ).
"""

import numpy as np
import pytest

from baseband_tasks_tpu import (Channelize, Dechannelize, Dedisperse,
                                Disperse, InversePolyphaseFilterBank,
                                NoiseGenerator, PolyphaseFilterBank,
                                Resample, SetAttribute, ShiftAndResample,
                                sinc_hamming)
from baseband_tasks_tpu.utils import Time, units as u

T0 = Time.from_mjd(58000.0)


def snr_db(out, ref):
    err = np.mean(np.abs(out - ref) ** 2)
    sig = np.mean(np.abs(ref) ** 2)
    return 10 * np.log10(sig / err) if err > 0 else np.inf


def cnoise(shape, seed, rate=1 * u.MHz, spf=None):
    return NoiseGenerator(shape=shape, start_time=T0, sample_rate=rate,
                          samples_per_frame=spf or min(shape[0], 1 << 14),
                          seed=seed)


class TestSixtyDBBars:
    def test_channelize_dechannelize(self):
        src = cnoise((1 << 15,), 1)
        raw = np.asarray(src.read())
        src.seek(0)
        back = Dechannelize(Channelize(src, 256))
        out = np.asarray(back.read(back.shape[0]))
        s = snr_db(out, raw[:out.shape[0]])
        assert s >= 60, s  # measured: float-roundoff level (>120 dB)

    def test_disperse_dedisperse(self):
        """Coherent dispersion round trip at the production window size.

        The chirp's phase is discontinuous at the (per-channel) Nyquist
        wrap, so its impulse-response tails flatten at a ~1/N floor:
        the overlap-save ghost power on white noise is margin-
        INDEPENDENT and falls only ~3 dB per window doubling (verified
        against a float64 direct overlap-save, which this implementation
        matches at 129 dB — the floor is the algorithm's, inherited from
        the reference, not an implementation artifact).  The recommended
        sizing is therefore the production one: 2^18-2^19-sample pow2
        windows, which sit at/above 60 dB.
        """
        n_chan = 8
        freq = (400 + (np.arange(n_chan) - n_chan / 2) * 0.25) * u.MHz
        src = SetAttribute(cnoise((1 << 20, n_chan), 2, rate=250 * u.kHz,
                                  spf=1 << 18),
                           frequency=freq, sideband=1)
        raw = np.asarray(src.read())
        src.seek(0)
        dis = Disperse(src, 10.0, samples_per_frame=1 << 19)
        ded = Dedisperse(dis, 10.0, samples_per_frame=1 << 19)
        n = 1 << 19
        out = np.asarray(ded.read(n))
        # output sample k is raw sample k + lead (start_time bookkeeping)
        lead = int(round(float((ded.start_time - T0).sec) * 250e3))
        s = snr_db(out, raw[lead:lead + n])
        assert s >= 60, s

    def test_pfb_inverse(self):
        # clean-stream recommended sizing: 128-block pads, sn matched to
        # the actual (noiseless) stream quality.  Low sn (10-30) is the
        # recommendation for DIGITIZED data, where the Wiener gain
        # deliberately suppresses low-|H| bins below the quantization
        # noise — a lossy trade by design (reference pfb.py:170-181).
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        src = cnoise((1 << 16,), 3)
        raw = np.asarray(src.read())
        src.seek(0)
        inv = InversePolyphaseFilterBank(
            PolyphaseFilterBank(src, h), h, sn=1e3,
            pad_start=128, pad_end=128, dtype=np.complex64)
        out = np.asarray(inv.read(4096))
        lead = int(round(float((inv.start_time - T0).sec) * 1e6))
        s = snr_db(out, raw[lead:lead + 4096])
        assert s >= 60, s

    def test_pfb_inverse_high_sn(self):
        # with a clean (undigitized) stream, sn=1e4 recovers ~100 dB
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        src = cnoise((1 << 16,), 4)
        raw = np.asarray(src.read())
        src.seek(0)
        inv = InversePolyphaseFilterBank(
            PolyphaseFilterBank(src, h), h, sn=1e4,
            pad_start=128, pad_end=128, dtype=np.complex64)
        out = np.asarray(inv.read(4096))
        lead = int(round(float((inv.start_time - T0).sec) * 1e6))
        s = snr_db(out, raw[lead:lead + 4096])
        assert s >= 90, s

    def test_resample_roundtrip(self):
        # shift by a fractional sample and back (pad=128: the default 64
        # gives ~0.1% amplitude accuracy = right at the 60 dB bar,
        # reference sampling.py:108-109)
        src = cnoise((1 << 15,), 5)
        raw = np.asarray(src.read())
        src.seek(0)
        fwd = ShiftAndResample(src, 0.3125, pad=128,
                               samples_per_frame=4096)
        back = ShiftAndResample(fwd, -0.3125, pad=128,
                                samples_per_frame=4096)
        n = back.shape[0] - 64
        out = np.asarray(back.read(n))
        lead = int(round(float((back.start_time - T0).sec) * 1e6))
        s = snr_db(out, raw[lead:lead + n])
        assert s >= 60, s


    def test_pfb_inverse_high_sn_pallas(self):
        # the Wiener deconvolution must keep the high-S/N
        # reconstruction bar (>= 90 dB) at 128-spectra pads
        n, n_tap = 32, 4
        h = sinc_hamming(n_tap, n)
        src = cnoise((1 << 16,), 7)
        raw = np.asarray(src.read())
        src.seek(0)
        inv = InversePolyphaseFilterBank(
            PolyphaseFilterBank(src, h), h, sn=1e4,
            pad_start=128, pad_end=128, dtype=np.complex64)
        out = np.asarray(inv.read(4096))
        lead = int(round(float((inv.start_time - T0).sec) * 1e6))
        s = snr_db(out, raw[lead:lead + 4096])
        assert s >= 90, s
