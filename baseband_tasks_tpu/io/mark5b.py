"""Mark 5B (VLBI disk recorder) stream reader/writer.

The reference framework reads Mark 5B recordings through the external
``baseband`` package (SURVEY.md §1 L0); that package is not available
here, so this module provides a self-contained implementation of the
common cases: 1/2/4/8-bit real samples, any power-of-two channel count
with nchan·bps <= 32 bit-streams, frame gaps zero-filled.

Format reference: the public Mark 5B design specification (Haystack
Mark 5 memo series) and the mark5access decoder conventions.

Frame = 16-byte header + 10000-byte payload (2500 little-endian 32-bit
words).  Header words (little-endian u32):

  w0: sync word 0xABADDEED
  w1: user-specified (16) | tvg flag (1) | frame number in second (15)
  w2: BCD time code 'JJJSSSSS' (day-of-MJD mod 1000, seconds in day)
  w3: BCD fractional seconds .xxxx (0.1 ms units, 16) | CRC-16 (16)

The CRC-16 is the VLBA time-code check (polynomial x^16+x^12+x^5+1)
over the preceding 48 bits (w2 and the BCD half of w3); it is written
on output and ignored on input (the sync word is the integrity check,
as in mark5access).

The header carries neither nchan nor bps, and the 3-digit day is
ambiguous by 1000 days: readers must pass ``nchan`` (and ``bps`` if not
2), plus ``ref_time=`` or ``kday=`` to pin the millennium-day era.

Payload bit layout: channel-fastest ``bps``-bit fields packed LSB-first
into each 32-bit word.  2-bit samples use the sign-magnitude VLBA
convention (code 0,1,2,3 -> -3.3359, +1, -1, +3.3359 — mark5access
``lut4level``), unlike VDIF's monotonic offset binary; 4/8-bit samples
are offset binary.
"""

from __future__ import annotations

import os

import numpy as np

from ..base import Base
from ..utils import Time, units as u
from .. import native

__all__ = ["open", "Mark5BStreamReader", "Mark5BStreamWriter"]

HEADER_BYTES = 16
PAYLOAD_BYTES = 10000
FRAME_BYTES = HEADER_BYTES + PAYLOAD_BYTES
SYNC = 0xABADDEED

#: mark5access lut4level: 2-bit code -> value (sign-magnitude order)
M5B_2BIT_LEVELS = np.array([-3.3359, 1.0, -1.0, 3.3359], dtype=np.float32)

# 2-bit code remap between monotonic (sorted-level) codes, which
# native.pack_2bit emits, and the Mark5B wire codes: level order
# -3.3359 < -1 < 1 < 3.3359 is wire 0, 2, 1, 3.
_MONO_TO_WIRE = np.array([0, 2, 1, 3], dtype=np.uint8)
_BYTE_REMAP = np.empty(256, np.uint8)
for _b in range(256):
    _BYTE_REMAP[_b] = sum(
        int(_MONO_TO_WIRE[(_b >> (2 * _i)) & 3]) << (2 * _i)
        for _i in range(4))
del _b


def crc16_vlba(bits48):
    """CRC-16 (x^16+x^12+x^5+1) over a 48-bit integer, VLBA time-code
    convention (MSB first, zero-initialized register)."""
    reg = 0
    for k in range(47, -1, -1):
        bit = (bits48 >> k) & 1
        top = (reg >> 15) & 1
        reg = ((reg << 1) & 0xFFFF)
        if bit ^ top:
            reg ^= 0x1021
    return reg


def _bcd_encode(value, digits):
    out = 0
    for k in range(digits):
        out |= (value % 10) << (4 * k)
        value //= 10
    return out


def _bcd_decode(word, digits):
    out = 0
    for k in range(digits - 1, -1, -1):
        d = (word >> (4 * k)) & 0xF
        if d > 9:
            raise ValueError(f"invalid BCD digit {d:#x}")
        out = out * 10 + d
    return out


def _bcd_decode_vec(words, digits):
    """Vectorized :func:`_bcd_decode` over a uint32 array -> int64."""
    out = np.zeros(words.shape, dtype=np.int64)
    for k in range(digits - 1, -1, -1):
        d = (words >> np.uint32(4 * k)) & np.uint32(0xF)
        if np.any(d > 9):
            raise ValueError("invalid BCD digit in Mark5B time code")
        out = out * 10 + d
    return out


def _parse_header(raw):
    w = np.frombuffer(raw, dtype="<u4", count=4)
    if int(w[0]) != SYNC:
        raise ValueError(
            f"bad Mark5B sync word {int(w[0]):#010x} (expected "
            f"{SYNC:#010x})")
    return {
        "frame_nr": int(w[1] & 0x7FFF),
        "tvg": bool((w[1] >> 15) & 1),
        "user": int(w[1] >> 16),
        "bcd_jjjsssss": int(w[2]),
        "bcd_frac": int(w[3] >> 16),
        "crc": int(w[3] & 0xFFFF),
    }


def _build_header(frame_nr, day3, sec_in_day, frac_tenth_ms, user=0):
    w = np.zeros(4, dtype="<u4")
    w[0] = SYNC
    w[1] = (frame_nr & 0x7FFF) | ((user & 0xFFFF) << 16)
    w[2] = (_bcd_encode(day3, 3) << 20) | _bcd_encode(sec_in_day, 5)
    bcd_frac = _bcd_encode(frac_tenth_ms, 4)
    crc = crc16_vlba((int(w[2]) << 16) | bcd_frac)
    w[3] = (bcd_frac << 16) | crc
    return w.tobytes()


def _decode_payload(payload, bps, n_comp):
    raw = np.frombuffer(payload, np.uint8)
    if bps == 2:
        comp = native.unpack_2bit(raw, M5B_2BIT_LEVELS)
    elif bps == 1:
        bits = np.unpackbits(raw, bitorder="little")
        comp = bits.astype(np.float32) * 2.0 - 1.0
    elif bps == 4:
        comp = native.unpack_4bit(raw)
    elif bps == 8:
        comp = native.unpack_8bit(raw)
    else:
        raise ValueError(f"unsupported bits-per-sample {bps}")
    return comp[:n_comp]


def _encode_payload(comp, bps):
    if bps == 2:
        mono = np.asarray(native.pack_2bit(
            comp, np.array([-2.0, 0.0, 2.0], np.float32)), dtype=np.uint8)
        return _BYTE_REMAP[mono].tobytes()
    if bps == 1:
        bits = (comp > 0).astype(np.uint8)
        return np.packbits(bits, bitorder="little").tobytes()
    if bps == 4:
        vals = np.clip(np.round(comp - 0.5) + 8, 0, 15).astype(np.uint8)
        return (vals[0::2] | (vals[1::2] << 4)).tobytes()
    if bps == 8:
        return np.clip(np.round(comp - 0.5) + 128, 0, 255
                       ).astype(np.uint8).tobytes()
    raise ValueError(f"unsupported bits-per-sample {bps}")


def _resolve_kday(day3, ref_time, kday):
    """Full MJD day from the 3-digit header day + era information."""
    if kday is not None:
        if kday % 1000:
            raise ValueError(f"kday {kday} must be a multiple of 1000")
        return kday + day3
    if ref_time is None:
        raise ValueError(
            "Mark5B headers carry only day-of-MJD mod 1000; pass "
            "ref_time= (a Time within 500 days of the data) or kday= "
            "(the MJD millennium, e.g. 60000)")
    ref_mjd = float(ref_time.mjd)
    # nearest day with this 3-digit residue
    base = int(np.floor(ref_mjd)) - day3
    era = int(np.round(base / 1000.0)) * 1000
    return era + day3


class Mark5BStreamReader(Base):
    """Stream head over a Mark 5B file.

    Parameters
    ----------
    name : str or path
    nchan : int
        Channels per sample (power of two; the header does not record
        it).  Channels become the sample axis, squeezed when 1.
    bps : int
        Bits per sample (1, 2, 4 or 8; default 2).
    ref_time : Time, optional
        Any time within 500 days of the observation, to resolve the
        3-digit header day.  Alternative: ``kday``.
    kday : int, optional
        MJD millennium day (multiple of 1000, e.g. 60000).
    sample_rate : Quantity, optional
        Samples per second per channel; inferred from the frame count
        per second when the file crosses an integer second.
    """

    def __init__(self, name, nchan, bps=2, ref_time=None, kday=None,
                 sample_rate=None):
        self._fh = _open_file(name, "rb")
        try:
            self._init_from_file(int(nchan), int(bps), ref_time, kday,
                                 sample_rate)
        except Exception:
            self._fh.close()
            self._fh = None
            raise

    def _init_from_file(self, nchan, bps, ref_time, kday, sample_rate):
        if nchan < 1 or nchan & (nchan - 1):
            raise ValueError(f"nchan {nchan} must be a power of two")
        if nchan * bps > 32:
            raise ValueError(
                f"nchan*bps = {nchan * bps} exceeds the 32 bit-streams "
                f"of a Mark5B frame")
        self._nchan = nchan
        self._bps = bps
        spf = PAYLOAD_BYTES * 8 // (bps * nchan)
        self._samples_per_frame_file = spf

        size = os.fstat(self._fh.fileno()).st_size
        n_frames = size // FRAME_BYTES
        if n_frames < 1:
            raise ValueError("file shorter than one Mark5B frame")
        cap = 1 << 22
        n_scan = min(n_frames, cap)
        if n_frames > cap:
            import warnings
            warnings.warn(
                f"indexing only the first {cap} of {n_frames} Mark5B "
                f"frames; split the file to read the remainder")
        # One vectorized pass over the headers (memmap touches only the
        # header pages, not the 10000-byte payloads).
        mm = np.memmap(self._fh, dtype=np.uint8, mode="r",
                       shape=(n_scan, FRAME_BYTES))
        w = np.ascontiguousarray(mm[:, :HEADER_BYTES]).view("<u4") \
            .reshape(n_scan, 4)
        del mm
        bad = np.nonzero(w[:, 0] != SYNC)[0]
        if bad.size:
            raise ValueError(
                f"bad Mark5B sync word at frame {int(bad[0])} "
                f"({int(w[bad[0], 0]):#010x})")
        frame_nr = (w[:, 1] & 0x7FFF).astype(np.int64)
        day3 = _bcd_decode_vec(w[:, 2] >> 20, 3)
        sec = _bcd_decode_vec(w[:, 2] & 0xFFFFF, 5)
        # A file spanning a millennium-day wrap (999 -> 000) holds both
        # high and low day values; order the low ones as +1000.
        day_eff = np.where(day3 < 500, day3 + 1000, day3) \
            if int(day3.max()) - int(day3.min()) > 500 else day3
        key = (day_eff * 86400 + sec) * (1 << 15) + frame_nr
        k0 = int(np.argmin(key))
        day0, sec0, fnr0 = int(day_eff[k0]), int(sec[k0]), int(frame_nr[k0])
        mjd0 = _resolve_kday(int(day3[k0]), ref_time, kday)

        if sample_rate is None:
            if len(np.unique(day_eff * 86400 + sec)) < 2:
                raise ValueError(
                    "file shorter than one second; pass sample_rate=")
            frames_per_sec = int(frame_nr.max()) + 1
            sample_rate = u.Quantity(frames_per_sec * spf, u.Hz)
        fps = int(round(sample_rate.to_value(u.Hz) / spf))

        time_idx = ((day_eff - day0) * 86400 + (sec - sec0)) * fps \
            + (frame_nr - fnr0)
        self._frame_locs = {int(t): k for k, t in enumerate(time_idx)}
        n_times = int(time_idx.max()) + 1

        start = Time.from_mjd(mjd0, scale="utc") + u.Quantity(float(sec0), u.s) \
            + u.Quantity(fnr0 * spf / sample_rate.to_value(u.Hz), u.s)
        sample_shape = (nchan,) if nchan > 1 else ()
        super().__init__(
            shape=(n_times * spf,) + sample_shape, start_time=start,
            sample_rate=sample_rate, samples_per_frame=spf,
            dtype=np.float32)

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame_file
        loc = self._frame_locs.get(frame_index)
        if loc is None:  # gap: zero-fill, like a dropped disk frame
            return np.zeros((spf,) + self.sample_shape, np.float32)
        self._fh.seek(loc * FRAME_BYTES + HEADER_BYTES)
        comp = _decode_payload(self._fh.read(PAYLOAD_BYTES), self._bps,
                               spf * self._nchan)
        return comp.reshape((spf,) + self.sample_shape)

    # -- packed-payload ingest (device-side decode; see io/vdif.py) -------
    @property
    def packed_alignment(self):
        """Samples per packed unit: reads must be frame-aligned."""
        return self._samples_per_frame_file

    def read_packed(self, offset, count):
        """Raw payloads for [offset, offset+count) as ``(carrier, mask)``:
        carrier (n_frames, 2500) uint32 words of the 10000-byte
        payloads, mask (n_frames,) float32 presence flags (dropped frames
        decode to 0, exactly like the host path's zero fill)."""
        spf = self._samples_per_frame_file
        if offset % spf or count % spf:
            raise ValueError(
                f"packed reads must be frame-aligned: offset {offset} "
                f"and count {count} must be multiples of {spf}")
        f0, n_frames = offset // spf, count // spf
        carrier = np.zeros((n_frames, PAYLOAD_BYTES // 4), np.uint32)
        mask = np.zeros((n_frames,), np.float32)
        for fi in range(n_frames):
            loc = self._frame_locs.get(f0 + fi)
            if loc is None:
                continue
            self._fh.seek(loc * FRAME_BYTES + HEADER_BYTES)
            carrier[fi] = np.frombuffer(self._fh.read(PAYLOAD_BYTES),
                                        "<u4")
            mask[fi] = 1.0
        return carrier, mask

    def packed_decode_fn(self):
        """Jittable ``decode((carrier, mask)) -> samples``, bit-exact
        against :meth:`_read_frame`'s host LUT decode."""
        from ..ops import unpack_device as ud

        spf = self._samples_per_frame_file
        nchan = self._nchan
        bps = self._bps
        if bps == 8:
            unpack = ud.unpack_8bit_device
        elif bps == 4:
            unpack = ud.unpack_4bit_device
        elif bps == 2:
            def unpack(x):
                return ud.unpack_2bit_device(x, M5B_2BIT_LEVELS)
        elif bps == 1:
            unpack = ud.unpack_1bit_device
        else:
            raise ValueError(f"unsupported bits-per-sample {bps}")
        out_shape = (nchan,) if nchan > 1 else ()

        def decode(packed):
            carrier, mask = packed
            comp = unpack(carrier)               # (F, 80000/bps)
            comp = comp * mask[:, None]
            return comp.reshape((carrier.shape[0] * spf,) + out_shape)

        return decode

    def close(self):
        super().close()
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None


class Mark5BStreamWriter:
    """Write a real-valued stream as Mark 5B frames.

    The channel count comes from the template's sample shape (trailing
    axes are flattened); frames are fixed at 10000 payload bytes, so the
    per-channel ``samples_per_frame`` is ``80000 / (nchan * bps)`` and
    the sample rate must give an integer number of frames per second
    with the start time frame-aligned within its second.
    """

    def __init__(self, name, template, *, bps=2, user=0):
        self._fh = None   # open last, after all validation
        if template.dtype.kind == "c":
            raise ValueError("Mark5B holds real samples only; convert "
                             "with Real2Complex's inverse or write VDIF")
        shape = template.shape
        nchan = int(np.prod(shape[1:], dtype=int)) if len(shape) > 1 else 1
        if nchan & (nchan - 1):
            raise ValueError(f"nchan {nchan} must be a power of two")
        if nchan * bps > 32:
            raise ValueError(f"nchan*bps = {nchan * bps} > 32 bit-streams")
        self._nchan = nchan
        self._bps = bps
        self._user = user
        spf = PAYLOAD_BYTES * 8 // (bps * nchan)
        self._spf = spf
        rate = template.sample_rate.to_value(u.Hz)
        if rate % spf:
            raise ValueError(
                f"sample rate {rate} Hz is not a whole number of "
                f"{spf}-sample frames per second")
        self._frames_per_sec = int(round(rate / spf))
        if self._frames_per_sec > (1 << 15):
            raise ValueError(
                f"{self._frames_per_sec} frames/s overflows the 15-bit "
                f"frame counter; reduce the rate or bit-streams")
        mjd_hi, mjd_lo = template.start_time.mjd_pair
        day = int(np.floor(mjd_hi + mjd_lo))
        frac_day = (mjd_hi - day) + mjd_lo
        sec_f = frac_day * 86400.0
        sec = int(np.floor(sec_f + 0.5e-9))
        frame0_f = (sec_f - sec) * self._frames_per_sec
        frame0 = int(round(frame0_f))
        if abs(frame0_f - frame0) * spf > 1e-3:
            raise ValueError(
                "start time is not frame-aligned within its second; "
                "Resample or slice the stream to a frame boundary")
        self._day = day
        self._sec = sec
        self._frame0 = frame0
        self._counter = 0
        self._buffer = np.zeros((0, nchan), np.float32)
        self._fh = _open_file(name, "wb")

    def write(self, data):
        data = np.asarray(data, dtype=np.float32)
        data = data.reshape(len(data), self._nchan)
        self._buffer = np.concatenate([self._buffer, data])
        while len(self._buffer) >= self._spf:
            self._emit(self._buffer[:self._spf])
            self._buffer = self._buffer[self._spf:]

    def _emit(self, block):
        abs_frame = self._frame0 + self._counter
        extra_sec, frame_nr = divmod(abs_frame, self._frames_per_sec)
        day_extra, sec = divmod(self._sec + extra_sec, 86400)
        day3 = (self._day + day_extra) % 1000
        frac = int(round(frame_nr / self._frames_per_sec * 1e4))
        self._fh.write(_build_header(frame_nr, day3, sec, min(frac, 9999),
                                     self._user))
        self._fh.write(_encode_payload(block.reshape(-1), self._bps))
        self._counter += 1

    def close(self):
        if self._fh is not None:
            if len(self._buffer):
                import warnings
                n = len(self._buffer)
                warnings.warn(
                    f"zero-padding final Mark5B frame: {n} buffered "
                    f"samples < samples_per_frame={self._spf}")
                pad = np.zeros((self._spf - n, self._nchan), np.float32)
                self._emit(np.concatenate([self._buffer, pad]))
                self._buffer = self._buffer[:0]
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def _open_file(name, mode="rb"):
    import builtins
    return builtins.open(name, mode)


def open(name, mode="r", **kwargs):
    """Open a Mark 5B file: 'r' -> stream reader (needs ``nchan`` and an
    era hint), 'w' -> writer (needs ``template=``)."""
    if mode == "r":
        return Mark5BStreamReader(name, **kwargs)
    if mode == "w":
        return Mark5BStreamWriter(name, **kwargs)
    raise ValueError(f"unknown mode {mode!r}")
