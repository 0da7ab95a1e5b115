"""VDIF (VLBI Data Interchange Format) stream reader/writer.

The reference framework reads raw telescope data through the external
``baseband`` package (SURVEY.md §1 L0); that package is not available
here, so this module provides a self-contained VDIF implementation
covering the common cases: little-endian 32-byte headers (VDIF v0/v1),
one or more threads (e.g. polarizations), 2/4/8/16/32 bits per component,
real or complex samples, decoded through the native LUT unpacker.

Format reference: the public VDIF specification (vlbi.org), v1.1.

Header words (little-endian u32):
  w0: seconds-from-epoch (30) | legacy (1) | invalid (1)
  w1: frame number in second (24) | ref epoch (6, half-years since 2000)
  w2: frame length / 8 incl. header (24) | log2 nchan (5) | version (3)
  w3: station (16) | thread id (10) | bits-1 (5) | complex (1)
  w4..w7: extended user data (zeroed here)
"""

from __future__ import annotations

import os

import numpy as np

from ..base import Base
from ..utils import Time, units as u
from .. import native

__all__ = ["open", "VDIFStreamReader", "VDIFStreamWriter"]

HEADER_BYTES = 32


def _ref_epoch_time(epoch):
    """VDIF reference epoch -> Time (half-years since 2000-01-01)."""
    year = 2000 + epoch // 2
    month = 1 if epoch % 2 == 0 else 7
    return Time(f"{year:04d}-{month:02d}-01T00:00:00.0", scale="utc")


def _time_to_epoch_seconds(t):
    """Time -> (ref_epoch, whole seconds since it)."""
    for epoch in range(63, -1, -1):
        e0 = _ref_epoch_time(epoch)
        if t >= e0:
            dt = (t - e0).sec
            return epoch, int(round(dt))
    raise ValueError("time before VDIF epoch range")


def _parse_header(raw):
    w = np.frombuffer(raw, dtype="<u4", count=8)
    return {
        "invalid": bool(w[0] >> 31),
        "legacy": bool((w[0] >> 30) & 1),
        "seconds": int(w[0] & 0x3FFFFFFF),
        "epoch": int((w[1] >> 24) & 0x3F),
        "frame_nr": int(w[1] & 0xFFFFFF),
        "frame_len8": int(w[2] & 0xFFFFFF),
        "lg2_nchan": int((w[2] >> 24) & 0x1F),
        "version": int(w[2] >> 29),
        "station": int(w[3] & 0xFFFF),
        "thread": int((w[3] >> 16) & 0x3FF),
        "bps": int(((w[3] >> 26) & 0x1F) + 1),
        "complex": bool(w[3] >> 31),
    }


def _build_header(seconds, frame_nr, epoch, frame_len8, lg2_nchan, thread,
                  bps, complex_data, station=0):
    w = np.zeros(8, dtype="<u4")
    w[0] = seconds & 0x3FFFFFFF
    w[1] = (frame_nr & 0xFFFFFF) | ((epoch & 0x3F) << 24)
    w[2] = (frame_len8 & 0xFFFFFF) | ((lg2_nchan & 0x1F) << 24)
    w[3] = (station & 0xFFFF) | ((thread & 0x3FF) << 16) \
        | (((bps - 1) & 0x1F) << 26) | (int(complex_data) << 31)
    return w.tobytes()


def _decode_payload(payload, bps, n_comp):
    if bps == 8:
        comp = native.unpack_8bit(np.frombuffer(payload, np.uint8))
    elif bps == 4:
        comp = native.unpack_4bit(np.frombuffer(payload, np.uint8))
    elif bps == 2:
        from .hdf5 import _TWO_BIT_LEVELS
        comp = native.unpack_2bit(np.frombuffer(payload, np.uint8),
                                  _TWO_BIT_LEVELS)
    elif bps == 16:
        comp = np.frombuffer(payload, "<u2").astype(np.float32) - 32767.5
    elif bps == 32:
        comp = np.frombuffer(payload, "<f4").astype(np.float32)
    else:
        raise ValueError(f"unsupported bits-per-sample {bps}")
    return comp[:n_comp]


def _encode_payload(comp, bps):
    if bps == 8:
        return np.clip(np.round(comp - 0.5) + 128, 0, 255
                       ).astype(np.uint8).tobytes()
    if bps == 4:
        vals = np.clip(np.round(comp - 0.5) + 8, 0, 15).astype(np.uint8)
        if vals.size % 2:
            vals = np.concatenate([vals, np.zeros(1, np.uint8)])
        return (vals[0::2] | (vals[1::2] << 4)).tobytes()
    if bps == 2:
        return native.pack_2bit(comp, np.array([-2.0, 0.0, 2.0],
                                               np.float32)).tobytes()
    if bps == 16:
        return (np.clip(np.round(comp - 0.5) + 32768, 0, 65535)
                .astype("<u2").tobytes())
    if bps == 32:
        return comp.astype("<f4").tobytes()
    raise ValueError(f"unsupported bits-per-sample {bps}")


class VDIFStreamReader(Base):
    """Stream head over a (possibly multi-thread) VDIF file.

    Threads become the last sample axis (one per polarization, say);
    channels within a frame the first.  Sample shape: (nchan, nthread),
    squeezed of length-1 axes.
    """

    def __init__(self, name, sample_rate=None):
        self._fh = open_file(name, "rb")
        try:
            self._init_from_file(sample_rate)
        except Exception:
            self._fh.close()
            self._fh = None
            raise

    def _init_from_file(self, sample_rate):
        first = _parse_header(self._fh.read(HEADER_BYTES))
        self._hdr0 = first
        frame_bytes = first["frame_len8"] * 8
        self._frame_bytes = frame_bytes
        payload_bytes = frame_bytes - (16 if first["legacy"] else 32)
        self._payload_bytes = payload_bytes
        nchan = 1 << first["lg2_nchan"]
        bps = first["bps"]
        factor = 2 if first["complex"] else 1
        spf = payload_bytes * 8 // (bps * nchan * factor)
        self._samples_per_frame_file = spf
        self._nchan = nchan
        self._bps = bps
        self._complex = first["complex"]

        # Index every frame header (seconds, frame_nr, thread) so frames
        # may appear in ANY order/interleaving in the file.
        size = os.fstat(self._fh.fileno()).st_size
        n_frames_total = size // frame_bytes
        scan = min(n_frames_total, 1 << 22)
        headers = []
        threads = set()
        max_frame_nr = 0
        seconds_seen = set()
        for k in range(scan):
            self._fh.seek(k * frame_bytes)
            h = _parse_header(self._fh.read(HEADER_BYTES))
            headers.append((h["seconds"], h["frame_nr"], h["thread"],
                            h["invalid"]))
            threads.add(h["thread"])
            seconds_seen.add(h["seconds"])
            max_frame_nr = max(max_frame_nr, h["frame_nr"])
        self._threads = sorted(threads)
        n_thread = len(self._threads)

        if sample_rate is None:
            # frames are numbered within each second, so the rate can only
            # be inferred when the file crosses a second boundary
            if len(seconds_seen) < 2:
                raise ValueError(
                    "file shorter than one second; pass sample_rate=")
            frames_per_sec = (max_frame_nr + 1)
            sample_rate = u.Quantity(frames_per_sec * spf, u.Hz)
        self._thread_index = {t: i for i, t in enumerate(self._threads)}
        fps = int(round(sample_rate.to_value(u.Hz) / spf))

        # first frame in time (not necessarily first in the file)
        sec0, fnr0 = min((s, f) for s, f, _, _ in headers)
        n_times = 0
        self._frame_locs = {}
        for k, (s, f, t, invalid) in enumerate(headers):
            time_idx = (s - sec0) * fps + (f - fnr0)
            # frames flagged invalid carry fill/junk payloads (standard
            # for drop-outs): zero-fill them exactly like missing frames
            if not invalid:
                self._frame_locs[(time_idx, self._thread_index[t])] = k
            n_times = max(n_times, time_idx + 1)
        frames_per_thread = n_times

        epoch_time = _ref_epoch_time(first["epoch"])
        start = epoch_time + u.Quantity(float(sec0), u.s) \
            + u.Quantity(fnr0 * spf / sample_rate.to_value(u.Hz), u.s)

        sample_shape = tuple(s for s in (nchan, n_thread) if s > 1)
        self._squeeze = (nchan, n_thread)
        dtype = np.complex64 if first["complex"] else np.float32
        super().__init__(
            shape=(frames_per_thread * spf,) + sample_shape,
            start_time=start, sample_rate=sample_rate,
            samples_per_frame=spf, dtype=dtype)

    def _read_frame(self, frame_index):
        nchan, n_thread = self._squeeze
        spf = self._samples_per_frame_file
        out = np.zeros((spf, nchan, n_thread),
                       np.complex64 if self._complex else np.float32)
        header_len = 16 if self._hdr0["legacy"] else 32
        for ti in range(n_thread):
            loc = self._frame_locs.get((frame_index, ti))
            if loc is None:
                continue  # missing frame: stays zero (invalid data)
            self._fh.seek(loc * self._frame_bytes + header_len)
            payload = self._fh.read(self._payload_bytes)
            factor = 2 if self._complex else 1
            comp = _decode_payload(payload, self._bps,
                                   spf * nchan * factor)
            if self._complex:
                pair = comp.reshape(spf, nchan, 2)
                out[:, :, ti] = pair[..., 0] + 1j * pair[..., 1]
            else:
                out[:, :, ti] = comp.reshape(spf, nchan)
        shape = (spf,) + self.sample_shape
        return out.reshape(shape)

    # -- packed-payload ingest (device-side decode) -----------------------
    # The eager path above decodes on the host (native LUT); production
    # ingest wants the raw payload bits shipped to the device and decoded
    # inside the compiled pipeline (ops/unpack_device.py) — 4-16x fewer
    # bytes over the link and zero host decode (the reference's
    # bps-encoded HDF5 payloads put decode inside the pipeline too,
    # reference io/hdf5/payload.py:164-178).

    @property
    def packed_alignment(self):
        """Samples per packed unit: reads must be frame-aligned."""
        return self._samples_per_frame_file

    def read_packed(self, offset, count):
        """Raw payloads for samples [offset, offset+count) as a packed
        pytree ``(carrier, mask)``.

        carrier : (n_frames, n_thread, payload_bytes//4) uint32
            The payload bytes, bit-for-bit (little-endian words).
        mask : (n_frames, n_thread) float32
            1 where the frame is present and valid, 0 for missing or
            invalid frames (the decoded samples are zero there, exactly
            like the host path's zero fill).

        Host work is pure file I/O — no decode, no samplewise pass.
        """
        spf = self._samples_per_frame_file
        if offset % spf or count % spf:
            raise ValueError(
                f"packed reads must be frame-aligned: offset {offset} "
                f"and count {count} must be multiples of {spf}")
        f0, n_frames = offset // spf, count // spf
        n_thread = len(self._threads)
        words = self._payload_bytes // 4
        carrier = np.zeros((n_frames, n_thread, words), np.uint32)
        mask = np.zeros((n_frames, n_thread), np.float32)
        header_len = 16 if self._hdr0["legacy"] else 32
        for fi in range(n_frames):
            for ti in range(n_thread):
                loc = self._frame_locs.get((f0 + fi, ti))
                if loc is None:
                    continue
                self._fh.seek(loc * self._frame_bytes + header_len)
                payload = self._fh.read(self._payload_bytes)
                carrier[fi, ti] = np.frombuffer(payload, "<u4")
                mask[fi, ti] = 1.0
        return carrier, mask

    def packed_decode_fn(self):
        """Jittable ``decode((carrier, mask)) -> samples``: the device
        counterpart of :meth:`_read_frame`'s host decode, bit-exact
        against it (tests/test_packed_ingest.py)."""
        from ..ops import unpack_device as ud

        spf = self._samples_per_frame_file
        nchan, n_thread = self._squeeze
        cplx = self._complex
        bps = self._bps
        if bps == 8:
            unpack = ud.unpack_8bit_device
        elif bps == 4:
            unpack = ud.unpack_4bit_device
        elif bps == 2:
            from .hdf5 import _TWO_BIT_LEVELS

            def unpack(x):
                return ud.unpack_2bit_device(x, _TWO_BIT_LEVELS)
        elif bps == 16:
            unpack = ud.unpack_16bit_device
        elif bps == 32:
            unpack = ud.f32_payload_device
        else:
            raise ValueError(f"unsupported bits-per-sample {bps}")
        factor = 2 if cplx else 1
        keep = tuple(slice(None) if s > 1 else 0
                     for s in (nchan, n_thread))

        def decode(packed):
            import jax
            import jax.numpy as jnp

            carrier, mask = packed
            comp = unpack(carrier)
            n_frames = comp.shape[0]
            comp = comp * mask[:, :, None]
            if cplx:
                pair = comp.reshape(n_frames, n_thread, spf, nchan, 2)
                x = jax.lax.complex(pair[..., 0], pair[..., 1])
            else:
                x = comp.reshape(n_frames, n_thread, spf, nchan)
            x = jnp.moveaxis(x, 1, -1)          # (F, spf, nchan, thread)
            x = x.reshape((n_frames * spf, nchan, n_thread))
            return x[(slice(None),) + keep]

        return decode

    def close(self):
        super().close()
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None


class VDIFStreamWriter:
    """Write a stream to VDIF frames (one thread per trailing axis entry)."""

    def __init__(self, name, template, *, bps=8, samples_per_frame=None,
                 station=0, nthread=None):
        self._fh = None   # open last, after all validation
        self._bps = bps
        self._station = station
        shape = template.shape
        self._complex = template.dtype.kind == "c"
        # interpret sample shape as (nchan, nthread) / (n,) / ().  A 2-d
        # shape is ambiguous (the reader squeezes both multi-channel
        # single-thread and single-channel multi-thread files to 2-d):
        # default to channels — the frequency axis, which must survive a
        # read->write round trip — and let ``nthread`` select threads.
        if len(shape) == 1:
            self._nchan, self._nthread = 1, 1
        elif len(shape) == 2:
            if nthread is not None and nthread != 1:
                if shape[1] != nthread:
                    raise ValueError(f"template axis {shape[1]} != "
                                     f"nthread {nthread}")
                self._nchan, self._nthread = 1, shape[1]
            else:
                self._nchan, self._nthread = shape[1], 1
        else:
            self._nchan, self._nthread = shape[1], shape[2]
        if self._nchan & (self._nchan - 1):
            raise ValueError(
                f"VDIF requires a power-of-two channel count, got "
                f"{self._nchan}; pad channels or split threads")
        rate = template.sample_rate.to_value(u.Hz)
        epoch, sec0 = _time_to_epoch_seconds(template.start_time)
        e0 = _ref_epoch_time(epoch)
        # exact two-double seconds from the reference epoch (a single
        # float loses ~1e-8 s at decade-scale offsets)
        hi, lo = (template.start_time - e0).sec_pair
        frac = (hi - sec0) + lo
        offset_samples = int(round(frac * rate))
        if samples_per_frame is None:
            # the frame size must divide the sample rate (integer frames
            # per second) AND the start offset (frame-aligned start)
            import math
            g = math.gcd(int(round(rate)),
                         offset_samples if offset_samples else
                         int(round(rate)))
            samples_per_frame = min(1024, g)
            while samples_per_frame > 1 and g % samples_per_frame:
                samples_per_frame -= 1
        if rate % samples_per_frame or \
                offset_samples % samples_per_frame:
            raise ValueError(
                f"samples_per_frame {samples_per_frame} must divide the "
                f"sample rate and the start offset within the second")
        self._spf = samples_per_frame
        self._rate = rate
        factor = 2 if self._complex else 1
        payload_bits = samples_per_frame * self._nchan * bps * factor
        if payload_bits % 64:
            raise ValueError("frame payload must be a multiple of 8 bytes")
        self._payload_bytes = payload_bits // 8
        self._frame_len8 = (self._payload_bytes + 32) // 8
        self._epoch, self._sec0 = epoch, sec0
        self._frame0 = offset_samples // samples_per_frame
        self._frames_per_sec = int(round(rate / samples_per_frame))
        self._counter = 0
        self._buffer = np.zeros((0, self._nchan, self._nthread),
                                np.complex64 if self._complex
                                else np.float32)
        self._fh = open_file(name, "wb")

    def write(self, data):
        data = np.asarray(data)
        data = data.reshape(len(data), self._nchan, self._nthread)
        self._buffer = np.concatenate([self._buffer, data])
        while len(self._buffer) >= self._spf:
            self._emit(self._buffer[:self._spf])
            self._buffer = self._buffer[self._spf:]

    def _emit(self, block):
        abs_frame = self._frame0 + self._counter
        seconds = self._sec0 + abs_frame // self._frames_per_sec
        frame_nr = abs_frame % self._frames_per_sec
        lg2 = int(self._nchan).bit_length() - 1
        for t in range(self._nthread):
            hdr = _build_header(seconds, frame_nr, self._epoch,
                                self._frame_len8, lg2, t, self._bps,
                                self._complex, self._station)
            x = block[:, :, t]
            if self._complex:
                comp = np.stack([x.real, x.imag], axis=-1).reshape(-1)
            else:
                comp = x.reshape(-1)
            self._fh.write(hdr)
            self._fh.write(_encode_payload(comp.astype(np.float32),
                                           self._bps))
        self._counter += 1

    def close(self):
        if self._fh is not None:
            if len(self._buffer):
                # flush the tail as a zero-padded final frame rather than
                # silently truncating a non-frame-multiple stream
                import warnings
                n = len(self._buffer)
                warnings.warn(
                    f"zero-padding final VDIF frame: {n} buffered samples "
                    f"< samples_per_frame={self._spf}")
                pad = np.zeros((self._spf - n,) + self._buffer.shape[1:],
                               self._buffer.dtype)
                self._emit(np.concatenate([self._buffer, pad]))
                self._buffer = self._buffer[:0]
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def open_file(name, mode="rb"):
    import builtins
    return builtins.open(name, mode)


def open(name, mode="r", **kwargs):
    """Open a VDIF file: 'r' -> stream reader, 'w' -> writer
    (needs ``template=``)."""
    if mode == "r":
        return VDIFStreamReader(name, **kwargs)
    if mode == "w":
        return VDIFStreamWriter(name, **kwargs)
    raise ValueError(f"unknown mode {mode!r}")
