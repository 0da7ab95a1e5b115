"""DADA (psrdada) single-file stream reader/writer.

The reference consumes DADA through its `baseband` dependency (the
`UseDADASample` test mixin, /root/reference/baseband_tasks/tests/common.py:
12-39); this framework reads the format natively.  A DADA file is a
fixed-size ASCII header ("KEY value" lines, HDR_SIZE bytes, typically
4096) followed by raw little-endian samples ordered
(time, polarization, channel), complex interleaved re/im when NDIM=2 —
the psrdada disk format.

Sample shape follows the baseband package convention: ``(npol, nchan)``
(length-1 axes squeezed).  NBIT 8 (two's-complement int8), 16 (int16)
and -32/32 (float32) payloads are supported.

Times: UTC_START (+ OBS_OFFSET bytes at TSAMP µs per sample) maps to the
two-double `utils.Time`; streams are seekable by absolute time like any
other node.
"""

from __future__ import annotations

import os

import numpy as np

from ..base import Base
from ..utils import Time, units as u

__all__ = ["DADAStreamReader", "DADAStreamWriter", "open"]

_DEFAULT_HDR_SIZE = 4096


def _parse_header(raw):
    hdr = {}
    for line in raw.decode("ascii", "replace").splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.split(None, 1)
        if len(parts) == 2:
            hdr[parts[0]] = parts[1].strip()
    return hdr


def _payload_dtype(nbit):
    if nbit in (32, -32):
        return np.dtype("<f4")
    if nbit == 16:
        return np.dtype("<i2")
    if nbit == 8:
        return np.dtype("i1")
    raise ValueError(f"unsupported NBIT {nbit} (supported: 8, 16, ±32)")


class DADAStreamReader(Base):
    """Stream head over a single DADA file."""

    def __init__(self, name, samples_per_frame=None):
        import builtins
        self._fh = builtins.open(name, "rb")
        try:
            self._init_from_file(samples_per_frame)
        except Exception:
            self._fh.close()
            self._fh = None
            raise

    def _init_from_file(self, samples_per_frame):
        probe = self._fh.read(_DEFAULT_HDR_SIZE)
        hdr = _parse_header(probe)
        hdr_size = int(hdr.get("HDR_SIZE", _DEFAULT_HDR_SIZE))
        if hdr_size > _DEFAULT_HDR_SIZE:
            hdr = _parse_header(probe + self._fh.read(
                hdr_size - _DEFAULT_HDR_SIZE))
        self._hdr = hdr
        self._hdr_size = hdr_size
        nbit = int(hdr.get("NBIT", 8))
        ndim = int(hdr.get("NDIM", 1))
        npol = int(hdr.get("NPOL", 1))
        nchan = int(hdr.get("NCHAN", 1))
        if ndim not in (1, 2):
            raise ValueError(f"NDIM {ndim} not supported")
        self._npol, self._nchan, self._ndim = npol, nchan, ndim
        self._raw_dtype = _payload_dtype(nbit)
        tsamp_us = float(hdr["TSAMP"])
        sample_rate = u.Quantity(1e6 / tsamp_us, u.Hz)
        frame_comp = npol * nchan * ndim
        self._bytes_per_sample = frame_comp * self._raw_dtype.itemsize

        size = os.fstat(self._fh.fileno()).st_size
        n = (size - hdr_size) // self._bytes_per_sample

        # UTC_START is yyyy-mm-dd-hh:mm:ss; normalize to ISO
        parts = hdr["UTC_START"].split("-")
        iso = "-".join(parts[:3]) + "T" + parts[3] if len(parts) == 4 \
            else hdr["UTC_START"]
        start = Time(iso, scale="utc")  # DADA UTC_START is UTC by name
        # PSRDADA convention: UTC_START holds whole seconds; fractional
        # starts ride in PICOSECONDS (psrdada dbdisk et al.)
        pico = float(hdr.get("PICOSECONDS", 0))
        if pico:
            start = start + u.Quantity(pico * 1e-12, u.s)
        offset_bytes = int(hdr.get("OBS_OFFSET", 0))
        off_samples = offset_bytes // self._bytes_per_sample
        start = start + u.Quantity(
            off_samples / sample_rate.to_value(u.Hz), u.s)

        dtype = np.dtype("c8") if ndim == 2 else np.dtype("f4")
        sample_shape = tuple(x for x in (npol, nchan) if x > 1)
        self._store_shape = (npol, nchan)
        spf = samples_per_frame or min(n, 1 << 16)
        freq = None
        sideband = None
        if "FREQ" in hdr and nchan >= 1:
            f0 = float(hdr["FREQ"])
            bw = float(hdr.get("BW", 0.0))
            if nchan > 1 and bw:
                chans = f0 + (np.arange(nchan) - (nchan - 1) / 2) \
                    * (bw / nchan)
                freq = u.Quantity(
                    np.broadcast_to(chans, sample_shape).copy(), u.MHz)
                sideband = np.where(bw > 0, 1, -1)
            else:
                freq = u.Quantity(f0, u.MHz)
                sideband = 1 if bw >= 0 else -1
        super().__init__(shape=(n,) + sample_shape, start_time=start,
                         sample_rate=sample_rate,
                         samples_per_frame=spf, dtype=dtype,
                         frequency=freq, sideband=sideband)

    @property
    def header(self):
        """The parsed DADA header (dict of strings)."""
        return dict(self._hdr)

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        start = frame_index * spf
        stop = min(start + spf, self._shape[0])
        count = stop - start
        self._fh.seek(self._hdr_size + start * self._bytes_per_sample)
        raw = np.frombuffer(
            self._fh.read(count * self._bytes_per_sample),
            self._raw_dtype)
        comps = raw.astype(np.float32).reshape(
            (count,) + self._store_shape + (self._ndim,))
        if self._ndim == 2:
            data = comps[..., 0] + 1j * comps[..., 1]
        else:
            data = comps[..., 0]
        return data.reshape((count,) + self.sample_shape).astype(
            self._dtype)

    # -- packed-payload ingest (device-side decode; see io/vdif.py) -------
    @property
    def packed_alignment(self):
        """Samples per packed unit: the smallest run whose payload is a
        whole number of 32-bit carrier words."""
        import math
        return 4 // math.gcd(self._bytes_per_sample, 4)

    def read_packed(self, offset, count):
        """Raw payload bytes for [offset, offset+count) as uint32 words
        of shape (count*bytes_per_sample//4,).  DADA files
        are contiguous (no frame drops), so no mask is needed."""
        align = self.packed_alignment
        if offset % align or count % align:
            raise ValueError(
                f"packed reads must be word-aligned: offset {offset} and "
                f"count {count} must be multiples of {align}")
        bps_bytes = self._bytes_per_sample
        self._fh.seek(self._hdr_size + offset * bps_bytes)
        raw = self._fh.read(count * bps_bytes)
        return np.frombuffer(raw, "<u4").astype(np.uint32)

    def packed_decode_fn(self):
        """Jittable ``decode(carrier) -> samples``, bit-exact against
        :meth:`_read_frame`'s host decode."""
        from ..ops import unpack_device as ud

        nbit = {1: 8, 2: 16, 4: 32}[self._raw_dtype.itemsize]
        if self._raw_dtype.kind == "f":
            unpack = ud.f32_payload_device
        elif nbit == 8:
            unpack = ud.unpack_8bit_signed_device
        else:
            unpack = ud.unpack_16bit_signed_device
        npol, nchan, ndim = self._npol, self._nchan, self._ndim
        per_sample = npol * nchan * ndim
        keep = tuple(slice(None) if s > 1 else 0 for s in (npol, nchan))
        cplx = ndim == 2

        def decode(carrier):
            import jax
            comp = unpack(carrier)
            count = comp.shape[0] // per_sample
            x = comp.reshape(count, npol, nchan, ndim)
            if cplx:
                x = jax.lax.complex(x[..., 0], x[..., 1])
            else:
                x = x[..., 0]
            return x[(slice(None),) + keep]

        return decode

    def close(self):
        super().close()
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None


class DADAStreamWriter:
    """Write a stream to a DADA file (one header + raw payload)."""

    def __init__(self, name, template, *, nbit=32, extra_header=None):
        import builtins
        shape = template.shape
        sample_shape = shape[1:]
        while len(sample_shape) < 2:
            sample_shape = (1,) + sample_shape \
                if len(sample_shape) == 1 else (1, 1)
        npol, nchan = sample_shape
        ndim = 2 if np.dtype(template.dtype).kind == "c" else 1
        self._raw_dtype = _payload_dtype(nbit)
        self._ndim = ndim
        self._store_shape = (npol, nchan)
        rate_hz = template.sample_rate.to_value(u.Hz)
        iso = template.start_time.isot
        date, _, clock = iso.partition("T")
        whole, _, frac = clock.partition(".")
        utc_start = f"{date}-{whole}"
        hdr = {
            "HDR_VERSION": "1.0",
            "HDR_SIZE": str(_DEFAULT_HDR_SIZE),
            "INSTRUMENT": "baseband_tasks_tpu",
            "NBIT": str(abs(int(nbit)) if nbit != -32 else 32),
            "NDIM": str(ndim),
            "NPOL": str(npol),
            "NCHAN": str(nchan),
            "TSAMP": repr(1e6 / rate_hz),
            "UTC_START": utc_start,
            "OBS_OFFSET": "0",
        }
        if frac and float("0." + frac):
            # whole seconds live in UTC_START; keep the fraction
            hdr["PICOSECONDS"] = str(int(round(float("0." + frac) * 1e12)))
        attrs = getattr(template, "meta", {}).get("__attributes__", {})
        freq = attrs.get("frequency")
        if freq is not None:
            # channel axis is last in the (npol, nchan) store shape:
            # take one pol's channel values, keeping ORDER so the
            # bandwidth sign (sideband) survives the round trip
            fv = np.atleast_1d(np.asarray(freq.to_value(u.MHz),
                                          dtype=np.float64))
            fv = fv.reshape(-1, fv.shape[-1])[0]
            hdr["FREQ"] = repr(float(fv.mean()))
            if fv.size > 1:
                hdr["BW"] = repr(float(
                    (fv[-1] - fv[0]) * fv.size / (fv.size - 1)))
        if extra_header:
            hdr.update({k: str(v) for k, v in extra_header.items()})
        text = "".join(f"{k} {v}\n" for k, v in hdr.items())
        raw = text.encode("ascii")
        if len(raw) > _DEFAULT_HDR_SIZE:
            raise ValueError("header too large")
        self._fh = builtins.open(name, "wb")
        self._fh.write(raw.ljust(_DEFAULT_HDR_SIZE, b"\x00"))
        self._closed = False

    def write(self, data):
        data = np.asarray(data)
        comps = [data.real, data.imag][:self._ndim]
        stacked = np.stack(comps, axis=-1).astype(np.float32)
        stacked = stacked.reshape(
            (len(data),) + self._store_shape + (self._ndim,))
        if self._raw_dtype.kind == "i":
            info = np.iinfo(self._raw_dtype)
            stacked = np.clip(np.round(stacked), info.min, info.max)
        self._fh.write(np.ascontiguousarray(
            stacked.astype(self._raw_dtype)).tobytes())

    def close(self):
        if not self._closed:
            self._fh.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def open(name, mode="r", **kwargs):
    """Open a DADA file for stream reading ('r') or writing ('w')."""
    if mode == "r":
        return DADAStreamReader(name, **kwargs)
    if mode == "w":
        return DADAStreamWriter(name, **kwargs)
    raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")
