"""GUPPI raw file reader/writer.

The reference's PFB-inversion guidance is written for GUPPI data
(/root/reference/baseband_tasks/pfb.py:170-181) and it reads the format
through its `baseband` dependency; this is the native equivalent.

A GUPPI raw file is a sequence of blocks, each an ASCII header of
80-character FITS-style cards (ending with ``END``, optionally padded to
512-byte multiples when ``DIRECTIO=1``) followed by ``BLOCSIZE`` bytes
of payload.  The payload is channel-major: for each of ``OBSNCHAN``
channels, a contiguous time series of ``NPOL`` (2 = single-pol complex,
4 = dual-pol complex) int8 components; ``OVERLAP`` trailing samples of
each block are repeated at the start of the next.

The stream presents (time, chan, pol) complex64 samples; overlap
regions are de-duplicated, and STT_IMJD/SMJD/OFFS (+ PKTIDX for
continuity checks) map to the two-double `utils.Time`.
"""

from __future__ import annotations

import builtins
import os

import numpy as np

from ..base import Base
from ..utils import Time, units as u

__all__ = ["GUPPIStreamReader", "GUPPIStreamWriter", "open"]

CARD = 80


def _parse_cards(fh):
    """Read one header (cards to END); returns (dict, header_bytes) or
    (None, 0) at EOF."""
    cards = {}
    n = 0
    while True:
        raw = fh.read(CARD)
        if len(raw) < CARD:
            if n == 0 and not raw:
                return None, 0
            raise ValueError("truncated GUPPI header")
        n += CARD
        text = raw.decode("ascii", "replace")
        key = text[:8].strip()
        if key == "END":
            break
        if "=" in text:
            val = text.split("=", 1)[1]
            if val.lstrip().startswith("'"):
                # string value: closing quote, then optional comment
                body = val.lstrip()[1:]
                val = body.split("'", 1)[0].strip()
            else:
                # FITS inline comment: "value / comment"
                val = val.split("/", 1)[0].strip()
            cards[key] = val
        if n > 200 * CARD:
            raise ValueError("GUPPI header too long (no END card)")
    return cards, n


class GUPPIStreamReader(Base):
    """Stream head over a GUPPI raw file."""

    def __init__(self, name):
        self._fh = builtins.open(name, "rb")
        try:
            self._init_from_file()
        except Exception:
            self._fh.close()
            self._fh = None
            raise

    def _init_from_file(self):
        fh = self._fh
        size = os.fstat(fh.fileno()).st_size
        # index all blocks (header dict, payload offset)
        blocks = []
        while fh.tell() < size:
            pos = fh.tell()
            hdr, hbytes = _parse_cards(fh)
            if hdr is None:
                break
            if int(hdr.get("DIRECTIO", 0)):
                pad = (-(pos + hbytes)) % 512
                fh.seek(pad, 1)
            blocsize = int(hdr["BLOCSIZE"])
            blocks.append((hdr, fh.tell()))
            fh.seek(blocsize, 1)
            if int(hdr.get("DIRECTIO", 0)):
                # hashpipe et al. 512-align the data segment too
                fh.seek((-blocsize) % 512, 1)
        if not blocks:
            raise ValueError("no GUPPI blocks found")
        self._blocks = blocks
        h0 = blocks[0][0]
        nchan = int(h0["OBSNCHAN"])
        npol_comp = int(h0.get("NPOL", 4))
        npol = 2 if npol_comp == 4 else 1
        nbits = int(h0.get("NBITS", 8))
        if nbits != 8:
            raise ValueError(f"NBITS={nbits} not supported (8-bit only)")
        blocsize = int(h0["BLOCSIZE"])
        ntime = blocsize // (nchan * npol * 2)  # 2 = re,im int8
        overlap = int(h0.get("OVERLAP", 0))
        self._nchan, self._npol = nchan, npol
        self._ntime, self._overlap = ntime, overlap
        step = ntime - overlap
        n = step * len(blocks) + (overlap if overlap else 0)
        tbin = float(h0["TBIN"])
        sample_rate = u.Quantity(1.0 / tbin, u.Hz)
        imjd = int(float(h0.get("STT_IMJD", 55000)))
        smjd = float(h0.get("STT_SMJD", 0))
        offs = float(h0.get("STT_OFFS", 0))
        start = Time(float(imjd), 0.0, format="mjd", scale="utc") \
            + u.Quantity(smjd + offs, u.s)

        freq = None
        sideband = None
        if "OBSFREQ" in h0:
            fc = float(h0["OBSFREQ"])
            bw = float(h0.get("OBSBW", 0.0))
            if nchan > 1 and bw:
                chans = fc + (np.arange(nchan) - (nchan - 1) / 2) \
                    * (bw / nchan)
                freq = u.Quantity(chans[:, None] * np.ones((1, npol)),
                                  u.MHz) if npol > 1 else \
                    u.Quantity(chans, u.MHz)
                sideband = 1 if bw > 0 else -1
            else:
                freq = u.Quantity(fc, u.MHz)
                sideband = 1 if bw >= 0 else -1
        sample_shape = (nchan, npol) if npol > 1 else (nchan,)
        super().__init__(shape=(n,) + sample_shape, start_time=start,
                         sample_rate=sample_rate,
                         samples_per_frame=step, dtype=np.complex64,
                         frequency=freq, sideband=sideband)

    @property
    def header0(self):
        """First block's header cards (dict of strings)."""
        return dict(self._blocks[0][0])

    def _read_frame(self, frame_index):
        # frames 0..nblocks-1 cover [k*step, (k+1)*step) = block k's
        # first `step` rows (its leading `overlap` rows repeat the
        # previous block's tail); when overlap > 0 one extra final frame
        # holds the last block's unique tail rows [step, step+overlap)
        nblocks = len(self._blocks)
        hdr, payload = self._blocks[min(frame_index, nblocks - 1)]
        nchan, npol, ntime = self._nchan, self._npol, self._ntime
        step = self._samples_per_frame
        first = 0 if frame_index < nblocks else step
        want = min(step, self._shape[0] - frame_index * step)
        self._fh.seek(payload)
        raw = np.frombuffer(self._fh.read(int(hdr["BLOCSIZE"])), np.int8)
        data = raw.reshape(nchan, ntime, npol, 2).astype(np.float32)
        z = (data[..., 0] + 1j * data[..., 1]).transpose(1, 0, 2)
        z = z[first:first + want]
        if npol == 1:
            z = z[..., 0]
        return z.astype(np.complex64)

    # -- packed-payload ingest (device-side decode; see io/vdif.py) -------
    @property
    def packed_alignment(self):
        """Samples per packed unit: one raw block's unique rows."""
        return self._samples_per_frame

    def read_packed(self, offset, count):
        """Raw block payloads covering [offset, offset+count) as a
        uint32 word array of shape (n_blocks, BLOCSIZE//4).

        Covers the uniform region [0, nblocks*step); the final
        overlap-tail rows (when OVERLAP > 0) stay on the eager path.
        """
        step = self._samples_per_frame
        if offset % step or count % step:
            raise ValueError(
                f"packed reads must be frame-aligned: offset {offset} "
                f"and count {count} must be multiples of {step}")
        b0, n_blocks = offset // step, count // step
        if b0 + n_blocks > len(self._blocks):
            raise ValueError(
                "packed reads cover only whole raw blocks "
                f"(samples [0, {len(self._blocks) * step}))")
        blocsize = int(self._blocks[b0][0]["BLOCSIZE"])
        if blocsize % 4:
            raise ValueError("BLOCSIZE not a multiple of 4 bytes")
        carrier = np.empty((n_blocks, blocsize // 4), np.uint32)
        for k in range(n_blocks):
            hdr, payload = self._blocks[b0 + k]
            if int(hdr["BLOCSIZE"]) != blocsize:
                raise ValueError("BLOCSIZE varies between blocks")
            self._fh.seek(payload)
            carrier[k] = np.frombuffer(self._fh.read(blocsize), "<u4")
        return carrier

    def packed_decode_fn(self):
        """Jittable ``decode(carrier) -> samples``, bit-exact against
        :meth:`_read_frame`'s host decode (signed int8 components,
        channel-major payload, leading OVERLAP rows dropped)."""
        from ..ops import unpack_device as ud

        nchan, npol, ntime = self._nchan, self._npol, self._ntime
        step = self._samples_per_frame

        def decode(carrier):
            import jax
            import jax.numpy as jnp

            comp = ud.unpack_8bit_signed_device(carrier)
            n_blocks = comp.shape[0]
            x = comp.reshape(n_blocks, nchan, ntime, npol, 2)
            z = jax.lax.complex(x[..., 0], x[..., 1])
            z = jnp.moveaxis(z, 1, 2)            # (B, ntime, nchan, npol)
            z = z[:, :step]
            z = z.reshape((n_blocks * step, nchan, npol))
            return z if npol > 1 else z[..., 0]

        return decode

    def close(self):
        super().close()
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None


class GUPPIStreamWriter:
    """Write a stream to GUPPI raw blocks (8-bit, no overlap)."""

    def __init__(self, name, template, *, samples_per_block=None,
                 scale=32.0, extra_header=None):
        shape = template.shape
        sample_shape = shape[1:]
        if len(sample_shape) == 0:
            sample_shape = (1, 1)
        elif len(sample_shape) == 1:
            sample_shape = sample_shape + (1,)
        self._nchan, self._npol = sample_shape
        self._scale = float(scale)
        self._spb = int(samples_per_block or 8192)
        rate_hz = template.sample_rate.to_value(u.Hz)
        t0 = template.start_time
        imjd = int(np.floor(t0.mjd))
        hi, lo = t0.mjd_pair
        sec = ((hi - imjd) + lo) * 86400.0
        self._cards = {
            "BLOCSIZE": self._spb * self._nchan * self._npol * 2,
            "OBSNCHAN": self._nchan,
            "NPOL": 4 if self._npol == 2 else 2,
            "NBITS": 8,
            "TBIN": repr(1.0 / rate_hz),
            "OVERLAP": 0,
            "STT_IMJD": imjd,
            "STT_SMJD": int(np.floor(sec)),
            "STT_OFFS": round(sec - np.floor(sec), 9),
            "PKTIDX": 0,
        }
        attrs = getattr(template, "meta", {}).get("__attributes__", {})
        freq = attrs.get("frequency")
        if freq is not None:
            # per-channel values only (drop pol broadcast), keeping the
            # channel ORDER so the bandwidth sign (sideband) survives
            fv = np.atleast_1d(
                np.asarray(freq.to_value(u.MHz), np.float64))
            if fv.ndim > 1:
                fv = fv.reshape(fv.shape[0], -1)[:, 0]
            self._cards["OBSFREQ"] = repr(float(fv.mean()))
            if fv.size > 1:
                self._cards["OBSBW"] = repr(float(
                    (fv[-1] - fv[0]) * fv.size / (fv.size - 1)))
        if extra_header:
            self._cards.update(extra_header)
        self._fh = builtins.open(name, "wb")
        self._buf = np.zeros((0, self._nchan, self._npol), np.complex64)
        self._block_nr = 0
        self._closed = False

    def _emit(self, z):
        cards = dict(self._cards)
        cards["PKTIDX"] = self._block_nr
        text = b""
        for k, v in cards.items():
            sval = str(v)
            text += f"{k:<8}= {sval:<20}".ljust(CARD).encode("ascii")
        text += "END".ljust(CARD).encode("ascii")
        self._fh.write(text)
        comp = np.stack([z.real, z.imag], axis=-1) * self._scale
        comp = np.clip(np.round(comp), -128, 127).astype(np.int8)
        # (time, chan, pol, 2) -> channel-major (chan, time, pol, 2)
        self._fh.write(np.ascontiguousarray(
            comp.transpose(1, 0, 2, 3)).tobytes())
        self._block_nr += 1

    def write(self, data):
        z = np.asarray(data, np.complex64).reshape(
            len(data), self._nchan, self._npol)
        self._buf = np.concatenate([self._buf, z]) if len(self._buf) \
            else z
        while len(self._buf) >= self._spb:
            self._emit(self._buf[:self._spb])
            self._buf = self._buf[self._spb:]

    def close(self):
        if not self._closed:
            if len(self._buf):
                pad = np.zeros((self._spb - len(self._buf),
                                self._nchan, self._npol), np.complex64)
                self._emit(np.concatenate([self._buf, pad]))
                self._buf = self._buf[:0]
            self._fh.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def open(name, mode="r", **kwargs):
    """Open a GUPPI raw file for stream reading ('r') or writing ('w')."""
    if mode == "r":
        return GUPPIStreamReader(name, **kwargs)
    if mode == "w":
        return GUPPIStreamWriter(name, **kwargs)
    raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")
