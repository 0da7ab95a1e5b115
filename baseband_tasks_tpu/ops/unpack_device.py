"""On-device bit-unpacking: packed baseband words -> float32 samples.

Device-side counterpart of the host LUT decoder (native/unpack.c; the
reference decodes under ``Base.read`` via numpy fancy indexing,
/root/reference/baseband_tasks/io/hdf5/payload.py:164-178).  The decode
conventions match the host decoder bit-for-bit:

- 8-bit: offset binary, ``sample = byte - offset`` (default 127.5);
- 4-bit: two components per byte, LOW nibble first, ``nibble - offset``;
- 2-bit: four components per byte, LSB-first crumbs, mapped through a
  4-entry level table (VDIF levels by default);
- 1-bit: eight components per byte, LSB first, mapped to ±1.

Packed payloads travel and live on device as ``uint32`` words, each
holding four little-endian payload bytes.  Inside jit, shifts and masks
expand the words into fields and the 2/4-level tables are applied with
selects, so the whole decode is elementwise work that XLA fuses into
whatever consumes the samples — no gather, no extra HBM round trip.
(Float32 carriers holding the same bit pattern are still accepted and
bitcast to words first.)

Throughput note: packed samples cost 1/4 (8-bit) to 1/16 (2-bit) of the
HBM read traffic of float32 planes; fusing decode into an HBM-bound
pipeline *reduces* total traffic rather than adding a pass.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["pack_bytes", "pack_time_words", "unpack_time_words",
           "words", "unpack_8bit_device",
           "unpack_4bit_device", "unpack_2bit_device",
           "unpack_1bit_device", "unpack_16bit_device",
           "unpack_8bit_signed_device", "unpack_16bit_signed_device",
           "f32_payload_device", "VDIF_2BIT_LEVELS"]

# standard VDIF 2-bit reconstruction levels (domain constant; also used
# by the host decoder and io/vdif.py)
VDIF_2BIT_LEVELS = np.array([-3.3359, -1.0, 1.0, 3.3359], dtype=np.float32)


def pack_bytes(raw):
    """Host helper: uint8 payload -> uint32 words (little-endian
    4-bytes-per-word), padded with zero bytes to a multiple of 4."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8).ravel()
    pad = (-raw.size) % 4
    if pad:
        raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
    return raw.view("<u4").astype(np.uint32, copy=False)


def words(x):
    """Packed carrier -> uint32 words (jit-side): identity for uint32,
    a bitcast for float32 carriers of the same bit pattern."""
    if x.dtype == jnp.uint32:
        return x
    return jax.lax.bitcast_convert_type(x, jnp.uint32)


def _fields(x, bits):
    """Split each uint32 word of the carrier into its 32/bits
    subfields, flattened in stream (LSB-first) order along the last
    axis: (..., n) words -> (..., n * 32//bits) int32."""
    u = words(x)
    per = 32 // bits
    mask = jnp.uint32((1 << bits) - 1)
    parts = [((u >> jnp.uint32(bits * k)) & mask).astype(jnp.int32)
             for k in range(per)]
    stacked = jnp.stack(parts, axis=-1)
    return stacked.reshape(*u.shape[:-1], u.shape[-1] * per)


def unpack_8bit_device(x, offset=127.5):
    """Carrier (..., n) -> (..., 4n) float32 samples, byte - offset."""
    return _fields(x, 8).astype(jnp.float32) - jnp.float32(offset)


def unpack_4bit_device(x, offset=7.5):
    """Carrier (..., n) -> (..., 8n) float32 samples, nibble - offset
    (low nibble of each byte first)."""
    return _fields(x, 4).astype(jnp.float32) - jnp.float32(offset)


def unpack_16bit_device(x, offset=32767.5):
    """Carrier (..., n) -> (..., 2n) float32 samples, little-endian
    u16 - offset (matches the host ``'<u2'`` decode in io/vdif.py)."""
    return _fields(x, 16).astype(jnp.float32) - jnp.float32(offset)


def unpack_8bit_signed_device(x):
    """Carrier (..., n) -> (..., 4n) float32 from two's-complement
    int8 bytes (GUPPI/DADA payloads use signed samples)."""
    f = _fields(x, 8)
    return jnp.where(f >= 128, f - 256, f).astype(jnp.float32)


def unpack_16bit_signed_device(x):
    """Carrier (..., n) -> (..., 2n) float32 from little-endian
    two's-complement int16 (DADA NBIT=16)."""
    f = _fields(x, 16)
    return jnp.where(f >= 32768, f - 65536, f).astype(jnp.float32)


def f32_payload_device(x):
    """The payload bytes already are little-endian float32 samples
    (DADA NBIT=±32, VDIF 32-bit): reinterpret the words."""
    if x.dtype == jnp.float32:
        return x
    return jax.lax.bitcast_convert_type(x, jnp.float32)


def unpack_2bit_device(x, levels=None):
    """Carrier (..., n) -> (..., 16n) float32 samples via a 4-level
    table (LSB-first crumbs).

    The table lookup is two nested selects (gather-free, and
    bit-identical to the host LUT — a fitted polynomial would round).
    """
    if levels is None:
        levels = VDIF_2BIT_LEVELS
    lv = [jnp.float32(v) for v in np.asarray(levels, dtype=np.float32)]
    c = _fields(x, 2)
    return jnp.where(c < 2,
                     jnp.where(c == 0, lv[0], lv[1]),
                     jnp.where(c == 2, lv[2], lv[3]))


def unpack_1bit_device(x, low=-1.0, high=1.0):
    """Carrier (..., n) -> (..., 32n) float32 samples: bit ? high :
    low (LSB first)."""
    b = _fields(x, 1).astype(jnp.float32)
    return jnp.float32(low) + b * jnp.float32(high - low)


def pack_time_words(fields, bits):
    """Host helper: (T, ...) small-int sample fields -> (T*bits//32, ...)
    uint32 words, ``32/bits`` time-consecutive samples per word, the
    earliest in the least significant bits (decoded by
    :func:`unpack_time_words`).

    ``fields`` holds the raw encoded values (bytes for 8-bit, nibbles
    0..15 for 4-bit, crumbs 0..3 for 2-bit, bits 0..1).
    """
    if bits not in (1, 2, 4, 8):
        raise ValueError("bits must be 1, 2, 4 or 8")
    per = 32 // bits
    f = np.ascontiguousarray(fields, dtype=np.uint32)
    t = f.shape[0]
    if t % per:
        raise ValueError(f"time axis must divide by {per}")
    if f.max(initial=0) >> bits:
        raise ValueError(f"field values exceed {bits} bits")
    grouped = f.reshape((t // per, per) + f.shape[1:])
    w = np.zeros((t // per,) + f.shape[1:], dtype=np.uint32)
    for k in range(per):
        w |= grouped[:, k] << np.uint32(bits * k)
    return w


def unpack_time_words(w, bits, offset=None, levels=None):
    """Decode :func:`pack_time_words` words back to the (T, ...) float32
    time series, jit-side.  Units: 8-bit ``byte - 127.5``, 4-bit
    ``nibble - 7.5``, 2-bit VDIF levels, 1-bit ±1 (``offset`` /
    ``levels`` override)."""
    if bits not in (1, 2, 4, 8):
        raise ValueError("bits must be 1, 2, 4 or 8")
    u = words(w)
    per = 32 // bits
    mask = jnp.uint32((1 << bits) - 1)
    f = jnp.stack([((u >> jnp.uint32(bits * k)) & mask).astype(jnp.int32)
                   for k in range(per)], axis=1)
    f = f.reshape((u.shape[0] * per,) + u.shape[1:])
    if bits == 2:
        lv = [jnp.float32(v) for v in np.asarray(
            VDIF_2BIT_LEVELS if levels is None else levels, np.float32)]
        return jnp.where(f < 2, jnp.where(f == 0, lv[0], lv[1]),
                         jnp.where(f == 2, lv[2], lv[3]))
    if bits == 1:
        lo, hi = (-1.0, 1.0) if levels is None else (levels[0], levels[-1])
        return jnp.where(f == 0, jnp.float32(lo), jnp.float32(hi))
    if offset is None:
        offset = {8: 127.5, 4: 7.5}[bits]
    return f.astype(jnp.float32) - jnp.float32(offset)
