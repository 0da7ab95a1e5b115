"""Source-node stream generators.

Counterparts of `/root/reference/baseband_tasks/generators.py`:
``StreamGenerator`` (user frame function), ``EmptyStreamGenerator`` (blank
frames) and ``NoiseGenerator`` (reproducible Gaussian noise).

Device-side noise: the reference uses a Philox counter RNG keyed on the frame
offset for reproducible random access (generators.py:171-190); JAX's
counter-based PRNG gives the identical property via
``jax.random.fold_in(key, frame_index)`` — any frame can be (re)generated
independently, on device, in any order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .base import Base

__all__ = ["StreamGenerator", "EmptyStreamGenerator", "Noise",
           "NoiseGenerator"]


class StreamGenerator(Base):
    """Stream whose frames are produced by a user function.

    The function is called with the handle itself (positioned at the frame
    start, so ``tell()``/``time`` give the frame location) and must return
    an array of ``(samples_per_frame,) + sample_shape``.
    """

    def __init__(self, function, shape, start_time, sample_rate, *,
                 samples_per_frame=1, dtype=np.complex64,
                 frequency=None, sideband=None, polarization=None):
        super().__init__(shape=shape, start_time=start_time,
                         sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, dtype=dtype,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization)
        self._function = function

    def _read_frame(self, frame_index):
        old_offset = self._offset
        try:
            self._offset = frame_index * self._samples_per_frame
            data = self._function(self)
        finally:
            self._offset = old_offset
        n = min(self._samples_per_frame,
                self._shape[0] - frame_index * self._samples_per_frame)
        if len(data) < n:
            # a short frame would silently misalign every later sample
            raise ValueError(
                f"generator function returned {len(data)} samples for "
                f"frame {frame_index}; expected at least {n}")
        if len(data) > n:
            data = data[:n]
        return data


class EmptyStreamGenerator(Base):
    """Stream of blank (zero) frames, to be filled by a downstream Task."""

    def _read_frame(self, frame_index):
        n = min(self._samples_per_frame,
                self._shape[0] - frame_index * self._samples_per_frame)
        return jnp.zeros((n,) + self.sample_shape, self._dtype)


class Noise:
    """Reproducible random-access Gaussian noise generator.

    Callable with a stream handle; generates the frame at the handle's
    current offset from ``fold_in(key, frame_offset)`` so regenerating any
    frame gives identical values regardless of read order.
    """

    def __init__(self, seed=None, dtype=np.complex64):
        key = seed if isinstance(seed, jax.Array) and seed.dtype == jax.random.key(0).dtype \
            else jax.random.key(0 if seed is None else seed)
        self._key = key
        self._dtype = np.dtype(dtype)

    def __call__(self, sh):
        offset = sh.tell()
        n = min(sh.samples_per_frame, sh.shape[0] - offset)
        shape = (n,) + sh.sample_shape
        key = jax.random.fold_in(self._key, offset)
        itemsize = self._dtype.itemsize // (2 if self._dtype.kind == "c"
                                            else 1)
        if itemsize > 4 and not jax.config.jax_enable_x64:
            # float64/complex128 would silently downcast to 32-bit
            raise ValueError(
                f"dtype {self._dtype} requires jax x64 mode "
                f"(jax.config.update('jax_enable_x64', True))")
        real_dtype = jnp.float64 if itemsize > 4 else jnp.float32
        if self._dtype.kind == "c":
            pair = jax.random.normal(key, shape + (2,), real_dtype)
            return jax.lax.complex(pair[..., 0], pair[..., 1]).astype(self._dtype)
        return jax.random.normal(key, shape, real_dtype).astype(self._dtype)


class NoiseGenerator(StreamGenerator):
    """Stream of Gaussian noise (complex: unit variance per component).

    ``seed`` gives reproducibility; frames are independent of read order
    (cf. reference generators.py:193-245).

    Examples
    --------
    >>> import numpy as np
    >>> from baseband_tasks_tpu import NoiseGenerator
    >>> from baseband_tasks_tpu.utils import Time, units as u
    >>> ng = NoiseGenerator(shape=(1000,),
    ...                     start_time=Time("2020-01-01T00:00:00.0"),
    ...                     sample_rate=1 * u.kHz, samples_per_frame=100,
    ...                     seed=4)
    >>> tail = np.asarray(ng.read(1000))[-100:]
    >>> _ = ng.seek(900)        # random access: same samples come back
    >>> bool(np.array_equal(np.asarray(ng.read(100)), tail))
    True
    """

    def __init__(self, shape, start_time, sample_rate, *,
                 samples_per_frame=1, dtype=np.complex64, seed=None,
                 frequency=None, sideband=None, polarization=None):
        noise = Noise(seed, dtype=dtype)
        super().__init__(noise, shape=shape, start_time=start_time,
                         sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, dtype=dtype,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization)
