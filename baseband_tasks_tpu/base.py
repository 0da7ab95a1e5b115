"""Stream/task kernel for baseband_tasks_tpu.

Device-resident re-design of the reference's stream framework
(`/root/reference/baseband_tasks/base.py`): every node in a pipeline looks
like a baseband file handle — ``shape``, ``dtype``, ``sample_rate``,
``start_time``, ``seek``/``tell``, ``read(count)`` — and wraps an underlying
handle ``ih``, so a pipeline is a lazy chain that computes frames on demand.

Differences from the reference:

- Frames are **device-resident jax arrays**; ``read()`` assembles outputs by
  slicing/concatenating device arrays, so a chained pipeline never bounces
  through host memory between stages (the reference memcpys into numpy at
  every level, base.py:389-438).
- The per-frame ``task`` hook is a **pure function jitted once per shape**;
  XLA fuses elementwise work into the FFTs.  Static shapes are preserved at
  stream ends by re-reading full windows and slicing (instead of running a
  smaller partial frame through a fresh compilation).
- Sample-pointer ↔ time conversions use exact two-double arithmetic
  (``utils.time``) to keep ns-level bookkeeping off the device.

Reference parity map (class → reference class, file:line):
- ``Base``           → ``Base``            (base.py:87)
- ``BaseTaskBase``   → ``BaseTaskBase``    (base.py:499)
- ``TaskBase``       → ``TaskBase``        (base.py:613)
- ``PaddedTaskBase`` → ``PaddedTaskBase``  (base.py:709)
- ``Task``           → ``Task``            (base.py:798)
- ``SetAttribute``   → ``SetAttribute``    (base.py:892)
"""

from __future__ import annotations

import inspect
import math
import operator
import warnings
from fractions import Fraction

import jax.numpy as jnp
import numpy as np

from .utils import Time, units as u

__all__ = ["Base", "BaseTaskBase", "TaskBase", "PaddedTaskBase", "Task",
           "SetAttribute", "getattr_if_none", "check_broadcast_to",
           "simplify_shape", "FrameSizeWarning", "PerformanceHint"]

#: Stream attributes that propagate through tasks via ``meta``.
META_ATTRIBUTES = ("frequency", "sideband", "polarization")


def getattr_if_none(ih, attr, value=None, required=True):
    """Return ``value`` if not None, else ``getattr(ih, attr)``.

    Mirrors the parameter-inheritance helper of the reference
    (base.py:56-84): task parameters default to the underlying stream's.
    """
    if value is None:
        value = getattr(ih, attr, None)
        if value is None and required:
            raise ValueError(
                f"{attr} not set and underlying stream does not have it; "
                f"pass it in explicitly.")
    return value


def check_broadcast_to(value, shape):
    """Check ``value`` broadcasts to ``shape``; return the broadcast array."""
    if isinstance(value, u.Quantity):
        return u.Quantity(np.broadcast_to(np.asarray(value.value), shape),
                          value.unit)
    return np.broadcast_to(value, shape)


def simplify_shape(value):
    """Strip leading length-1 dimensions from an attribute array."""
    arr = value.value if isinstance(value, u.Quantity) else np.asarray(value)
    arr = np.asarray(arr)
    shape = arr.shape
    first = 0
    while first < len(shape) and shape[first] == 1:
        first += 1
    arr = np.asarray(arr[(0,) * first])
    out = arr[()] if arr.ndim == 0 else arr
    return u.Quantity(out, value.unit) if isinstance(value, u.Quantity) else out


class Base:
    """Filehandle-like stream head: shape, rate, time, seek/tell/read.

    Subclasses must implement ``_read_frame(frame_index)`` returning an
    array (jax or numpy) of ``(samples_per_frame,) + sample_shape``.
    """

    def __init__(self, shape, start_time, sample_rate, *,
                 samples_per_frame=1, dtype=np.complex64,
                 frequency=None, sideband=None, polarization=None):
        self._shape = tuple(operator.index(n) for n in shape)
        self._start_time = Time(start_time) if not isinstance(start_time, Time) \
            else start_time
        self._sample_rate = sample_rate
        self._samples_per_frame = operator.index(samples_per_frame)
        self._dtype = np.dtype(dtype)
        self._meta = {"__attributes__": {}}
        if (frequency is None) != (sideband is None):
            # one without the other is meaningless (reference
            # base.py:144-146)
            raise ValueError("frequency and sideband should both be passed "
                             "in.")
        for name, value in (("frequency", frequency), ("sideband", sideband),
                            ("polarization", polarization)):
            if value is not None:
                value = self._check_attribute(name, value)
            self._meta["__attributes__"][name] = value
        self._frame = None
        self._frame_index = None
        self._offset = 0
        self._closed = False

    def _check_attribute(self, name, value):
        if name == "sideband":
            value = np.where(np.asarray(value) < 0, -1, 1).astype(np.int8)
        elif name == "polarization":
            value = np.asarray(value)
        elif name == "frequency" and not isinstance(value, u.Quantity):
            raise TypeError("frequency must be a Quantity")
        broadcast_shape = self.sample_shape if self.sample_shape else (1,)
        check_broadcast_to(value, broadcast_shape)
        return simplify_shape(value)

    # -- shape / dtype ---------------------------------------------------
    @property
    def shape(self):
        return self._shape

    @property
    def sample_shape(self):
        return self._shape[1:]

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return math.prod(self._shape)

    @property
    def dtype(self):
        return self._dtype

    @property
    def complex_data(self):
        return self._dtype.kind == "c"

    @property
    def samples_per_frame(self):
        return self._samples_per_frame

    # -- metadata --------------------------------------------------------
    @property
    def meta(self):
        return self._meta

    def _get_attribute(self, name):
        value = self._meta["__attributes__"].get(name)
        if value is None:
            raise AttributeError(f"{name} not set on this stream")
        return value

    @property
    def frequency(self):
        return self._get_attribute("frequency")

    @property
    def sideband(self):
        return self._get_attribute("sideband")

    @property
    def polarization(self):
        return self._get_attribute("polarization")

    # -- time ------------------------------------------------------------
    @property
    def sample_rate(self):
        return self._sample_rate

    @property
    def start_time(self):
        return self._start_time

    @property
    def stop_time(self):
        return self._tell_time(self._shape[0])

    @property
    def time(self):
        """Time of the current sample pointer."""
        return self._tell_time(self._offset)

    def _tell_time(self, offset):
        from .utils.time import TimeDelta
        return self._start_time + TimeDelta.from_samples(
            offset, self._sample_rate.to_value(u.Hz))

    # -- seek / tell -----------------------------------------------------
    def seek(self, offset, whence=0):
        """Move the sample pointer.

        ``offset`` may be an integer number of samples, a time Quantity, or
        an absolute :class:`~baseband_tasks_tpu.utils.Time` (whence ignored
        in that case), mirroring reference semantics (base.py:312-353).
        """
        if isinstance(offset, Time):
            offset = self._offset_from_time(offset)
            whence = 0
        elif isinstance(offset, u.Quantity):
            if offset.unit.is_equivalent(u.s):
                offset = offset.to_value(u.s) * self._sample_rate.to_value(u.Hz)
            else:
                offset = offset.to_value(u.one)
            offset = int(round(offset))
        offset = operator.index(offset)  # reject floats loudly, now
        if whence == 0 or whence == "start":
            self._offset = offset
        elif whence == 1 or whence == "current":
            self._offset += offset
        elif whence == 2 or whence == "end":
            self._offset = self._shape[0] + offset
        else:
            raise ValueError("invalid 'whence'; should be 0, 1 or 2")
        # like the reference (base.py:343-353) and regular filehandles,
        # out-of-range pointers are allowed; reads validate the range
        return self._offset

    def _offset_from_time(self, time):
        dt = time - self._start_time
        hi, lo = dt.sec_pair
        rate = self._sample_rate.to_value(u.Hz)
        return int(round(hi * rate + lo * rate))

    def tell(self, unit=None):
        if unit is None:
            return self._offset
        if unit == "time" or isinstance(unit, Time):
            return self.time
        return (self._offset / self._sample_rate).to(unit)

    # -- read ------------------------------------------------------------
    def read(self, count=None, out=None):
        """Read ``count`` samples starting at the current pointer.

        Returns a device (jax) array of shape ``(count,) + sample_shape``;
        pass ``out=`` to have slices written via ``__setitem__`` instead
        (used by Integrate's bin-pushing reader, cf. reference
        integration.py:18-39).
        """
        if self._closed:
            raise ValueError("I/O operation on closed stream.")
        if self._offset < 0:
            raise OSError("cannot read from before the start of input.")
        samples_left = self._shape[0] - self._offset
        if count is not None:
            count = operator.index(count)
        if count is None or count < 0:
            count = max(samples_left, 0)
        if count > samples_left:
            raise EOFError("cannot read from beyond end of input.")

        frame_index, sample_off = divmod(self._offset, self._samples_per_frame)
        self._maybe_hint_compiled(count)
        pieces = []
        sample = 0
        while sample < count:
            frame = self._get_frame_cached(frame_index)
            nsample = min(count - sample, len(frame) - sample_off)
            piece = frame[sample_off:sample_off + nsample]
            if out is None:
                pieces.append(piece)
            else:
                out[sample:sample + nsample] = piece
            sample += nsample
            sample_off = 0
            frame_index += 1
        self._offset += count
        if out is not None:
            return out
        if not pieces:
            return jnp.zeros((0,) + self.sample_shape, self._dtype)
        if len(pieces) == 1:
            return pieces[0]
        if isinstance(pieces[0], np.ndarray):
            # e.g. structured {data,count} frames from non-averaging
            # Integrate; these are host arrays by construction.
            return np.concatenate(pieces, axis=0)
        return jnp.concatenate([jnp.asarray(p) for p in pieces], axis=0)

    #: frames per eager read on an accelerator backend above which a
    #: one-time CompiledPipeline hint is emitted (None disables)
    _HINT_FRAMES = 64
    _hinted_compiled = False

    def _maybe_hint_compiled(self, count):
        """One-time performance hint: long eager reads through task
        chains on an accelerator dispatch every frame from the host;
        point at CompiledPipeline once per process.  (On the CPU backend
        the eager path is the normal way to run, so no hint.)"""
        if (Base._hinted_compiled or self._HINT_FRAMES is None
                or getattr(self, "ih", None) is None
                or count < self._HINT_FRAMES * self._samples_per_frame):
            return
        import jax
        if jax.default_backend() == "cpu":
            return
        Base._hinted_compiled = True
        warnings.warn(
            f"eager read of {count} samples spans "
            f"{count // self._samples_per_frame} frames, each a separate "
            f"host->device dispatch; call .compile() on the chain head "
            f"for a read-compatible view backed by the compiled device "
            f"scan. This hint is shown once.", PerformanceHint)

    def _get_frame_cached(self, frame_index):
        if frame_index != self._frame_index:
            frame = self._read_frame(frame_index)
            # the reference validates implicitly by copying frames into
            # an out array of the declared shape (base.py:389-438); here
            # frames are returned as-is, so check the metadata contract
            if tuple(frame.shape[1:]) != tuple(self.sample_shape):
                raise ValueError(
                    f"frame sample shape {tuple(frame.shape[1:])} does "
                    f"not match the stream's {tuple(self.sample_shape)}")
            self._frame = frame
            self._frame_index = frame_index
        return self._frame

    def _read_frame(self, frame_index):  # pragma: no cover - abstract
        raise NotImplementedError

    def compile(self, *, block_samples=None, mesh=None, shard_axis="time"):
        """A read-compatible view backed by the compiled device scan.

        Same filehandle protocol (``seek``/``read``/``tell``/meta), but
        frames come from a :class:`~.models.compiled.CompiledPipeline`
        streamed on device, instead of one host dispatch per frame as in
        eager frame-at-a-time reads.  Warmup and the
        streaming delay are handled internally, so
        ``stream.compile().read(n) == stream.read(n)`` over the whole
        stream (head/tail edges are served eagerly; the midsection
        matches to the streaming-exactness contract,
        models/compiled.py:35-47).  Trailing ``Integrate``/``Fold``
        reductions keep their host bin bookkeeping over a compiled view
        of their input chain.

        Pass ``mesh`` (a `jax.sharding.Mesh`) to run each step
        time-sharded across its ``shard_axis`` devices
        (:class:`~.models.sharded.ShardedPipeline` halo exchange) —
        the same read-compatible API, multi-chip underneath.
        """
        from .models.view import compile_stream
        return compile_stream(self, block_samples=block_samples,
                              mesh=mesh, shard_axis=shard_axis)

    # -- conversions / niceties ------------------------------------------
    def __getitem__(self, item):
        from .shaping import GetItem, GetSlice
        if isinstance(item, slice):
            return GetSlice(self, item)
        if isinstance(item, tuple) and item and isinstance(item[0], slice):
            # sh[t_slice, sample_index...]: slice time first, then select.
            time_part, rest = item[0], item[1:]
            base = self if time_part == slice(None) \
                else GetSlice(self, time_part)
            if not rest:       # sh[:10,] — trailing comma, numpy-style
                return base
            return GetItem(base, rest if len(rest) > 1 else rest[0])
        return GetItem(self, item)

    def __array__(self, dtype=None, copy=None):
        old_offset = self._offset
        try:
            self.seek(0)
            data = np.asarray(self.read())
        finally:
            self._offset = old_offset
        if dtype is not None:
            data = data.astype(dtype, copy=False)
        return data

    # explicit np.asarray(sh) is supported above, but ufuncs/functions
    # must not silently materialize a whole (possibly huge) stream
    # (reference base.py:482-486)
    def __array_ufunc__(self, *args, **kwargs):
        return NotImplemented

    def __array_function__(self, *args, **kwargs):
        return NotImplemented

    def close(self):
        self._frame = None
        self._frame_index = None
        self._closed = True

    @property
    def closed(self):
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()

    def _repr_item(self, name):
        """Value for a constructor parameter, searched as attribute,
        _attribute, or meta attribute (reference base.py:207-233 inspects
        signatures the same way)."""
        for candidate in (name, "_" + name):
            if hasattr(self, candidate):
                return getattr(self, candidate)
        return self._meta.get("__attributes__", {}).get(name)

    @staticmethod
    def _repr_value(value):
        if isinstance(value, Time):
            return value.isot if value.isscalar else f"<Time {value.shape}>"
        arr = getattr(value, "value", value)
        if isinstance(arr, np.ndarray) and arr.size > 4:
            return f"<{type(value).__name__} {arr.shape}>"
        return repr(value)

    def __repr__(self):
        """Auto-repr from the constructor signature: every parameter that
        resolves to a set attribute is shown; chained handles indent."""
        cls = type(self)
        try:
            params = list(inspect.signature(cls.__init__).parameters
                          .values())[1:]
        except (TypeError, ValueError):
            params = []
        parts = []
        for par in params:
            if par.name in ("ih", "ihs") or par.kind in (
                    par.VAR_POSITIONAL, par.VAR_KEYWORD):
                continue
            value = self._repr_item(par.name)
            if value is None:
                continue
            parts.append(f"{par.name}={self._repr_value(value)}")
        head = f"{cls.__name__}({', '.join(parts)})"
        ih = getattr(self, "ih", None)
        ihs = getattr(self, "ihs", None)
        if ih is not None:
            sub = repr(ih).replace("\n", "\n   ")
            head += f"\nih: {sub}"
        elif ihs:
            for k, sub_ih in enumerate(ihs):
                sub = repr(sub_ih).replace("\n", "\n   ")
                head += f"\nihs[{k}]: {sub}"
        return head


class BaseTaskBase(Base):
    """A stream node wrapping an underlying handle ``ih``.

    All parameters default to the underlying stream's
    (reference base.py:499-610), and meta attributes propagate unless
    overridden.
    """

    def __init__(self, ih, *, shape=None, start_time=None, sample_rate=None,
                 samples_per_frame=None, dtype=None,
                 frequency=None, sideband=None, polarization=None):
        self.ih = ih
        shape = getattr_if_none(ih, "shape", shape)
        start_time = getattr_if_none(ih, "start_time", start_time)
        sample_rate = getattr_if_none(ih, "sample_rate", sample_rate)
        dtype = getattr_if_none(ih, "dtype", dtype)
        if samples_per_frame is None:
            samples_per_frame = getattr(ih, "samples_per_frame", 1)
        # Inherit meta attributes when not overridden.
        inherited = getattr(ih, "meta", {}).get("__attributes__", {})
        if frequency is None:
            frequency = inherited.get("frequency")
        if sideband is None:
            sideband = inherited.get("sideband")
        if polarization is None:
            polarization = inherited.get("polarization")
        super().__init__(shape=shape, start_time=start_time,
                         sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, dtype=dtype,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization)

    def close(self):
        super().close()
        ih = self.__dict__.pop("ih", None)
        if ih is not None:
            pass  # do not close the underlying stream; we only drop our ref.


class TaskBase(BaseTaskBase):
    """A stream node computing output frames as ``task(input_block)``.

    Handles sample-rate changes: ``ih_samples_per_frame`` input samples map
    to ``samples_per_frame`` output samples per frame; complete groups of
    ``q`` input ↔ ``p`` output samples (``p/q`` the reduced rate ratio)
    define how much of a trailing partial block is usable
    (reference base.py:613-706).
    """

    def __init__(self, ih, *, ih_samples_per_frame=None, shape=None,
                 sample_rate=None, samples_per_frame=None, **kwargs):
        sample_rate = getattr_if_none(ih, "sample_rate", sample_rate)
        # Determine the rate ratio as an exact fraction.
        ratio = self._rate_ratio(sample_rate, ih.sample_rate)
        p, q = ratio.numerator, ratio.denominator
        if ih_samples_per_frame is None:
            if samples_per_frame is not None:
                ih_samples_per_frame = samples_per_frame * q // p
            else:
                ih_samples_per_frame = getattr(ih, "samples_per_frame", 1)
                ih_samples_per_frame = max(ih_samples_per_frame // q, 1) * q
        if samples_per_frame is None:
            samples_per_frame = ih_samples_per_frame * p // q
        if samples_per_frame * q != ih_samples_per_frame * p:
            raise ValueError(
                f"samples_per_frame {samples_per_frame} inconsistent with "
                f"input frame {ih_samples_per_frame} and rate ratio {ratio}")
        self._ih_samples_per_frame = ih_samples_per_frame
        ih_n = ih.shape[0]
        nframe, extra_in = divmod(ih_n, ih_samples_per_frame)
        usable_extra_in = (extra_in // q) * q
        extra_out = usable_extra_in * p // q
        n_out = nframe * samples_per_frame + extra_out
        self._ih_stop = nframe * ih_samples_per_frame + usable_extra_in
        if shape is None:
            shape = (n_out,) + self._output_sample_shape(ih)
        super().__init__(ih, shape=shape, sample_rate=sample_rate,
                         samples_per_frame=samples_per_frame, **kwargs)

    @staticmethod
    def _rate_ratio(sample_rate, ih_sample_rate):
        """Exact output/input sample-rate ratio as a Fraction.

        float64 values and unit scales are themselves exact binary
        rationals, so the quotient is formed in exact integer arithmetic
        — no float division ever rounds (reference keeps ratios exact
        from Quantities, base.py:662-687).  Integer-valued rates (the
        normal case) therefore give the exact reduced fraction however
        extreme (e.g. 44100/48000 → 147/160, 10**9+1 over 10**9).  Only
        when the exact ratio is not simple — float-noise inputs like
        44.1 kHz whose binary expansion is not the intended decimal —
        is it snapped to the nearest simple fraction, and only if that
        reproduces the exact ratio to 1 part in 1e12.
        """
        def as_fraction(q):
            v = np.asarray(q.value)
            if v.ndim:
                raise ValueError("sample rates must be scalar")
            return Fraction(float(v)) * Fraction(q.unit.scale)

        exact = as_fraction(sample_rate) / as_fraction(ih_sample_rate)
        if exact <= 0:
            raise ValueError(f"sample rate ratio {float(exact)} must be "
                             f"positive")
        if exact.denominator <= 1 << 40:
            return exact
        approx = exact.limit_denominator(10 ** 9)
        if abs(approx - exact) <= exact / 10 ** 12:
            return approx
        raise ValueError(f"sample rate ratio {float(exact)} is not a "
                         f"simple fraction")

    def _output_sample_shape(self, ih):
        return ih.sample_shape

    def task(self, data):  # pragma: no cover - abstract unless set
        raise NotImplementedError

    def _seek_frame(self, frame_index):
        """Input-range for output frame ``frame_index`` -> (start, stop)."""
        start = frame_index * self._ih_samples_per_frame
        stop = min(start + self._ih_samples_per_frame, self._ih_stop)
        return start, stop

    def _read_frame(self, frame_index):
        start, stop = self._seek_frame(frame_index)
        self.ih.seek(start)
        data = self.ih.read(stop - start)
        return self.task(data)


class PerformanceHint(UserWarning):
    """One-time advisory that a faster execution path exists (e.g. long
    eager reads on an accelerator -> CompiledPipeline).  Distinct category
    so it can be filtered without hiding real warnings."""


class FrameSizeWarning(UserWarning):
    """Advisory: a user-chosen frame size is FFT-slow or pad-inefficient.

    Purely informational — the computation is still correct.  Kept as a
    distinct category so test suites that deliberately stress odd sizes
    (mirroring the reference's prime-length FFT tests) can filter it
    without hiding real warnings.
    """


class PaddedTaskBase(TaskBase):
    """Overlap-save stream node: frames need padding samples on both sides.

    An output frame of ``samples_per_frame`` samples is computed from
    ``pad_start + samples_per_frame + pad_end`` input samples; successive
    input windows overlap.  The default frame size keeps padding overhead
    below 25% and rounds the padded window to an FFT-fast length
    (reference base.py:709-795).  At the stream end, a full-size window is
    re-read at an offset so jitted task shapes stay static.
    """

    def __init__(self, ih, pad_start=0, pad_end=0, *, samples_per_frame=None,
                 next_fast_len=None, **kwargs):
        self._pad_start = operator.index(pad_start)
        self._pad_end = operator.index(pad_end)
        if self._pad_start < 0 or self._pad_end < 0:
            raise ValueError("padding values should be 0 or positive.")
        pad = self._pad_start + self._pad_end
        if samples_per_frame is None:
            samples_per_frame = max(3 * pad, 1)
            if next_fast_len is not None:
                padded = next_fast_len(samples_per_frame + pad)
                samples_per_frame = padded - pad
        else:
            total = samples_per_frame + pad
            if next_fast_len is not None and next_fast_len(total) != total:
                warnings.warn(
                    f"padded frame size {total} is not an FFT-fast length; "
                    f"consider samples_per_frame="
                    f"{next_fast_len(total) - pad}", FrameSizeWarning)
            if pad > 0 and samples_per_frame < 3 * pad:
                warnings.warn(
                    f"{type(self).__name__} efficiency below 75%: padding "
                    f"{pad} vs frame {samples_per_frame}; increase "
                    f"samples_per_frame.", FrameSizeWarning)
        n_out = ih.shape[0] - pad
        if n_out < 1:
            raise ValueError(
                f"input stream too short: {ih.shape[0]} samples cannot "
                f"support padding of {pad}")
        samples_per_frame = min(samples_per_frame, n_out)
        self._padded_samples_per_frame = samples_per_frame + pad
        super().__init__(ih, ih_samples_per_frame=samples_per_frame,
                         samples_per_frame=samples_per_frame,
                         shape=(n_out,) + self._output_sample_shape(ih),
                         **kwargs)
        # start_time shifts by pad_start samples of the underlying stream.
        if self._pad_start:
            self._start_time = (
                self._start_time
                + self._samples_to_timedelta(self._pad_start,
                                             ih.sample_rate))

    @staticmethod
    def _samples_to_timedelta(n, sample_rate):
        from .utils.time import TimeDelta
        return TimeDelta.from_samples(n, sample_rate.to_value(u.Hz))

    @property
    def pad_start(self):
        return self._pad_start

    @property
    def pad_end(self):
        return self._pad_end

    def _seek_frame(self, frame_index):
        start = frame_index * self._samples_per_frame
        stop = start + self._padded_samples_per_frame
        # Clamp to the stream end by re-reading a full window at an offset;
        # _frame_offset records how far into the window this frame starts.
        ih_n = self.ih.shape[0]
        if stop > ih_n:
            shift = stop - ih_n
            start -= shift
            stop = ih_n
            self._frame_offset = shift
        else:
            self._frame_offset = 0
        return start, stop

    def _read_frame(self, frame_index):
        start, stop = self._seek_frame(frame_index)
        offset = self._frame_offset
        self.ih.seek(start)
        data = self.ih.read(stop - start)
        out = self.task(data)
        if offset:
            out = out[offset:]
        return out


class Task(TaskBase):
    """Wrap a user callable as a stream task.

    The callable is used as a method (receiving the task instance) if its
    signature has a second positional argument, else as a plain function of
    the data block — same detection as the reference (base.py:863-884).
    """

    def __init__(self, ih, task, *, method=None, **kwargs):
        if method is None:
            method = self._is_method(task)
        if method:
            import types
            # MethodType also handles already-bound callables (the Task
            # instance becomes the first *free* argument), matching
            # reference base.py:879-882
            self.task = types.MethodType(task, self)
        else:
            self.task = task
        super().__init__(ih, **kwargs)

    @staticmethod
    def _is_method(func):
        """One *required* argument = function, two = method; anything
        else (or an un-inspectable callable) raises, so mistakes fail at
        construction (reference base.py:866-877 argspec counting,
        including the defaults subtraction)."""
        try:
            # inspect.signature already excludes a bound method's self
            # (unlike the reference's getfullargspec, base.py:869-874,
            # which therefore subtracts it)
            sig = inspect.signature(func)
            params = [p for p in sig.parameters.values()
                      if p.kind in (p.POSITIONAL_ONLY,
                                    p.POSITIONAL_OR_KEYWORD)]
            n_required = sum(p.default is p.empty for p in params)
            assert 1 <= n_required <= 2
            return n_required == 2
        except Exception as exc:
            raise TypeError(
                "cannot determine whether ``task`` is a function or "
                "method; pass in ``method``.") from exc


class SetAttribute(BaseTaskBase):
    """Attach or override stream attributes without touching the data.

    Zero-copy: frames pass straight through (reference base.py:892-948's
    ``simple_read`` fast path is the default here since frames are device
    arrays and no copy ever happens).  Overriding ``sample_rate`` or
    ``start_time`` relabels the stream without resampling.
    """

    def __init__(self, ih, *, start_time=None, sample_rate=None,
                 frequency=None, sideband=None, polarization=None):
        super().__init__(ih, start_time=start_time, sample_rate=sample_rate,
                         frequency=frequency, sideband=sideband,
                         polarization=polarization)

    def _read_frame(self, frame_index):
        spf = self._samples_per_frame
        start = frame_index * spf
        stop = min(start + spf, self.ih.shape[0])
        self.ih.seek(start)
        return self.ih.read(stop - start)
