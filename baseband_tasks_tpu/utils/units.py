"""Minimal units/quantity system for baseband_tasks_tpu.

The reference package (mhvk/baseband-tasks) leans on ``astropy.units``
throughout its public API (e.g. ``sample_rate`` is a Quantity in Hz,
dispersion measures are ``pc / cm**3`` quantities).  astropy is not a
dependency of this rebuild, so this module provides a small,
self-contained dimensional-analysis layer with the subset of behaviour the
framework needs:

- ``Unit``: scale + integer powers over three base dimensions
  (length [m], time [s], angle [cycle]).
- ``Quantity``: value (numpy scalar/array) + ``Unit``; arithmetic,
  comparisons, ``to`` / ``to_value`` conversion, numpy ufunc interop.

Design notes: units exist purely on the *host* at
pipeline-construction time; nothing in this module ever touches a device
array.  Device code receives plain floats (e.g. sample rate in Hz) that are
extracted with ``to_value`` when a jitted block function is built.

Reference-parity notes: mirrors the roles of ``astropy.units`` usage in
``/root/reference/baseband_tasks/base.py`` (sample_rate handling) and
``/root/reference/baseband_tasks/dm.py`` (dispersion-measure units).
"""

from __future__ import annotations

import numbers

import numpy as np

__all__ = [
    "Unit", "Quantity", "UnitsError",
    "one", "dimensionless", "percent",
    "s", "ms", "us", "ns", "minute", "hour", "day", "yr",
    "Hz", "kHz", "MHz", "GHz",
    "m", "cm", "km", "au", "pc", "kpc",
    "cycle", "rad", "deg", "arcmin", "arcsec", "mas",
    "DM", "quantity", "Jy", "mJy",
]


class UnitsError(Exception):
    """Raised on incompatible-unit operations or conversions."""


# Base dimensions: (length, time, angle, flux)
_NDIM = 4
_DIM_NAMES = ("m", "s", "cycle", "Jy")


class Unit:
    """A unit: a scale factor times integer powers of base dimensions.

    Base dimensions are metre, second, cycle and jansky.  ``scale`` is the
    factor to the coherent base unit, e.g. ``MHz.scale == 1e6`` with powers
    ``(0, -1, 0, 0)``.
    """

    __slots__ = ("scale", "powers", "name")

    # Make ndarray * Unit defer to our __rmul__ instead of broadcasting.
    __array_ufunc__ = None
    __array_priority__ = 10000

    def __init__(self, scale=1.0, powers=(0,) * _NDIM, name=None):
        if scale <= 0:
            raise UnitsError("unit scale must be positive")
        self.scale = float(scale)
        self.powers = tuple(powers)
        self.name = name

    # -- algebra ---------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit(self.scale * other.scale,
                        tuple(a + b for a, b in zip(self.powers, other.powers)))
        if isinstance(other, (numbers.Number, np.ndarray, list, tuple)):
            return Quantity(other, self)
        return NotImplemented

    def __rmul__(self, other):
        if isinstance(other, (numbers.Number, np.ndarray, list, tuple)):
            return Quantity(other, self)
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Unit(self.scale / other.scale,
                        tuple(a - b for a, b in zip(self.powers, other.powers)))
        if isinstance(other, numbers.Number):
            return Quantity(1.0 / other, self)
        return NotImplemented

    def __rtruediv__(self, other):
        inv = self ** -1
        if isinstance(other, Unit):
            return other * inv
        if isinstance(other, (numbers.Number, np.ndarray, list, tuple)):
            return Quantity(other, inv)
        return NotImplemented

    def __pow__(self, exponent):
        if exponent == 0:
            return Unit(1.0)
        p = [a * exponent for a in self.powers]
        if not all(float(x).is_integer() for x in p):
            raise UnitsError(f"non-integer unit powers from exponent {exponent}")
        return Unit(self.scale ** exponent, tuple(int(x) for x in p))

    # -- comparison / properties ----------------------------------------
    def __eq__(self, other):
        # relative comparison only: the default np.isclose atol (1e-8)
        # would equate any two sub-1e-8 scales (e.g. ns vs 2 ns)
        return (isinstance(other, Unit) and self.powers == other.powers
                and np.isclose(self.scale, other.scale, rtol=1e-14,
                               atol=0.0))

    def __hash__(self):
        return hash((round(np.log(self.scale), 12), self.powers))

    @property
    def physical_type(self):
        table = {
            (0, 0, 0, 0): "dimensionless",
            (1, 0, 0, 0): "length",
            (0, 1, 0, 0): "time",
            (0, -1, 0, 0): "frequency",
            (0, 0, 1, 0): "angle",
            (-2, 0, 0, 0): "dispersion measure",
            (0, 0, 0, 1): "flux density",
        }
        return table.get(self.powers, "unknown")

    def is_equivalent(self, other):
        if isinstance(other, Quantity):
            other = other.unit
        return self.powers == other.powers

    def to(self, other):
        """Conversion factor from this unit to ``other``."""
        if not self.is_equivalent(other):
            raise UnitsError(
                f"cannot convert {self} [{self.physical_type}] "
                f"to {other} [{other.physical_type}]")
        return self.scale / other.scale

    def decompose(self):
        return Unit(self.scale, self.powers)

    def __repr__(self):
        return f"Unit({self})"

    def __str__(self):
        if self.name:
            return self.name
        # prefer a registered named unit with the same scale and powers
        named = _NAMED_UNITS.get((round(np.log10(self.scale), 10),
                                  self.powers))
        if named:
            return named
        num, den = [], []
        for p, n in zip(self.powers, _DIM_NAMES):
            if p > 0:
                num.append(n if p == 1 else f"{n}{p}")
            elif p < 0:
                den.append(n if p == -1 else f"{n}{-p}")
        body = " ".join(num) or "1"
        if den:
            body += " / " + " ".join(den)
        if self.scale != 1.0:
            body = f"{self.scale:g} {body}"
        return body


def _as_quantity(x):
    if isinstance(x, Quantity):
        return x
    if isinstance(x, Unit):
        return Quantity(1.0, x)
    return Quantity(x, dimensionless)


class Quantity:
    """A numeric value with a unit.

    Thin wrapper (not an ndarray subclass): ``.value`` is a numpy scalar or
    array, ``.unit`` a :class:`Unit`.  Supports arithmetic, comparisons,
    ``to``/``to_value``, indexing, and a useful subset of numpy ufuncs.
    """

    __slots__ = ("value", "unit")
    # Let our __array_ufunc__ win over ndarray's.
    __array_priority__ = 10000

    def __init__(self, value, unit=None):
        if isinstance(value, Quantity):
            if unit is not None:
                value = value.to(unit)
            self.value = value.value
            self.unit = value.unit
            return
        if unit is None:
            unit = dimensionless
        if isinstance(unit, Quantity):
            value = np.asarray(value) * unit.value
            unit = unit.unit
        if isinstance(value, (list, tuple)):
            value = np.asarray(value)
        if isinstance(value, np.ndarray) and value.dtype.kind in "iu":
            value = value.astype(np.float64)
        elif isinstance(value, numbers.Integral):
            value = float(value)
        self.value = value
        self.unit = unit

    # -- conversion ------------------------------------------------------
    def to(self, unit):
        if isinstance(unit, Quantity):
            unit = unit.unit
        factor = self.unit.to(unit)
        if factor == 1.0:
            return Quantity(np.copy(self.value) if isinstance(self.value, np.ndarray)
                            else self.value, unit)
        return Quantity(self.value * factor, unit)

    def to_value(self, unit=None):
        if unit is None:
            return self.value
        if isinstance(unit, Quantity):
            unit = unit.unit
        factor = self.unit.to(unit)
        return self.value * factor if factor != 1.0 else self.value

    def decompose(self):
        return Quantity(self.value * self.unit.scale, Unit(1.0, self.unit.powers))

    @property
    def si(self):
        return self.decompose()

    # -- numpy-ish properties -------------------------------------------
    @property
    def shape(self):
        return np.shape(self.value)

    @property
    def ndim(self):
        return np.ndim(self.value)

    @property
    def size(self):
        return np.size(self.value)

    @property
    def dtype(self):
        return np.asarray(self.value).dtype

    @property
    def isscalar(self):
        return np.ndim(self.value) == 0

    def __len__(self):
        return len(self.value)

    def __getitem__(self, item):
        return Quantity(np.asarray(self.value)[item], self.unit)

    def __iter__(self):
        for v in np.atleast_1d(self.value):
            yield Quantity(v, self.unit)

    def reshape(self, *shape):
        return Quantity(np.reshape(self.value, shape if len(shape) != 1 else shape[0]),
                        self.unit)

    def squeeze(self, axis=None):
        return Quantity(np.squeeze(self.value, axis=axis), self.unit)

    def copy(self):
        return Quantity(np.copy(self.value), self.unit)

    def __array__(self, dtype=None, copy=None):
        if self.unit.powers != (0,) * _NDIM:
            raise UnitsError(
                f"only dimensionless quantities convert to bare arrays, not {self.unit}")
        return np.asarray(self.value * self.unit.scale, dtype=dtype)

    # -- arithmetic ------------------------------------------------------
    @staticmethod
    def _defer(other):
        """Operands with their own time semantics (Time/TimeDelta
        define __radd__/__rmul__ etc. for Quantity) must get Python's
        reflected-operator fallback, not be wrapped as dimensionless."""
        from .time import Time, TimeDelta
        return isinstance(other, (Time, TimeDelta))

    def __add__(self, other):
        if self._defer(other):
            return NotImplemented
        other = _as_quantity(other)
        return Quantity(self.value + other.to_value(self.unit), self.unit)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        if self._defer(other):
            return NotImplemented
        other = _as_quantity(other)
        return Quantity(self.value - other.to_value(self.unit), self.unit)

    def __rsub__(self, other):
        if self._defer(other):
            return NotImplemented
        other = _as_quantity(other)
        return Quantity(other.to_value(self.unit) - self.value, self.unit)

    def __mul__(self, other):
        if self._defer(other):
            return NotImplemented
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit * other)
        other = _as_quantity(other)
        return Quantity(self.value * other.value, self.unit * other.unit)

    def __rmul__(self, other):
        return self.__mul__(other)

    def __truediv__(self, other):
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit / other)
        other = _as_quantity(other)
        return Quantity(self.value / other.value, self.unit / other.unit)

    def __rtruediv__(self, other):
        other = _as_quantity(other)
        return Quantity(other.value / self.value, other.unit / self.unit)

    def __floordiv__(self, other):
        other = _as_quantity(other)
        return np.floor_divide(self.decompose().value, other.decompose().value) \
            if self.unit.is_equivalent(other.unit) else NotImplemented

    def __mod__(self, other):
        other = _as_quantity(other)
        return Quantity(np.mod(self.value, other.to_value(self.unit)), self.unit)

    def __pow__(self, exponent):
        return Quantity(self.value ** exponent, self.unit ** exponent)

    def __neg__(self):
        return Quantity(-self.value, self.unit)

    def __pos__(self):
        return Quantity(self.value, self.unit)

    def __abs__(self):
        return Quantity(np.abs(self.value), self.unit)

    # -- comparisons -----------------------------------------------------
    def _cmp_value(self, other):
        other = _as_quantity(other)
        return self.value, other.to_value(self.unit)

    def __eq__(self, other):
        try:
            a, b = self._cmp_value(other)
        except (UnitsError, TypeError):
            return NotImplemented if not isinstance(other, (Quantity, Unit)) else False
        return a == b

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else np.logical_not(eq)

    def __lt__(self, other):
        a, b = self._cmp_value(other)
        return a < b

    def __le__(self, other):
        a, b = self._cmp_value(other)
        return a <= b

    def __gt__(self, other):
        a, b = self._cmp_value(other)
        return a > b

    def __ge__(self, other):
        a, b = self._cmp_value(other)
        return a >= b

    def __hash__(self):
        if not self.isscalar:
            raise TypeError("unhashable array Quantity")
        d = self.decompose()
        return hash((float(d.value), d.unit.powers))

    def __bool__(self):
        return bool(self.value)

    def __float__(self):
        if self.unit.powers != (0,) * _NDIM:
            raise UnitsError(f"cannot convert {self.unit} quantity to float")
        return float(self.value * self.unit.scale)

    def __int__(self):
        return int(float(self))

    # -- numpy ufunc interop --------------------------------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__" or kwargs.get("out") is not None:
            return NotImplemented
        # Defer to higher-priority duck arrays (e.g. phases.Phase), which
        # know how to absorb a Quantity but not vice versa.
        for x in inputs:
            if (x is not self
                    and getattr(x, "__array_priority__", 0)
                    > self.__array_priority__):
                return NotImplemented
        name = ufunc.__name__
        if name in ("multiply", "divide", "true_divide"):
            a, b = [_as_quantity(x) for x in inputs]
            if name == "multiply":
                return Quantity(ufunc(a.value, b.value), a.unit * b.unit)
            return Quantity(ufunc(a.value, b.value), a.unit / b.unit)
        if name in ("add", "subtract"):
            a, b = [_as_quantity(x) for x in inputs]
            return Quantity(ufunc(a.value, b.to_value(a.unit)), a.unit)
        if name in ("negative", "absolute", "fabs", "positive", "conjugate", "conj"):
            (a,) = inputs
            return Quantity(ufunc(a.value), a.unit)
        if name in ("floor", "ceil", "rint", "trunc"):
            (a,) = inputs
            return Quantity(ufunc(a.value), a.unit)
        if name == "sqrt":
            (a,) = inputs
            return Quantity(np.sqrt(a.value * a.unit.scale), Unit(1.0, a.unit.powers) ** 0.5) \
                if all(p % 2 == 0 for p in a.unit.powers) else NotImplemented
        if name == "square":
            (a,) = inputs
            return Quantity(np.square(a.value), a.unit ** 2)
        if name in ("minimum", "maximum"):
            a, b = [_as_quantity(x) for x in inputs]
            return Quantity(ufunc(a.value, b.to_value(a.unit)), a.unit)
        if name in ("less", "less_equal", "greater", "greater_equal",
                    "equal", "not_equal"):
            a, b = [_as_quantity(x) for x in inputs]
            return ufunc(a.value, b.to_value(a.unit))
        if name in ("sin", "cos", "tan"):
            (a,) = inputs
            return ufunc(a.to_value(rad))
        if name in ("exp", "log", "log2", "log10", "expm1", "log1p"):
            (a,) = inputs
            return ufunc(a.to_value(dimensionless))
        if name == "isfinite":
            (a,) = inputs
            return np.isfinite(a.value)
        if name == "sign":
            (a,) = inputs
            return np.sign(a.value)
        if name == "floor_divide":
            a, b = [_as_quantity(x) for x in inputs]
            return np.floor_divide(a.value, b.to_value(a.unit))
        if name in ("remainder", "mod"):
            a, b = [_as_quantity(x) for x in inputs]
            return Quantity(np.remainder(a.value, b.to_value(a.unit)), a.unit)
        if name == "reciprocal":
            (a,) = inputs
            return Quantity(1.0 / a.value, a.unit ** -1)
        if name == "power":
            a, b = inputs
            return _as_quantity(a) ** b
        return NotImplemented

    def __array_function__(self, func, types, args, kwargs):
        # Support a curated set of numpy functions on Quantities.
        unary_keep = {np.mean, np.sum, np.min, np.max, np.amin, np.amax,
                      np.ptp, np.std, np.median, np.diff, np.squeeze,
                      np.ravel, np.atleast_1d, np.broadcast_to, np.reshape,
                      np.around, np.round, np.nanmin, np.nanmax, np.sort}
        if func in unary_keep:
            a = args[0]
            rest = args[1:]
            return Quantity(func(np.asarray(a.value), *rest, **kwargs), a.unit)
        if func is np.shape:
            return np.shape(args[0].value)
        if func is np.ndim:
            return np.ndim(args[0].value)
        if func is np.size:
            return np.size(args[0].value)
        if func in (np.isclose, np.allclose):
            a = _as_quantity(args[0])
            b = _as_quantity(args[1])
            kwargs.pop("atol_unit", None)
            atol = kwargs.pop("atol", None)
            if atol is not None:
                kwargs["atol"] = _as_quantity(atol).to_value(a.unit)
            else:
                kwargs["atol"] = 0.0
            return func(a.value, b.to_value(a.unit), *args[2:], **kwargs)
        if func is np.concatenate:
            seq = args[0]
            unit = seq[0].unit
            return Quantity(np.concatenate([q.to_value(unit) for q in seq],
                                           *args[1:], **kwargs), unit)
        if func is np.where:
            cond, a, b = args
            a = _as_quantity(a)
            b = _as_quantity(b)
            return Quantity(np.where(cond, a.value, b.to_value(a.unit)), a.unit)
        if func in (np.argmin, np.argmax, np.argsort, np.searchsorted):
            a = args[0]
            rest = [x.to_value(a.unit) if isinstance(x, Quantity) else x
                    for x in args[1:]]
            return func(np.asarray(a.value), *rest, **kwargs)
        return NotImplemented

    def __repr__(self):
        return f"<Quantity {self.value} {self.unit}>"

    def __format__(self, spec):
        return f"{self.value:{spec}} {self.unit}" if spec else f"{self.value} {self.unit}"

    def __str__(self):
        return f"{self.value} {self.unit}"


def quantity(value, unit=None):
    return Quantity(value, unit)


# -- unit definitions ----------------------------------------------------
dimensionless = Unit(1.0, (0, 0, 0, 0), name="")
one = dimensionless
percent = Unit(0.01, (0, 0, 0, 0), name="%")

m = Unit(1.0, (1, 0, 0, 0), name="m")
cm = Unit(1e-2, (1, 0, 0, 0), name="cm")
km = Unit(1e3, (1, 0, 0, 0), name="km")
au = Unit(1.495978707e11, (1, 0, 0, 0), name="AU")
pc = Unit(3.0856775814913673e16, (1, 0, 0, 0), name="pc")
kpc = Unit(3.0856775814913673e19, (1, 0, 0, 0), name="kpc")

s = Unit(1.0, (0, 1, 0, 0), name="s")
ms = Unit(1e-3, (0, 1, 0, 0), name="ms")
us = Unit(1e-6, (0, 1, 0, 0), name="us")
ns = Unit(1e-9, (0, 1, 0, 0), name="ns")
minute = Unit(60.0, (0, 1, 0, 0), name="min")
min = minute                # astropy-parity alias (shadows builtins.min
#                             only inside this module's namespace)
hour = Unit(3600.0, (0, 1, 0, 0), name="h")
day = Unit(86400.0, (0, 1, 0, 0), name="d")
yr = Unit(365.25 * 86400.0, (0, 1, 0, 0), name="yr")

Hz = Unit(1.0, (0, -1, 0, 0), name="Hz")
kHz = Unit(1e3, (0, -1, 0, 0), name="kHz")
MHz = Unit(1e6, (0, -1, 0, 0), name="MHz")
GHz = Unit(1e9, (0, -1, 0, 0), name="GHz")

cycle = Unit(1.0, (0, 0, 1, 0), name="cycle")
rad = Unit(1.0 / (2.0 * np.pi), (0, 0, 1, 0), name="rad")
deg = Unit(1.0 / 360.0, (0, 0, 1, 0), name="deg")
arcmin = Unit(1.0 / 360.0 / 60.0, (0, 0, 1, 0), name="arcmin")
arcsec = Unit(1.0 / 360.0 / 3600.0, (0, 0, 1, 0), name="arcsec")
mas = Unit(1.0 / 360.0 / 3600.0 / 1000.0, (0, 0, 1, 0), name="mas")

Jy = Unit(1.0, (0, 0, 0, 1), name="Jy")
mJy = Unit(1e-3, (0, 0, 0, 1), name="mJy")

#: Dispersion-measure unit, pc / cm**3 (dims: length**-2).
DM = Unit(pc.scale / cm.scale ** 3, (-2, 0, 0, 0), name="pc / cm3")

#: Display lookup for derived units that match a named one.
_NAMED_UNITS = {}
for _u in (s, ms, us, ns, minute, hour, day, Hz, kHz, MHz, GHz, m, cm, km,
           pc, cycle, rad, deg, Jy, mJy, DM):
    _NAMED_UNITS.setdefault((round(np.log10(_u.scale), 10), _u.powers),
                            _u.name)
del _u
