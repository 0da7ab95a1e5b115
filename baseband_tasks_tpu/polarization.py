"""Polarization basis conversion and Jones-matrix calibration.

Beyond the reference: `mhvk/baseband-tasks` carries polarization
*labels* through its tasks (base.py:21,144-159) but has no operation
that acts on the polarization state itself.  Any real array/receiver
chain needs two: converting between linear and circular feed bases, and
applying (or undoing) a 2x2 Jones matrix per channel — complex gain,
differential delay/phase, and leakage calibration.

Both are elementwise 2-vector maps along the polarization axis — a
(2, 2) matmul XLA fuses into whatever surrounds it — so they ride
eager, compiled, and mesh-sharded execution unchanged.

Conventions: IAU/IEEE circular, ``L = (X - iY)/sqrt(2)``,
``R = (X + iY)/sqrt(2)`` (and the unitary inverse).  The conversion is
unitary, so total power is conserved exactly.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from .base import TaskBase, getattr_if_none
from .utils.device import device_complex

__all__ = ["ConvertPolarization", "ApplyJones"]

_LINEAR = ({"X", "Y"}, {"H", "V"})
_CIRCULAR = ({"L", "R"},)

#: unitary linear -> circular map in (L, R) <- (X, Y) component order
_L2C = np.array([[1.0, -1.0j], [1.0, 1.0j]], np.complex64) / np.sqrt(2.0)


def _find_pol_axis(ih, pol_axis, polarization, *, required_len=2):
    """(pol_axis, ordered labels or None) for a dual-pol stream."""
    if pol_axis is not None:
        axis = pol_axis % len(ih.sample_shape)
        if ih.sample_shape[axis] != required_len:
            raise ValueError(
                f"pol_axis {pol_axis} has length "
                f"{ih.sample_shape[axis]}, need {required_len}")
        labels = None
        if polarization is not None:
            pols = np.broadcast_to(np.asarray(polarization),
                                   ih.sample_shape[len(ih.sample_shape)
                                   - np.ndim(polarization):])
            rel = axis - (len(ih.sample_shape) - pols.ndim)
            if 0 <= rel < pols.ndim:
                index = [0] * pols.ndim
                index[rel] = slice(None)
                labels = [str(p).upper() for p in pols[tuple(index)]]
        return axis, labels
    if polarization is None:
        raise ValueError("need polarization labels (or an explicit "
                         "pol_axis=)")
    pols = np.broadcast_to(np.asarray(polarization),
                           ih.sample_shape[len(ih.sample_shape)
                                           - np.ndim(polarization):])
    for rel in range(pols.ndim):
        if pols.shape[rel] != required_len:
            continue
        index = [0] * pols.ndim
        index[rel] = slice(None)
        line = [str(p).upper() for p in pols[tuple(index)]]
        if len(set(line)) == required_len:
            return rel + len(ih.sample_shape) - pols.ndim, line
    raise ValueError("could not find a length-2 polarization axis in "
                     f"labels {polarization}")


def _apply_matrix(data, mat, axis):
    """v' = mat @ v along ``axis`` of the sample shape (data has a
    leading time axis).  ``mat`` broadcasts against the remaining
    sample axes: shape (..., 2, 2)."""
    a = axis + 1  # account for the time axis
    v = jnp.moveaxis(jnp.asarray(data), a, -1)
    out = jnp.einsum("...ij,...j->...i", mat, v,
                     preferred_element_type=v.dtype)
    return jnp.moveaxis(out, -1, a)


class ConvertPolarization(TaskBase):
    """Convert dual-polarization voltages between feed bases.

    Parameters
    ----------
    ih : stream
        Complex dual-polarization voltages.
    to : {'circular', 'linear'}
        Target basis.  A stream already in the target basis is
        rejected (use `SetAttribute` to relabel instead).
    pol_axis : int, optional
        Polarization axis within the sample shape; inferred from the
        labels when not given.

    The (X, Y) ↔ (L, R) maps are the unitary IAU/IEEE pair in the
    module docstring; output labels become ['L', 'R'] or ['X', 'Y'].
    """

    def __init__(self, ih, to, *, pol_axis=None, polarization=None):
        if ih.dtype.kind != "c":
            raise ValueError("polarization conversion needs complex "
                             "voltages")
        if to not in ("circular", "linear"):
            raise ValueError("to must be 'circular' or 'linear'")
        polarization = getattr_if_none(ih, "polarization", polarization,
                                       required=False)
        axis, labels = _find_pol_axis(ih, pol_axis, polarization)
        flip = False
        if labels is not None:
            pair = set(labels)
            src = "linear" if pair in _LINEAR else \
                "circular" if pair in _CIRCULAR else None
            if src == to:
                raise ValueError(f"stream is already {to}")
            if src is None and pol_axis is None:
                raise ValueError(f"cannot infer feed basis from labels "
                                 f"{pair}")
            # honor label order: ['Y','X'] / ['R','L'] streams get the
            # component-swapped matrix
            flip = labels[0] in ("Y", "V", "R")
        mat = _L2C if to == "circular" else _L2C.conj().T
        if flip:
            # reversed input components AND reversed output rows keep
            # the label order of the stream
            mat = mat[::-1, ::-1]
        self._mat = device_complex(np.ascontiguousarray(mat))
        self._axis = axis
        new_pol = None
        if polarization is not None:
            out = ["L", "R"] if to == "circular" else ["X", "Y"]
            if flip:
                out = out[::-1]
            pols = np.broadcast_to(
                np.asarray(polarization),
                ih.sample_shape[len(ih.sample_shape)
                                - np.ndim(polarization):]).copy()
            rel = axis - (len(ih.sample_shape) - pols.ndim)
            if 0 <= rel < pols.ndim:
                sl = [slice(None)] * pols.ndim
                new = np.empty(pols.shape, dtype="U2")
                for k in range(2):
                    sl[rel] = k
                    new[tuple(sl)] = out[k]
                new_pol = new
            # else: explicit pol_axis outside the span of the labels
            # (they broadcast over it) — the labels cannot name the
            # converted components, so leave them unset rather than
            # rewriting the wrong axis
        super().__init__(ih, polarization=new_pol)

    def task(self, data):
        return _apply_matrix(data, self._mat, self._axis)


class ApplyJones(TaskBase):
    """Apply a 2x2 Jones matrix (per channel) to dual-pol voltages.

    Parameters
    ----------
    ih : stream
        Complex dual-polarization voltages.
    jones : array-like (..., 2, 2)
        Jones matrices; leading axes broadcast against the sample shape
        with the polarization axis REMOVED (e.g. ``(n_chan, 2, 2)`` for
        a per-channel calibration of a ``(n_chan, 2)`` sample shape).
    inverse : bool
        Apply ``inv(jones)`` instead — i.e. *calibrate* data that the
        instrument corrupted with ``jones``.
    pol_axis : int, optional
        Polarization axis within the sample shape; inferred from the
        labels when not given.

    ``.inverse()`` builds the undo task, so
    ``ApplyJones(ApplyJones(sh, J), J, inverse=True)`` is the identity
    to float roundoff.
    """

    def __init__(self, ih, jones, *, inverse=False, pol_axis=None,
                 polarization=None):
        if ih.dtype.kind != "c":
            raise ValueError("ApplyJones needs complex voltages")
        polarization = getattr_if_none(ih, "polarization", polarization,
                                       required=False)
        axis, _ = _find_pol_axis(ih, pol_axis, polarization)
        jones = np.asarray(jones, np.complex64)
        if jones.shape[-2:] != (2, 2):
            raise ValueError(f"jones must end in (2, 2), got "
                             f"{jones.shape}")
        self._jones = jones
        self._inverse = bool(inverse)
        mat = np.linalg.inv(jones) if inverse else jones
        # broadcast-check against the sample shape without the pol
        # axis; extra leading dims would silently broadcast into the
        # time axis, so require the result to BE the non-pol shape
        rest = tuple(s for i, s in enumerate(ih.sample_shape)
                     if i != axis)
        lead = mat.shape[:-2]
        try:
            ok = (len(lead) <= len(rest)
                  and np.broadcast_shapes(lead, rest) == tuple(rest))
        except ValueError:
            ok = False
        if not ok:
            raise ValueError(
                f"jones leading shape {lead} does not broadcast "
                f"against the non-pol sample shape {rest}")
        # trailing-aligned broadcasting puts the matrix against the
        # value's (..., rest, 2) layout directly
        # f32-plane transfer (see ConvertPolarization)
        self._mat = device_complex(mat)
        self._axis = axis
        super().__init__(ih)

    def inverse(self, ih=None):
        """The task undoing this one (applied to ``ih`` or self)."""
        return ApplyJones(ih if ih is not None else self, self._jones,
                          inverse=not self._inverse,
                          pol_axis=self._axis)

    def task(self, data):
        return _apply_matrix(data, self._mat, self._axis)
