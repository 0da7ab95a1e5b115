"""Device placement of the constant arrays tasks cache on device
(chirps, response FTs, Wiener gains, LO phase factors, Jones matrices).

Device compute is single precision: complex constants are placed as
complex64 and real ones as float32, whatever precision the host built
them in.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

__all__ = ["device_complex"]


def device_complex(arr):
    """Place a host array on device: complex as complex64, anything
    else as float32."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "c":
        return jnp.asarray(arr.astype(np.complex64, copy=False))
    return jnp.asarray(arr.astype(np.float32, copy=False))
