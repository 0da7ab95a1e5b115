"""Multi-chip sharding layer: device meshes, halo exchange, sharded ops.

The reference is strictly single-process (SURVEY.md §2: no DP/TP/PP/SP and
no comm backend); this layer is the device-mesh generalization prescribed by
SURVEY.md §7: time-axis sharding with ppermute halo exchange for
overlap-save ops, channel/polarization sharding for embarrassingly parallel
per-channel work, and psum reductions for integrate/fold.
"""

from .mesh import make_mesh, time_chan_specs
from .halo import halo_exchange, sharded_overlap_save
from .corner import corner_turn, sharded_channelize, sharded_dechannelize
from . import multihost

__all__ = ["make_mesh", "time_chan_specs", "halo_exchange",
           "sharded_overlap_save", "corner_turn", "sharded_channelize",
           "sharded_dechannelize", "multihost"]
