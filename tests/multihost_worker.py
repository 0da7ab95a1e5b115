"""Worker process for the two-process multihost tests (not a pytest file).

Launched by tests/test_multihost.py as:
    python multihost_worker.py <process_id> <num_processes> <port> \
        [outfile] [mode]

``mode`` selects the configuration:

- ``small`` (default): 2 virtual CPU devices per process, a
  (time=2, chan=2) mesh, toy shapes — the fast gate that the gloo
  backend computes what single-process XLA collectives do.
- ``production``: 4 virtual CPU devices per process, a
  (time=4, chan=2) mesh at production shapes (n_chan=128, 2^16-sample
  time shards, n_phase=64) — VERDICT round-3 item 3: one full sharded
  flagship step across OS processes at the shapes the flagship ships
  with.

Either way the time-axis halo exchange and the fold psum cross the
process boundary through the gloo collectives backend — the same code
path a multi-host run uses over its network (parallel/multihost.py).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))          # repo root, for the package

MODE = sys.argv[5] if len(sys.argv) > 5 else "small"
LOCAL_DEVICES = 4 if MODE == "production" else 2

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = \
    f"--xla_force_host_platform_device_count={LOCAL_DEVICES}"

import jax                                                  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import numpy as np                                          # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

CONFIGS = {
    "small": dict(n_chan=8, n_pol=2, dm=0.5, period_samples=(512, 1),
                  n_phase=8, block_samples=1024, chan_shards=2),
    "production": dict(n_chan=128, n_pol=2, dm=50.0,
                       period_samples=(16000, 3), n_phase=64,
                       block_samples=1 << 16, chan_shards=2),
}


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    from baseband_tasks_tpu.parallel import multihost
    try:
        multihost.initialize(coordinator_address=f"localhost:{port}",
                             num_processes=nproc, process_id=pid)
    except Exception as exc:          # pragma: no cover
        print(f"INIT_FAIL: {exc}")
        return 2
    if jax.process_count() != nproc \
            or jax.device_count() != LOCAL_DEVICES * nproc:
        print(f"INIT_FAIL: processes={jax.process_count()} "
              f"devices={jax.device_count()}")
        return 2

    from baseband_tasks_tpu.models import WidebandPulsarPipeline
    from baseband_tasks_tpu.utils import units as u

    cfg = CONFIGS[MODE]
    mesh = multihost.pod_mesh(chan=cfg["chan_shards"])
    n_time = LOCAL_DEVICES * nproc // cfg["chan_shards"]
    assert mesh.shape == {"time": n_time, "chan": cfg["chan_shards"]}
    pipe = WidebandPulsarPipeline(
        n_chan=cfg["n_chan"], n_pol=cfg["n_pol"], dm=cfg["dm"],
        freq_center=600 * u.MHz, chan_rate=250 * u.kHz,
        period_samples=cfg["period_samples"], n_phase=cfg["n_phase"],
        block_samples=cfg["block_samples"], mesh=mesh)
    T = pipe.global_block
    rng = np.random.default_rng(0)           # same data in every process
    xf_global = rng.standard_normal(
        (T, cfg["n_chan"], cfg["n_pol"], 2)).astype(np.float32)

    # every process hands over only ITS time shard of the global block
    sharding = NamedSharding(mesh, P("time", "chan"))
    local = xf_global[pid * (T // nproc):(pid + 1) * (T // nproc)]
    xf = multihost.host_local(local, sharding)
    prof, cnt = pipe.step_fn()(xf, np.float32(17))

    from jax.experimental import multihost_utils
    # reassemble the chan-sharded global profile on every process
    prof_full = np.asarray(multihost_utils.process_allgather(
        prof, tiled=True))
    assert prof_full.shape == (pipe.n_phase, pipe.n_chan, pipe.n_pol)
    cnt_full = np.asarray(multihost_utils.process_allgather(
        cnt, tiled=True))

    if cnt_full.sum() != T:
        print(f"FAIL counts: {cnt_full.sum()} != {T}")
        return 1
    # process 0 exports the result; the parent test re-runs the SAME
    # sharded config in a single process (same mesh shape over local
    # virtual devices) and checks the two agree — proving the
    # cross-process gloo collectives compute what single-process XLA
    # collectives do.
    if pid == 0 and len(sys.argv) > 4:
        np.savez(sys.argv[4], prof=prof_full, cnt=cnt_full)
    print(f"MULTIHOST_OK pid={pid}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
