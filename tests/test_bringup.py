"""The GPU bring-up surface, exercised on the CPU.

- ``chip_smoke.py``'s phases at small widths (the script itself refuses
  to run without a GPU);
- the fold's two accumulation methods against a float64 fold;
- the compile-cache placement done by the entry scripts;
- importing the package without the optional ``yaml``/``h5py``;
- the trace reduction of tools/trace_reduce.py on a recorded CPU trace;
- the run-time helpers of utils/runtime.py.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import chip_smoke as cs  # noqa: E402


def _run(code, env=None, cwd=None, timeout=300):
    """Run ``code`` in a fresh CPU-only Python process."""
    full = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    full.pop("JAX_COMPILATION_CACHE_DIR", None)
    full.update(env or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=full,
                          cwd=cwd or ROOT, timeout=timeout)


class TestChipSmokePhases:
    """Every phase of chip_smoke.py at the small CPU shapes, with the
    same checks (60 dB against the numpy-engine reference, bit-exact
    decode) that the GPU run applies at full width."""

    def test_decode(self):
        cs.phase_decode(cs.SMALL)

    def test_main_path(self):
        rate = cs.phase_main(cs.SMALL)
        assert rate > 0

    def test_library_path(self):
        rate = cs.phase_library(cs.SMALL)
        assert rate > 0

    def test_four_wideband(self):
        cs.phase_four_wideband(cs.SMALL4, jax.devices()[:4], chunk=8)

    def test_four_library(self):
        cs.phase_four_library(cs.SMALL, jax.devices()[:4])

    def test_no_compile_hint_on_accelerator(self, monkeypatch):
        """On an accelerator backend the eager numpy-engine reference
        reads a file of short VDIF frames (>= 64 frames per Dedisperse
        window), which raises the one-time compile hint — an error
        under this suite's warnings-as-errors, as under
        ``pytest -m gpu`` on the card.  The phase silences it."""
        from dataclasses import replace
        from baseband_tasks_tpu.base import Base
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        monkeypatch.setattr(Base, "_hinted_compiled", False)
        cs.phase_library(replace(cs.SMALL, max_file_spf=100))
        assert Base._hinted_compiled   # the hint was reached, silenced

    def test_check_raises_below_bar(self):
        ref = np.ones(64)
        cs.check("same", ref, ref)
        with pytest.raises(AssertionError, match="dB"):
            cs.check("off", ref * 1.01, ref)

    @pytest.mark.parametrize("err,expect", [(1e-3, 60.0), (1e-6, 120.0)])
    def test_snr_db(self, err, expect):
        ref = np.ones(1000)
        assert cs.snr_db(ref + err, ref) == pytest.approx(expect)

    def test_decode_words_host_order(self):
        """Byte k of word w is time sample 4w + k."""
        w = np.array([[0x04030201]], np.uint32)
        np.testing.assert_array_equal(
            cs.decode_words_host(w)[:, 0],
            np.array([1, 2, 3, 4], np.float32) - 127.5)

    def test_library_block_choice(self):
        from baseband_tasks_tpu.utils import units as u
        sh = cs.SMALL
        idx = np.arange(sh.n_chan) - sh.n_chan / 2 + 0.5
        freqs = u.Quantity((1400 + 0.25 * idx)[:, None], u.MHz)
        block, margin, spf = cs._library_block(sh, 250 * u.kHz, freqs,
                                               sh.dm, 1400 * u.MHz)
        assert sh.block <= block <= 1.25 * sh.block
        assert 250000 % spf == 0 and block % spf == 0 and spf >= 16
        assert margin >= 256


class TestChipSmokeRefusesCPU:
    def test_exits_nonzero_without_gpu(self):
        r = subprocess.run([sys.executable, os.path.join(ROOT,
                                                         "chip_smoke.py")],
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert "no GPU" in r.stderr

    def test_exits_nonzero_alone(self, tmp_path):
        """Copied into a directory without the package it fails too."""
        import shutil
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        env.pop("PYTHONPATH", None)
        r = subprocess.run([sys.executable, "chip_smoke.py"],
                           capture_output=True, text=True, timeout=300,
                           cwd=tmp_path, env=env)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout

    @pytest.mark.parametrize("script", ["bench.py",
                                        "tools/bench_full.py",
                                        "tools/profile_plain.py"])
    def test_benchmarks_refuse_cpu(self, script):
        r = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                           capture_output=True, text=True, timeout=300,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode != 0 and "no GPU" in r.stderr


class TestFoldMethods:
    """The fold's one-hot product (HIGHEST precision) and segment_sum
    both match a float64 fold; the one-hot form was the faster on an
    H100 (PERF.md), so it is the default."""

    @pytest.mark.parametrize("method", ["onehot", "segment"])
    @pytest.mark.parametrize("shape", [(4096,), (4096, 8), (4096, 4, 2)])
    def test_matches_float64(self, method, shape):
        from baseband_tasks_tpu.ops.fold import fold_accumulate
        rng = np.random.default_rng(len(shape))
        p = rng.exponential(size=shape).astype(np.float32)
        b = rng.integers(0, 32, shape[0]).astype(np.int32)
        prof, cnt = jax.jit(lambda x, y: fold_accumulate(
            x, y, 32, method=method))(p, b)
        ref = np.zeros((32,) + shape[1:])
        np.add.at(ref, b, p.astype(np.float64))
        assert cs.snr_db(np.asarray(prof), ref) > 120
        np.testing.assert_array_equal(np.asarray(cnt),
                                      np.bincount(b, minlength=32))

    def test_unknown_method(self):
        from baseband_tasks_tpu.ops.fold import fold_accumulate
        with pytest.raises(ValueError, match="method"):
            fold_accumulate(jnp.ones((8,)), jnp.zeros(8, jnp.int32), 4,
                            method="mxu")

    @pytest.mark.parametrize("n_phase", [1, 64, 1 << 15])
    def test_fold_bins_matches_numpy(self, n_phase):
        from baseband_tasks_tpu.ops.fold import (fold_bins, fold_bins_ref,
                                                 fold_phase_vector)
        fold = fold_phase_vector(0.3217, 1.0 / 97.3)
        t = np.arange(1 << 14, dtype=np.int32)
        got = np.asarray(jax.jit(lambda f, tt: fold_bins(
            f, tt, n_phase))(jnp.asarray(fold), t))
        np.testing.assert_array_equal(got, fold_bins_ref(fold, t, n_phase))
        assert got.min() >= 0 and got.max() < n_phase


class TestCompileCache:
    CODE = """
        import json, sys, os, jax, jax.numpy as jnp
        sys.path.insert(0, os.environ["REPO_ROOT"])
        from baseband_tasks_tpu.utils.runtime import configure_compile_cache
        path = configure_compile_cache(os.environ["FAKE_ROOT"])
        jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()
        print(json.dumps({"path": path}))
    """

    def _files(self, d):
        return [f for _, _, fs in os.walk(d) for f in fs] \
            if os.path.isdir(d) else []

    def test_default_under_root(self, tmp_path):
        root = tmp_path / "checkout"
        root.mkdir()
        r = _run(self.CODE, env={
            "REPO_ROOT": ROOT, "FAKE_ROOT": str(root),
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
        assert r.returncode == 0, r.stderr
        path = json.loads(r.stdout.strip().splitlines()[-1])["path"]
        assert path == str(root / ".jax_cache")
        assert self._files(path)

    def test_env_variable_wins(self, tmp_path):
        root = tmp_path / "checkout"
        root.mkdir()
        cache = tmp_path / "elsewhere"
        r = _run(self.CODE, env={
            "REPO_ROOT": ROOT, "FAKE_ROOT": str(root),
            "JAX_COMPILATION_CACHE_DIR": str(cache),
            "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"})
        assert r.returncode == 0, r.stderr
        path = json.loads(r.stdout.strip().splitlines()[-1])["path"]
        assert path == str(cache)
        assert self._files(cache)
        assert not (root / ".jax_cache").exists()

    def test_not_configured_at_import(self):
        r = _run("""
            import jax, baseband_tasks_tpu, baseband_tasks_tpu.models
            print(repr(jax.config.jax_compilation_cache_dir))
        """)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == "None"


class TestOptionalImports:
    BLOCK = """
        import sys
        class Block:
            def find_spec(self, name, path, target=None):
                if name.split('.')[0] in {mods!r}:
                    raise ImportError('blocked ' + name)
        sys.meta_path.insert(0, Block())
    """

    @pytest.mark.parametrize("mods", [("yaml",), ("h5py",),
                                      ("yaml", "h5py")])
    def test_package_imports_without(self, mods):
        r = _run(self.BLOCK.format(mods=mods) + """
        import baseband_tasks_tpu, baseband_tasks_tpu.models
        import baseband_tasks_tpu.io
        from baseband_tasks_tpu.io import vdif, hdf5
        print('ok')
        """)
        assert r.returncode == 0, r.stderr
        assert r.stdout.strip() == "ok"

    def test_yaml_needed_only_to_open_hdf5(self, tmp_path):
        pytest.importorskip("h5py")
        from baseband_tasks_tpu import NoiseGenerator
        from baseband_tasks_tpu.io import hdf5
        from baseband_tasks_tpu.utils import Time, units as u
        sh = NoiseGenerator(shape=(1024, 2), start_time=Time.from_mjd(58000.),
                            sample_rate=1 * u.MHz, samples_per_frame=1024,
                            seed=1)
        path = str(tmp_path / "x.h5")
        with hdf5.open(path, "w", template=sh) as fw:
            fw.write(np.asarray(sh.read()))
        r = _run(self.BLOCK.format(mods=("yaml",)) + f"""
        from baseband_tasks_tpu.io import hdf5
        try:
            hdf5.open({path!r})
        except ImportError as exc:
            print('ImportError', exc)
        """)
        assert r.returncode == 0, r.stderr
        assert "ImportError" in r.stdout and "yaml" in r.stdout


class TestTraceReduce:
    def test_union(self):
        from trace_reduce import union_ns
        assert union_ns([(0, 10), (5, 15), (20, 30)]) == 25
        assert union_ns([]) == 0

    def test_cpu_trace(self, tmp_path):
        from trace_reduce import device_time, find_xplane
        f = jax.jit(lambda x: jnp.fft.fft(x * 2))
        x = jnp.ones((1 << 12, 8), jnp.complex64)
        f(x).block_until_ready()
        with jax.profiler.trace(str(tmp_path)):
            for _ in range(3):
                f(x).block_until_ready()
        busy, window, kernels = device_time(find_xplane(str(tmp_path)),
                                            plane_prefix="/host:CPU")
        assert 0 < busy <= window
        assert kernels
        with pytest.raises(ValueError, match="no device events"):
            device_time(find_xplane(str(tmp_path)))


class TestRuntime:
    def test_require_gpu_refuses_cpu(self):
        from baseband_tasks_tpu.utils.runtime import require_gpu
        with pytest.raises(SystemExit, match="no GPU"):
            require_gpu()

    def test_device_summary(self):
        from baseband_tasks_tpu.utils.runtime import device_summary
        d = device_summary()
        assert d == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                     "count": len(jax.devices())}

    def test_power_limit_without_nvidia_smi(self, monkeypatch):
        from baseband_tasks_tpu.utils import runtime
        monkeypatch.setenv("PATH", "")
        assert runtime.gpu_name_and_power_limit() == "not available"

    @pytest.mark.parametrize("var", ["JAX_COORDINATOR_ADDRESS",
                                     "SLURM_JOB_ID"])
    def test_multihost_detection(self, monkeypatch, var):
        from baseband_tasks_tpu.parallel import multihost
        for v in ("JAX_COORDINATOR_ADDRESS", "SLURM_JOB_ID",
                  "OMPI_COMM_WORLD_SIZE"):
            monkeypatch.delenv(v, raising=False)
        assert not multihost._in_multihost_env()
        monkeypatch.setenv(var, "1")
        assert multihost._in_multihost_env()


@pytest.fixture
def gpu_device():
    """Skip unless JAX's default device is a GPU (decided at run time,
    never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/ on the card (chip_smoke.py runs the "
                    "same phases)")
    return jax.devices()[0]


@pytest.mark.gpu
class TestOnCard:
    """chip_smoke.py's phases at full flagship width, on the card."""

    def test_decode_full(self, gpu_device):
        cs.phase_decode(cs.FULL)

    def test_main_path_full(self, gpu_device):
        cs.phase_main(cs.FULL)

    def test_library_path_full(self, gpu_device):
        cs.phase_library(cs.FULL)


class TestGraftEntry:
    def test_entry(self):
        import __graft_entry__ as g
        fn, args = g.entry()
        prof, cnt = fn(*args)
        assert float(np.asarray(cnt).sum()) == args[0].shape[0]

    def test_dryrun_multichip_4(self):
        """The four-device dry run (both layers, every factorization)
        on the virtual CPU mesh."""
        import __graft_entry__ as g
        g.dryrun_multichip(4)
