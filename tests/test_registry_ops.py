"""Top-level open() dispatch, the fold op, and stream monitors."""

import numpy as np
import pytest

import baseband_tasks_tpu as bbt
from baseband_tasks_tpu import NoiseGenerator, SetAttribute
from baseband_tasks_tpu.ops import fold_accumulate
from baseband_tasks_tpu.utils import Time, units as u
from baseband_tasks_tpu.utils.profiling import monitor

START = Time("2018-01-01T00:00:00.000000000")


def make_stream():
    return SetAttribute(
        NoiseGenerator(shape=(4096, 2), start_time=START,
                       sample_rate=u.Quantity(1 << 20, u.Hz),
                       samples_per_frame=1024, seed=3),
        frequency=[400., 400.] * u.MHz, sideband=1)


class TestOpenDispatch:
    def test_hdf5_detect(self, tmp_path):
        from baseband_tasks_tpu.io import hdf5
        sh = make_stream()
        path = str(tmp_path / "x.h5")
        with hdf5.open(path, "w", template=sh) as fw:
            fw.write(np.asarray(sh.read()))
        fr = bbt.open(path)  # no format given
        assert fr.shape == (4096, 2)

    def test_vdif_by_extension(self, tmp_path):
        from baseband_tasks_tpu.io import vdif
        sh = make_stream()
        path = str(tmp_path / "x.vdif")
        with vdif.open(path, "w", template=sh, bps=8) as fw:
            fw.write(np.asarray(sh.read()) * 16)
        with bbt.open(path, sample_rate=u.Quantity(1 << 20, u.Hz)) as fr:
            assert fr.shape == (4096, 2)

    def test_explicit_format(self, tmp_path):
        from baseband_tasks_tpu.io import hdf5
        sh = make_stream()
        path = str(tmp_path / "odd_extension.bin")
        with hdf5.open(path, "w", template=sh) as fw:
            fw.write(np.asarray(sh.read()))
        fr = bbt.open(path, format="hdf5")
        assert fr.shape == (4096, 2)

    def test_unknown_format(self, tmp_path):
        path = tmp_path / "junk.bin"
        path.write_bytes(b"this is not a stream file")
        with pytest.raises(ValueError, match="detect"):
            bbt.open(str(path))
        with pytest.raises(ValueError, match="unknown format"):
            bbt.open(str(path), format="nope")

    def test_write_needs_format(self, tmp_path):
        with pytest.raises(ValueError, match="format"):
            bbt.open(str(tmp_path / "y.h5"), "w")


class TestFoldAccumulate:
    def test_methods_agree(self):
        import jax.numpy as jnp
        rng = np.random.default_rng(0)
        power = jnp.asarray(rng.standard_normal((1000, 4)).astype(np.float32))
        bins = jnp.asarray(rng.integers(0, 16, 1000).astype(np.int32))
        p1, c1 = fold_accumulate(power, bins, 16, method="onehot")
        p2, c2 = fold_accumulate(power, bins, 16, method="segment")
        np.testing.assert_allclose(np.asarray(p1), np.asarray(p2),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))

    def test_counts_sum(self):
        import jax.numpy as jnp
        bins = jnp.asarray(np.arange(100, dtype=np.int32) % 7)
        power = jnp.ones((100, 2), jnp.float32)
        prof, cnt = fold_accumulate(power, bins, 7)
        assert float(np.asarray(cnt).sum()) == 100


class TestMonitors:
    def test_counts_and_report(self):
        from baseband_tasks_tpu import Square
        sq = Square(make_stream())
        mons = monitor(sq)
        assert len(mons) == 3  # Square, SetAttribute, NoiseGenerator
        np.asarray(sq.read(2048))
        assert mons[0].samples == 2048
        assert mons[0].frames == 2
        assert "samples/s" in mons[0].report()
        # the underlying generator was also exercised
        assert mons[-1].samples >= 2048


class TestMultihost:
    def test_initialize_noop_single_process(self):
        from baseband_tasks_tpu.parallel import multihost
        multihost.initialize()  # must not raise on a single process
        mesh = multihost.pod_mesh(time=-1, chan=2)
        assert mesh.shape["chan"] == 2
        assert mesh.shape["time"] * 2 == len(__import__("jax").devices())

    def test_host_local_roundtrip(self):
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from baseband_tasks_tpu.parallel import multihost
        mesh = multihost.pod_mesh(time=4, chan=2)
        x = np.arange(64, dtype=np.float32).reshape(8, 8)
        arr = multihost.host_local(x, NamedSharding(mesh, P("time", "chan")))
        np.testing.assert_array_equal(np.asarray(arr), x)


class TestEntryPointPlugins:
    """Third-party formats register via the baseband_tasks_tpu.io
    entry-point group (the reference's baseband.io plugin analogue)."""

    def _fake_eps(self, plugin):
        class EP:
            name = "fake"

            @staticmethod
            def load():
                return plugin

        def entry_points(group=None):
            assert group == "baseband_tasks_tpu.io"
            return [EP]

        return entry_points

    def test_plugin_format_dispatch(self, tmp_path, monkeypatch):
        from baseband_tasks_tpu import registry
        import importlib.metadata as md

        calls = {}

        class Plugin:
            @staticmethod
            def open(name, mode="r", **kw):
                calls["args"] = (str(name), mode)
                return "handle"

            @staticmethod
            def detect_format(head, name):
                return head.startswith(b"FAKE")

        monkeypatch.setattr(md, "entry_points", self._fake_eps(Plugin))
        monkeypatch.setattr(registry, "_entry_points_loaded", False)
        monkeypatch.setattr(registry, "FORMATS", dict(registry.FORMATS))

        p = tmp_path / "x.bin"
        p.write_bytes(b"FAKEDATA" * 8)
        # auto-detection via the plugin's detect_format
        assert registry.open(p) == "handle"
        assert calls["args"] == (str(p), "r")
        # explicit format= dispatch
        assert registry.open(p, "r", format="fake") == "handle"

    def test_builtin_not_overridden(self, tmp_path, monkeypatch):
        from baseband_tasks_tpu import registry
        import importlib.metadata as md

        class Evil:
            name = "vdif"

            @staticmethod
            def load():  # pragma: no cover - must not be reached
                raise AssertionError("built-in was overridden")

        monkeypatch.setattr(md, "entry_points",
                            lambda group=None: [Evil])
        monkeypatch.setattr(registry, "_entry_points_loaded", False)
        monkeypatch.setattr(registry, "FORMATS", dict(registry.FORMATS))
        registry._load_entry_points()
        assert registry.FORMATS["vdif"][0] is not Evil

    def test_broken_detector_skipped(self, tmp_path, monkeypatch):
        """One plugin whose detect raises must not disable detection of
        later formats."""
        from baseband_tasks_tpu import registry

        def boom(head, name):
            raise UnicodeDecodeError("utf-8", b"", 0, 1, "boom")

        formats = dict(registry.FORMATS)
        # broken detector FIRST in iteration order
        formats = {"broken": (lambda *a, **k: None, boom), **formats}
        monkeypatch.setattr(registry, "FORMATS", formats)
        monkeypatch.setattr(registry, "_entry_points_loaded", True)

        import numpy as np
        from baseband_tasks_tpu.io import hdf5
        p = tmp_path / "x.h5"
        src = make_stream()
        with hdf5.open(str(p), "w", template=src) as w:
            w.write(np.asarray(src.read(1024)))
        with registry.open(p) as r:   # detection must reach hdf5
            assert r.sample_shape == src.sample_shape
            assert np.asarray(r.read(1024)).shape[0] == 1024
