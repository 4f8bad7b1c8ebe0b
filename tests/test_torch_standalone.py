"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, and its own copies of the numpy modules (utils/config,
configs/presets, data/*, native/, eval/metrics) give what poi_tpu's give."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from poi_tpu.configs import presets as jax_presets
from poi_tpu.data.dataset import load_dataset as jax_load_dataset
from poi_tpu.eval.metrics import ranking_metrics as jax_ranking_metrics
from poi_tpu_torch import native
from poi_tpu_torch.configs import presets
from poi_tpu_torch.data import checkins, dataset
from poi_tpu_torch.eval.metrics import ranking_metrics
from poi_tpu_torch.utils.config import DataConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_poi_tpu():
    """Every Python module of poi_tpu_torch (but ``__main__``, which runs the
    CLI), imported in a fresh interpreter, leaves no ``jax``/``jax.*`` and no
    ``poi_tpu``/``poi_tpu.*`` module loaded."""
    code = (
        "import importlib, pathlib, sys\n"
        "root = pathlib.Path('poi_tpu_torch')\n"
        "names = ['.'.join(p.with_suffix('').parts).removesuffix('.__init__') for p in sorted(root.rglob('*.py'))\n"
        "         if p.name != '__main__.py']\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'poi_tpu') or m.startswith(('jax.', 'poi_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.strip()) >= 30  # the package's modules, the copies and the kernels' wrappers


def test_presets_equal_poi_tpus():
    assert presets.list_configs() == jax_presets.list_configs()
    for name in presets.list_configs():
        assert dataclasses.asdict(presets.get_config(name)) == dataclasses.asdict(jax_presets.get_config(name)), name


def _assert_datasets_equal(a, b):
    assert type(a).__module__ == "poi_tpu_torch.data.dataset" and type(b).__module__ == "poi_tpu.data.dataset"
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            for g in dataclasses.fields(x):
                np.testing.assert_array_equal(getattr(x, g.name), getattr(y, g.name), err_msg=f"{f.name}.{g.name}")
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f.name)


@pytest.mark.parametrize("name, kind", [("smoke", "synthetic"), ("lstm_bpr_foursquare", "foursquare"),
                                        ("strnn_gowalla", "gowalla")])
def test_load_dataset_equals_poi_tpus_with_separate_caches(name, kind, tmp_path, monkeypatch):
    """Both packages build the same arrays, each caches under its own
    directory and variable, and a cached load gives the same dataset again."""
    monkeypatch.setenv("POI_TPU_TORCH_DATA_CACHE", str(tmp_path / "port"))
    monkeypatch.setenv("POI_TPU_DATA_CACHE", str(tmp_path / "jax"))
    small = {"data.num_users": "48", "data.num_pois": "300", "data.max_seq_len": "12", "data.val_fraction": "0.1"}
    cfg = presets.get_config(name).with_overrides(small)
    jcfg = jax_presets.get_config(name).with_overrides(small)
    assert cfg.data.dataset == kind
    ours, theirs = dataset.load_dataset(cfg.data), jax_load_dataset(jcfg.data)
    _assert_datasets_equal(ours, theirs)
    assert len(list((tmp_path / "port").glob("*.pkl"))) == 1 and len(list((tmp_path / "jax").glob("*.pkl"))) == 1
    _assert_datasets_equal(dataset.load_dataset(cfg.data), theirs)  # from the port's cache


@pytest.mark.parametrize("seed, T", [(0, 16), (1, 8)])
def test_native_windowing_equals_numpy_path(seed, T):
    if native.load() is None:
        pytest.skip("no C++ toolchain available")
    assert os.path.dirname(native._LIB) == os.path.join(REPO, "poi_tpu_torch", "native")
    table = checkins.synthesize_checkins(120, 400, 35, seed=seed)
    cfg = DataConfig(min_user_checkins=4, min_poi_checkins=1, max_seq_len=T, val_fraction=0.1)
    a = dataset.build_dataset(table, cfg, use_native=True)
    b = dataset.build_dataset(table, cfg, use_native=False)
    for split in ("train", "val", "test"):
        x, y = getattr(a, split), getattr(b, split)
        for f in dataclasses.fields(x):
            np.testing.assert_array_equal(getattr(x, f.name), getattr(y, f.name), err_msg=f"{split}.{f.name}")


def test_ranking_metrics_equal_poi_tpus():
    rng = np.random.default_rng(0)
    top = rng.integers(0, 50, size=(40, 10))
    tgt = rng.integers(0, 50, size=40)
    top[:8, 3] = tgt[:8]
    want = jax_ranking_metrics(top, tgt)
    got = ranking_metrics(top, tgt)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
