"""The port's serving slice held against poi_tpu on the same weights: param
conversion, the scoring query, the featurizer, Recommender.recommend as a
whole, and the CLI without JAX.

Smoke-config dataset with config #1's model widths (64-d). The JAX side runs
on the CPU: the lax.scan GRU cell and, with eval.topk_impl=pallas, the
top-k kernel in Pallas interpret mode."""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from poi_tpu.eval.serve import Checkin as JaxCheckin
from poi_tpu.eval.serve import Recommender as JaxRecommender
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.models.base import build_model as jax_build_model
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import load_npz, params_from_jax, params_to_numpy, save_npz
from poi_tpu_torch.data.dataset import load_dataset
from poi_tpu_torch.eval.serve import Checkin, Recommender
from poi_tpu_torch.models.base import DataDims, batch_to, build_model

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Queries: bf16 operands with exact products and fp32 sums on both sides, in
# different orders; measured agreement is ~1e-7 at these sizes.
QUERY_TOL = 1e-5
# Two candidates whose fp64 scores differ by less than this may swap between
# the packages (their fp32 sums differ in the last bits); anything further
# apart must rank the same.
TIE_TOL = 1e-5


def _jax(cfg):
    """The same configuration as poi_tpu's own Config."""
    return JaxConfig.from_dict(cfg.to_dict())


@pytest.fixture(scope="module")
def setup():
    cfg = get_config("smoke").with_overrides(
        {"model.embed_dim": "64", "model.hidden_dim": "64", "eval.topk_impl": "pallas"}
    )
    ds = load_dataset(cfg.data)
    jmodel = jax_build_model(_jax(cfg).model, JaxDataDims.from_dataset(ds))
    jparams = jmodel.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    model = build_model(cfg.model, DataDims.from_dataset(ds), device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return cfg, ds, jmodel, jparams, tree, model


def _histories_from_test(ds, n, checkin=Checkin):
    """Raw histories rebuilt from eval rows: POI ids and hour-of-week, with
    the catalog's coordinates."""
    ex = ds.test
    out = []
    for i in np.linspace(0, len(ex) - 1, n).astype(int):
        m = int(ex.mask[i].sum())
        out.append([
            checkin(poi=int(p), timestamp=float(tb) * 3600.0 + 1800.0)
            for p, tb in zip(ex.poi_in[i, :m], ex.time_bucket[i, :m])
        ])
    return out


def test_convert_round_trips_jax_init_tree(setup, tmp_path):
    _, _, _, _, tree, model = setup
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    path = tmp_path / "params.npz"
    save_npz(path, tree)
    with np.load(path) as f:
        assert "tower/layers/0/wx" in f.files and "embed/poi" in f.files
    loaded = load_npz(path)
    assert jax.tree.structure(loaded) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_queries_last_matches_jax(setup):
    cfg, ds, jmodel, jparams, _, model = setup
    jrec = JaxRecommender(jmodel, jparams, _jax(cfg), ds)
    batch = jrec._featurize(_histories_from_test(ds, 8, JaxCheckin))
    want = np.asarray(jmodel.queries_last(jparams, batch))
    with torch.inference_mode():
        got = model.queries_last(batch_to(batch, "cpu")).numpy()
    assert got.shape == want.shape == (8, cfg.model.embed_dim)
    np.testing.assert_allclose(got, want, atol=QUERY_TOL, rtol=0)


def test_queries_last_with_projection_user_and_untied_table_matches_jax(setup):
    """The parts config #1 does not use: a hidden width other than the
    embedding width (so a projection), the user embedding and an untied
    output table, carried across and scored as in poi_tpu."""
    from poi_tpu.utils.config import ModelConfig as JaxModelConfig
    from poi_tpu_torch.eval.evaluate import prepare_catalog
    from poi_tpu_torch.utils.config import ModelConfig

    cfg, ds, _, _, _, _ = setup
    mcfg = ModelConfig(kind="gru", embed_dim=32, hidden_dim=48, use_user_embedding=True,
                       tie_output_embedding=False)
    jmodel = jax_build_model(JaxModelConfig(**dataclasses.asdict(mcfg)), JaxDataDims.from_dataset(ds))
    jparams = jmodel.init(jax.random.key(1))
    model = build_model(mcfg, DataDims.from_dataset(ds), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    jrec = JaxRecommender(jmodel, jparams, _jax(cfg), ds)
    batch = jrec._featurize(_histories_from_test(ds, 8, JaxCheckin))
    batch = batch._replace(user=np.arange(8, dtype=np.int32))
    want = np.asarray(jmodel.queries_last(jparams, batch))
    with torch.inference_mode():
        got = model.queries_last(batch_to(batch, "cpu")).numpy()
    np.testing.assert_allclose(got, want, atol=QUERY_TOL, rtol=0)
    prep = prepare_catalog(model, cfg.with_overrides({"model.tie_output_embedding": "false"}), ds.poi_counts)
    np.testing.assert_array_equal(
        prep.table[: ds.num_pois].float().numpy(),
        torch.from_numpy(np.asarray(jparams["embed"]["out"])[prep.id_map[: ds.num_pois]]).to(torch.bfloat16).float().numpy(),
    )


def test_featurize_matches_jax(setup):
    cfg, ds, jmodel, jparams, _, model = setup
    rng = np.random.default_rng(7)
    T = ds.max_seq_len
    raw = []
    for n in (1, 3, T, T + 5):  # singleton and over-length (trimmed) rows
        pois = rng.integers(0, ds.num_pois, size=n)
        t0 = 1.3e9 + float(rng.integers(0, 86400 * 30))
        raw.append([
            (int(p), t0 + 3700.0 * i,
             float(rng.uniform(-60, 60)) if i % 3 == 0 else None,
             float(rng.uniform(-120, 120)) if i % 3 == 0 else None)
            for i, p in enumerate(pois)
        ])
    want = JaxRecommender(jmodel, jparams, _jax(cfg), ds)._featurize([[JaxCheckin(*c) for c in h] for h in raw])
    got = Recommender(model, cfg, ds)._featurize([[Checkin(*c) for c in h] for h in raw])
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("exclude_visited", [True, False])
def test_recommend_matches_jax(setup, exclude_visited):
    """The slice as a whole: featurize → embed → GRU → top-k → visited
    filter, port on the CPU against poi_tpu on the CPU, same weights."""
    cfg, ds, jmodel, jparams, _, model = setup
    histories = _histories_from_test(ds, 8)
    jhist = [[JaxCheckin(c.poi, c.timestamp) for c in h] for h in histories]
    want = JaxRecommender(jmodel, jparams, _jax(cfg), ds).recommend(jhist, k=10, exclude_visited=exclude_visited)
    rec = Recommender(model, cfg, ds)
    got = rec.recommend(histories, k=10, exclude_visited=exclude_visited)
    assert got.shape == want.shape == (8, 10)
    assert (got >= 0).all() and (got < ds.num_pois).all()
    if exclude_visited:
        for row, hist in zip(got, histories):
            assert not set(row.tolist()) & {c.poi for c in hist}
    with torch.inference_mode():
        q = model.queries_last(batch_to(rec._featurize(histories), "cpu")).double().numpy()
    table = model.embed["poi"].detach().to(torch.bfloat16).double().numpy()
    scores = torch.from_numpy(q).to(torch.bfloat16).double().numpy() @ table.T
    scores += model.embed["out_bias"].detach().double().numpy()
    rows = np.arange(len(got))[:, None]
    near = np.abs(scores[rows, got] - scores[rows, want]) < TIE_TOL
    assert ((got == want) | near).all(), (got, want)


def test_finalize_pads_short_rows_with_sentinel():
    ids = np.array([[0, 1, 2, 3, 4, 5]])
    hist = [Checkin(poi=p, timestamp=1000.0 * p) for p in (0, 1, 2, 3)]
    out = Recommender._finalize(ids, [hist], k=5, exclude_visited=True)
    assert out[0, :2].tolist() == [4, 5] and (out[0, 2:] == -1).all()


def test_cli_recommend_runs_without_jax(setup, tmp_path):
    """`python -m poi_tpu_torch recommend` on the CPU, in a process that must
    end with no JAX module loaded."""
    cfg, ds, _, _, tree, model = setup
    params = tmp_path / "params.npz"
    save_npz(params, tree)
    histories = _histories_from_test(ds, 3)
    payload = json.dumps([[{"poi": c.poi, "timestamp": c.timestamp} for c in h] for h in histories])
    argv = ["recommend", "--config", "smoke", "--params", str(params), "--device", "cpu", "--k", "5",
            "--set", "model.embed_dim=64", "model.hidden_dim=64"]
    code = (
        "import sys; from poi_tpu_torch.cli import main; rc = main(sys.argv[1:]); "
        "assert 'jax' not in sys.modules, 'jax was imported'; sys.exit(rc)"
    )
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, *argv], input=payload, capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = np.asarray(json.loads(proc.stdout.strip().splitlines()[-1]))
    want = Recommender(model, cfg.with_overrides({"eval.topk_impl": "xla"}), ds).recommend(histories, k=5)
    np.testing.assert_array_equal(out, want)


def test_cli_serve_answers_errors_and_keeps_serving(setup, tmp_path, monkeypatch):
    from poi_tpu_torch import cli

    cfg, ds, _, _, tree, _ = setup
    params = tmp_path / "params.npz"
    save_npz(params, tree)
    lines = "\n".join([
        json.dumps([[{"poi": 3, "timestamp": 1000.0}]]),
        "{not json",
        json.dumps({"histories": [[{"poi": 5, "timestamp": 2000.0}]], "k": 4, "exclude_visited": False}),
    ]) + "\n"
    monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(["serve", "--config", "smoke", "--params", str(params), "--device", "cpu", "--k", "3",
                       "--set", "model.embed_dim=64", "model.hidden_dim=64"])
    assert rc == 0
    out = [json.loads(l) for l in buf.getvalue().strip().splitlines()]
    assert len(out) == 3
    assert len(out[0]["ids"][0]) == 3
    assert "error" in out[1]
    assert len(out[2]["ids"][0]) == 4


def test_cli_cuda_device_without_cuda_is_an_error(tmp_path):
    from poi_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("CUDA is available here; the error path needs a machine without it")
    with pytest.raises(SystemExit) as e:
        cli.main(["serve", "--config", "smoke", "--params", str(tmp_path / "none.npz"), "--device", "cuda"])
    assert e.value.code == 2
