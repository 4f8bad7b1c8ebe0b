"""Serving on a mesh of 4 gloo ranks on the CPU: the smoke config trained
and checkpointed under ``torch.distributed.run`` on 2 x 2, then ``recommend``
(from a ``--params`` file, on 2 x 2) and ``serve`` (from the checkpoint, on
1 x 4 with a2a lookups) under the launcher, each rank holding its shard of
the catalog (``Recommender(mesh=...)``, the per-shard catalog and
``sharded_topk``; B11's plain version on the CPU). Their ids are held
against the one-process port ``Recommender`` on the same params and against
``poi_tpu``'s single-process ``Recommender``; the serve session carries the
reference's assertions (``tests/test_multihost.py``: a malformed line
answered by rank 0 alone, the visited filter, EOF ending every rank with
exit code 0), plus ``k = 129`` refused before the broadcast and a row that
the capped fetch leaves short, scored again by every rank."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from poi_tpu.eval.serve import Checkin as JaxCheckin
from poi_tpu.eval.serve import Recommender as JaxRecommender
from poi_tpu.models.base import DataDims as JaxDataDims
from poi_tpu.models.base import build_model as jax_build_model
from poi_tpu.utils.config import Config as JaxConfig
from poi_tpu_torch import cli
from poi_tpu_torch.configs.presets import get_config
from poi_tpu_torch.convert import params_to_numpy, save_npz
from poi_tpu_torch.eval.serve import Checkin
from poi_tpu_torch.models.base import batch_to
from poi_tpu_torch.utils.config import parse_set_flags

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Config #1's widths on the smoke corpus (tests/test_torch_serve.py's), the
# kernel path's top-k (the per-shard popularity-ordered catalog).
SETS = ["model.embed_dim=64", "model.hidden_dim=64", "eval.topk_impl=pallas", "mesh.data=2", "mesh.model=2"]
SERVE_SETS = ["mesh.data=1", "mesh.model=4", "mesh.embedding_mode=a2a", "mesh.a2a_capacity_factor=8.0"]
ENV = {**os.environ, "OMP_NUM_THREADS": "1", "POI_TPU_TORCH_DATA_CACHE": "off"}
LAUNCH = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4"]
TIE_TOL = 1e-5  # tests/test_torch_serve.py's: scores this close may swap between the packages


def _cfg(sets=()):
    return get_config("smoke").with_overrides(parse_set_flags([*SETS, *sets]))


def _run(args, stdin=None, timeout=240):
    proc = subprocess.run([*LAUNCH, "-m", "poi_tpu_torch", *args, "--platform", "cpu", "--config", "smoke"],
                          cwd=REPO, env=ENV, input=stdin, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc


def _histories(ds, n):
    """Raw histories rebuilt from test rows (tests/test_torch_serve.py's)."""
    ex = ds.test
    out = []
    for i in np.linspace(0, len(ex) - 1, n).astype(int):
        m = int(ex.mask[i].sum())
        out.append([Checkin(poi=int(p), timestamp=float(tb) * 3600.0 + 1800.0)
                    for p, tb in zip(ex.poi_in[i, :m], ex.time_bucket[i, :m])])
    return out


def _json(histories):
    return [[{"poi": c.poi, "timestamp": c.timestamp} for c in h] for h in histories]


@pytest.fixture(scope="module")
def rig(tmp_path_factory):
    """Train 4 steps on 2 x 2 under the launcher into a checkpoint; the
    one-process port Recommender on its params, and those params as an
    ``.npz``; the requests (one of them built to come up short)."""
    d = tmp_path_factory.mktemp("torch_serve_mesh")
    ckpt = str(d / "ckpt")
    _run(["train", "--checkpoint-dir", ckpt, "--set", *SETS, "train.num_steps=4", "train.eval_every=100"])
    cfg = _cfg().with_overrides({"checkpoint.directory": ckpt})
    rec = cli.load_recommender(cfg, torch.device("cpu"))
    params = d / "params.npz"
    save_npz(params, params_to_numpy(rec.model))
    hist = _histories(rec.ds, 8)
    # A history whose model window (its last T = 16 check-ins) reads a test
    # row and whose earlier 128 check-ins are that window's 128 best POIs:
    # every candidate of the capped fetch (128) is visited, so the row comes
    # up short and is scored again alone.
    tail = hist[3]
    best = rec.recommend([tail], k=128, exclude_visited=False)[0]
    long = [Checkin(poi=int(p), timestamp=60.0 * i) for i, p in enumerate(best)] + tail
    assert len(long) >= 128
    return {"dir": d, "ckpt": ckpt, "params": params, "rec": rec, "hist": hist, "long": long}


def _jax_ids(rec, histories, k, impl="pallas", exclude=True):
    """poi_tpu's single-process Recommender on the port's params."""
    jcfg = JaxConfig.from_dict(rec.cfg.with_overrides({"eval.topk_impl": impl}).to_dict())
    jmodel = jax_build_model(jcfg.model, JaxDataDims.from_dataset(rec.ds))
    jparams = jax.tree.map(jax.numpy.asarray, params_to_numpy(rec.model))
    jrec = JaxRecommender(jmodel, jparams, jcfg, rec.ds)
    return jrec.recommend([[JaxCheckin(c.poi, c.timestamp) for c in h] for h in histories], k=k,
                          exclude_visited=exclude)


def _assert_same_or_tied(rec, histories, got, want):
    """``got`` equals ``want`` but where the two candidates' scores (bf16
    query and table, fp64 sums) lie within TIE_TOL."""
    with torch.inference_mode():
        q = rec.model.queries_last(batch_to(rec.check(histories, 1), "cpu")).to(torch.bfloat16).double().numpy()
    table = rec.model.embed["poi"].detach().to(torch.bfloat16).double().numpy()
    scores = q @ table.T + rec.model.embed["out_bias"].detach().double().numpy()
    rows = np.arange(len(got))[:, None]
    near = np.abs(scores[rows, got] - scores[rows, want]) < TIE_TOL
    assert ((got == want) | near).all(), (got, want)


def test_recommend_under_the_launcher_from_params_matches_one_process_and_poi_tpu(rig):
    """``recommend --params P.npz`` on 2 x 2: every rank reads the file and
    keeps its shard; rank 0 alone prints the ids, which equal the
    one-process Recommender's and, but among equal scores, poi_tpu's."""
    hist = rig["hist"]
    inp = rig["dir"] / "requests.json"
    inp.write_text(json.dumps(_json(hist)))
    proc = _run(["recommend", "--params", str(rig["params"]), "--input", str(inp), "--k", "10", "--set", *SETS])
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    assert len(lines) == 1, proc.stdout
    got = np.asarray(json.loads(lines[0]))
    want = rig["rec"].recommend(hist, k=10)
    np.testing.assert_array_equal(got, want)
    _assert_same_or_tied(rig["rec"], hist, got, _jax_ids(rig["rec"], hist, 10))
    for row, h in zip(got, hist):
        assert not set(row.tolist()) & {c.poi for c in h}


@pytest.fixture(scope="module")
def served(rig):
    """``serve`` from the checkpoint on 1 x 4 (a2a lookups): 8 histories,
    a malformed line, k = 129, the reference's two-history request, the
    short row, then EOF."""
    lines = [json.dumps(_json(rig["hist"])),
             "this is not json",
             json.dumps({"histories": _json(rig["hist"][:1]), "k": 129}),
             json.dumps({"histories": [[{"poi": 3, "timestamp": 2000.0}], [{"poi": 4, "timestamp": 2500.0}]],
                         "k": 3, "exclude_visited": True}),
             json.dumps({"histories": _json([rig["long"]])})]
    proc = _run(["serve", "--checkpoint-dir", rig["ckpt"], "--set", *SETS, *SERVE_SETS],
                stdin="\n".join(lines) + "\n")
    return [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")], proc.stderr


def test_serve_under_the_launcher_answers_errors_and_exits_every_rank(served):
    """The reference's multi-process serve assertions: one answer a line,
    the bad lines answered ``{"error"}`` by rank 0 without desyncing the
    shards (k = 129 is refused before the broadcast), the visited filter
    active, and every rank ends at EOF with exit code 0 (the launcher's 0);
    each compute shard served exactly the accepted requests."""
    replies, stderr = served
    assert len(replies) == 5
    assert "ids" in replies[0] and len(replies[0]["ids"]) == 8
    assert "error" in replies[1]
    assert replies[2] == {"error": "ValueError: k=129 > 128 not supported"}
    assert "ids" in replies[3] and len(replies[3]["ids"]) == 2
    assert all(len(row) == 3 for row in replies[3]["ids"])
    assert 3 not in replies[3]["ids"][0]
    for r in (1, 2, 3):
        assert f"compute shard {r}: served 3 requests" in stderr, stderr[-3000:]


def test_served_ids_match_one_process_and_poi_tpu(rig, served):
    """The served ids equal the one-process Recommender's on the same
    params and, but among equal scores, poi_tpu's single-process
    Recommender's."""
    replies, _ = served
    rec, hist = rig["rec"], rig["hist"]
    got = np.asarray(replies[0]["ids"])
    np.testing.assert_array_equal(got, rec.recommend(hist, k=10))
    _assert_same_or_tied(rec, hist, got, _jax_ids(rec, hist, 10))
    two = [[Checkin(3, 2000.0)], [Checkin(4, 2500.0)]]
    np.testing.assert_array_equal(np.asarray(replies[3]["ids"]), rec.recommend(two, k=3))


def test_served_short_row_is_scored_again_on_every_shard(rig, served):
    """The row whose 128 fetched candidates are all visited: the mesh scores
    it again (every rank masking the visited POIs of its shard) and gives
    the one-process kernel path's ids, which equal the uncapped plain
    path's and, but among equal scores, poi_tpu's uncapped plain path's."""
    replies, _ = served
    rec, long = rig["rec"], rig["long"]
    got = np.asarray(replies[4]["ids"])
    capped = rec.recommend([long], k=10)
    plain = cli.load_recommender(rec.cfg.with_overrides({"eval.topk_impl": "xla"}), torch.device("cpu"))
    np.testing.assert_array_equal(got, capped)
    np.testing.assert_array_equal(got, plain.recommend([long], k=10))
    assert (got >= 0).all() and not set(got[0].tolist()) & {c.poi for c in long}
    _assert_same_or_tied(rec, [long], got, _jax_ids(rec, [long], 10, impl="xla"))


@pytest.mark.parametrize("what,args,error", [
    ("k above the kernel's 128", dict(k=129), "k=129 > 128 not supported"),
    ("a negative k", dict(k=-1), "k=-1 < 0"),
    ("no histories", dict(histories=[]), "empty request: no histories"),
    ("an empty history", dict(histories=[[]]), "empty history"),
    ("a POI outside the catalog", dict(histories=[[Checkin(poi=10**6, timestamp=0.0)]]), "outside the catalog"),
    ("a negative POI", dict(histories=[[Checkin(poi=-1, timestamp=0.0)]]), "outside the catalog"),
    ("one user id for two histories", dict(histories=[[Checkin(3, 0.0)], [Checkin(4, 0.0)]], user_ids=[1]),
     "user_ids length 1 != 2 histories"),
])
def test_check_refuses_before_any_work(rig, what, args, error):
    """``Recommender.check`` raises ValueError, before any collective, for
    every request that would otherwise fail once the shards have joined
    it: ``serve`` calls it before the accept word."""
    rec = rig["rec"]
    call = {"histories": rig["hist"][:1], "k": 10, **args}
    with pytest.raises(ValueError, match=error):
        rec.check(call["histories"], call["k"], call.get("user_ids"))
