"""``parallel.collectives.count_bytes`` and ``async_save`` on a mesh, on 2
gloo ranks of the CPU (``tests/torch_mesh_jobs.py``: ``bytes_job``,
``async_ckpt_job``).

The byte counts are held to the analytic payload of each collective the
lookups and the SP attention issue, forward and backward, per rank: the
psum lookup's one all-reduce of the rows; a2a's two all-to-alls of ids and
rows, their backward, and the all-gather; ring's M - 1 rotations of k and
v each way, Ulysses' four exchanges each way, and both SP modes' split,
output gather and the four weight gradients' sums. The asynchronous save
on the mesh must write on rank 0's writer thread and give the synchronous
file's bytes, and a resume from it the same bits."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from poi_tpu_torch.ops.embedding import a2a_capacity
from poi_tpu_torch.parallel.collectives import WIRE
from poi_tpu_torch.parallel.launch import spawn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M = 2
N_IDS, DIM, VOCAB, FACTOR = 300, 8, 64, 2.0
ATTN = {"B": 3, "T": 8, "D": 8, "heads": 2, "window": 3}
F32, I64 = 4, 8


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    d = tmp_path_factory.mktemp("collective_bytes")
    spawn("tests.torch_mesh_jobs:bytes_job", M, {"out": str(d / "out.json"), "n_ids": N_IDS, "dim": DIM,
                                                 "vocab": VOCAB, "factor": FACTOR, "attn": json.dumps(ATTN)},
          timeout=300, cwd=REPO, log_dir=str(d))
    with open(d / "out.json") as f:
        return json.load(f)


def _expected() -> dict[str, dict[str, int]]:
    nloc_pad = -(-N_IDS // M) * M
    cap = a2a_capacity(nloc_pad // M, M, FACTOR)
    B, T, D = ATTN["B"], ATTN["T"], ATTN["D"]
    block = B * (T // M) * D * F32  # q, k or v of one rank's time block
    sp_common = {"split/bwd": B * T * D * F32, "all_gather/fwd": B * T * D * F32, "grad_psum/bwd": 4 * D * D * F32}
    return {
        "psum": {"psum/fwd": N_IDS * DIM * F32},
        "a2a": {"all_to_all/fwd": M * cap * I64 + M * cap * DIM * F32, "all_to_all/bwd": M * cap * DIM * F32,
                "all_gather/fwd": nloc_pad * DIM * F32},
        "ring": {**sp_common, "ppermute_ring/fwd": 2 * (M - 1) * block, "ppermute_ring/bwd": 2 * (M - 1) * block},
        "ulysses": {**sp_common, "all_to_all/fwd": 4 * block, "all_to_all/bwd": 4 * block},
    }


@pytest.mark.parametrize("case", ["psum", "a2a", "ring", "ulysses"])
def test_count_bytes_equals_the_analytic_payload(counts, case):
    """Payload bytes by op and direction exactly; wire bytes by the
    reference's ring weights (all-reduce 2(M-1)/M, gather and all-to-all
    (M-1)/M, the shift 1)."""
    want = _expected()[case]
    got = counts[case]
    assert got["payload"] == want
    kind = {"psum": "all-reduce", "grad_psum": "all-reduce", "all_gather": "all-gather", "split": "all-gather",
            "all_to_all": "all-to-all", "ppermute_ring": "collective-permute"}
    for op, b in want.items():
        assert got["wire"][op] == pytest.approx(b * WIRE[kind[op.split("/")[0]]](M), rel=1e-12), op
    assert sum(got["by_kind"].values()) == sum(want.values())


def test_count_bytes_outside_a_block_counts_nothing():
    """No block, no tally: ``_counts`` is empty, so the collectives skip it."""
    from poi_tpu_torch.parallel import collectives as cc

    assert cc._counts == []
    with cc.count_bytes() as c:
        assert cc._counts == [c]
    assert cc._counts == [] and c.payload == {}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("async_ckpt")
    spawn("tests.torch_mesh_jobs:async_ckpt_job", M, {"out": str(d / "out.npz"), "steps": 2}, timeout=300,
          cwd=REPO, log_dir=str(d))
    with np.load(d / "out.npz") as f:
        return {k: f[k] for k in f.files}


def test_async_save_on_a_mesh_writes_on_the_writer_thread_and_the_sync_bytes(ckpt):
    writers = list(ckpt["writers"])
    assert len(writers) == 2 and writers[0].startswith("ckpt-writer") and writers[1] == "MainThread"
    assert bool(ckpt["same_bytes"])


def test_async_save_on_a_mesh_resumes_bit_for_bit_like_a_sync_one(ckpt):
    assert int(ckpt["async/step"]) == int(ckpt["sync/step"]) == 3
    assert ckpt["async/loss"] == ckpt["sync/loss"]
    keys = sorted(k[len("sync/params/"):] for k in ckpt if k.startswith("sync/params/"))
    assert keys
    for k in keys:
        assert np.array_equal(ckpt[f"async/params/{k}"], ckpt[f"sync/params/{k}"]), k
