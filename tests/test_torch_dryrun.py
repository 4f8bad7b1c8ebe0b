"""The port's multi-rank dry run (``poi_tpu_torch/parallel/dryrun.py``, the
counterpart of ``__graft_entry__.dryrun_multichip``) on 4 gloo CPU ranks:
the four combinations of SP attention, lookup, loss and table update take a
step and the sharded eval sweep, the checkpoint round trip keeps the bits,
and the mesh's Recommender gives the one-process ids."""

import pytest

from poi_tpu_torch.parallel.dryrun import COMBOS, dryrun_multichip, mesh_shapes


@pytest.mark.parametrize("n,want", [(3, [(3, 1)]), (4, [(2, 2)]), (8, [(4, 2), (2, 4)])])
def test_mesh_shapes_are_the_references(n, want):
    """``__graft_entry__.py:93-98``'s meshes."""
    assert mesh_shapes(n) == want


def test_dryrun_multichip_passes_on_four_ranks(capsys):
    dryrun_multichip(4, timeout=240)
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if "loss=" in ln] == [
        ln for ln in lines if ln.startswith("dryrun_multichip(4): mesh=2x2 attn=") and ln.endswith(" OK")]
    assert len([ln for ln in lines if "loss=" in ln]) == len(COMBOS)
    assert len([ln for ln in lines if "sharded eval sweep recall@10=" in ln]) == len(COMBOS)
    assert "dryrun_multichip(4): mesh=2x2 sharded save/restore round-trip OK" in lines
    assert "dryrun_multichip(4): Recommender on the mesh answers 3 histories with the one-process ids OK" in lines
