"""Short-probe tuning sweep of config #4 (attention + sampled softmax), the
counterpart of ``scripts/tune_attention.py``.

    python -m poi_tpu_torch.scripts.tune_attention [steps] [--device cuda]

Trains ``attention_gowalla`` with ``data.val_fraction=0.1`` for ``steps``
steps (2,000 by default) once a probe, the reference's probes (the preset;
the user embedding; dropout 0.3; both; the user embedding with dropout
0.5), and scores the VALIDATION split beside the popularity floor
(``tune_strnn.run_probes``). One ``PROBE`` line a probe, the reference's.
"""

from __future__ import annotations

import sys

from poi_tpu_torch.scripts._timing import setup
from poi_tpu_torch.scripts.tune_strnn import parse, run_probes

BASE = {"data.val_fraction": "0.1"}  # the preset with a val split to score on
PROBES = {
    "base": {},
    "user": {"model.use_user_embedding": "true"},
    "drop03": {"model.dropout": "0.3"},
    "user_drop03": {"model.use_user_embedding": "true", "model.dropout": "0.3"},
    "user_drop05": {"model.use_user_embedding": "true", "model.dropout": "0.5"},
}


def main(argv: list[str] | None = None) -> int:
    args = parse("python -m poi_tpu_torch.scripts.tune_attention", __doc__, 2000, argv)
    run_probes("attention_gowalla", PROBES, args.steps, setup(args.device), BASE)
    return 0


if __name__ == "__main__":
    sys.exit(main())
