"""Command-line entry point of the PyTorch port.

    python -m poi_tpu_torch train     --config gru_foursquare_nyc [--set k=v ...] [--device cuda] --no-checkpoint
    python -m poi_tpu_torch recommend --config gru_foursquare_nyc --params P.npz [--device cuda]
    python -m poi_tpu_torch serve     --config gru_foursquare_nyc --params P.npz [--device cuda]

``train`` trains from a fresh init, evaluates on val every ``eval_every``
steps (best-on-val selection) when the dataset has a val split, or on test
otherwise, and prints the final test metrics of the selected parameters as
one JSON line. Checkpointing is not ported yet, so it needs
``--no-checkpoint``.

``--params`` is an ``.npz`` of a ``poi_tpu`` param tree with ``/``-joined keys
(``convert.save_npz``; ``scripts/export_params_npz.py`` writes one from a
``poi_tpu`` checkpoint). The JSON protocol is ``poi_tpu``'s: ``recommend``
reads one list of histories and prints one list of id lists; ``serve`` reads
one request per stdin line (a bare list of histories, or ``{"histories":
[...], "k": 5, "exclude_visited": false, "user_ids": [...]}``) and answers
each with ``{"ids": [[...]]}`` or ``{"error": "..."}``, serving on after a
bad request.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

import numpy as np
import torch


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="poi_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_common(p, params: bool = True):
        p.add_argument("--config", required=True, help="named config (configs/presets.py)")
        p.add_argument("--set", nargs="*", default=[], help="dotted overrides key=value")
        if params:
            p.add_argument("--params", required=True, help="parameters as .npz (convert.save_npz layout)")
        p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p_train = sub.add_parser("train", help="train a model, then evaluate it on test")
    add_common(p_train, params=False)
    p_train.add_argument("--no-checkpoint", action="store_true",
                         help="train without checkpoints (required: checkpointing is not ported yet)")

    p_rec = sub.add_parser("recommend", help="one-shot: JSON check-in histories in, top-k POI ids out")
    add_common(p_rec)
    p_rec.add_argument("--input", default="-", help="JSON file of histories ('-' = stdin)")
    p_rec.add_argument("--k", type=int, default=10)
    p_rec.add_argument("--include-visited", action="store_true")

    p_srv = sub.add_parser("serve", help="persistent loop: one JSON request per stdin line")
    add_common(p_srv)
    p_srv.add_argument("--k", type=int, default=10, help="default top-k per request")

    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: CUDA is not available")

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.utils.config import parse_set_flags

    cfg = get_config(args.config).with_overrides(parse_set_flags(args.set))
    if args.cmd == "train":
        if not args.no_checkpoint:
            print("error: checkpointing is not ported to poi_tpu_torch yet; pass --no-checkpoint to train "
                  "without it", file=sys.stderr)
            return 2
        return run_train(cfg, device)
    rec = load_recommender(cfg, args.params, device)
    if args.cmd == "recommend":
        return run_recommend(rec, args.input, args.k, not args.include_visited)
    return run_serve(rec, default_k=args.k)


def run_train(cfg, device: torch.device) -> int:
    """Train, select on val (or evaluate on test) every ``eval_every`` steps,
    then print the final test metrics as one JSON line."""
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval.evaluate import evaluate, popularity_baseline
    from poi_tpu_torch.train.loop import make_trainer, train
    from poi_tpu_torch.train.selection import BestOnVal

    log = logging.getLogger("poi_tpu_torch.cli")
    ds = load_dataset(cfg.data)
    log.info("dataset: %d users, %d pois, %d train examples, %d test examples on %s",
             ds.num_users, ds.num_pois, len(ds.train), len(ds.test), device)
    trainer = make_trainer(cfg, ds, device)
    tracker = BestOnVal(trainer, ds, cfg) if ds.val is not None else None
    test_evals: list[dict] = []

    def callback(step, state, metrics):
        if tracker is not None:
            tracker(step, state, metrics)
        elif step % cfg.train.eval_every == 0:
            m = evaluate(trainer.model, ds, cfg)
            log.info("test @%d: %s", step, m)
            test_evals.append({"step": step, **m})

    trainer, state, history = train(cfg, ds, trainer=trainer, callbacks=[callback], device=device)
    if tracker is not None and tracker.best_step >= 0:
        # No checkpoint keeps the end-of-run state, so the selected
        # parameters simply replace it for the final evaluation.
        with torch.no_grad():
            for k, p in tracker.best_params(state.params).items():
                state.params[k].copy_(p)
        log.info("selected best-on-val params from step %d (val %s=%.4f)",
                 tracker.best_step, tracker.metric, tracker.best_score)
    final = evaluate(trainer.model, ds, cfg)
    pop = popularity_baseline(ds, cfg.eval.recall_ks)
    log.info("final eval: %s", final)
    log.info("popularity baseline: %s", pop)
    print(json.dumps({
        "steps": state.step,
        "selected_step": tracker.best_step if tracker is not None else None,
        "final": final,
        "popularity_baseline": pop,
        "history": [{k: row[k] for k in ("step", "loss", "seqs_per_sec")} for row in history],
        "periodic_evals": tracker.history if tracker is not None else test_evals,
    }), flush=True)
    return 0


def load_recommender(cfg, params_path: str, device: torch.device):
    """Dataset featurizer + model with the given parameters on ``device``."""
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.convert import load_npz, params_from_jax
    from poi_tpu_torch.eval.serve import Recommender
    from poi_tpu_torch.models.base import DataDims, build_model

    ds = load_dataset(cfg.data)
    tree = load_npz(params_path)
    # The table may be padded past num_pois (a vocab-sharded run); take its size.
    dims = dataclasses.replace(DataDims.from_dataset(ds), num_pois_padded=int(tree["embed"]["poi"].shape[0]))
    model = build_model(cfg.model, dims, device=device)
    model.load_state_dict(params_from_jax(tree))
    return Recommender(model, cfg, ds)


def parse_histories(raw) -> list:
    from poi_tpu_torch.eval.serve import Checkin

    return [
        [Checkin(poi=int(c["poi"]), timestamp=float(c["timestamp"]), lat=c.get("lat"), lon=c.get("lon")) for c in hist]
        for hist in raw
    ]


def run_recommend(rec, input_path: str, k: int, exclude_visited: bool) -> int:
    if input_path == "-":
        raw = sys.stdin.read()
    else:
        with open(input_path) as f:
            raw = f.read()
    out = rec.recommend(parse_histories(json.loads(raw)), k=k, exclude_visited=exclude_visited)
    print(json.dumps(out.tolist()))
    return 0


def run_serve(rec, default_k: int = 10) -> int:
    log = logging.getLogger("poi_tpu_torch.cli")
    log.info("serving on %s: reading JSON requests from stdin", rec.device)
    served = 0
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
            if isinstance(req, list):
                req = {"histories": req}
            histories = parse_histories(req["histories"])
            if not histories:
                raise ValueError("empty request: no histories")
            k = int(req.get("k", default_k))
            user_ids = req.get("user_ids")
            if user_ids is not None:
                user_ids = np.asarray(user_ids, np.int32)
                if len(user_ids) != len(histories):
                    raise ValueError(f"user_ids length {len(user_ids)} != {len(histories)} histories")
            exclude = bool(req.get("exclude_visited", True))
            out = rec.recommend(histories, k=k, user_ids=user_ids, exclude_visited=exclude)
        except Exception as e:  # a bad request is answered, never kills the server
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}), flush=True)
            continue
        print(json.dumps({"ids": out.tolist()}), flush=True)
        served += 1
    log.info("served %d requests", served)
    return 0


if __name__ == "__main__":
    sys.exit(main())
