"""Command-line entry point of the PyTorch port.

    python -m poi_tpu_torch train     --config gru_foursquare_nyc [--set k=v ...] [--device cuda] [--checkpoint-dir D]
    python -m poi_tpu_torch eval      --config gru_foursquare_nyc [--checkpoint-dir D] [--step N]
    python -m poi_tpu_torch recommend --config gru_foursquare_nyc (--checkpoint-dir D [--step N] | --params P.npz)
    python -m poi_tpu_torch serve     --config gru_foursquare_nyc (--checkpoint-dir D [--step N] | --params P.npz)
    python -m poi_tpu_torch configs

    python -m torch.distributed.run --nproc-per-node N -m poi_tpu_torch train --config multihost_1m [...]

Under ``torch.distributed.run`` (or any launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``) every verb runs as one
rank of the ``(mesh.data, mesh.model)`` mesh: a card a rank
(``cuda:{LOCAL_RANK}``) over ``nccl``, or the CPU (``--platform cpu``) over
``gloo``; a process group that the caller made first is used as it is. Only rank 0
writes the checkpoint and the metrics and prints the result. ``eval``,
``recommend`` and ``serve`` give each rank its part of the params (its
shard of the catalog tables). ``recommend`` and ``serve`` read their input
on rank 0, the front end, and the other ranks serve as compute shards of
``Recommender(mesh=...)``: ``serve`` checks each request on rank 0 before it
announces it to them, answers a bad one there alone, and ends every rank
at EOF.

``train`` evaluates on val every ``eval_every`` steps (best-on-val
selection) when the dataset has a val split, or on test otherwise, and
prints the final test metrics of the selected parameters as one JSON line.
It checkpoints every ``checkpoint_every`` steps into ``checkpoint.directory``
(``--checkpoint-dir``; ``--no-checkpoint`` trains without) and resumes from
the latest step there: same batches, same draws, same optimizer moments, so
``--set train.fault_inject_step=N`` and a rerun give the uninterrupted run's
bits. The step sequence ends at the true end-of-run state; the selected
params go to ``<dir>/selected``, which ``eval``, ``recommend`` and ``serve``
prefer unless ``--step`` names a step.

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

import torch

# Steps [start, stop) that --profile-dir traces (the reference's window).
PROFILE_STEPS = (10, 15)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="poi_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    def add_common(p):
        p.add_argument("--config", required=True, help="named config (see `configs`)")
        p.add_argument("--set", nargs="*", default=[], help="dotted overrides key=value")
        p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
        p.add_argument("--platform", choices=("cuda", "cpu"), default=None, help="the same as --device cuda|cpu")

    def add_source(p, params: bool):
        where = p.add_mutually_exclusive_group(required=params)
        where.add_argument("--checkpoint-dir", default=None,
                           help="a poi_tpu_torch checkpoint directory" + ("" if params else
                                                                          " (default: checkpoint.directory)"))
        if params:
            where.add_argument("--params", default=None, help="parameters as .npz (convert.save_npz layout)")
        p.add_argument("--step", type=int, default=None,
                       help="checkpoint step to load (default: the latest, with the selected params when saved)")

    p_train = sub.add_parser("train", help="train a model, then evaluate it on test")
    add_common(p_train)
    p_train.add_argument("--checkpoint-dir", default=None, help="override checkpoint.directory")
    p_train.add_argument("--no-checkpoint", action="store_true", help="train without saving or resuming")
    p_train.add_argument("--metrics-dir", default=None, help="append per-step JSONL metrics here")
    p_train.add_argument("--tensorboard", action="store_true", help="also write TB scalars under metrics-dir/tb")
    p_train.add_argument("--profile-dir", default=None,
                         help=f"trace steps {PROFILE_STEPS[0]}..{PROFILE_STEPS[1]} to this dir (Chrome trace)")
    p_train.add_argument("--debug", action="store_true",
                         help="autograd anomaly detection, and stop on a non-finite loss or grad norm")

    p_eval = sub.add_parser("eval", help="evaluate a checkpoint on test")
    add_common(p_eval)
    add_source(p_eval, params=False)

    p_rec = sub.add_parser("recommend", help="one-shot: JSON check-in histories in, top-k POI ids out")
    add_common(p_rec)
    add_source(p_rec, params=True)
    p_rec.add_argument("--input", default="-", help="JSON file of histories ('-' = stdin)")
    p_rec.add_argument("--k", type=int, default=10)
    p_rec.add_argument("--include-visited", action="store_true")

    p_srv = sub.add_parser("serve", help="persistent loop: one JSON request per stdin line")
    add_common(p_srv)
    add_source(p_srv, params=True)
    p_srv.add_argument("--k", type=int, default=10, help="default top-k per request")

    sub.add_parser("configs", help="list named configs")

    args = parser.parse_args(argv)
    if args.cmd == "configs":
        from poi_tpu_torch.configs.presets import list_configs

        for name in list_configs():
            print(name)
        return 0
    if getattr(args, "params", None) is not None and args.step is not None:
        parser.error("--step names a checkpoint step: it goes with --checkpoint-dir, not --params")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    device = torch.device(args.platform or args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error(f"--device {args.device}: CUDA is not available")
    from poi_tpu_torch.parallel.mesh import join_launch

    device = join_launch(device)

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.utils.config import parse_set_flags

    cfg = get_config(args.config).with_overrides(parse_set_flags(args.set))
    if args.checkpoint_dir:
        cfg = cfg.with_overrides({"checkpoint.directory": args.checkpoint_dir})
    try:
        if args.cmd == "train":
            return run_train(cfg, device, enable_checkpoint=not args.no_checkpoint, metrics_dir=args.metrics_dir,
                             profile_dir=args.profile_dir, tensorboard=args.tensorboard, debug=args.debug)
        if args.cmd == "eval":
            return run_eval(cfg, device, step=args.step)
        rec = load_recommender(cfg, device, params_path=args.params, step=args.step)
        if args.cmd == "recommend":
            return run_recommend(rec, args.input, args.k, not args.include_visited)
        return run_serve(rec, default_k=args.k)
    finally:
        # Before the interpreter exits: a process group left to the exit
        # tears its threads down mid-run (gloo aborted a rank so).
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def run_train(cfg, device: torch.device, enable_checkpoint: bool = True, metrics_dir: str | None = None,
              profile_dir: str | None = None, tensorboard: bool = False, debug: bool = False) -> int:
    """Train (resuming from ``checkpoint.directory``'s latest step), select
    on val (or evaluate on test) every ``eval_every`` steps, then print the
    final test metrics as one JSON line."""
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval.evaluate import evaluate, popularity_baseline
    from poi_tpu_torch.train.loop import make_trainer, train
    from poi_tpu_torch.train.selection import BestOnVal
    from poi_tpu_torch.utils.checkpoint import CheckpointManager, warn_config_mismatch
    from poi_tpu_torch.utils.obs import MetricsLogger, device_memory_stats, profile_window

    log = logging.getLogger("poi_tpu_torch.cli")
    ds = load_dataset(cfg.data)
    log.info("dataset: %d users, %d pois, %d train examples, %d test examples on %s",
             ds.num_users, ds.num_pois, len(ds.train), len(ds.test), device)
    trainer = make_trainer(cfg, ds, device)
    trainer.check_finite = debug
    mesh = trainer.mesh
    lead = mesh.rank == 0  # writes the metrics and prints the result
    if mesh.size > 1:
        log.info("rank %d of %r", mesh.rank, mesh)
    state = trainer.init_state()

    ckpt = None
    loader_state = None
    resumed_from = None
    if enable_checkpoint:
        ckpt = CheckpointManager(cfg.checkpoint.directory, cfg.checkpoint.max_to_keep, cfg.checkpoint.async_save,
                                 mesh=mesh, num_pois=trainer.dims.num_pois)
        latest = ckpt.latest_step()
        if latest is not None:
            warn_config_mismatch(ckpt.saved_config(latest), cfg)
            if latest >= cfg.train.num_steps:
                log.info("checkpoint already at step %d >= num_steps %d", latest, cfg.train.num_steps)
                return 0
            state, loader_state = ckpt.restore(state, latest)
            resumed_from = latest
            log.info("resumed from checkpoint step %d", latest)

    # With a val split, periodic eval runs on val and the best-on-val params
    # are selected for the final test eval; without one, periodic eval runs
    # on test directly.
    tracker = BestOnVal(trainer, ds, cfg) if ds.val is not None else None
    if tracker is not None and ckpt is not None:
        # Resuming a directory with a persisted selection: seed the tracker
        # so a worse later-segment val peak never replaces the better one.
        info = ckpt.selected_info()
        if info and info["metric"] == tracker.metric and info["score"] is not None:
            tracker.seed(info["step"], info["score"], ckpt.restore_selected(like=state.params))
            log.info("seeded selection from selected/: step %d %s=%.4f", info["step"], info["metric"], info["score"])
    metrics = MetricsLogger(metrics_dir if lead else None, tensorboard=tensorboard)
    pw = profile_window(profile_dir if lead else None, *PROFILE_STEPS)
    test_evals: list[dict] = []

    def loader_state_at(step):
        ldr = trainer.active_loader
        return ldr.state_at(step) if ldr is not None else None

    def callback(step, st, m):
        pw.step(step)
        if step % cfg.train.eval_every == 0:
            mem = device_memory_stats(device)  # empty on the CPU
            if mem:
                metrics.write(step, mem)
        if ckpt is not None and cfg.train.checkpoint_every > 0 and step % cfg.train.checkpoint_every == 0:
            ckpt.save(step, st, loader_state=loader_state_at(step), config_json=cfg.to_json())
        if tracker is not None:
            tracker(step, st, m)
            if tracker.history and tracker.history[-1]["step"] == step:
                metrics.write(step, {f"val/{k}": v for k, v in tracker.history[-1].items() if k != "step"})
        elif step % cfg.train.eval_every == 0:
            em = evaluate(trainer.model, ds, cfg, mesh=mesh)
            log.info("test @%d: %s", step, em)
            test_evals.append({"step": step, **em})
            metrics.write(step, {f"eval/{k}": v for k, v in em.items()})

    try:
        with torch.autograd.set_detect_anomaly(debug):
            trainer, state, history = train(cfg, ds, num_steps=cfg.train.num_steps - state.step, state=state,
                                            trainer=trainer, callbacks=[callback], loader_state=loader_state)
        for row in history:
            metrics.write(row["step"], {k: v for k, v in row.items() if k != "step"})
        # The step sequence ends with the TRUE end-of-run state (params and
        # moments that belong together, so resuming with a larger num_steps
        # is sound). It is saved before the selected params go into the
        # model for the final eval: evaluate() reads the model's own params.
        if ckpt is not None and ckpt.latest_step() != state.step:
            ckpt.save(state.step, state, loader_state=loader_state_at(state.step), config_json=cfg.to_json())
        if tracker is not None and tracker.best_step >= 0:
            with torch.no_grad():
                for k, p in tracker.best_params(state.params).items():
                    state.params[k].copy_(p)
            log.info("selected best-on-val params from step %d (val %s=%.4f)",
                     tracker.best_step, tracker.metric, tracker.best_score)
            if ckpt is not None:
                ckpt.save_selected(tracker.best_step, state.params, metric=tracker.metric, score=tracker.best_score)
        final = evaluate(trainer.model, ds, cfg, mesh=mesh)
        pop = popularity_baseline(ds, cfg.eval.recall_ks)
        metrics.write(state.step, {f"final/{k}": v for k, v in final.items()})
    finally:
        pw.close()
        metrics.close()
        if ckpt is not None:
            ckpt.close()
    log.info("final eval: %s", final)
    log.info("popularity baseline: %s", pop)
    if not lead:
        return 0
    print(json.dumps({
        "steps": state.step,
        "resumed_from": resumed_from,
        "selected_step": tracker.best_step if tracker is not None else None,
        "final": final,
        "popularity_baseline": pop,
        "history": [{k: row[k] for k in ("step", "loss", "seqs_per_sec")} for row in history],
        "periodic_evals": tracker.history if tracker is not None else test_evals,
    }), flush=True)
    return 0


def model_with_params(cfg, ds, params: dict[str, torch.Tensor], device: torch.device):
    """The model of ``cfg`` on ``device`` holding ``params`` (a ``state_dict``).
    The table may be padded past num_pois (a vocab-sharded run): its size
    comes from the params."""
    from poi_tpu_torch.models.base import DataDims, build_model

    dims = dataclasses.replace(DataDims.from_dataset(ds), num_pois_padded=int(params["embed.poi"].shape[0]))
    model = build_model(cfg.model, dims, device=device)
    model.load_state_dict(params)
    return model


def restore_for_inference(cfg, device: torch.device, step: int | None = None):
    """(dataset, model, step) from ``checkpoint.directory``: exactly step
    ``step`` when given, else the latest step with the best-on-val selected
    params when the run saved them (so inference on a finished directory
    reproduces its reported metrics); ``step`` is the params' step."""
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.utils.checkpoint import CheckpointManager, warn_config_mismatch

    log = logging.getLogger("poi_tpu_torch.cli")
    ds = load_dataset(cfg.data)
    ckpt = CheckpointManager(cfg.checkpoint.directory)
    try:
        saved = ckpt.load(step)
        warn_config_mismatch(saved["config"], cfg)
        params, at = saved["params"], saved["step"]
        if step is None and ckpt.selected_step() is not None:
            params, at = ckpt.restore_selected(), ckpt.selected_step()
            log.info("using best-on-val-selected params (trained to step %d)", at)
        model = model_with_params(cfg, ds, params, device)
    finally:
        ckpt.close()
    log.info("restored step %d from %s", at, ckpt.directory)
    return ds, model, at


def restore_model(cfg, device: torch.device, step: int | None = None, params_path: str | None = None):
    """(dataset, model, mesh, step) for ``eval``, ``recommend`` and
    ``serve``: the params of ``params_path`` (a ``.npz``; step None) or of
    ``checkpoint.directory`` (exactly step ``step`` when given, else the
    latest step with the selected params when the run saved them). In one
    process the model holds them whole (mesh None); under a launcher each
    rank's model holds its part on the ``(mesh.data, mesh.model)`` mesh."""
    from poi_tpu_torch.convert import load_npz, params_from_jax
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.parallel.mesh import Mesh, launched
    from poi_tpu_torch.train.loop import make_trainer
    from poi_tpu_torch.utils.checkpoint import CheckpointManager, local_part, warn_config_mismatch

    if not launched():  # one process: the params whole, whatever mesh wrote them
        if params_path is None:
            ds, model, at = restore_for_inference(cfg, device, step=step)
            return ds, model, None, at
        ds = load_dataset(cfg.data)
        return ds, model_with_params(cfg, ds, params_from_jax(load_npz(params_path)), device), None, None
    mesh = Mesh(cfg.mesh.data, cfg.mesh.model)
    ds = load_dataset(cfg.data)
    trainer = make_trainer(cfg, ds, device, mesh)
    like = dict(trainer.model.named_parameters())
    rows = like["embed.poi"].shape[0]
    at = None
    if params_path is not None:  # every rank reads the file and keeps its part
        params = local_part(params_from_jax(load_npz(params_path)), mesh, rows, True)
    else:
        ckpt = CheckpointManager(cfg.checkpoint.directory, mesh=mesh, num_pois=trainer.dims.num_pois)
        try:
            saved = ckpt.load(step)
            warn_config_mismatch(saved["config"], cfg)
            at = saved["step"]
            if step is None and ckpt.selected_step() is not None:
                params, at = ckpt.restore_selected(like=like), ckpt.selected_step()
            else:
                params = ckpt.local_part(saved["params"], rows, True)
        finally:
            ckpt.close()
    trainer.model.load_state_dict(params)
    return ds, trainer.model, mesh, at


def run_eval(cfg, device: torch.device, step: int | None = None) -> int:
    """Evaluate a checkpoint on test; prints ``{"step", "metrics"}`` as one
    JSON line. Under a launcher every rank holds its part of the params on
    the ``(mesh.data, mesh.model)`` mesh, and rank 0 prints."""
    from poi_tpu_torch.eval.evaluate import evaluate

    ds, model, mesh, at = restore_model(cfg, device, step=step)
    metrics = evaluate(model, ds, cfg, mesh=mesh)
    if mesh is None or mesh.rank == 0:
        print(json.dumps({"step": at, "metrics": metrics}), flush=True)
    return 0


def load_recommender(cfg, device: torch.device, params_path: str | None = None, step: int | None = None):
    """``Recommender`` of the params ``restore_model`` gives: whole on
    ``device`` in one process, this rank's part on its mesh under a
    launcher."""
    from poi_tpu_torch.eval.serve import Recommender

    ds, model, mesh, _ = restore_model(cfg, device, step=step, params_path=params_path)
    return Recommender(model, cfg, ds, mesh=mesh)


def parse_histories(raw) -> list:
    from poi_tpu_torch.eval.serve import Checkin

    return [
        [Checkin(poi=int(c["poi"]), timestamp=float(c["timestamp"]), lat=c.get("lat"), lon=c.get("lon")) for c in hist]
        for hist in raw
    ]


def run_recommend(rec, input_path: str, k: int, exclude_visited: bool) -> int:
    """One request: rank 0 reads the histories and prints the ids; on a mesh
    the other ranks serve as compute shards."""
    histories = None
    if rec.mesh is None or rec.mesh.rank == 0:
        if input_path == "-":
            raw = sys.stdin.read()
        else:
            with open(input_path) as f:
                raw = f.read()
        histories = parse_histories(json.loads(raw))
    out = rec.recommend(histories, k=k, exclude_visited=exclude_visited)
    if out is not None:
        print(json.dumps(out.tolist()))
    return 0


def _announce(rec, word: int | None) -> int:
    """Rank 0's word (1: a request follows, 0: shut down) on every rank."""
    t = torch.tensor([0 if word is None else word], device=rec.device)
    torch.distributed.broadcast(t, 0)
    return int(t)


def run_serve(rec, default_k: int = 10) -> int:
    """One JSON request a stdin line, one JSON answer a line, until EOF. On
    a mesh rank 0 is the front end and the other ranks loop as compute
    shards: rank 0 checks a request whole (``Recommender.check``) before it
    announces it, so a bad line is answered by rank 0 alone and the shards
    never hear of it; EOF announces the shutdown."""
    log = logging.getLogger("poi_tpu_torch.cli")
    mesh = rec.mesh
    if mesh is not None and mesh.rank != 0:
        served = 0
        while _announce(rec, None):
            rec.recommend(None)
            served += 1
        log.info("compute shard %d: served %d requests", mesh.rank, served)
        return 0
    log.info("serving on %s%s: reading JSON requests from stdin", rec.device, f" as rank 0 of {mesh!r}" if mesh else "")
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
            k = int(req.get("k", default_k))
            user_ids = req.get("user_ids")
            exclude = bool(req.get("exclude_visited", True))
            batch = rec.check(histories, k, user_ids)
        except Exception as e:  # a bad request is answered, never kills the server
            print(json.dumps({"error": f"{type(e).__name__}: {e}"}), flush=True)
            continue
        if mesh is not None:
            _announce(rec, 1)
            # Past the word the shards are in this request's collectives: a
            # failure now would leave them there, so it ends the run.
            out = rec.recommend(histories, k=k, user_ids=user_ids, exclude_visited=exclude, batch=batch)
        else:
            try:
                out = rec.recommend(histories, k=k, user_ids=user_ids, exclude_visited=exclude, batch=batch)
            except Exception as e:  # a bad request never kills the server
                print(json.dumps({"error": f"{type(e).__name__}: {e}"}), flush=True)
                continue
        print(json.dumps({"ids": out.tolist()}), flush=True)
        served += 1
    if mesh is not None:
        _announce(rec, 0)
    log.info("served %d requests", served)
    return 0


if __name__ == "__main__":
    sys.exit(main())
