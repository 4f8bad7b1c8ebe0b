"""Rank bodies of the gloo rig that ``tests/test_torch_sharded.py``,
``tests/test_torch_train_sharded.py`` and ``tests/test_torch_sp_attention.py``
start with ``parallel.launch.spawn`` (``tests/test_torch_scripts.py`` too, for
``quality_job``):
4 ranks on the CPU, one job a test module. Each body reads the inputs the
test wrote (numpy, from a seed and from ``poi_tpu``), computes every case
on a 2 x 2 and a 1 x 4 mesh of its 4 ranks, and rank 0 writes the results
(each gathered to the whole batch and the whole catalog) to ``out``.

Imports torch and the port only, so a rank starts in a couple of seconds.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from poi_tpu_torch.parallel import collectives as cc
from poi_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh, init_distributed

MESHES = ((2, 2), (1, 4))


def _setup() -> int:
    torch.set_num_threads(1)
    init_distributed("gloo")
    return dist.get_rank()


def _whole_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A data shard's rows gathered to the whole batch."""
    return cc.all_gather(x.detach(), mesh, DATA_AXIS)


def _whole_table_grad(g: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A shard's gradient summed over data and gathered over model."""
    return cc.all_gather(cc.all_reduce_(g.clone(), mesh, DATA_AXIS), mesh, MODEL_AXIS)


def ops_job(inp: str, out: str) -> None:
    """Lookups, losses and the sharded top-k at both meshes."""
    from poi_tpu_torch.eval.evaluate import _prepare_catalog_sharded
    from poi_tpu_torch.ops import sharded_loss
    from poi_tpu_torch.ops.embedding import make_lookup
    from poi_tpu_torch.ops.topk import fused_topk, sharded_topk, topk_reference
    from poi_tpu_torch.configs.presets import get_config

    rank = _setup()
    z = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
    res: dict[str, np.ndarray] = {}
    V, B = z["table"].shape[0], z["ids"].shape[0]
    for shape in MESHES:
        mesh = Mesh(*shape)
        tag = f"{shape[0]}x{shape[1]}"
        mrows, drows = mesh.rows(V), mesh.rows(B, DATA_AXIS)

        # Lookups: exact (generous capacity), and skewed ids with drops.
        for case, ids_key, factor in (("psum", "ids", None), ("a2a", "ids", 16.0), ("a2a_skew", "skew", 1.0)):
            table = z["table"][mrows].clone().requires_grad_()
            ids = z[ids_key].long()[drows]
            lookup = make_lookup(mesh, case[:4] if case != "a2a_skew" else "a2a", factor or 2.0)
            got = lookup(table, ids)
            (got * z["cot"][drows]).sum().backward()
            res[f"{tag}/{case}/out"] = _whole_rows(got, mesh).numpy()
            res[f"{tag}/{case}/grad"] = _whole_table_grad(table.grad, mesh).numpy()

        # Losses: the sharded CE, BPR and sampled softmax (B9/B10's plain
        # versions where fused) on the injected negatives.
        mean = sharded_loss.make_global_mean(mesh)
        psum = make_lookup(mesh, "psum")
        losses = {
            "ce": (sharded_loss.make_sharded_ce(mesh, mean), None),
            "bpr": (sharded_loss.make_sharded_bpr(psum, mean), z["bpr_neg"].long()[drows]),
        }
        for fused in ("on", "off"):
            fn = sharded_loss.make_sharded_sampled_softmax(mesh, psum, int(z["pool"].shape[0]), V, mean, fused=fused)
            losses[f"sampled_{fused}"] = (fn, z["pool"].long())
        for name, (fn, neg) in losses.items():
            q = z["q"][drows].clone().requires_grad_()
            table = z["table"][mrows].clone().requires_grad_()
            bias = z["bias"][mrows].clone().requires_grad_()
            args = (q, table, bias, z["tgt"].long()[drows], z["mask"][drows])
            loss = fn(*args) if neg is None else fn(*args, neg)
            loss.backward()
            res[f"{tag}/{name}/loss"] = cc.all_reduce_(loss.detach().clone(), mesh, DATA_AXIS).numpy()
            res[f"{tag}/{name}/dq"] = _whole_rows(q.grad, mesh).numpy()
            res[f"{tag}/{name}/dtable"] = _whole_table_grad(table.grad, mesh).numpy()
            res[f"{tag}/{name}/dbias"] = _whole_table_grad(bias.grad, mesh).numpy()

        # The sharded top-k: xla on the shards as they are, pallas (B11's
        # plain version) through the per-shard popularity id space.
        k = int(z["k"])
        qk = z["tq"][mesh.rows(z["tq"].shape[0], DATA_AXIS)]
        table, bias = z["ttable"][mrows], z["tbias"][mrows]
        _, ids = sharded_topk(qk, table, bias, k, mesh, topk_reference)
        res[f"{tag}/topk_xla"] = _whole_rows(ids, mesh).numpy()
        cfg = get_config("smoke").with_overrides({"eval.topk_impl": "pallas"})
        model = type("Model", (), {"embed": {"poi": table, "out_bias": bias}})()
        prep = _prepare_catalog_sharded(model, cfg, z["counts"].numpy(), mesh)
        vals, ids = sharded_topk(qk, prep.table, prep.bias, k, mesh, fused_topk)
        res[f"{tag}/topk_pallas"] = _whole_rows(ids, mesh).numpy()
        res[f"{tag}/topk_pallas_vals"] = _whole_rows(vals, mesh).numpy()
        res[f"{tag}/id_map"] = prep.id_map
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


def train_job(inp: str, out: str, cases: str) -> None:
    """For each case of ``cases`` (JSON: name -> {"overrides", "mesh"}, and
    ``dense_lazy_max_bytes`` to force lazy Adam's form and the rows step):
    ``steps`` steps on the mesh from the injected full params, batches and
    pools, every step's metrics and the final params gathered; the same
    steps on one rank (rank 0, a 1 x 1 mesh); ``evaluate`` of the mesh
    run's params on the mesh and on one rank. Then a checkpoint of the last case saved on its mesh and
    restored on one rank and on the other mesh."""
    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.convert import unflatten
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.eval.evaluate import evaluate
    from poi_tpu_torch.models.base import DataDims, batch_to
    from poi_tpu_torch.data.pipeline import Batch
    from poi_tpu_torch.parallel.shardings import CATALOG_TABLES, unshard_state
    from poi_tpu_torch.train import sparse_opt
    from poi_tpu_torch.train.loop import Trainer
    from poi_tpu_torch.utils.checkpoint import CheckpointManager

    rank = _setup()
    z = dict(np.load(inp))
    res: dict[str, np.ndarray] = {}
    state_of = {}
    threshold = sparse_opt.DENSE_LAZY_MAX_BYTES
    for name, case in json.loads(cases).items():
        cfg = get_config("smoke").with_overrides(case["overrides"])
        ds = load_dataset(cfg.data)
        dims = DataDims.from_dataset(ds)
        tree = unflatten({k[len(f"{name}/params/"):]: v for k, v in z.items() if k.startswith(f"{name}/params/")})
        batches = [Batch(*(z[f"batch{s}/{f}"] for f in Batch._fields)) for s in range(int(z["steps"]))]
        pools = z.get(f"{name}/pools")
        negatives = None if pools is None else (lambda step, p=pools: torch.from_numpy(p[step]))
        runs = {"mesh": Mesh(*case["mesh"])}
        if rank == 0:
            runs["one"] = Mesh(world_size=1)
        sparse_opt.DENSE_LAZY_MAX_BYTES = case.get("dense_lazy_max_bytes", threshold)
        for run, mesh in runs.items():
            # One rank takes the mesh's padded catalog, so it loads the same params.
            tt = Trainer(cfg, dims.padded_to(case["mesh"][1]) if run == "one" else dims, device="cpu", mesh=mesh,
                         negatives=negatives)
            st = tt.init_state(tree)
            res[f"{name}/{run}/rows_mode"] = np.asarray(tt.rows_mode)
            rows = mesh.rows(cfg.train.batch_size, DATA_AXIS)
            for s, b in enumerate(batches):
                st, m = tt.step(st, batch_to(Batch(*(a[rows] for a in b)), "cpu"))
                for key, v in m.items():
                    res[f"{name}/{run}/{key}/{s}"] = np.asarray(float(v))
            whole = unshard_state(dict(st.params), mesh, tt.sharded)
            for key, v in whole.items():
                res[f"{name}/{run}/params/{key}"] = v.detach()[:dims.num_pois].numpy() if key in CATALOG_TABLES \
                    else v.detach().numpy()
            if run == "mesh":
                trained = {k: v.detach().clone() for k, v in whole.items()}
            else:  # one rank evaluates the mesh run's params
                tt.model.load_state_dict(trained)
            for key, v in evaluate(tt.model, ds, cfg, mesh=mesh).items():
                res[f"{name}/{run}/eval/{key}"] = np.asarray(v)
            state_of[(name, run)] = (tt, st)

    # The last case's state, saved on its mesh, restored on one rank and on
    # the other mesh shape of the 4 ranks.
    name = list(json.loads(cases))[-1]
    tt, st = state_of[(name, "mesh")]
    other = [s for s in MESHES if tuple(s) != tuple(tt.mesh.shape.values())][0]
    directory = os.path.join(os.path.dirname(out), "ckpt")
    ckpt = CheckpointManager(directory, mesh=tt.mesh, num_pois=tt.dims.num_pois)
    ckpt.save(st.step, st, config_json=tt.cfg.to_json())
    whole = {"params": unshard_state(dict(st.params), tt.mesh, tt.sharded),
             **{k: unshard_state(v, tt.mesh, tt.sharded) for k, v in st.opt_state.items() if k != "count"}}
    for target in ("one", "other"):
        mesh = Mesh(world_size=1) if target == "one" else Mesh(*other)
        if target == "one" and rank != 0:
            continue
        t2 = Trainer(tt.cfg, tt.dims, device="cpu", mesh=mesh)
        st2, _ = CheckpointManager(directory, mesh=mesh, num_pois=tt.dims.num_pois).restore(t2)
        got = {"params": unshard_state(dict(st2.params), mesh, t2.sharded),
               **{k: unshard_state(v, mesh, t2.sharded) for k, v in st2.opt_state.items() if k != "count"}}
        same = all(torch.equal(got[w][k][:tt.dims.num_pois], whole[w][k][:tt.dims.num_pois])
                   for w in whole for k in whole[w])
        res[f"ckpt/{target}/same"] = np.asarray(same and st2.step == st.step
                                                and st2.opt_state["count"] == st.opt_state["count"])
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


def sp_job(inp: str, out: str, cases: str, towers: str) -> None:
    """Sequence-parallel attention (``parallel.sp_attention``) on both
    meshes: for each case of ``cases`` (JSON: name -> {"impl", "window",
    "heads"}), the forward of this data rank's rows of ``x``, and the
    gradients of ``x`` and of ``wq``..``wo`` under the cotangent ``cot``,
    each gathered to the whole batch (the projections' summed over data);
    a case that raises keeps its error. Then the attention tower of each
    of ``towers`` (JSON: key prefix -> {"sets": overrides on
    ``attention_gowalla``, "cot": the input that is its output's
    cotangent}) with each impl on the inputs ``tx`` and ``tmask``: its
    output and the gradients of its GRU and projections, gathered and
    summed alike. Then
    ``ppermute_ring`` at shifts 1 and -1, forward and backward, every
    rank's result gathered."""
    import types

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.models.attention import AttentionTower
    from poi_tpu_torch.parallel.sp_attention import IMPLS, make_sp_attention

    rank = _setup()
    z = {k: torch.from_numpy(v) for k, v in np.load(inp).items()}
    res: dict[str, np.ndarray] = {}
    B = z["x"].shape[0]
    for shape in MESHES:
        mesh = Mesh(*shape)
        tag = f"{shape[0]}x{shape[1]}"
        drows = mesh.rows(B, DATA_AXIS)
        for name, case in json.loads(cases).items():
            x = z["x"][drows].clone().requires_grad_()
            p = {w: z[w].clone().requires_grad_() for w in ("wq", "wk", "wv", "wo")}
            mha = make_sp_attention(mesh, case["heads"], case["window"], case["impl"], case["block"])
            try:
                o = mha(x, p)
            except ValueError as e:
                res[f"{tag}/{name}/error"] = np.asarray(str(e))
                continue
            (o * z["cot"][drows]).sum().backward()
            res[f"{tag}/{name}/out"] = _whole_rows(o, mesh).numpy()
            res[f"{tag}/{name}/dx"] = _whole_rows(x.grad, mesh).numpy()
            # Every model rank holds the whole gradient of its rows of x.
            res[f"{tag}/{name}/dx_model_max_diff"] = np.asarray(float(
                (cc.all_reduce_(x.grad.clone(), mesh, MODEL_AXIS, "max") - x.grad).abs().max()))
            for w in p:
                res[f"{tag}/{name}/d{w}"] = cc.all_reduce_(p[w].grad.clone(), mesh, DATA_AXIS).numpy()

        for prefix, tower in json.loads(towers).items():
            model_cfg = get_config("attention_gowalla").with_overrides(tower["sets"]).model
            for impl in IMPLS:
                t = AttentionTower(model_cfg, torch.Generator().manual_seed(0), "cpu")
                t.sp_mha = make_sp_attention(mesh, model_cfg.attn_heads, model_cfg.attn_window, impl,
                                             model_cfg.attn_block_size)
                o = t(z["tx"][drows], types.SimpleNamespace(mask=z["tmask"][drows]))
                (o * z[tower["cot"]][drows]).sum().backward()
                key = f"{tag}/tower_{prefix}{impl}"
                res[f"{key}/out"] = _whole_rows(o, mesh).numpy()
                for k, p in t.named_parameters():
                    if p.grad is not None:
                        res[f"{key}/d{k}"] = cc.all_reduce_(p.grad.clone(), mesh, DATA_AXIS).numpy()

        # The ring shift: rank i's tensor to rank i + shift of its model group, the gradient back.
        for shift in (1, -1):
            x = torch.full((2, 3), float(rank)).requires_grad_()
            y = cc.ppermute_ring(x, mesh, MODEL_AXIS, shift)
            y.backward(torch.full((2, 3), 10.0 * rank))
            got = torch.stack([y.detach()[0, 0], x.grad[0, 0]])
            parts = [torch.empty_like(got) for _ in range(dist.get_world_size())]
            dist.all_gather(parts, got)
            res[f"{tag}/ring{shift}"] = torch.stack(parts).numpy()  # [world, (received, gradient)]
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


def bytes_job(out: str, n_ids: int, dim: int, vocab: int, factor: float, attn: str) -> None:
    """On a 1 x world mesh: ``collectives.count_bytes`` around the psum and
    a2a lookups of ``n_ids`` ids (forward and backward) and around ring and
    Ulysses attention (``attn``: JSON B, T, D, heads, window); rank 0 writes
    each case's payload bytes by ``op/direction``, and its wire bytes, as
    JSON."""
    from poi_tpu_torch.ops.embedding import make_lookup
    from poi_tpu_torch.parallel.sp_attention import make_sp_attention

    rank = _setup()
    mesh = Mesh(1, dist.get_world_size())
    gen = torch.Generator().manual_seed(0)
    res = {}
    rows = vocab // mesh.shape[MODEL_AXIS]
    ids = torch.randint(0, vocab, (n_ids,), generator=gen)
    for mode in ("psum", "a2a"):
        table = torch.randn(rows, dim, generator=gen).requires_grad_()
        lookup = make_lookup(mesh, mode, factor)
        with cc.count_bytes() as c:
            lookup(table, ids).square().sum().backward()
        res[mode] = c
    a = json.loads(attn)
    x = torch.randn(a["B"], a["T"], a["D"], generator=gen)
    p = {n: (0.1 * torch.randn(a["D"], a["D"], generator=gen)).requires_grad_() for n in ("wq", "wk", "wv", "wo")}
    for impl in ("ring", "ulysses"):
        mha = make_sp_attention(mesh, a["heads"], a["window"], impl)
        xr = x.clone().requires_grad_()
        with cc.count_bytes() as c:
            mha(xr, p).square().sum().backward()
        res[impl] = c
    if rank == 0:
        with open(out, "w") as f:
            json.dump({k: {"payload": {"/".join(op): b for op, b in c.payload.items()},
                           "wire": {"/".join(op): b for op, b in c.wire.items()}, "by_kind": c.by_kind()}
                       for k, c in res.items()}, f)
    dist.barrier()
    dist.destroy_process_group()


def async_ckpt_job(out: str, steps: int) -> None:
    """A small attention config on a 1 x world mesh: ``steps`` steps, saved
    at the end by an asynchronous and by a synchronous
    ``CheckpointManager``; each restored into a fresh trainer that takes
    one more step. Rank 0 writes whether the two files hold the same bytes,
    whether the async save returned before its file existed on rank 0 or
    ran on the writer thread, and the two resumed runs' losses and params,
    gathered, to ``out`` (npz)."""
    import threading

    from poi_tpu_torch.configs.presets import get_config
    from poi_tpu_torch.data.dataset import load_dataset
    from poi_tpu_torch.data.pipeline import make_batch
    from poi_tpu_torch.models.base import DataDims
    from poi_tpu_torch.parallel.shardings import unshard_state
    from poi_tpu_torch.train.loop import Trainer
    from poi_tpu_torch.utils import checkpoint
    from poi_tpu_torch.utils.checkpoint import CheckpointManager

    rank = _setup()
    cfg = get_config("smoke").with_overrides({"model.kind": "attention", "model.embed_dim": "16",
                                              "model.hidden_dim": "16", "model.attn_heads": "2",
                                              "train.warmup_steps": "0", "model.dropout": "0.0"})
    ds = load_dataset(cfg.data)
    dims = DataDims.from_dataset(ds)
    mesh = Mesh(1, dist.get_world_size())
    batches = [make_batch(ds.train, np.arange(s * 16, s * 16 + cfg.train.batch_size)) for s in range(steps + 1)]
    tt = Trainer(cfg, dims, device="cpu", mesh=mesh)
    st = tt.init_state()
    for b in batches[:steps]:
        st, _ = tt.step(st, b)
    writers = []
    write = checkpoint._write

    def spy(path, payload):  # which thread writes the step file
        writers.append(threading.current_thread().name)
        write(path, payload)

    checkpoint._write = spy
    base = os.path.dirname(out)
    res = {}
    for kind in ("async", "sync"):
        mgr = CheckpointManager(os.path.join(base, kind), async_save=kind == "async", mesh=mesh,
                                num_pois=dims.num_pois)
        mgr.save(st.step, st, config_json=cfg.to_json())
        mgr.close()  # wait(): rank 0 joins its write, then every rank passes the barrier
        t2 = Trainer(cfg, dims, device="cpu", mesh=mesh)
        s2, _ = CheckpointManager(os.path.join(base, kind), mesh=mesh, num_pois=dims.num_pois).restore(t2)
        s2, m = t2.step(s2, batches[steps])
        res[f"{kind}/loss"] = np.asarray(float(m["loss"]))
        res[f"{kind}/step"] = np.asarray(s2.step)
        for k, v in unshard_state(dict(s2.params), mesh, t2.sharded).items():
            res[f"{kind}/params/{k}"] = v.detach().numpy()
    checkpoint._write = write
    if rank == 0:
        files = [open(os.path.join(base, k, f"step_{steps}.pt"), "rb").read() for k in ("async", "sync")]
        res["same_bytes"] = np.asarray(files[0] == files[1])
        res["writers"] = np.asarray(writers)
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


def quality_job(argv: list) -> None:
    """``quality_runs.main(argv)`` on this rank, in the process group made
    first, as the gloo ranks sharing a card make theirs: the script runs on
    the config's mesh and keeps the group, which this body ends."""
    from poi_tpu_torch.scripts import quality_runs

    _setup()
    assert quality_runs.main(argv) == 0
    assert dist.is_initialized()  # kept: the caller made it
    dist.barrier()
    dist.destroy_process_group()
