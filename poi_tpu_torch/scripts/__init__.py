"""Measurement scripts of the port, the counterparts of the JAX package's
``scripts/`` that run on the card:

    python -m poi_tpu_torch.scripts.sweep_ce_fwd    # B12: the CE forward's variants x rows a block
    python -m poi_tpu_torch.scripts.sweep_ce_bwd    # B8: its dq and dtable passes, apart and together
    python -m poi_tpu_torch.scripts.profile_step    # the bench workload's train step by region
    python -m poi_tpu_torch.scripts.profile_attn    # config #4's train step by region
    python -m poi_tpu_torch.scripts.bench_cells     # B1-B6 against their plain versions and cuDNN
    python -m poi_tpu_torch.scripts.bench_serve     # Recommender.recommend p50/p99 and requests/s
    python -m poi_tpu_torch.scripts.mem_budget      # params, optimizer state and a step's peak memory
    python -m poi_tpu_torch.scripts.quality_runs    # train, select on val, evaluate beside popularity
    python -m poi_tpu_torch.scripts.bench_1m        # config #5 at V = 1M: top-k, train seq/s, peak memory
    python -m poi_tpu_torch.scripts.profile_1m      # config #5's step by region; lazy Adam's two forms
    python -m poi_tpu_torch.scripts.step_time       # the whole train step: bench workload, configs #4, #5
    python -m poi_tpu_torch.scripts.check_cell_parity        # B1-B4 against the plain cells, presets' shapes
    python -m poi_tpu_torch.scripts.bench_eval_path          # full-T queries then the last vs queries_last
    python -m poi_tpu_torch.scripts.tune_strnn [steps]       # config #3's probes, scored on val
    python -m poi_tpu_torch.scripts.tune_attention [steps]   # config #4's probes, scored on val
    python -m poi_tpu_torch.scripts.compare_embedding_modes  # psum vs a2a: collective bytes by op
    python -m poi_tpu_torch.scripts.compare_attention_modes  # blockwise, ring, Ulysses: collective bytes by op
    python -m poi_tpu_torch.scripts.scaling_bench            # seq/s at 1 and N ranks, the efficiency table
    python -m poi_tpu_torch.scripts.host_feed                # the host loader's train() under each way of feeding it

Each prints the card's ``nvidia-smi`` name and power limit first and runs on
``--device cuda`` unless it is given ``--device cpu``, where it runs the
kernels' plain versions at whatever size it is asked for and times them on
the host clock.
"""
