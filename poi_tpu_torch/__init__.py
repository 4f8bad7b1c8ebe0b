"""poi_tpu_torch — the PyTorch/CUDA port of ``poi_tpu`` for NVIDIA Hopper.

It trains and serves configs #1-#4 (the GRU, LSTM + BPR, ST-RNN and GRU +
attention towers) through kernels written by hand in CUDA C++ (``csrc/``),
built with nvcc at first use. Nothing here imports JAX or ``poi_tpu``: the
configs, presets, data loading and featurizer helpers, the metrics and the
C++ windowing (``utils``, ``configs``, ``data``, ``eval.metrics``,
``native``) are the port's own copies of ``poi_tpu``'s numpy-only modules.

Layering (entry point down to the kernels):

- ``cli``              — ``train`` / ``eval`` / ``recommend`` / ``serve`` / ``configs`` verbs
- ``utils.checkpoint`` — step files (params, optimizer state, loader position), resume, ``selected/``
- ``utils.obs``        — JSONL metrics, card memory readings, the profiler window
- ``train``            — ``Trainer`` and ``train()``, losses, optimizers, best-on-val
- ``data``             — check-in tables, windowing, host loader, batches drawn on the device
- ``eval.serve``       — ``Recommender``: featurize, query, top-k, visited filter
- ``eval.evaluate``    — catalog prep, the top-k dispatch, ``evaluate()``
- ``models``           — embeddings + GRU, LSTM, ST-RNN and attention towers (``queries``, ``queries_last``)
- ``ops``              — kernel wrappers with their plain PyTorch versions and
  the autograd Functions around them
- ``convert``          — ``poi_tpu`` param trees and Adam state ↔ the port's, ``.npz``
- ``_build``           — nvcc build + ctypes loader of ``csrc/*.cu``
"""
