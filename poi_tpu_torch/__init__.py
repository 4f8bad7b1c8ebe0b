"""poi_tpu_torch — the PyTorch/CUDA port of ``poi_tpu`` for NVIDIA Hopper.

It serves config #1 (GRU tower + full-catalog top-k) and trains the GRU +
full-catalog softmax CE workload through kernels written by hand in CUDA C++
(``csrc/``), built with nvcc at first use. Configs, presets, data loading
and featurizer helpers are ``poi_tpu``'s numpy-only modules, imported rather
than copied; nothing here imports JAX.

Layering (entry point down to the kernels):

- ``cli``              — ``train`` / ``recommend`` / ``serve`` verbs
- ``train``            — ``Trainer`` and ``train()``, losses, optimizers, best-on-val
- ``data``             — batches drawn on the device
- ``eval.serve``       — ``Recommender``: featurize, query, top-k, visited filter
- ``eval.evaluate``    — catalog prep, the top-k dispatch, ``evaluate()``
- ``models``           — embeddings + GRU tower (``queries``, ``queries_last``)
- ``ops``              — kernel wrappers with their plain PyTorch versions and
  the autograd Functions around them
- ``convert``          — ``poi_tpu`` param trees and Adam state ↔ the port's, ``.npz``
- ``_build``           — nvcc build + ctypes loader of ``csrc/*.cu``
"""
