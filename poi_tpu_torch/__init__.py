"""poi_tpu_torch — the PyTorch/CUDA port of ``poi_tpu`` for NVIDIA Hopper.

It serves config #1 (GRU tower + full-catalog top-k) through two kernels
written by hand in CUDA C++ (``csrc/``), built with nvcc at first use.
Configs, presets, data loading and featurizer helpers are ``poi_tpu``'s
numpy-only modules, imported rather than copied; nothing here imports JAX.

Layering (entry point down to the kernels):

- ``cli``              — ``recommend`` / ``serve`` verbs (JSON protocol)
- ``eval.serve``       — ``Recommender``: featurize, query, top-k, visited filter
- ``eval.evaluate``    — catalog prep and the top-k dispatch
- ``models``           — embeddings + GRU tower (``queries_last``)
- ``ops``              — kernel wrappers with their plain PyTorch versions
- ``convert``          — ``poi_tpu`` param trees ↔ the port's state, ``.npz``
- ``_build``           — nvcc build + ctypes loader of ``csrc/*.cu``
"""
