"""PyTorch/CUDA port of the ``repro`` solver (one NVIDIA H100).

Mirrors the layout of ``src/repro``: ``core/model.py`` → ``core/compile.py``
→ ``core/fixpoint.py`` (plain version) and ``kernels/fixpoint_kernel.py``
(the Hopper kernel) → ``core/search.py`` + ``core/eps.py`` →
``core/api.py`` / ``solver.py`` → ``launch/solve.py``.  Imports torch and
numpy only — never ``jax`` and nothing of ``repro``.
"""
