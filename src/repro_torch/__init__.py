"""PyTorch/CUDA port of the ``repro`` package (one NVIDIA H100).

Mirrors the layout of ``src/repro``.  The solver: ``core/model.py`` →
``core/compile.py`` → ``core/fixpoint.py`` (plain version) and
``kernels/fixpoint_kernel.py`` (the Hopper kernels) → ``core/search.py`` +
``core/eps.py`` → ``core/api.py`` / ``solver.py`` → ``launch/solve.py``.
LM serving (dense GQA): ``configs/`` → ``nn/layers.py``,
``nn/attention.py`` (prefill attention in ``kernels/flash_attention.py``)
→ ``nn/transformer.py`` → ``nn/model.py`` → ``train/serve_step.py`` →
``launch/serve.py``.  LM training: ``data/pipeline.py`` →
``nn/model.py`` `forward_train` → ``train/train_step.py`` and
``train/optimizer.py`` → ``ckpt/checkpoint.py``,
``ft/fault_tolerance.py`` `TrainSupervisor` → ``launch/train.py``.
Imports torch and numpy only — never ``jax`` and nothing of ``repro``.
"""
