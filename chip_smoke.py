#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any error or mismatch ends the run with a non-zero
exit code and no result line:

1. card and build: the card line of ``nvidia-smi``, torch and CUDA
   versions; ``nvcc`` builds ``kernels/csrc/fixpoint.cu`` and
   ``kernels/csrc/search.cu`` for sm_90a, each at int32 and int64 and
   ``search.cu`` also in its lane-tiled mode,
   ``kernels/csrc/flash_attention.cu``, and the clock-stamped ``clocks``
   variants of ``fixpoint.cu`` at both widths and of ``search.cu`` at
   int32, all ten at once; each kernel instance's registers and spill
   stores are printed (from ``-Xptxas -v``), and each solver kernel
   instance's co-resident CTAs per SM (the launch's occupancy query with
   no dynamic shared memory: what its registers and threads allow); the
   flash kernel must neither spill nor use local memory, and no few-lane
   instance of ``fixpoint.cu`` (1024 threads, 64 registers a thread) may
   spill;
2. kernel against plain version: ``fixpoint_cuda`` against the plain
   PyTorch ``fixpoint_batch``, on the card, on RCPSP J30- and J60-class
   models, for 1024 random stores (random tells on the root box, from a
   numpy seed) and the EPS pool, at ``max_sweeps`` 1, 4 and uncapped:
   failed masks, non-failed stores, per-lane sweeps and convergence
   flags must be equal;
3. main path: a J60-class instance solved end to end through
   ``Solver(SolveConfig.preset("prove", backend="cuda", n_lanes=1024,
   eps_target=4096))``, with the launch counters set to 0 just before
   and read just after; the solution is ground-checked and the optimum
   held against the JAX package's; a J30-class instance solved with
   ``backend="cuda"`` and ``backend="gather"`` on the card must give
   identical results, equal to the JAX package's;
4. times: the kernel and its plain version per launch (CUDA events) at
   the main path's shape ``[1024, 62]``, on phase 2's J60 random stores,
   beside the least time the card could take for that work; then the
   kernel as EPS issues it (``time_eps_launches``: J60 decomposed to
   4096 subproblems under ``torch.profiler``, one ``[2, 62]`` launch per
   split; on an H100 they take the few-lane instance), its device time
   per launch beside its bound, and the plain version per ``[2, 62]``
   launch; then those launches replayed through the ``clocks`` library
   on both instances (1024 and 256 threads per CTA): SM clocks per
   lane-sweep by phase of the sweep (``clock_breakdown``);
5. resident kernel against plain version: ``search_cuda`` against
   ``search_plain`` on the card, on J30 (256 lanes) and J60 (1024 lanes)
   class models with phase 2's EPS pools, from fresh lanes, from the
   state after 5 plain supersteps (decision paths) and from the states 8
   supersteps before and after the first solution (incumbents, bound
   tells, ``stop_on_first`` tripping mid-launch and a stopped state),
   under the ``prove``, ``fast`` and ``first_solution`` presets, at K =
   1, 4 and 16 supersteps per launch: every LaneState field, the bound,
   the superstep count, the pool cursor and the stop flag must be
   equal;
6. resident main path: the J60-class instance solved end to end through
   ``Solver(SolveConfig.preset("prove", backend="cuda_resident",
   supersteps_per_launch=16, n_lanes=1024, eps_target=4096))``, with the
   launch counters set to 0 just before and read just after; status,
   objective and every counter must equal phase 3's ``cuda`` solve, and
   the solution is ground-checked;
7. times: ``search_cuda`` and ``search_plain`` per launch (CUDA events)
   at the main path's shape (1024 lanes, K=16, from phase 5's J60 state
   after 5 supersteps), beside the least time the card could take;
8. the dense AllDifferent bank, kernel against plain version: phase 2's
   comparison on N-queens 32, graph coloring 64
   (``large_instance("coloring")``) and N-queens 8, 1024 random stores
   each (the first 256 made overfull, which must fail by pigeonhole)
   and the EPS pools of the first two;
9. the same bank in the resident kernel: phase 5's comparison on
   N-queens 32 and coloring 64 (1024 lanes, their EPS pools of 4096)
   under ``prove``, ``fast`` and ``min_dom``/``split``, from fresh lanes
   and after 5 supersteps;
10. the main path on the zoo: N-queens 32 and coloring 64 solved through
   ``Solver.solve`` (1024 lanes, eps_target 4096, each instance with its
   strategy pair ``ZOO_STRATEGY``), with ``cuda`` and ``cuda_resident``
   (K=16) under a cap of 2048 supersteps (status, objective and every
   counter equal), then with ``cuda_resident`` under 100,000 supersteps,
   which must prove the optimum (N-queens q0 = 0, coloring cmax = 4);
   the launch counters are set to 0 just before each solve and read just
   after, and every solution is ground-checked;
11. the zoo's smoke tier (rcpsp, nqueens, coloring, knapsack, jobshop,
   ``small_instance(seed=0)``) through ``gather``, ``cuda`` and
   ``cuda_resident``: equal results and counters, equal to the JAX
   package's, ground-checked;
12. times of both kernels at the N-queens-32 shapes (``[1024, 33]``
   stores of phase 8; 1024 lanes, K=16, ``min_dom``/``split``, after 5
   supersteps), beside their plain versions and bounds, and the fixpoint
   kernel as EPS issues it on N-queens 32, with its clock breakdown (as
   in phase 4); then every
   launch of phase 10's long N-queens-32 ``cuda_resident`` solve,
   replayed from the same options and pool and timed one by one (its
   supersteps and nodes must equal the solve's); then the early state's
   launch and the replay's slowest launch replayed through
   ``search.cu``'s ``clocks`` library (``search_clock_breakdown``; its
   outputs must equal ``search_cuda``'s): the share of CTA-clocks of
   each phase of a superstep (dispatch, the wait at the first grid
   barrier, ranks, load, fixpoint, commit, the wait at the second), the
   clocks per lane-sweep of each phase of a sweep, and per superstep the
   lanes' sweeps, the sweeps of one CTA's lanes and the CTAs' busy
   clocks, mean and maximum;
13. the sparse banks, kernel against plain version: phase 2's comparison
   on the J90 and J120 classes, jobshop 20 x 15 (sparse Cumulative),
   N-queens 64 and N-queens 256 (sparse AllDifferent; the first 256
   random stores overfull), 1024 random stores each and the EPS pools;
   then a J30-class instance compiled ``bank_layout="sparse"`` against
   its dense compile, both through ``fixpoint_cuda``: equal failed
   masks, non-failed stores, sweeps and convergence flags;
14. the sparse banks in the resident kernel: phase 5's comparison on the
   J120 class (``prove``) and N-queens 64 (``min_dom``/``split``) at K =
   1, 4 and 16, and on N-queens 256 at K = 4, 1024 lanes each, from
   fresh lanes and after 5 supersteps, and on J120 also 8 supersteps
   before and after its first solution;
15. the main path on the sparse banks (1024 lanes, eps_target 4096, the
   launch counters read around each solve, every solution
   ground-checked): the J120 and J90 classes and rcpsp-96
   (``large_instance("rcpsp")``) through ``cuda`` and ``cuda_resident``
   (K=16), which must prove the JAX package's optima 157, 88 and 55 with
   equal counters; N-queens 256 (``min_dom``/``split``) through both
   under 256 supersteps (equal counters), then ``cuda_resident`` under
   100,000 supersteps or a 10 s timeout, whichever comes first;
16. times of both kernels at the J120 (``[1024, 122]``) and N-queens-256
   (``[1024, 257]``) shapes of phases 13 and 14, beside their plain
   versions, their bounds and the sparse banks' own work (sort compares
   and scan steps), the J120 launch replayed through the search
   ``clocks`` library (as in phase 12), and the fixpoint kernel as EPS
   issues it on J120, with its clock breakdown (as in phase 4);
17. the Compact-Table bank and the bitset store, kernel against plain
   version: phase 2's comparison on crossword and configuration at the
   small, bench and large tiers and a model whose tables hold more than
   32 tuples (two support words), in both modes — a carried bitset store
   (1024 random stores with 1024 random bitset stores, the first 256 of
   which wipe out a table's interior, and the EPS pool's range words)
   and the transient one (no store) — at ``max_sweeps`` 1, 4 and
   uncapped: failed masks, non-failed stores and words, sweeps and
   convergence flags must be equal;
18. the resident kernel with the bitset store: phase 5's comparison on
   crossword large and configuration large under ``prove`` and
   ``min_lb``/``middle_out``, fed their EPS pool (2 subproblems, as the
   main path) and a pool of phase 17's 1024 random stores (every lane
   searches; the second start is after 2 supersteps, as the search ends
   within 4; the compared states must hold failed nodes and lanes in a
   right branch, so backtracking through ``root_dom`` is checked), and
   on N-queens 32 and coloring 64 under ``min_dom``/``middle_out``, at K
   = 1, 4 and 16, 1024 lanes, from fresh lanes and after 5 supersteps:
   every LaneState field, ``dom`` and ``root_dom`` included, must be
   equal;
19. the main path on the table models and ``middle_out`` (the launch
   counters read around each solve, every solution ground-checked):
   crossword large and configuration large through ``cuda`` and
   ``cuda_resident`` (1024 lanes, eps_target 4096), which must prove the
   JAX package's optima 22 and 107 with equal counters; N-queens 32 under
   ``min_dom``/``middle_out`` through both under 2048 supersteps (equal
   counters); the J30 class under ``middle_out`` through both, whose
   counters must equal its ``split`` solve's (no start is tracked);
20. times of both kernels at the shapes of phases 17 and 18
   (``[1024, 50]`` configuration large and ``[1024, 65]`` crossword
   large, with and without a carried store; K=16 on both, from fresh
   lanes on the EPS pool and on the random pool, and
   on N-queens 32 under ``min_dom``/``middle_out``), beside their plain
   versions and bounds; the Compact-Table work of a bound is counted from
   the member values of the stores each sweep reads.

21. int64 models, ``fixpoint_cuda`` against its plain version (the int64
   library): the J120 class with every duration × 10⁷ (V=122, sparse
   Cumulative), the J60 class compiled ``force_dtype="int64"`` in the
   dense layout and a two-term row whose products pass 2³¹, 1024 random
   stores each and the first 1024 subproblems of the EPS pools, at
   ``max_sweeps`` 1, 4 and uncapped;
22. int64 in the resident kernel: phase 5's comparison on J120 × 10⁷ and
   J60 int64 (1024 lanes, ``prove``, K = 1, 4, 16), from fresh lanes and
   after 5 supersteps, and on J120 × 10⁷ 8 before and after the first
   solution (the compared states must hold failed nodes and backtracks);
23. the int64 main path (launch counters read around each solve,
   solutions ground-checked): J120 × 10⁷ through ``cuda`` and
   ``cuda_resident`` with equal counters, proving 157 × 10⁷; J60 int64
   through both, every counter equal to phase 3's int32 J60 solve;
24. lane tiles: phase 5's comparison in lane tiles of 256 (4 tiles) and
   384 (3, the last one short) on J60 (``prove``, in tiles of 256 also
   around its first solution) and N-queens 32 (``min_dom``/``split``),
   and of 256 on J60 int64, 1024 lanes, K = 1 and 16, from fresh lanes
   and after 5 supersteps (every field, the per-tile cursors included);
   then J60 through ``cuda_resident`` in tiles of 256, which must prove
   82 with a launch per K supersteps (its nodes and supersteps printed
   beside phase 6's one-queue solve), and J30 at 16 lanes in tiles of 4,
   whose counters must equal the plain version's on the CPU and differ
   from one queue's;
25. times: both kernels at int64 (J120 × 10⁷) against int32 (J120) at
   ``[1024, 122]``, the fixpoint kernel as EPS issues it on J120 × 10⁷
   with its clock breakdown (as in phase 4, at int64), and
   ``search_cuda`` at J60 in tiles of 256 against one queue, beside
   their plain versions and bounds (int64 bytes counted at 8, int64
   operations against the int32 peak);
26. flash attention, kernel against plain version: ``flash_attention``
   against ``flash_attention_plain`` on the card, bf16 inputs drawn with
   numpy from SEED, at the serving prefill shape ``[4, 2048, 32, 128]``
   with 8 KV heads (causal), a ragged S of 1000 (the pad path),
   bidirectional S = 512, MQA (1 KV head) and head_dim 64, and phase
   37's prefill shapes (``[2, 1024]`` with 48 heads over 8 at head_dim
   128 (dbrx) and 36 over 36 at 64 (minicpm), ``[2, 256]`` with 16 over
   16 at 64 (seamless's decoder), ``[2, 1024]`` bidirectional with 16
   over 16 at 64 (seamless's encoder)), each at the blocks (128, 128) and
   (64, 128): every output within ``rtol 2⁻⁷, atol 1e-3`` of the plain
   version's;
27. the LM main path: qwen3-4b at full width and depth (36 layers),
   random weights from a ``torch.Generator`` on the card seeded with 0,
   through ``repro_torch.train.serve_step.generate``: 4 requests of 2048
   prompt tokens, 16 tokens each, greedy, twice (cold, then warm), with
   the launch counter set to 0 just before each and read just after
   (exactly one launch per layer: 36); tokens in the vocabulary; then
   decode against teacher forcing (prefill on 2047 tokens and decode
   token 2047 against a prefill on all 2048): finite logits within
   ``0.08 · max|logit|``;
28. times at phase 27's attention shape: the kernel, its plain version
   and ``torch.nn.functional.scaled_dot_product_attention`` (causal,
   GQA; the library yardstick, which the port never calls) per call by
   CUDA events, beside the bound (the larger of the bytes over the HBM
   rate and the causal pairs' operations over the bf16 tensor-core
   peak), the achieved TFLOP/s of the function and the kernel's time as
   a share of the bound; the kernel's own work with p split into bf16 hi
   and lo (6·hd operations per pair against the function's 4·hd) printed
   beside it;
29. the few-lane instance of the fixpoint kernel: ``fixpoint_cuda`` over
   1 (the root box), 2 and 132 lanes (the few-lane instance on an H100)
   and 133 (the 256-thread one) against ``fixpoint_batch``, every bank
   at both widths (J60, J120, N-queens 32 and 256, crossword and
   configuration large with the transient and the carried store; J120
   × 10⁷, J60 int64, the wide row, N-queens 8 and 36 and a two-word
   table forced to int64), at max_sweeps 1 and uncapped: every field
   equal; then every launch EPS made in phases 4, 12, 16 and 25 (J60,
   N-queens 32, J120, J120 × 10⁷) and in N-queens 256's, crossword
   large's and configuration large's decompositions against
   ``fixpoint_batch`` on the same stores, and the decomposition replayed
   with the plain results, whose pool (the pool through
   ``fixpoint_batch``) must equal the pool through ``fixpoint_cuda`` bit
   for bit;
30. the resident kernel's slot axis (``search_slots_cuda``, one launch
   over the slots of a ``LaneBatch``) against its plain version: four
   J60 instances of one shape (``rcpsp.generate(60, n_resources=4,
   seed=0)`` and the same project with its durations permuted by
   ``np.random.default_rng(s)`` for s = 1, 2, 3), 1024 lanes and an EPS
   pool of 4096 each, at K = 1, 4 and 16, from fresh lanes and after 5
   plain supersteps with slot 2 idle (frozen) and slot 3 stopped (every
   lane done): every field of every slot equal to ``search_plain`` on the
   slot and to a single-instance ``search_cuda`` launch on it; then the
   same in lane tiles of 256 per slot, on crossword large at seeds 0-3
   (the bitset store) and on two J60 slots forced to int64; and one
   4-slot K=16 launch timed against the four single launches (CUDA
   events) beside its bound (the sum of the slots' bounds);
31. ``Solver.solve_many`` on the card: phase 30's four J60 instances
   (``prove``, 1024 lanes, eps_target 4096, at most 4096 supersteps)
   through ``cuda_resident`` (K=16) and ``cuda``: each slot's status,
   objective and every counter equal to a sequential ``Solver.solve`` on
   its pool through the same backend, and the backends equal; seed 0
   proves 82, every solution is ground-checked, and the launch counters
   read around the call show one ``search_cuda`` launch per quantum, not
   one per slot; the wall time beside the four sequential solves';
32. the solver service on the card: a ``SolverScheduler``
   (``cuda_resident``, 1024 lanes, eps_target 4096, ``max_batch`` 4,
   ``min_dom``/``split``) driven by ``serve.loadgen.run_open_loop``
   through ``poisson_trace(16, 8.0, seed=0)`` over N-queens 32, knapsack
   20 and crossword 8 (weights 1, 2, 1; seed-stable shapes) with
   deadlines (None, 120, 600): every request that completes equals a
   sequential ``Solver.solve`` of its pool padded to the bucket's size on
   every counter and is ground-checked;
   latency and time-to-first-incumbent percentiles, mean occupancy,
   builds and EPS seconds per bucket, and the phase's wall time.
33. the scatter oracle on the card: on J60 (dense Cumulative), J120
   (sparse Cumulative), N-queens 32 (dense AllDifferent), N-queens 256
   (sparse AllDifferent), crossword large (Compact-Table; the bitset
   store carried and transient, and its EPS pool) and J120 × 10⁷
   (int64), the ``scatter`` backend's ``fixpoint_batch`` (PyTorch
   ``scatter_reduce`` joins, CUDA tensors in and out) against ``cuda``
   on the 1024 random stores of the kernel phases: equal failed masks
   and, on every lane that did not fail, equal stores, bitset stores,
   sweeps and convergence flags; ``kernels.ops.batched_fixpoint(
   impl="cuda")`` against ``kernels.ref.fixpoint_ref`` on the last 64
   of them; the scatter form's ms against ``fixpoint_cuda``'s per model;
   J30 seed 0 solved through ``SolveConfig(backend="scatter")`` with
   ``cuda``'s counters (and the JAX package's);
34. the paper's comparison: RCPSP J30 seeds 0-3, J60 and J120 seed 0
   (``rcpsp.generate(n, n_resources=4, seed)``), ``prove``, 1024 lanes,
   eps_target 4096, ``cuda_resident`` K=16 on the card against the
   port's ``SequentialSolver`` on the host with the same
   ``SearchOptions`` (60 s per instance): equal objectives where both
   prove (J30 s0 34, J60 82, J120 157 on the card), the card's solutions
   ground-checked, a cut baseline's incumbent never below the optimum;
   one line per instance (statuses, objectives, nodes, wall s, nodes/s,
   ``eps_s``, launches) beside the card line and the host CPU's model;
35. the entry points: ``examples/torch_quickstart.py``,
   ``examples/torch_rcpsp_solve.py --n 8 --count 2`` and
   ``examples/torch_planner_demo.py --timeout 20`` as subprocesses on the
   card, each exiting 0;
36. distributed EPS (``core/dist_solve.py``; every shard on the card, each
   shard's superstep one ``fixpoint_cuda`` launch): J30 class (16 lanes
   per shard, eps_target 64) at mesh 1, 2 and 4 through ``cuda`` and
   ``gather``, equal to the JAX package's counters per mesh size and to
   each other with the bound of every chunk; J60 class at full width
   (1024 lanes per shard, eps_target 4096) at mesh 1 (every counter equal
   to phase 3's solve), 2 and 4 (proving 82), and the J120 class at mesh
   4 (proving 157), each ground-checked, with the launch counters set to 0
   before and read after: wall and EPS seconds, supersteps, chunks,
   launches (EPS's few-lane ones and one per shard and superstep) and ms
   per mesh superstep after EPS; a steal on J60's pool with its second
   half failed (mesh 2, chunk 1): at least one steal, the partition
   invariant at every chunk boundary, the objective of a one-shard solve
   of the same pool; a device loss (mesh 4, chunk 8, shard 1 lost after
   chunk 1): one remesh from 4 to 3 shards that requeues work, OPTIMAL
   82, a monotone bound; and ``launch/solve.py --mesh 4`` on J60 as a
   subprocess;
37. the other architectures' serving path, one after another, each
   freed before the next: minicpm-2b (40 layers), pixtral-12b (40
   layers, 1024 patch embeddings before the text), mamba2-1.3b (48
   layers, prompts of 1000: the last 256-chunk padded),
   recurrentgemma-2b (26 layers: 8 stacked periods and 2 recurrent
   tails; prompts of 2100, past the 2048 window, so the ring wraps in
   prefill and decode) and seamless-m4t-large-v2 (24 + 24 layers, 1024
   frames) whole, dbrx-132b and deepseek-v2-236b at full width with
   their depth cut to 4 layers (deepseek's dense layer and 3 MoE
   layers; whole, they are 263 and 471 GB in bf16); random weights from
   a ``torch.Generator`` on the card seeded with 0, prompts (and stub
   inputs) from ``np.random.default_rng(SEED)``, 2 requests of 1024
   prompt tokens unless stated, 8 tokens each, through
   ``repro_torch.train.serve_step.generate``, twice (cold, then warm),
   with the launch counters set to 0 just before each and read just
   after: flash_attention exactly
   once per layer whose prefill attention is unwindowed and of one
   head_dim, causal or bidirectional (40, 40, 0, 0, 24 + 24, 4, 0), no
   solver kernel; the layers, params, GB on the card, the cut, prefill
   ms, decode ms per token, tokens/s and peak memory beside the card
   line, and the MoE pair's ``moe_dropped``; the MoE pair's first
   expert product on the prefill's dispatched tokens (a bf16 GEMM with
   an f32 result) against the widened f32 product, within one bf16 ulp
   of max |ref|; tokens in the vocabulary; then decode against
   teacher forcing (the MoE pair at B = 1, S = 8, where no expert can
   pass capacity): finite logits within ``0.08 · max|logit|``; and
   recurrentgemma once more on a short prompt (B = 2, S = 16 under a
   ring of its whole 2048-token window), whose decode attends on the
   ring's first lap, against teacher forcing at the same bound, and
   again with the unwritten slots let into the softmax (the fault the
   ring's mask repairs), which must land outside the bound;
38. training (``train/``, ``nn/model.forward_train``), which runs none
   of the three kernels, as the reference's training runs no Pallas
   kernel: (a) every architecture's smoke config, one step
   (``loss_and_grads``, then ``apply_updates``, the body of
   ``train_step``) on the card from the same f32 params (drawn on the
   CPU from a seeded ``torch.Generator``) as the same step on the CPU:
   the loss within 1e-2 relative of the CPU's, every gradient leaf
   finite, every leaf nonzero whose CPU gradient is, and each such
   leaf's ‖card − cpu‖/‖cpu‖ under 0.1; (b) llama3-8b's
   smoke config trained 60 steps on the pipeline (as
   ``tests/test_train.py::test_loss_decreases_on_learnable_task``): the
   mean of the last 5 losses at least 1.0 under that of the first 5;
   (c) under ``TrainSupervisor`` on the card, a run cut at step 10 and
   resumed to 14 equals the uninterrupted run bit for bit (params and
   moments); (d) minicpm-2b whole (40 layers, d_model 2304, 2.72 B
   params, f32 params, gradients and moments) through
   ``launch/train.py``: 4 steps of 4 x 512 tokens, WSD, random weights
   from seed 0, no checkpoint: per step ms, tokens/s, peak
   ``max_memory_allocated``, loss, lr and grad_norm beside the card
   line; finite losses and a finite, positive grad_norm; (e) the
   kernels' launch counters are the same before and after the phase.

The last lines are the card line, a ``{"kernels": [...]}`` JSON line and
``{"ok": true, "device": {...}}``.  Without a usable GPU, or without the
repository around it, the script fails before it prints any result.
"""

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import namedtuple

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

SEED = 0
N_RANDOM = 1024            # random stores per model in phases 2 and 8
CAPS = (1, 4, None)        # max_sweeps of phases 2 and 8 (None: uncapped)
MAIN_LANES = 1024
MAIN_EPS = 4096
MAIN_TIMEOUT_S = 600.0
# Proven optima of the generated instances, from the JAX package
# (``repro.solver``, backend="gather", preset "prove", on the CPU).
J60_OPTIMUM = 82           # rcpsp.generate(60, n_resources=4, seed=0)
# phase 15, the sparse Cumulative layout: rcpsp.generate(n,
# n_resources=4, seed=0) for n = 90 and 120, and large_instance("rcpsp")
SPARSE_OPTIMUM = {"J90": 88, "J120": 157, "rcpsp96": 55}
# phase 19: the proven optima of the zoo's large table instances
# (large_instance(name, seed=0)), from the JAX package (backend="gather",
# preset "prove", 64 lanes, eps_target 64, on the CPU)
TABLE_OPTIMUM = {"crossword": 22, "configuration": 107}
# of phase 17's random bitset stores, those that wipe out the interior of
# one table row (all of its members' interior values cleared)
N_WIPE = 256
# the variants of phase 18: (name, preset, (var, val) pair or None)
TABLE_VARIANTS = (("prove", "prove", None),
                  ("min_lb/middle_out", "prove", ("min_lb", "middle_out")))
MIDDLE_OUT = ("min_dom", "middle_out")
# phase 15's N-queens 256 strategy pair (first-fail, bisection), the
# superstep cap of its cuda vs cuda_resident solves and the timeout of its
# long solve: no pair of four tried on the card found a solution within
# 20 s, and 2048 supersteps took 92 s and 161 s (PERF.md section 6); 10 s
# leaves room for phases 21-25 (the long solve found none in 30 s either)
NQ256_STRATEGY = ("min_dom", "split")
NQ256_CAP = 256
NQ256_LONG_TIMEOUT_S = 10.0
# rcpsp.generate(30, n_resources=4, seed=0), preset "prove", 32 lanes,
# default eps_target: the JAX package's SolveResult counters.
J30_LANES = 32
J30_REFERENCE = dict(status="OPTIMAL", objective=34, n_nodes=2038,
                     n_fails=1078, n_sols=5, n_sweeps=960,
                     n_supersteps=65)

# H100 SXM HBM rate (NVIDIA data sheet).  The int32 peak is not in the
# data sheet: it is the card's SM count x 64 INT32 lanes per SM (NVIDIA
# Hopper architecture whitepaper) x its maximum SM clock, one operation
# per lane per clock (phase 1 reads both from the card).
PEAK_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64
# every library the run launches, built at once in phase 1: both
# sources at int32 and int64, search.cu's lane-tiled mode at both, the
# flash kernel, and fixpoint.cu's clock-stamped breakdown at both widths
BUILDS = (("fixpoint", ""), ("fixpoint", "i64"), ("search", ""),
          ("search", "i64"), ("search", "tiles"), ("search", "tiles_i64"),
          ("flash_attention", ""), ("fixpoint", "clocks"),
          ("fixpoint", "clocks_i64"), ("search", "clocks"))
# phases 21-25: every duration of an RCPSP class × INT64_SCALE compiles to
# int64 (sums pass the int32 headroom); scaling every duration scales the
# optimum, so J120 × 10⁷ must prove SPARSE_OPTIMUM["J120"] × 10⁷
INT64_SCALE = 10 ** 7
# phase 24's lane tiles on 1024 lanes: 4 tiles, and 3 with a short last
# one; the lane-tiled main path runs MAIN_TILE
TILES = (256, 384)
MAIN_TILE = 256
# (lanes, eps_target, lane tile) of phase 24's small tiled J30 solve, whose
# counters the tiles change (16 lanes: one queue 1680 nodes, tiles of 4
# 1654 in the plain version on the CPU)
J30_TILED = (16, 64, 4)
FIXPOINT_SOURCE = "src/repro_torch/kernels/csrc/fixpoint.cu"
FIXPOINT_REPLACES = "src/repro/kernels/fixpoint_kernel.py:285"
SEARCH_SOURCE = "src/repro_torch/kernels/csrc/search.cu"
SEARCH_REPLACES = "src/repro/kernels/fixpoint_kernel.py:520"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:95"
# phases 26-28: the LM serving path
LM_ARCH = "qwen3-4b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 2048, 16
LM_WEIGHT_SEED = 0
DECODE_TOL = 0.08          # × max|logit| (tests/test_archs.py's bound)
FLASH_RTOL, FLASH_ATOL = 2.0 ** -7, 1e-3
# (tag, B, S, H, KV, hd, causal) of phase 26, each at FLASH_BLOCKS
FLASH_CASES = (("prefill", 4, 2048, 32, 8, 128, True),
               ("ragged S=1000", 4, 1000, 32, 8, 128, True),
               ("bidirectional S=512", 4, 512, 32, 8, 128, False),
               ("MQA", 4, 2048, 32, 1, 128, True),
               ("head_dim 64", 4, 2048, 32, 8, 64, True),
               # phase 37's prefill shapes: dbrx, minicpm, seamless
               ("dbrx 48 over 8", 2, 1024, 48, 8, 128, True),
               ("minicpm 36 over 36", 2, 1024, 36, 36, 64, True),
               ("seamless decoder S=256", 2, 256, 16, 16, 64, True),
               ("seamless encoder", 2, 1024, 16, 16, 64, False))
FLASH_BLOCKS = ((128, 128), (64, 128))
# phase 37: the other architectures, one after another: (arch, decoder
# layers kept at full width, or None for all of them; requests, prompt
# tokens, tokens generated, flash launches per prefill: the layers whose
# prefill attention is unwindowed and of one head_dim, causal or the
# encoder's bidirectional one)
OTHER_ARCHS = (("minicpm-2b", None, 2, 1024, 8, 40),
               ("pixtral-12b", None, 2, 1024, 8, 40),
               ("mamba2-1.3b", None, 2, 1000, 8, 0),
               ("recurrentgemma-2b", None, 2, 2100, 8, 0),
               ("seamless-m4t-large-v2", None, 2, 256, 8, 48),
               ("dbrx-132b", 4, 2, 1024, 8, 4),
               ("deepseek-v2-236b", 4, 2, 1024, 8, 0))
# (B, S) of the MoE pair's decode check: T = 8 tokens <= C = 8 slots per
# expert, so no expert can pass capacity and drops cannot split the sides
MOE_CHECK = (1, 8)
# (B, S) of recurrentgemma's short-prompt decode check, under a ring of
# the whole window (2048 slots): its decode runs on the first lap with
# all but S slots unwritten
SHORT_RING = (2, 16)
# phase 38: (a) the smoke step's batch and tolerance against the CPU, (b)
# the learnable task, (c) kill and resume, (d) minicpm-2b whole through
# launch/train.py
TRAIN_SMOKE = (4, 32)                  # global batch, sequence
TRAIN_LOSS_RTOL = 1e-2
# worst on-path gradient leaf ‖card − cpu‖/‖cpu‖: bf16 compute in another
# order gives 0.0005-0.0169, dbrx 0.0466 (router near-ties); a wrong
# scale, transpose or lost term gives O(1)
TRAIN_GRAD_RTOL = 0.1
LEARN = dict(steps=60, seq=32, batch=8, lr=3e-3, warmup=5, drop=1.0)
RESUME = (10, 14, 5)                   # cut, end, checkpoint every
TRAIN_FULL = ["--arch", "minicpm-2b", "--steps", "4", "--seq", "512",
              "--global-batch", "4", "--seed", "0", "--log-every", "1"]
# phases 30-32: batched solving.  Slots 1-3 of phase 30's J60 batch
# permute seed 0's durations with np.random.default_rng(s) (one shape
# signature); after 5 plain supersteps slot SLOT_IDLE is frozen idle and
# slot SLOT_STOPPED has every lane done; SLOT_TILE lanes per tile in the
# tiled run; BATCH_CAP caps phase 31's supersteps
SLOT_SEEDS = (1, 2, 3)
SLOT_IDLE, SLOT_STOPPED = 2, 3
SLOT_TILE = 256
BATCH_CAP = 4096
# phase 32: the service's trace, mix (every shape signature seed-stable),
# deadlines (the reference's), slots per bucket and strategy pair (phase
# 10's N-queens pair, under which N-queens 32 proves q0 = 0 in 338
# supersteps)
SERVE_REQUESTS, SERVE_RATE, SERVE_BATCH = 16, 8.0, 4
SERVE_MIX = (("nqueens", dict(n=32), 1.0), ("knapsack", dict(n=20), 2.0),
             ("crossword", dict(n=8), 1.0))
SERVE_DEADLINES = (None, 120.0, 600.0)
SERVE_STRATEGY = ("min_dom", "split")
SERVE_MAX_WALL_S = 300.0
# phase 33: the random stores of each model (the last ones) the oracle
# (`fixpoint_ref`) and `batched_fixpoint(impl="cuda")` run on
SCATTER_REF_LANES = 64
# phase 34: the paper's comparison, (tag, tasks, seed) of
# rcpsp.generate(n, n_resources=4, seed), the optima the card must prove,
# and the baseline's time limit per instance
COMPARISON = (("J30 s0", 30, 0), ("J30 s1", 30, 1), ("J30 s2", 30, 2),
              ("J30 s3", 30, 3), ("J60 s0", 60, 0), ("J120 s0", 120, 0))
COMPARISON_OPTIMUM = {"J30 s0": J30_REFERENCE["objective"],
                      "J60 s0": J60_OPTIMUM,
                      "J120 s0": SPARSE_OPTIMUM["J120"]}
BASELINE_TIMEOUT_S = 60.0
# the planner demo's time per solve: its microbatch schedule proves no
# optimum within the reference's 120 s on the CPU, so the card's run is
# cut to this (it returns its best schedule)
PLANNER_TIMEOUT_S = 20
# phase 35: the examples, run from the repository root
EXAMPLES = (("examples/torch_quickstart.py",),
            ("examples/torch_rcpsp_solve.py", "--n", "8", "--count", "2"),
            ("examples/torch_planner_demo.py", "--timeout",
             str(PLANNER_TIMEOUT_S)))
EXAMPLE_TIMEOUT_S = 300
# phase 36: distributed EPS.  RCPSP J30 class (rcpsp.generate(30,
# n_resources=4, seed=0)), preset "prove", DIST_J30_LANES lanes per shard,
# eps_target DIST_J30_EPS: the JAX package's counters per mesh size
# (`dist_solve.solve_dist`, backend "gather", on fake CPU devices;
# tests/test_torch_planner_ft.py recomputes them from the JAX package)
DIST_J30_LANES, DIST_J30_EPS = 16, 64
DIST_J30_REFERENCE = {
    1: dict(status="OPTIMAL", objective=34, n_nodes=1680, n_fails=854,
            n_sols=18, n_sweeps=937, n_supersteps=106),
    2: dict(status="OPTIMAL", objective=34, n_nodes=1966, n_fails=1006,
            n_sols=9, n_sweeps=960, n_supersteps=63),
    4: dict(status="OPTIMAL", objective=34, n_nodes=3864, n_fails=1944,
            n_sols=20, n_sweeps=1920, n_supersteps=62)}
DIST_MESHES = (1, 2, 4)
# the steal run (mesh, chunk) on J60's pool with its second half failed,
# and the device-loss run (mesh, chunk, at_chunk, lost shard)
DIST_STEAL = (2, 1)
DIST_LOSS = (4, 8, 1, 1)
DIST_CLI = ("--n", "60", "--lanes", str(MAIN_LANES), "--eps-target",
            str(MAIN_EPS), "--mesh", "4")
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
PEAK_BF16_FLOP_S = 989e12
# the phases of a sweep the clocks library stamps (fixlane::Phase order)
PHASES = ("linear", "alldiff stage", "table supports", "cumulative events",
          "alldiff sort", "alldiff masks", "alldiff hall", "table current",
          "cumulative sort", "cumulative profile", "cumulative starts",
          "table survivors", "join")
# the phases of a superstep the search clocks library stamps
# (csrc/search.cu SPhase order), its per-superstep records (the first
# SEARCH_CLOCK_STEPS supersteps of a launch) and their fields
SEARCH_PHASES = ("dispatch", "want wait", "ranks", "load", "fixpoint",
                 "commit", "bound wait")
SEARCH_CLOCK_STEPS = 64
STEP_STATS = ("busy_sum", "busy_max", "cta_sweeps_max", "sweeps_sum",
              "sweeps_max", "lanes")
# the propagator banks both kernels cover (csrc/fixpoint_lane.cuh)
BANKS = ("ReifLinLe", "AllDifferent dense", "AllDifferent sparse",
         "Cumulative dense", "Cumulative sparse", "Compact-Table",
         "bitset store")
# phases 5-7 and 9: the resident search kernel
SEARCH_K = (1, 4, 16)
WARM_STEPS = 5             # plain supersteps before the second start
# phase 18's random pools: the large table models' searches from their
# 1024 random stores end within 4 supersteps (PR 16 chip run), so the
# second start is after 2, while lanes are mid-search
RANDOM_WARM = 2
FIRST_SOL_MAX = 512        # cap on the search for the first solution
MAIN_K = 16                # supersteps per launch on the main path
COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps")
# the variants phases 5 and 9 run: (name, preset, (var, val) strategy
# pair or None for the preset's own)
RCPSP_VARIANTS = tuple((p, p, None)
                       for p in ("prove", "fast", "first_solution"))
ZOO_VARIANTS = (("prove", "prove", None), ("fast", "fast", None),
                ("min_dom/split", "prove", ("min_dom", "split")))
# the bound's AllDifferent work per (upper endpoint, member) of a sorted
# Hall pass: a compare and an add for the count, a subtract and a compare
# for the width test, a compare and a max or min on each push side
ALLDIFF_OPS = 8
# the endpoint-pair algorithm of the kernel, per (endpoint pair, member):
# two compares, an AND and an add
PAIR_OPS = 4
N_PIGEONHOLE = 256         # of phase 8's 1024 random stores, made overfull
ZOO_CAP = 2048             # superstep cap of the cuda vs cuda_resident solves
ZOO_LONG_CAP = 100_000     # superstep cap of the long cuda_resident solves
# the strategy pair of each zoo main-path instance: first-fail (min_dom)
# on both; bisection for N-queens, smallest colour first for coloring
# (PERF.md section 4 has the trial on the card that chose them)
ZOO_STRATEGY = {"nqueens32": ("min_dom", "split"),
                "coloring64": ("min_dom", "min")}
# the optima the long solves prove on the card: N-queens' objective is
# q0 >= 0, and 0 is reached; coloring 64 needs five colours (cmax 4)
ZOO_OPTIMUM = {"nqueens32": 0, "coloring64": 4}
ZOO_SMOKE = ("rcpsp", "nqueens", "coloring", "knapsack", "jobshop",
             "crossword", "configuration")
ZOO_SMOKE_LANES = 16
ZOO_BACKENDS = ("gather", "cuda", "cuda_resident")
# small_instance(name, seed=0), preset "prove", 16 lanes, default
# eps_target: the JAX package's SolveResult (backend="gather", CPU)
ZOO_SMOKE_REFERENCE = {
    "rcpsp": dict(status="OPTIMAL", objective=13, n_nodes=200, n_fails=120,
                  n_sols=12, n_sweeps=90, n_supersteps=14),
    "nqueens": dict(status="OPTIMAL", objective=0, n_nodes=16, n_fails=6,
                    n_sols=10, n_sweeps=20, n_supersteps=2),
    "coloring": dict(status="OPTIMAL", objective=1, n_nodes=124, n_fails=92,
                     n_sols=2, n_sweeps=32, n_supersteps=9),
    "knapsack": dict(status="OPTIMAL", objective=-25, n_nodes=64,
                     n_fails=48, n_sols=16, n_sweeps=16, n_supersteps=5),
    "jobshop": dict(status="OPTIMAL", objective=6, n_nodes=64, n_fails=48,
                    n_sols=16, n_sweeps=16, n_supersteps=5),
    "crossword": dict(status="OPTIMAL", objective=22, n_nodes=2, n_fails=0,
                      n_sols=2, n_sweeps=18, n_supersteps=2),
    "configuration": dict(status="OPTIMAL", objective=18, n_nodes=8,
                          n_fails=3, n_sols=5, n_sweeps=18, n_supersteps=2),
}

# One model of the run: the zoo module, instance and handles (for the
# ground check), the compiled model on the card, its random stores, its
# EPS pool and, for a table model, its random bitset stores (None where
# no phase needs them).
Case = namedtuple("Case", "mod inst handles cm lbs ubs pool doms",
                  defaults=(None,))
# `eps.decompose` traced (`time_eps_launches`): its fixpoint launches, the
# device ms of one and its bound, the recorded (lbs, ubs, lbs', ubs') of
# each launch and the pool
EpsRun = namedtuple("EpsRun", "launches ms bound_ms bound_by calls pool")


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi(query):
    """First line of ``nvidia-smi --query-gpu=<query>`` (csv, no header)."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def load(name, inst, **compile_kw):
    """The Case of one zoo instance, compiled onto the card."""
    from repro_torch.core.models import ZOO
    mod = ZOO[name]
    m, handles = mod.build_model(inst)
    return Case(mod, inst, handles, m.compile(device="cuda", **compile_kw),
                None, None, None)


def describe(cm):
    s = f"V={cm.n_vars} P={cm.n_props} K={cm.k_terms} D={cm.d_occ}"
    if cm.n_cumulative:
        s += (f" C={cm.n_cumulative} T={cm.cu_width} Dcu={cm.cu_docc} "
              f"horizon={cm.horizon} cu_layout={cm.cu_layout}")
    if cm.n_alldiff:
        s += (f" A={cm.n_alldiff} N={cm.ad_width} Dad={cm.ad_docc} "
              f"ad_layout={cm.ad_layout}")
    if cm.n_table:
        s += (f" tables={cm.n_table} R={cm.ct_arity} W={cm.n_words} "
              f"TW={cm.ct_words} Dct={cm.ct_docc} ct_supp="
              f"{list(cm.ct_supp.shape)}")
    return f"{s} {cm.dtype}"


def prepare(phase, tag, case, eps_target=None):
    """`case` with N_RANDOM random stores (with an AllDifferent bank, the
    first N_PIGEONHOLE of them overfull) and, given `eps_target`, the EPS
    pool decomposed to it."""
    import numpy as np
    from repro_torch.core import eps
    from repro_torch.solver import SolveConfig
    from repro_torch.testing import (pigeonhole_stores, random_dom_stores,
                                     random_substores)
    cm = case.cm
    rng = np.random.default_rng(SEED)
    lbs, ubs = random_substores(rng, cm, N_RANDOM)
    if cm.n_alldiff:
        lbs[:N_PIGEONHOLE], ubs[:N_PIGEONHOLE] = pigeonhole_stores(
            rng, cm, lbs, ubs, N_PIGEONHOLE)
    doms = (random_dom_stores(rng, cm, lbs, ubs, n_wipe=N_WIPE)
            if cm.n_table else None)
    pool, msg = None, ""
    if eps_target:
        opts = SolveConfig.preset("prove", backend="cuda").search_options()
        t0 = time.perf_counter()
        pool = eps.decompose(cm, eps_target, opts)
        msg = (f"; EPS pool {pool[0].shape[0]} subproblems in "
               f"{time.perf_counter() - t0:.2f} s")
    print(f"[{phase}] {tag}: {describe(cm)}{msg}")
    return case._replace(lbs=lbs, ubs=ubs, pool=pool, doms=doms)


def rcpsp_cases():
    from repro_torch.core.models import rcpsp
    return {tag: prepare(2, tag, load("rcpsp", rcpsp.generate(
        n, n_resources=4, seed=SEED)), target)
        for tag, n, target in (("J30", 30, 1024), ("J60", 60, MAIN_EPS))}


def zoo_cases():
    from repro_torch.core.models import large_instance, nqueens
    return {
        "nqueens32": prepare(8, "nqueens32", load(
            "nqueens", nqueens.generate(32, seed=SEED)), MAIN_EPS),
        "coloring64": prepare(8, "coloring64", load(
            "coloring", large_instance("coloring", seed=SEED)), MAIN_EPS),
        "nqueens8": prepare(8, "nqueens8", load(
            "nqueens", nqueens.generate(8, seed=SEED)))}


# --------------------------------------------------------------------------
# phase 1: card and build
# --------------------------------------------------------------------------

def phase_card_and_build():
    """Returns the card line and the card's int32 peak (operations/s)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.fixpoint_kernel import FEW_THREADS
    card = nvidia_smi("name,power.limit")
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    peak_int32 = sms * INT32_LANES_PER_SM * mhz * 1e6
    print(f"[1] {sms} SMs x {INT32_LANES_PER_SM} INT32 lanes x {mhz:.0f} "
          f"MHz (max SM clock) = {peak_int32 / 1e12:.2f} T int32 op/s")
    for (_, var), built in zip(BUILDS, build.build_all(BUILDS)):
        print(f"[1] built {os.path.relpath(built.path, ROOT)} in "
              f"{built.seconds:.1f} s")
        for entry, regs, spills in ptxas_report(built.log):
            print(f"[1]   {entry}: {regs} registers, {spills} bytes spill "
                  f"stores{ctas_per_sm(built.name, var, entry)}")
            # the few-lane fixpoint instances (one CTA of FEW_THREADS per
            # SM: 64 registers a thread) must not spill
            if (built.name == "fixpoint" and spills
                    and entry.startswith(f"fixpoint<{FEW_THREADS},")):
                fail(f"{built.path.name}: {entry} spills {spills} bytes")
        # the flash kernel keeps its accumulators and p in registers
        if built.name == "flash_attention" and (
                "Local memory" in built.log
                or re.search(r"[1-9]\d* bytes spill stores", built.log)):
            fail("flash_attention.cu spills or uses local memory")
    return card, peak_int32


def ctas_per_sm(name, var, entry):
    """", N CTAs per SM" for a solver kernel instance (`ptxas_report`'s
    entry name) of library `name` variant `var`: the co-resident CTAs the
    occupancy query of the launch finds (``search_occupancy``,
    ``fixpoint_occupancy``) with no dynamic shared memory, so bounded by
    the instance's registers and threads alone (a model's shared memory
    may bound it further); "" for another kernel."""
    from repro_torch.kernels import fixpoint_kernel as K
    args = re.fullmatch(r"(fixpoint|search)<([\d,]+)>", entry)
    if args is None:
        return ""
    flags = [int(a) for a in args.group(2).split(",")]
    dtype = "int64" if var.endswith("i64") else "int32"
    if name == "search":
        lib = K._search_lib(dtype, var.startswith("tiles"),
                            clocks=var.startswith("clocks"))
        n = lib.search_occupancy(*flags, 0)
    else:
        lib = K._lib(dtype, clocks=var.startswith("clocks"))
        n = lib.fixpoint_occupancy(*flags, 0)
    if n < 1:
        fail(f"{name} {var} {entry}: no co-resident CTA ({n})")
    return f", {n} CTAs per SM"


def ptxas_report(log):
    """(entry, registers, spill-store bytes) of each kernel in an ``nvcc
    -Xptxas -v`` log, the solver kernels' entries named by their thread
    count and template arguments: ``fixpoint<threads, AD_SPARSE,
    CU_SPARSE, DOM>`` (``fixpoint_few_kernel`` is the few-lane instance),
    ``search<AD_SPARSE, CU_SPARSE, DOM>``."""
    from repro_torch.kernels.fixpoint_kernel import FEW_THREADS, THREADS
    out, entry, spills = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            t = re.search(r"(fixpoint_few|fixpoint|search)_kernelI"
                          r"((?:L[ib]\d+E)+)E", name)
            args = re.findall(r"L[ib](\d+)E", t.group(2)) if t else []
            if t and t.group(1).startswith("fixpoint"):
                args.insert(0, str(FEW_THREADS if t.group(1) ==
                                   "fixpoint_few" else THREADS))
            entry = (f"{t.group(1).split('_')[0]}<{','.join(args)}>" if t
                     else name)
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spills = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out.append((entry, int(m.group(1)), spills))
            entry, spills = None, 0
    return out


# --------------------------------------------------------------------------
# phases 2 and 8: the fixpoint kernel against its plain version
# --------------------------------------------------------------------------

def compare(cm, lb, ub, cap, what, dom=None):
    """Kernel vs plain version on one batch (with `dom`, a carried bitset
    store); returns (max_abs_err over non-failed stores, whole-output
    equality, sweeps, failed mask)."""
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    ref = F.fixpoint_batch(cm, lb, ub, dom, max_iters=cap)
    got = fixpoint_cuda(cm, lb, ub, dom, max_sweeps=cap)
    torch.cuda.synchronize()
    rdom = gdom = None
    if dom is not None:
        rdom, gdom = ref[2], got[2]
        ref, got = ref[:2] + ref[3:], got[:2] + got[3:]
    rlb, rub, rsw, rconv = ref
    glb, gub, gsw, gconv = got
    rfail, gfail = (rlb > rub).any(1), (glb > gub).any(1)
    if not torch.equal(rfail, gfail):
        fail(f"{what}: failed masks differ on "
             f"{int((rfail != gfail).sum())} lanes")
    ok = ~rfail
    err = max(int((glb[ok].long() - rlb[ok].long()).abs().max().item()
                  if ok.any() else 0),
              int((gub[ok].long() - rub[ok].long()).abs().max().item()
                  if ok.any() else 0))
    if err:
        fail(f"{what}: non-failed stores differ (max |err| {err})")
    if not torch.equal(rsw, gsw):
        fail(f"{what}: sweep counts differ on "
             f"{int((rsw != gsw).sum())} lanes")
    if not torch.equal(rconv, gconv):
        fail(f"{what}: convergence flags differ")
    if dom is not None and not torch.equal(rdom[ok], gdom[ok]):
        fail(f"{what}: the non-failed stores' domain words differ")
    whole = (torch.equal(rlb, glb) and torch.equal(rub, gub)
             and (dom is None or torch.equal(rdom, gdom)))
    return err, whole, rsw, rfail


def phase_kernel_vs_plain(phase, cases, pool_batches=None):
    """`fixpoint_cuda` against `fixpoint_batch` on each case's random
    stores and EPS pool (its first `pool_batches` batches of N_RANDOM
    stores, or all) at every cap of CAPS; the overfull stores of an
    AllDifferent model must fail uncapped.  Returns the max |err|."""
    import torch
    max_err = 0
    for tag, c in cases.items():
        batches = [("random", c.lbs, c.ubs)]
        if c.pool is not None:
            plb, pub = c.pool
            batches += [(f"pool[{i}:{i + N_RANDOM}]", plb[i:i + N_RANDOM],
                         pub[i:i + N_RANDOM])
                        for i in range(0, plb.shape[0], N_RANDOM)
                        ][:pool_batches]
        n_over = N_PIGEONHOLE if c.cm.n_alldiff else 0
        for cap in CAPS:
            lanes = whole = over_failed = 0
            sweeps = []
            for name, bl, bu in batches:
                lb = torch.from_numpy(bl).cuda()
                ub = torch.from_numpy(bu).cuda()
                err, same, sw, failed = compare(
                    c.cm, lb, ub, cap, f"{tag} {name} max_sweeps={cap}")
                if name == "random":
                    over_failed = int(failed[:n_over].sum())
                max_err = max(max_err, err)
                lanes += lb.shape[0]
                whole += int(same)
                sweeps.append(sw)
            sw = torch.cat(sweeps)
            over = (f"; {over_failed}/{n_over} overfull stores failed"
                    if n_over else "")
            print(f"[{phase}] {tag} max_sweeps={cap}: {lanes} lanes equal "
                  f"(failed masks, stores, sweeps, converged); "
                  f"{whole}/{len(batches)} batches equal in every store; "
                  f"sweeps mean {sw.float().mean().item():.2f} "
                  f"max {int(sw.max())}{over}")
            if cap is None and over_failed != n_over:
                fail(f"{tag}: {n_over - over_failed} overfull stores did "
                     "not fail")
    return max_err


def checked_cases(phase, make, pool_batches=None):
    """The cases `make()` returns, held by `phase_kernel_vs_plain`."""
    cases = make()
    return cases, phase_kernel_vs_plain(phase, cases, pool_batches)


# --------------------------------------------------------------------------
# phases 3, 6, 10 and 11: solves through the main path
# --------------------------------------------------------------------------

def main_config(backend, strategy=None, **kw):
    """The main path's configuration: `prove`, 1024 lanes, eps_target
    4096, K=16 for `cuda_resident`, optionally a (var, val) pair."""
    from repro_torch.solver import SolveConfig
    if strategy:
        kw.update(var_strategy=strategy[0], val_strategy=strategy[1])
    if backend == "cuda_resident":
        kw.update(supersteps_per_launch=MAIN_K)
    kw.setdefault("timeout_s", MAIN_TIMEOUT_S)
    return SolveConfig.preset("prove", backend=backend, n_lanes=MAIN_LANES,
                              eps_target=MAIN_EPS, **kw)


def solve_case(phase, tag, c, cfg, optimum=None):
    """One solve through `Solver.solve` with the launch counters set to 0
    just before and read just after.  The solution is ground-checked, the
    backend's kernel must have run (`cuda`: a launch per superstep at
    least; `cuda_resident`: one per K supersteps), and with `optimum`
    the result must be OPTIMAL at it.  Returns (result, (fixpoint_cuda
    launches, search_cuda launches, fixpoint_cuda launches of the
    few-lane instance))."""
    from repro_torch.core.models import ground_check
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda, search_cuda
    from repro_torch.solver import Solver
    fixpoint_cuda.launches = 0
    fixpoint_cuda.few_lane_launches = 0
    search_cuda.launches = 0
    res = Solver(cfg).solve(c.cm)
    launches = (fixpoint_cuda.launches, search_cuda.launches,
                fixpoint_cuda.few_lane_launches)
    checked = ground_check(c.mod, c.inst, c.handles, res)
    if checked is False:
        fail(f"{tag} ({cfg.backend}): the solution fails the ground check")
    steps = res.n_supersteps
    search_s = res.wall_s - res.eps_s
    print(f"[{phase}] {tag} ({cfg.backend}, {cfg.var_strategy}/"
          f"{cfg.val_strategy}, {cfg.n_lanes} lanes, eps_target "
          f"{cfg.resolved_eps_target()}, max_supersteps "
          f"{cfg.max_supersteps}): {res.status} objective={res.objective} "
          f"nodes={res.n_nodes} ({res.nodes_per_sec:.0f}/s) "
          f"fails={res.n_fails} sols={res.n_sols} sweeps={res.n_sweeps} "
          f"supersteps={steps} wall={res.wall_s:.2f} s "
          f"eps={res.eps_s:.2f} s ({res.eps_s / res.wall_s:.1%} of the "
          f"wall), search {search_s * 1e3:.1f} ms "
          f"({search_s / max(steps, 1) * 1e3:.4f} ms/superstep after EPS) "
          f"fixpoint_cuda launches={launches[0]} (few-lane instance "
          f"{launches[2]}) search_cuda launches={launches[1]}; ground check "
          f"{'OK' if checked else 'n/a (no solution)'}")
    fix, srch, _ = launches
    if cfg.backend == "cuda" and (fix == 0 or fix < steps):
        fail(f"{tag}: {fix} fixpoint_cuda launches for {steps} supersteps")
    if cfg.backend == "cuda_resident" and (
            srch == 0 or srch < -(-steps // cfg.resolved_supersteps())):
        fail(f"{tag}: {srch} search_cuda launches for {steps} supersteps")
    if optimum is not None and (res.status != "OPTIMAL"
                                or res.objective != optimum):
        fail(f"{tag} ({cfg.backend}): expected OPTIMAL {optimum} within "
             f"{cfg.max_supersteps} supersteps, got {res.status} "
             f"{res.objective} after {steps}")
    return res, launches


def same_counters(phase, what, results, reference=None):
    """Fails unless every result of `results` (backend -> SolveResult)
    has the same COUNTERS, equal to `reference` where given."""
    names = list(results)
    for k in COUNTERS:
        vals = [getattr(results[b], k) for b in names]
        if len(set(vals)) != 1:
            fail(f"{what}: {k} differs: "
                 + ", ".join(f"{b} {v}" for b, v in zip(names, vals)))
        if reference is not None and vals[0] != reference[k]:
            fail(f"{what}: {k} = {vals[0]}, the JAX package gives "
                 f"{reference[k]}")
    print(f"[{phase}] {what}: {' == '.join(names)}"
          f"{' == JAX reference' if reference else ''} on "
          + ", ".join(COUNTERS))


def phase_main_path(cases):
    import torch
    from repro_torch.solver import SolveConfig
    res, (launches, _, few) = solve_case(3, "J60", cases["J60"],
                                         main_config("cuda"), J60_OPTIMUM)
    # EPS runs the few-lane instance, the supersteps the 256-thread one
    if not 0 < few < launches:
        fail(f"J60: {few} of {launches} fixpoint_cuda launches on the "
             "few-lane instance")

    # the cost of the per-superstep host read of the global done flag
    flag = torch.zeros(MAIN_LANES, dtype=torch.bool).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        bool(flag.all())
    sync_us = (time.perf_counter() - t0) / 200 * 1e6
    print(f"[3] host read of the done flag: {sync_us:.1f} us per superstep "
          f"(idle stream)")

    got = {b: solve_case(3, "J30", cases["J30"], SolveConfig.preset(
        "prove", backend=b, n_lanes=J30_LANES))[0] for b in ("cuda", "gather")}
    same_counters(3, "J30", got, J30_REFERENCE)
    return launches, few, res


def phase_resident_path(cases, ref):
    res, (_, launches, _) = solve_case(6, "J60", cases["J60"],
                                    main_config("cuda_resident"))
    same_counters(6, "J60", {"cuda": ref, "cuda_resident": res})
    return launches, res


def phase_zoo_main_path(cases):
    """N-queens 32 and coloring 64: `cuda` and `cuda_resident` under
    ZOO_CAP supersteps (equal results and counters), then
    `cuda_resident` under ZOO_LONG_CAP to the optimum.  Returns the
    launches by (tag, run) and the long runs' (config, result) by tag."""
    launches, long = {}, {}
    for tag, strategy in ZOO_STRATEGY.items():
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                10, tag, cases[tag],
                main_config(backend, strategy, max_supersteps=ZOO_CAP))
        same_counters(10, tag, got)
        cfg = main_config("cuda_resident", strategy,
                          max_supersteps=ZOO_LONG_CAP)
        res, launches[(tag, "long")] = solve_case(10, tag, cases[tag], cfg,
                                                  ZOO_OPTIMUM[tag])
        long[tag] = (cfg, res)
    return launches, long


def phase_zoo_smoke():
    from repro_torch.core.models import small_instance
    from repro_torch.solver import SolveConfig
    for name in ZOO_SMOKE:
        c = load(name, small_instance(name, seed=SEED))
        got = {b: solve_case(11, name, c, SolveConfig.preset(
            "prove", backend=b, n_lanes=ZOO_SMOKE_LANES))[0]
            for b in ZOO_BACKENDS}
        same_counters(11, f"{name} smoke", got, ZOO_SMOKE_REFERENCE[name])


# --------------------------------------------------------------------------
# phases 4, 7 and 12: times and bounds
# --------------------------------------------------------------------------

def cuda_ms(fn, reps, warmup):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def table_bytes(cm, dom=False):
    """Bytes of the propagator tables a sweep of this model reads: a
    bank's dense ``[rows, width]`` tables or its packed (sparse) ones,
    as the model compiled, and its occurrence lists; the Compact-Table
    bank's only with tables, the domain layout (offsets, tracked flags)
    only with tables or a carried store (`dom`)."""
    from repro_torch.kernels.fixpoint_kernel import kernel_tables
    unread = ((cm.ad_vars, cm.ad_offs, cm.ad_mask)
              if cm.ad_layout == "sparse" else
              (cm.ad_ptr, cm.ad_pk_var, cm.ad_pk_off, cm.ad_pk_seg))
    unread += ((cm.cu_svar, cm.cu_dur, cm.cu_dem)
               if cm.cu_layout == "sparse" else
               (cm.cu_ptr, cm.cu_pk_svar, cm.cu_pk_dur, cm.cu_pk_dem,
                cm.cu_pk_seg))
    if not cm.n_table:
        unread += (cm.ct_vars, cm.ct_mask, cm.ct_supp, cm.ct_occ_inst,
                   cm.ct_occ_pos)
        if not dom:
            unread += (cm.dom_off, cm.dom_track)
    return sum(t.numel() * t.element_size() for t in kernel_tables(cm)
               if not any(t.data_ptr() == u.data_ptr() for u in unread))


def row_sizes(cm):
    """Members of each real AllDifferent row."""
    return cm.ad_mask[:cm.n_alldiff].sum(1).tolist() if cm.n_alldiff else []


def ops_per_sweep(cm, dom=False):
    """The integer work one fixpoint sweep of one lane needs (at int64
    counted against the int32 peak, so a lower bound), apart from
    the Compact-Table bank's per-value work (`ct_ops_per_value`): 8·P1·K
    for the linear bank and 2·V·D for its join; with a Cumulative bank,
    4·C1·T for the tasks (each adds its compulsory part's two ends, and
    each task's first and last start take at least one operation each),
    per row of n tasks the lesser of two ways to build the profile — a
    prefix sum and a capacity compare per time point of the horizon
    (2·H), or a sort of its 2·n events and a sum and a compare per event
    (2·2n·⌈log2 2n⌉ + 4·n; the lesser at durations × 10⁷) — and
    2·V·Dcu for its join; with an AllDifferent bank, on each row of n
    members the lesser of two algorithms' work: a sorted Hall pass,
    2·n·⌈log2 n⌉ compares to sort the members by lower and by upper
    bound and ALLDIFF_OPS per (upper endpoint, member) for the counts,
    the width tests and the pushes, or the endpoint-pair pass, PAIR_OPS·n³ (cheaper for n = 2);
    and 2·V·Dad for its join; with a Compact-Table bank, r·TW per table
    row of r members to AND their support ORs into the current table and
    2·V·Dct for its join; with a carried bitset store (`dom`) also
    V·Dct·W to AND the tables' words in and 4·V·W to normalize."""
    P1, K = cm.vidx.shape
    V = cm.n_vars
    ops = 8 * P1 * K + 2 * V * cm.d_occ
    if cm.n_cumulative:
        C1, T = cm.cu_svar.shape
        C = cm.n_cumulative
        rows = (cm.cu_ptr[1:C + 1] - cm.cu_ptr[:C]).tolist()
        ops += (4 * C1 * T + 2 * V * cm.cu_docc
                + sum(min(2 * cm.horizon,
                          4 * n * math.ceil(math.log2(2 * n)) + 4 * n)
                      for n in rows if n))
    if cm.n_alldiff:
        ops += sum(min(2 * n * math.ceil(math.log2(n)) + ALLDIFF_OPS * n * n,
                       PAIR_OPS * n ** 3)
                   for n in row_sizes(cm) if n > 1) + 2 * V * cm.ad_docc
    W = cm.n_words
    if cm.n_table:
        TW = cm.ct_words
        ops += int(cm.ct_mask[:cm.n_table].ne(0).sum()) * TW
        ops += 2 * V * cm.ct_docc + (V * cm.ct_docc * W if dom else 0)
    if dom:
        ops += 4 * V * W
    return ops


def ct_ops_per_value(cm):
    """The Compact-Table bank's work per value a member holds in the
    store a sweep reads: a bit test and an OR per support word (2·TW) to
    OR the value's support into the member's, and three operations to
    test whether it survives and fold it into the hull."""
    return 2 * cm.ct_words + 3


def ct_values(cm, lb, ub, dom=None):
    """Per lane ``[L]``: the values the table rows' real members hold in
    the store a sweep reads — the carried words `dom`, or without them
    the range words of [lb, ub] (untracked variables all-ones), as the
    sweep builds them — summed over every member of every row."""
    import torch
    from repro_torch.core import bitset as B
    if dom is None:
        dom = B.from_bounds(lb, ub, cm.dom_off, cm.n_words,
                            track=cm.dom_track.view(torch.int32))
    T = cm.n_table
    members = cm.ct_vars[:T][cm.ct_mask[:T] != 0].long()
    return B.count(dom.index_select(1, members)).long().sum(1)


def ct_value_work(cm, lb, ub, dom, sweeps, plain_fixpoint):
    """The member values the Compact-Table bank walks in a fixpoint run
    from (lb, ub, dom) in which lane l made ``sweeps[l]`` sweeps: sweep k
    reads the store after k - 1 sweeps (Jacobi), which one-sweep calls of
    `plain_fixpoint` (`fixpoint_batch`) replay."""
    total = 0
    for k in range(int(sweeps.max()) if sweeps.numel() else 0):
        total += int(ct_values(cm, lb, ub, dom)[sweeps > k].sum())
        out = plain_fixpoint(cm, lb, ub, dom, max_iters=1)
        lb, ub = out[0], out[1]
        dom = out[2] if dom is not None else None
    return total


@contextlib.contextmanager
def counting_ct_values(cm):
    """Within the block, every plain fixpoint (`fixpoint_batch`, which
    `search_plain` runs through its gather backend) adds the member
    values its sweeps walk (`ct_value_work`) to the yielded list's one
    cell."""
    from repro_torch.core import fixpoint as F
    plain = F.fixpoint_batch
    acc = [0]

    def counted(cm_, lb, ub, dom=None, **kw):
        out = plain(cm_, lb, ub, dom, **kw)
        acc[0] += ct_value_work(cm_, lb, ub, dom, out[-2], plain)
        return out
    F.fixpoint_batch = counted
    try:
        yield acc
    finally:
        F.fixpoint_batch = plain


def sparse_work_per_sweep(cm):
    """The sparse banks' own work per lane-sweep, as the kernel does it:
    (sort compares, scan steps).  A sort of n keys counts n·⌈log2 n⌉
    compares (n = Mad members; n = 2·Mcu events); the scans count one
    step per (member, member of its row) in the Hall count and again in
    the push (2·n² per row of n), and one per (task, event of its row),
    forward and backward (2·n·2n per row of n tasks)."""
    def nlog(n):
        return n * math.ceil(math.log2(n)) if n > 1 else 0
    sort = scan = 0
    if cm.n_alldiff and cm.ad_layout == "sparse":
        sort += nlog(cm.ad_packed)
        scan += sum(2 * n * n for n in row_sizes(cm))
    if cm.n_cumulative and cm.cu_layout == "sparse":
        sort += nlog(2 * cm.cu_packed)
        rows = (cm.cu_ptr[1:cm.n_cumulative + 1]
                - cm.cu_ptr[:cm.n_cumulative]).tolist()
        scan += sum(4 * n * n for n in rows)
    return sort, scan


def pair_ops_per_sweep(cm):
    """The AllDifferent work of the kernel's own endpoint-pair algorithm
    per lane-sweep, every pair counted: PAIR_OPS·n³ per row."""
    return sum(PAIR_OPS * n ** 3 for n in row_sizes(cm))


def live_pair_share(cm, lb, ub):
    """Share of the endpoint pairs (i, j) of real members with
    yl_i <= yu_j in the stores `lb`/`ub`: the pairs the kernel does not
    skip in a sweep of them."""
    A = cm.n_alldiff
    msk = cm.ad_mask[:A] != 0
    idx, off = cm.ad_vars[:A].long(), cm.ad_offs[:A]
    yl, yu = lb[:, idx] + off, ub[:, idx] + off                # [L, A, N]
    live = ((yl[:, :, :, None] <= yu[:, :, None, :])
            & msk[:, :, None] & msk[:, None, :])
    return int(live.sum()) / (lb.shape[0] * sum(n * n
                                                 for n in row_sizes(cm)))


def bound(nbytes, ops, peak_int32):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate
    and int32 operations over the int32 peak."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak_int32 * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def pair_note(cm, lane_sweeps, peak_int32):
    """The kernel's own work where it differs from the bound's count: the
    dense AllDifferent bank's endpoint pairs, the sparse banks' sorts and
    scans."""
    if cm.n_alldiff and cm.ad_layout == "dense":
        ops = lane_sweeps * pair_ops_per_sweep(cm)
        return (f"; the endpoint-pair algorithm's own AllDifferent work, "
                f"every pair: {ops} int32 ops "
                f"({ops / peak_int32 * 1e3:.5f} ms)")
    sort, scan = sparse_work_per_sweep(cm)
    if not sort:
        return ""
    return (f"; the sparse banks' own work: {lane_sweeps * sort} sort "
            f"compares and {lane_sweeps * scan} scan steps ({sort} and "
            f"{scan} per lane-sweep)")


def time_fixpoint(card, peak_int32, cm, lbs, ubs, tag, what, plain_reps=5,
                  doms=None):
    """`fixpoint_cuda` and `fixpoint_batch` per launch (CUDA events) on
    ``[MAIN_LANES, V]`` stores (with `doms`, ``uint32 [L, V, W]``, a
    carried bitset store), uncapped, beside the bound: each table and
    store read once and each output written once, over the HBM rate;
    the sweeps this run needed times `ops_per_sweep`, over the int32
    peak.  Returns (kernel ms, plain ms, bound ms, bound_by)."""
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    lb = torch.from_numpy(lbs[:MAIN_LANES]).cuda()
    ub = torch.from_numpy(ubs[:MAIN_LANES]).cuda()
    dom = (None if doms is None else
           torch.from_numpy(doms[:MAIN_LANES].view("int32")).cuda())
    L, V = lb.shape
    n0 = fixpoint_cuda.launches
    ms = cuda_ms(lambda: fixpoint_cuda(cm, lb, ub, dom), reps=50, warmup=5)
    plain_ms = cuda_ms(lambda: F.fixpoint_batch(cm, lb, ub, dom),
                       reps=plain_reps, warmup=1)
    fixpoint_cuda.launches = n0            # timing launches are not counted
    lane_sweeps = F.fixpoint_batch(cm, lb, ub, dom)[-2]
    sweeps = int(lane_sweeps.sum())
    carried = dom is not None
    nbytes = (table_bytes(cm, carried) + 4 * L * V * lb.element_size()
              + 2 * L * 4 + (2 * dom.numel() * 4 if carried else 0))
    ops = sweeps * ops_per_sweep(cm, carried)
    live = ""
    if cm.n_table:
        values = ct_value_work(cm, lb, ub, dom, lane_sweeps,
                               F.fixpoint_batch)
        ops += values * ct_ops_per_value(cm)
        live = (f"; {values / sweeps:.1f} table-member values per "
                f"lane-sweep")
    bound_ms, bound_by = bound(nbytes, ops, peak_int32)
    if cm.n_alldiff and cm.ad_layout == "dense":
        live = (f"; {live_pair_share(cm, lb, ub):.1%} of the endpoint "
                f"pairs live in the input stores")
    print(f"[{tag}] fixpoint at [{L}, {V}] {cm.dtype} ({what}, uncapped, "
          f"{sweeps} lane-sweeps): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, {ops} "
          f"ops at {peak_int32 / 1e12:.2f} T/s; kernel {ms / bound_ms:.0f}x "
          f"the bound){pair_note(cm, sweeps, peak_int32)}{live} on {card}")
    return ms, plain_ms, bound_ms, bound_by


def decompose_recorded(cm, strategy=None, replies=None):
    """`eps.decompose` to MAIN_EPS subproblems under `main_config`'s
    options (with the strategy pair), each propagation recorded as (lbs,
    ubs, lbs', ubs').  With `replies` (a decomposition's recorded calls),
    the propagations return those results instead of launching, after
    checking that each one's stores are the recorded ones.  Returns (the
    calls, the pool)."""
    import numpy as np
    from repro_torch.core import eps
    calls, propagate = [], eps._propagate
    opts = main_config("cuda", strategy).search_options()

    def record(backend, cm_, lbs, ubs):
        if replies is None:
            out = propagate(backend, cm_, lbs, ubs)
        else:
            i = len(calls)
            if i >= len(replies) or not (np.array_equal(lbs, replies[i][0])
                                         and np.array_equal(ubs,
                                                            replies[i][1])):
                fail(f"the replayed decomposition left the recorded one at "
                     f"propagation {i}")
            out = replies[i][2:]
        calls.append((lbs, ubs) + tuple(out))
        return out

    eps._propagate = record
    try:
        pool = eps.decompose(cm, MAIN_EPS, opts)
    finally:
        eps._propagate = propagate
    return calls, pool


def time_eps_launches(card, peak_int32, cm, tag, what, strategy=None):
    """`fixpoint_cuda` as `core/eps.py` issues it on the main path:
    `eps.decompose` to MAIN_EPS subproblems (`main_config`'s options, with
    the instance's strategy pair), traced with ``torch.profiler``, gives the
    device time of its launches (the root's ``[1, V]``, then one ``[2,
    V]`` pair per split); the bound per launch as `time_fixpoint`'s
    (tables, stores in and out and counters; the sweeps its lanes need,
    counted from one batched run of the recorded stores, as lanes are
    independent).  Returns an `EpsRun`: the recorded ``[n, V]`` stores of
    each launch with the kernel's results, and the pool."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    n0 = fixpoint_cuda.launches, fixpoint_cuda.few_lane_launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        calls, pool = decompose_recorded(cm, strategy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = fixpoint_cuda.launches - n0[0]
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and "fixpoint" in e.key]
    count = sum(e.count for e in rows)
    if launches != len(calls) or not count:
        fail(f"{tag}: EPS made {launches} launches for {len(calls)} "
             f"propagations, {count} traced")
    ms = sum(e.self_device_time_total for e in rows) / 1e3 / count
    lb = torch.from_numpy(np.concatenate([c[0] for c in calls])).cuda()
    ub = torch.from_numpy(np.concatenate([c[1] for c in calls])).cuda()
    sweeps = fixpoint_cuda(cm, lb, ub)[-2].cpu().numpy()
    # timing launches are not counted
    fixpoint_cuda.launches, fixpoint_cuda.few_lane_launches = n0
    bound_ms = t_bytes = t_ops = 0.0
    first = 0
    for lbs, *_ in calls:
        L, V = lbs.shape
        nbytes = table_bytes(cm) + 4 * L * V * lbs.itemsize + 2 * L * 4
        ops = int(sweeps[first:first + L].sum()) * ops_per_sweep(cm)
        bound_ms += bound(nbytes, ops, peak_int32)[0]
        t_bytes += bound(nbytes, 0, peak_int32)[0]
        t_ops += bound(0, ops, peak_int32)[0]
        first += L
    bound_ms /= launches
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[{tag}] fixpoint as EPS issues it ({what}, eps_target "
          f"{MAIN_EPS}): {launches} launches (1 of [1, {cm.n_vars}], "
          f"{launches - 1} of [2, {cm.n_vars}]), {int(sweeps.sum())} "
          f"lane-sweeps; kernel {ms:.4f} ms per launch on the device "
          f"(profiler, {count} runs traced), bound {bound_ms:.5f} ms per "
          f"launch (kernel {ms / bound_ms:.0f}x the bound), launches x "
          f"(ms - bound) "
          f"{launches * (ms - bound_ms):.1f} ms; EPS wall {wall:.2f} s "
          f"traced, device busy {launches * ms / 1e3 / wall:.1%} of it, on "
          f"{card}")
    return EpsRun(launches, ms, bound_ms, bound_by, calls, pool)


def clock_breakdown(cm, tag, what, calls, threads):
    """Per-phase SM clocks of `fixpoint_cuda`'s sweeps: `calls` (the
    ``[n, V]`` stores `time_eps_launches` recorded) replayed one launch
    each through the ``clocks`` library at `threads` per CTA, whose
    sweeps end every phase with a barrier and a clock stamp
    (``fixlane::Phase``, ``FIXLANE_CLOCKS``).  Prints the clocks per
    lane-sweep of each phase that ran, its share, and the replay's
    device ms per launch (CUDA events; the stamps' barriers included).
    Returns {phase: clocks per lane-sweep}."""
    import ctypes
    import numpy as np
    import torch
    from repro_torch.kernels import fixpoint_kernel as K
    lib = K._lib(cm.dtype, clocks=True)
    buf = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    sizes = [c[0].shape[0] for c in calls]
    lb = torch.from_numpy(np.concatenate([c[0] for c in calls])).cuda()
    ub = torch.from_numpy(np.concatenate([c[1] for c in calls])).cuda()
    parts = list(zip(lb.split(sizes), ub.split(sizes)))
    if lib.fixpoint_clocks(buf):                       # clear
        fail("fixpoint_clocks failed")
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for l, u in parts:
        K.launch_fixpoint(lib, cm, l.contiguous(), u.contiguous(), None,
                          None, threads)
    t1.record()
    torch.cuda.synchronize()
    if lib.fixpoint_clocks(buf):
        fail("fixpoint_clocks failed")
    sweeps = buf[len(PHASES)]
    per = {name: buf[i] / max(sweeps, 1) for i, name in enumerate(PHASES)}
    total = sum(per.values())
    shown = ", ".join(f"{name} {c:.0f} ({c / total:.1%})"
                      for name, c in per.items() if c > 0)
    print(f"[{tag}] clocks per lane-sweep by phase, {what}, {threads} "
          f"threads per CTA ({len(calls)} launches, {sweeps} lane-sweeps; "
          f"replay {t0.elapsed_time(t1) / len(calls):.4f} ms per launch by "
          f"CUDA events, stamps and host gaps included): total "
          f"{total:.0f}: {shown}")
    return per


def search_clock_breakdown(card, timing_state, tag, what):
    """One K=MAIN_K launch of `search_cuda` from `timing_state` (model,
    pool, start, keywords), replayed through the search ``clocks``
    library, whose supersteps end every phase with a barrier and a clock
    stamp (``SPhase``) and whose sweeps stamp theirs (``fixlane::Phase``);
    its outputs must equal `search_cuda`'s.  Prints the share of
    CTA-clocks each superstep phase takes, the clocks per lane-sweep of
    each sweep phase, and per superstep the lanes' sweeps (mean and
    maximum), the sweeps of one CTA's lanes (mean and maximum) and the
    CTAs' busy clocks (every phase but the two grid-barrier waits; mean
    and maximum).  Returns the summary: busy clocks summed over the
    supersteps of the slowest CTA and of the mean CTA, and the least
    that the longest lane and the CTA with the most sweeps take at the
    clocks per lane-sweep of this launch."""
    import ctypes
    from repro_torch.kernels import fixpoint_kernel as K
    from repro_torch.testing import search_diff
    cm, slb, sub, start, kw = timing_state
    lib = K._search_lib(cm.dtype, False, clocks=True)
    n_fix, n_sup = len(PHASES) + 1, len(SEARCH_PHASES)
    buf = (ctypes.c_ulonglong * (n_fix + n_sup + SEARCH_CLOCK_STEPS
                                 * len(STEP_STATS)))()
    if lib.search_clocks(buf):                         # clear
        fail("search_clocks failed")
    got = K.launch_search(lib, cm, slb, sub, *start, supersteps=MAIN_K,
                          **kw)
    if lib.search_clocks(buf):
        fail("search_clocks failed")
    n0 = K.search_cuda.launches
    ref = K.search_cuda(cm, slb, sub, *start, supersteps=MAIN_K, **kw)
    K.search_cuda.launches = n0           # a check, not the main path
    bad = search_diff(ref, got)
    if bad:
        fail(f"{tag} {what}: the clocks library differs from search_cuda "
             f"in {bad}")
    L = start[0].lb.shape[0]
    grid = lib.search_grid(L, *K._c_tables(cm), int(start[0].dom is not None))
    sweep_clk = sum(buf[:n_fix - 1])
    lane_sweeps = buf[n_fix - 1]
    per_sweep = sweep_clk / max(lane_sweeps, 1)
    sup = buf[n_fix:n_fix + n_sup]
    total = sum(sup)
    print(f"[{tag}] superstep clocks, {what} (K={MAIN_K}, {L} lanes on "
          f"{grid} CTAs, the clocks library): share of CTA-clocks by "
          f"phase: " + ", ".join(f"{name} {c / total:.1%}"
                                 for name, c in zip(SEARCH_PHASES, sup)))
    shares = ", ".join(f"{name} {buf[i] / max(lane_sweeps, 1):.0f} "
                       f"({buf[i] / max(sweep_clk, 1):.1%})"
                       for i, name in enumerate(PHASES) if buf[i])
    print(f"[{tag}] sweep clocks, {what}: {lane_sweeps} lane-sweeps, "
          f"{per_sweep:.0f} clocks per lane-sweep: {shares}")
    steps = [dict(zip(STEP_STATS, buf[n_fix + n_sup + k * len(STEP_STATS):
                                     n_fix + n_sup + (k + 1)
                                     * len(STEP_STATS)]))
             for k in range(min(MAIN_K, SEARCH_CLOCK_STEPS))]
    steps = [r for r in steps if r["lanes"]]
    rows = []
    for k, r in enumerate(steps):
        rows.append(f"{k}: lanes {r['lanes']}, sweeps mean "
                    f"{r['sweeps_sum'] / r['lanes']:.2f} max "
                    f"{r['sweeps_max']}, CTA sweeps mean "
                    f"{r['sweeps_sum'] / grid:.2f} max "
                    f"{r['cta_sweeps_max']}, busy kclk mean "
                    f"{r['busy_sum'] / grid / 1e3:.1f} max "
                    f"{r['busy_max'] / 1e3:.1f}")
    print(f"[{tag}] per superstep, {what}: " + "; ".join(rows))
    summary = dict(
        busy_max=sum(r["busy_max"] for r in steps),
        busy_mean=sum(r["busy_sum"] for r in steps) / grid,
        longest_lane=per_sweep * sum(r["sweeps_max"] for r in steps),
        busiest_cta=per_sweep * sum(r["cta_sweeps_max"] for r in steps),
        even_split=per_sweep * sum(r["sweeps_sum"] for r in steps) / grid)
    print(f"[{tag}] summed over {len(steps)} supersteps, {what}, in "
          f"kclk: slowest CTA's busy {summary['busy_max'] / 1e3:.0f}, mean "
          f"CTA's {summary['busy_mean'] / 1e3:.0f}; at {per_sweep:.0f} "
          f"clocks per lane-sweep the longest lane's sweeps take "
          f"{summary['longest_lane'] / 1e3:.0f}, the busiest CTA's "
          f"{summary['busiest_cta'] / 1e3:.0f}, all sweeps spread evenly "
          f"over the CTAs {summary['even_split'] / 1e3:.0f} on {card}")
    return summary


def eps_launches_and_clocks(card, peak_int32, cm, tag, what, strategy=None):
    """`time_eps_launches`, then the clock breakdown of its recorded
    launches on both instances (few-lane, then 256 threads).  Returns
    `time_eps_launches`' tuple."""
    from repro_torch.kernels.fixpoint_kernel import FEW_THREADS, THREADS
    out = time_eps_launches(card, peak_int32, cm, tag, what, strategy)
    for threads in (FEW_THREADS, THREADS):
        clock_breakdown(cm, tag, f"{what} EPS", out.calls, threads)
    return out


def search_bound_ms(cm, start, out, peak_int32, launches=1, ct_vals=0):
    """Least time for the work of `launches` launches from `start` to
    `out`: the LaneState read once and written once per launch (bools one
    byte each) and the tables read once per launch, over the HBM rate;
    the sweeps they needed times `ops_per_sweep`, the `ct_vals` table-
    member values their sweeps walked times `ct_ops_per_value`, plus, per
    lane and live superstep, the commit's solved/failed checks (2·V) and
    branch selection (3·B), over the int32 peak.  Dispatch, the tells and
    backtracking are counted as nothing, so this is a lower bound."""
    st_in, st_out = start[0], out[0]
    L, V = st_in.lb.shape
    B = int(cm.branch_vars.shape[0])
    steps = int(out[2]) - int(start[2])
    sweeps = int(st_out.n_sweeps.long().sum() - st_in.n_sweeps.long().sum())
    state = sum(a.numel() * a.element_size() for a in st_in
                if a is not None)
    carried = st_in.dom is not None
    nbytes = launches * (2 * state + table_bytes(cm, carried))
    ops = (sweeps * ops_per_sweep(cm, carried)
           + (ct_vals * ct_ops_per_value(cm) if cm.n_table else 0)
           + steps * L * (2 * V + 3 * B))
    return (*bound(nbytes, ops, peak_int32), nbytes, ops, steps, sweeps)


def time_search(card, peak_int32, timing_state, tag, what, plain_reps=2,
                plain_warmup=1):
    """`search_cuda` and `search_plain` per launch (CUDA events) from one
    start, beside the bound; returns (kernel ms, plain ms, bound ms,
    bound_by)."""
    from repro_torch.kernels.fixpoint_kernel import search_cuda, search_plain
    cm, slb, sub, start, kw = timing_state
    n0 = search_cuda.launches
    out = search_cuda(cm, slb, sub, *start, supersteps=MAIN_K, **kw)
    ms = cuda_ms(lambda: search_cuda(cm, slb, sub, *start,
                                     supersteps=MAIN_K, **kw),
                 reps=20, warmup=3)
    plain_ms = cuda_ms(lambda: search_plain(cm, slb, sub, *start,
                                            supersteps=MAIN_K, **kw),
                       reps=plain_reps, warmup=plain_warmup)
    search_cuda.launches = n0             # timing launches are not counted
    ct_vals, note = 0, ""
    if cm.n_table:
        with counting_ct_values(cm) as acc:
            search_plain(cm, slb, sub, *start, supersteps=MAIN_K, **kw)
        ct_vals = acc[0]
    bound_ms, bound_by, nbytes, ops, steps, sweeps = search_bound_ms(
        cm, start, out, peak_int32, ct_vals=ct_vals)
    if cm.n_table:
        note = (f"; {ct_vals / max(sweeps, 1):.1f} table-member values per "
                f"lane-sweep")
    L = start[0].lb.shape[0]
    tile = kw.get("lane_tile") or 0
    mode = f"lane tiles of {tile}" if tile else "one queue"
    print(f"[{tag}] search at {L} lanes, {cm.dtype}, {mode}, K={MAIN_K} "
          f"({what}, from the state "
          f"after {int(start[2])}; {steps} live supersteps, {sweeps} "
          f"lane-sweeps): kernel {ms:.4f} ms per launch "
          f"({ms / max(steps, 1):.4f} ms per superstep), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by}: "
          f"{nbytes} B, {ops} ops at {peak_int32 / 1e12:.2f} T/s; "
          f"kernel {ms / bound_ms:.0f}x the bound)"
          f"{pair_note(cm, sweeps, peak_int32)}{note}; library: none "
          f"(no PyTorch call computes a superstep) on {card}")
    return ms, plain_ms, bound_ms, bound_by


def time_resident_solve(card, peak_int32, tag, c, cfg, res, phase=12):
    """Every launch of one `cuda_resident` solve, replayed from the same
    options and a pool decomposed as the solve's (the split depends on
    the strategy pair) and timed one by one (CUDA events); the replay's
    supersteps and nodes must equal the solve's `res`.  Returns (the
    device ms of all launches, the timing state (model, pool, start,
    keywords) of the slowest one)."""
    import torch
    from repro_torch.kernels.fixpoint_kernel import search_cuda
    from repro_torch.testing import search_inputs
    opts = cfg.search_options()
    kw = dict(max_fixpoint_iters=opts.max_fixpoint_iters,
              var_strategy=opts.var_strategy,
              val_strategy=opts.val_strategy,
              stop_on_first=opts.stop_on_first)
    slb, sub, st, gbest, head = search_inputs(c.cm, cfg.n_lanes,
                                              cfg.resolved_eps_target(), opts)
    start = cur = (st, gbest, 0, head)
    n0 = search_cuda.launches
    times, slowest = [], None
    while True:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = search_cuda(c.cm, slb, sub, *cur,
                          supersteps=cfg.resolved_supersteps(), **kw)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
        if times[-1] >= max(times):
            slowest = cur
        cur = out[:4]
        if bool(out[4]) or int(out[2]) >= cfg.max_supersteps:
            break
    search_cuda.launches = n0             # replay launches are not counted
    nodes = int(out[0].n_nodes.long().sum())
    if (int(out[2]), nodes) != (res.n_supersteps, res.n_nodes):
        fail(f"{tag}: the replay reached {int(out[2])} supersteps and "
             f"{nodes} nodes, the solve {res.n_supersteps} and "
             f"{res.n_nodes}")
    bound_ms, bound_by, nbytes, ops, steps, sweeps = search_bound_ms(
        c.cm, start, out, peak_int32, launches=len(times))
    total = sum(times)
    mid = sorted(times)[len(times) // 2]
    print(f"[{phase}] {tag} main-path replay ({cfg.backend}, K="
          f"{cfg.resolved_supersteps()}, {cfg.n_lanes} lanes): "
          f"{len(times)} launches, {steps} supersteps, {sweeps} lane-sweeps, "
          f"nodes {nodes} as the solve; device {total:.2f} ms in all "
          f"against the solve's {(res.wall_s - res.eps_s) * 1e3:.1f} ms of "
          f"search wall; per launch mean {total / len(times):.4f} ms, "
          f"median {mid:.4f}, min {min(times):.4f}, max {max(times):.4f}; "
          f"bound {bound_ms:.5f} ms in all ({bound_by}: {nbytes} B, {ops} "
          f"int32 ops; kernel {total / bound_ms:.0f}x the bound)"
          f"{pair_note(c.cm, sweeps, peak_int32)} on {card}")
    print(f"[{phase}] per-launch ms: "
          + " ".join(f"{t:.3f}" for t in times))
    return total, (c.cm, slb, sub, slowest, kw)


def plain_eps_ms(cm, calls, n=32):
    """`fixpoint_batch` per ``[2, V]`` launch of EPS (CUDA events), over
    the first `n` recorded splits."""
    import torch
    from repro_torch.core import fixpoint as F
    stores = [(torch.from_numpy(c[0]).cuda(), torch.from_numpy(c[1]).cuda())
              for c in calls[1:n + 1]]
    it = iter(stores * 2)
    F.fixpoint_batch(cm, *stores[0])                  # warm up
    return cuda_ms(lambda: F.fixpoint_batch(cm, *next(it)), len(stores), 0)


def phase_times(card, peak_int32, cases, launches, max_err):
    """Phase 4: the many-lane instance at the main path's superstep shape,
    and EPS's launches on the few-lane instance.  Returns the int32
    entry of the {"kernels": [...]} line, the few-lane instance's times
    (ms, plain ms, bound ms, bound_by) and the EPS run."""
    c = cases["J60"]
    ms, plain_ms, bound_ms, bound_by = time_fixpoint(
        card, peak_int32, c.cm, c.lbs, c.ubs, "4", "J60 random stores")
    run = eps_launches_and_clocks(card, peak_int32, c.cm, "4", "J60")
    few_plain = plain_eps_ms(c.cm, run.calls)
    print(f"[4] plain fixpoint_batch per [2, {c.cm.n_vars}] EPS launch: "
          f"{few_plain:.3f} ms")
    print(f"kernels: fixpoint_cuda launches={launches}")
    entry = dict(name="fixpoint_cuda", route="cuda", source=FIXPOINT_SOURCE,
                 replaces=FIXPOINT_REPLACES, launches=launches,
                 max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return entry, (run.ms, few_plain, run.bound_ms, run.bound_by), run


def phase_search_times(card, peak_int32, timing_state, launches, max_err):
    ms, plain_ms, bound_ms, bound_by = time_search(
        card, peak_int32, timing_state, "7", "J60, prove")
    print(f"kernels: search_cuda launches={launches}")
    return dict(name="search_cuda", route="cuda", source=SEARCH_SOURCE,
                replaces=SEARCH_REPLACES, launches=launches,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def phase_alldiff_times(card, peak_int32, cases, states, long):
    """Both kernels at the N-queens-32 shapes, EPS's launches, then the
    long N-queens-32 solve's launches replayed.  Returns the EPS run."""
    c = cases["nqueens32"]
    time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "12",
                  "N-queens 32 stores of phase 8")
    run = eps_launches_and_clocks(card, peak_int32, c.cm, "12",
                                  "N-queens 32", ZOO_STRATEGY["nqueens32"])
    early = states[("nqueens32", "min_dom/split")]
    time_search(card, peak_int32, early, "12",
                "N-queens 32, min_dom/split, early state")
    _, slowest = time_resident_solve(card, peak_int32, "nqueens32", c,
                                     *long["nqueens32"])
    search_clock_breakdown(card, early, "12", "N-queens 32 early state")
    search_clock_breakdown(card, slowest, "12",
                           "N-queens 32 replay's slowest launch")
    return run


# --------------------------------------------------------------------------
# phases 5 and 9: the resident search kernel against its plain version
# --------------------------------------------------------------------------

def search_kwargs(preset, strategy=None):
    from repro_torch.solver import SolveConfig
    pair = (dict(var_strategy=strategy[0], val_strategy=strategy[1])
            if strategy else {})
    opts = SolveConfig.preset(preset, backend="cuda_resident",
                              **pair).search_options()
    return opts, dict(max_fixpoint_iters=opts.max_fixpoint_iters,
                      var_strategy=opts.var_strategy,
                      val_strategy=opts.val_strategy,
                      stop_on_first=opts.stop_on_first)


def right_branch_lanes(st):
    """Lanes whose decision path holds a flipped (right-branch) decision:
    each got there by a backtrack."""
    import torch
    md = st.dec_var.shape[1]
    on = (torch.arange(md, device=st.depth.device)[None, :]
          < st.depth[:, None])
    return int((st.dec_flip & on).any(1).sum())


def max_abs_diff(ref, got):
    """Largest |difference| over every LaneState field and the four
    scalars of two resident-launch results."""
    err = 0
    for a, b in zip(ref[0], got[0]):
        if a is not None and a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    for a, b in zip(ref[1:], got[1:]):
        err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def phase_search_vs_plain(phase, cases, lanes, variants, around_first,
                          ks=SEARCH_K, must_search=False, warm=WARM_STEPS,
                          lane_tile=0):
    """`search_cuda` against `search_plain` on each case (`lanes[tag]`
    lanes, its EPS pool) under each variant, at every K of `ks`,
    from fresh lanes, after `warm` plain supersteps and, with
    `around_first`, 8 supersteps before and after the first solution;
    with `lane_tile`, in lane tiles of that many lanes (the cursors, one
    per tile, compared too).
    With `must_search`, each variant must have failed nodes and lanes
    in a right branch (a backtrack) in the states it compared.
    Returns the starts after `warm` supersteps by (tag, variant name),
    the fresh starts by (tag, variant name, 0), and the max |err|."""
    import torch
    from repro_torch.kernels.fixpoint_kernel import (search_cuda,
                                                     search_grid,
                                                     search_plain)
    from repro_torch.testing import search_diff, search_inputs
    n0 = search_cuda.launches
    max_err = 0
    states = {}
    for tag, c in cases.items():
        cm, L = c.cm, lanes[tag]
        starts, msg = [0, warm], ""
        if around_first:
            # the superstep that finds the first solution, from fresh lanes
            opts, kw = search_kwargs("first_solution")
            inputs = search_inputs(cm, L, None, opts, pool=c.pool)
            out = search_plain(cm, *inputs[:3], inputs[3], 0, inputs[4],
                               supersteps=FIRST_SOL_MAX, **kw)
            if not bool(out[4]):
                fail(f"{tag}: no solution in {FIRST_SOL_MAX} supersteps")
            first = int(out[2])
            starts = sorted({0, warm, max(first - 8, 0), first + 8})
            msg = f"; first solution at superstep {first}"
        print(f"[{phase}] {tag}: {L} lanes, EPS pool {c.pool[0].shape[0]}"
              f"{msg}; starts after {', '.join(map(str, starts))} plain "
              f"supersteps")
        for name, preset, strategy in variants:
            opts, kw = search_kwargs(preset, strategy)
            if lane_tile:
                kw["lane_tile"] = lane_tile
            slb, sub, st, gbest, head = search_inputs(cm, L, None, opts,
                                                      pool=c.pool)
            carried = st.dom is not None
            print(f"[{phase}] {tag} {name}: "
                  f"{search_grid(cm, L, carried, lane_tile)} "
                  f"CTAs (cooperative grid), bitset store "
                  f"{'carried' if carried else 'none'}, {cm.dtype}, "
                  + (f"lane tiles of {lane_tile}" if lane_tile
                     else "one queue"))
            cur, done_steps = (st, gbest, 0, head), 0
            fails = flipped = 0
            for n in starts:
                if n > done_steps:
                    cur = search_plain(cm, slb, sub, *cur,
                                       supersteps=n - done_steps, **kw)[:4]
                    done_steps = n
                if n == warm:
                    states[(tag, name)] = (cm, slb, sub, cur, kw)
                if n == 0:
                    states[(tag, name, 0)] = (cm, slb, sub, cur, kw)
                for k in ks:
                    ref = search_plain(cm, slb, sub, *cur, supersteps=k,
                                       **kw)
                    got = search_cuda(cm, slb, sub, *cur, supersteps=k,
                                      **kw)
                    torch.cuda.synchronize()
                    bad = search_diff(ref, got)
                    if bad:
                        fail(f"{tag} {name} from superstep {int(cur[2])}, "
                             f"K={k}: search_cuda differs from search_plain "
                             f"in {', '.join(bad)}")
                    max_err = max(max_err, max_abs_diff(ref, got))
                st0, stk = cur[0], ref[0]
                right = right_branch_lanes(stk)
                fails = max(fails, int(stk.n_fails.sum()))
                flipped = max(flipped, right)
                print(f"[{phase}] {tag} {name} from superstep {int(cur[2])} "
                      f"({int(st0.has_sol.sum())} lanes with a solution): "
                      f"K={','.join(map(str, ks))} equal on every "
                      f"field; after K={ks[-1]}: it={int(ref[2])} "
                      f"nodes={int(stk.n_nodes.sum())} "
                      f"fails={int(stk.n_fails.sum())} "
                      f"sols={int(stk.n_sols.sum())} gbest={int(ref[1])} "
                      f"head={ref[3].tolist()} stopped={bool(ref[4])} "
                      f"lanes in a right branch={right}")
            if must_search and not (fails and flipped):
                fail(f"{tag} {name}: the compared states hold {fails} "
                     f"failed nodes and {flipped} lanes in a right branch; "
                     f"this comparison needs both")
    search_cuda.launches = n0          # comparison launches are not counted
    return states, max_err


# --------------------------------------------------------------------------
# phases 13-16: the sparse AllDifferent and Cumulative banks
# --------------------------------------------------------------------------

def sparse_cases():
    """The sparse-layout models of phases 13-16 (the auto crossover picks
    the layout), each with its random stores and EPS pool."""
    from repro_torch.core.models import large_instance, nqueens, rcpsp

    def gen(n):
        return load("rcpsp", rcpsp.generate(n, n_resources=4, seed=SEED))
    made = {"J90": gen(90), "J120": gen(120),
            "jobshop20x15": load("jobshop",
                                 large_instance("jobshop", seed=SEED)),
            "nqueens64": load("nqueens", nqueens.generate(64, seed=SEED)),
            "nqueens256": load("nqueens",
                               large_instance("nqueens", seed=SEED))}
    out = {}
    for tag, c in made.items():
        if "sparse" not in (c.cm.ad_layout, c.cm.cu_layout):
            fail(f"{tag}: compiled to the dense layouts")
        out[tag] = prepare(13, tag, c, MAIN_EPS)
    return out


def phase_sparse_vs_dense():
    """A J30-class instance compiled sparse against its dense compile,
    both through `fixpoint_cuda`, on 1024 random stores at every cap:
    equal failed masks, non-failed stores, sweeps and convergence."""
    import numpy as np
    import torch
    from repro_torch.core.models import rcpsp
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    from repro_torch.testing import random_substores
    m, _ = rcpsp.build_model(rcpsp.generate(30, n_resources=4, seed=SEED))
    dense, sparse = (m.compile(device="cuda", bank_layout=lay)
                     for lay in ("dense", "sparse"))
    print(f"[13] J30 dense: {describe(dense)}; sparse: {describe(sparse)}")
    lbs, ubs = random_substores(np.random.default_rng(SEED), dense,
                                N_RANDOM)
    lb, ub = torch.from_numpy(lbs).cuda(), torch.from_numpy(ubs).cuda()
    n0 = fixpoint_cuda.launches
    for cap in CAPS:
        dl, du, dsw, dconv = fixpoint_cuda(dense, lb, ub, max_sweeps=cap)
        sl, su, ssw, sconv = fixpoint_cuda(sparse, lb, ub, max_sweeps=cap)
        torch.cuda.synchronize()
        failed = (dl > du).any(1)
        ok = ~failed
        if not (torch.equal(failed, (sl > su).any(1))
                and torch.equal(dl[ok], sl[ok])
                and torch.equal(du[ok], su[ok])
                and torch.equal(dsw, ssw) and torch.equal(dconv, sconv)):
            fail(f"J30 max_sweeps={cap}: the sparse compile differs from "
                 "the dense one on the card")
        print(f"[13] J30 sparse == dense on the card, max_sweeps={cap}: "
              f"{int(ok.sum())} non-failed stores equal, "
              f"{int(failed.sum())} failed in both, sweeps and flags equal")
    fixpoint_cuda.launches = n0        # comparison launches are not counted


def phase_sparse_search(cases):
    """Phase 14: `search_cuda` against `search_plain` on J120 (prove; also
    around its first solution, where lanes fail and backtrack), N-queens
    64 at K = 1, 4, 16 and N-queens 256 at K = 4 (min_dom/split).
    Returns the starts after WARM_STEPS and the max |err|."""
    split = (("min_dom/split", "prove", ("min_dom", "split")),)
    states, err = {}, 0
    for tag, variants, around_first, ks in (
            ("J120", (("prove", "prove", None),), True, SEARCH_K),
            ("nqueens64", split, False, SEARCH_K),
            ("nqueens256", split, False, (4,))):
        st, e = phase_search_vs_plain(14, {tag: cases[tag]},
                                      {tag: MAIN_LANES}, variants,
                                      around_first, ks=ks)
        states.update(st)
        err = max(err, e)
    return states, err


def phase_sparse_main_path(cases):
    """Phase 15: J120, J90 and rcpsp-96 proved on both backends, N-queens
    256 on both under NQ256_CAP, then long on `cuda_resident`.  Returns
    the launches by (tag, run)."""
    from repro_torch.core.models import large_instance
    launches = {}
    rc96 = load("rcpsp", large_instance("rcpsp", seed=SEED))
    print(f"[15] rcpsp96: {describe(rc96.cm)}")
    for tag, c in (("J120", cases["J120"]), ("J90", cases["J90"]),
                   ("rcpsp96", rc96)):
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                15, tag, c, main_config(backend), SPARSE_OPTIMUM[tag])
        same_counters(15, tag, got)
    c = cases["nqueens256"]
    got = {}
    for backend in ("cuda", "cuda_resident"):
        got[backend], launches[("nqueens256", backend)] = solve_case(
            15, "nqueens256", c, main_config(backend, NQ256_STRATEGY,
                                             max_supersteps=NQ256_CAP))
    same_counters(15, "nqueens256", got)
    _, launches[("nqueens256", "long")] = solve_case(
        15, "nqueens256", c, main_config(
            "cuda_resident", NQ256_STRATEGY, max_supersteps=ZOO_LONG_CAP,
            timeout_s=NQ256_LONG_TIMEOUT_S))
    return launches


def phase_sparse_times(card, peak_int32, cases, states):
    """Phase 16: both kernels at the J120 and N-queens-256 shapes, and
    EPS's launches on J120.  Returns the EPS run."""
    for tag, what in (("J120", "J120 random stores of phase 13"),
                      ("nqueens256", "N-queens 256 stores of phase 13")):
        c = cases[tag]
        time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "16", what,
                      plain_reps=1)
        if tag == "J120":
            run = eps_launches_and_clocks(card, peak_int32, c.cm, "16",
                                          "J120")
    time_search(card, peak_int32, states[("J120", "prove")], "16",
                "J120, prove", plain_reps=1, plain_warmup=0)
    search_clock_breakdown(card, states[("J120", "prove")], "16",
                           "J120 early state")
    time_search(card, peak_int32, states[("nqueens256", "min_dom/split")],
                "16", "N-queens 256, min_dom/split", plain_reps=1,
                plain_warmup=0)
    return run


# --------------------------------------------------------------------------
# phases 17-20: the Compact-Table bank, the bitset store and middle_out
# --------------------------------------------------------------------------

def table_cases():
    """The table models of phases 17-20: crossword and configuration at
    the small, bench and large tiers and the wide-table model (tables of
    more than 32 tuples), each with its random stores and bitset stores
    and its EPS pool."""
    from repro_torch.core.model import Model
    from repro_torch.core.models import (bench_instance, large_instance,
                                         small_instance)
    from repro_torch.testing import wide_table_model
    out = {}
    for name in ("crossword", "configuration"):
        for tier, make in (("small", small_instance),
                           ("bench", bench_instance),
                           ("large", large_instance)):
            out[f"{name}_{tier}"] = prepare(
                17, f"{name} {tier}", load(name, make(name, seed=SEED)),
                MAIN_EPS)
    wide = wide_table_model(Model, seed=SEED).compile(device="cuda")
    if wide.ct_words != 2:
        fail(f"the wide-table model has ct_words {wide.ct_words}, not 2")
    out["wide_table"] = prepare(17, "wide table", Case(
        None, None, None, wide, None, None, None), MAIN_EPS)
    return out


def phase_table_vs_plain(cases):
    """`fixpoint_cuda` against `fixpoint_batch` on each table model's
    random stores and EPS pool, with the bitset store carried (random
    words; the pool's range words) and transient, at every cap of CAPS.
    Returns the max |err|."""
    import numpy as np
    import torch
    from repro_torch.core.bitset import np_from_bounds
    max_err = 0
    for tag, c in cases.items():
        cm = c.cm
        off = cm.dom_off.cpu().numpy()
        track = cm.dom_track.cpu().numpy()
        batches = [("random", c.lbs, c.ubs, c.doms)]
        plb, pub = c.pool
        for i in range(0, plb.shape[0], N_RANDOM):
            bl, bu = plb[i:i + N_RANDOM], pub[i:i + N_RANDOM]
            batches.append((f"pool[{i}:{i + N_RANDOM}]", bl, bu,
                            np_from_bounds(bl, bu, off, cm.n_words,
                                           track=track)))
        for cap in CAPS:
            for mode in ("carried", "transient"):
                lanes = whole = wiped = 0
                sweeps = []
                for name, bl, bu, bd in batches:
                    lb = torch.from_numpy(bl).cuda()
                    ub = torch.from_numpy(bu).cuda()
                    dom = (torch.from_numpy(bd.view(np.int32)).cuda()
                           if mode == "carried" else None)
                    err, same, sw, failed = compare(
                        cm, lb, ub, cap,
                        f"{tag} {name} {mode} max_sweeps={cap}", dom)
                    if name == "random":
                        wiped = int(failed[:N_WIPE].sum())
                    max_err = max(max_err, err)
                    lanes += lb.shape[0]
                    whole += int(same)
                    sweeps.append(sw)
                sw = torch.cat(sweeps)
                print(f"[17] {tag} {mode} max_sweeps={cap}: {lanes} lanes "
                      f"equal (failed masks, stores, words, sweeps, "
                      f"converged); {whole}/{len(batches)} batches equal in "
                      f"every output; sweeps mean "
                      f"{sw.float().mean().item():.2f} max {int(sw.max())};"
                      f" {wiped}/{N_WIPE} interior-wipe stores failed")
    return max_err


def phase_table_search(tcases, zoo):
    """Phase 18: `search_cuda` against `search_plain` with the bitset
    store on crossword and configuration large (prove, and
    min_lb/middle_out), from their EPS pool (the main path's 2
    subproblems) and from a pool of their N_RANDOM random stores, where
    every lane searches, fails and backtracks (the shared bound ends the
    search within 4 supersteps, so the second start is after
    RANDOM_WARM); and on N-queens 32 and coloring 64
    (min_dom/middle_out).  Returns the starts and the max |err|."""
    big = {t: tcases[t] for t in ("crossword_large", "configuration_large")}
    states, err = phase_search_vs_plain(
        18, big, dict.fromkeys(big, MAIN_LANES), TABLE_VARIANTS, False)
    rand = {f"{t} random pool": c._replace(pool=(c.lbs, c.ubs))
            for t, c in big.items()}
    more, err2 = phase_search_vs_plain(
        18, rand, dict.fromkeys(rand, MAIN_LANES), TABLE_VARIANTS, False,
        must_search=True, warm=RANDOM_WARM)
    states.update(more)
    mo = {t: zoo[t] for t in ("nqueens32", "coloring64")}
    more, err3 = phase_search_vs_plain(
        18, mo, dict.fromkeys(mo, MAIN_LANES),
        (("min_dom/middle_out", "prove", MIDDLE_OUT),), False)
    states.update(more)
    return states, max(err, err2, err3)


def phase_table_main_path(tcases, zoo, rcpsp):
    """Phase 19: crossword and configuration large proved through both
    backends; N-queens 32 under min_dom/middle_out through both under
    ZOO_CAP; J30 under middle_out through both equal to its split
    solve.  Returns the launches by (tag, run)."""
    from repro_torch.solver import SolveConfig
    launches = {}
    for name in ("crossword", "configuration"):
        tag = f"{name}_large"
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                19, tag, tcases[tag], main_config(backend),
                TABLE_OPTIMUM[name])
        same_counters(19, tag, got)
    got = {}
    for backend in ("cuda", "cuda_resident"):
        got[backend], launches[("nqueens32 middle_out", backend)] = \
            solve_case(19, "nqueens32", zoo["nqueens32"],
                       main_config(backend, MIDDLE_OUT,
                                   max_supersteps=ZOO_CAP))
    same_counters(19, "nqueens32 min_dom/middle_out", got)
    got = {}
    for backend, val in (("cuda", "split"), ("cuda", "middle_out"),
                         ("cuda_resident", "middle_out")):
        got[f"{backend} {val}"], launches[(f"J30 {val}", backend)] = \
            solve_case(19, "J30", rcpsp["J30"], SolveConfig.preset(
                "prove", backend=backend, n_lanes=J30_LANES,
                val_strategy=val))
    same_counters(19, "J30 middle_out against split", got)
    return launches


def phase_table_times(card, peak_int32, tcases, states):
    """Phase 20: both kernels at the large table models' shapes (the
    fixpoint with and without a carried store; the search from fresh
    lanes on the EPS pool, which solves within one launch, and on the
    random pool, where every lane searches) and on N-queens 32 under
    min_dom/middle_out (after WARM_STEPS)."""
    for name in ("configuration", "crossword"):
        tag = f"{name}_large"
        c = tcases[tag]
        time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "20",
                      f"{name} large random stores, bitset store carried",
                      doms=c.doms)
        time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "20",
                      f"{name} large random stores, transient")
        for variant, _, _ in TABLE_VARIANTS:
            time_search(card, peak_int32, states[(tag, variant, 0)], "20",
                        f"{name} large, {variant}, EPS pool, fresh lanes")
            time_search(card, peak_int32,
                        states[(f"{tag} random pool", variant, 0)], "20",
                        f"{name} large, {variant}, random pool, fresh lanes")
    time_search(card, peak_int32, states[("nqueens32", "min_dom/middle_out")],
                "20", "N-queens 32, min_dom/middle_out")


# --------------------------------------------------------------------------
# phases 21-25: int64 models in both kernels, and lane tiles
# --------------------------------------------------------------------------

def int64_cases():
    """The int64 models of phases 21-25: the J120 class with every
    duration × INT64_SCALE (sparse Cumulative by the crossover), the J60
    class compiled with force_dtype="int64" in the dense layout (the
    values of the int32 J60, so its search must be the same), and a
    two-term row whose products pass 2³¹; each with its random stores
    and, the first two, their EPS pools."""
    import dataclasses
    from repro_torch.core.model import Model
    from repro_torch.core.models import rcpsp
    inst = rcpsp.generate(120, n_resources=4, seed=SEED)
    wide = Model("wide")
    x, y = wide.int_var(0, 10 ** 8), wide.int_var(0, 10 ** 8)
    wide.add(1000 * x + 1000 * y <= 10 ** 9)
    made = {
        "J120x1e7": (load("rcpsp", dataclasses.replace(
            inst, durations=inst.durations * INT64_SCALE)), MAIN_EPS),
        "J60int64": (load("rcpsp", rcpsp.generate(60, n_resources=4,
                                                  seed=SEED),
                          force_dtype="int64", bank_layout="dense"),
                     MAIN_EPS),
        "wide": (Case(None, None, None, wide.compile(device="cuda"), None,
                      None, None), None)}
    out = {}
    for tag, (c, target) in made.items():
        if c.cm.dtype != "int64":
            fail(f"{tag}: compiled to {c.cm.dtype}, not int64")
        out[tag] = prepare(21, tag, c, target)
    return out


def phase_int64_search(cases):
    """Phase 22: `search_cuda` against `search_plain` at int64 on J120 ×
    10⁷ and J60 int64 (1024 lanes, prove, K = 1, 4, 16), from fresh lanes
    and after 5 supersteps, and on J120 × 10⁷ also 8 before and after the
    first solution (failed nodes and backtracks required).  Returns the
    starts and the max |err|."""
    prove = (("prove", "prove", None),)
    states, err = phase_search_vs_plain(
        22, {"J120x1e7": cases["J120x1e7"]}, {"J120x1e7": MAIN_LANES}, prove,
        True, must_search=True)
    st, e = phase_search_vs_plain(22, {"J60int64": cases["J60int64"]},
                                  {"J60int64": MAIN_LANES}, prove, False)
    states.update(st)
    return states, max(err, e)


def phase_int64_main_path(cases, j60):
    """Phase 23: J120 × 10⁷ and J60 int64 through `cuda` and
    `cuda_resident`: equal counters on both, J120 × 10⁷ at the scaled
    optimum, J60 int64 with every counter of the int32 J60 (`j60`, phase
    3).  Returns the launches by (tag, backend)."""
    launches = {}
    want = {"J120x1e7": SPARSE_OPTIMUM["J120"] * INT64_SCALE,
            "J60int64": J60_OPTIMUM}
    for tag in ("J120x1e7", "J60int64"):
        got = {}
        for backend in ("cuda", "cuda_resident"):
            got[backend], launches[(tag, backend)] = solve_case(
                23, tag, cases[tag], main_config(backend), want[tag])
        same_counters(23, tag, got, {k: getattr(j60, k) for k in COUNTERS}
                      if tag == "J60int64" else None)
    return launches


def phase_lane_tiles(rcpsp, zoo, int64, j60_resident):
    """Phase 24: `search_cuda` against `search_plain` in lane tiles of
    TILES on J60 (prove; in tiles of MAIN_TILE also 8 supersteps before
    and after the first solution, failed nodes and backtracks required)
    and N-queens 32
    (min_dom/split), 1024 lanes, K = 1 and 16, from fresh lanes and after
    5 supersteps, and in tiles of MAIN_TILE on J60 int64; then the J60 `cuda_resident` solve in tiles of
    MAIN_TILE, which must prove 82 with a launch per K supersteps.
    Returns the starts by (tag, variant, tile), the max |err| and the
    tiled solve's search_cuda launches."""
    states, err = {}, 0
    split = (("min_dom/split", "prove", ("min_dom", "split")),)
    prove = (("prove", "prove", None),)
    runs = [(t, "J60", rcpsp["J60"], prove, t == MAIN_TILE) for t in TILES]
    runs += [(t, "nqueens32", zoo["nqueens32"], split, False) for t in TILES]
    runs += [(MAIN_TILE, "J60int64", int64["J60int64"], prove, False)]
    for tile, tag, c, variants, around_first in runs:
        st, e = phase_search_vs_plain(24, {tag: c}, {tag: MAIN_LANES},
                                      variants, around_first,
                                      ks=(1, MAIN_K),
                                      must_search=around_first,
                                      lane_tile=tile)
        states.update({k + (tile,): v for k, v in st.items()})
        err = max(err, e)
    res, (_, launches, _) = solve_case(
        24, "J60", rcpsp["J60"], main_config("cuda_resident",
                                             lane_tile=MAIN_TILE),
        J60_OPTIMUM)
    print(f"[24] J60 cuda_resident, lane tiles of {MAIN_TILE}: "
          f"nodes={res.n_nodes} supersteps={res.n_supersteps} "
          f"launches={launches}; one queue (phase 6): "
          f"nodes={j60_resident.n_nodes} "
          f"supersteps={j60_resident.n_supersteps}")
    # a small solve whose trajectory the tiles change: the card's tiled
    # solve equals the plain one on the CPU and differs from one queue
    from repro_torch.solver import SolveConfig, Solver
    cfg = SolveConfig.preset("prove", backend="cuda_resident",
                             n_lanes=J30_TILED[0], eps_target=J30_TILED[1],
                             lane_tile=J30_TILED[2])
    c = rcpsp["J30"]
    card = solve_case(24, "J30", c, cfg, J30_REFERENCE["objective"])[0]
    cpu = Solver(cfg.replace(device="cpu")).solve(c.cm.to("cpu"))
    queue = solve_case(24, "J30", c, cfg.replace(lane_tile=None))[0]
    same_counters(24, f"J30 in lane tiles of {J30_TILED[2]}",
                  {"card": card, "plain on the CPU": cpu})
    if all(getattr(card, k) == getattr(queue, k) for k in COUNTERS):
        fail("J30: the lane-tiled solve's counters equal one queue's")
    print(f"[24] J30 one queue: nodes={queue.n_nodes} "
          f"supersteps={queue.n_supersteps}; tiles: nodes={card.n_nodes} "
          f"supersteps={card.n_supersteps}")
    return states, err, launches


def phase_int64_times(card, peak_int32, sparse, sp_states, int64,
                      i64_states, states, tile_states):
    """Phase 25: both kernels at int64 against int32 at the J120 shape
    ([1024, 122]: random stores of phases 13 and 21; K=16 after 5
    supersteps), EPS's launches on J120 × 10⁷ (the few-lane instance at
    int64) and `search_cuda` at J60 in lane tiles of MAIN_TILE against one
    queue.  Returns the times of the int64 and lane-tile modes: (fixpoint
    int64, search int64, search tiles), each (ms, plain ms, bound ms,
    bound_by), and the EPS run."""
    c = sparse["J120"]
    time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "25",
                  "J120 random stores", plain_reps=1)
    c = int64["J120x1e7"]
    fix64 = time_fixpoint(card, peak_int32, c.cm, c.lbs, c.ubs, "25",
                          "J120 x 1e7 random stores", plain_reps=1)
    run = eps_launches_and_clocks(card, peak_int32, c.cm, "25", "J120 x 1e7")
    time_search(card, peak_int32, sp_states[("J120", "prove")], "25",
                "J120, prove", plain_reps=1, plain_warmup=0)
    srch64 = time_search(card, peak_int32, i64_states[("J120x1e7", "prove")],
                         "25", "J120 x 1e7, prove", plain_reps=1,
                         plain_warmup=0)
    time_search(card, peak_int32, states[("J60", "prove")], "25",
                "J60, prove")
    tiles = time_search(card, peak_int32,
                        tile_states[("J60", "prove", MAIN_TILE)], "25",
                        "J60, prove")
    return fix64, srch64, tiles, run


# --------------------------------------------------------------------------
# phase 29: the few-lane instance of the fixpoint kernel
# --------------------------------------------------------------------------

def few_lane_models(rcpsp, zoo, sparse, tables, int64):
    """(tag, model, random stores, random bitset stores or None) of phase
    29: every bank at both widths.  int32: J60 (dense Cumulative), J120
    (sparse Cumulative), N-queens 32 and 256 (dense and sparse
    AllDifferent), crossword and configuration large (Compact-Table, also
    with a carried store); int64: J120 × 10⁷, J60 int64, the wide row,
    N-queens 8 and 36 forced to int64 (dense and sparse AllDifferent) and
    the two-word table hand case forced to int64 (also carried)."""
    import numpy as np
    from repro_torch.core.model import Model
    from repro_torch.core.models import nqueens
    from repro_torch.testing import (CT_HAND_MODELS, random_dom_stores,
                                     random_substores)
    for tag, c in (("J60", rcpsp["J60"]), ("J120", sparse["J120"]),
                   ("nqueens32", zoo["nqueens32"]),
                   ("nqueens256", sparse["nqueens256"]),
                   ("crossword_large", tables["crossword_large"]),
                   ("configuration_large", tables["configuration_large"]),
                   ("J120x1e7", int64["J120x1e7"]),
                   ("J60int64", int64["J60int64"]), ("wide", int64["wide"])):
        yield tag, c.cm, c.lbs, c.ubs, c.doms
    made = {"nqueens8int64": nqueens.build_model(nqueens.generate(8))[0],
            "nqueens36int64": nqueens.build_model(nqueens.generate(36))[0],
            "wide_table_int64": CT_HAND_MODELS["wide"](Model)}
    for tag, m in made.items():
        cm = m.compile(device="cuda", force_dtype="int64")
        rng = np.random.default_rng(SEED)
        lbs, ubs = random_substores(rng, cm, N_RANDOM)
        doms = (random_dom_stores(rng, cm, lbs, ubs, n_wipe=N_WIPE)
                if cm.n_table else None)
        yield tag, cm, lbs, ubs, doms


def phase_few_lane_vs_plain(models):
    """Phase 29, first part: `fixpoint_cuda` over 1 (the root box), 2 and
    132 lanes (the few-lane instance; 132 = the card's SMs) and 133 (the
    many-lane one) against `fixpoint_batch`, at max_sweeps 1 and
    uncapped, each model of `few_lane_models` with the transient store
    and, where it has random bitset stores, the carried one: every field
    equal.  Returns the max |err| (0, or the run failed)."""
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import (FEW_THREADS,
                                                     fixpoint_cuda,
                                                     instance_threads)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n0 = fixpoint_cuda.launches, fixpoint_cuda.few_lane_launches
    for tag, cm, lbs, ubs, doms in models:
        checked = []
        for lanes in (1, 2, sms, sms + 1):
            if lanes == 1:
                lb, ub = cm.lb0[None].clone(), cm.ub0[None].clone()
            else:
                lb = torch.from_numpy(lbs[:lanes]).cuda()
                ub = torch.from_numpy(ubs[:lanes]).cuda()
            for dom in (None,) + (() if doms is None else (
                    torch.from_numpy(doms[:lanes].view("int32")).cuda(),)):
                for cap in (1, None):
                    ref = F.fixpoint_batch(cm, lb, ub, dom, max_iters=cap)
                    got = fixpoint_cuda(cm, lb, ub, dom, max_sweeps=cap)
                    torch.cuda.synchronize()
                    if not all(torch.equal(r, g) for r, g in zip(ref, got)):
                        store = "transient" if dom is None else "carried"
                        fail(f"{tag}: fixpoint_cuda over {lanes} lanes "
                             f"({store}, max_sweeps={cap}) differs from "
                             "fixpoint_batch")
            few = instance_threads(lanes, sms) == FEW_THREADS
            checked.append(f"{lanes} ({'few-lane' if few else '256'})")
        stores = "transient" + ("" if doms is None else " and carried")
        print(f"[29] {tag} {cm.dtype}: fixpoint_cuda == fixpoint_batch on "
              f"every field over {', '.join(checked)} lanes, max_sweeps 1 "
              f"and uncapped, {stores} store")
    fixpoint_cuda.launches, fixpoint_cuda.few_lane_launches = n0
    return 0


def phase_eps_pools(runs, more):
    """Phase 29, second part: EPS on the few-lane instance against the
    plain version.  `runs` holds the EPS runs of phases 4, 12, 16 and 25
    (tag -> (model, strategy pair or None, EpsRun)); `more` the (model,
    strategy) of the models this phase decomposes itself.  For each:
    every recorded launch's results against `fixpoint_batch` on the same
    stores (batched: lanes are independent), then `eps.decompose`
    replayed with the plain results in place of the kernel's, whose pool
    (the pool through `fixpoint_batch`) must equal the recorded run's bit
    for bit.  Returns the max |err| (0, or the run failed)."""
    import numpy as np
    import torch
    from repro_torch.core import fixpoint as F
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda
    recorded = {tag: (cm, strategy, run.calls, run.pool)
                for tag, (cm, strategy, run) in runs.items()}
    n0 = fixpoint_cuda.launches, fixpoint_cuda.few_lane_launches
    for tag, (cm, strategy) in more.items():
        recorded[tag] = (cm, strategy) + decompose_recorded(cm, strategy)
    fixpoint_cuda.launches, fixpoint_cuda.few_lane_launches = n0
    for tag, (cm, strategy, calls, pool) in recorded.items():
        t0 = time.time()
        lb = np.concatenate([c[0] for c in calls])
        ub = np.concatenate([c[1] for c in calls])
        plain = []
        for i in range(0, lb.shape[0], N_RANDOM):
            out = F.fixpoint_batch(cm, torch.from_numpy(lb[i:i + N_RANDOM])
                                   .cuda(), torch.from_numpy(
                                       ub[i:i + N_RANDOM]).cuda())
            plain.append((out[0].cpu().numpy(), out[1].cpu().numpy()))
        plain_lb = np.concatenate([p[0] for p in plain])
        plain_ub = np.concatenate([p[1] for p in plain])
        if not (np.array_equal(plain_lb, np.concatenate(
                [c[2] for c in calls])) and np.array_equal(
                plain_ub, np.concatenate([c[3] for c in calls]))):
            fail(f"{tag}: an EPS launch of fixpoint_cuda differs from "
                 "fixpoint_batch on its stores")
        at = np.cumsum([0] + [c[0].shape[0] for c in calls])
        replies = [c[:2] + (plain_lb[at[i]:at[i + 1]],
                            plain_ub[at[i]:at[i + 1]])
                   for i, c in enumerate(calls)]
        replayed, plain_pool = decompose_recorded(cm, strategy, replies)
        if len(replayed) != len(calls) or not all(
                np.array_equal(a, b) for a, b in zip(plain_pool, pool)):
            fail(f"{tag}: the EPS pool through fixpoint_batch differs from "
                 "the pool through fixpoint_cuda")
        print(f"[29] {tag} {cm.dtype}: {len(calls)} EPS launches "
              f"({lb.shape[0]} stores) equal to fixpoint_batch; the pool "
              f"through fixpoint_batch == the pool through fixpoint_cuda "
              f"({pool[0].shape[0]} subproblems, bit for bit) "
              f"[{time.time() - t0:.1f} s]")
    return 0


# --------------------------------------------------------------------------
# phases 26-28: the LM serving path and the flash-attention kernel
# --------------------------------------------------------------------------

def bf16_qkv(B, S, H, KV, hd):
    """bf16 q, k, v on the card, drawn with numpy from SEED."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    return tuple(torch.from_numpy(rng.standard_normal(
        (B, S, h, hd), dtype=np.float32)).to("cuda", torch.bfloat16)
        for h in (H, KV, KV))


def phase_flash_vs_plain():
    """Returns (max |kernel - plain| over every case, the prefill case's
    q, k, v)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.nn.layers import set_matmul_precision
    set_matmul_precision()
    max_err, prefill = 0.0, None
    for tag, B, S, H, KV, hd, causal in FLASH_CASES:
        q, k, v = bf16_qkv(B, S, H, KV, hd)
        if prefill is None:
            prefill = (q, k, v)
        for bq, bk in FLASH_BLOCKS:
            got = flash_attention(q, k, v, causal=causal, bq=bq, bk=bk)
            ref = flash_attention_plain(q, k, v, causal=causal, bq=bq,
                                        bk=bk)
            torch.cuda.synchronize()
            diff = (got.float() - ref.float()).abs()
            err = diff.max().item()
            excess = (diff - FLASH_ATOL - FLASH_RTOL * ref.float().abs()
                      ).max().item()
            print(f"[26] {tag} [{B}, {S}, {H}, {hd}] KV {KV} blocks "
                  f"({bq}, {bk}): max |err| {err:.3e} (tolerance rtol "
                  f"2^-7, atol 1e-3: {'ok' if excess <= 0 else 'FAILED'})")
            if excess > 0 or not torch.isfinite(got).all():
                fail(f"flash_attention {tag} blocks ({bq}, {bk}) differs "
                     f"from its plain version (max |err| {err:.3e})")
            max_err = max(max_err, err)
    return max_err, prefill


def phase_lm_main_path(card):
    """qwen3-4b served through `generate`, then decode against teacher
    forcing.  Returns the warm run's flash_attention launches."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels.fixpoint_kernel import (fixpoint_cuda,
                                                     search_cuda)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train.serve_step import generate
    cfg = configs.get(LM_ARCH)
    t = time.perf_counter()
    params = init_params(MD.param_specs(cfg), torch.Generator(
        device="cuda").manual_seed(LM_WEIGHT_SEED), "cuda")
    torch.cuda.synchronize()
    nbytes = sum(p.numel() * p.element_size() for p in params.values())
    print(f"[27] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads, "
          f"{cfg.n_params():,} params, {nbytes / 1e9:.3f} GB on the card, "
          f"drawn in {time.perf_counter() - t:.2f} s")
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT))).cuda()
    batch = {"tokens": tokens}
    smax = LM_PROMPT + LM_GEN + 8
    runs = []
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        flash_attention.launches = 0
        fixpoint_cuda.launches = search_cuda.launches = 0
        t0 = time.perf_counter()
        out = generate(params, cfg, batch, steps=LM_GEN, smax=smax,
                       stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        if fixpoint_cuda.launches or search_cuda.launches:
            fail(f"{run} generate launched a solver kernel")
        if launches != cfg.n_layers:
            fail(f"{run} generate: flash_attention launched {launches} "
                 f"times, not once per layer ({cfg.n_layers})")
        if out.shape != (LM_BATCH, LM_GEN) or not (
                (out >= 0) & (out < cfg.vocab)).all():
            fail(f"{run} generate: tokens {tuple(out.shape)} outside the "
                 f"vocabulary")
        runs.append(out)
        print(f"[27] {run}: {LM_BATCH} requests x {LM_PROMPT} prompt tokens"
              f", {LM_GEN} generated: wall {wall:.3f} s, prefill "
              f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
              f"{stats['decode_s'] / (LM_GEN - 1) * 1e3:.3f} ms/token, "
              f"{LM_BATCH * LM_GEN / wall:.1f} tokens/s, flash_attention "
              f"launches {launches}, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({card})")
    print(f"[27] cold and warm tokens equal: {torch.equal(*runs)}; "
          f"request 0: {runs[1][0].tolist()}")

    full, _ = MD.forward_prefill(params, cfg, batch, smax)
    _, caches = MD.forward_prefill(params, cfg,
                                   {"tokens": tokens[:, :-1]}, smax)
    dec, _ = MD.forward_decode(params, cfg, tokens[:, -1:], caches)
    torch.cuda.synchronize()
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        fail("non-finite logits")
    err = (dec - full).abs().max().item()
    scale = max(full.abs().max().item(), 1.0)
    print(f"[27] decode of token {LM_PROMPT - 1} against teacher forcing: "
          f"max |err| {err:.4f}, max |logit| {scale:.4f} "
          f"({err / scale:.4f} of it; bound {DECODE_TOL})")
    if err >= DECODE_TOL * scale:
        fail(f"decode differs from teacher forcing: {err:.4f} >= "
             f"{DECODE_TOL} x {scale:.4f}")
    del params, caches
    torch.cuda.empty_cache()
    return launches


def phase_flash_times(card, qkv, launches, max_err):
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = qkv
    B, S, H, hd = q.shape
    ms = cuda_ms(lambda: flash_attention(q, k, v), 10, 2)
    plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v), 3, 1)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

    def sdpa():
        return Fn.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                               enable_gqa=True)
    library_ms = cuda_ms(sdpa, 10, 2)
    lib_err = (sdpa().transpose(1, 2).float()
               - flash_attention(q, k, v).float()).abs().max().item()
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    pairs = B * H * S * (S + 1) // 2                # causal (query, key)
    flops = 4 * hd * pairs                          # QK and PV
    split_flops = 6 * hd * pairs                    # PV twice: p_hi, p_lo
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_BF16_FLOP_S * 1e3
    bound_ms, bound_by = max((bytes_ms, "bytes"), (ops_ms, "operations"))
    print(f"[28] flash_attention [{B}, {S}, {H}, {hd}] KV {k.shape[2]} "
          f"causal ({card}): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"scaled_dot_product_attention {library_ms:.4f} ms (max |diff| "
          f"to the kernel {lib_err:.3e}); bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.1f} GFLOP at 989 TFLOP/s bf16; "
          f"{nbytes / 1e6:.1f} MB at 3.35 TB/s = {bytes_ms:.4f} ms); "
          f"achieved {flops / ms / 1e9:.1f} TFLOP/s of the function, "
          f"roofline share {bound_ms / ms:.1%} (the bound over the kernel's "
          f"time; kernel {ms / bound_ms:.2f}x the bound, "
          f"{ms / library_ms:.2f}x the library); with p split into bf16 "
          f"hi and lo the kernel does {split_flops / 1e9:.1f} GFLOP "
          f"({split_flops / PEAK_BF16_FLOP_S * 1e3:.4f} ms at the peak, "
          f"{split_flops / ms / 1e9:.1f} TFLOP/s achieved)")
    print(f"kernels: flash_attention launches={launches} (per request "
          f"batch: one per layer of the prefill, none per decode step)")
    return dict(name="flash_attention", route="cuda", source=FLASH_SOURCE,
                replaces=FLASH_REPLACES, launches=launches,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# --------------------------------------------------------------------------
# phases 30-32: the slot axis, solve_many and the solver service
# --------------------------------------------------------------------------

def slot_batches(rcpsp, tables, int64):
    """Phase 30's batches, each (tag, cases, lane tile): the four J60
    instances (seed 0's case of phase 2, the permuted ones decomposed
    now) in one queue and in lane tiles of SLOT_TILE, crossword large at
    seeds 0-3, and J60 int64 with its durations permuted by seed 1 beside
    it.  Every batch is of one shape signature."""
    from repro_torch.core.api import shape_signature
    from repro_torch.core.models import large_instance
    from repro_torch.testing import permuted_durations
    base = rcpsp["J60"]
    j60 = [base] + [prepare(30, f"J60 durations permuted by seed {s}", load(
        "rcpsp", permuted_durations(base.inst, s)), MAIN_EPS)
        for s in SLOT_SEEDS]
    cw = [tables["crossword_large"]] + [prepare(30, f"crossword large seed "
                                                f"{s}", load("crossword",
                                                large_instance("crossword",
                                                               seed=s)),
                                                MAIN_EPS)
                                        for s in SLOT_SEEDS]
    i64 = [int64["J60int64"], prepare(30, "J60int64 permuted by seed 1", load(
        "rcpsp", permuted_durations(base.inst, 1), force_dtype="int64",
        bank_layout="dense"), MAIN_EPS)]
    out = [("J60", j60, 0), ("J60", j60, SLOT_TILE),
           ("crossword large", cw, 0), ("J60 int64", i64, 0)]
    for tag, cases, _ in out:
        sigs = {shape_signature(c.cm) for c in cases}
        if len(sigs) != 1:
            fail(f"{tag}: the slots' shape signatures differ: {sigs}")
    return out


def freeze_slots(cms, args, n, idle, stopped):
    """`args` (pools, state, bounds, counts, cursors of a launch over
    slots) with slot `idle` frozen as `LaneBatch` freezes an idle slot
    (every lane done, none fresh, an all-failed pool) and slot `stopped`
    with every lane done."""
    import torch
    from repro_torch.core import eps
    from repro_torch.core import search as S
    slb, sub, st = args[0].clone(), args[1].clone(), args[2]
    st = S.LaneState(*(None if a is None else a.clone() for a in st))
    for i in (idle, stopped):
        st.done[i * n:(i + 1) * n] = True
    st.fresh[idle * n:(idle + 1) * n] = False
    lb, ub = eps.failed_pool(cms[idle].lb0.cpu().numpy(),
                             cms[idle].ub0.cpu().numpy(), slb.shape[1])
    slb[idle] = torch.from_numpy(lb).to(slb.device)
    sub[idle] = torch.from_numpy(ub).to(sub.device)
    return (slb, sub, st) + tuple(args[3:])


def phase_slots_vs_plain(card, peak_int32, batches):
    """Phase 30.  Returns the max |err| and the timing entry's times."""
    import torch
    from repro_torch.kernels.fixpoint_kernel import (search_cuda,
                                                     search_slots_cuda,
                                                     search_slots_plain)
    from repro_torch.testing import search_diff, slot_inputs, slot_part
    n0 = (search_cuda.launches, search_cuda.slot_launches)
    n, max_err, timing = MAIN_LANES, 0, None
    for tag, cases, tile in batches:
        cms = [c.cm for c in cases]
        B = len(cms)
        opts, kw = search_kwargs("prove")
        kw["lane_tile"] = tile
        fresh = slot_inputs(cms, n, opts, [c.pool for c in cases])
        warm = search_slots_plain(cms, *fresh, supersteps=WARM_STEPS, **kw)
        warm = fresh[:2] + warm[:4]
        starts = [("fresh", fresh), (f"after {WARM_STEPS}", warm)]
        if B > SLOT_STOPPED:
            starts[1] = (f"after {WARM_STEPS}, slot {SLOT_IDLE} idle, slot "
                         f"{SLOT_STOPPED} stopped", freeze_slots(
                             cms, warm, n, SLOT_IDLE, SLOT_STOPPED))
        mode = f"lane tiles of {tile}" if tile else "one queue per slot"
        for what, args in starts:
            for k in SEARCH_K:
                ref = search_slots_plain(cms, *args, supersteps=k, **kw)
                got = search_slots_cuda(cms, *args, supersteps=k, **kw)
                torch.cuda.synchronize()
                bad = search_diff(ref, got)
                if bad:
                    fail(f"{tag} {B} slots ({mode}) {what}, K={k}: "
                         f"search_slots_cuda differs from search_slots_plain"
                         f" in {', '.join(bad)}")
                max_err = max(max_err, max_abs_diff(ref, got))
                for i, cm in enumerate(cms):
                    one = search_cuda(cm, args[0][i], args[1][i],
                                      *slot_part(args[2:], i, n),
                                      supersteps=k, **kw)
                    bad = search_diff(one, slot_part(got, i, n))
                    if bad:
                        fail(f"{tag} ({mode}) {what}, K={k}: slot {i} "
                             f"differs from a single search_cuda launch in "
                             f"{', '.join(bad)}")
                    if bool(args[2].done[i * n:(i + 1) * n].all()) and (
                            int(got[2][i]) != int(args[4][i])
                            or not bool(got[4][i])):
                        fail(f"{tag} {what}: stopped slot {i} moved")
            print(f"[30] {tag}, {B} slots x {n} lanes, {mode}, {what}: K="
                  f"{','.join(map(str, SEARCH_K))} equal to search_slots_"
                  f"plain and to {B} single launches on every field; after "
                  f"K={SEARCH_K[-1]}: it={got[2].tolist()} "
                  f"nodes={[int(x) for x in got[0].n_nodes.view(B, n).sum(1)]}"
                  f" gbest={got[1].tolist()} stopped={got[4].tolist()}")
        if tag == "J60" and not tile:
            timing = time_slots(card, peak_int32, cms, warm, kw)
    search_cuda.launches, search_cuda.slot_launches = n0
    return max_err, timing


def time_slots(card, peak_int32, cms, args, kw):
    """One launch over the slots (K=MAIN_K, every slot live, the state
    after WARM_STEPS supersteps) against the single launches of the same
    slots, in turn by CUDA events, beside the bound: the sum over slots of
    `search_bound_ms`' bytes and operations."""
    from repro_torch.kernels.fixpoint_kernel import (search_cuda,
                                                     search_slots_cuda,
                                                     search_slots_plain)
    from repro_torch.testing import slot_part
    n, B = MAIN_LANES, len(cms)

    def slots():
        return search_slots_cuda(cms, *args, supersteps=MAIN_K, **kw)

    def singles():
        return [search_cuda(cm, args[0][i], args[1][i],
                            *slot_part(args[2:], i, n), supersteps=MAIN_K,
                            **kw) for i, cm in enumerate(cms)]
    out = slots()
    ms = [cuda_ms(f, reps=10, warmup=2)
          for f in (slots, singles, singles, slots)]
    plain_ms = cuda_ms(lambda: search_slots_plain(
        cms, *args, supersteps=MAIN_K, **kw), reps=1, warmup=0)
    nbytes = ops = 0
    for i, cm in enumerate(cms):
        start = slot_part(args[2:], i, n)
        b = search_bound_ms(cm, start, slot_part(out, i, n), peak_int32)
        nbytes, ops = nbytes + b[2], ops + b[3]
    bound_ms, bound_by = bound(nbytes, ops, peak_int32)
    slot_ms = min(ms[0], ms[3])
    print(f"[30] time, {B} J60 slots x {n} lanes, K={MAIN_K}, after "
          f"{WARM_STEPS} (slots, singles, singles, slots): one launch over "
          f"the slots {ms[0]:.4f}, {ms[3]:.4f} ms; {B} single launches "
          f"{ms[1]:.4f}, {ms[2]:.4f} ms in all ({min(ms[1], ms[2]) / slot_ms:.2f}x"
          f" the slot launch); plain {plain_ms:.3f} ms; bound "
          f"{bound_ms:.5f} ms ({bound_by}: {nbytes} B, {ops} ops, the sum of "
          f"the slots'; slot launch {slot_ms / bound_ms:.0f}x the bound); "
          f"library: none on {card}")
    return slot_ms, plain_ms, bound_ms, bound_by


def launch_counts():
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda, search_cuda
    return dict(fixpoint=fixpoint_cuda.launches,
                few_lane=fixpoint_cuda.few_lane_launches,
                search=search_cuda.launches, slots=search_cuda.slot_launches)


def zero_launch_counts():
    from repro_torch.kernels.fixpoint_kernel import fixpoint_cuda, search_cuda
    fixpoint_cuda.launches = fixpoint_cuda.few_lane_launches = 0
    search_cuda.launches = search_cuda.slot_launches = 0


def phase_solve_many(cases):
    """Phase 31.  Returns the resident run's search_cuda launches."""
    from repro_torch.core import eps
    from repro_torch.core.api import _bucket
    from repro_torch.core.models import ground_check
    from repro_torch.solver import Solver
    cms = [c.cm for c in cases]
    # each slot's pool padded as solve_many pads it, for the sequential
    # solves
    size = _bucket(max(c.pool[0].shape[0] for c in cases))
    pools = [eps.fit_pool(*c.pool, size) for c in cases]
    got, resident_launches = {}, None
    for backend in ("cuda_resident", "cuda"):
        cfg = main_config(backend, max_supersteps=BATCH_CAP)
        zero_launch_counts()
        t0 = time.perf_counter()
        many = Solver(cfg).solve_many(cms)
        wall = time.perf_counter() - t0
        n = launch_counts()
        seq_wall = 0.0
        for i, (c, res) in enumerate(zip(cases, many)):
            t1 = time.perf_counter()
            ref = Solver(cfg).solve(c.cm, subs=pools[i])
            seq_wall += time.perf_counter() - t1
            same_counters(31, f"slot {i} ({backend})",
                          {"solve_many": res, "sequential": ref})
            if ground_check(c.mod, c.inst, c.handles, res) is False:
                fail(f"slot {i} ({backend}): the solution fails the ground "
                     "check")
        eps_s = sum(r.eps_s for r in many)
        steps = [r.n_supersteps for r in many]
        print(f"[31] solve_many, 4 J60 slots ({backend}): "
              + "; ".join(f"slot {i} {r.status} {r.objective} nodes="
                          f"{r.n_nodes} supersteps={r.n_supersteps}"
                          for i, r in enumerate(many))
              + f"; wall {wall:.3f} s (EPS {eps_s:.3f} s, search "
              f"{wall - eps_s:.3f} s) against 4 sequential solves on the "
              f"same pools {seq_wall:.3f} s; launches: fixpoint_cuda "
              f"{n['fixpoint']} (few-lane {n['few_lane']}), search_cuda "
              f"{n['search']} (over slots {n['slots']}) on "
              f"{nvidia_smi('name,power.limit')}")
        if many[0].status != "OPTIMAL" or many[0].objective != J60_OPTIMUM:
            fail(f"slot 0 ({backend}): {many[0].status} {many[0].objective},"
                 f" not OPTIMAL {J60_OPTIMUM}")
        if backend == "cuda_resident":
            quanta = -(-max(steps) // MAIN_K)
            per_slot = sum(-(-s // MAIN_K) for s in steps)
            if not n["search"] == n["slots"] == quanta:
                fail(f"solve_many (cuda_resident): {n['search']} search_cuda"
                     f" launches ({n['slots']} over slots) for {quanta} "
                     "quanta; one launch per quantum expected")
            print(f"[31] one search_cuda launch per quantum: {quanta} "
                  f"launches (one per slot would be {per_slot})")
            resident_launches = n["search"]
        elif n["fixpoint"] - n["few_lane"] != sum(steps):
            fail(f"solve_many (cuda): {n['fixpoint'] - n['few_lane']} "
                 f"superstep launches for {sum(steps)} slot supersteps")
        got[backend] = many
    for i in range(len(cases)):
        same_counters(31, f"slot {i}", {b: got[b][i] for b in got})
    return resident_launches


def phase_service():
    """Phase 32.  Returns the run's search_cuda launches."""
    from repro_torch.core import eps
    from repro_torch.core.api import _bucket
    from repro_torch.core.models import ZOO, ground_check
    from repro_torch.serve import MetricsRecorder, SolverScheduler, loadgen
    from repro_torch.solver import Solver

    class PerBucket(MetricsRecorder):
        """Also keeps each bucket's occupancy samples."""
        def __init__(self):
            super().__init__()
            self.by_bucket = {}

        def sample_occupancy(self, bucket, live, width):
            super().sample_occupancy(bucket, live, width)
            self.by_bucket.setdefault(bucket, []).append(live / width)

    cfg = main_config("cuda_resident", SERVE_STRATEGY)
    trace = loadgen.poisson_trace(SERVE_REQUESTS, SERVE_RATE, seed=SEED,
                                  mix=SERVE_MIX, deadlines=SERVE_DEADLINES)
    rec = PerBucket()
    sched = SolverScheduler(cfg, max_batch=SERVE_BATCH, recorder=rec)
    zero_launch_counts()
    t0 = time.perf_counter()
    handles = loadgen.run_open_loop(sched, trace, max_wall_s=SERVE_MAX_WALL_S)
    wall = time.perf_counter() - t0
    n = launch_counts()
    if n["search"] != n["slots"] or not n["slots"]:
        fail(f"service: {n['search']} search_cuda launches, {n['slots']} "
             "over slots")
    # the sequential reference solves the request's pool padded as its
    # bucket pads it (padding adds failed nodes, never a solution)
    seq, size = Solver(cfg), _bucket(cfg.resolved_eps_target())
    n_checked = 0
    eps_by_bucket = {}
    for a, h in handles:
        res = h.result()
        rid = h.request.request_id
        rec_r = rec.requests[rid]
        eps_by_bucket.setdefault(rec_r.bucket, []).append(res.eps_s)
        if rec_r.deadline_missed:
            continue
        inst = a.generate()
        m, hd = ZOO[a.model].build_model(inst)
        cm = m.compile(device=cfg.device)
        pool = eps.fit_pool(*eps.decompose(cm, cfg.resolved_eps_target(),
                                           cfg.search_options()), size)
        same_counters(32, f"{rid} {a.model} seed {a.seed}",
                      {"served": res, "sequential": seq.solve(cm,
                                                              subs=pool)})
        if ground_check(ZOO[a.model], inst, hd, res) is False:
            fail(f"{rid}: the solution fails the ground check")
        n_checked += 1
    s = rec.summary()
    print(f"[32] service: {SERVE_REQUESTS} requests at {SERVE_RATE}/s "
          f"(seed {SEED}; {', '.join(f'{m} {kw}' for m, kw, _ in SERVE_MIX)})"
          f", {cfg.var_strategy}/{cfg.val_strategy}, {cfg.n_lanes} lanes, "
          f"eps_target {cfg.resolved_eps_target()}, max_batch "
          f"{SERVE_BATCH}: {s['n_done']} done ({s['statuses']}), "
          f"{s['n_deadline_missed']} deadline misses, {n_checked} equal to "
          f"sequential solves and ground-checked; wall {wall:.2f} s")
    for key in ("latency_s", "ttfi_s", "queue_wait_s", "tto_s"):
        print(f"[32] {key}: {s[key]}")
    print(f"[32] instances/s {s['instances_per_sec']}, span {s['span_s']} s;"
          f" launches: search_cuda {n['search']} (all over slots), "
          f"fixpoint_cuda {n['fixpoint']} (few-lane {n['few_lane']})")
    for label, b in sched.buckets().items():
        occ = rec.by_bucket.get(label, [0.0])
        eps = eps_by_bucket.get(label, [0.0])
        print(f"[32] bucket {label}: {b['n_requests']} requests, "
              f"{rec.bucket_stats[label]['n_steps']} quanta, mean occupancy "
              f"{sum(occ) / len(occ):.3f} of {b['width']} slots, builds "
              f"{b['n_builds']} ({b['build_s']} s), EPS per admission mean "
              f"{sum(eps) / len(eps):.3f} s max {max(eps):.3f} s")
    if n_checked < s["n_done"] - s["n_deadline_missed"]:
        fail("service: a completed request was not checked")
    return n["search"]


# --------------------------------------------------------------------------
# phase 33: the scatter oracle on the card
# --------------------------------------------------------------------------

def compare_scatter(cm, lb, ub, dom, what):
    """The ``scatter`` backend against ``cuda`` (kernel 1) on one batch:
    equal failed masks and, on every lane that did not fail, equal
    stores, bitset stores, sweeps and convergence flags.  Returns (lanes
    that failed, whether every output is equal on every lane, the
    scatter call's ms by CUDA events)."""
    import torch
    from repro_torch.core.backend import get_backend
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    ref = get_backend("scatter").fixpoint_batch(cm, lb, ub, dom=dom)
    t1.record()
    got = get_backend("cuda").fixpoint_batch(cm, lb, ub, dom=dom)
    torch.cuda.synchronize()
    if not all(t.is_cuda for t in ref):
        fail(f"{what}: the scatter outputs are not all CUDA tensors")
    names = (("lb", "ub", "dom", "sweeps", "converged") if dom is not None
             else ("lb", "ub", "sweeps", "converged"))
    rfail = (ref[0] > ref[1]).any(1)
    if not torch.equal(rfail, (got[0] > got[1]).any(1)):
        fail(f"{what}: failed masks differ")
    ok = ~rfail
    for name, r, g in zip(names, ref, got):
        if not torch.equal(r[ok], g[ok]):
            fail(f"{what}: {name} differs on lanes that did not fail")
    return (int(rfail.sum()), all(torch.equal(r, g) for r, g in zip(ref, got)),
            t0.elapsed_time(t1))


def phase_scatter_oracle(card, models, j30):
    """Phase 33.  `models`: tag -> Case (with random stores, bitset
    stores for a table model, and an EPS pool where one was made).
    Returns the launches of `batched_fixpoint(impl="cuda")` and of the
    J30 solves."""
    import torch
    from repro_torch.core import bitset as B
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels.ops import batched_fixpoint
    from repro_torch.kernels.ref import fixpoint_ref
    from repro_torch.solver import SolveConfig
    timings, ops_launches = [], 0
    for tag, c in models.items():
        cm = c.cm
        lb = torch.from_numpy(c.lbs).cuda()
        ub = torch.from_numpy(c.ubs).cuda()
        batches = [("random", lb, ub, None)]
        if c.doms is not None:
            # the bitset store carried (random words), and transient
            batches.insert(0, ("random, bitset store carried", lb, ub,
                               torch.from_numpy(c.doms.view("int32")).cuda()))
        if c.pool is not None:
            plb = torch.from_numpy(c.pool[0][:N_RANDOM]).cuda()
            pub = torch.from_numpy(c.pool[1][:N_RANDOM]).cuda()
            pdom = (B.from_bounds(plb, pub, cm.dom_off, cm.n_words,
                                  track=cm.dom_track.view(torch.int32))
                    if c.doms is not None else None)
            batches.append(("EPS pool", plb, pub, pdom))
        for name, blb, bub, bdom in batches:
            n_failed, whole, scatter_ms = compare_scatter(
                cm, blb, bub, bdom, f"{tag} {name}: scatter vs cuda")
            print(f"[33] {tag} {name}: scatter == cuda on {blb.shape[0]} "
                  f"stores ({n_failed} failed; every output equal on every "
                  f"lane: {whole})")
            if name.startswith("random"):
                kernel_ms = cuda_ms(lambda: get_backend("cuda").fixpoint_batch(
                    cm, blb, bub, dom=bdom), reps=10, warmup=2)
                timings.append((f"{tag} {name}", scatter_ms, kernel_ms))
        # the oracle on the last 64 of the stores (past the overfull ones
        # of an AllDifferent model), against the façade's kernel
        n = SCATTER_REF_LANES
        zero_launch_counts()
        klb, kub = batched_fixpoint(cm, lb[-n:], ub[-n:], impl="cuda")
        torch.cuda.synchronize()
        ops_launches += launch_counts()["fixpoint"]
        rlb, rub = fixpoint_ref(cm, lb[-n:], ub[-n:])
        if not (rlb.is_cuda and rub.is_cuda):
            fail(f"{tag}: fixpoint_ref's outputs are not CUDA tensors")
        rfail = (rlb > rub).any(1)
        if not torch.equal(rfail, (klb > kub).any(1)):
            fail(f"{tag}: batched_fixpoint(impl='cuda') and fixpoint_ref "
                 "disagree on the failed mask")
        if not (torch.equal(rlb[~rfail], klb[~rfail])
                and torch.equal(rub[~rfail], kub[~rfail])):
            fail(f"{tag}: batched_fixpoint(impl='cuda') and fixpoint_ref "
                 "disagree on a store that did not fail")
        print(f"[33] {tag}: batched_fixpoint(impl='cuda') == fixpoint_ref on "
              f"{n} stores ({int(rfail.sum())} failed)")
    for what, scatter_ms, kernel_ms in timings:
        print(f"[33] time, {what} [{N_RANDOM}, V] uncapped: scatter form "
              f"{scatter_ms:.3f} ms (one call), fixpoint_cuda {kernel_ms:.4f} "
              f"ms ({scatter_ms / kernel_ms:.1f}x) on {card}")
    # a whole solve through the scatter backend on the card, phase 3's J30
    got, launches = {}, {}
    for backend in ("scatter", "cuda"):
        cfg = SolveConfig.preset("prove", backend=backend, n_lanes=J30_LANES)
        got[backend], launches[backend] = solve_case(
            33, "J30", j30, cfg, J30_REFERENCE["objective"])
        if backend == "scatter" and any(launches[backend]):
            fail(f"J30 (scatter): kernel launches {launches[backend]}")
    same_counters(33, "J30", got, J30_REFERENCE)
    print(f"kernels: batched_fixpoint(impl='cuda') launches of fixpoint_cuda "
          f"{ops_launches}; the J30 solves' (fixpoint_cuda, search_cuda, "
          f"few-lane) launches: scatter {launches['scatter']}, cuda "
          f"{launches['cuda']}")
    return ops_launches, launches


# --------------------------------------------------------------------------
# phase 34: the paper's comparison, the card against the sequential baseline
# --------------------------------------------------------------------------

def cpu_model():
    """The host CPU as /proc/cpuinfo gives it: the model name (a virtual
    machine may report "unknown"), with the vendor, family, model number,
    clock and processor count beside it."""
    first, n = {}, 0
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, val = line.partition(":")
            key = key.strip()
            n += key == "processor"
            first.setdefault(key, val.strip())
    get = first.get
    return (f"{get('model name', 'no model name')} ({get('vendor_id', '?')}"
            f" family {get('cpu family', '?')} model {get('model', '?')}, "
            f"{get('cpu MHz', '?')} MHz, {n} processors)")


def phase_paper_comparison(card):
    """Phase 34.  Returns {tag: (card result, baseline result, launches)}."""
    from repro_torch.core.baseline import SequentialSolver
    from repro_torch.core.models import rcpsp
    from repro_torch.solver import Solver
    cfg = main_config("cuda_resident")
    host = cpu_model()
    print(f"[34] card {card}; host CPU {host} (the baseline, one core); "
          f"card: cuda_resident K={MAIN_K}, {cfg.n_lanes} lanes, eps_target "
          f"{cfg.resolved_eps_target()}, prove; baseline: the same "
          f"SearchOptions, {BASELINE_TIMEOUT_S:.0f} s per instance")
    out = {}
    for tag, n, seed in COMPARISON:
        inst = rcpsp.generate(n, n_resources=4, seed=seed)
        m, h = rcpsp.build_model(inst)
        cm = m.compile(device="cuda")
        zero_launch_counts()
        par = Solver(cfg).solve(cm)
        n_l = launch_counts()
        seq = SequentialSolver(cm, cfg.search_options()).solve(
            timeout_s=BASELINE_TIMEOUT_S)
        if par.status != "OPTIMAL":
            fail(f"{tag}: the card gave {par.status}, not OPTIMAL")
        want = COMPARISON_OPTIMUM.get(tag)
        if want is not None and par.objective != want:
            fail(f"{tag}: the card proved {par.objective}, not {want}")
        starts = par.solution[[v.idx for v in h["s"]]]
        ok, mk = rcpsp.check_solution(inst, starts)
        if not (ok and mk == par.objective):
            fail(f"{tag}: the card's solution fails the ground check")
        if seq.status == "OPTIMAL" and seq.objective != par.objective:
            fail(f"{tag}: the baseline proved {seq.objective}, the card "
                 f"{par.objective}")
        if seq.objective is not None and seq.objective < par.objective:
            fail(f"{tag}: the baseline's incumbent {seq.objective} is below "
                 f"the proven optimum {par.objective}")
        print(f"[34] {tag}: card {par.status} {par.objective} nodes="
              f"{par.n_nodes} wall={par.wall_s:.3f} s "
              f"({par.nodes_per_sec:.0f} nodes/s) eps_s={par.eps_s:.3f} "
              f"launches fixpoint_cuda={n_l['fixpoint']} (few-lane "
              f"{n_l['few_lane']}) search_cuda={n_l['search']} | baseline "
              f"{seq.status} {seq.objective} nodes={seq.n_nodes} "
              f"wall={seq.wall_s:.3f} s ({seq.nodes_per_sec:.0f} nodes/s) | "
              f"ground check OK")
        out[tag] = (par, seq, n_l)
    return out


# --------------------------------------------------------------------------
# phase 35: the entry points, as a user runs them
# --------------------------------------------------------------------------

def phase_examples():
    """Phase 35: the port's examples as subprocesses on the card."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    for args in EXAMPLES:
        t0 = time.time()
        r = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                           capture_output=True, text=True,
                           timeout=EXAMPLE_TIMEOUT_S)
        if r.returncode != 0:
            fail(f"{' '.join(args)} exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        for line in r.stdout.strip().splitlines():
            print(f"[35] {os.path.basename(args[0])}: {line}")
        print(f"[35] {' '.join(args)}: exit 0 in {time.time() - t0:.1f} s")


# --------------------------------------------------------------------------
# phase 36: distributed EPS on the card
# --------------------------------------------------------------------------

def dist_solve_case(card, tag, c, cfg, optimum=None, **kw):
    """One `dist_solve.solve_dist` with the launch counters set to 0 just
    before and read just after; the solution is ground-checked, and with
    `optimum` the result must be OPTIMAL at it.  Returns (result, trace,
    launches)."""
    from repro_torch.core import dist_solve
    from repro_torch.core.models import ground_check
    zero_launch_counts()
    res, tr = dist_solve.solve_dist(c.cm, cfg, **kw)
    n = launch_counts()
    if n["search"]:
        fail(f"{tag}: {n['search']} search_cuda launches on the mesh path")
    checked = ground_check(c.mod, c.inst, c.handles, res)
    if checked is False:
        fail(f"{tag}: the solution fails the ground check")
    if optimum is not None and (res.status != "OPTIMAL"
                                or res.objective != optimum):
        fail(f"{tag}: expected OPTIMAL {optimum}, got {res.status} "
             f"{res.objective}")
    D = cfg.mesh_shards
    search_s = res.wall_s - res.eps_s
    print(f"[36] {tag} ({cfg.backend}, mesh {D}, {cfg.n_lanes} lanes per "
          f"shard, eps_target {cfg.resolved_eps_target()}, chunk "
          f"{cfg.chunk}): {res.status} objective={res.objective} nodes="
          f"{res.n_nodes} fails={res.n_fails} sols={res.n_sols} sweeps="
          f"{res.n_sweeps} supersteps={res.n_supersteps} chunks="
          f"{tr.n_chunks} steals={tr.n_steals} remeshes="
          f"{len(tr.remesh_events)}; wall {res.wall_s:.3f} s, EPS "
          f"{res.eps_s:.3f} s, search {search_s * 1e3:.1f} ms "
          f"({search_s / max(res.n_supersteps, 1) * 1e3:.3f} ms per mesh "
          f"superstep after EPS); fixpoint_cuda launches {n['fixpoint']} "
          f"(few-lane {n['few_lane']}); ground check "
          f"{'OK' if checked else 'n/a'}; on {card}")
    return res, tr, n


def phase_distributed(card, j30, j60, j120, j60_cuda):
    """Phase 36.  `j60_cuda` is phase 3's J60 `cuda` result.  Returns the
    (256-thread, few-lane) fixpoint_cuda launches of the J60 and J120
    mesh solves."""
    import numpy as np
    from repro_torch.ft.fault_tolerance import DeviceLoss
    from repro_torch.solver import SolveConfig, Solver
    print(f"[36] distributed EPS on {card}: every shard on cuda:0")
    for D in DIST_MESHES:
        got, traces = {}, {}
        for backend in ("cuda", "gather"):
            cfg = SolveConfig.preset(
                "prove", backend=backend, n_lanes=DIST_J30_LANES,
                eps_target=DIST_J30_EPS, mesh_shards=D)
            got[backend], traces[backend], n = dist_solve_case(
                card, f"J30 mesh {D}", j30, cfg)
            if backend == "cuda" and n["fixpoint"] < D * got[
                    backend].n_supersteps:
                fail(f"J30 mesh {D}: {n['fixpoint']} fixpoint_cuda launches"
                     f" for {got[backend].n_supersteps} supersteps")
        same_counters(36, f"J30 mesh {D}", got, DIST_J30_REFERENCE[D])
        if traces["cuda"].gbest_per_chunk != traces["gather"].gbest_per_chunk:
            fail(f"J30 mesh {D}: the bound per chunk differs between cuda "
                 "and gather")

    launches = [0, 0]
    full = ([("J60", j60, D, J60_OPTIMUM) for D in DIST_MESHES]
            + [("J120", j120, 4, SPARSE_OPTIMUM["J120"])])
    for tag, c, D, optimum in full:
        cfg = main_config("cuda", mesh_shards=D)
        res, tr, n = dist_solve_case(card, f"{tag} mesh {D}", c, cfg,
                                     optimum)
        if n["fixpoint"] - n["few_lane"] != D * res.n_supersteps:
            fail(f"{tag} mesh {D}: {n['fixpoint'] - n['few_lane']} "
                 f"256-thread launches for {D} shards x {res.n_supersteps} "
                 "supersteps")
        if tag == "J60" and D == 1:
            same_counters(36, "J60 mesh 1 against phase 3's cuda solve",
                          {"mesh 1": res, "phase 3": j60_cuda})
        launches[0] += n["fixpoint"] - n["few_lane"]
        launches[1] += n["few_lane"]

    # a steal: J60's pool with its second half failed
    D, chunk = DIST_STEAL
    lb, ub = (np.array(a) for a in j60.pool)
    half = (lb.shape[0] + 1) // 2
    lb[half:, 0], ub[half:, 0] = 1, 0
    cfg = main_config("cuda", mesh_shards=D, chunk=chunk)
    res, tr, _ = dist_solve_case(card, "J60 steal", j60, cfg,
                                 subs=(lb, ub))
    single = Solver(main_config("cuda")).solve(j60.cm, subs=(lb, ub))
    if not tr.n_steals:
        fail("J60 steal: no steal fired")
    for k, (owned, consumed) in enumerate(zip(tr.assignments,
                                              tr.consumed_per_chunk)):
        flat = [i for o in owned for i in o]
        if (len(flat) != len(set(flat)) or not set(flat).isdisjoint(consumed)
                or set(flat) | set(consumed) != set(tr.all_ids)):
            fail(f"J60 steal: the pool is not a partition at chunk {k + 1}")
    if res.objective != single.objective or res.status != single.status:
        fail(f"J60 steal: {res.status} {res.objective}, a one-shard solve "
             f"of the same pool {single.status} {single.objective}")
    print(f"[36] J60 steal: {tr.n_steals} steals (first {tr.steal_events[0]})"
          f"; the partition holds at all {tr.n_chunks} boundaries; "
          f"{res.status} {res.objective} == one shard's {single.status} "
          f"{single.objective}")

    # a device loss
    D, chunk, at, lost = DIST_LOSS
    cfg = main_config("cuda", mesh_shards=D, chunk=chunk)
    res, tr, _ = dist_solve_case(card, "J60 device loss", j60, cfg,
                                 J60_OPTIMUM,
                                 fault=DeviceLoss(at_chunk=at, shard=lost))
    g = tr.gbest_per_chunk
    ev = tr.remesh_events
    if (len(ev) != 1 or (ev[0]["shards_before"], ev[0]["shards_after"])
            != (D, D - 1) or ev[0]["n_requeued"] < 1):
        fail(f"J60 device loss: remesh events {ev}")
    if not res.complete or any(a < b for a, b in zip(g, g[1:])):
        fail(f"J60 device loss: complete={res.complete}, bound per chunk {g}")
    print(f"[36] J60 device loss: {ev[0]}; bound per chunk {g}")

    # the CLI
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.solve",
                        *DIST_CLI], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=EXAMPLE_TIMEOUT_S)
    out = r.stdout
    if (r.returncode != 0 or f"OPTIMAL objective={J60_OPTIMUM}" not in out
            or "distributed: shards=4" not in out):
        fail(f"launch/solve.py {' '.join(DIST_CLI)}: exit {r.returncode}: "
             f"{out[-1000:]} {r.stderr[-2000:]}")
    for line in out.strip().splitlines():
        print(f"[36] launch/solve.py: {line}")
    print(f"[36] launch/solve.py {' '.join(DIST_CLI)}: exit 0 in "
          f"{time.time() - t0:.1f} s on {card}")
    return launches


# --------------------------------------------------------------------------
# phase 37: the other architectures' serving path
# --------------------------------------------------------------------------

@contextlib.contextmanager
def moe_log(dropped, products):
    """Records each MoE layer's ``moe_dropped`` (a 0-d tensor, read after
    the run; serving itself ignores the aux dict) and the operands of the
    first expert product (the prefill's gate product of the first MoE
    layer) while the blocks run."""
    from repro_torch.nn import moe as MOE
    from repro_torch.nn import transformer as T
    run, product = T.run_moe, MOE._expert_f32

    def logged(p, x, cfg):
        out, aux = run(p, x, cfg)
        dropped.append(aux["moe_dropped"])
        return out, aux

    def kept(xe, w):
        if not products:
            products.append((xe, w))
        return product(xe, w)
    T.run_moe, MOE._expert_f32 = logged, kept
    try:
        yield
    finally:
        T.run_moe, MOE._expert_f32 = run, product


def expert_check(cfg, xe, w, card):
    """The card's expert product (a bf16 GEMM with an f32 result) against
    the product of the bf16 values widened to f32 (`einsum_f32`, the
    reference's ``preferred_element_type=f32``), on a real prefill's
    dispatched tokens: max |err| under one bf16 ulp (2^-8) of max |ref|."""
    import torch
    from repro_torch.nn.layers import einsum_f32
    from repro_torch.nn.moe import _expert_f32
    got = _expert_f32(xe, w)
    ref = einsum_f32("ecd,edf->ecf", xe, w)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    bound = ref.abs().max().item() * 2.0 ** -8
    print(f"[37] {cfg.name}: expert product {list(xe.shape)} @ "
          f"{list(w.shape)} in f32 against the widened product: max |err| "
          f"{err:.3e}, bound {bound:.3e} (one bf16 ulp of max |ref|; {card})")
    if not err < bound:
        fail(f"{cfg.name}: expert product differs from the f32 product: "
             f"{err:.3e} >= {bound:.3e}")


def decode_check(params, cfg, batch, card, smax=None):
    """Prefill on S-1 tokens and decode token S-1 against a prefill on all
    S (the stub inputs kept), the caches of ``smax`` slots: max |err|
    against DECODE_TOL · max|logit|."""
    S = batch["tokens"].shape[1]
    err, scale = decode_gap(params, cfg, batch, smax)
    print(f"[37] {cfg.name}: decode of token {S - 1} at "
          f"B={batch['tokens'].shape[0]}, S={S} against teacher forcing: "
          f"max |err| {err:.4f}, max |logit| {scale:.4f} ({err / scale:.4f} "
          f"of it; bound {DECODE_TOL}; {card})")
    if err >= DECODE_TOL * scale:
        fail(f"{cfg.name}: decode differs from teacher forcing: {err:.4f} "
             f">= {DECODE_TOL} x {scale:.4f}")


def decode_gap(params, cfg, batch, smax=None):
    """(max |decode − teacher forcing|, max(max|logit|, 1)) of the last
    token, the caches of ``smax`` slots (`serve_smax` by default)."""
    import torch
    from repro_torch.launch.serve import serve_smax
    from repro_torch.nn import model as MD
    S = batch["tokens"].shape[1]
    smax = serve_smax(cfg, S, 0) if smax is None else smax
    head = dict(batch, tokens=batch["tokens"][:, :-1])
    full, _ = MD.forward_prefill(params, cfg, batch, smax)
    _, caches = MD.forward_prefill(params, cfg, head, smax)
    dec, _ = MD.forward_decode(params, cfg, batch["tokens"][:, -1:], caches)
    torch.cuda.synchronize()
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        fail(f"{cfg.name}: non-finite logits")
    return ((dec - full).abs().max().item(),
            max(full.abs().max().item(), 1.0))


@contextlib.contextmanager
def unmasked_ring():
    """The decode mask without its first-lap repair: ring slots never
    written (negative position) take softmax weight, as in the
    reference."""
    from repro_torch.nn import attention as A
    mask = A._mask

    def faulty(q_pos, kv_pos, kv_valid, *, causal, window, kv_len=None):
        if kv_len is not None:
            kv_pos = kv_pos.clamp_min(0)
        return mask(q_pos, kv_pos, kv_valid, causal=causal, window=window,
                    kv_len=kv_len)
    A._mask = faulty
    try:
        yield
    finally:
        A._mask = mask


def short_ring_check(params, cfg, tokens, card):
    """recurrentgemma's decode on the ring's first lap (S tokens under a
    ring of its whole window) against teacher forcing, then with the
    unwritten slots let in, which must fail the same bound: the check
    tells the repaired ring from the faulty one."""
    W = cfg.rglru.window
    print(f"[37] {cfg.name}: short prompt, {tokens.shape[1]} tokens under a "
          f"ring of {W} slots (its first lap)")
    decode_check(params, cfg, {"tokens": tokens}, card, smax=W)
    with unmasked_ring():
        err, scale = decode_gap(params, cfg, {"tokens": tokens}, W)
    print(f"[37] {cfg.name}: the same decode with the {W - tokens.shape[1]}"
          f" unwritten slots in the softmax: max |err| {err:.4f} "
          f"({err / scale:.4f} of max |logit|; must reach {DECODE_TOL})")
    if err < DECODE_TOL * scale:
        fail(f"{cfg.name}: the short-prompt check cannot tell the repaired "
             f"ring from the faulty one: {err:.4f} < {DECODE_TOL} x "
             f"{scale:.4f}")


def phase_other_archs(card):
    """Every other architecture served at full width through `generate`,
    one after another (each freed before the next), twice (cold, then
    warm), then decode against teacher forcing.  Returns the
    flash_attention launches of the warm runs."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels.fixpoint_kernel import (fixpoint_cuda,
                                                     search_cuda)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import serve_smax, stub_batch
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train.serve_step import generate
    total = 0
    for arch, keep, B, S, gen, want in OTHER_ARCHS:
        full = configs.get(arch)
        cfg = full if keep is None else dataclasses.replace(full,
                                                            n_layers=keep)
        cut = ("nothing cut" if keep is None else
               f"depth cut from {full.n_layers} to {keep} layers at full "
               f"width (the whole model, {full.n_params():,} params, is "
               f"{full.n_params() * 2 / 1e9:.0f} GB in bf16)")
        layers = (f"{cfg.encdec.enc_layers} + {cfg.encdec.dec_layers}"
                  if cfg.encdec else str(cfg.n_layers))
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = init_params(MD.param_specs(cfg), torch.Generator(
            device="cuda").manual_seed(LM_WEIGHT_SEED), "cuda")
        torch.cuda.synchronize()
        nbytes = sum(p.numel() * p.element_size() for p in params.values())
        print(f"[37] {cfg.name}: {layers} layers, d_model {cfg.d_model}, "
              f"{cfg.n_params():,} params ({cfg.n_active_params():,} active "
              f"per token), {nbytes / 1e9:.3f} GB on the card, drawn in "
              f"{time.perf_counter() - t:.2f} s (peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB); {cut} "
              f"({card})")
        batch = stub_batch(cfg, np.random.default_rng(SEED), B, S, "cuda")
        smax = serve_smax(cfg, S, gen)
        extra = (f" + {cfg.frontend_tokens} patches"
                 if cfg.frontend == "vit_stub" else
                 f", {cfg.frontend_tokens} frames" if cfg.encdec else "")
        runs = []
        for run in ("cold", "warm"):
            torch.cuda.reset_peak_memory_stats()
            dropped, products, stats = [], [], {}
            flash_attention.launches = 0
            fixpoint_cuda.launches = search_cuda.launches = 0
            t0 = time.perf_counter()
            with moe_log(dropped, products):
                out = generate(params, cfg, batch, steps=gen, smax=smax,
                               stats=stats)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = flash_attention.launches
            if fixpoint_cuda.launches or search_cuda.launches:
                fail(f"{cfg.name}: generate launched a solver kernel")
            if launches != want:
                fail(f"{cfg.name}: flash_attention launched {launches} "
                     f"times in generate, not {want}")
            if out.shape != (B, gen) or not ((out >= 0)
                                             & (out < cfg.vocab)).all():
                fail(f"{cfg.name}: tokens {tuple(out.shape)} outside the "
                     "vocabulary")
            runs.append(out)
            print(f"[37] {cfg.name} {run}: {B} requests x {S} prompt tokens"
                  f"{extra}, {gen} generated: wall {wall:.3f} s, prefill "
                  f"{stats['prefill_s'] * 1e3:.3f} ms, decode "
                  f"{stats['decode_s'] / (gen - 1) * 1e3:.3f} ms/token, "
                  f"{B * gen / wall:.1f} tokens/s, flash_attention launches "
                  f"{launches}, max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
                  f"({card})")
        total += launches
        print(f"[37] {cfg.name}: cold and warm tokens equal: "
              f"{torch.equal(*runs)}; request 0: {runs[1][0].tolist()}")
        if cfg.moe is not None:
            n_moe = cfg.n_layers - cfg.moe.first_dense
            share = [float(d) for d in dropped]
            print(f"[37] {cfg.name}: moe_dropped in the prefill's {n_moe} "
                  f"MoE layers {[round(d, 4) for d in share[:n_moe]]} (mean "
                  f"{sum(share[:n_moe]) / n_moe:.4f}), at most "
                  f"{max(share[n_moe:]):.4f} in a decode step")
            expert_check(cfg, *products[0], card)
            del products
            cb, cs = MOE_CHECK
            batch = {"tokens": batch["tokens"][:cb, :cs]}
        decode_check(params, cfg, batch, card)
        if cfg.rglru is not None:
            sb, ss = SHORT_RING
            short_ring_check(params, cfg, batch["tokens"][:sb, :ss], card)
        del params, batch, out, runs
        gc.collect()
        torch.cuda.empty_cache()
    return total


def grad_norm_rel(got, ref):
    """‖got − ref‖ / ‖ref‖ of two f32 tensors (on any devices)."""
    ref = ref.double().cpu()
    return ((got.double().cpu() - ref).norm() / ref.norm().clamp_min(1e-30)
            ).item()


def train_smoke_step(cfg, params, batch, device):
    """One training step of the smoke config on `device` from copies of
    `params`: ``loss_and_grads`` and ``apply_updates`` (the body of
    ``train_step``).  Returns (loss, grads, updated params)."""
    from repro_torch.data.pipeline import to_device
    from repro_torch.nn.layers import set_matmul_precision
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import loss_and_grads
    set_matmul_precision()
    p = {k: v.to(device, copy=True) for k, v in params.items()}
    ocfg = O.OptConfig()
    (_, metrics), grads = loss_and_grads(p, cfg, to_device(batch, device),
                                         ocfg, remat=True, chunks=(8, 8))
    p, _, _ = O.apply_updates(p, grads, O.init_opt_state(p), ocfg)
    return float(metrics["loss"]), grads, p


def phase_train_smoke(card):
    """(a): every architecture's smoke step, card against CPU."""
    import torch
    from repro_torch import configs
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    B, S = TRAIN_SMOKE
    for arch in configs.ARCH_IDS:
        cfg = configs.get_smoke(arch)
        params = init_params(MD.param_specs(cfg),
                             torch.Generator().manual_seed(LM_WEIGHT_SEED),
                             "cpu", dtype=torch.float32)
        batch = SyntheticLM(cfg, S, B, seed=SEED).batch(0)
        cpu_loss, cpu_grads, _ = train_smoke_step(cfg, params, batch, "cpu")
        t = time.perf_counter()
        loss, grads, new = train_smoke_step(cfg, params, batch, "cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        on_path = [k for k, g in cpu_grads.items() if g.abs().max() > 0]
        bad = [k for k, g in grads.items() if not torch.isfinite(g).all()]
        dead = [k for k in on_path if not grads[k].abs().max() > 0]
        moved = sum(not torch.equal(new[k].cpu(), params[k]) for k in params)
        rel = abs(loss - cpu_loss) / abs(cpu_loss)
        worst = max(grad_norm_rel(grads[k], cpu_grads[k]) for k in on_path)
        print(f"[38] {cfg.name}: loss card {loss:.6f}, cpu {cpu_loss:.6f} "
              f"({rel:.2e} relative, bound {TRAIN_LOSS_RTOL}); "
              f"{len(grads)} gradient leaves, {len(on_path)} nonzero on the "
              f"CPU, {len(on_path) - len(dead)} of them nonzero on the card,"
              f" {len(bad)} not finite; worst leaf ‖card − cpu‖/‖cpu‖ "
              f"{worst:.4f} (bound {TRAIN_GRAD_RTOL}); {moved} params moved; step {ms:.1f} ms (cold; "
              f"{card})")
        if (not rel <= TRAIN_LOSS_RTOL or bad or dead or not on_path
                or not worst <= TRAIN_GRAD_RTOL):
            fail(f"{cfg.name}: training step on the card: loss {loss} "
                 f"against {cpu_loss} on the CPU, non-finite {bad}, zero "
                 f"{dead}, worst leaf {worst:.4f} (bound {TRAIN_GRAD_RTOL})")
        del params, grads, cpu_grads, new


def learnable_run(cfg, steps):
    """`steps` steps of the learnable task on the card; the losses."""
    import torch
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import train_step
    data = SyntheticLM(cfg, LEARN["seq"], LEARN["batch"], seed=SEED)
    params = init_params(MD.param_specs(cfg),
                         torch.Generator().manual_seed(SEED), "cpu",
                         dtype=torch.float32)
    params = {k: v.to("cuda") for k, v in params.items()}
    opt = O.init_opt_state(params)
    ocfg = O.OptConfig(peak_lr=LEARN["lr"], warmup_steps=LEARN["warmup"],
                       total_steps=steps, schedule="cosine")
    losses = []
    for s in range(steps):
        params, opt, m = train_step(params, opt,
                                    to_device(data.batch(s), "cuda"), cfg,
                                    ocfg, remat=False, chunks=(8, 8))
        losses.append(float(m["loss"]))
    return losses


def phase_learn_and_resume(card):
    """(b) the learnable task, (c) kill and resume under the supervisor."""
    import tempfile
    import torch
    from repro_torch import configs
    from repro_torch.ckpt.checkpoint import Checkpointer
    from repro_torch.data.pipeline import SyntheticLM, to_device
    from repro_torch.ft.fault_tolerance import TrainSupervisor
    from repro_torch.nn import model as MD
    from repro_torch.nn.layers import init_params
    from repro_torch.train import optimizer as O
    from repro_torch.train.train_step import train_step
    cfg = configs.get_smoke("llama3-8b")
    t = time.perf_counter()
    losses = learnable_run(cfg, LEARN["steps"])
    first, last = sum(losses[:5]) / 5, sum(losses[-5:]) / 5
    print(f"[38] {cfg.name}: {LEARN['steps']} steps of the learnable task "
          f"({LEARN['batch']} x {LEARN['seq']} tokens) in "
          f"{time.perf_counter() - t:.2f} s: mean loss of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f} (drop {first - last:.4f},"
          f" at least {LEARN['drop']}); losses "
          f"{[round(x, 3) for x in losses[::10]]} ({card})")
    if not all(math.isfinite(x) for x in losses) or \
            not last <= first - LEARN["drop"]:
        fail(f"{cfg.name}: the learnable task's loss fell {first - last:.4f}"
             f", not {LEARN['drop']}")

    cut, end, every = RESUME
    data = SyntheticLM(cfg, 16, 4, seed=SEED)
    ocfg = O.OptConfig(peak_lr=3e-3, warmup_steps=2, total_steps=end)

    def fresh():
        p = init_params(MD.param_specs(cfg),
                        torch.Generator().manual_seed(SEED), "cpu",
                        dtype=torch.float32)
        p = {k: v.to("cuda") for k, v in p.items()}
        return p, O.init_opt_state(p)

    def step_fn(params, opt, step):
        return train_step(params, opt, to_device(data.batch(step), "cuda"),
                          cfg, ocfg, chunks=(8, 8))

    p_ref, o_ref = fresh()
    for s in range(end):
        p_ref, o_ref, _ = step_fn(p_ref, o_ref, s)
    with tempfile.TemporaryDirectory() as tmp:
        TrainSupervisor(Checkpointer(tmp), ckpt_every=every).run(
            *fresh(), step_fn, n_steps=cut)
        resumed_at = Checkpointer(tmp).latest_step()
        p_res, o_res, log = TrainSupervisor(
            Checkpointer(tmp), ckpt_every=every).run(*fresh(), step_fn,
                                                     n_steps=end)
    differ = [f"{part}:{k}" for k in p_ref for part, a, b in (
        ("params", p_ref[k], p_res[k]), ("mu", o_ref["mu"][k],
                                         o_res["mu"][k]),
        ("nu", o_ref["nu"][k], o_res["nu"][k])) if not torch.equal(a, b)]
    print(f"[38] {cfg.name}: run cut at step {cut} (checkpoint {resumed_at})"
          f", resumed to {end} under TrainSupervisor ({len(log)} steps run):"
          f" {3 * len(p_ref) - len(differ)} of {3 * len(p_ref)} params and "
          f"moments equal to the uninterrupted run bit for bit; step "
          f"{int(o_res['step'])}")
    if differ or resumed_at != cut or len(log) != end - cut:
        fail(f"resumed training differs from the uninterrupted run: "
             f"{differ[:8]}")


def phase_train_full(card):
    """(d) minicpm-2b whole through launch/train.py."""
    import gc
    import torch
    from repro_torch import configs
    from repro_torch.launch import train
    cfg = configs.get("minicpm-2b")
    nbytes = cfg.n_params() * 4
    print(f"[38] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads, vocab {cfg.vocab}, {cfg.n_params():,} "
          f"params: f32 params, gradients, mu and nu {4 * nbytes / 1e9:.1f} "
          f"GB; launch/train.py {' '.join(TRAIN_FULL)}")
    t = time.perf_counter()
    records = train.main(TRAIN_FULL)
    wall = time.perf_counter() - t
    for r in records:
        print(f"[38] {cfg.name} step {r['step']} "
              f"({'cold' if r['step'] == 0 else 'warm'}): {r['ms']:.1f} ms, "
              f"{r['tokens_per_s']:.1f} tokens/s, peak max_memory_allocated "
              f"{r['peak_gb']:.3f} GB, loss {r['loss']:.4f}, lr "
              f"{r['lr']:.3e}, grad_norm {r['grad_norm']:.4f} ({card})")
    warm = [r["ms"] for r in records[1:]]
    print(f"[38] {cfg.name}: warm steps {min(warm):.1f}-{max(warm):.1f} ms, "
          f"{max(r['tokens_per_s'] for r in records[1:]):.1f} tokens/s at "
          f"best; peak {max(r['peak_gb'] for r in records):.3f} GB; "
          f"{wall:.1f} s with the draw ({card})")
    if len(records) != 4 or not all(
            math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
            and r["grad_norm"] > 0 for r in records):
        fail(f"{cfg.name}: training gave non-finite losses or grad norms")
    gc.collect()
    torch.cuda.empty_cache()


def phase_training(card):
    """Phase 38: (a)-(d), with the kernels' launch counters read around
    it (e)."""
    from repro_torch.kernels.flash_attention import flash_attention

    def counts():
        return dict(launch_counts(), flash=flash_attention.launches)

    before = counts()
    phase_train_smoke(card)
    phase_learn_and_resume(card)
    phase_train_full(card)
    after = counts()
    print(f"[38] kernel launch counters before and after the phase: "
          f"{before} and {after}")
    if after != before:
        fail(f"training launched a kernel: {before} -> {after}")


def mode_entry(base, mode, launches, err, times):
    """A {"kernels": [...]} entry of one kernel mode: `base`'s name,
    route, source and bank list, this mode's launches, max |err| and
    times."""
    ms, plain_ms, bound_ms, bound_by = times
    return dict(base, name=f"{base['name']} ({mode})", mode=mode,
                launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None)


def main():
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              "root of a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this run "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    t0 = time.time()

    def timed(phase, fn, *args):
        t = time.time()
        out = fn(*args)
        print(f"[{phase}] phase {phase} took {time.time() - t:.1f} s")
        return out

    card, peak_int32 = timed(1, phase_card_and_build)
    rcpsp, max_err = timed(2, checked_cases, 2, rcpsp_cases)
    launches, few, cuda_res = timed(3, phase_main_path, rcpsp)
    entry, few_times, run4 = timed(4, phase_times, card, peak_int32, rcpsp,
                                   launches - few, max_err)
    kernels = [entry]
    states, search_err = timed(5, phase_search_vs_plain, 5, rcpsp,
                               {"J30": 256, "J60": MAIN_LANES},
                               RCPSP_VARIANTS, True)
    search_launches, resident_res = timed(6, phase_resident_path, rcpsp,
                                          cuda_res)
    kernels.append(timed(7, phase_search_times, card, peak_int32,
                         states[("J60", "prove")], search_launches,
                         search_err))
    zoo, ad_err = timed(8, checked_cases, 8, zoo_cases)
    searched = {t: zoo[t] for t in ZOO_STRATEGY}
    ad_states, ad_search_err = timed(
        9, phase_search_vs_plain, 9, searched,
        dict.fromkeys(searched, MAIN_LANES), ZOO_VARIANTS, False)
    zoo_launches, long = timed(10, phase_zoo_main_path, zoo)
    timed(11, phase_zoo_smoke)
    run12 = timed(12, phase_alldiff_times, card, peak_int32, zoo, ad_states,
                  long)
    sparse, sp_err = timed(13, checked_cases, 13, sparse_cases)
    timed(13, phase_sparse_vs_dense)
    sp_states, sp_search_err = timed(14, phase_sparse_search, sparse)
    sp_launches = timed(15, phase_sparse_main_path, sparse)
    run16 = timed(16, phase_sparse_times, card, peak_int32, sparse,
                  sp_states)
    tables = timed(17, table_cases)
    ct_err = timed(17, phase_table_vs_plain, tables)
    ct_states, ct_search_err = timed(18, phase_table_search, tables, zoo)
    ct_launches = timed(19, phase_table_main_path, tables, zoo, rcpsp)
    timed(20, phase_table_times, card, peak_int32, tables, ct_states)
    int64, i64_err = timed(21, checked_cases, 21, int64_cases, 1)
    i64_states, i64_search_err = timed(22, phase_int64_search, int64)
    i64_launches = timed(23, phase_int64_main_path, int64, cuda_res)
    tile_states, tile_err, tile_launches = timed(
        24, phase_lane_tiles, rcpsp, zoo, int64, resident_res)
    fix64, srch64, tiled, run25 = timed(
        25, phase_int64_times, card, peak_int32, sparse, sp_states, int64,
        i64_states, states, tile_states)
    flash_err, flash_qkv = timed(26, phase_flash_vs_plain)
    flash_launches = timed(27, phase_lm_main_path, card)
    flash = timed(28, phase_flash_times, card, flash_qkv, flash_launches,
                  flash_err)
    few_err = timed(29, phase_few_lane_vs_plain, list(few_lane_models(
        rcpsp, zoo, sparse, tables, int64)))
    few_err = max(few_err, timed(29, phase_eps_pools, {
        "J60": (rcpsp["J60"].cm, None, run4),
        "nqueens32": (zoo["nqueens32"].cm, ZOO_STRATEGY["nqueens32"], run12),
        "J120": (sparse["J120"].cm, None, run16),
        "J120x1e7": (int64["J120x1e7"].cm, None, run25)}, {
        "nqueens256": (sparse["nqueens256"].cm, NQ256_STRATEGY),
        "crossword_large": (tables["crossword_large"].cm, None),
        "configuration_large": (tables["configuration_large"].cm, None)}))
    batches = timed(30, slot_batches, rcpsp, tables, int64)
    slot_err, slot_times = timed(30, phase_slots_vs_plain, card, peak_int32,
                                 batches)
    many_launches = timed(31, phase_solve_many, batches[0][1])
    serve_launches = timed(32, phase_service)
    scatter_launches, _ = timed(33, phase_scatter_oracle, card, {
        "J60": rcpsp["J60"], "J120": sparse["J120"],
        "nqueens32": zoo["nqueens32"], "nqueens256": sparse["nqueens256"],
        "crossword_large": tables["crossword_large"],
        "J120x1e7": int64["J120x1e7"]}, rcpsp["J30"])
    comparison = timed(34, phase_paper_comparison, card)
    timed(35, phase_examples)
    dist_launches = timed(36, phase_distributed, card, rcpsp["J30"],
                          rcpsp["J60"], sparse["J120"], cuda_res)
    other_flash = timed(37, phase_other_archs, card)
    timed(38, phase_training, card)
    flash["launches"] += other_flash
    kernels[0]["launches"] += dist_launches[0]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], ad_err,
                                    sp_err, ct_err)
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"],
                                    ad_search_err, sp_search_err,
                                    ct_search_err)
    for k in kernels:
        k["banks"] = list(BANKS)
    kernels[0]["mode"] = "int32, 256 threads"
    kernels[1]["mode"] = "int32, one queue"
    fix64_launches = i64_launches[("J120x1e7", "cuda")]
    kernels += [
        mode_entry(kernels[0], "int32, few-lane: EPS, 1024 threads",
                   few + dist_launches[1], few_err, few_times),
        mode_entry(kernels[0], "int64, 256 threads",
                   fix64_launches[0] - fix64_launches[2], i64_err, fix64),
        mode_entry(kernels[1], "int64, one queue",
                   i64_launches[("J120x1e7", "cuda_resident")][1],
                   i64_search_err, srch64),
        mode_entry(kernels[1], f"int32, lane tiles of {MAIN_TILE}",
                   tile_launches, tile_err, tiled),
        mode_entry(kernels[1], "int32, 4 slots of a LaneBatch (solve_many)",
                   many_launches, slot_err, slot_times), flash]
    print("kernels: int64 main-path launches (fixpoint_cuda, search_cuda, "
          "few-lane fixpoint_cuda): "
          + ", ".join(f"{t} {b} {n}" for (t, b), n in i64_launches.items())
          + f"; lane-tiled J60 search_cuda launches {tile_launches}")
    print("kernels: zoo main-path launches (fixpoint_cuda, search_cuda, "
          "few-lane fixpoint_cuda): "
          + ", ".join(f"{t} {b} {n}" for (t, b), n in zoo_launches.items()))
    print("kernels: sparse main-path launches (fixpoint_cuda, "
          "search_cuda, few-lane fixpoint_cuda): " + ", ".join(
              f"{t} {b} {n}" for (t, b), n in sp_launches.items()))
    print("kernels: table and middle_out main-path launches (fixpoint_cuda,"
          " search_cuda, few-lane fixpoint_cuda): " + ", ".join(
              f"{t} {b} {n}" for (t, b), n in ct_launches.items()))
    print(f"kernels: slot launches of search_cuda: solve_many "
          f"{many_launches}, the service {serve_launches}")
    print("kernels: phase 34's (fixpoint_cuda, few-lane fixpoint_cuda, "
          "search_cuda) launches: " + ", ".join(
              f"{t} ({n['fixpoint']}, {n['few_lane']}, {n['search']})"
              for t, (_, _, n) in comparison.items())
          + f"; phase 33's batched_fixpoint(impl='cuda') {scatter_launches}")
    print(f"kernels: phase 36's mesh solves (J60 mesh 1, 2, 4 and J120 mesh "
          f"4) added {dist_launches[0]} 256-thread and {dist_launches[1]} "
          "few-lane fixpoint_cuda launches to phase 3's")
    print(f"kernels: phase 37's warm generate runs (minicpm, pixtral, "
          f"seamless's encoder and decoder, dbrx) added {other_flash} flash_attention "
          f"launches to phase 27's {flash_launches}")
    print("kernels: phase 38 (training) launched none of the three kernels,"
          " as the reference's training runs no Pallas kernel: training "
          "attends through blocked_attention")
    print(f"chip_smoke: all phases passed in {time.time() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
