"""The port's kernel façade and oracle against the JAX package.

* every registered backend's single-store ``fixpoint()`` against JAX's
  gather and scatter ``fixpoint``;
* `kernels/ops.batched_fixpoint` (``gather``, ``scatter`` and ``cuda``;
  on CPU tensors ``cuda`` runs the kernel's plain version) and
  `kernels/ref.fixpoint_ref` against the reference's `kernels/ops.py`
  (gather and scatter) and `kernels/ref.py`, capped and uncapped:
  equal failed masks and identical stores on the lanes that did not fail
  (the comparison spec), and here every store equal as well;
* the refusals of the reference's ``impl="pallas"`` and ``lane_tile``;
* the scatter sweep and fixpoint on one int64 model (RCPSP J30 class,
  durations × 10⁷: the sparse Cumulative layout), the JAX side in a
  subprocess with ``JAX_ENABLE_X64=1`` (the tier-1 run keeps JAX at 32
  bits).
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import batched_fixpoint as jbatched_fixpoint
from repro.kernels.ref import fixpoint_ref as jfixpoint_ref
from repro.core import fixpoint as JF
from repro_torch.core import fixpoint as TF
from repro_torch.core.backend import available_backends, get_backend
from repro_torch.core.models import rcpsp as trcpsp
from repro_torch.kernels.ops import batched_fixpoint
from repro_torch.kernels.ref import fixpoint_ref
from test_torch_int64 import J30 as J30_X64, scaled_rcpsp
from test_torch_scatter import _eq, _model, _stores
from util import random_substores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)      # small tensors: thread hand-offs cost more


@pytest.mark.parametrize("name", ["rcpsp j30 sparse", "crossword"])
def test_backends_single_store_fixpoint(name):
    """Every registered backend's ``fixpoint()`` equals JAX's gather and
    scatter ``fixpoint`` on single stores (the ``cuda`` backends run
    their plain versions on CPU tensors)."""
    jcm, cm = _model(name)
    assert set(available_backends()) == {"gather", "scatter", "cuda",
                                         "cuda_resident"}
    lbs, ubs = _stores(jcm, seed=8, n=3)
    for lb, ub in zip(lbs, ubs):
        ref = JF.fixpoint(jcm, jnp.asarray(lb), jnp.asarray(ub))
        jsc = JF.fixpoint(jcm, jnp.asarray(lb), jnp.asarray(ub),
                          use_scatter=True)
        for r, s in zip(ref, jsc):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(s))
        for backend in available_backends():
            got = get_backend(backend).fixpoint(cm, torch.from_numpy(lb),
                                                torch.from_numpy(ub))
            for g, r, k in zip(got, ref, ("lb", "ub", "sweeps", "conv")):
                _eq(g, r, f"{backend} {k}")


@pytest.mark.parametrize("name", ["rcpsp j30 dense", "nqueens8 sparse",
                                  "crossword"])
def test_batched_fixpoint_and_oracle_match_jax(name):
    """`batched_fixpoint` for each impl and `fixpoint_ref` against the
    reference's façade and oracle: equal failed masks, identical stores
    on the lanes that did not fail (the comparison spec), and here every
    store equal as well."""
    jcm, cm = _model(name)
    lbs, ubs = _stores(jcm, seed=9, n=12)
    lb, ub = torch.from_numpy(lbs), torch.from_numpy(ubs)
    ref = jbatched_fixpoint(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                            impl="gather")
    oracle = jfixpoint_ref(jcm, jnp.asarray(lbs), jnp.asarray(ubs))
    for r, o in zip(ref, oracle):
        np.testing.assert_array_equal(np.asarray(r), np.asarray(o))
    for impl in ("gather", "scatter", "cuda"):
        got = batched_fixpoint(cm, lb, ub, impl=impl)
        for g, r, k in zip(got, ref, ("lb", "ub")):
            _eq(g, r, f"{impl} {k}")
    jsc = jbatched_fixpoint(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                            impl="scatter", max_sweeps=2)
    for g, r in zip(batched_fixpoint(cm, lb, ub, impl="cuda", max_sweeps=2),
                    jsc):
        _eq(g, r, "capped")
    got = fixpoint_ref(cm, lb, ub)
    for g, r, k in zip(got, oracle, ("lb", "ub")):
        _eq(g, r, f"fixpoint_ref {k}")
    for g, r in zip(fixpoint_ref(cm, lb, ub, max_sweeps=1),
                    jfixpoint_ref(jcm, jnp.asarray(lbs), jnp.asarray(ubs),
                                  max_sweeps=1)):
        _eq(g, r, "fixpoint_ref capped")


def test_batched_fixpoint_refuses_pallas_and_lane_tile():
    _, cm = _model("nqueens8 dense")
    lb, ub = cm.lb0[None], cm.ub0[None]
    for kw in (dict(impl="pallas"), dict(impl="cuda", lane_tile=8)):
        with pytest.raises(ValueError, match="impl='cuda'"):
            batched_fixpoint(cm, lb, ub, **kw)
    with pytest.raises(ValueError, match="unknown impl"):
        batched_fixpoint(cm, lb, ub, impl="triton")


# the JAX side with JAX_ENABLE_X64=1: argv[1] the inputs, argv[2] the
# results (.npz)
_JAX_SIDE = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from repro.core.fixpoint import fixpoint_batch, sweep_scatter_batch
from repro.core.models import rcpsp
from test_torch_int64 import J30, scaled_rcpsp

assert jax.config.jax_enable_x64
inp = dict(np.load(sys.argv[1]))
cm = rcpsp.build_model(scaled_rcpsp(rcpsp, **J30))[0].compile()
lb, ub = jnp.asarray(inp["lb"]), jnp.asarray(inp["ub"])
out = {"dtype": np.array(cm.dtype), "layout": np.array(cm.cu_layout)}
for k, a in zip(("lb", "ub"), sweep_scatter_batch(cm, lb, ub)):
    out[f"sweep/{k}"] = np.asarray(a)
for cap in (1, None):
    res = fixpoint_batch(cm, lb, ub, max_iters=cap, use_scatter=True)
    for k, a in zip(("lb", "ub", "sweeps", "converged"), res):
        out[f"{cap}/{k}"] = np.asarray(a)
np.savez(sys.argv[2], **out)
"""


def test_int64_scatter_matches_jax_x64(tmp_path):
    cm = trcpsp.build_model(scaled_rcpsp(trcpsp, **J30_X64))[0].compile(
        device="cpu")
    assert cm.dtype == "int64" and cm.cu_layout == "sparse"
    lbs, ubs = random_substores(np.random.default_rng(3), cm, 24)
    np.savez(tmp_path / "in.npz", lb=lbs, ub=ubs)
    env = dict(os.environ, JAX_ENABLE_X64="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE, str(tmp_path / "in.npz"),
         str(tmp_path / "out.npz")], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    ref = dict(np.load(tmp_path / "out.npz"))
    assert str(ref["dtype"]) == "int64" and str(ref["layout"]) == "sparse"
    lb, ub = torch.from_numpy(lbs), torch.from_numpy(ubs)
    for k, g in zip(("lb", "ub"), TF.sweep_scatter_batch(cm, lb, ub)):
        _eq(g, ref[f"sweep/{k}"], f"sweep {k}")
    for cap in (1, None):
        got = TF.fixpoint_batch(cm, lb, ub, max_iters=cap, use_scatter=True)
        for k, g in zip(("lb", "ub", "sweeps", "converged"), got):
            _eq(g, ref[f"{cap}/{k}"], f"{cap} {k}")
