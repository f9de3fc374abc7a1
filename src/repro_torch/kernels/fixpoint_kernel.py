"""The propagation fixpoint kernel for Hopper and its wrapper.

`fixpoint_cuda` replaces the Pallas TPU kernel ``fixpoint_pallas``
(``src/repro/kernels/fixpoint_kernel.py``).  The kernel source is
``csrc/fixpoint.cu``: one CTA per lane, both stores double-buffered in
shared memory, the sweep loop driven by ``__syncthreads_or`` on the
per-lane rule of the reference (changed ∧ it < max_sweeps ∧ ¬failed).
It covers the ReifLinLe bank and the dense Cumulative bank — everything
RCPSP lowers to.

On a CPU tensor the wrapper runs the plain version
(`repro_torch.core.fixpoint.fixpoint_batch`); on a CUDA tensor it
launches the kernel or raises (unsupported bank, int64 model, wrong
dtype/shape/device, failed build, refused launch).  It never falls back.

`fixpoint_cuda.launches` counts kernel launches (and nothing else), so a
run can show that the main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import fixpoint as F

# shared memory one H100 block may use (232,448 bytes = 227 KB)
SMEM_LIMIT_BYTES = 227 * 1024
UNCAPPED = 2 ** 31 - 1


def smem_budget(cm) -> dict:
    """Shared-memory bytes of one CTA (one lane), by part — the formula
    of ``fixpoint_smem_bytes`` in ``csrc/fixpoint.cu``:

    * ``stores``     — current and next lb/ub, ``4·V`` int32;
    * ``linear``     — the ``[P+1, K+1]`` candidate pair;
    * ``cumulative`` — the ``[C+1, horizon]`` profile, the ``[C+1, T]``
      candidate pair, the staged task table and per-row flags.
    """
    P1, K = cm.vidx.shape
    C1, T = cm.cu_svar.shape
    stores = 4 * cm.n_vars * 4
    linear = 2 * P1 * (K + 1) * 4
    cumulative = (C1 * cm.horizon + 5 * C1 * T + 2 * C1) * 4
    return dict(stores=stores, linear=linear, cumulative=cumulative,
                total=stores + linear + cumulative)


def fit_smem(cm, limit_bytes: int = SMEM_LIMIT_BYTES) -> dict:
    """The budget of `smem_budget`, or a clear ``ValueError`` when one
    lane does not fit a block.  (The reference halves its lane tile
    before it gives up; a CTA here holds exactly one lane, so there is
    nothing to halve.)"""
    b = smem_budget(cm)
    if b["total"] > limit_bytes:
        raise ValueError(
            f"fixpoint_cuda: model {cm.name or '<unnamed>'} needs "
            f"{b['total']:,} bytes of shared memory per lane (stores "
            f"{b['stores']:,}, linear candidates {b['linear']:,}, "
            f"cumulative {b['cumulative']:,}) > {limit_bytes:,} per H100 "
            "block; shrink the horizon or the linear bank, or use the "
            "gather backend")
    return b


def _lib():
    from repro_torch.kernels.build import load
    lib = load("fixpoint")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.fixpoint_launch.argtypes = [ptr] * 20 + [i32] * 11 + [ptr]
        lib.fixpoint_launch.restype = i32
        lib.fixpoint_error_string.argtypes = [i32]
        lib.fixpoint_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(cm, lb, ub):
    F.check_supported(**F.model_statics(cm))
    if cm.dtype != "int32":
        raise NotImplementedError(
            f"fixpoint_cuda: model {cm.name or '<unnamed>'} compiled to "
            f"{cm.dtype}; the kernel is int32-only")
    if lb.dtype != torch.int32 or ub.dtype != torch.int32:
        raise TypeError(f"fixpoint_cuda: stores must be int32, got "
                        f"{lb.dtype}/{ub.dtype}")
    if lb.dim() != 2 or lb.shape != ub.shape or lb.shape[1] != cm.n_vars:
        raise ValueError(f"fixpoint_cuda: stores must be [L, {cm.n_vars}], "
                         f"got {tuple(lb.shape)}/{tuple(ub.shape)}")
    if not (lb.is_contiguous() and ub.is_contiguous()):
        raise ValueError("fixpoint_cuda: stores must be contiguous")
    if lb.device != ub.device or cm.device != lb.device:
        raise ValueError(f"fixpoint_cuda: stores on {lb.device}/{ub.device}"
                         f", model tables on {cm.device}")


def fixpoint_cuda(cm, lb, ub, *, max_sweeps=None):
    """Run every lane of ``[L, V]`` stores to its fixed point.

    Returns (lb', ub', sweeps i32[L], converged bool[L]), equal to
    `fixpoint_batch(cm, lb, ub, max_iters=max_sweeps)`.  ``max_sweeps``
    None is uncapped.
    """
    if lb.device.type == "cpu":
        return F.fixpoint_batch(cm, lb, ub, max_iters=max_sweeps)
    if lb.device.type != "cuda":
        raise ValueError(f"fixpoint_cuda: unsupported device {lb.device}")
    _check(cm, lb, ub)
    fit_smem(cm)
    L, V = lb.shape
    lb_out, ub_out = torch.empty_like(lb), torch.empty_like(ub)
    sweeps = torch.empty(L, dtype=torch.int32, device=lb.device)
    conv = torch.empty(L, dtype=torch.int32, device=lb.device)
    if L == 0:
        return lb_out, ub_out, sweeps, conv.bool()
    cap = UNCAPPED if max_sweeps is None else int(max_sweeps)
    if cap < 0:
        raise ValueError(f"fixpoint_cuda: max_sweeps must be >= 0, got {cap}")
    P1, K = cm.vidx.shape
    C1, T = cm.cu_svar.shape
    lib = _lib()
    err = lib.fixpoint_launch(
        cm.vidx.data_ptr(), cm.coef.data_ptr(), cm.rhs.data_ptr(),
        cm.bidx.data_ptr(), cm.occ_prop.data_ptr(), cm.occ_slot.data_ptr(),
        cm.cu_svar.data_ptr(), cm.cu_dur.data_ptr(), cm.cu_dem.data_ptr(),
        cm.cu_cap.data_ptr(), cm.cu_occ_inst.data_ptr(),
        cm.cu_occ_pos.data_ptr(), cm.box_lo.data_ptr(),
        cm.box_hi.data_ptr(), lb.data_ptr(), ub.data_ptr(),
        lb_out.data_ptr(), ub_out.data_ptr(), sweeps.data_ptr(),
        conv.data_ptr(), L, V, P1, K, cm.occ_prop.shape[1], C1, T,
        cm.cu_occ_inst.shape[1], cm.horizon, cm.n_cumulative, cap,
        torch.cuda.current_stream(lb.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            "fixpoint_cuda: launch failed: "
            + lib.fixpoint_error_string(err).decode())
    fixpoint_cuda.launches += 1
    return lb_out, ub_out, sweeps, conv.bool()


fixpoint_cuda.launches = 0
