"""Checkpointing (the port of ``repro/ckpt/checkpoint.py``): atomic,
async-capable, resumable, with retention.

Layout, the reference's:  <dir>/step_<N>/arrays.npz + manifest.json, plus
<dir>/LATEST written via atomic rename only after the payload is fully
written, so a crash mid-save never corrupts the restore point.  Tree
paths are flattened with ``||`` (``params||blocks/attn/wq``,
``opt||mu||…``, ``opt||step``), so a checkpoint written by either package
restores in the other.

`save` copies every leaf to host numpy synchronously (a bf16 leaf is
widened to f32, which numpy can hold; the restore casts it back), so
training may write its tensors in place at once; with
``background=True`` the files are written on a worker thread.  Every
save first waits for a pending background write (the reference's
foreground save does not, and two writes then race on ``LATEST``).  `restore`
returns numpy trees; `ft.fault_tolerance.TrainSupervisor` puts each leaf
back at the dtype and device of the leaf it replaces.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

_FLAT_SEP = "||"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_FLAT_SEP}"))
    else:
        out[prefix[:-len(_FLAT_SEP)]] = tree
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict = {}
    for k, v in flat.items():
        parts = k.split(_FLAT_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _host(v) -> np.ndarray:
    """A copy of a leaf as a host numpy array (bf16 widened to f32): the
    caller may write the tensor in place while the copy is written."""
    if isinstance(v, torch.Tensor):
        dtype = torch.float32 if v.dtype == torch.bfloat16 else v.dtype
        return v.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(v)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, params, opt_state, extra: Optional[Dict] = None,
             background: bool = False):
        flat = _flatten({"params": params, "opt": opt_state})
        host = {k: _host(v) for k, v in flat.items()}
        meta = {"step": int(step), "time": time.time(),
                "extra": extra or {}}
        # one write at a time: a save waits for a pending background one
        # (two writes race on LATEST, and the older could publish last)
        self.wait()
        if background:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: Dict, meta: Dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                      # atomic publish
        latest_tmp = os.path.join(self.dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.rename(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def steps(self):
        return sorted(int(n.split("_")[1]) for n in os.listdir(self.dir)
                      if n.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            s = int(f.read().strip())
        return s if s in self.steps() else (self.steps() or [None])[-1]

    def restore(self, step: Optional[int] = None
                ) -> Optional[Tuple[int, Dict, Dict]]:
        """(step, params, opt_state) as numpy trees, of `step` or the
        latest; None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        self.wait()
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        tree = _unflatten(flat)
        return step, tree["params"], tree["opt"]
