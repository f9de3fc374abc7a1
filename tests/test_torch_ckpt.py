"""The port's checkpointing (`repro_torch.ckpt.checkpoint`), training
supervisor (`ft.fault_tolerance.TrainSupervisor`) and training CLI
(`launch/train.py`), on the CPU.

* A checkpoint round trip is exact (f32 params, f32 moments, the int32
  step; a bf16 leaf comes back as the same bf16 values).
* The on-disk layout is the reference's: a checkpoint written by either
  package restores in the other with every array exactly equal.
* A run killed at step 10 and resumed to 14 under `TrainSupervisor`
  equals the uninterrupted run bit for bit (params and moments).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JC
from repro_torch import configs
from repro_torch.ckpt.checkpoint import Checkpointer
from repro_torch.data.pipeline import SyntheticLM, to_device
from repro_torch.ft.fault_tolerance import (FailureInjector, Heartbeat,
                                            TrainSupervisor, restore_like)
from repro_torch.launch import train
from repro_torch.nn import layers as L
from repro_torch.nn import model as M
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import train_step

torch.set_num_threads(1)


def state(seed=0):
    rng = np.random.default_rng(seed)
    params = {"blocks/attn/wq": torch.from_numpy(
        rng.standard_normal((2, 4, 6)).astype(np.float32)),
        "final_norm": torch.from_numpy(rng.standard_normal(4).astype(
            np.float32))}
    opt = O.init_opt_state(params)
    opt["mu"]["final_norm"] += 0.25
    opt["step"] += 7
    return params, opt


def assert_tree_equal(got, ref):
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, dict):
            assert_tree_equal(got[k], v)
        else:
            g = got[k]
            g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
            v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            assert g.dtype == v.dtype and np.array_equal(g, v), k


def test_checkpoint_roundtrip_exact(tmp_path):
    params, opt = state()
    params["embed/tok"] = torch.randn(5, 4).to(torch.bfloat16)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, params, opt)
    step, p, o = ck.restore()
    assert step == 3
    assert p["embed/tok"].dtype == np.float32
    back = restore_like(params, p)
    assert back["embed/tok"].dtype == torch.bfloat16
    assert torch.equal(back["embed/tok"], params["embed/tok"])
    del params["embed/tok"], p["embed/tok"]
    assert_tree_equal(p, params)
    assert_tree_equal(o, opt)
    assert o["step"].dtype == np.int32 and o["step"].shape == ()
    assert sorted(os.listdir(tmp_path / "step_3")) == ["arrays.npz",
                                                      "manifest.json"]


def test_checkpoint_retention_and_latest(tmp_path):
    params, opt = state()
    ck = Checkpointer(str(tmp_path), keep=2)
    assert ck.latest_step() is None and ck.restore() is None
    for s in (1, 2, 3, 4):
        ck.save(s, params, opt, background=(s % 2 == 0))
    ck.wait()
    assert ck.steps() == [3, 4] and ck.latest_step() == 4
    assert (tmp_path / "LATEST").read_text() == "4"
    assert ck.restore(3)[0] == 3


def test_background_save_snapshots_before_writes(tmp_path):
    """Training may write its tensors in place right after `save`."""
    params, opt = state()
    want = params["final_norm"].clone()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params, opt, background=True)
    params["final_norm"].add_(1.0)
    ck.wait()
    assert np.array_equal(ck.restore()[1]["final_norm"], want.numpy())


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    params, opt = state()
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jo = {"mu": {k: jnp.asarray(v.numpy()) for k, v in opt["mu"].items()},
          "nu": {k: jnp.asarray(v.numpy()) for k, v in opt["nu"].items()},
          "step": jnp.asarray(opt["step"].numpy())}
    JC.Checkpointer(str(tmp_path)).save(5, jp, jo)
    step, p, o = Checkpointer(str(tmp_path)).restore()
    assert step == 5
    assert_tree_equal(p, params)
    assert_tree_equal(o, opt)
    assert_tree_equal(restore_like(opt, o), opt)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    params, opt = state(1)
    port = Checkpointer(str(tmp_path))
    port.save(9, params, opt, background=True)
    port.wait()
    ck = JC.Checkpointer(str(tmp_path))
    step, p, o = ck.restore()
    assert step == 9 and ck.latest_step() == 9
    assert_tree_equal(p, params)
    assert_tree_equal(o, opt)


def tiny_setup():
    cfg = configs.get_smoke("llama3-8b")
    data = SyntheticLM(cfg, seq_len=16, global_batch=4, seed=0)
    params = L.init_params(M.param_specs(cfg),
                           torch.Generator().manual_seed(0), "cpu",
                           dtype=torch.float32)
    ocfg = O.OptConfig(peak_lr=3e-3, warmup_steps=2, total_steps=14)

    def step_fn(params, opt_state, step):
        return train_step(params, opt_state, to_device(data.batch(step),
                                                       "cpu"),
                          cfg, ocfg, chunks=(8, 8))

    return params, step_fn


def clone(tree):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def test_kill_and_resume_bit_exact(tmp_path):
    """A run killed at step 10 and resumed must end bit-identical to an
    uninterrupted run (deterministic data + optimizer).  `train_step`
    writes its params and state in place, so each run starts from its
    own copy."""
    params, step_fn = tiny_setup()
    p_ref, o_ref = clone(params), O.init_opt_state(params)
    for s in range(14):
        p_ref, o_ref, _ = step_fn(p_ref, o_ref, s)

    ck = os.path.join(tmp_path, "ck")
    sup = TrainSupervisor(Checkpointer(ck), ckpt_every=5)
    _, _, log = sup.run(clone(params), O.init_opt_state(params), step_fn,
                        n_steps=10)
    assert len(log) == 10 and Checkpointer(ck).steps() == [5, 10]
    sup2 = TrainSupervisor(Checkpointer(ck), ckpt_every=5)
    p_res, o_res, log2 = sup2.run(clone(params), O.init_opt_state(params),
                                  step_fn, n_steps=14)
    assert len(log2) == 4
    for k in p_ref:
        assert torch.equal(p_ref[k], p_res[k]), k
        for part in ("mu", "nu"):
            assert torch.equal(o_ref[part][k], o_res[part][k]), k
    assert int(o_res["step"]) == 14 and o_res["step"].dtype == torch.int32


def test_heartbeat_failure_detection():
    t = {"now": 0.0}
    hb = Heartbeat(["h0", "h1", "h2"], timeout_s=10, clock=lambda: t["now"])
    inj = FailureInjector({3: ["h1"]})
    for step in range(6):
        t["now"] += 5.0
        inj.advance(step, hb)
    assert hb.dead_hosts() == ["h1"]


def test_supervisor_invokes_failure_path(tmp_path):
    params, step_fn = tiny_setup()

    def supervisor():
        t = {"now": 0.0}
        hb = Heartbeat(["h0", "h1"], timeout_s=1, clock=lambda: t["now"])
        inj = FailureInjector({2: ["h1"]})

        def fn(p, o, s):
            t["now"] += 1.0
            return step_fn(p, o, s)

        return TrainSupervisor(Checkpointer(str(tmp_path)), ckpt_every=100,
                               heartbeat=hb, injector=inj), fn

    seen = {}
    sup, fn = supervisor()
    out = sup.run(clone(params), O.init_opt_state(params), fn, n_steps=10,
                  on_failure=lambda dead, step, log: seen.update(
                      dead=dead, step=step, n=len(log)) or "failed")
    assert out == "failed" and seen["dead"] == ["h1"]
    assert seen["step"] == seen["n"] and 2 <= seen["step"] < 10
    sup, fn = supervisor()
    with pytest.raises(RuntimeError, match="hosts lost"):
        sup.run(clone(params), O.init_opt_state(params), fn, n_steps=10)


def test_restore_like_keeps_dtype_and_device():
    like = {"a": torch.zeros(3, dtype=torch.bfloat16),
            "b": {"c": torch.zeros((), dtype=torch.int32)}}
    got = restore_like(like, {"a": np.array([1.5, 2.0, 3.0], np.float32),
                              "b": {"c": np.array(4, np.int64)}})
    assert got["a"].dtype == torch.bfloat16 and got["a"].tolist() == [1.5,
                                                                     2.0,
                                                                     3.0]
    assert got["b"]["c"].dtype == torch.int32 and int(got["b"]["c"]) == 4
    assert got["a"].device == like["a"].device


def test_train_cli_runs_and_resumes_on_cpu(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    argv = ["--arch", "llama3-8b", "--smoke", "--device", "cpu", "--seq",
            "16", "--global-batch", "2", "--ckpt-dir", ck, "--ckpt-every",
            "2", "--log-every", "1"]
    recs = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert out.startswith("arch=llama3-smoke params=")
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert "step     2 loss" in out and "done in" in out
    assert Checkpointer(ck).steps() == [2, 3]
    for r in recs:
        assert np.isfinite(r["loss"]) and r["grad_norm"] > 0
        assert r["ms"] > 0 and r["tokens_per_s"] > 0 and r["peak_gb"] == 0
    recs = train.main(argv + ["--steps", "5", "--profile"])
    assert [r["step"] for r in recs] == [3, 4]
    assert Checkpointer(ck).latest_step() == 5
    out = capsys.readouterr().out
    assert "step     4 loss" in out
    assert "profile train step 5: device busy 0.0 ms" in out


def test_train_cli_refuses_several_devices():
    with pytest.raises(NotImplementedError, match="9.3"):
        train.main(["--smoke", "--device", "cpu", "--devices", "2"])


def test_train_cli_defaults_minicpm_to_wsd(monkeypatch):
    seen = {}

    def build(arch, smoke, seq, gb, ocfg, **kw):
        seen["schedule"] = ocfg.schedule
        raise SystemExit

    monkeypatch.setattr(train, "build", build)
    for arch, want in (("minicpm-2b", "wsd"), ("llama3-8b", "cosine")):
        with pytest.raises(SystemExit):
            train.main(["--arch", arch, "--smoke", "--device", "cpu"])
        assert seen["schedule"] == want
