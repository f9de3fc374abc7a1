"""The port's examples (``examples/torch_*.py``) run end to end on the
CPU (``--device cpu``, tiny sizes) in subprocesses, and fail without a
usable GPU when the CPU is not asked for.  ``test_torch_solve.py``
checks that they import neither JAX nor the JAX package."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=600)


def test_quickstart_on_cpu():
    r = _run("examples/torch_quickstart.py", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "== sequential chaotic iteration: True" in out
    assert ("backends ('cuda', 'cuda_resident', 'gather', 'scatter') agree "
            "on the batched fixpoint: True") in out
    assert "status=OPTIMAL makespan=9" in out and "second solve:" in out


def test_rcpsp_solve_on_cpu():
    r = _run("examples/torch_rcpsp_solve.py", "--n", "5", "--count", "2",
             "--lanes", "4", "--subs", "8", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 3, r.stdout
    for line in lines[:2]:
        assert "turbo-torch: OPTIMAL" in line and "seq: OPTIMAL" in line
        assert "ground-check OK" in line and "launches=0+0" in line
    assert lines[2].startswith("suite: 2 instances, engine (cuda_resident")


@pytest.mark.parametrize("args", [
    ("--model", "nqueens", "--backend", "scatter"),
    ("--model", "knapsack", "--many", "3", "--backend", "cuda_resident"),
], ids=["nqueens scatter", "knapsack many"])
def test_model_zoo_on_cpu(args):
    r = _run("examples/torch_model_zoo.py", "--device", "cpu", *args)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OPTIMAL" in r.stdout and "FAIL" not in r.stdout
    assert "ground-check OK" in r.stdout


def test_train_lm_on_cpu(tmp_path):
    """The 25m preset for 2 steps (short sequences), then a second run
    that finds the finished checkpoint."""
    args = ("examples/torch_train_lm.py", "--preset", "25m", "--steps", "2",
            "--seq", "32", "--global-batch", "2", "--device", "cpu",
            "--ckpt-dir", str(tmp_path))
    r = _run(*args)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0].startswith("model llama-25m: ") and "M params" in lines[0]
    assert lines[1].startswith("step    0  loss") and "tok/s" in lines[1]
    assert lines[-1].startswith("done in") and "(uniform = 9.704)" in lines[-1]
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_2"]
    again = _run(*args)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "nothing to do" in again.stdout


@pytest.mark.parametrize("script", ["torch_quickstart.py",
                                    "torch_rcpsp_solve.py",
                                    "torch_model_zoo.py",
                                    "torch_planner_demo.py",
                                    "torch_train_lm.py"])
def test_examples_without_gpu_fail(script):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    r = _run(f"examples/{script}")
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr
