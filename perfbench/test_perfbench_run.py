"""Whole runs of the harness on the CPU at a size a test run holds: sound
runs come out correct; the control (the program's truncated fixpoint)
and each fault the cells can have come out not correct; the process
loads no JAX; the command refuses to run without a card or outside a
checkout."""

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402

CELLS = ["j60-deadline", "j120-first"]


def tiny(cell: str, **traffic) -> dict:
    """The cell at 16 jobs, 8 lanes and a pool of 16 (NC 1.5: a network
    that 16 jobs can hold), one deadline instance with the whole 3 s
    window and a drawn one with 3 s after it, every other setting as the
    cell states."""
    spec = copy.deepcopy(harness.cell_spec(cell))
    spec["config"]["n_jobs"] = 16
    spec["config"]["grid"]["NC"] = [1.5]
    spec["config"]["solver"].update(n_lanes=8, eps_target=16)
    share = spec["traffic"]["deadline"] == "share"
    spec["traffic"].update(set_size=1 if share else 3, min_budget_s=0.5,
                           late_s=20, warm_timeout_s=2,
                           check_drawn_s=3 if share else 20)
    spec["traffic"].update(traffic)
    return spec


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the test workers share the CPU, and spinning
    thread pools of several workers slow a launch by tens of times."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(spec, seed=2**31 + 17):
    return harness.run_cell(spec, seed, 3.0, False, device="cpu",
                            log=lambda msg: None)


def values(out):
    return {k: v["value"] for k, v in out["checks"].items()}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(tiny(cell))
    assert out["correct"], values(out)
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    e2e = {m["name"] for m in harness.cell_spec(cell)["e2e"]}
    assert set(out["metrics"]) == e2e


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_rejected(cell):
    """The program's own lower-precision path, the truncated fixpoint of
    the ``fast`` preset, fails the replay of the search."""
    out = run(tiny(cell, max_fixpoint_iters=4))
    assert not out["correct"]
    assert values(out)["replay_lanes_bad"] > 0


@pytest.mark.parametrize("iters", [None, 4])
def test_the_cuda_backend_is_replayed_by_superstep(iters):
    """A cell on the ``cuda`` backend (the worked example of the README)
    needs no new code: its quanta are single supersteps, replayed the
    same way; the control fails there too."""
    spec = tiny("j60-deadline", replay_launch_span=40,
                **({"max_fixpoint_iters": iters} if iters else {}))
    spec["config"]["solver"].update(backend="cuda",
                                    supersteps_per_launch=None)
    out = run(spec)
    assert out["correct"] == (iters is None), values(out)
    assert values(out)["unchecked"] == 0


def _unchanged(FK, E, mp):
    def launch(cm, subs_lb, subs_ub, st, gbest, it, pool_head, *,
               supersteps=16, **kw):
        return (st, gbest, torch.tensor(int(it) + supersteps,
                                        dtype=torch.int32),
                pool_head, torch.tensor(False))
    launch.launches = launch.slot_launches = 0
    mp.setattr(FK, "search_cuda", launch)


def _half_pool(FK, E, mp):
    decompose = E.decompose

    def half(cm, target, opts=None):
        lb, ub = decompose(cm, target, opts)
        return lb[:(len(lb) + 1) // 2], ub[:(len(ub) + 1) // 2]
    mp.setattr(E, "decompose", half)


def _altered(FK, E, mp):
    search = FK.search_cuda

    def launch(*a, **kw):
        st, g, it, h, stop = search(*a, **kw)
        sol = st.best_sol.clone()
        sol[:, 1] += 1                    # the first start of every incumbent
        return st._replace(best_sol=sol), g, it, h, stop
    launch.launches = launch.slot_launches = 0
    mp.setattr(FK, "search_cuda", launch)


@pytest.mark.parametrize("fault", [_unchanged, _half_pool, _altered],
                         ids=["state_unchanged", "half_the_pool",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault, monkeypatch):
    from repro_torch.core import eps as E
    from repro_torch.kernels import fixpoint_kernel as FK
    fault(FK, E, monkeypatch)
    out = run(tiny(cell))
    assert not out["correct"], values(out)
    assert out["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_a_wrong_answer_on_a_drawn_instance_is_caught(cell, monkeypatch):
    """The instances drawn from the seed are judged like the window's: a
    fault that shows only on them fails the run."""
    spec = tiny(cell)
    drawn = {i.name for i in harness.drawn_instances(
        spec["config"], spec["traffic"], 2**31 + 17)}
    problem_of = harness.problem_of

    def wrapped(config):
        P = problem_of(config)
        ok = P.answer_ok

        def answer_ok(inst, res, cols):
            return "planted" if inst.name in drawn else ok(inst, res, cols)
        P.answer_ok = answer_ok
        return P
    monkeypatch.setattr(harness, "problem_of", wrapped)
    out = run(spec)
    assert not out["correct"]
    assert values(out)["schedules_bad"] == 1 and out["failed"] == 1


def _script(tmp_path, body):
    path = tmp_path / "probe.py"
    path.write_text(body)
    return subprocess.run([sys.executable, str(path)], capture_output=True,
                          text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    """What a run imports, compared by whole top-level names."""
    res = _script(tmp_path, f"""
import sys
sys.path[:0] = [{str(HERE)!r}, {str(HERE.parent / 'src')!r}]
import test_perfbench_run as T
import run as R
T.torch.set_num_threads(1)
out = T.run(T.tiny("j60-deadline"))
assert out["correct"], out
for name in [m["name"] for m in T.harness.benchmark()["per_layer"]]:
    T.harness.load_metric(name)
print(R.forbidden_modules(), "repro_torch" in sys.modules)
""")
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_are_compared_whole():
    import run as R
    assert R.forbidden_modules(["repro_torch", "repro_torch.core",
                                "reprox", "numpy"]) == []
    assert R.forbidden_modules(["repro.core", "jaxlib.xla", "flax",
                                "jax"]) == ["flax", "jax", "jaxlib", "repro"]


def _command(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "j60-deadline",
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600)


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    res = _command(HERE.parent)
    assert res.returncode != 0 and not res.stdout.strip()


def test_command_refuses_with_only_the_benchmark(tmp_path):
    shutil.copy(HERE.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _command(tmp_path)
    assert res.returncode != 0 and not res.stdout.strip()
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())
