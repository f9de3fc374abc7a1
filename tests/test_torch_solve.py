"""The port's solver (`repro_torch.solver`) end to end against JAX.

`Solver.solve` on the CPU against the JAX package's `Solver.solve`
(``backend="gather"``) on RCPSP small, bench and J30 class under the
``prove``, ``fast`` and ``first_solution`` presets: status, objective
and every counter are equal, and the solution passes the ground check.
Also: the entry points run on the GPU unless asked for the CPU (and
raise without one), the CLI runs with ``--device cpu``, and neither the
package nor ``chip_smoke.py`` imports JAX or the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import solver as jsolver
from repro.core.models import rcpsp as jrcpsp
from repro_torch import solver as tsolver
from repro_torch.core import compile as TC
from repro_torch.core import device as tdevice
from repro_torch.core.models import rcpsp as trcpsp
from test_torch_compile import bench, j30, small

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

COUNTERS = ("status", "objective", "n_nodes", "n_fails", "n_sols",
            "n_sweeps", "n_supersteps", "complete")
TIERS = {"small": (small(0), 16), "bench": (bench(1), 16),
         "j30": (j30(0), chip_smoke.J30_LANES)}


@pytest.fixture(scope="module")
def jax_session():
    return jsolver.Solver()


@pytest.mark.parametrize("preset", ["prove", "fast", "first_solution"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_solve_matches_jax(jax_session, tier, preset):
    kw, lanes = TIERS[tier]
    jinst = jrcpsp.generate(**kw)
    jm, _ = jrcpsp.build_model(jinst)
    ref = jax_session.solve(jm.compile(), config=jsolver.SolveConfig.preset(
        preset, n_lanes=lanes, backend="gather"))

    inst = trcpsp.generate(**kw)
    m, handles = trcpsp.build_model(inst)
    cfg = tsolver.SolveConfig.preset(preset, n_lanes=lanes, device="cpu")
    assert cfg.backend == "cuda"           # the port's default backend
    got = tsolver.Solver(cfg).solve(m.compile(device="cpu"))
    for k in COUNTERS:
        assert getattr(got, k) == getattr(ref, k), k
    np.testing.assert_array_equal(got.solution, ref.solution)
    starts = [int(got.solution[v.idx]) for v in handles["s"]]
    assert trcpsp.check_solution(inst, starts) == (True, got.objective)
    assert [i.objective for i in got.improvements] == \
        [i.objective for i in ref.improvements]
    assert 0 <= got.eps_s <= got.wall_s
    if tier == "j30" and preset == "prove":
        # the reference numbers chip_smoke.py holds the card's run to
        assert {k: getattr(got, k) for k in chip_smoke.J30_REFERENCE} == \
            chip_smoke.J30_REFERENCE


def test_solve_iter_budgets_and_gather_backend():
    m, _ = trcpsp.build_model(trcpsp.generate(**bench(2)))
    cm = m.compile(device="cpu")
    cfg = tsolver.SolveConfig.preset("prove", n_lanes=8, chunk=2,
                                     device="cpu")
    full = tsolver.Solver(cfg).solve(cm, backend="gather")
    assert full.status == tsolver.OPTIMAL
    events = list(tsolver.Solver(cfg).solve_iter(cm))
    assert events[-1].final and not any(e.final for e in events[:-1])
    assert [e.superstep for e in events[:-1]] == \
        list(range(2, 2 * len(events) - 1, 2))
    assert events[-1].result.n_nodes == full.n_nodes
    capped = tsolver.Solver(cfg).solve(cm, max_supersteps=3)
    assert capped.n_supersteps == 4 and not capped.complete
    assert capped.status in (tsolver.SAT, tsolver.UNKNOWN)


def test_config_validation():
    with pytest.raises(ValueError, match="unknown backend"):
        tsolver.SolveConfig(backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="n_lanes"):
        tsolver.SolveConfig(n_lanes=0, device="cpu")
    cfg = tsolver.SolveConfig(val_strategy="middle_out", device="cpu")
    assert cfg.search_options().val_strategy == "middle_out"
    with pytest.raises(ValueError, match="val_strategy"):
        tsolver.SolveConfig(val_strategy="middle", device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tsolver.SolveConfig(device="mps")
    cfg = tsolver.SolveConfig.preset("fast", n_lanes=4, device="cpu")
    assert cfg.max_fixpoint_iters == 4 and cfg.preset_name == "fast"
    assert cfg.replace(n_lanes=8).preset_name is None


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsolver.SolveConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsolver.Solver()
    m, _ = trcpsp.build_model(trcpsp.generate(**small(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        m.compile()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device(None)
    cm = m.compile(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cm.to("cuda")
    assert TC.from_arrays(*TC.to_arrays(cm), "cpu").device.type == "cpu"


def _run(args, cwd=ROOT, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    env.pop("CUDA_VISIBLE_DEVICES", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=600)


def test_cli_runs_on_cpu_when_asked():
    r = _run(["-m", "repro_torch.launch.solve", "--n", "5", "--lanes", "4",
              "--device", "cpu"])
    assert r.returncode == 0, r.stderr[-2000:]
    last = r.stdout.strip().splitlines()[-1]
    assert "OPTIMAL objective=13" in last and "ground_check=OK" in last
    assert "kernel_launches=0" in last


def test_cli_profile_report(capsys):
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType
    from repro_torch.launch import solve as cli
    dev, host = DeviceType.CUDA, DeviceType.CPU
    events = [NS(key="fixpoint_kernel", count=4, self_device_time_total=800,
                 device_type=dev),
              NS(key="elementwise_kernel", count=10,
                 self_device_time_total=200, device_type=dev),
              NS(key="aten::where", count=10, self_device_time_total=200,
                 device_type=host)]
    cli._profile_report(NS(key_averages=lambda: events), 0.01, "search")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("profile search: device busy 1.0 ms of 10.0 ms wall "
                      "(10.0%), 14 device ops")
    assert "fixpoint_kernel" in out[1] and "elementwise_kernel" in out[2]
    assert len(out) == 3


def test_cli_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is usable")
    r = _run(["-m", "repro_torch.launch.solve", "--n", "5"])
    assert r.returncode != 0
    assert "torch.cuda.is_available() is False" in r.stderr


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print('LOADED', len(sys.modules), 'BAD', bad)\n")
    r = _run(["-c", code])
    assert r.returncode == 0, r.stderr[-2000:]
    assert "BAD []" in r.stdout, r.stdout


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    r = _run([os.path.join(ROOT, "chip_smoke.py")])
    assert r.returncode != 0 and '"ok"' not in r.stdout
    assert "torch.cuda.is_available() is False" in r.stderr
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
    r = _run([str(alone)], cwd=str(tmp_path), env_extra={"PYTHONPATH": ""})
    assert r.returncode != 0 and '"ok"' not in r.stdout
    assert "cannot import the port" in r.stderr
