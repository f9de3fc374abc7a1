"""The reader of ``eps_hit`` (``metrics/eps_hit.py``): the splits EPS's
rule took over those its batches propagated, summed over the window's
solves, on synthetic runs; nothing from a program that keeps no such
counts or from solves outside the window; and a number between 0 and
100 % from the program itself, on the CPU cell of
``test_perfbench_run.py``."""

import sys
from pathlib import Path
from types import SimpleNamespace as NS

import pytest

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import harness  # noqa: E402

read = harness.load_metric("eps_hit").read


def _run(*solves):
    """A run of one window [0, 10] s over solves ``(t_done, tallies)``;
    tallies None is a program's trace without them, "none" no trace."""
    out = []
    for k, (t_done, tallies) in enumerate(solves):
        trace = (None if tallies == "none" else
                 NS(phases={}) if tallies is None else
                 NS(phases={}, tallies=tallies))
        out.append(harness.Solve(k=k, inst=None, t_start=0.0, t_done=t_done,
                                 result=NS(trace=trace)))
    return harness.Run(cell={}, config={"solver": {}}, traffic={},
                       seconds=10.0, setup_s=1.0, t0=0.0, t_end=10.0,
                       solves=out)


def test_the_share_is_summed_over_the_windows_solves():
    run = _run((2.0, {"eps.splits": 30, "eps.spec": 100}),
               (5.0, {"eps.splits": 10, "eps.spec": 60}),
               (11.0, {"eps.splits": 1, "eps.spec": 1000}))   # too late
    assert read(run) == pytest.approx(100.0 * 40 / 160)


@pytest.mark.parametrize("solves", [
    (),
    ((2.0, None), (3.0, None)),            # an older program: no counts
    ((2.0, "none"),),                      # no trace at all
    ((2.0, {"eps.splits": 0, "eps.spec": 0}),),   # a failed root
    ((12.0, {"eps.splits": 3, "eps.spec": 4}),)])  # outside the window
def test_nothing_to_read_gives_nothing(solves):
    assert read(_run(*solves)) is None


def test_the_reader_reads_the_cpu_cell():
    """The j120-first cell at 16 jobs, 8 lanes and a pool of 16 on the
    CPU (`test_perfbench_run.tiny`), untraced: the program's own counts
    give a share in (0, 100]."""
    import test_perfbench_run as T
    threads = T.torch.get_num_threads()
    spec = T.tiny("j120-first")
    spec["e2e"] = spec["e2e"] + [{"name": "eps_hit", "unit": "%"}]
    T.torch.set_num_threads(1)          # as test_perfbench_run's fixture
    try:
        out = T.run(spec)
    finally:
        T.torch.set_num_threads(threads)
    assert out["correct"], out["checks"]
    assert 0 < out["metrics"]["eps_hit"]["value"] <= 100
