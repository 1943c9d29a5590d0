"""The check that decides `correct`, driven through a whole run of each
cell on the CPU at a small n (the look for a card skipped): sound runs of
the port pass, and the control and the faults the cells can have fail.

The cells have no batch to halve and no exchange between chips, so of
the faults a run can have these two apply: a solve that returns its state
unchanged, and an answer altered where it is produced.
"""

import time

import pytest

from cgbench import control, harness

SPEC = harness.load_spec()
CELLS = [c["name"] for c in SPEC["workloads"]]
N = 300


def _cell(name):
    cell, cfg, traffic = harness.find_cell(SPEC, name)
    cfg["n"], traffic["rhs_pool"] = N, 6
    return cell, cfg, traffic


def _run(name, seed, solver_cls=harness.ProgramSolver, seconds=0.2):
    cell, cfg, traffic = _cell(name)
    return harness.run_cell(cell, cfg, traffic, seed, seconds, False, "cpu",
                            time.perf_counter(), solver_cls=solver_cls)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    run = _run(name, 2**31 + 21)
    assert harness.check.correct(run.checks), run.checks
    assert run.failed == 0 and run.attempted == len(run.solve_times) >= 1
    assert run.checks["true_rel_residual"][0] < 2e-9


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    run = _run(name, 2**31 + 22, solver_cls=control.ReferenceSolver)
    value, limit = run.checks["true_rel_residual"]
    assert not harness.check.correct(run.checks)
    assert value > 100 * limit and run.failed == run.attempted


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_returns_its_state_unchanged_is_caught(name,
                                                           monkeypatch):
    from lam_tpu_torch.solver import cg as cg_mod
    monkeypatch.setattr(cg_mod, "_cg_run", lambda mv, state, *a, **k: state)
    run = _run(name, 2**31 + 23, seconds=0.0)
    assert not harness.check.correct(run.checks)
    assert run.failed == run.attempted


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(name, monkeypatch):
    from lam_tpu_torch.solver import api

    def altered(solve):
        def inner(*a, **k):
            res = solve(*a, **k)
            x = res.x.clone()
            x[x.shape[0] // 2] += 1e-6 * float(x.abs().max())
            return res._replace(x=x)
        return inner

    monkeypatch.setattr(api, "cg_solve", altered(api.cg_solve))
    monkeypatch.setattr(api, "cg_solve_ir", altered(api.cg_solve_ir))
    run = _run(name, 2**31 + 24, seconds=0.0)
    assert not harness.check.correct(run.checks)
    assert run.checks["true_rel_residual"][0] > 2e-9


def test_the_same_seed_judges_the_same_answers():
    a = _run("spd40k.ir", 2**31 + 25, seconds=0.0)
    b = _run("spd40k.ir", 2**31 + 25, seconds=0.0)
    assert a.iters == b.iters and a.checks == b.checks
