"""The port's host tools against lam_tpu's (CPU): `oracle_cg`,
`lam-spd-gen-torch`, `entry` and the multi-rank dry run.

`lam_tpu_torch.solver.oracle.oracle_cg` bit for bit lam_tpu's; the
generator's files byte-equal to lam_tpu's `lam-spd-gen` and its stdout and
error paths line for line; `dryrun.entry(device="cpu")` against
`__graft_entry__.entry()` under jax.jit and against `oracle_cg`; and
`dryrun_multichip(4, device="cpu")`, four gloo rank processes, every leg
held to lam_tpu's oracle and every leg's plain-version calls to the
kernels it launches on the card.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from lam_tpu.solver.oracle import oracle_cg as lam_oracle_cg
from lam_tpu.tools import spd_gen as lam_spd_gen
from lam_tpu_torch import dryrun
from lam_tpu_torch import generate as gen
from lam_tpu_torch.solver import oracle_cg
from lam_tpu_torch.tools import spd_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# entry's x after 20 df64 iterations: 9.4e-16 relative from lam_tpu's
# (interpret-mode df64 kernel), 1.6e-16 from the f64 oracle's (measured)
ENTRY_TOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_modules_import_without_jax_or_lam_tpu():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'lam_tpu'):\n"
            "    sys.modules[name] = None  # any import of them raises\n"
            "import lam_tpu_torch.solver.oracle, lam_tpu_torch.tools.spd_gen\n"
            "import lam_tpu_torch.dryrun\n"
            "from lam_tpu_torch.solver import oracle_cg\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- oracle_cg ----------------------------------------------------------------

@pytest.mark.parametrize("max_iters,converged", [(1000, True), (15, False)])
def test_oracle_cg_is_lam_tpus_bit_for_bit(max_iters, converged):
    a, b = gen.random_spd_system(200, seed=3)
    x, k, rel, ok = oracle_cg(a, b, max_iters=max_iters)
    xj, kj, relj, okj = lam_oracle_cg(a, b, max_iters=max_iters)
    assert ok is okj is converged
    assert k == kj and (k < max_iters) == converged
    assert rel == relj
    assert x.dtype == xj.dtype and np.array_equal(x, xj)


# -- lam-spd-gen-torch --------------------------------------------------------

def _run_both(tmp_path, monkeypatch, capsys, argv):
    """Run lam_tpu's tool and the port's with the same argv, each in a
    directory of its own; returns {package: (rc, stdout, stderr, dir)}."""
    out = {}
    for name, tool in (("lam_tpu", lam_spd_gen), ("port", spd_gen)):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        rc = tool.main(list(argv))
        got = capsys.readouterr()
        out[name] = (rc, got.out, got.err, d)
    return out


@pytest.mark.parametrize("argv", [["48", "m.bin", "r.bin", "7"],
                                  ["300", "m.bin", "r.bin", "5", "--fast"]])
def test_spd_gen_files_and_stdout_match_lam_tpu(tmp_path, monkeypatch,
                                                 capsys, argv):
    runs = _run_both(tmp_path, monkeypatch, capsys, argv)
    rc, out, err, d = runs["port"]
    rcj, outj, errj, dj = runs["lam_tpu"]
    assert rc == rcj == 0 and err == errj == ""
    assert out.splitlines() == outj.splitlines()
    assert out.splitlines()[-1] == "Finished successfully"
    for f in ("m.bin", "r.bin"):
        assert (d / f).read_bytes() == (dj / f).read_bytes()


@pytest.mark.parametrize("size,extra,fast", [(4096, [], False),
                                             (4097, [], True),
                                             (10, ["--fast"], True),
                                             (10, [], False)])
def test_spd_gen_fast_switch(tmp_path, monkeypatch, capsys, size, extra,
                             fast):
    seen = []

    def spy(n, seed=0, fast=None, dtype=np.float64):
        seen.append((n, fast))
        return np.eye(2), np.ones(2)

    monkeypatch.setattr(gen, "random_spd_system", spy)
    rc = spd_gen.main([str(size), str(tmp_path / "m.bin"),
                       str(tmp_path / "r.bin"), "1", *extra])
    capsys.readouterr()
    assert rc == 0 and seen == [(size, fast)]


def test_spd_gen_wrong_size(tmp_path, monkeypatch, capsys):
    runs = _run_both(tmp_path, monkeypatch, capsys,
                     ["-5", "m.bin", "r.bin", "1"])
    assert runs["port"][:3] == runs["lam_tpu"][:3]
    rc, out, err, d = runs["port"]
    assert rc == 1 and out == "" and err == "Wrong argument value\n"
    assert not (d / "m.bin").exists()


def test_spd_gen_io_error_is_one_line(tmp_path, monkeypatch, capsys):
    (tmp_path / "plain").write_text("a regular file")
    bad = str(tmp_path / "plain" / "m.bin")
    runs = _run_both(tmp_path, monkeypatch, capsys,
                     ["8", bad, "r.bin", "1"])
    assert runs["port"][:3] == runs["lam_tpu"][:3]
    rc, out, err, _ = runs["port"]
    assert rc == 1
    assert len(err.splitlines()) == 1 and err.startswith("lam-spd-gen: ")
    assert "Traceback" not in err
    assert out.splitlines()[-1] == "Writing matrix to file ..."


def test_spd_gen_script_is_registered():
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    assert ('lam-spd-gen-torch = "lam_tpu_torch.tools.spd_gen:main"'
            in text)


# -- entry --------------------------------------------------------------------

def test_entry_matches_lam_tpu_and_the_oracle():
    fn, args = dryrun.entry(device="cpu")
    assert [tuple(t.shape) for t in args] == [(512, 512), (512, 512), (512,)]
    assert [t.dtype for t in args] == [torch.float32, torch.float32,
                                       torch.float64]
    from lam_tpu_torch import ops
    ops.reset_counters()
    x = fn(*args).numpy()
    # the loop reads its flag every CHUNK iterations: it may run frozen
    # iterations (x unchanged) past its 20
    assert ops.counters()["gemv_df64_plain"] >= 20
    jfn, jargs = ge.entry()
    xj = np.asarray(jax.block_until_ready(jax.jit(jfn)(*jargs)))
    for i in range(2):  # the example's planes and rhs: lam_tpu's bytes
        assert np.array_equal(args[i].numpy(), np.asarray(jargs[i]))
    a, b = gen.tridiagonal_matrix(512), gen.ones_rhs(512)
    xo = oracle_cg(a, b, max_iters=20)[0]
    for ref in (xj, xo):
        assert np.linalg.norm(x - ref) / np.linalg.norm(ref) < ENTRY_TOL


def test_the_card_is_required_where_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.dryrun_multichip(2)


@pytest.mark.parametrize("g,grid", [(1, False), (2, False), (4, True),
                                    (8, True)])
def test_sizes_and_legs(g, grid):
    assert dryrun.sizes(g, "cpu") == (max(64 * g, 512), 128)
    assert dryrun.sizes(g, "cuda") == (1024 * g, 512)
    legs = dryrun.legs_of(g)
    assert ("2d" in legs) == grid and legs[-1] == "heat"
    assert len(legs) == 11 + 11 * grid
    assert set(legs) <= set(dryrun.KERNELS_OF)


# -- the dry run --------------------------------------------------------------

# legs whose 'auto' precision is f64 on the CPU: plain torch products
_F64_ON_CPU = ("gather", "ring", "2d", "2d-chain", "2d-gen")


@pytest.fixture
def _host_lock():
    """The host's cluster lock, held through the test: the wait for other
    files' clusters is the test's setup time, the dry run its call time."""
    from torch_sharded_worker import host_lock
    with host_lock():
        yield


def test_dryrun_multichip_four_ranks_on_cpu(monkeypatch, capsys, _host_lock):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    got = []
    real = dryrun.dryrun_multichip

    def keep(*args, **kwargs):
        got.extend(real(*args, **kwargs))
        return got

    monkeypatch.setattr(dryrun, "dryrun_multichip", keep)
    assert dryrun.main(["--ranks", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert [rec["leg"] for rec in got] == dryrun.legs_of(4)
    n, _ = dryrun.sizes(4, "cpu")
    a, b = gen.random_spd_system(n, seed=dryrun.SEED)
    k_ref = lam_oracle_cg(a, b, max_iters=2000, rel_error=1e-9)[1]
    solves = 0
    for rec in got:
        line = rec["line"]
        assert line in out
        fields = dict(re.findall(r"(\w+)=(\S+)", line))
        if "true_rel" in fields:
            solves += 1
            assert float(fields["true_rel"]) < 1e-8, line
            if "/" in rec["leg"]:  # refinement: the TRUE residual only
                assert fields["oracle"] == "-", line
            else:
                assert int(fields["oracle"]) == k_ref
                assert abs(int(fields["iters"]) - k_ref) <= max(
                    3, k_ref // 50), line
        assert rec["kernels"] == {}
        want = () if rec["leg"] in _F64_ON_CPU else dryrun.KERNELS_OF[
            rec["leg"]]
        assert set(rec["plain"]) == {f"{k}_plain" for k in want}, rec
    assert solves == 17  # 9 direct, 8 refined; 4 matvec legs and heat
    assert re.search(r"every leg passed in [\d.]+ s", out)


def test_a_failing_rank_fails_the_dry_run(monkeypatch):
    real = dryrun._rank_argv

    def argv(rank, *rest):
        if rank == 1:
            return [sys.executable, "-c", "import sys; print('rank 1 failed "
                    "on purpose', flush=True); sys.exit(1)"]
        return real(rank, *rest)

    monkeypatch.setattr(dryrun, "_rank_argv", argv)
    with pytest.raises(RuntimeError) as err:
        dryrun.dryrun_multichip(2, device="cpu")
    text = str(err.value)
    assert "rank 1 failed on purpose" in text
    assert "--- rank 0" in text and "--- rank 1 (exit 1)" in text


@pytest.mark.parametrize("name", [
    "solver.operators.DenseOperator.from_dense",
    "parallel.pcg.ShardedDenseOperator.from_dense",
    "parallel.pcg2d.Sharded2DOperator.from_dense",
    "parallel.pcg2d.Sharded2DOperator.from_gen_tridiagonal"])
def test_constructor_precision_defaults(name):
    """An observed difference, kept: these constructors default to df64
    (the port's CPU path runs the kernels' plain versions), lam_tpu's to
    'auto'; the dry run passes 'auto' itself."""
    import importlib
    import inspect
    mod, cls, fn = name.rsplit(".", 2)
    defaults = []
    for pkg in ("lam_tpu_torch", "lam_tpu"):
        obj = getattr(getattr(importlib.import_module(f"{pkg}.{mod}"), cls),
                      fn)
        defaults.append(inspect.signature(obj).parameters["precision"]
                        .default)
    assert defaults == ["df64", "auto"]
