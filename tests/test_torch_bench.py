"""The port's benchmark tools (lam_tpu_torch.bench) against lam_tpu.bench
(CPU), case for case beside lam_tpu's own tests/test_bench_tools.py.

- (a) `cache_dirs`/`cache_paths` equal to lam_tpu's but for the last entry
  (lam_tpu's literal /tmp, the port's temporary directory), with and
  without $LAM_BENCH_CACHE_DIR (lam_tpu's cache order, bench.py's file
  names);
- (b) `publish`: files byte-equal to lam_tpu's, each package's found by the
  other, a directory that refuses the file passed over with no `.tmp` left,
  None where none takes it (test_runner_spd_pack_cache_reuses_system's
  cache);
- (c) `clean.main` of both packages on copies of one corpus: rewritten
  sources, BEST_RESULTS and stderr byte-equal (test_clean_best_pick,
  test_clean_skips_non_csv_file_instead_of_emptying,
  test_clean_drops_projection_rows);
- (d) the gen sweep against lam_tpu's runner (test_runner_gen_sweep);
- (e) spd mode in memory, f64, against lam_tpu's runner
  (test_runner_spd_mode);
- (f) spd mode with df64 against oracle_cg, and ir and irfq against
  lam_tpu's runner, the kernels' plain versions here;
- (g) `--pack-cache` cold then warm, and lam_tpu's runner on the port's
  cache (test_runner_spd_pack_cache_reuses_system);
- (h) the facade's in-memory build `_build_operator` on one device;
- (i) a sharded sweep of two ranks: one job of the 2-rank cluster of
  tests/test_torch_sharded.py (`test_bench_sweep_across_two_ranks`), since
  a cluster of its own would wait for the host's cluster lock.
Every test points $LAM_BENCH_CACHE_DIR at its own temporary directory, so
nothing is published into the checkout's io/bench or the temporary
directory.
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from lam_tpu import generate as jgen
from lam_tpu.bench import clean as jclean
from lam_tpu.bench import runner as jrunner
from lam_tpu.bench import systems as jsystems
from lam_tpu_torch import cg_solve_ir
from lam_tpu_torch import generate as gen
from lam_tpu_torch.bench import clean, runner, systems
from lam_tpu_torch.solver import api, oracle_cg
from lam_tpu_torch.solver import pack_cache as pc
from lam_tpu_torch.solver.cg import default_inner_floor
from lam_tpu_torch.solver.operators import DenseOperator

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SPD = 96


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on shared cores: torch's own
    # thread pool would oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _cache_dir(tmp_path, monkeypatch):
    """$LAM_BENCH_CACHE_DIR for each test: a directory of its own."""
    d = tmp_path / "cache"
    d.mkdir()
    monkeypatch.setenv("LAM_BENCH_CACHE_DIR", str(d))
    return d


def _fields(row):
    f = row.split(",")
    assert len(f) == 9
    return f


def _rows(path):
    return [_fields(r) for r in path.read_text().strip().splitlines()]


def test_modules_import_without_jax_or_lam_tpu():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'lam_tpu'):\n"
            "    sys.modules[name] = None  # any import of them raises\n"
            "import lam_tpu_torch.bench.runner, lam_tpu_torch.bench.clean\n"
            "import lam_tpu_torch.bench.systems\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- (a) the cache directories ------------------------------------------------

@pytest.mark.parametrize("with_env", [True, False])
@pytest.mark.parametrize("cwd", ["root", "elsewhere"])
@pytest.mark.parametrize("own_tmp", [True, False])
def test_cache_dirs_and_paths_equal_lam_tpus(with_env, cwd, own_tmp,
                                             tmp_path, monkeypatch):
    """Equal to lam_tpu's on every entry but the last: lam_tpu's is a
    literal /tmp, the port's the process's temporary directory."""
    if not with_env:
        monkeypatch.delenv("LAM_BENCH_CACHE_DIR")
    if own_tmp:
        (tmp_path / "tmp").mkdir()
        monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    monkeypatch.chdir(ROOT if cwd == "root" else tmp_path)
    dirs = systems.cache_dirs()
    jdirs = jsystems.cache_dirs()
    assert dirs[:-1] == jdirs[:-1]
    assert jdirs[-1] == "/tmp"
    assert dirs[-1] == tempfile.gettempdir()
    if own_tmp:
        assert dirs[-1] == str(tmp_path / "tmp")
    assert len(dirs) == len(set(dirs)) == 2 + with_env + (cwd != "root")
    assert dirs[with_env] == os.path.join(ROOT, "io", "bench")
    for n, seed in ((96, 2024), (20000, 7)):
        paths = systems.cache_paths(n, seed)
        jpaths = jsystems.cache_paths(n, seed)
        assert paths[:-1] == jpaths[:-1]
        assert paths[-1] == os.path.join(
            tempfile.gettempdir(), os.path.basename(jpaths[-1]))
    assert systems.SEED == jsystems.SEED == 2024


# -- (b) publish --------------------------------------------------------------

def test_publish_is_lam_tpus_byte_for_byte_and_found_by_both(tmp_path,
                                                             monkeypatch):
    a = gen.random_spd_matrix(40, seed=5)
    paths = {}
    for name, mod in (("port", systems), ("lam_tpu", jsystems)):
        d = tmp_path / name
        monkeypatch.setenv("LAM_BENCH_CACHE_DIR", str(d))
        assert mod.find_cached(40, 5) is None
        paths[name] = mod.publish(a, 40, 5)
        assert paths[name] == str(d / "lam_bench_spd_N40_s5.npy")
        assert os.listdir(d) == ["lam_bench_spd_N40_s5.npy"]  # no .tmp
    with open(paths["port"], "rb") as f, open(paths["lam_tpu"], "rb") as g:
        assert f.read() == g.read()
    # each package finds the other's file
    for name, other in (("port", jsystems), ("lam_tpu", systems)):
        monkeypatch.setenv("LAM_BENCH_CACHE_DIR", str(tmp_path / name))
        assert other.find_cached(40, 5) == paths[name]
    assert np.array_equal(np.load(paths["port"]), a)


def _refusing_dirs(tmp_path, n, seed):
    """Two cache directories that refuse the file: one below a regular
    file (no directory can be made there) and one where the file's name
    is taken by a non-empty directory (the .tmp is written, the rename
    fails)."""
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    taken = tmp_path / "taken"
    (taken / f"lam_bench_spd_N{n}_s{seed}.npy").mkdir(parents=True)
    (taken / f"lam_bench_spd_N{n}_s{seed}.npy" / "keep").write_text("x")
    return [str(blocker / "sub"), str(taken)]


def test_publish_passes_over_a_directory_that_refuses_it(tmp_path,
                                                         monkeypatch):
    good = tmp_path / "good"
    dirs = _refusing_dirs(tmp_path, 8, 1) + [str(good)]
    monkeypatch.setattr(systems, "cache_dirs", lambda: dirs)
    a = np.eye(8)
    path = systems.publish(a, 8, 1)
    assert path == str(good / "lam_bench_spd_N8_s1.npy")
    assert np.array_equal(np.load(path), a)
    assert not list(tmp_path.rglob("*.tmp"))


def test_publish_returns_none_when_nothing_takes_it(tmp_path, monkeypatch):
    dirs = _refusing_dirs(tmp_path, 8, 1)
    monkeypatch.setattr(systems, "cache_dirs", lambda: dirs)
    assert systems.publish(np.eye(8), 8, 1) is None
    assert not list(tmp_path.rglob("*.tmp"))


# -- (c) the post-processor ---------------------------------------------------

CORPUS = {
    "MERGE_run.txt": (
        "this is a header line\n"
        "\n"
        "20000,8,1,1.0,0.1,0.2,350,1e-10,2.5\n"
        "10000,4,1,1.0,0.1,0.2,350,1e-10,9.9\n"
        "10000,4,1,1.0,0.1,0.05,350,1e-10,3.3\n"
        "10000,4,1,1.0,0.1,0.01,350,1e-10,7.7\n"
        "  \n"
        "10000,1,1,1.0,0.3,0.4,358,9e-10,1.2\n"
        "20000,8,1,1.0,0.1,0.3,350,1e-10,2.1\n"
        "28963,2,1,0,0.00077,0.00077,384,1e-09,0.2959 # projected\n"
        "9000,16,1,2.0,0.2,0.1,300,1e-10,4.0\n"
        "9000,2,1,2.0,0.2,0.3,300,1e-10,4.0\n"),
    "WEAK.txt": (
        "# legend line\n"
        "20480,1,1,564,0.0076,0.0076,385,9.9e-10,2.96\n"
        "40960,4,1,0,0.00077,0.00077,384,1e-09,0.2971 # projected\n"),
    "SCALING.txt": (
        "# convergence-invariance study\n"
        "sharded_gather,1024,1,334,9.884e-10,8192\n"),
}


@pytest.mark.parametrize("time_field", ["-1", "5"])
def test_clean_is_lam_tpus_byte_for_byte(time_field, tmp_path, monkeypatch,
                                         capsys):
    names = list(CORPUS)
    out = {}
    for pkg, mod in (("port", clean), ("lam_tpu", jclean)):
        d = tmp_path / pkg
        d.mkdir()
        for name, text in CORPUS.items():
            (d / name).write_text(text)
        monkeypatch.chdir(d)  # the banners name the files as given
        capsys.readouterr()
        assert mod.main(names + ["-o", "BEST", "--time-field",
                                 time_field]) == 0
        out[pkg] = ({n: (d / n).read_bytes() for n in names + ["BEST"]},
                    capsys.readouterr().err)
    assert out["port"] == out["lam_tpu"]
    files, err = out["port"]
    assert files["SCALING.txt"] == CORPUS["SCALING.txt"].encode()
    assert "SCALING.txt: no data rows" in err
    assert "MERGE_run.txt: dropped 1 annotated row" in err
    cleaned = files["MERGE_run.txt"].decode().splitlines()
    assert len(cleaned) == 8 and cleaned[0].startswith("9000,2,")
    best = files["BEST"].decode()
    assert "projected" not in best and "sharded_gather" not in best
    picks = {"-1": "0.05,350,1e-10,3.3", "5": "0.01,350,1e-10,7.7"}
    section = best.split("File: MERGE_run.txt")[1].split("File:")[0]
    assert [r for r in section.splitlines() if r.startswith("10000,4,")] == [
        "10000,4,1,1.0,0.1," + picks[time_field]]


def test_clean_module_runs_as_a_script(tmp_path):
    data = tmp_path / "MERGE.txt"
    data.write_text("2000,1,1,1.0,0.1,0.2,350,1e-10,2.5\n"
                    "1000,1,1,1.0,0.1,0.2,350,1e-10,2.5\n")
    proc = subprocess.run(
        [sys.executable, "-m", "lam_tpu_torch.bench.clean", str(data), "-o",
         str(tmp_path / "BEST")], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert data.read_text().startswith("1000,1,")
    assert "2000,1,1" in (tmp_path / "BEST").read_text()


# -- (d), (e) the runner against lam_tpu's ------------------------------------

@pytest.fixture(scope="module")
def spd_system():
    a = gen.random_spd_matrix(N_SPD, seed=2024)
    b = gen.random_rhs(N_SPD, seed=2034)
    return a, b, oracle_cg(a, b, max_iters=10000)[1]


def test_gen_sweep_matches_lam_tpu(tmp_path):
    port, ref = tmp_path / "port.csv", tmp_path / "lam_tpu.csv"
    assert runner.main(["--sizes", "128", "256", "--mode", "gen", "-o",
                        str(port), "--device", "cpu"]) == 0
    # the conftest's virtual mesh would make lam_tpu's auto backend sharded
    assert jrunner.main(["--sizes", "128", "256", "--mode", "gen", "-o",
                         str(ref), "--backend", "local"]) == 0
    for f, g, n in zip(_rows(port), _rows(ref), (128, 256)):
        assert (f[0], f[1], f[2]) == (g[0], g[1], g[2]) == (str(n), "1",
                                                             "1")
        # the gen-mode cap: the reference's CSV shows max_iters + 1
        assert f[6] == g[6] == "16"
        assert abs(float(f[7]) - float(g[7])) <= 1e-6 * float(g[7])
        assert all(float(x) > 0 for x in f[3:6] + f[8:])


def test_spd_mode_f64_matches_lam_tpu(tmp_path, spd_system):
    """Both f64 CG on the same system, summed in other orders: past n
    iterations (this spectrum takes ~156 at n=96) the counts part by a
    few, as lam_tpu's own engines' do (port 155, lam_tpu 157, oracle_cg
    156 here)."""
    port, ref = tmp_path / "port.csv", tmp_path / "lam_tpu.csv"
    argv = ["--sizes", str(N_SPD), "--mode", "spd", "--precision", "f64",
            "-i", "1000"]
    assert runner.main(argv + ["-o", str(port), "--device", "cpu"]) == 0
    assert jrunner.main(argv + ["-o", str(ref), "--backend", "local"]) == 0
    (f,), (g,) = _rows(port), _rows(ref)
    assert f[:3] == g[:3] == [str(N_SPD), "1", "1"]
    k = spd_system[2]
    assert abs(int(f[6]) - k) <= 2 and abs(int(g[6]) - k) <= 2
    assert float(f[7]) < 1e-9 and float(g[7]) < 1e-9


# -- (f) the kernels' precisions ----------------------------------------------

def test_spd_mode_df64_within_two_of_the_oracle(spd_system, capsys):
    assert runner.main(["--sizes", str(N_SPD), "--mode", "spd",
                        "--precision", "df64", "--device", "cpu"]) == 0
    f = _fields(capsys.readouterr().out.strip())
    assert f[:3] == [str(N_SPD), "1", "1"]
    assert abs(int(f[6]) - spd_system[2]) <= 2
    assert float(f[7]) < 1e-9


# precision -> the relative tolerance of the port's count against lam_tpu's
# runner on the same system. At n=96 the f32 inner loops restart often and
# the counts follow the inner matvec's rounding: irfq's is the port's own
# dequantizing product on both sides (port 260, lam_tpu 261), while ir's
# f32 product is XLA:CPU's on lam_tpu's side (port 232, lam_tpu 240; the
# 5% is test_torch_cg.py's tolerance for ir against lam_tpu's CLI).
REFINEMENT_COUNT_TOL = {"ir": 0.05, "irfq": 0.02}


@pytest.mark.parametrize("precision", ["ir", "irfq"])
def test_spd_mode_refinement_matches_lam_tpu(precision, tmp_path,
                                             spd_system):
    """The row's count against lam_tpu's runner on the same system, and
    the solution's TRUE residual. At n=96 ir takes ~1.5 and irfq ~1.7
    times oracle_cg's 156 iterations (at N=10000 on the card, 365 and 375
    against df64's 358)."""
    a, b, k = spd_system
    port, ref = tmp_path / "port.csv", tmp_path / "lam_tpu.csv"
    argv = ["--sizes", str(N_SPD), "--mode", "spd", "--precision", precision]
    assert runner.main(argv + ["-o", str(port), "--device", "cpu"]) == 0
    assert jrunner.main(argv + ["-o", str(ref), "--backend", "local"]) == 0
    (f,), (g,) = _rows(port), _rows(ref)
    assert f[:3] == g[:3] == [str(N_SPD), "1", "1"]
    assert (abs(int(f[6]) - int(g[6]))
            <= REFINEMENT_COUNT_TOL[precision] * int(g[6]))
    assert int(f[6]) >= k
    assert float(f[7]) < 1e-9 and float(g[7]) < 1e-9
    # the runner's row is the facade's solve of that system: its solution
    # meets the tolerance against the f64 matrix
    op = DenseOperator.from_dense(a, precision=api._BASE[precision],
                                  device="cpu")
    res = cg_solve_ir(op.as_f32(), op, b, max_iters=10000, rel_error=1e-9,
                      inner_floor=default_inner_floor(precision))
    assert bool(res.converged) and int(res.num_iters) == int(f[6])
    x = res.x.numpy()
    assert np.linalg.norm(b - a @ x) <= 2e-9 * np.linalg.norm(b)


# -- (g) the .npy system cache ------------------------------------------------

def test_pack_cache_cold_then_warm_and_lam_tpu_reads_it(tmp_path, _cache_dir,
                                                        monkeypatch):
    out = tmp_path / "spd.csv"
    argv = ["--sizes", str(N_SPD), "--mode", "spd", "--pack-cache",
            "--precision", "irfq", "--device", "cpu", "-o", str(out)]
    assert runner.main(argv) == 0
    npy = _cache_dir / f"lam_bench_spd_N{N_SPD}_s2024.npy"
    with open(tmp_path / "ref.npy", "wb") as fh:
        np.save(fh, jgen.random_spd_matrix(N_SPD, seed=2024))
    assert npy.read_bytes() == (tmp_path / "ref.npy").read_bytes()
    fqpack = pc.cache_path(str(npy), "fq")
    assert os.path.exists(fqpack)
    stamps = (npy.stat().st_mtime_ns, os.stat(fqpack).st_mtime_ns)

    def refuse(*args, **kw):
        raise AssertionError("the warm run generated or packed")
    # warm: the system and its pack both read from the cache
    monkeypatch.setattr(runner, "_spd_matrix", refuse)
    monkeypatch.setattr(pc, "save", refuse)
    assert runner.main(argv) == 0
    cold, warm = _rows(out)
    assert cold[:3] + cold[6:8] == warm[:3] + warm[6:8]
    assert float(cold[7]) < 1e-9
    assert (npy.stat().st_mtime_ns, os.stat(fqpack).st_mtime_ns) == stamps

    # lam_tpu's runner finds the port's file and never generates
    monkeypatch.setattr(jgen, "random_spd_matrix", refuse)
    ref = tmp_path / "lam_tpu.csv"
    assert jrunner.main(["--sizes", str(N_SPD), "--mode", "spd",
                         "--pack-cache", "--precision", "f64", "--backend",
                         "local", "-o", str(ref), "-i", "1000"]) == 0
    (g,) = _rows(ref)
    assert float(g[7]) < 1e-9
    assert sorted(os.listdir(_cache_dir)) == sorted(
        [npy.name, os.path.basename(fqpack)])


def test_pack_cache_without_a_writable_directory_is_rc_1(tmp_path,
                                                         monkeypatch,
                                                         capsys):
    # the first of _refusing_dirs: the other holds a directory of the
    # file's name, which find_cached would find
    dirs = _refusing_dirs(tmp_path, 64, 2024)[:1]
    monkeypatch.setattr(systems, "cache_dirs", lambda: dirs)
    assert runner.main(["--sizes", "64", "--mode", "spd", "--pack-cache",
                        "--device", "cpu"]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert captured.err == ("lam-bench: no writable cache dir for the N=64 "
                            "system\n")


# -- (h) the facade's in-memory build -----------------------------------------

@pytest.mark.parametrize("precision", ["df64", "ir", "f32", "fq", "irfq",
                                       "f64"])
@pytest.mark.parametrize("full", [True, False])
def test_build_operator_on_one_device_is_from_dense(precision, full,
                                                    spd_system):
    a = spd_system[0]
    cg = api.ConjugateGradient(backend="local", precision=precision,
                               device="cpu")
    op = cg._build_operator(lambda s, m: a[s:s + m, :], N_SPD,
                            full_matrix=a if full else None)
    ref = DenseOperator.from_dense(a, precision=api._BASE.get(precision,
                                                              precision),
                                   device="cpu")
    got = op.operand if isinstance(op.operand, tuple) else (op.operand,)
    want = ref.operand if isinstance(ref.operand, tuple) else (ref.operand,)
    assert type(op) is DenseOperator and op.engine == ref.engine
    assert (op.n, op.n_padded, op.precision) == (ref.n, ref.n_padded,
                                                 ref.precision)
    assert len(got) == len(want)
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(got, want))


# -- refusals -----------------------------------------------------------------

def test_cuda_without_a_card_is_rc_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    assert runner.main(["--sizes", "64"]) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert captured.err.startswith("lam-bench: device 'cuda' requested")
    assert len(captured.err.splitlines()) == 1


@pytest.mark.parametrize("argv,words", [
    (["--num-processes", "2"], "need --coordinator"),
    (["--process-id", "0"], "need --coordinator"),
    (["--backend", "ring"], "unknown backend"),
    (["--precision", "f16"], "unknown precision")])
def test_refusals_are_one_stderr_line(argv, words, capsys):
    assert runner.main(["--sizes", "64", "--device", "cpu"] + argv) == 1
    captured = capsys.readouterr()
    assert captured.out == ""
    assert words in captured.err and len(captured.err.splitlines()) == 1


def test_default_iteration_caps(monkeypatch):
    seen = []

    def fake(n, mode, max_iters, *args, **kw):
        seen.append((mode, max_iters))
        return f"{n},1,1,0,0,0,{max_iters + 1},1,0"
    monkeypatch.setattr(runner, "run_one", fake)
    for mode in ("gen", "spd"):
        assert runner.main(["--sizes", "8", "--mode", mode, "--device",
                            "cpu"]) == 0
    assert runner.main(["--sizes", "8", "-i", "3", "--device", "cpu"]) == 0
    assert seen == [("gen", 15), ("spd", 10000), ("gen", 3)]
