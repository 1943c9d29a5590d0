"""The harness: cells found by name, the result line's shape, the guards
against a run without a card and against JAX in the process."""

import json
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

from cgbench import harness

ROOT = pathlib.Path(harness.__file__).resolve().parents[1]
SPEC = harness.load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [c["name"] for c in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_config_and_traffic_by_name(cell):
    entry, cfg, traffic = harness.find_cell(SPEC, cell)
    assert entry["name"] == cell
    cfg_entry = {c["name"]: c for c in SPEC["configs"]}[entry["config"]]
    assert cfg_entry["file"] == f"cgbench/configs/{entry['config']}.json"
    assert cfg["name"] == entry["config"]
    for key in ("system", "n", "true_rel_residual_limit", "assumed"):
        assert key in cfg
    for key in ("precision", "rel_error", "max_iters", "warmup", "rhs_pool",
                "matvec"):
        assert key in traffic
    assert traffic["warmup"] is False and traffic["rel_error"] == 1e-9


@pytest.mark.parametrize("entry", METRICS, ids=lambda m: m["name"])
def test_each_metric_has_its_reader_and_allowed_names(entry):
    assert callable(harness.load_reader(entry["name"]).read)
    assert NAME.match(entry["name"]) and UNIT.match(entry["unit"])
    assert entry["better"] in ("lower", "higher")
    for cell in entry.get("workloads", []):
        assert cell in CELLS


def test_per_layer_metrics_name_a_layer_and_the_metric_they_move():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]
        assert m["moves"] in e2e


def test_names_keep_to_the_allowed_characters():
    for item in SPEC["configs"] + SPEC["workloads"]:
        assert NAME.match(item["name"])
    for cell in SPEC["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
        assert cell["chips"] == 1 and len(cell["why"]) <= 200


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell(SPEC, "no-such-cell")


def test_metrics_for_untraced_and_traced():
    e2e = [m["name"] for m in harness.metrics_for(SPEC, "spd40k.ir", False)]
    assert set(e2e) == {"solve_s", "device_mem_gb", "setup_s"}
    layer = [m["name"] for m in harness.metrics_for(SPEC, "spd40k.ir", True)]
    assert set(layer) == {"build_s", "warmup_s", "inner_iters",
                          "kernels_per_iter", "matvec_roofline",
                          "device_idle_share"}


def test_each_cell_reports_what_its_per_layer_metrics_move():
    for cell in CELLS:
        e2e = {m["name"] for m in harness.metrics_for(SPEC, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_for(SPEC, cell, True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_a_split_metric_is_read_by_its_quantity():
    assert (harness.load_reader("solve_s.hostpaced").read.__code__.co_code
            == harness.load_reader("solve_s").read.__code__.co_code)


def _run(trace=None, on_card=True):
    return harness.Run(
        config={"n": 40000}, traffic={"matvec": {
            "element_bytes": 4, "diagonal_bytes": 0, "vector_bytes": 4,
            "peak": "f32"}},
        on_card=on_card, setup_s=30.0, build_s=20.0, warmup_s=0.5,
        window_s=40.2, solve_times=[0.5] * 80, iters=[365] * 80,
        memory_peak_bytes=7_500_000_000 if on_card else None,
        solver_bytes=7_000_000_000 if on_card else None,
        attempted=83, failed=0,
        checks={"true_rel_residual": (9.7e-10, 2e-9), "unconverged": (0, 0)},
        gemv_s=1.2e-3, trace=trace, traced_iters=1095,
        details={"precision": "ir"})


TRACE = {"busy_s": 1.4, "window_s": 1.5, "kernels": 25600,
         "device_ops": [["k", 1.3]], "idle_gaps": [["aten::item", 0.1]]}
DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_untraced_result_line_shape():
    out = harness.result_line(SPEC, {"name": "spd40k.ir"}, _run(), False,
                              DEVICE)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks" and "breakdown" not in out
    assert out["correct"] is True and out["attempted"] == 83
    assert set(out["metrics"]) == {"solve_s", "device_mem_gb", "setup_s"}
    assert out["metrics"]["solve_s"] == {"value": 40.2 / 80, "unit": "s"}
    assert out["device"]["memory_peak_bytes"] == 7_500_000_000
    assert out["metrics"]["device_mem_gb"] == {"value": 7.0, "unit": "GB"}
    assert out["checks"]["true_rel_residual"] == {"value": 9.7e-10,
                                                  "limit": 2e-9}
    json.dumps(out)


def test_traced_result_line_shape():
    out = harness.result_line(SPEC, {"name": "spd40k.ir"}, _run(TRACE), True,
                              DEVICE)
    assert set(out["metrics"]) == {
        m["name"] for m in harness.metrics_for(SPEC, "spd40k.ir", True)}
    assert out["device"]["busy_s"] == 1.4 and out["device"]["window_s"] == 1.5
    assert out["breakdown"] == {"device_ops": [["k", 1.3]],
                                "idle_gaps": [["aten::item", 0.1]]}
    roof = out["metrics"]["matvec_roofline"]["value"]
    assert 79.0 < roof < 80.0   # 0.9553 ms over 1.2 ms
    assert out["metrics"]["kernels_per_iter"]["value"] == 25600 / 1095
    assert list(out)[-1] == "checks"


def test_a_run_off_the_card_writes_no_device_metric():
    out = harness.result_line(SPEC, {"name": "spd40k.ir"},
                              _run(TRACE, on_card=False), True, DEVICE)
    for name in ("matvec_roofline", "device_idle_share", "kernels_per_iter"):
        assert name not in out["metrics"]


def test_a_false_check_makes_the_run_not_correct():
    run = _run()
    run.checks["true_rel_residual"] = (3e-9, 2e-9)
    assert harness.result_line(SPEC, {"name": "spd40k.ir"}, run, False,
                               DEVICE)["correct"] is False
    run.checks["true_rel_residual"] = (float("nan"), 2e-9)
    assert harness.check.correct(run.checks) is False


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["torch", "lam_tpu_torch", "lam_tpu_torch.solver", "numpy",
             "jaxtyping", "flaxen"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(names + ["jax.numpy", "lam_tpu.ops",
                                              "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "lam_tpu"]


def _cardless(cwd):
    return subprocess.run(
        [sys.executable, "cgbench/run.py", "--workload", "spd40k.ir",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = _cardless(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in SPEC["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _cardless(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


SCRIPT = """
import json, sys, time
sys.path.insert(0, {root!r})
from cgbench import harness
spec = harness.load_spec()
cell, cfg, traffic = harness.find_cell(spec, "spd40k.ir")
cfg["n"], traffic["rhs_pool"] = 200, 4
run = harness.run_cell(cell, cfg, traffic, 2**31 + 9, 0.05, False, "cpu",
                       time.perf_counter())
print(json.dumps(harness.forbidden_modules()))
"""


def test_a_run_loads_no_jax_and_no_lam_tpu():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(ROOT))],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    out = subprocess.run(
        [sys.executable, "cgbench/run.py", "--workload", "spd40k.ir",
         "--seed", str(2**31 + 11), "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert "breakdown" in line and line["device"]["busy_s"] > 0
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
