"""Runs of the harness on the CPU at tiny sizes, in a copy of the benchmark
to which a configuration, a traffic mix and a per-layer metric were added
as files (no file of the benchmark edited): the runs come out correct and
report the added metric; the control and planted faults come out not
correct; the command refuses without a card; nothing loads JAX or the JAX
package, and the reference loads nothing of the port."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11
FORBIDDEN = {"jax", "jaxlib", "flax", "poly_commit_tpu"}

ADDED = {
    "configs/tiny_marlin.json": {"name": "tiny_marlin", "scheme": "marlin_kzg10",
                                 "curve": "bls12_381", "srs_degree": 31, "h_size": 8,
                                 "k_size": 8, "x_size": 2, "hiding_bound": 1},
    "configs/tiny_hyrax.json": {"name": "tiny_hyrax", "scheme": "hyrax", "curve": "bn254",
                                "num_vars": 6},
    # two degree bounds, so the shifted commitments differ in their shift
    "traffic/two_rounds.json": {"rounds": [
        [{"label": "a", "degree": {"h_size": 2, "const": 3}, "hiding": True, "query": "x"},
         {"label": "b", "degree": {"const": 5}, "degree_bound": {"const": 9}, "query": "y"}],
        [{"label": "c", "degree": {"h_size": 1}, "degree_bound": {"h_size": 2}, "hiding": True,
          "query": "x"}]], "check_requests": 1},
}
ADDED_METRIC = '''"""requests_run: the requests the window ran."""


def read(ctx):
    return len(ctx.requests)
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout with the benchmark's files and the added ones."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "poly_commit_tpu_torch").symlink_to(REPO / "poly_commit_tpu_torch")
    for rel, body in ADDED.items():
        (root / "port_bench" / rel).write_text(json.dumps(body))
    (root / "port_bench/metrics/requests_run.py").write_text(ADDED_METRIC)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("tiny_marlin", "tiny_hyrax"):
        bench["configs"].append({"name": name, "source": "a test", "reduced": [], "why": "a test",
                                 "file": f"port_bench/configs/{name}.json"})
    cells = [{"name": "tiny.marlin", "config": "tiny_marlin", "traffic": "two_rounds"},
             {"name": "tiny.marlin.proof9", "config": "tiny_marlin", "traffic": "proof9"},
             {"name": "tiny.hyrax", "config": "tiny_hyrax", "traffic": "commit_open"}]
    for cell in cells:
        bench["workloads"].append({**cell, "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c["name"] for c in cells]
    bench["per_layer"].append({"name": "requests_run", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "scheme",
                               "moves": "prover_coeffs_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for f in (REPO / "port_bench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts and "tests" not in f.parts:
            assert (root / f.relative_to(REPO)).read_bytes() == f.read_bytes()
    return root


def run_cell(root, workload, trace=False, control=False, plant=""):
    """One run on the CPU in a fresh interpreter; (result, modules loaded)."""
    code = f"""
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {str(root)!r})
import torch
torch.set_num_threads(1)
from pathlib import Path
from port_bench import harness
{plant}
r = harness.run(Path({str(root)!r}), {workload!r}, {SEED}, 0.01, {trace}, t,
                device_kind="cpu", control={control})
print(json.dumps(r))
print(json.dumps(sorted(sys.modules)))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result, modules = out.stdout.strip().splitlines()[-2:]
    return json.loads(result), json.loads(modules)


def tops(modules):
    return {m.split(".")[0] for m in modules}


@pytest.mark.parametrize("workload,trace", [("tiny.marlin", False), ("tiny.marlin.proof9", True),
                                            ("tiny.hyrax", True)])
def test_added_cell_runs_correct(root, workload, trace):
    result, modules = run_cell(root, workload, trace=trace)
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["checks"] == {"wrong_outputs": {"value": 0, "limit": 0}}
    assert list(result)[-1] == "checks"
    if trace:
        assert result["metrics"]["requests_run"]["value"] == result["attempted"]
        assert {"commit_ms", "open_ms"} <= set(result["metrics"])
        assert "msm_roofline" not in result["metrics"]  # no device trace on the CPU
    else:
        assert set(result["metrics"]) == {"setup_s"}  # nothing completed in 0.01 s
    assert not tops(modules) & FORBIDDEN


@pytest.mark.parametrize("workload", ["tiny.marlin", "tiny.hyrax"])
def test_control_is_not_correct(root, workload):
    result, _ = run_cell(root, workload, control=True)
    assert result["correct"] is False
    assert result["checks"]["wrong_outputs"]["value"] > 0


ALTERED = """
from poly_commit_tpu_torch.core import msm as M
_msm, _rows = M.msm, M.msm_rows
def _plus_g(group, pt):
    gen = group.generator(pt[0].device)
    return group.add(pt, tuple(g.expand(pt[0].shape) for g in gen))
M.msm = lambda group, scalars, points, assume_distinct=False: _plus_g(
    group, _msm(group, scalars, points, assume_distinct))
M.msm_rows = lambda group, scalars, points, assume_distinct=False: _plus_g(
    group, _rows(group, scalars, points, assume_distinct))
"""
HALF = """
from poly_commit_tpu_torch.core import msm as M
_msm, _rows = M.msm, M.msm_rows
def _half(scalars):
    scalars = scalars.clone()
    scalars[scalars.shape[0] // 2:] = 0
    return scalars
M.msm = lambda group, scalars, points, assume_distinct=False: _msm(
    group, _half(scalars), points, assume_distinct)
M.msm_rows = lambda group, scalars, points, assume_distinct=False: _rows(
    group, _half(scalars), points, assume_distinct)
"""


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("workload", ["tiny.marlin", "tiny.hyrax"])
def test_planted_fault_is_not_correct(root, workload, fault):
    """An answer altered where it is produced (every MSM's result plus the
    generator); half of the batch left out (the second half of every MSM's
    scalars, of msm_rows' rows)."""
    result, _ = run_cell(root, workload, plant=ALTERED if fault == "altered" else HALF)
    assert result["correct"] is False
    assert result["checks"]["wrong_outputs"]["value"] > 0


def test_reference_loads_nothing_of_the_port(root, tmp_path):
    """A run's sampled request, checked again by the reference alone in a
    process that never imports the port."""
    dump = tmp_path / "request.pkl"
    plant = f"""
import pickle
from port_bench import harness as _h
_check = None
def _keep(cfg, traffic, seed, plan, outputs, device):
    pickle.dump((cfg, traffic, seed, plan, outputs), open({str(dump)!r}, "wb"))
    return _check(cfg, traffic, seed, plan, outputs, device)
_load = _h._by_name
def _by_name(root, kind, name):
    global _check
    module = _load(root, kind, name)
    if kind == "reference":
        _check, module.check = module.check, _keep
    return module
_h._by_name = _by_name
"""
    result, _ = run_cell(root, "tiny.hyrax", plant=plant)
    assert result["correct"] is True and dump.exists()
    code = f"""
import json, pickle, sys
sys.path.insert(0, {str(root)!r})
from port_bench.reference import hyrax
cfg, traffic, seed, plan, outputs = pickle.load(open({str(dump)!r}, "rb"))
print(json.dumps([hyrax.check(cfg, traffic, seed, plan, outputs, "cpu"), sorted(sys.modules)]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    (wrong, checked), modules = json.loads(out.stdout.strip().splitlines()[-1])
    assert wrong == 0 and checked > 0
    assert not tops(modules) & (FORBIDDEN | {"poly_commit_tpu_torch"})


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "hyrax.nv22.commit",
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    if "refused" not in out.stderr:
        pytest.skip("a CUDA card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_do_not_run(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's folder only has
    no port to run: the run fails and prints no result."""
    shutil.copytree(REPO / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from port_bench import harness; "
            "sys.exit(harness.main(['--workload', 'hyrax.nv22.commit', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], device_kind='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.mark.gpu
def test_added_cell_runs_correct_on_the_card(root, cuda):
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "tiny.hyrax",
                          "--seed", str(SEED), "--seconds", "2", "--trace", "1"], cwd=root,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
