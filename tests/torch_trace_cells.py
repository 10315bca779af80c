"""Traced runs of tiny benchmark cells on the CPU, for the tests of the
readers of the port's spans and counters (``test_torch_trace_readers*.py``).

A checkout of the benchmark is made as ``port_bench/tests`` makes one: the
benchmark's files, the port linked in, tiny configurations, a traffic mix
and cells added as files; every metric that lists cells lists the tiny
ones too, so a reader's None shows as a metric missing from the result,
but a twin in ``MIRRORED``, listed only where its cell is (the older
metrics read the spans its scheme shares with the others).
Each cell runs once, traced, in a fresh interpreter, through
``harness.run`` with a window that holds one request.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 2**31 + 29
NEW = ("transcript_ms", "transcript_permutations", "host_fold_ms", "to_host_ms", "host_syncs",
       "poly_ms", "msm_host_ms", "msm_useful_share")
LIGERO = ("encode_ms", "ntt_roofline", "leaf_hash_ms", "merkle_ms", "hashed_bytes")
ADDED = {
    "configs/tiny_marlin.json": {"name": "tiny_marlin", "scheme": "marlin_kzg10",
                                 "curve": "bls12_381", "srs_degree": 15, "h_size": 4,
                                 "k_size": 4, "x_size": 2, "hiding_bound": 1},
    "configs/tiny_hyrax.json": {"name": "tiny_hyrax", "scheme": "hyrax", "curve": "bn254",
                                "num_vars": 4},
    "configs/tiny_ligero.json": {"name": "tiny_ligero", "scheme": "ligero_ml", "curve": "bn254",
                                 "num_vars": 8, "rho_inv": 2, "sec_param": 128,
                                 "check_well_formedness": True},
    # one polynomial with a degree bound, opened: every span family runs
    "traffic/one_bounded.json": {"rounds": [[{"label": "c", "degree": {"h_size": 1},
                                              "degree_bound": {"h_size": 2}, "query": "x"}]],
                                 "check_requests": 1},
}
CELLS = {  # tiny cell -> (config, traffic, the cell of BENCHMARK.json whose metrics it shows)
    "tiny.marlin": ("tiny_marlin", "one_bounded", "marlin.d20.proof9"),
    "tiny.hyrax.commit": ("tiny_hyrax", "commit", "hyrax.nv22.commit"),
    "tiny.hyrax.prove": ("tiny_hyrax", "commit_open", "hyrax.nv22.prove"),
    "tiny.ligero": ("tiny_ligero", "commit_open", "ligero_ml.bn254.nv22.prove"),
}
MIRRORED = ("tiny.ligero",)


def checkout(root: Path) -> dict:
    """Fills ``root`` with the benchmark and the tiny cells; returns its
    BENCHMARK.json."""
    shutil.copytree(REPO / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "poly_commit_tpu_torch").symlink_to(REPO / "poly_commit_tpu_torch")
    for rel, body in ADDED.items():
        (root / "port_bench" / rel).write_text(json.dumps(body))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in ("tiny_marlin", "tiny_hyrax", "tiny_ligero"):
        bench["configs"].append({"name": name, "source": "a test", "reduced": [], "why": "a test",
                                 "file": f"port_bench/configs/{name}.json"})
    for cell, (config, traffic, _) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": config, "traffic": traffic,
                                   "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [c for c, (_, _, twin) in CELLS.items()
                               if c not in MIRRORED or twin in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench


def run_traced(root: Path, cell: str) -> dict:
    """One traced run of ``cell`` on the CPU; its result line's object."""
    code = f"""
import json, sys, time
t = time.perf_counter()
sys.path.insert(0, {str(root)!r})
import torch
torch.set_num_threads(1)
from pathlib import Path
from port_bench import harness
print(json.dumps(harness.run(Path({str(root)!r}), {cell!r}, {SEED}, 0.01, True, t,
                             device_kind="cpu")))
"""
    run = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


def listed(bench: dict, cell: str) -> set:
    """The new metrics BENCHMARK.json lists for the cell a tiny cell stands
    for, less those only a device trace gives (no card here)."""
    return {m["name"] for m in bench["per_layer"]
            if m["name"] in NEW + LIGERO and m["source"] != "device_trace"
            and CELLS[cell][2] in m.get("workloads", [])}


def check_result(bench: dict, cell: str, result: dict) -> dict:
    """The run is correct and reports exactly the listed new metrics, each
    in its unit; returns the metrics."""
    assert result["correct"] is True and result["failed"] == 0
    metrics = result["metrics"]
    assert {name for name in NEW + LIGERO if name in metrics} == listed(bench, cell)
    for name in listed(bench, cell):
        assert metrics[name]["unit"] == next(m["unit"] for m in bench["per_layer"]
                                             if m["name"] == name)
    if "msm_useful_share" in listed(bench, cell):
        assert 0 < metrics["msm_useful_share"]["value"] <= 100
        assert metrics["host_syncs"]["value"] > 0 and metrics["to_host_ms"]["value"] > 0
    return metrics
