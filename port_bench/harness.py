"""One run of one cell: set-up, the measured window, the reference check,
the metrics, one JSON line.

Set-up (``setup_s``): imports, CUDA, the scheme's ``setup`` and ``trim``
from the seed, and one warm-up request of the cell's own shapes, which
loads the kernel libraries it launches (built into the checkout's
``poly_commit_tpu_torch/_build`` on a cell's first run there, loaded after).
The process runs on fixed cores (``PIN_CORES``), and what set-up leaves
alive is moved out of the garbage collector's reach (``gc.freeze``).
The window is a closed loop with one prover: request i + 1 starts when
request i has returned. Each request draws its inputs (on the device, from
the seed) inside the window. With ``--trace 1`` the window runs under
``torch.profiler``. After the window the peak memory is read, the port's
state is freed, and the reference checks a sample of the requests, drawn
from the seed as they ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import random
import sys
import time
import traceback
from pathlib import Path

from . import inputs, seeds, tracing as T, yardstick

FORBIDDEN = ("jax", "jaxlib", "flax", "poly_commit_tpu")
PB = Path(__file__).resolve().parent.name
PIN_CORES = 1  # the command's process and the threads it starts: this many fixed cores


@dataclasses.dataclass
class Request:
    plan: inputs.Plan
    t0: float
    t1: float = 0.0
    coeffs: int = 0
    spans: list = dataclasses.field(default_factory=list)  # (name, t0, t1)
    outputs: dict | None = None
    error: str | None = None


@dataclasses.dataclass
class Context:
    """What a metric's reader reads."""

    cfg: dict
    traffic: dict
    setup_s: float
    window_start: float
    deadline: float
    requests: list
    trace: T.TraceSummary | None
    card: dict
    scheme: object  # schemes/<scheme>.py
    plan: inputs.Plan  # the shapes of every request (the warm-up's plan)


class Refused(Exception):
    """The run cannot be made here; no result is printed."""


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise Refused(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _by_name(root: Path, kind: str, name: str):
    """``port_bench/<kind>/<name>.py`` as a module of the package."""
    path = root / PB / kind / f"{name}.py"
    if not path.exists():
        raise Refused(f"{kind}: no {path}")
    return load_module(path, f"{PB}.{kind}.{name.replace('.', '_')}")


def load_cell(root: Path, workload: str):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / config["file"]).read_text())
    traffic = json.loads((root / PB / "traffic" / f"{cell['traffic']}.json").read_text())
    return bench, cell, cfg, traffic


def applies(metric: dict, cell: dict) -> bool:
    return "workloads" not in metric or cell["name"] in metric["workloads"]


def check_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def pin(n: int | None):
    """Pins the calling thread, and every thread it starts from then on, to
    the n highest-numbered cores it may use; returns them."""
    if not n or not hasattr(os, "sched_setaffinity"):
        return None
    cores = sorted(os.sched_getaffinity(0))[-n:]
    os.sched_setaffinity(0, cores)
    return cores


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, t_process: float,
        device_kind: str = "cuda", control: bool = False, log=print) -> dict:
    """One run; returns the result line's object. ``device_kind="cpu"`` and
    ``control`` are for the tests and the control run only: the command
    line always asks for a CUDA card."""
    import torch

    bench, cell, cfg, traffic = load_cell(root, workload)
    if device_kind == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                          f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        card = yardstick.card(torch)
        log(f"# device: {card['name']}, power limit {card['power_limit_w']} W, {card['sms']} SMs, "
            f"max SM clock {card['max_sm_clock_mhz']} MHz, IMAD peak {card['imad_per_s']}/s")
        log(f"# host cores of this thread: {sorted(os.sched_getaffinity(0))}")
    else:
        card = {"name": "cpu", "sms": 0, "power_limit_w": None, "max_sm_clock_mhz": None,
                "imad_per_s": None}
    device = torch.device(device_kind)
    sync = torch.cuda.synchronize if device_kind == "cuda" else (lambda: None)
    scheme = _by_name(root, "schemes", cfg["scheme"])

    shapes = inputs.plan(traffic, cfg, scheme, seed, -1)
    state = scheme.setup(cfg, shapes, seed, device)
    coeffs = inputs.coefficients(shapes)

    def one(index: int, timed: bool) -> Request:
        req = Request(plan=inputs.plan(traffic, cfg, scheme, seed, index), t0=time.perf_counter())

        @contextlib.contextmanager
        def span(name):
            t0 = time.perf_counter()
            with (torch.profiler.record_function(T.SPAN_PREFIX + name) if trace and timed
                  else contextlib.nullcontext()):
                yield
            req.spans.append((name, t0, time.perf_counter()))

        with (torch.profiler.record_function(T.SPAN_PREFIX + "request") if trace and timed
              else contextlib.nullcontext()):
            try:
                req.outputs = scheme.request(state, cfg, req.plan, seed, device, span, control)
                sync()
                req.coeffs = coeffs
            except Exception:  # a failed request is counted, the window goes on
                req.error = traceback.format_exc()
        req.t1 = time.perf_counter()
        return req

    warm = one(-1, False)
    if warm.error:
        raise RuntimeError(f"warm-up request failed:\n{warm.error}")
    sync()
    if device_kind == "cuda":
        from poly_commit_tpu_torch import device as D

        log(f"# kernel libraries the warm-up loaded, nvcc seconds by source (none: all built): "
            f"{json.dumps(D.BUILD_SECONDS)}")
    del warm
    gc.collect()
    gc.freeze()

    # the reference's sample: uniform over the requests that ran without an
    # error, drawn from the seed while they run (reservoir sampling), so
    # that the window holds the outputs of k requests, not of all
    k = traffic["check_requests"]
    sampler = random.Random(seeds.derive(seed, "sample"))
    sample, n_ok = [], 0

    def keep(req):
        nonlocal n_ok
        n_ok += 1
        if len(sample) < k:
            sample.append(req)
            return
        j = sampler.randrange(n_ok)
        if j < k:
            sample[j].outputs = None
            sample[j] = req
        else:
            req.outputs = None

    requests = []
    prof = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                               torch.profiler.ProfilerActivity.CUDA])
            if trace else contextlib.nullcontext())
    with prof:
        with (torch.profiler.record_function(T.WINDOW) if trace else contextlib.nullcontext()):
            window_start = time.perf_counter()
            setup_s = window_start - t_process
            deadline = window_start + seconds
            while time.perf_counter() < deadline:
                req = one(len(requests), True)
                requests.append(req)
                if req.error is None:
                    keep(req)
            sync()
    peak = torch.cuda.max_memory_allocated(device) if device_kind == "cuda" else 0
    summary = T.summarize(prof, torch) if trace else None
    del prof, state
    gc.unfreeze()
    gc.collect()
    if device_kind == "cuda":
        torch.cuda.empty_cache()

    failed = [r for r in requests if r.error]
    for r in failed[:1]:
        print(f"request {r.plan.index} failed:\n{r.error}", file=sys.stderr)
    done = [r for r in requests if not r.error]
    reference = _by_name(root, "reference", cfg["scheme"])
    wrong, checked = len(failed), 0
    t_ref = time.perf_counter()
    for r in sorted(sample, key=lambda r: r.plan.index):
        w, n = reference.check(cfg, traffic, seed, r.plan, r.outputs, device)
        wrong, checked = wrong + w, checked + n
    log(f"# reference: {len(sample)} of {len(requests)} requests, {checked} outputs compared "
        f"in {time.perf_counter() - t_ref:.3f} s")

    in_window = [r for r in done if r.t1 <= deadline]
    log(f"# window: {len(requests)} requests run, {len(in_window)} completed in the "
        f"{seconds} s window (the samples of request_ms_p90), {len(failed)} failed")
    log("# request ms: " + " ".join(f"{(r.t1 - r.t0) * 1e3:.1f}" for r in requests))
    span_ms: dict = {}
    for r in done:
        for name, t0, t1 in r.spans:
            span_ms[name] = span_ms.get(name, 0.0) + (t1 - t0) * 1e3 / len(done)
    log("# span ms a request: " + json.dumps({k: round(v, 3) for k, v in span_ms.items()}))
    ctx = Context(cfg=cfg, traffic=traffic, setup_s=setup_s, window_start=window_start,
                  deadline=deadline, requests=requests, trace=summary, card=card, scheme=scheme,
                  plan=shapes)
    metrics = {}
    for m in bench["per_layer"] if trace else bench["end_to_end"]:
        if not applies(m, cell):
            continue
        value = _by_name(root, "metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    device_line = {"platform": "gpu" if device_kind == "cuda" else device_kind,
                   "kind": card["name"], "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(wrong == 0 and checked > 0), "attempted": len(requests),
              "failed": len(failed), "metrics": metrics, "device": device_line}
    if summary is not None:
        device_line.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = T.breakdown(summary)
    result["checks"] = {"wrong_outputs": {"value": wrong, "limit": 0}}
    return result


def main(argv=None, t_process: float | None = None, device_kind: str = "cuda") -> int:
    import argparse

    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    log = lambda s: print(s, flush=True)  # noqa: E731
    pin(PIN_CORES)
    try:
        result = run(root, args.workload, args.seed, args.seconds, bool(args.trace), t_process,
                     device_kind=device_kind, log=log)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    bad = check_modules()
    if bad:
        print(f"refused: modules loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
