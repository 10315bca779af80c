"""The benchmark's readers of the port's spans and counters
(``port_bench/metrics/`` over ``poly_commit_tpu_torch.utils.trace``).

Each of the eight readers runs on a synthetic window: records go to the
completed request whose interval holds them, failed requests and records
outside every request are left out, self times subtract child spans of
other families, counters sum, ``msm_useful_share`` divides the points the
work needs by the points run, and a reader returns None where the window
holds no record of its family or the port keeps no records. Then a traced
run of a tiny Marlin cell on the CPU (``torch_trace_cells``) reports all
eight; ``test_torch_trace_hyrax.py`` runs the Hyrax cells. No JAX.
"""

import importlib
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from poly_commit_tpu_torch.utils import trace  # noqa: E402
from port_bench.harness import Request  # noqa: E402
from port_bench.metrics import _program  # noqa: E402
from tests import torch_trace_cells as cells  # noqa: E402

NEW = cells.NEW
MS = 1_000_000  # ns


def reader(name):
    return importlib.import_module(f"port_bench.metrics.{name}")


def rec(id, parent, root, name, t0_ms, t1_ms, **counts):
    """A record of span ``name`` from t0 to t1 ms after the clock's 1 s."""
    r = trace.Record(id, parent, root, name, 1000 * MS + t0_ms * MS)
    r.end_ns = None if t1_ms is None else 1000 * MS + t1_ms * MS
    r.counts = dict(counts)
    return r


def request(t0_ms, t1_ms, error=None):
    r = Request(plan=None, t0=1.0 + t0_ms / 1e3, t1=1.0 + t1_ms / 1e3)
    r.error = error
    return r


REQUESTS = [request(0, 1000), request(1000, 2000), request(2000, 3000, error="failed")]
RECORDS = [
    # request 1: a commit with an MSM, its host fold and a read, a division; an absorb
    rec(1, None, 1, "MarlinKZG10::commit", 100, 900, host_syncs=2),
    rec(2, 1, 1, "MSM::msm", 200, 600, msm_points_run=100, host_syncs=1),
    rec(3, 2, 1, "MSM::fold_host", 300, 500),
    rec(4, 3, 1, "Serialize::to_host", 350, 400, host_syncs=1),
    rec(5, 1, 1, "Poly::divide", 600, 700),
    rec(6, None, 6, "Transcript::absorb", 920, 950, poseidon_permutations=3),
    # request 2: an opening
    rec(7, None, 7, "PC::batch_open", 1100, 1900),
    rec(8, 7, 7, "Transcript::squeeze", 1200, 1300, poseidon_permutations=1),
    rec(9, 7, 7, "Poly::evaluate", 1300, 1500, host_syncs=4),
    rec(10, 9, 7, "Serialize::to_host", 1400, 1450, host_syncs=1),
    rec(11, 7, 7, "MSM::msm", 1500, 1800, msm_points_run=300),
    # the failed request, a record after every request, one left open
    rec(12, None, 12, "Transcript::absorb", 2100, 2200, poseidon_permutations=50),
    rec(13, None, 13, "Transcript::absorb", 4100, 4200, poseidon_permutations=70),
    rec(14, None, 14, "MSM::fold_host", 4300, None),
]
SCHEME = types.SimpleNamespace(msm_points=lambda cfg, plan: 150)
EXPECTED = {
    "transcript_ms": (30 + 100) / 2,
    "transcript_permutations": (3 + 1) / 2,
    "host_fold_ms": (150 + 0) / 2,  # the fold less its read
    "to_host_ms": (50 + 50) / 2,
    "host_syncs": (4 + 5) / 2,
    "poly_ms": (100 + 150) / 2,  # the evaluation less its read
    "msm_host_ms": (200 + 300) / 2,  # the first MSM less its fold
    "msm_useful_share": 100 * 150 / 200,
}


def ctx(scheme=SCHEME):
    return types.SimpleNamespace(requests=REQUESTS, scheme=scheme, cfg={}, plan=None)


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_synthetic_window(monkeypatch, name):
    monkeypatch.setattr(_program, "records", lambda: list(RECORDS))
    assert reader(name).read(ctx()) == pytest.approx(EXPECTED[name])


def test_records_go_to_the_request_that_holds_them():
    held = _program.by_request(REQUESTS, RECORDS)
    assert [(r.t0, [x.id for x in rs]) for r, rs in held] == [
        (1.0, [1, 2, 3, 4, 5, 6]), (2.0, [7, 8, 9, 10, 11])]


def test_self_times_add_up_to_the_roots():
    own = _program.self_ns(RECORDS)
    for root in (r for r in RECORDS if r.parent is None and r.end_ns is not None):
        assert sum(own[r.id] for r in RECORDS if r.root == root.id) == root.end_ns - root.start_ns
    assert own[2] == 200 * MS and own[3] == 150 * MS and 14 not in own


@pytest.mark.parametrize("name", NEW)
def test_reader_finds_nothing_to_read(monkeypatch, name):
    """No record at all (an untraced run); a port whose trace module keeps
    none (an older port); records of other families only."""
    monkeypatch.setattr(_program, "records", lambda: [])
    assert reader(name).read(ctx()) is None
    others = [rec(1, None, 1, "Hyrax::commit", 100, 900)]
    monkeypatch.setattr(_program, "records", lambda: others)
    assert reader(name).read(ctx()) is None


def test_a_port_without_records_gives_none(monkeypatch):
    monkeypatch.delattr(trace, "records")
    assert _program.records() == []


def test_errored_and_outside_records_are_left_out(monkeypatch):
    only_failed = [r for r in RECORDS if r.id in (12, 13, 14)]
    monkeypatch.setattr(_program, "records", lambda: only_failed)
    for name in NEW:
        assert reader(name).read(ctx()) is None


def test_useful_share_needs_the_schemes_points(monkeypatch):
    monkeypatch.setattr(_program, "records", lambda: list(RECORDS))
    assert reader("msm_useful_share").read(ctx(scheme=types.SimpleNamespace())) is None
    assert reader("msm_useful_share").share(0, 10) is None
    assert reader("msm_useful_share").share(5, 10) == 50.0


# ---------------------------------------------------------------------------
# a traced run of a tiny Marlin cell on the CPU (the Hyrax cells: their own files)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def marlin(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    bench = cells.checkout(root)
    return bench, cells.run_traced(root, "tiny.marlin")


def test_traced_tiny_marlin_reports_its_metrics(marlin):
    bench, result = marlin
    metrics = cells.check_result(bench, "tiny.marlin", result)
    assert cells.listed(bench, "tiny.marlin") == set(cells.NEW)
    assert metrics["transcript_permutations"]["value"] > 0
    assert metrics["host_fold_ms"]["value"] > 0 and metrics["poly_ms"]["value"] > 0
