"""The multilinear Ligero cell on the CPU (``torch_trace_cells``' tiny
twin of ``ligero_ml.bn254.nv22.prove``, nv 8): a traced run comes out
correct and reports the new per-layer metrics that need no card, with
``hashed_bytes`` as the shapes give it; the control and three planted
faults in a request's outputs read not correct; the five readers on a
synthetic window; ``ntt_roofline``'s yardstick. No JAX."""

import contextlib
import copy
import importlib
import json
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from poly_commit_tpu_torch.utils import trace  # noqa: E402
from port_bench import harness, inputs  # noqa: E402
from port_bench.metrics import _program  # noqa: E402
from port_bench.reference import ligero_ml as R  # noqa: E402
from port_bench.schemes import ligero_ml as S  # noqa: E402
from tests import torch_trace_cells as cells  # noqa: E402

CFG = cells.ADDED["configs/tiny_ligero.json"]
TRAFFIC = json.loads((cells.REPO / "port_bench/traffic/commit_open.json").read_text())
MS = 1_000_000  # ns


def hashed_bytes(cfg, poly_len):
    """Blake2s over every encoded column's canonical bytes, then two trees
    (commit's, open's) of ext - 1 SHA-256 compressions of 64 bytes."""
    rows, _, ext, _ = R.dimensions(cfg, poly_len)
    return ext * rows * 32 + 2 * (ext - 1) * 64


def test_traced_tiny_ligero_reports_its_metrics(tmp_path):
    bench = cells.checkout(tmp_path)
    metrics = cells.check_result(bench, "tiny.ligero", cells.run_traced(tmp_path, "tiny.ligero"))
    assert set(metrics) == set(cells.LIGERO) - {"ntt_roofline"}  # no device trace here
    assert metrics["hashed_bytes"]["value"] == hashed_bytes(CFG, 1 << CFG["num_vars"]) == 49024
    assert metrics["merkle_ms"]["value"] > 0 and metrics["leaf_hash_ms"]["value"] > 0


@pytest.fixture(scope="module")
def request_outputs():
    """One request through the adapter on the CPU, its plan, and a run of
    the control."""
    seed, dev = 2**31 + 101, torch.device("cpu")
    ck = S.setup(CFG, None, seed, dev)
    plan = inputs.plan(TRAFFIC, CFG, S, seed, 4)
    nospan = lambda name: contextlib.nullcontext()  # noqa: E731
    sound = S.request(ck, CFG, plan, seed, dev, nospan)
    control = S.request(ck, CFG, plan, seed, dev, nospan, control=True)
    return seed, plan, sound, control


def _check(seed, plan, outputs):
    return R.check(CFG, TRAFFIC, seed, plan, outputs, "cpu")


def _flip_limb(out):
    out["encoded"]["p"] = out["encoded"]["p"].clone()
    out["encoded"]["p"][1, 5, 3] ^= 1


def _swap_columns(out):
    pf = out["proofs"][0][0]
    paths = pf["paths"]
    j = next(j for j in range(1, len(paths)) if paths[j][0] != paths[0][0])
    pf["columns"] = list(pf["columns"])
    pf["columns"][0], pf["columns"][j] = pf["columns"][j], pf["columns"][0]


def _change_root_byte(out):
    root = bytearray(out["commitments"]["p"]["root"])
    root[7] ^= 0x40
    out["commitments"]["p"]["root"] = bytes(root)


def test_sound_request_is_correct(request_outputs):
    seed, plan, sound, _ = request_outputs
    wrong, checked = _check(seed, plan, sound)
    assert wrong == 0 and checked == 9
    assert sound["commitments"]["p"]["metadata"] == R.dimensions(CFG, 1 << CFG["num_vars"])[:3]


def test_control_is_not_correct(request_outputs):
    seed, plan, _, control = request_outputs
    assert _check(seed, plan, control)[0] > 0


@pytest.mark.parametrize("plant", [_flip_limb, _swap_columns, _change_root_byte])
def test_planted_fault_is_not_correct(request_outputs, plant):
    seed, plan, sound, _ = request_outputs
    out = copy.copy(sound)
    out["commitments"] = copy.deepcopy(sound["commitments"])
    out["encoded"] = dict(sound["encoded"])
    out["proofs"] = copy.deepcopy(sound["proofs"])
    plant(out)
    assert _check(seed, plan, out)[0] > 0
    assert _check(seed, plan, sound)[0] == 0  # the sound outputs were not touched


# ---------------------------------------------------------------------------
# the readers
# ---------------------------------------------------------------------------


def rec(id, parent, root, name, t0_ms, t1_ms, **counts):
    r = trace.Record(id, parent, root, name, 1000 * MS + t0_ms * MS)
    r.end_ns = 1000 * MS + t1_ms * MS
    r.counts = dict(counts)
    return r


def request(t0_ms, t1_ms, error=None):
    r = harness.Request(plan=None, t0=1.0 + t0_ms / 1e3, t1=1.0 + t1_ms / 1e3)
    r.error = error
    return r


REQUESTS = [request(0, 1000), request(1000, 2000), request(2000, 3000, error="failed")]
RECORDS = [
    # request 1: a commit's encode, leaves (with their read) and tree; an open's tree and paths
    rec(1, None, 1, "LinearCodePCS::commit", 100, 700),
    rec(2, 1, 1, "LinearCode::encode", 100, 200),
    rec(3, 1, 1, "Merkle::leaves", 200, 500, hashed_bytes=1000),
    rec(4, 3, 1, "Serialize::to_host", 250, 300, host_syncs=1),
    rec(5, 1, 1, "Merkle::tree", 500, 600, hashed_bytes=640),
    rec(6, None, 6, "LinearCodePCS::open", 700, 950),
    rec(7, 6, 6, "Merkle::tree", 700, 800, hashed_bytes=640),
    rec(8, 6, 6, "Merkle::tree", 900, 910),
    # request 2: an encode only; the failed request's records are left out
    rec(9, None, 9, "LinearCode::encode", 1100, 1160),
    rec(10, None, 10, "Merkle::tree", 2100, 2200, hashed_bytes=640),
]
EXPECTED = {"encode_ms": (100 + 60) / 2, "leaf_hash_ms": 250 / 2,
            "merkle_ms": (100 + 100 + 10) / 2, "hashed_bytes": (1000 + 640 + 640) / 2}


def reader(name):
    return importlib.import_module(f"port_bench.metrics.{name}")


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_a_synthetic_window(monkeypatch, name):
    ctx = types.SimpleNamespace(requests=REQUESTS)
    monkeypatch.setattr(_program, "records", lambda: list(RECORDS))
    assert reader(name).read(ctx) == pytest.approx(EXPECTED[name])
    monkeypatch.setattr(_program, "records", lambda: [rec(1, None, 1, "Hyrax::commit", 1, 2)])
    assert reader(name).read(ctx) is None


def test_ntt_roofline_yardstick():
    M = reader("ntt_roofline")
    assert M.butterflies([(256, 15)]) == 62_914_560
    assert M.imad_per_butterfly("bn254") == 264
    assert {"k_fused", "k_stages", "k_small", "k_butterfly"} <= M.kernel_names()
    assert S.ntt_shapes({**CFG, "num_vars": 22}, inputs.plan(TRAFFIC, {**CFG, "num_vars": 22},
                                                             S, 1, 0)) == [(256, 15)]


def test_ntt_roofline_reads_the_ntt_kernels():
    M = reader("ntt_roofline")
    kernels = {"k_fused(int const*, int const*, int*, long, int, int, long, FieldConsts)": 1.5e-3,
               "k_stages(int const*, StageTw, int*, long, int, int, int, FieldConsts)": 0.5e-3,
               "k_scan<Fp<8> >(ScanArgs, long, int, FieldConsts)": 9.0}
    summary = types.SimpleNamespace(kernels=kernels)
    scheme = types.SimpleNamespace(ntt_shapes=lambda cfg, plan: [(256, 15)])
    ctx = types.SimpleNamespace(trace=summary, cfg={**CFG, "num_vars": 22}, plan=None,
                                requests=REQUESTS, card={"imad_per_s": 16.727e12}, scheme=scheme)
    want = 100 * 2 * 62_914_560 * 264 / 16.727e12 / 2.0e-3  # two requests completed
    assert M.read(ctx) == pytest.approx(want)
    ctx.scheme = types.SimpleNamespace()
    assert M.read(ctx) is None
