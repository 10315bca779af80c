"""The port's spans and counters (poly_commit_tpu_torch.utils.trace) on the
CPU.

With no profiler and no POLY_COMMIT_TRACE a commit and an opening keep no
record and never enter ``record_function``. Under ``torch.profiler`` a tiny
MarlinKZG10 commit and open and a Hyrax commit and open (one profile,
module-scoped) leave the span tree the benchmark's readers take apart:
``MSM::fold_host`` under ``MSM::msm`` under ``KZG10::commit``, one root a
top-level call, a loop of absorbs as one record, counts on the innermost
span, self times that add up to the root's duration, and the profiler's
events under the same names. No JAX: the port alone.
"""

import contextlib

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core.transcript import PoseidonSponge  # noqa: E402
from poly_commit_tpu_torch.pcs.data_structures import (  # noqa: E402
    HostRng, LabeledPolynomial, fresh_sponge)
from poly_commit_tpu_torch.pcs.hyrax import HyraxPC  # noqa: E402
from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10  # noqa: E402
from poly_commit_tpu_torch.utils import trace  # noqa: E402

DEGREE = 7
NUM_VARS = 4


@pytest.fixture(scope="module")
def keys():
    marlin_ck, _ = MarlinKZG10.trim(MarlinKZG10.setup(DEGREE, rng=HostRng(1), device="cpu"),
                                    DEGREE)
    hyrax_ck, _ = HyraxPC.trim(HyraxPC.setup(0, num_vars=NUM_VARS, device="cpu"))
    return marlin_ck, hyrax_ck


def marlin_round_trip(ck):
    """One commitment of a polynomial without hiding or bound, opened at 5."""
    spec = MarlinKZG10.spec
    lp = LabeledPolynomial("a", F.from_ints(spec, HostRng(2).field_ints(spec, DEGREE + 1),
                                            device="cpu"))
    comms, states = MarlinKZG10.commit(ck, [lp], HostRng(3))
    return MarlinKZG10.batch_open(ck, [lp], comms, {("a", ("z", 5))}, fresh_sponge(spec),
                                  states, HostRng(4))


def hyrax_round_trip(ck):
    spec = HyraxPC.spec
    lp = LabeledPolynomial("h", F.from_ints(spec, HostRng(5).field_ints(spec, 1 << NUM_VARS),
                                            device="cpu"), num_vars=NUM_VARS)
    comms, states = HyraxPC.commit(ck, [lp], HostRng(6))
    point = tuple(HostRng(7).field_ints(spec, NUM_VARS))
    return HyraxPC.batch_open(ck, [lp], comms, {("h", ("p", point))}, fresh_sponge(spec),
                              states, HostRng(8))


@pytest.fixture(scope="module")
def traced(keys):
    """(records, the profiler's event names, the Marlin and Hyrax results)
    of one profile holding a Marlin and a Hyrax round trip."""
    marlin_ck, hyrax_ck = keys
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        marlin = marlin_round_trip(marlin_ck)
        hyrax = hyrax_round_trip(hyrax_ck)
    recs = trace.records()
    trace.reset()
    return recs, event_names(prof), marlin, hyrax


def event_names(prof):
    """The names of a profile's events, from its raw results (building
    ``key_averages`` takes minutes for the plain MSMs' millions of ops)."""
    return {e.name() for e in prof.profiler.kineto_results.events()}


def by_id(recs):
    return {r.id: r for r in recs}


def ancestors(rec, ids):
    out = []
    while rec.parent is not None:
        rec = ids[rec.parent]
        out.append(rec.name)
    return out


def test_off_keeps_no_record_and_enters_no_range(keys, monkeypatch):
    """Neither switch on: no record, and record_function is never entered."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with tracing off")

    monkeypatch.delenv("POLY_COMMIT_TRACE", raising=False)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trace.reset()
    assert not trace.recording()
    marlin_round_trip(keys[0])
    assert trace.records() == [] and trace.dropped() == 0


def test_untraced_results_equal_traced(keys, traced):
    """The spans change no result: the Hyrax round trip untraced gives the
    traced run's proof and value."""
    proofs, values = hyrax_round_trip(keys[1])
    assert (proofs, values) == traced[3]


def test_fold_host_sits_under_msm_under_kzg_commit(traced):
    recs = traced[0]
    ids = by_id(recs)
    folds = [r for r in recs if r.name == "MSM::fold_host"]
    assert folds
    commit_folds = [r for r in folds if "KZG10::commit" in ancestors(r, ids)]
    assert commit_folds
    for r in commit_folds:
        assert ancestors(r, ids)[:3] == ["MSM::msm", "KZG10::commit", "MarlinKZG10::commit"]
    # the fold's reads from the card are its children
    reads = [r for r in recs if r.parent == commit_folds[0].id]
    assert reads and {r.name for r in reads} == {"Serialize::to_host"}


def test_one_root_a_top_level_call(traced):
    recs = traced[0]
    ids = by_id(recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["MarlinKZG10::commit", "PC::batch_open",
                                      "Hyrax::commit", "PC::batch_open"]
    for r in roots:
        assert r.root == r.id
    for r in recs:
        top = r
        while top.parent is not None:
            top = ids[top.parent]
        assert r.root == top.id


def test_spans_nest_in_time(traced):
    recs = traced[0]
    ids = by_id(recs)
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
        if r.parent is not None:
            p = ids[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
            assert p.name != r.name  # a scope named as its parent records nothing


def test_absorb_loop_is_one_record(traced):
    """Hyrax's statement (the key's 2^(nv/2) + 1 points, the row
    commitments, the point) is one Transcript::absorb record; then one for
    each of com_eval, com_d and com_b."""
    recs = traced[0]
    ids = by_id(recs)
    opening = next(r for r in recs if r.name == "Hyrax::open")
    absorbs = [r for r in recs if r.name == "Transcript::absorb" and r.parent == opening.id]
    assert len(absorbs) == 4
    dim = 1 << (NUM_VARS // 2)
    points = 2 * dim + 1  # key, h, rows
    # each point absorbs its length and its bytes; two rate slots a permutation
    assert absorbs[0].counts["poseidon_permutations"] >= points
    assert all(ids[r.parent].name == "Hyrax::open" for r in absorbs)


def test_counts_sit_on_the_innermost_span(traced):
    recs = traced[0]
    where = {}
    for r in recs:
        for name in r.counts:
            where.setdefault(name, set()).add(r.name)
    assert where["msm_points_run"] == {"MSM::msm", "MSM::msm_rows"}
    assert where["poseidon_permutations"] <= {"Transcript::absorb", "Transcript::squeeze"}
    assert "Serialize::to_host" in where["host_syncs"]
    folds = [r for r in recs if r.name == "MSM::fold_host"]
    assert all("host_syncs" not in r.counts for r in folds)  # its reads are children
    reads = [r for r in recs if r.name == "Serialize::to_host"
             and r.parent in {f.id for f in folds}]
    assert reads and all(r.counts == {"host_syncs": 1} for r in reads)


def test_device_folds_count_hyrax_rows(traced):
    """msm_device_folds sits on MSM::fold_device under Hyrax's commit and
    counts its row MSMs; Marlin's CPU MSMs still fold on host ints."""
    recs = traced[0]
    ids = by_id(recs)
    folds = [r for r in recs if "msm_device_folds" in r.counts]
    dim = 1 << (NUM_VARS // 2)
    assert folds and all(r.name == "MSM::fold_device" for r in folds)
    assert all(r.counts["msm_device_folds"] == dim and "Hyrax::commit" in ancestors(r, ids)
               for r in folds)
    assert [r for r in recs if r.name == "MSM::fold_host"
            and "MarlinKZG10::commit" in ancestors(r, ids)]


def test_msm_points_run_counts_padded_points(traced):
    """A CPU MSM of n points scans max(16, next power of two) (16 lanes);
    Hyrax's msm_rows scans its rows times the padded row length."""
    recs = traced[0]
    runs = [(r.name, r.counts["msm_points_run"]) for r in recs if "msm_points_run" in r.counts]
    dim = 1 << (NUM_VARS // 2)
    assert ("MSM::msm_rows", dim * dim) in runs
    assert ("MSM::msm", 16) in runs  # Marlin's 8 coefficients, Hyrax's 4-point com_d


def test_self_times_add_up_to_each_root(traced):
    recs = traced[0]
    own = {r.id: r.end_ns - r.start_ns for r in recs}
    for r in recs:
        if r.parent is not None:
            own[r.parent] -= r.end_ns - r.start_ns
    assert all(v >= 0 for v in own.values())
    for root in (r for r in recs if r.parent is None):
        assert sum(own[r.id] for r in recs if r.root == root.id) == root.end_ns - root.start_ns


def test_profiler_events_carry_the_span_names(traced):
    recs, names = traced[:2]
    assert {r.name for r in recs} <= names
    assert {"MSM::msm", "MSM::fold_host", "MSM::msm_rows", "MSM::fold_device",
            "MSM::fixed_base", "Serialize::to_host", "Transcript::absorb",
            "Transcript::squeeze", "Poly::evaluate", "Poly::divide", "Poly::tensor",
            "Poly::combine", "PC::batch_open"} <= {r.name for r in recs}


def test_scheme_labels_keep_their_names(traced):
    names = {r.name for r in traced[0]}
    assert {"MarlinKZG10::commit", "KZG10::commit", "MarlinKZG10::open", "KZG10::open",
            "Hyrax::commit", "Hyrax::open"} <= names


def test_same_name_scope_records_once():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.scope("Outer", log=False):
            with trace.scope("Outer", log=False):
                trace.count("n")
                with trace.scope("Inner", log=False):
                    trace.count("n", 2)
            trace.count("n")
    recs = trace.records()
    trace.reset()
    assert [(r.name, r.counts) for r in recs] == [("Outer", {"n": 2}), ("Inner", {"n": 2})]
    assert recs[1].parent == recs[0].id and recs[1].root == recs[0].id


def test_sponge_loop_under_one_span():
    sponge = PoseidonSponge(MarlinKZG10.spec)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.scope("Transcript::absorb", log=False):
            for i in range(10):
                sponge.absorb_field([i, i + 1])
                sponge.absorb_bytes(bytes([i]) * 40)
        sponge.squeeze_challenges_128(3)
    recs = trace.records()
    trace.reset()
    assert [r.name for r in recs] == ["Transcript::absorb", "Transcript::squeeze"]
    assert recs[0].counts["poseidon_permutations"] >= 20
    assert recs[1].counts["poseidon_permutations"] == 2  # the mode switch, then one refill


def test_the_cap_holds(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with trace.scope(f"S{i}", log=False):
                trace.count("n")
    recs = trace.records()
    assert [r.name for r in recs] == ["S0", "S1", "S2"] and trace.dropped() == 2
    assert {f"S{i}" for i in range(5)} <= event_names(prof)
    trace.reset()
    assert trace.records() == [] and trace.dropped() == 0


def test_counts_outside_a_profile_do_nothing():
    trace.reset()
    with trace.scope("S", log=False):
        trace.count("n", 5)
    assert trace.records() == []


@pytest.mark.parametrize("log,printed", [(True, True), (False, False)])
def test_only_logging_scopes_print(capsys, monkeypatch, log, printed):
    monkeypatch.setenv("POLY_COMMIT_TRACE", "1")
    with trace.scope("Labelled", log=log):
        pass
    err = capsys.readouterr().err
    assert ("Start: Labelled" in err and "End: Labelled" in err) is printed
    assert printed or err == ""


def test_log_and_record_together(capsys, monkeypatch):
    """Both switches on: the log prints and the scope records."""
    monkeypatch.setenv("POLY_COMMIT_TRACE", "1")
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.scope("Both"):
            pass
    assert [r.name for r in trace.records()] == ["Both"]
    trace.reset()
    assert "Start: Both" in capsys.readouterr().err


def test_an_error_closes_the_span():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with contextlib.suppress(ValueError):
            with trace.scope("Failing", log=False):
                raise ValueError("x")
        with trace.scope("After", log=False):
            pass
    recs = trace.records()
    trace.reset()
    assert [(r.name, r.parent) for r in recs] == [("Failing", None), ("After", None)]
    assert all(r.end_ns is not None for r in recs)
