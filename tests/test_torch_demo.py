"""The port's entry point, poly_commit_tpu_torch/demo.py, on the CPU.

Each drive runs as ``python -m poly_commit_tpu_torch.demo --device cpu``
runs it (the kernels' plain versions): the check passes and the tamper
probe is rejected. For MarlinKZG10, IPA-PC and MultilinearLigero the
drive's commitments (host points, Merkle roots) and opened values are held
against the JAX package's same public calls from the same HostRng seed,
with tolerance 0. Also: the name filter, the exit code of a failing
scheme, and the refusal to run without a CUDA device unless asked for the
CPU. The drives of SonicKZG10, MarlinPST13 and streaming KZG are in
test_torch_demo_kzg.py, those of MultilinearPC and Hyrax in
test_torch_demo_multilinear.py, so that no file holds a worker much over
a minute.
"""

import functools
import io

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field as jF  # noqa: E402
import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu.pcs.data_structures as jDS  # noqa: E402
from poly_commit_tpu.pcs.ipa_pc import InnerProductArgPC as JIpa  # noqa: E402
from poly_commit_tpu.pcs.linear_codes import MultilinearLigero as JMlLigero  # noqa: E402
from poly_commit_tpu.pcs.marlin_pc import MarlinKZG10 as JMarlin  # noqa: E402
from poly_commit_tpu_torch import demo  # noqa: E402
from poly_commit_tpu_torch.pcs import errors  # noqa: E402
from poly_commit_tpu_torch.pcs.linear_codes import MultilinearBrakedown  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SCHEMES_HERE = ("marlin_kzg10", "ipa_pc", "univariate_ligero", "multilinear_ligero", "brakedown")


@functools.lru_cache(maxsize=None)
def _drive(name):
    return demo.run_scheme(name, "cpu")


def _jax_univariate(PC, degree=8, max_degree=16, hiding=True, enforced=None, bound=None):
    """The reference demo's drive_univariate up to batch_open: (comms, values)."""
    rng = jDS.HostRng(42)
    pp = PC.setup(max_degree, rng=rng)
    ck, _ = PC.trim(pp, degree, 2 if hiding else 0, enforced)
    poly_degree = bound if bound is not None else degree
    lp = jDS.LabeledPolynomial(
        "p", jF.from_ints(PC.spec, rng.field_ints(PC.spec, poly_degree + 1)),
        degree_bound=bound, hiding_bound=2 if hiding else None)
    comms, states = PC.commit(ck, [lp], rng)
    qs = {("p", ("pt", rng.field_int(PC.spec)))}
    _, values = PC.batch_open(ck, [lp], comms, qs, jT.PoseidonSponge(PC.spec), states, rng)
    return comms, values


def _jax_multilinear(PC, nv=4):
    """The reference demo's drive_multilinear up to batch_open (not Hyrax)."""
    rng = jDS.HostRng(43)
    pp = PC.setup(0, num_vars=nv, rng=rng)
    ck, _ = PC.trim(pp, 0, 0, None)
    lp = jDS.LabeledPolynomial("p", jF.from_ints(PC.spec, rng.field_ints(PC.spec, 1 << nv)),
                               num_vars=nv)
    comms, states = PC.commit(ck, [lp], rng)
    qs = {("p", ("pt", tuple(rng.field_int(PC.spec) for _ in range(nv))))}
    _, values = PC.batch_open(ck, [lp], comms, qs, jT.PoseidonSponge(PC.spec), states, rng)
    return comms, values


def _points(comms):
    return [(c.label, c.degree_bound, c.commitment.comm, c.commitment.shifted_comm) for c in comms]


def _roots(comms):
    m = [c.commitment.metadata for c in comms]
    return [(c.label, c.commitment.root, x.n_rows, x.n_cols, x.n_ext_cols) for c, x in zip(comms, m)]


REFERENCE = {
    "marlin_kzg10": (lambda: _jax_univariate(JMarlin, enforced=[6], bound=6), _points),
    "ipa_pc": (lambda: _jax_univariate(JIpa, degree=7, max_degree=7), _points),
    "multilinear_ligero": (lambda: _jax_multilinear(JMlLigero), _roots),
}


@pytest.mark.parametrize("name", SCHEMES_HERE)
def test_drive_ok_and_tamper_rejected(name):
    res = _drive(name)
    assert res.error is None, res.error
    assert res.ok is True
    assert res.tamper_rejected is True
    assert set(res.ms) == set(demo.PHASES)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_drive_matches_jax(name):
    reference, view = REFERENCE[name]
    res = _drive(name)
    comms, values = reference()
    assert view(res.commitments) == view(comms)
    assert res.values == values


@pytest.mark.parametrize("filters, want", [
    ((), list(demo.NAMES)),
    (("marlin",), ["marlin_kzg10"]),
    (("ligero",), ["univariate_ligero", "multilinear_ligero"]),
    (("pc",), ["multilinear_pc"]),  # a substring of a scheme's word, as in the reference
    (("XZZPD", "streaming"), ["multilinear_pc", "streaming_kzg"]),
])
def test_filter_selects_like_the_reference(filters, want):
    assert demo.selected(filters) == want


def test_main_prints_ok_and_times(capsys):
    assert demo.main(["ligero", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if ln.startswith("OK ")] == [
        "OK univariate_ligero", "OK multilinear_ligero"]
    times = [ln.split() for ln in lines if ln.startswith("time ")]
    assert [t[1] for t in times] == ["univariate_ligero", "multilinear_ligero"]
    assert all(t[-1] == "ms" and [f.split("=")[0] for f in t[2:-1]] == list(demo.PHASES)
               for t in times)
    assert lines[-1] == "all driven schemes OK"


def test_no_cuda_device_raises(monkeypatch):
    """No fallback: without a CUDA device and without --device cpu, the
    demo raises before any scheme runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.run(["brakedown"], out=out)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.run_scheme("brakedown")
    assert out.getvalue() == ""


def _raise(*args, **kw):
    raise RuntimeError("kernel launch failed")


@pytest.mark.parametrize("fault, verdict", [
    ("commit_raises", "FAIL brakedown (check=False, tamper-rejected=False)"),
    ("check_accepts_all", "FAIL brakedown (check=True, tamper-rejected=False)"),
    ("check_rejects_all", "FAIL brakedown (check=False, tamper-rejected=True)"),
    ("tamper_raises_other", "FAIL brakedown (check=True, tamper-rejected=False)"),
    ("tamper_raises_pc_error", "OK brakedown"),
])
def test_failing_scheme_exits_nonzero(monkeypatch, capsys, fault, verdict):
    """A scheme that raises or misjudges is reported as FAIL and the exit
    code is 1; only the scheme's own error counts as a rejection."""
    check = MultilinearBrakedown.batch_check.__func__
    calls = []

    def second_call_raises(exc):
        def batch_check(cls, *args):
            calls.append(1)
            if len(calls) == 2:
                raise exc
            return check(cls, *args)
        return classmethod(batch_check)

    patch = {
        "commit_raises": ("commit", classmethod(_raise)),
        "check_accepts_all": ("batch_check", classmethod(lambda cls, *a: True)),
        "check_rejects_all": ("batch_check", classmethod(lambda cls, *a: False)),
        "tamper_raises_other": ("batch_check", second_call_raises(RuntimeError("launch"))),
        "tamper_raises_pc_error": ("batch_check", second_call_raises(errors.MissingEvaluation())),
    }[fault]
    monkeypatch.setattr(MultilinearBrakedown, *patch)
    rc = demo.main(["brakedown", "--device", "cpu"])
    captured = capsys.readouterr()
    assert captured.out.splitlines()[0] == verdict
    if verdict.startswith("OK"):
        assert rc == 0
    else:
        assert rc == 1
        assert "FAILED: ['brakedown']" in captured.out
