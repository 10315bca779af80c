"""The PyTorch port's persistence and trace scopes
(poly_commit_tpu_torch.utils.persist / trace) on the CPU: the counterpart
of tests/test_persist_trace.py.

A nested object and a KZG10 SRS round-trip through one ``.npz`` file (the
reloaded key commits to the same point); a file written by the JAX package
names JAX classes and is refused; the POLY_COMMIT_TRACE log and the
``torch.profiler`` span of a traced entry point carry its label.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from poly_commit_tpu.pcs import kzg10 as jK  # noqa: E402
from poly_commit_tpu.utils import persist as jpersist  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core.field_params import FR_BLS12_381  # noqa: E402
from poly_commit_tpu_torch.pcs import kzg10  # noqa: E402
from poly_commit_tpu_torch.pcs.data_structures import HostRng  # noqa: E402
from poly_commit_tpu_torch.utils import persist, trace  # noqa: E402

pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files


def test_persist_roundtrip_nested(tmp_path):
    obj = {
        "arr": F.from_ints(FR_BLS12_381, [1, 2, 3], device="cpu"),
        "np": np.arange(5, dtype=np.uint16),
        "proof": kzg10.Proof(w=(123456789012345678901234567890, 42, False), random_v=7),
        "comm": [kzg10.Commitment(point=(1, 2, False))],
        "tup": (b"\x00\x01", 5, "label"),
        (3, "key"): None,
    }
    p = str(tmp_path / "obj.npz")
    persist.save(p, obj)
    back = persist.load(p, device="cpu")
    assert back["arr"].dtype == torch.int32 and back["arr"].device.type == "cpu"
    assert torch.equal(back["arr"], obj["arr"])
    assert back["np"].dtype == np.uint16 and np.array_equal(back["np"], obj["np"])
    assert back["proof"] == obj["proof"]
    assert back["comm"][0].point == (1, 2, False)
    assert back["tup"] == (b"\x00\x01", 5, "label")
    assert (3, "key") in back


@pytest.fixture(scope="module")
def srs():
    return kzg10.setup(4, rng=HostRng(1), device="cpu")


def test_persist_universal_params_and_commit(tmp_path, srs):
    """A KZG10 SRS at degree 4 survives save/load; the reloaded powers
    commit to the same point."""
    pp = srs
    p = str(tmp_path / "srs.npz")
    persist.save(p, pp)
    back = persist.load(p, device="cpu")
    assert back.max_degree == pp.max_degree and back.h == pp.h and back.beta_h == pp.beta_h
    for a, b in zip(back.powers_of_g + back.powers_of_gamma_g, pp.powers_of_g + pp.powers_of_gamma_g):
        assert a.dtype == b.dtype and torch.equal(a, b)
    coeffs = F.from_ints(FR_BLS12_381, HostRng(2).field_ints(FR_BLS12_381, 5), device="cpu")

    def commit(params):
        return kzg10.commit(kzg10.Powers(params.powers_of_g, params.powers_of_gamma_g), coeffs)[0]

    assert commit(back) == commit(pp)


def test_load_refuses_classes_outside_the_port(tmp_path):
    """A file of the JAX package names poly_commit_tpu classes: the port's
    loader raises instead of importing them."""
    p = str(tmp_path / "jax.npz")
    jpersist.save(p, {"comm": jK.Commitment(point=(1, 2, False))})
    with pytest.raises(ValueError, match="poly_commit_tpu.pcs.kzg10:Commitment"):
        persist.load(p, device="cpu")


def test_trace_scope_output(capsys, monkeypatch):
    monkeypatch.setenv("POLY_COMMIT_TRACE", "1")
    with trace.scope("outer"):
        with trace.scope("inner"):
            pass
    err = capsys.readouterr().err
    assert "Start: outer" in err and "··Start: inner" in err and "End: inner" in err


def test_trace_scope_is_silent_when_off(capsys, monkeypatch):
    monkeypatch.delenv("POLY_COMMIT_TRACE", raising=False)
    with trace.scope("outer"):
        pass
    assert capsys.readouterr().err == ""


def test_traced_entry_point_shows_its_label_under_the_profiler(monkeypatch, srs):
    from torch.profiler import ProfilerActivity, profile

    from poly_commit_tpu_torch.pcs.marlin_pc import MarlinKZG10

    monkeypatch.setenv("POLY_COMMIT_TRACE", "1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        MarlinKZG10.trim(srs, 4)
    assert "MarlinKZG10::trim" in {e.key for e in prof.key_averages()}
