"""The port's entry point (poly_commit_tpu_torch/demo.py) on the CPU: the
SonicKZG10, MarlinPST13 and streaming KZG drives, as
``python -m poly_commit_tpu_torch.demo --device cpu`` runs them (the
kernels' plain versions): each check passes and each tamper probe is
rejected. test_torch_demo.py has the other drives and the entry point's
options; the drives are split across files so that none holds a test
worker much over a minute (each here takes ~17 s).
"""

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from poly_commit_tpu_torch import demo  # noqa: E402


@pytest.mark.parametrize("name", ["sonic_kzg10", "pst13", "streaming_kzg"])
def test_drive_ok_and_tamper_rejected(name):
    res = demo.run_scheme(name, "cpu")
    assert res.error is None, res.error
    assert res.ok is True
    assert res.tamper_rejected is True
    assert set(res.ms) == set(demo.PHASES)
