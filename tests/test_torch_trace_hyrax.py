"""Traced runs of tiny Hyrax cells on the CPU (``torch_trace_cells``): a
commit reports exactly the four new metrics that ``hyrax.nv22.commit``
lists (no transcript, no host fold, no polynomial op), a commit and open
all eight; rows a power of two long pad nothing. No JAX."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from tests import torch_trace_cells as cells  # noqa: E402


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    return root, cells.checkout(root)


@pytest.mark.parametrize("cell,count", [("tiny.hyrax.commit", 4), ("tiny.hyrax.prove", 8)])
def test_traced_tiny_hyrax_reports_its_metrics(checkout, cell, count):
    root, bench = checkout
    metrics = cells.check_result(bench, cell, cells.run_traced(root, cell))
    assert len(cells.listed(bench, cell)) == count
    if cell == "tiny.hyrax.commit":
        assert metrics["msm_useful_share"]["value"] == 100.0
    else:  # com_d's MSM of 2^(nv/2) points runs at least 16 lanes on the CPU
        assert metrics["transcript_permutations"]["value"] > 0
