"""The PyTorch port's digit grouping (poly_commit_tpu_torch.core.sort_gpu,
K3) against the JAX package's Pallas bitonic argsort in interpret mode.

Only the grouping must match: equal sorted keys, and an order that is a
permutation with keys[order] == sorted (the order inside equal keys is
free). The port also returns inclusive per-key counts, the MSM's bucket
tails, checked against numpy.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from poly_commit_tpu.core import sort_tpu  # noqa: E402
from poly_commit_tpu_torch.core import sort_gpu  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SENTINEL = 1 << 16


def _keys(kind, w=3, n=1024):
    rng = np.random.default_rng(["uniform", "duplicates", "sentinels"].index(kind))
    if kind == "uniform":
        return rng.integers(0, SENTINEL + 1, size=(w, n)).astype(np.uint32)
    keys = np.zeros((w, n), np.uint32)
    if kind == "duplicates":
        keys[0] = rng.integers(0, 4, size=n)
        keys[1] = 7
        keys[2] = rng.integers(0, 2, size=n) * SENTINEL
    else:
        keys[0, : n // 2] = SENTINEL
        keys[0, n // 2 :] = rng.integers(0, SENTINEL, size=n // 2)
        keys[1] = SENTINEL
        keys[2] = rng.integers(SENTINEL - 3, SENTINEL + 1, size=n)
    return keys


def _check_grouping(keys, order, sorted_keys):
    for wi in range(keys.shape[0]):
        assert sorted(order[wi].tolist()) == list(range(keys.shape[1]))
        assert np.array_equal(keys[wi][order[wi]], sorted_keys[wi])


@pytest.mark.parametrize("kind", ["uniform", "duplicates", "sentinels"])
def test_grouping_matches_bitonic_argsort(kind):
    keys = _keys(kind)
    j_order, j_sorted = sort_tpu.bitonic_argsort(jnp.asarray(keys), interpret=True)
    order, sorted_keys, incl = sort_gpu.digit_sort(torch.from_numpy(keys.astype(np.int32)), SENTINEL)
    assert order.dtype == torch.int32 and sorted_keys.dtype == torch.int32
    assert np.array_equal(sorted_keys.numpy(), np.asarray(j_sorted).astype(np.int32))
    _check_grouping(keys, order.numpy(), sorted_keys.numpy())
    _check_grouping(keys, np.asarray(j_order), np.asarray(j_sorted))
    assert incl.shape == (keys.shape[0], SENTINEL + 1)
    for wi in range(keys.shape[0]):
        want = np.searchsorted(np.sort(keys[wi]), np.arange(SENTINEL + 1), side="right")
        assert np.array_equal(incl[wi].numpy(), want)


def test_rejects_out_of_range_keys():
    keys = torch.zeros((2, 8), dtype=torch.int32)
    keys[1, 3] = SENTINEL + 1
    with pytest.raises(ValueError):
        sort_gpu.digit_sort(keys, SENTINEL)
    with pytest.raises(ValueError):
        sort_gpu.digit_sort(keys.long(), SENTINEL)

