"""The PyTorch port's digit grouping (poly_commit_tpu_torch.core.sort_gpu,
K3) against the JAX package's Pallas bitonic argsort in interpret mode.

Against the JAX sort only the grouping must match: equal sorted keys, and
an order that is a permutation with keys[order] == sorted (the bitonic
sort is not stable). The port's sort is stable: its order is numpy's
stable argsort index for index. The port also returns inclusive per-key
counts, the MSM's bucket tails, checked against numpy.
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


def test_rejects_negative_keys():
    keys = torch.zeros((2, 8), dtype=torch.int32)
    keys[0, 5] = -1
    with pytest.raises(ValueError):
        sort_gpu.digit_sort(keys, SENTINEL)
    with pytest.raises(ValueError):
        sort_gpu.plain(keys, SENTINEL)


# the MSM's three shapes, cut in width: (windows, c) of c = 16, 8 and 4
MSM_SHAPES = [(16, 16), (32, 8), (64, 4)]


def _msm_keys(w, c, n, seed):
    """Keys of a c-bit window: few distinct values per window (long runs of
    equal keys), a tenth sentinels, one window all sentinel."""
    rng = np.random.default_rng(seed)
    sentinel = 1 << c
    keys = rng.integers(0, min(sentinel, 40), size=(w, n)) * max(1, sentinel // 40)
    keys = np.where(rng.random((w, n)) < 0.1, sentinel, keys)
    keys[1] = sentinel
    return keys.astype(np.int32), sentinel


@pytest.mark.parametrize("w,c", MSM_SHAPES)
def test_plain_order_is_stable(w, c):
    """The plain version's order is numpy's stable argsort, index for index
    (the kernel is held to it on the card), with the tails beside it."""
    keys, sentinel = _msm_keys(w, c, 300, seed=c)
    order, sorted_keys, incl = sort_gpu.digit_sort(torch.from_numpy(keys), sentinel)
    want = np.argsort(keys, axis=1, kind="stable")
    assert np.array_equal(order.numpy(), want)
    assert np.array_equal(sorted_keys.numpy(), np.take_along_axis(keys, want, 1))
    for wi in range(w):
        tails = np.searchsorted(np.sort(keys[wi]), np.arange(sentinel + 1), side="right")
        assert np.array_equal(incl[wi].numpy(), tails)


@pytest.mark.parametrize("w,c", MSM_SHAPES)
def test_radix_plan_passes_give_the_stable_order(w, c):
    """The kernel's LSD passes (radix_plan: at most 9 bits each, covering
    the keys' bits), each a stable sort by one digit, compose to the stable
    order of the whole keys."""
    keys, sentinel = _msm_keys(w, c, 300, seed=10 + c)
    plan = sort_gpu.radix_plan(sentinel)
    assert all(1 <= b <= sort_gpu.MAX_PASS_BITS for b in plan)
    assert sum(plan) == sentinel.bit_length()
    assert len(plan) == (2 if c == 16 else 1)
    order = np.broadcast_to(np.arange(keys.shape[1]), keys.shape)
    shift = 0
    for bits in plan:
        d = (np.take_along_axis(keys, order, 1) >> shift) & ((1 << bits) - 1)
        order = np.take_along_axis(order, np.argsort(d, axis=1, kind="stable"), 1)
        shift += bits
    assert np.array_equal(order, np.argsort(keys, axis=1, kind="stable"))

