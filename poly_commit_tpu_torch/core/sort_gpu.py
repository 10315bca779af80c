"""Digit grouping for the MSM windows: kernel K3.

Counterpart of poly_commit_tpu/core/sort_tpu.py. ``digit_sort`` takes (W, N)
int32 window digits in [0, sentinel] (the sentinel, 2^c, marks padding and
points at infinity and must sort last) and returns, per window, the order
(int32 indices), the sorted keys and the inclusive per-key counts, which are
the bucket tails: incl[w, b] - 1 is the last sorted position of a key <= b.
The sort is stable: equal keys keep their input order, so the order is
``torch.sort(keys, dim=1, stable=True)``'s on every device (the TPU's
bitonic sort is not stable; the MSM needs only the grouping).

K3 replaces ``_pallas_pass`` (poly_commit_tpu/core/sort_tpu.py:141), the
blocked bitonic network that keeps 2^17-element blocks in VMEM. On Hopper
it is a stable LSD radix sort per window (csrc/digit_sort.cu): one upsweep
builds every pass's digit histograms in shared memory, then each pass ranks
4096-key tiles in shared memory by warp-level matching, takes the tiles'
global offsets by a chained scan with decoupled look-back, and writes keys
and indices out in runs ordered by digit. A pass takes at most 9 bits
(``radix_plan``): the 17-bit keys of c = 16 take two passes, c <= 8 one.
The tails come from the sorted keys (run ends, then a max-scan). What
bounds it on the card: bytes (a read of the keys and a write of order and
keys at the least), with no arithmetic to speak of.

The upsweep also counts keys outside [0, sentinel] on the card; the
wrapper reads that count once after the launches and raises. The plain
version (a stable torch.sort plus a bincount) runs only for CPU tensors;
the wrapper counts its launches in ``digit_sort.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import device as D
from ..utils import trace

MAX_PASS_BITS = 9  # a pass's histogram (2^9 bins) stays in shared memory


def radix_plan(sentinel: int) -> tuple:
    """Digit bits of each LSD pass, from the bottom: the key bits of
    [0, sentinel] split into the fewest passes of at most 9 bits, the
    first pass taking the larger share (17 bits: (9, 8))."""
    bits = max(1, int(sentinel).bit_length())
    passes = -(-bits // MAX_PASS_BITS)
    first = -(-bits // passes)
    return (first,) + (bits - first,) * (passes - 1)


def _plain(keys: torch.Tensor, sentinel: int):
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    w = keys.shape[0]
    bins = sentinel + 1
    offs = (keys.long() + bins * torch.arange(w, device=keys.device).unsqueeze(1)).reshape(-1)
    counts = torch.bincount(offs, minlength=w * bins).reshape(w, bins)
    incl = counts.cumsum(1)
    return order.to(torch.int32), sorted_keys, incl.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = D.library("digit_sort")
    lib.pc_digit_sort_scratch.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.pc_digit_sort_scratch.restype = ctypes.c_longlong
    lib.pc_digit_sort.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    lib.pc_digit_sort.restype = ctypes.c_int
    return lib


def _check_layout(keys: torch.Tensor):
    if keys.dtype != torch.int32 or keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous (W, N) int32 tensor")


def _check_range(keys: torch.Tensor, sentinel: int):
    if keys.numel() and (int(keys.min()) < 0 or int(keys.max()) > sentinel):
        raise ValueError(f"keys must lie in [0, {sentinel}]")


def digit_sort(keys: torch.Tensor, sentinel: int):
    """(W, N) int32 keys -> (order, sorted keys, inclusive counts (W, sentinel+1))."""
    _check_layout(keys)
    if keys.device.type == "cpu":
        _check_range(keys, sentinel)
        return _plain(keys, sentinel)
    order, sorted_keys, incl, bad = _launch(keys, sentinel)
    with trace.scope("Serialize::to_host", log=False):
        trace.count("host_syncs")
        bad = int(bad.item())
    if bad:
        raise ValueError(f"keys must lie in [0, {sentinel}]")
    return order, sorted_keys, incl


def _launch(keys: torch.Tensor, sentinel: int):
    """K3's launches on CUDA keys, without the host's look at the range:
    (order, sorted keys, incl, bad), bad a one-word device count of the
    keys outside [0, sentinel]."""
    _check_layout(keys)
    D.require_cuda(keys)
    w, n = keys.shape
    bins = sentinel + 1
    order = torch.empty_like(keys)
    sorted_keys = torch.empty_like(keys)
    incl = torch.empty((w, bins), dtype=torch.int32, device=keys.device)
    if keys.numel() == 0:
        return order, sorted_keys, incl.zero_(), torch.zeros(1, dtype=torch.int32,
                                                              device=keys.device)
    plan = radix_plan(sentinel)
    bits = (ctypes.c_int * len(plan))(*plan)
    lib = _lib()
    words = lib.pc_digit_sort_scratch(w, n, bins, len(plan), bits)
    if words < 0:
        raise ValueError(f"digit sort takes no ({w}, {n}) keys below {bins}")
    scratch = torch.empty(words, dtype=torch.int32, device=keys.device)
    rc = lib.pc_digit_sort(keys.data_ptr(), order.data_ptr(), sorted_keys.data_ptr(),
                           incl.data_ptr(), scratch.data_ptr(), w, n, bins, len(plan), bits,
                           D.stream_of(keys))
    if rc != 0:
        raise RuntimeError(f"digit sort kernel launch failed: CUDA error {rc}")
    digit_sort.launches += 1
    return order, sorted_keys, incl, scratch[:1]  # scratch word 0: the keys out of range


digit_sort.launches = 0


def plain(keys: torch.Tensor, sentinel: int):
    """The plain PyTorch version on any device."""
    _check_layout(keys)
    _check_range(keys, sentinel)
    return _plain(keys, sentinel)
