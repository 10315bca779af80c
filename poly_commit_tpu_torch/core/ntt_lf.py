"""Limbs-first radix-2 NTT: kernels K4a, K4b and K4c.

Counterpart of poly_commit_tpu/core/ntt_lf.py. ``ntt``/``intt`` take
(L, rows n) int32 Montgomery limbs holding ``rows`` contiguous transforms of
length n (Ligero's batch of row encodes) and return them in order, each
value below 2p. The dispatch is the JAX package's (``_ntt_lf_body``):

  - bit-reverse each length-n block (plain torch, as in the JAX package);
  - from 1024 elements in all: K4b (``fused_stages``) runs the first
    log2(B) stages of every B-element block at once (all log2 n stages when
    n <= B), then K4c (``stages``) runs the remaining stages over the whole
    array, up to MAX_STAGES of them a launch;
  - below that, K4a (``small``) runs all log2 n stages of every row in one
    launch, in one block's shared memory (``butterfly``, the JAX package's
    one stage on split halves, stays beside it as K4a's one-stage form);
  - ``intt`` scales by n^-1 with K1.

B is 2^11 here (2^13 on the TPU, whose block does not fit in a Hopper
block's shared memory); csrc/ntt.cu gives the reasons and each kernel's
bound. Every wrapper takes its plain PyTorch version (one Montgomery
product, add and subtract per butterfly, core/ff.py's int64 arithmetic) for
tensors on the CPU only; on a CUDA tensor it launches its kernel or raises.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import device as D
from . import ff
from . import ntt as NTT
from .field_params import FieldSpec

FUSE_BLOCK = 1 << 11  # elements per K4b thread block
FUSED_MIN_TOTAL = 1024  # smaller transforms take K4a, one launch for all stages
SMALL_MAX_TOTAL = 1024  # elements of a K4a launch (csrc/ntt.cu's SMALL_MAX_TOTAL)
SMALL_MAX_STAGES = 9  # stages of a K4a launch (csrc/ntt.cu's SMALL_MAX_STAGES)
MAX_STAGES = 6  # K4c stages a launch (csrc/ntt.cu's MAX_STAGES)
_PLAIN_CHUNK = 1 << 20  # butterflies per plain-version step (bounds its int64 temporaries)


def _check(spec: FieldSpec, *tensors) -> None:
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != spec.n_limbs:
            raise ValueError(f"expected ({spec.n_limbs}, N) int32, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
        if t.device != tensors[0].device:
            raise ValueError("operands lie on different devices")
    if ff.n_words(spec) != 8:
        raise ValueError(f"{spec.name}: the NTT kernels take 8-word fields")


def _lib():
    lib = D.library("ntt")
    ptr, i64, consts = ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_uint32)
    lib.pc_ntt_butterfly.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, consts, ptr]
    lib.pc_ntt_small.argtypes = [ptr, ptr, ptr, ctypes.c_int, ctypes.c_int, consts, ptr]
    lib.pc_ntt_stages.argtypes = [ptr, ptr, ptr, i64, ctypes.c_int, ctypes.c_int, consts, ptr]
    lib.pc_ntt_fused.argtypes = [ptr, ptr, ptr, i64, ctypes.c_int, ctypes.c_int, i64, consts, ptr]
    for fn in (lib.pc_ntt_butterfly, lib.pc_ntt_small, lib.pc_ntt_stages, lib.pc_ntt_fused):
        fn.restype = ctypes.c_int
    return lib


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def butterfly_plain(spec: FieldSpec, u, w, tw):
    """(u + w tw, u - w tw) over (L, P) limbs, on any device."""
    lo, hi = torch.empty_like(u), torch.empty_like(u)
    for c in range(0, u.shape[1], _PLAIN_CHUNK):
        cols = slice(c, c + _PLAIN_CHUNK)
        uc = u[:, cols].contiguous()
        v = ff.plain("mul", spec, w[:, cols].contiguous(), tw[:, cols].contiguous())
        lo[:, cols] = ff.plain("add", spec, uc, v)
        hi[:, cols] = ff.plain("sub", spec, uc, v)
    return lo, hi


def _by_stage(bfly, spec: FieldSpec, a, tw, s: int):
    """Stage s (half = 2^s) of (L, total) through ``bfly`` on its split
    halves: u and w are the first and second half of each 2^(s+1)-run, and
    the (L, half) stage twiddles repeat once per run."""
    L, total = a.shape
    half = 1 << s
    m = total // (2 * half)
    x = a.view(L, m, 2, half)
    lo, hi = bfly(spec, x[:, :, 0].reshape(L, -1).contiguous(),
                  x[:, :, 1].reshape(L, -1).contiguous(), tw.repeat(1, m))
    return torch.stack([lo.view(L, m, half), hi.view(L, m, half)], 2).reshape(L, total)


def stage_plain(spec: FieldSpec, a, tw, s: int):
    """Stage s (half = 2^s) over (L, total) with the (L, half) stage twiddles."""
    return _by_stage(butterfly_plain, spec, a, tw, s)


def stages_plain(spec: FieldSpec, a, tws, s0: int):
    """Stages s0 .. s0 + len(tws) - 1, tws[t] stage s0 + t's (L, 2^(s0+t))
    twiddles: the chain of ``stage_plain`` calls."""
    _stages_args(spec, a, tws, s0)
    for t, tw in enumerate(tws):
        a = stage_plain(spec, a, tw, s0 + t)
    return a


def small_plain(spec: FieldSpec, a, tws):
    """Stages 0 .. len(tws) - 1 of (L, total), tws[s] stage s's (L, 2^s)
    twiddles: the chain of ``stage_plain`` calls."""
    _small_args(spec, a, tws)
    for s, tw in enumerate(tws):
        a = stage_plain(spec, a, tw, s)
    return a


def fused_stages_plain(spec: FieldSpec, a, table, n_stages: int, block: int):
    """Stages 0 .. n_stages-1 of every ``block``-element block. Those stages
    never pair across a block, so they run over the whole array at once."""
    _fused_args(a, table, n_stages, block)
    for s in range(n_stages):
        a = stage_plain(spec, a, table[:, (1 << s) - 1 : (2 << s) - 1].contiguous(), s)
    return a


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def butterfly(spec: FieldSpec, u, w, tw):
    """K4a: (u, w, tw), each (L, n/2) -> (u + w tw, u - w tw)."""
    ff.check_limbs(spec, u, w, tw)
    _check(spec, u)
    if u.device.type == "cpu":
        return butterfly_plain(spec, u, w, tw)
    D.require_cuda(u)
    lo, hi = torch.empty_like(u), torch.empty_like(u)
    n = u.shape[1]
    if n:
        _raise_on(_lib().pc_ntt_butterfly(u.data_ptr(), w.data_ptr(), tw.data_ptr(), lo.data_ptr(),
                                          hi.data_ptr(), n, ff.kernel_consts(spec), D.stream_of(u)),
                  "ntt butterfly")
        butterfly.launches += 1
    return lo, hi


def _small_args(spec: FieldSpec, a, tws) -> None:
    _check(spec, a, *tws)
    log_n, total = len(tws), a.shape[1]
    if not 1 <= log_n <= SMALL_MAX_STAGES or total > SMALL_MAX_TOTAL or total % (1 << log_n):
        raise ValueError(f"small transform: {log_n} stages of {total} elements, "
                         f"at most {SMALL_MAX_STAGES} stages of {SMALL_MAX_TOTAL}")
    for s, tw in enumerate(tws):
        if tw.shape[1] != 1 << s:
            raise ValueError(f"stage {s}: twiddles {tw.shape[1]}")


def small(spec: FieldSpec, a, tws):
    """K4a: stages 0 .. log_n - 1 (log_n = len(tws)) of every 2^log_n-element
    row of (L, total), total <= SMALL_MAX_TOTAL, in one launch; tws[s] is
    stage s's (L, 2^s) distinct twiddles."""
    tws = tuple(tws)
    _small_args(spec, a, tws)
    if a.device.type == "cpu":
        return small_plain(spec, a, tws)
    D.require_cuda(a)
    out = torch.empty_like(a)
    ptrs = (ctypes.c_void_p * len(tws))(*[t.data_ptr() for t in tws])
    _raise_on(_lib().pc_ntt_small(a.data_ptr(), ptrs, out.data_ptr(), a.shape[1], len(tws),
                                  ff.kernel_consts(spec), D.stream_of(a)), "ntt small")
    small.launches += 1
    return out


def _stages_args(spec: FieldSpec, a, tws, s0: int) -> None:
    _check(spec, a, *tws)
    r = len(tws)
    if not 1 <= r <= MAX_STAGES or s0 < 0 or a.shape[1] % (1 << (s0 + r)):
        raise ValueError(f"stages {s0}..{s0 + r - 1}: total {a.shape[1]}, "
                         f"1 to {MAX_STAGES} stages a launch")
    for t, tw in enumerate(tws):
        if tw.shape[1] != 1 << (s0 + t):
            raise ValueError(f"stage {s0 + t}: twiddles {tw.shape[1]}")


def stages(spec: FieldSpec, a, tws, s0: int):
    """K4c: stages s0 .. s0 + r - 1 of (L, total) in one launch, r =
    len(tws) <= MAX_STAGES; stage s0 + t pairs i with i + 2^(s0+t) and takes
    tws[t], its (L, 2^(s0+t)) distinct twiddles."""
    tws = tuple(tws)
    _stages_args(spec, a, tws, s0)
    if a.device.type == "cpu":
        return stages_plain(spec, a, tws, s0)
    D.require_cuda(a)
    out = torch.empty_like(a)
    ptrs = (ctypes.c_void_p * len(tws))(*[t.data_ptr() for t in tws])
    _raise_on(_lib().pc_ntt_stages(a.data_ptr(), ptrs, out.data_ptr(), a.shape[1], s0, len(tws),
                                   ff.kernel_consts(spec), D.stream_of(a)), "ntt stages")
    stages.launches += 1
    return out


def stage(spec: FieldSpec, a, tw, s: int):
    """K4c's one-stage case: stage s of (L, total), pairing i with i + 2^s,
    with the stage's (L, 2^s) distinct twiddles."""
    return stages(spec, a, (tw,), s)


def _fused_args(a, table, n_stages: int, block: int) -> None:
    total = a.shape[1]
    if (block & (block - 1) or total % block or not 1 <= n_stages or (1 << n_stages) > block
            or table.shape[1] != (1 << n_stages) - 1):
        raise ValueError(f"fused stages: total {total}, block {block}, {n_stages} stages, "
                         f"table {table.shape[1]}")


def _pack_words(limbs):
    """(2k, N) 16-bit limbs -> (k, N) int32 words lo | hi << 16."""
    v = limbs[0::2].long() | (limbs[1::2].long() << 16)
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32).contiguous()


def fused_stages(spec: FieldSpec, a, table, n_stages: int, block: int):
    """K4b: stages 0 .. n_stages-1 of each ``block`` contiguous elements of
    (L, total); ``table`` (L, 2^n_stages - 1) holds stage s's twiddles at
    columns [2^s - 1, 2^(s+1) - 1)."""
    _check(spec, a, table)
    _fused_args(a, table, n_stages, block)
    if a.device.type == "cpu":
        return fused_stages_plain(spec, a, table, n_stages, block)
    D.require_cuda(a)
    words = _pack_words(table)
    out = torch.empty_like(a)
    _raise_on(_lib().pc_ntt_fused(a.data_ptr(), words.data_ptr(), out.data_ptr(), a.shape[1],
                                  block.bit_length() - 1, n_stages, table.shape[1],
                                  ff.kernel_consts(spec), D.stream_of(a)), "ntt fused")
    fused_stages.launches += 1
    return out


WRAPPERS = (butterfly, fused_stages, stages, small)
for _w in WRAPPERS:
    _w.launches = 0
del _w


# ---------------------------------------------------------------------------
# the transform
# ---------------------------------------------------------------------------


def fused_table(tws, n_stages: int):
    """The K4b table of stages 0 .. n_stages-1: (L, 2^n_stages - 1)."""
    return torch.cat(tws[:n_stages], 1)


def _bitrev_apply(a, rows: int, log_n: int):
    """Bit-reverse each length-2^log_n block of (L, rows 2^log_n)."""
    if log_n < 2:
        return a
    L, total = a.shape
    perm = NTT.bitrev_perm(log_n, a.device)
    return a.view(L, rows, total // rows).index_select(2, perm).reshape(L, total)


def transform(spec: FieldSpec, a, rows: int, inverse: bool):
    """``rows`` in-order transforms of (L, rows n) Montgomery limbs (< 2p)
    -> in order, < 2p."""
    _check(spec, a)
    L, total = a.shape
    if rows < 1 or total % rows:
        raise ValueError(f"{total} elements do not split into {rows} rows")
    log_n = NTT._log2(total // rows)
    tws = NTT.stage_twiddles(spec, log_n, inverse, a.device)
    a = _bitrev_apply(a, rows, log_n)
    if total >= FUSED_MIN_TOTAL:
        block = min(FUSE_BLOCK, total)
        s0 = min(log_n, block.bit_length() - 1)
        if s0:
            a = fused_stages(spec, a, fused_table(tws, s0), s0, block)
        for s in range(s0, log_n, MAX_STAGES):
            a = stages(spec, a, tws[s : min(s + MAX_STAGES, log_n)], s)
    elif log_n:
        a = small(spec, a, tws)
    if inverse:
        n_inv = ff.from_ints(spec, [NTT.domain(spec, log_n)["n_inv"]], device=a.device)
        a = ff.mont_mul(spec, a, n_inv.expand(L, total).contiguous())
    return a


def ntt(spec: FieldSpec, a, rows: int = 1):
    """Forward NTT of ``rows`` contiguous transforms in (L, rows n) limbs."""
    return transform(spec, a, rows, False)


def intt(spec: FieldSpec, a, rows: int = 1):
    """Inverse NTT of ``rows`` contiguous transforms in (L, rows n) limbs."""
    return transform(spec, a, rows, True)
