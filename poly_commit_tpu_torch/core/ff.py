"""Limbs-first field arithmetic on (L, N) int32 tensors: kernel K1.

Counterpart of poly_commit_tpu/core/ff.py. A field element is a column of
L little-endian 16-bit limbs (L = 24 for the 381/377-bit Fq, 16 for BN254
and the scalar fields), so each limb row holds N contiguous elements and a
warp's loads coalesce. Values stay in Montgomery form with R = 2^(16 L) and
lazily in [0, 2p): ``mont_mul``, ``add`` and ``sub`` return values < 2p and
``canonicalize`` brings them below p. int32 holds the limbs because
torch.uint32 has no add, shift or compare on the CPU; the kernel reads the
bits as uint32.

K1 replaces ``_pallas_fn`` (poly_commit_tpu/core/ff.py:293), the Pallas
kernel that fuses ``_mont_mul_rows`` / ``_add_rows`` / ``_sub_rows`` over
1024-lane tiles. Here (csrc/ff.cu) one thread owns one element: it packs
the limb pairs into L/2 32-bit words in registers and runs a CIOS
Montgomery product (4(L/2)^2 + L/2 32-bit multiply-adds), then writes
16-bit limbs back. What bounds it on the card: a multiply moves 12 L bytes
per element and does 4(L/2)^2 + L/2 IMADs, which at L = 24 is ~2 IMAD per
byte -- under the IMAD/bandwidth ratio, so it is bound by bytes; add and
sub are bound by bytes. The design keeps every temporary in registers, so
each element is read and written exactly once. Most launches on the paths
have few columns, where the launch latency and the wrapper's host work
bound them instead.

Three more entries replace loops of K1 launches:

* ``mont_pow`` (a^e for a Python-int exponent) is the Fermat chain of every
  batched inversion. The JAX package runs it as one ``lax.scan`` of
  ``mont_mul`` (poly_commit_tpu/core/msm_tpu.py::_ff_inv); here it is one
  launch of ``pc_ff_pow`` in place of one launch a product (610 for an
  Fq-381 inverse): one thread per column runs the whole square-and-multiply
  chain in registers, bound by the latency of that chain.
* ``batch_inv`` inverts M columns with one Fermat chain: ``pc_ff_batch_inv``
  builds each 2^10-column block's product tree in shared memory and writes
  its root (one launch a level, two levels up to 2^20 columns), the last
  root takes one ``mont_pow``, and the same kernel walks each level's trees
  down again: 5 launches at M = 2^20 where the tree of K1 launches took
  3 log2 M + 1 and ~100 PyTorch operations.
* ``fsum`` adds the N columns of an operand (IPA-PC's inner products) with
  ``pc_ff_sum``: one launch up to 2^10 columns, else a grid of block sums
  and one launch over its partials, where the halving loop took log2 N.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import device as D
from ..utils import trace
from .field_params import LIMB_BITS, LIMB_MASK, FieldSpec

MASK = LIMB_MASK


@functools.lru_cache(maxsize=16)
def _consts_np(spec: FieldSpec):
    """(p, 2p, -p^-1 mod R, R mod p) as int64 numpy limb vectors (L,)."""
    L = spec.n_limbs
    assert 2 * spec.modulus < spec.R, "range invariant needs R > 2p"
    npi = (-pow(spec.modulus, -1, spec.R)) % spec.R

    def limbs(v):
        return np.array([(v >> (LIMB_BITS * i)) & MASK for i in range(L)], np.int64)

    return limbs(spec.modulus), limbs(2 * spec.modulus), limbs(npi), limbs(spec.R_mod_p)


@functools.lru_cache(maxsize=64)
def _consts_on(spec: FieldSpec, device: str, which: int) -> torch.Tensor:
    trace.count("host_syncs")
    return torch.from_numpy(_consts_np(spec)[which]).to(device).view(-1, 1)


def consts(spec: FieldSpec, device, which: int) -> torch.Tensor:
    """One of p, 2p, -p^-1, R mod p as an (L, 1) int64 column on ``device``."""
    return _consts_on(spec, str(device), which)


def needs_post_reduce(spec: FieldSpec) -> bool:
    """R >= 4p keeps a Montgomery product of values < 2p below 2p; tighter
    fields (255-bit scalar fields at 16 limbs) subtract 2p once more."""
    return 4 * spec.modulus > spec.R


# ---------------------------------------------------------------------------
# plain versions: int64 (K, N) limb columns, vectorised over the limb axis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _col_index(la: int, lb: int, device: str) -> torch.Tensor:
    """Column i + j of each product a_i b_j, flattened (i major)."""
    trace.count("host_syncs")
    return (torch.arange(la).unsqueeze(1) + torch.arange(lb).unsqueeze(0)).reshape(-1).to(device)


def _mul_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Uncarried column sums of a*b: a (La, N), b (Lb, N or 1) -> (La+Lb, N).

    One outer product of the limbs (each product < 2^32) whose rows are
    added into column i + j by one index_add_ (sums < La 2^32 < 2^37).
    """
    la, lb = a.shape[0], b.shape[0]
    x = (a.unsqueeze(1) * b.unsqueeze(0)).reshape(la * lb, -1)
    cols = x.new_zeros((la + lb, x.shape[1]))
    return cols.index_add_(0, _col_index(la, lb, str(a.device)), x)


def _digits(cols: torch.Tensor, chunks: int) -> torch.Tensor:
    """Base-2^16 digits of nonnegative int64 columns (K, N), each column
    < 2^(16 chunks); the value is cut mod 2^(16 K).

    Every column's chunks are first spread to the columns above it (after
    which each column is < chunks 2^16), then parallel carry rounds run
    until no column overflows: usually one round and one check.
    """
    out = cols & MASK
    for j in range(1, chunks):
        out[j:] += (cols[:-j] >> (LIMB_BITS * j)) & MASK
    while True:
        c = out >> LIMB_BITS
        trace.count("host_syncs")
        if not bool(c.any()):
            return out
        out = out & MASK
        out[1:] += c[:-1]


def _carry(cols: torch.Tensor):
    """Propagate carries and borrows through small signed int64 columns
    (K, N) (sums and differences of limbs).

    Returns (limbs, top): K 16-bit limbs and the signed carry out of the
    top limb, so that value = limbs + top * 2^(16K).
    """
    top = torch.zeros_like(cols[0])
    while True:
        c = cols >> LIMB_BITS
        trace.count("host_syncs")
        if not bool(c.any()):
            return cols, top
        cols = cols & MASK
        cols[1:] += c[:-1]
        top = top + c[-1]


def _sub_if_ge(v: torch.Tensor, top: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """v + top R (< 2m) minus m when it is >= m (m an (L, 1) column)."""
    d, dt = _carry(v - m)
    return torch.where((dt + top) < 0, v, d)


def _mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b R^-1 mod p (separated Montgomery): inputs < 2p -> output < 2p.

    t = a b stays as uncarried columns (< 2^37): m = (t mod R)(-p^-1) mod R
    takes them as they are (column sums < 2^58), and u = t + m p (< 5 R^2,
    2L + 1 columns) is carried once; u / R is the result."""
    L = spec.n_limbs
    dev = a.device
    t = _mul_cols(a, b)  # 2L columns
    m = _digits(_mul_cols(t[:L], consts(spec, dev, 2))[:L], 4)
    u = t + _mul_cols(m, consts(spec, dev, 0))
    # The low L columns hold exactly c R; carrying them would ripple through
    # all L limbs. c comes from the top two: c 2^32 - (u_{L-1} 2^16 + u_{L-2})
    # is the rest of the low part over 2^(16(L-2)), in [0, 2^23).
    c = (u[L - 1] * (1 << LIMB_BITS) + u[L - 2] + ((1 << 32) - 1)) >> 32
    hi = torch.cat([u[L:], u.new_zeros((1, u.shape[1]))], 0)
    hi[0] += c
    s = _digits(hi, 3)
    if needs_post_reduce(spec):
        return _sub_if_ge(s[:L], s[L], consts(spec, dev, 1))
    return s[:L]


def _add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    v, top = _carry(a + b)
    return _sub_if_ge(v, top, consts(spec, a.device, 1))


def _sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + 2p (>= 0, < 4p) reduced once below 2p."""
    v, top = _carry(a - b + consts(spec, a.device, 1))
    return _sub_if_ge(v, top, consts(spec, a.device, 1))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_OPS = {"mul": 0, "add": 1, "sub": 2}
_PLAIN = {"mul": _mont_mul_plain, "add": _add_plain, "sub": _sub_plain}
KCONST_WORDS = 38  # p[12], 2p[12], R mod p [12], -p^-1 mod 2^32, post-reduce


@functools.lru_cache(maxsize=16)
def kernel_consts(spec: FieldSpec):
    """The constant block every kernel takes: 32-bit words of p, 2p and
    R mod p (zero-padded to 12), -p^-1 mod 2^32 and the post-reduce flag."""
    def words(v):
        return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(12)]

    vals = (words(spec.modulus) + words(2 * spec.modulus) + words(spec.R_mod_p)
            + [(-pow(spec.modulus, -1, 1 << 32)) % (1 << 32),
               int(needs_post_reduce(spec))])
    return (ctypes.c_uint32 * KCONST_WORDS)(*vals)


def n_words(spec: FieldSpec) -> int:
    """32-bit words per element in the kernels (8 or 12)."""
    if spec.n_limbs not in (16, 24):
        raise ValueError(f"{spec.name}: kernels take 16 or 24 limbs")
    return spec.n_limbs // 2


def check_limbs(spec: FieldSpec, *tensors, rows: int = 0) -> None:
    """Every operand an (L, N) int32 contiguous tensor on one device (rows
    limb rows instead of L when given: 2L for Fq2 coordinates)."""
    rows = rows or spec.n_limbs
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != rows:
            raise ValueError(f"expected ({rows}, N) int32, got {tuple(t.shape)} {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError("operands differ in shape or device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = D.library("ff")
    lib.pc_ff_op.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
    lib.pc_ff_op.restype = ctypes.c_int
    lib.pc_ff_pow.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.POINTER(ctypes.c_uint32), ctypes.c_int,
                              ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
    lib.pc_ff_pow.restype = ctypes.c_int
    lib.pc_ff_batch_inv.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                    ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
    lib.pc_ff_batch_inv.restype = ctypes.c_int
    lib.pc_ff_sum.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_int, ctypes.POINTER(ctypes.c_uint32), ctypes.c_void_p]
    lib.pc_ff_sum.restype = ctypes.c_int
    return lib


def _count(wrapper) -> None:
    """One launch of ``wrapper``'s kernel."""
    wrapper.launches += 1


def _run(wrapper, op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor):
    check_limbs(spec, a, b)
    if a.device.type == "cpu":
        return _PLAIN[op](spec, a.long(), b.long()).to(torch.int32)
    D.require_cuda(a)
    out = torch.empty_like(a)
    if a.shape[1] == 0:
        return out
    rc = _lib().pc_ff_op(_OPS[op], n_words(spec), a.data_ptr(), b.data_ptr(),
                         out.data_ptr(), a.shape[1], kernel_consts(spec),
                         D.stream_of(a))
    if rc != 0:
        raise RuntimeError(f"ff {op} kernel launch failed: CUDA error {rc}")
    _count(wrapper)
    return out


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * R^-1 mod p, inputs and output < 2p."""
    return _run(mont_mul, "mul", spec, a, b)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p, inputs and output < 2p."""
    return _run(add, "add", spec, a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p, inputs and output < 2p."""
    return _run(sub, "sub", spec, a, b)


EXP_WORDS = 12  # the power kernel takes exponents below 2^384


def _pow_plain(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e on int64 limbs: square and multiply, MSB first, from R mod p."""
    acc = consts(spec, a.device, 3).expand(-1, a.shape[1]).clone()
    for bit in reversed(range(e.bit_length())):
        acc = _mont_mul_plain(spec, acc, acc)
        if e >> bit & 1:
            acc = _mont_mul_plain(spec, acc, a)
    return acc


def _exponent(e) -> int:
    e = int(e)
    if not 0 <= e < 1 << (32 * EXP_WORDS):
        raise ValueError(f"exponent must lie in [0, 2^{32 * EXP_WORDS})")
    return e


def mont_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e (Montgomery in and out, values < 2p) for a Python-int exponent:
    the whole square-and-multiply chain in one launch on a CUDA tensor."""
    check_limbs(spec, a)
    e = _exponent(e)
    if a.device.type == "cpu":
        return _pow_plain(spec, a.long(), e).to(torch.int32)
    D.require_cuda(a)
    out = torch.empty_like(a)
    if a.shape[1] == 0:
        return out
    words = (ctypes.c_uint32 * EXP_WORDS)(*[(e >> (32 * i)) & 0xFFFFFFFF for i in range(EXP_WORDS)])
    rc = _lib().pc_ff_pow(n_words(spec), a.data_ptr(), out.data_ptr(), a.shape[1], words,
                          e.bit_length(), kernel_consts(spec), D.stream_of(a))
    if rc != 0:
        raise RuntimeError(f"ff pow kernel launch failed: CUDA error {rc}")
    _count(mont_pow)
    return out


TREE_LOG_LEAVES = 10  # columns a block of the inversion tree (csrc/ff.cu's kTreeLogLeaves)


def batch_inv_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Inverses of the M columns of a (zeros map to zero) on any device: a
    product tree up, its root inverted by one Fermat power (a^(p-2), the
    JAX package's ``_ff_inv`` chain), then inv(child) = inv(parent) *
    sibling down the tree, each level one plain product."""
    check_limbs(spec, a)
    L, m = a.shape
    dev = a.device
    zero = is_zero(spec, a)
    n2 = 1 << max(0, (m - 1).bit_length())
    cur = select(zero, one_mont(spec, m, dev), a)
    if n2 != m:
        cur = torch.cat([cur, one_mont(spec, n2 - m, dev)], 1)
    levels = [cur]
    while cur.shape[1] > 1:
        cur = plain("mul", spec, cur[:, 0::2].contiguous(), cur[:, 1::2].contiguous())
        levels.append(cur)
    inv = plain_pow(spec, cur, spec.modulus - 2)
    for lvl in reversed(levels[:-1]):
        left = lvl[:, 0::2].contiguous()
        right = lvl[:, 1::2].contiguous()
        inv_l = plain("mul", spec, inv, right)
        inv_r = plain("mul", spec, inv, left)
        inv = torch.stack([inv_l, inv_r], dim=2).reshape(L, -1)
    return select(zero, zeros(spec, m, dev), inv[:, :m].contiguous())


def _tree_level(spec: FieldSpec, down: bool, src, inv_roots, dst) -> None:
    """One ``pc_ff_batch_inv`` launch over the columns of src."""
    n = src.shape[1]
    log_b = min(TREE_LOG_LEAVES, (n - 1).bit_length())
    rc = _lib().pc_ff_batch_inv(n_words(spec), int(down), src.data_ptr(), n,
                                inv_roots.data_ptr() if down else None, dst.data_ptr(), log_b,
                                kernel_consts(spec), D.stream_of(src))
    if rc != 0:
        raise RuntimeError(f"ff batch_inv kernel launch failed: CUDA error {rc}")
    _count(batch_inv)


def batch_inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Inverses of the M columns of a (values < 2p, zeros map to zero),
    values < 2p: on a CUDA tensor one ``pc_ff_batch_inv`` launch a level up
    (each 2^10-column block's root), one ``mont_pow`` on the last root, one
    launch a level down."""
    check_limbs(spec, a)
    if a.device.type == "cpu":
        return batch_inv_plain(spec, a)
    D.require_cuda(a)
    if a.shape[1] == 0:
        return torch.empty_like(a)
    levels = [a]
    while levels[-1].shape[1] > 1:
        src = levels[-1]
        n = src.shape[1]
        roots = src.new_empty((src.shape[0], ((n - 1) >> TREE_LOG_LEAVES) + 1))
        _tree_level(spec, False, src, None, roots)
        levels.append(roots)
    inv = mont_pow(spec, levels[-1], spec.modulus - 2)
    for src in reversed(levels[:-1]):
        out = torch.empty_like(src)
        _tree_level(spec, True, src, inv, out)
        inv = out
    return inv


SUM_THREADS = 256  # threads a block of pc_ff_sum (csrc/ff.cu's kThreads)
SUM_BLOCK_COLUMNS = 4 * SUM_THREADS  # columns a block of the first pass adds


def fsum_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """The (L, 1) field sum of the N columns of a on any device: zero
    columns up to a power of two, then the halving loop of plain adds."""
    check_limbs(spec, a)
    n = a.shape[1]
    n2 = 1 << max(0, (n - 1).bit_length())
    if n2 != n:
        a = torch.cat([a, zeros(spec, n2 - n, a.device)], 1)
    while a.shape[1] > 1:
        half = a.shape[1] // 2
        a = plain("add", spec, a[:, :half].contiguous(), a[:, half:].contiguous())
    return a


def _sum_pass(spec: FieldSpec, src, dst) -> None:
    """One ``pc_ff_sum`` launch: dst's columns are the block sums of src."""
    rc = _lib().pc_ff_sum(n_words(spec), src.data_ptr(), src.shape[1], dst.data_ptr(),
                          dst.shape[1], kernel_consts(spec), D.stream_of(src))
    if rc != 0:
        raise RuntimeError(f"ff sum kernel launch failed: CUDA error {rc}")
    _count(fsum)


def fsum(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """The field sum of the N columns of a (values < 2p) as an (L, 1)
    value < 2p: one ``pc_ff_sum`` launch up to SUM_BLOCK_COLUMNS columns,
    else a grid of at most SUM_THREADS block sums and one launch over them."""
    check_limbs(spec, a)
    if a.device.type == "cpu":
        return fsum_plain(spec, a)
    D.require_cuda(a)
    blocks = min(SUM_THREADS, -(-a.shape[1] // SUM_BLOCK_COLUMNS))
    if blocks > 1:
        part = a.new_empty((a.shape[0], blocks))
        _sum_pass(spec, a, part)
        a = part
    out = a.new_empty((a.shape[0], 1))
    _sum_pass(spec, a, out)
    return out


WRAPPERS = (mont_mul, add, sub, mont_pow, batch_inv, fsum)
for _w in WRAPPERS:
    _w.launches = 0
del _w


def plain(op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of kernel op ``op`` on any device."""
    check_limbs(spec, a, b)
    return _PLAIN[op](spec, a.long(), b.long()).to(torch.int32)


def plain_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """The plain PyTorch version of ``mont_pow`` on any device."""
    check_limbs(spec, a)
    return _pow_plain(spec, a.long(), _exponent(e)).to(torch.int32)


# ---------------------------------------------------------------------------
# plain tensor helpers (no kernel in the JAX package either)
# ---------------------------------------------------------------------------


def canonicalize(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """values < 2p -> canonical < p."""
    v = a.long()
    return _sub_if_ge(v, torch.zeros_like(v[0]), consts(spec, a.device, 0)).to(torch.int32)


def is_zero(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """value == 0 mod p for values < 2p: all-zero limbs or exactly p."""
    p = consts(spec, a.device, 0).to(torch.int32)
    return (a == 0).all(0) | (a == p).all(0)


def select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mask (N,) bool -> where(mask, a, b) over (L, N)."""
    return torch.where(mask.unsqueeze(0), a, b)


def zeros(spec: FieldSpec, n: int, device) -> torch.Tensor:
    return torch.zeros((spec.n_limbs, n), dtype=torch.int32, device=device)


def one_mont(spec: FieldSpec, n: int, device) -> torch.Tensor:
    r = consts(spec, device, 3).to(torch.int32)
    return r.expand(spec.n_limbs, n).contiguous()


# ---------------------------------------------------------------------------
# conversions (through bytes: no per-limb Python loops)
# ---------------------------------------------------------------------------


def ints_to_limbs(spec: FieldSpec, ints, mont: bool = True) -> np.ndarray:
    """Python ints -> (N, L) uint16 numpy limbs (Montgomery form by default)."""
    p, nb = spec.modulus, 2 * spec.n_limbs
    r = spec.R_mod_p if mont else 1
    data = b"".join((int(v) * r % p).to_bytes(nb, "little") for v in ints)
    return np.frombuffer(data, "<u2").reshape(-1, spec.n_limbs)


def limbs_to_ints(spec: FieldSpec, arr: np.ndarray, mont: bool = True) -> list:
    """(N, L) limbs (any value < R) -> canonical Python ints."""
    p, nb = spec.modulus, 2 * spec.n_limbs
    data = np.ascontiguousarray(arr, dtype="<u2").tobytes()
    rinv = pow(spec.R, -1, p) if mont else 1
    return [int.from_bytes(data[i : i + nb], "little") * rinv % p
            for i in range(0, len(data), nb)]


def from_ints(spec: FieldSpec, ints, mont: bool = True, device=None) -> torch.Tensor:
    """Python ints -> (L, N) canonical Montgomery limbs on ``device``."""
    arr = ints_to_limbs(spec, list(ints), mont).astype(np.int32)
    trace.count("host_syncs")
    return torch.from_numpy(np.ascontiguousarray(arr.T)).to(D.resolve(device))


@trace.traced("Serialize::to_host", log=False)
def to_ints(spec: FieldSpec, a: torch.Tensor, mont: bool = True) -> list:
    """(L, N) limbs (< 2p) -> canonical Python ints."""
    trace.count("host_syncs")
    return limbs_to_ints(spec, a.T.cpu().numpy(), mont)


def from_field_last(arr: torch.Tensor) -> torch.Tensor:
    """core/field.py layout (..., L) -> (L, N) contiguous."""
    L = arr.shape[-1]
    return arr.reshape(-1, L).T.contiguous()


def to_field_last(arr: torch.Tensor, batch_shape) -> torch.Tensor:
    """(L, N) -> (batch..., L)."""
    return arr.T.reshape(tuple(batch_shape) + (arr.shape[0],)).contiguous()
