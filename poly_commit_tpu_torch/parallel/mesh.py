"""Multi-GPU sharding layer: meshes of ranks and the sharded MSM, NTT and
batch operations, on torch.distributed.

Counterpart of poly_commit_tpu/parallel/mesh.py, with its names. The JAX
layer is single-controller: one process holds global arrays on a
``jax.sharding.Mesh`` and XLA emits the collectives of ``shard_map``. Here
each rank is a process (SPMD, one a GPU, as ``torchrun`` or
``parallel/launch.py`` start them): every rank runs the same scheme code on
replicated inputs, takes its own shard inside the functions below and
returns the replicated result, with the single-device path's field values
and group elements (bit-identical once canonical or affine).

Layouts, as in the JAX package:
  MSM      each rank runs core/msm.msm on its 1/D of the scalars and bases
           (K3, K2a); the D partial projective points are all-gathered and
           folded with group adds in rank order. O(1) points move.
  NTT      six-step: the length-n vector as an (n1, n2) row-major matrix
           with n1 = D; three all_to_all transposes, the size-n1 and size-n2
           transforms local on core/ntt_lf (K4a/b/c), the cross twiddles
           w^(i2 k1) sharded by rows of i2. Each rank holds its contiguous
           slice of the standard order, in and out; sizes that are not a
           multiple of D^2 gather, transform and slice.
  batch_*  the rows split over the ranks, each rank's rows mapped locally
           and the results all-gathered in order (``map_rows``).

A mesh is rank-major over its axes: rank r sits at
np.unravel_index(r, shape), and each axis has one process group per row of
ranks along it. The schemes use a mesh through a caller-side
``with use_mesh(mesh):``, as in the JAX package.

Backends: NCCL, one GPU a rank, is the default. Gloo runs on the CPU (the
tests) and, when asked, with several ranks sharing one card; its
collectives are then staged through host memory (``Mesh.staged``): gloo has
no CUDA all_to_all. ``make_mesh`` never switches backend on its own: NCCL
with more ranks than GPUs raises.

A guard the JAX layer does not need: in SPMD, ranks whose "replicated"
inputs differ (an unseeded rng, say) would give a wrong group element
without an error. Every sharded entry point all-gathers one 64-bit digest of
its replicated inputs, computed on the device, and raises ValueError when
they differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import device as D
from ..core import ff
from ..core import field as F
from ..core import msm as M
from ..core import ntt as NTT
from ..core import ntt_lf
from ..core import poly as P

DEFAULT_TIMEOUT_S = 120  # a lost rank makes the others raise after this, not hang


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a mesh of ranks."""

    axis_names: tuple
    shape: tuple  # ranks along each axis
    coords: tuple  # this rank's coordinate along each axis
    groups: tuple  # per axis, the process group of this rank's row along it
    rows: tuple  # per axis, the global ranks of that row, in axis order
    device: torch.device
    backend: str

    def _k(self, axis) -> int:
        return self.axis_names.index(axis or self.axis_names[0])

    def size(self, axis=None) -> int:
        return self.shape[self._k(axis)]

    def index(self, axis=None) -> int:
        return self.coords[self._k(axis)]

    def group(self, axis=None):
        return self.groups[self._k(axis)]

    @property
    def staged(self) -> bool:
        """Collectives go through host memory: gloo with CUDA tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"


# ---------------------------------------------------------------------------
# the active mesh: schemes consult it, so multi-GPU execution is a caller-side
# `with use_mesh(mesh):` rather than a parameter of every scheme API
# ---------------------------------------------------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def use_mesh(mesh: Mesh, axis: str | None = None):
    """Route the schemes' mesh branches over ``mesh`` (its first axis by
    default) for the duration of the context."""
    _ACTIVE.append((mesh, axis or mesh.axis_names[0]))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """(mesh, axis) of the innermost use_mesh context, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))


def check_backend(backend: str, world: int, device=None) -> None:
    """Raise unless ``backend`` can run ``world`` ranks on ``device``: NCCL
    needs one GPU a rank; several ranks share a card only over gloo."""
    if backend == "nccl":
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"backend 'nccl' runs on CUDA devices, not {device}: "
                             "use backend='gloo' on the CPU")
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if gpus < world:
            raise ValueError(
                f"backend 'nccl' needs one GPU a rank: {world} rank(s), {gpus} GPU(s). "
                "Use backend='gloo', on device 'cpu' or, for ranks sharing one card, "
                "'cuda:0' (its collectives are then staged through host memory)")
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r}: 'nccl' or 'gloo'")


def _init(backend: str, world: int, init_method) -> None:
    """The default process group, from the torchrun environment (RANK,
    MASTER_ADDR/MASTER_PORT) or ``init_method``; one rank alone needs
    neither (an in-process store)."""
    kw = dict(backend=backend, rank=int(os.environ.get("RANK", "0")), world_size=world,
              timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    if init_method is None and "MASTER_ADDR" in os.environ:
        init_method = "env://"
    if init_method is not None:
        kw["init_method"] = init_method
    elif world == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(f"{world} ranks need an init_method, or MASTER_ADDR and "
                         "MASTER_PORT (torchrun sets them)")
    if backend == "nccl":
        torch.cuda.set_device(_local_rank())
    dist.init_process_group(**kw)


def _device(backend: str, device) -> torch.device:
    if device is None:
        return torch.device("cuda", _local_rank()) if backend == "nccl" else torch.device("cpu")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank() if backend == "nccl" else torch.cuda.current_device())
    return dev


def _mesh(axis_names, shape, backend=None, device=None, init_method=None) -> Mesh:
    if dist.is_initialized():
        have = str(dist.get_backend())
        if backend is not None and backend != have:
            raise ValueError(f"the default process group runs {have!r}, not {backend!r}")
        backend, world = have, dist.get_world_size()
    else:
        backend = backend or "nccl"
        world = int(os.environ.get("WORLD_SIZE", "0")) or (1 if shape is None else int(np.prod(shape)))
    check_backend(backend, world, device)
    if not dist.is_initialized():
        _init(backend, world, init_method)
    rank = dist.get_rank()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if int(np.prod(shape)) != world:
        raise ValueError(f"a mesh of shape {shape} needs {int(np.prod(shape))} ranks; "
                         f"the world has {world}")
    dev = _device(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)  # the kernels launch on the current device's stream
    grid = np.arange(world).reshape(shape)
    groups, rows = [], []
    for k, size in enumerate(shape):
        for row in np.moveaxis(grid, k, -1).reshape(-1, size):
            ranks = [int(r) for r in row]
            group = dist.new_group(ranks)  # every rank makes every group, in one order
            if rank in ranks:
                groups.append(group)
                rows.append(tuple(ranks))
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    return Mesh(tuple(axis_names), shape, coords, tuple(groups), tuple(rows), dev, backend)


def make_mesh(n_devices: int | None = None, axis: str = "shard", **kw) -> Mesh:
    """1-D mesh over every rank of the world (``n_devices``, when given,
    must equal the world size).

    Keywords: ``backend`` ('nccl' unless the default group runs another;
    'gloo' only when asked), ``device`` (nccl: cuda:LOCAL_RANK; gloo: cpu,
    or a CUDA device when asked) and ``init_method`` for the default group,
    which is initialized here if it is not yet, with a timeout of
    DEFAULT_TIMEOUT_S."""
    return _mesh((axis,), None if n_devices is None else (n_devices,), **kw)


def make_mesh_2d(n_dp: int, n_tp: int, **kw) -> Mesh:
    """2-D mesh: 'dp' shards the point/coefficient batch (MSM bases), 'tp'
    shards tensor work (the NTT coefficient axis, matrix rows)."""
    return _mesh(("dp", "tp"), (n_dp, n_tp), **kw)


def make_mesh_3d(n_dp: int, n_tp: int, n_pp: int, **kw) -> Mesh:
    """3-D mesh: 'dp' shards MSM bases and scalars, 'tp' the NTT coefficient
    axis, 'pp' independent work batches (rows of transforms, per-poly
    commits)."""
    return _mesh(("dp", "tp", "pp"), (n_dp, n_tp, n_pp), **kw)


# ---------------------------------------------------------------------------
# collectives over one axis (staged through host memory on gloo + CUDA)
# ---------------------------------------------------------------------------


def _host(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    t = t.contiguous()
    return t.cpu() if mesh.staged else t


def _back(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t.to(mesh.device) if mesh.staged else t


def _all_gather(t: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """(D, *t.shape): every rank's t along the axis, in axis order."""
    src = _host(t, mesh)
    out = src.new_empty((mesh.size(axis),) + tuple(src.shape))
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group(axis))
    return _back(out, mesh)


def _all_to_all(chunks: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """chunks (D, ...): chunk j goes to the axis's rank j; returns (D, ...)
    whose j-th chunk came from rank j."""
    src = _host(chunks, mesh)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group(axis))
    return _back(out, mesh)


_DIGEST_MUL = 0x9E3779B1
_DIGEST_CHUNK = 1 << 22


def _digest(tensors, device) -> torch.Tensor:
    """One int64 on ``device``: every element times an odd weight below 2^21
    of its position, summed over the tensors in order (exact for 16-bit
    limbs up to 2^26 elements, and the same on every rank beyond)."""
    acc = torch.zeros((), dtype=torch.int64, device=device)
    pos = 0
    for t in tensors:
        flat = t.reshape(-1)
        for s in range(0, flat.numel(), _DIGEST_CHUNK):
            part = flat[s : s + _DIGEST_CHUNK].to(device=device, dtype=torch.int64)
            idx = torch.arange(pos + s, pos + s + part.numel(), dtype=torch.int64, device=device)
            acc += (part * ((idx * _DIGEST_MUL) % (1 << 20) * 2 + 1)).sum()
        pos += flat.numel()
    return acc


def _check_replicated(mesh: Mesh, axis, what: str, *tensors) -> None:
    """Raise ValueError unless every rank of the axis holds the same inputs."""
    got = _all_gather(_digest(tensors, mesh.device).reshape(1), mesh, axis).reshape(-1).tolist()
    if len(set(got)) > 1:
        raise ValueError(f"{what}: the ranks' replicated inputs differ (digests {got}); "
                         "every rank must hold the same values (seed every rng alike)")


def _slice(n: int, mesh: Mesh, axis, what: str) -> slice:
    d, i = mesh.size(axis), mesh.index(axis)
    if n % d:
        raise ValueError(f"{what}: {n} does not split over the {d} ranks of the axis")
    return slice(i * n // d, (i + 1) * n // d)


# ---------------------------------------------------------------------------
# sharded MSM
# ---------------------------------------------------------------------------


def _fold_gathered(group, gathered, n_dev: int):
    """(n_dev, ...) coordinates of projective points -> one point: the adds
    in rank order."""
    acc = tuple(c[0] for c in gathered)
    for i in range(1, n_dev):
        acc = group.add(acc, tuple(c[i] for c in gathered))
    return acc


def msm_sharded(group, scalars: torch.Tensor, points, mesh: Mesh, axis: str | None = None,
                assume_distinct: bool = False):
    """MSM with the bases and scalars sharded over a mesh axis (default:
    the first).

    scalars: (N, 16) plain limbs; points: affine (x, y, inf) batched (N, ...),
    both replicated; N divisible by the axis size (``pad_msm_inputs``).
    Each rank runs core/msm.msm on its N/D; returns the replicated
    projective point. The port's msm picks its own window, so the JAX
    package's c and lanes have no counterpart."""
    sl = _slice(int(scalars.shape[0]), mesh, axis, "msm_sharded")
    _check_replicated(mesh, axis, "msm_sharded", scalars, *points)
    part = M.msm(group, scalars[sl], tuple(a[sl] for a in points), assume_distinct=assume_distinct)
    gathered = _all_gather(torch.stack(part), mesh, axis)
    return _fold_gathered(group, tuple(gathered[:, k] for k in range(len(part))), mesh.size(axis))


def pad_msm_inputs(group, scalars: torch.Tensor, points, multiple: int):
    """Pad N up to a multiple with zero scalars and points at infinity."""
    x, y, inf = points
    padn = (-int(scalars.shape[0])) % multiple
    if padn == 0:
        return scalars, points

    def pad(a, value=0):
        return torch.cat([a, a.new_full((padn,) + tuple(a.shape[1:]), value)], 0)

    return pad(scalars), (pad(x), pad(y), pad(inf, True))


def map_rows(fn, rows: torch.Tensor, mesh: Mesh, axis: str | None = None, replicated=(),
             what: str = "map_rows"):
    """fn over the rows of a replicated batch, the rows split over a mesh
    axis: each rank maps its B/D rows, and the results (a tensor, or a tuple
    of tensors, leading axis B/D) are all-gathered in order. ``replicated``
    lists fn's other inputs for the digest guard. The counterpart of the
    JAX branches' shard_map over a row axis."""
    b = int(rows.shape[0])
    sl = _slice(b, mesh, axis, what)
    _check_replicated(mesh, axis, what, rows, *replicated)
    out = fn(rows[sl])
    if isinstance(out, tuple):
        g = _all_gather(torch.stack(out), mesh, axis)
        return tuple(g[:, k].reshape((b,) + tuple(o.shape[1:])) for k, o in enumerate(out))
    return _all_gather(out, mesh, axis).reshape((b,) + tuple(out.shape[1:]))


def batch_msm_sharded(group, rows: torch.Tensor, points, mesh: Mesh, axis: str | None = None,
                      assume_distinct: bool = False):
    """rows: (B, N, 16) plain scalars, one MSM a row over shared affine
    points; B divisible by the axis size. Each rank runs msm.msm_rows on its
    rows; returns the projective batch (B,), replicated."""
    return map_rows(lambda r: M.msm_rows(group, r, points, assume_distinct=assume_distinct),
                    rows, mesh, axis, points, "batch_msm_sharded")


# ---------------------------------------------------------------------------
# sharded NTT
# ---------------------------------------------------------------------------


def _transform_rows(spec, rows: torch.Tensor, inverse: bool) -> torch.Tensor:
    """(R, m, L) canonical Montgomery -> the R in-order transforms of length
    m, canonical: ntt_lf (K4a/b/c), the route of Ligero's _rs_encode_rows."""
    r, m, _ = rows.shape
    out = ntt_lf.transform(spec, ff.from_field_last(rows), r, inverse)
    return ff.to_field_last(ff.canonicalize(spec, out), (r, m))


@functools.lru_cache(maxsize=8)
def _cross_twiddles_on(spec, n1: int, n2: int, inverse: bool, device: str) -> torch.Tensor:
    p = spec.modulus
    w = NTT.domain(spec, (n1 * n2).bit_length() - 1)["omega_inv" if inverse else "omega"]
    cols = [P.powers(spec, F.from_ints(spec, pow(w, k1, p), device=device), n2) for k1 in range(n1)]
    return torch.stack(cols, 1)


def _cross_twiddles(spec, n1: int, n2: int, inverse: bool, device=None) -> torch.Tensor:
    """w^(+-i2 k1) for the six-step decomposition: (n2, n1, L) canonical
    Montgomery limbs on ``device``, column k1 the n2 powers of w^k1 by
    doubling (the JAX package tabulates them as Python ints)."""
    return _cross_twiddles_on(spec, n1, n2, inverse, str(D.resolve(device)))


def _transpose_sharded(x: torch.Tensor, mesh: Mesh, axis) -> torch.Tensor:
    """Local block (R/D, C, L) of a row-sharded (R, C) matrix -> local block
    (C/D, R, L) of its column-sharded transpose: one all_to_all."""
    n_dev = mesh.size(axis)
    r_d, cols, L = x.shape
    chunks = x.reshape(r_d, n_dev, cols // n_dev, L).transpose(0, 1)  # chunk j: columns of rank j
    y = _all_to_all(chunks, mesh, axis).reshape(n_dev * r_d, cols // n_dev, L)
    return y.transpose(0, 1).contiguous()


def ntt_sharded(spec, coeffs: torch.Tensor, mesh: Mesh, inverse: bool = False,
                axis: str | None = None) -> torch.Tensor:
    """Distributed radix-2 NTT by the six-step decomposition.

    coeffs: this rank's contiguous slice (n/D, L) of the length-n input in
    standard order, canonical Montgomery; returns its slice of the
    transform. The (n1, n2) view with n1 = D: size-n1 column transforms are
    local after one all_to_all transpose, the cross twiddle w^(i2 k1) is
    sharded like the rows of i2, the size-n2 row transforms are local after
    a second transpose, and a third restores the standard order. Sizes that
    are not a multiple of D^2 (and D = 1) gather, transform and slice."""
    n_dev, i = mesh.size(axis), mesh.index(axis)
    m, L = coeffs.shape
    n = m * n_dev
    _check_replicated(mesh, axis, "ntt_sharded", torch.tensor([n, int(inverse)]))
    if n_dev == 1 or n % (n_dev * n_dev):
        full = _all_gather(coeffs, mesh, axis).reshape(1, n, L)
        return _transform_rows(spec, full, inverse)[0, i * m : (i + 1) * m]
    n1, n2 = n_dev, n // n_dev
    b = _transpose_sharded(coeffs.reshape(1, n2, L), mesh, axis)  # (n2/D, n1, L): [i2, i1]
    tw = _cross_twiddles(spec, n1, n2, inverse, coeffs.device)[i * (n2 // n_dev) : (i + 1) * (n2 // n_dev)]
    b = F.mont_mul(spec, _transform_rows(spec, b, inverse), tw)  # [i2, k1] w^(i2 k1)
    c = _transform_rows(spec, _transpose_sharded(b, mesh, axis), inverse)  # (n1/D, n2, L): [k1, k2]
    return _transpose_sharded(c, mesh, axis).reshape(m, L)  # [k2, k1]: X[k2 n1 + k1]


def batch_ntt_sharded(spec, rows: torch.Tensor, mesh: Mesh, axis: str | None = None,
                      inverse: bool = False) -> torch.Tensor:
    """rows: (R, n, L) replicated, R independent transforms, R divisible by
    the axis size; each rank transforms its rows (the Ligero RS-encode
    layout). Returns (R, n, L), canonical, replicated."""
    return map_rows(lambda r: _transform_rows(spec, r, inverse), rows, mesh, axis,
                    what="batch_ntt_sharded")


# ---------------------------------------------------------------------------
# linear codes' v^T M and IPA's key fold
# ---------------------------------------------------------------------------


def row_mul_sharded(spec, vec: torch.Tensor, mat: torch.Tensor, mesh: Mesh,
                    axis: str | None = None) -> torch.Tensor:
    """v (n, L) times M (n, cols, L) -> (cols, L), the rows sharded over the
    mesh axis (n divisible by its size): local log-depth partial sums, one
    all_gather, D field adds in rank order. Field sums are canonical, so the
    result is the single-device one; replicated."""
    sl = _slice(int(vec.shape[0]), mesh, axis, "row_mul_sharded")
    _check_replicated(mesh, axis, "row_mul_sharded", vec, mat)
    parts = _all_gather(P.row_combination(spec, vec[sl], mat[sl]), mesh, axis)
    acc = parts[0]
    for j in range(1, mesh.size(axis)):
        acc = F.add(spec, acc, parts[j])
    return acc


def fold_key_sharded(group, k_l, k_r, ch: int, mesh: Mesh, axis: str | None = None):
    """IPA's key fold key_l + ch key_r (pcs/ipa_pc.fold_key: one ed_smul
    launch, an add, a batched normalisation) on this rank's 1/D of the
    pairs; the folded affine key is all-gathered, so the next round's halves
    stay replicated. k_l, k_r: affine (x, y, inf) with batch (n/2,), n/2
    divisible by the axis size. Returns the affine key (x, y, inf)."""
    half = int(k_l[0].shape[0])
    sl = _slice(half, mesh, axis, "fold_key_sharded")
    ch_limbs = torch.tensor([(int(ch) >> (16 * j)) & 0xFFFF for j in range(16)])
    _check_replicated(mesh, axis, "fold_key_sharded", *k_l, *k_r, ch_limbs)
    kr_mul = group.scalar_mul(group.from_affine(*(a[sl] for a in k_r)), ch)
    x, y, inf = group.to_affine(group.add(group.from_affine(*(a[sl] for a in k_l)), kr_mul))
    L = x.shape[-1]
    g = _all_gather(torch.cat([x, y, inf[:, None].to(x.dtype)], -1), mesh, axis).reshape(half, -1)
    return g[:, :L].contiguous(), g[:, L : 2 * L].contiguous(), g[:, 2 * L] != 0


# ---------------------------------------------------------------------------
# placing data
# ---------------------------------------------------------------------------


def shard_batch(arr: torch.Tensor, mesh: Mesh, axis: str | None = None) -> torch.Tensor:
    """This rank's slice of a batch-leading array along a mesh axis, on the
    mesh's device (the JAX package places the global array sharded)."""
    return arr[_slice(int(arr.shape[0]), mesh, axis, "shard_batch")].to(mesh.device)


def replicate(tree, mesh: Mesh, axis: str | None = None):
    """Every tensor of ``tree`` (a tensor, or tuples, lists and dicts of
    them; other leaves pass unchanged) broadcast from the axis's first rank,
    on the mesh's device."""
    k = mesh._k(axis)

    def one(t):
        if isinstance(t, torch.Tensor):
            buf = _host(t.to(mesh.device), mesh).clone()
            dist.broadcast(buf, src=mesh.rows[k][0], group=mesh.groups[k])
            return _back(buf, mesh)
        if isinstance(t, (tuple, list)):
            return type(t)(one(x) for x in t)
        if isinstance(t, dict):
            return {key: one(v) for key, v in t.items()}
        return t

    return one(tree)
