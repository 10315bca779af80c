"""Limbs-first Pippenger MSM and fixed-base multiplication on the GPU.

Counterpart of poly_commit_tpu/core/msm_tpu.py, following ``_msm_body``:

  1. Window digits of c bits per scalar; padding and points at infinity get
     the sentinel 2^c. Each window's points are grouped by digit with the
     counting sort of core/sort_gpu.py (K3), which also yields the bucket
     tails.
  2. The sorted points are laid out as T lanes x S steps per window; the
     packed mixed add accumulates every lane's prefix over its S steps, and
     each step's prefix is kept: in G1 one ``madd_scan`` launch (K2a), in
     G2 and JubJub a loop of S launches (``ec_lf.scan_loop``).
  3. A Blelloch tree over the T lanes (2 log2 T launches of ``add``) turns
     the lane totals into exclusive cross-lane prefixes.
  4. Each bucket's running sum G_b is the global prefix at its tail:
     lane prefix + within-lane prefix, one gathered ``add``.
  5. Abel summation S_w = (2^c - 1) G_last - sum_{b < 2^c - 1} G_b: a
     halving tree of ``add`` launches; the windows fold on the device
     (``fold_device``: one K2a ``window_fold`` launch on the card) for the
     rows of ``msm_rows`` and for one G1 MSM on the card, and on host ints
     (``_fold_host``) for one MSM on the CPU, in G2 or in JubJub.

The group law comes from an ops object, as in msm_tpu.py: ``JACOBIAN_OPS``
(G1, kernel K2a), ``G2_OPS`` (G2 over Fq2, K2c; coordinates are (2L, N)
stacks) and ``EDWARDS_OPS`` (JubJub, K2b; four coordinates, complete, so
the distinct forms do not exist and the digit sentinel alone skips
padding). ``ops_for(group)`` picks one; it also carries the group's
layouts between the scheme layer and the limbs-first kernels.

T and c are chosen from the device and N: on the card c = 16 and T = 4096
from 2^16 points up (16 windows x 4096 lanes = 65,536 points per launch),
c = 8 and T = 1024 from 2^8, and c = 4 and T = 16 below that and on the CPU,
where the plain versions run eagerly. The result is the same group element.

``msm_rows`` is the counterpart of Hyrax's ``jax.vmap`` of the MSM over
rows sharing one set of bases (poly_commit_tpu/pcs/hyrax.py): the rows'
windows are stacked as more windows of one body (one sort, one scan, one
lane tree and one Abel tree a chunk of rows), and the fold runs on the
device for every row at once, as msm_tpu does under a trace
(``_combine_sw_device``, ``_fold_device``), in the one launch a single G1
MSM on the card takes too. Its lane count gives each lane
ROW_STEPS steps (``rows_params``): B rows fill the card with few lanes a
window, where a single MSM of the same N needs many.

``fixed_base`` replaces ``_fixed_base_body`` with a shape suited to the
card: the 256 doublings of the base (``double``), one batched normalisation
of all of them (K1), a table d * 2^(c w) g built in c launches of
``madd_distinct`` (row k..2k-1 = rows 0..k-1 + 2^(c w + log k) g) and
normalised, then one complete ``madd`` per window over all scalars. It is
generic over the Jacobian groups, so G2 setup runs on K2c (the JAX package
sends G2 fixed-base through its portable scan instead; the group elements
are the same).
"""

from __future__ import annotations

import torch

from . import ec_lf as EC
from . import extfield as E2
from . import ff
from . import hostec
from . import sort_gpu
from .field_params import FieldSpec
from ..utils import trace

SCALAR_BITS = 256
CHUNK = 1 << 20  # points per MSM call: the kept prefixes take ~4.8 GB at 2^20


def params(device: torch.device, n: int):
    """(window bits c, lanes per window T) for an MSM of n points on
    ``device``. The bucket work (W 2^c lanes, c Abel levels) does not shrink
    with n, so on the card only SRS-sized MSMs take c = 16; the verifier's
    combinations of a few points and the hiding parts take c = 4."""
    if device.type != "cuda" or n < 1 << 8:
        return 4, 16
    if n < 1 << 16:
        return 8, 1024
    return 16, 4096


def fixed_base_window(device: torch.device) -> int:
    return 8 if device.type == "cuda" else 4


def _fl_to_lf(a: torch.Tensor) -> torch.Tensor:
    return ff.from_field_last(a)


def _lf_to_fl(spec: FieldSpec, a: torch.Tensor, batch_shape) -> torch.Tensor:
    return ff.to_field_last(ff.canonicalize(spec, a), batch_shape)


class JACOBIAN_OPS:
    """G1 Jacobian (3 coordinates of L rows): kernel K2a. ``to_lf`` and
    ``from_lf`` carry the scheme layer's (N, L) to the kernels' (L, N) and
    back, canonical."""

    n_coords = 3
    host_identity = None
    to_lf = staticmethod(_fl_to_lf)
    from_lf = staticmethod(_lf_to_fl)

    @staticmethod
    def rows(spec):
        return spec.n_limbs

    @staticmethod
    def madd(spec, p, x, y, distinct: bool):
        return (EC.madd_distinct if distinct else EC.madd)(spec, p, x, y)

    @staticmethod
    def scan(spec, packed, idx, keep, distinct: bool):
        """The within-lane scan in one launch, the points point-major."""
        return EC.madd_scan(spec, packed.T.contiguous(), idx, keep, distinct)

    add = staticmethod(EC.add)
    double = staticmethod(EC.double)
    from_affine = staticmethod(EC.from_affine)

    @staticmethod
    def infinity(spec, n, device):
        return EC.infinity(spec, n, device)

    @staticmethod
    def to_affine(spec, p):
        return jacobian_to_affine(spec, p)

    @staticmethod
    def to_host(spec, hg, coords):
        q = spec.modulus
        xs, ys, zs = (ff.to_ints(spec, cc) for cc in coords)
        pts = []
        for x, y, z in zip(xs, ys, zs):
            if z == 0:
                pts.append(None)
                continue
            zi = pow(z, -1, q)
            pts.append((x * zi * zi % q, y * zi * zi * zi % q))
        return pts

    @staticmethod
    def from_host(spec, pt, device):
        if pt is None:
            return EC.infinity(spec, 1, device)
        return (ff.from_ints(spec, [pt[0]], device=device),
                ff.from_ints(spec, [pt[1]], device=device), ff.one_mont(spec, 1, device))


class G2_OPS:
    """G2 Jacobian over Fq2 (3 coordinates of 2L rows, c0 over c1): kernel
    K2c. The scheme layer's (N, 2, L) pairs become (2L, N) stacks."""

    n_coords = 3
    host_identity = None
    to_lf = staticmethod(E2.to_lf)

    @staticmethod
    def from_lf(spec, a, batch_shape):
        return E2.from_lf(E2.canonicalize_lf(spec, a), batch_shape)

    @staticmethod
    def rows(spec):
        return 2 * spec.n_limbs

    @staticmethod
    def madd(spec, p, x, y, distinct: bool):
        return (EC.g2_madd_distinct if distinct else EC.g2_madd)(spec, p, x, y)

    @staticmethod
    def scan(spec, packed, idx, keep, distinct: bool):
        """The within-lane scan, one mixed-add launch a step."""
        madd = EC.g2_madd_distinct_packed if distinct else EC.g2_madd_packed
        return EC.scan_loop(lambda p, g: madd(spec, p, g),
                            EC.g2_infinity(spec, idx.shape[1], idx.device), packed, idx, keep)

    add = staticmethod(EC.g2_add)
    double = staticmethod(EC.g2_double)
    from_affine = staticmethod(EC.g2_from_affine)

    @staticmethod
    def infinity(spec, n, device):
        return EC.g2_infinity(spec, n, device)

    @staticmethod
    def to_affine(spec, p):
        return jacobian_to_affine_fq2(spec, p)

    @staticmethod
    def to_host(spec, hg, coords):
        L = spec.n_limbs
        xs, ys, zs = (list(zip(ff.to_ints(spec, cc[:L]), ff.to_ints(spec, cc[L:])))
                      for cc in coords)
        return [hg._jto_affine((x, y, z)) for x, y, z in zip(xs, ys, zs)]

    @staticmethod
    def from_host(spec, pt, device):
        if pt is None:
            return EC.g2_infinity(spec, 1, device)

        def dev2(e):
            return torch.cat([ff.from_ints(spec, [e[0]], device=device),
                              ff.from_ints(spec, [e[1]], device=device)], 0)

        return (dev2(pt[0]), dev2(pt[1]), EC.fq2_one(spec, 1, device))


class EDWARDS_OPS:
    """JubJub extended coordinates (4 coordinates of L rows): kernel K2b.
    The unified addition is complete: ``madd`` ignores ``distinct``."""

    n_coords = 4
    host_identity = (0, 1)
    to_lf = staticmethod(_fl_to_lf)
    from_lf = staticmethod(_lf_to_fl)

    @staticmethod
    def rows(spec):
        return spec.n_limbs

    @staticmethod
    def madd(spec, p, x, y, distinct: bool):
        return EC.ed_madd(spec, p, x, y)

    @staticmethod
    def scan(spec, packed, idx, keep, distinct: bool):
        """The within-lane scan, one mixed-add launch a step."""
        return EC.scan_loop(lambda p, g: EC.ed_madd_packed(spec, p, g),
                            EC.ed_infinity(spec, idx.shape[1], idx.device), packed, idx, keep)

    add = staticmethod(EC.ed_add)
    double = staticmethod(EC.ed_double)

    @staticmethod
    def infinity(spec, n, device):
        return EC.ed_infinity(spec, n, device)

    @staticmethod
    def to_host(spec, hg, coords):
        p = spec.modulus
        xs, ys, zs = (ff.to_ints(spec, cc) for cc in coords[:3])
        out = []
        for x, y, z in zip(xs, ys, zs):
            zi = pow(z, -1, p)
            out.append((x * zi % p, y * zi % p))
        return out

    @staticmethod
    def from_host(spec, pt, device):
        pt = (0, 1) if pt is None else pt
        return EC.ed_from_affine(spec, ff.from_ints(spec, [pt[0]], device=device),
                                 ff.from_ints(spec, [pt[1]], device=device))


def ops_for(group):
    """The ops object of a device group (G1, G2 or JubJub)."""
    if hostec._is_edwards(group):
        return EDWARDS_OPS
    if hostec._is_g2(group):
        return G2_OPS
    return JACOBIAN_OPS


def _digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """(..., N, 16) plain 16-bit limbs -> (..., W, N) c-bit window digits
    (int32)."""
    w_count = SCALAR_BITS // c
    per_limb = 16 // c
    w = torch.arange(w_count, device=scalars.device)
    limb = scalars.transpose(-1, -2)[..., w // per_limb, :]  # (..., W, N)
    shift = ((w % per_limb) * c).to(torch.int32).unsqueeze(1)
    return ((limb >> shift) & ((1 << c) - 1)).contiguous()


def _flat(pts, L: int, m: int):
    return tuple(cc.reshape(L, m).contiguous() for cc in pts)


def _window_digits(scalars, inf, c: int) -> torch.Tensor:
    """(..., N, 16) plain scalars -> (..., W, N) digits, the sentinel 2^c
    where the point is at infinity (inf (N,))."""
    digs = _digits(scalars, c)
    return torch.where(inf, torch.full_like(digs, 1 << c), digs)


def _msm_body(spec: FieldSpec, ops, digs, x, y, assume_distinct: bool, c: int, t_lanes: int):
    """digs (W, N) window digits in [0, 2^c], the sentinel 2^c for a point
    left out; x, y (rows, N) affine; N a multiple of T. W counts windows of
    every MSM that shares these bases (msm_rows stacks its rows' windows).
    Returns G_last and sum G per window: 2 n_coords coords (rows, W)."""
    n = digs.shape[1]
    L = ops.rows(spec)
    nc = ops.n_coords
    dev = x.device
    bsz = 1 << c
    w_count = digs.shape[0]
    l_steps = n // t_lanes
    m = w_count * t_lanes

    order, sd, incl = sort_gpu.digit_sort(digs, bsz)

    # lane t of window w covers sorted positions [t S, (t + 1) S)
    idx_l = order.view(w_count, t_lanes, l_steps).permute(2, 0, 1).reshape(l_steps, m).contiguous()
    keep_l = (sd != bsz).view(w_count, t_lanes, l_steps).permute(2, 0, 1).reshape(l_steps, m).contiguous()
    packed = EC.pack(x, y)  # x and y limb pairs as 32-bit words: one gather
    acc, prefixes = ops.scan(spec, packed, idx_l, keep_l, assume_distinct)

    # exclusive prefix of the lane totals per window (Blelloch)
    levels = t_lanes.bit_length() - 1
    sums = tuple(cc.view(L, w_count, t_lanes) for cc in acc)
    stack = []
    width = t_lanes
    for _ in range(levels):
        even = tuple(cc[:, :, 0::2] for cc in sums)
        odd = tuple(cc[:, :, 1::2] for cc in sums)
        stack.append(even)
        width //= 2
        s2 = ops.add(spec, _flat(even, L, w_count * width), _flat(odd, L, w_count * width))
        sums = tuple(cc.view(L, w_count, width) for cc in s2)
    pref = tuple(cc.view(L, w_count, 1) for cc in ops.infinity(spec, w_count, dev))
    width = 1
    for lv in reversed(range(levels)):
        odd = ops.add(spec, _flat(pref, L, w_count * width), _flat(stack[lv], L, w_count * width))
        pref = tuple(
            torch.stack([pe, po.view(L, w_count, width)], dim=3).reshape(L, w_count, 2 * width)
            for pe, po in zip(pref, odd)
        )
        width *= 2
    lane_pref = _flat(pref, L, m)

    # G_b = lane prefix + within-lane prefix at bucket b's tail position
    tails = incl[:, :bsz].long() - 1  # (W, bsz) in [-1, n - 1]
    pos = tails.clamp(min=0)
    lane = pos // l_steps
    step = pos % l_steps
    lane_flat = (lane + (torch.arange(w_count, device=dev) * t_lanes).unsqueeze(1)).reshape(-1)
    at = step.reshape(-1) * m + lane_flat
    within = tuple(prefixes[k].view(L, l_steps * m).index_select(1, at) for k in range(nc))
    del prefixes
    lp_at = tuple(cc.index_select(1, lane_flat) for cc in lane_pref)
    g = ops.add(spec, within, lp_at)
    g = EC.select((tails >= 0).reshape(-1), g, ops.infinity(spec, g[0].shape[1], dev))

    # Abel summation: S_w = (bsz - 1) G_last - sum_{b < bsz - 1} G_b
    g3 = tuple(cc.view(L, w_count, bsz) for cc in g)
    g_last = tuple(cc[:, :, bsz - 1].contiguous() for cc in g3)
    inf_col = tuple(cc.view(L, w_count, 1) for cc in ops.infinity(spec, w_count, dev))
    cur = tuple(torch.cat([cc[:, :, : bsz - 1], ic], dim=2) for cc, ic in zip(g3, inf_col))
    mlen = bsz
    while mlen > 1:
        half = mlen // 2
        s2 = ops.add(spec, _flat(tuple(cc[:, :, :half] for cc in cur), L, w_count * half),
                     _flat(tuple(cc[:, :, half:] for cc in cur), L, w_count * half))
        cur = tuple(cc.view(L, w_count, half) for cc in s2)
        mlen = half
    sum_g = tuple(cc[:, :, 0].contiguous() for cc in cur)
    return g_last + sum_g


@trace.traced("MSM::fold_host", log=False)
def _fold_host(group, ops, parts, c: int):
    """S_w = (2^c - 1) G_last - sum G per window, then the Horner fold over
    windows, on host ints (a few dozen points). Returns a host point."""
    grp = hostec.host_group(group)
    nc = ops.n_coords
    g_last = ops.to_host(group.spec, grp, parts[:nc])
    sum_g = ops.to_host(group.spec, grp, parts[nc:])
    pts = [grp.sub(grp.mul(gl, (1 << c) - 1), sg) for gl, sg in zip(g_last, sum_g)]
    acc = ops.host_identity
    for pt in reversed(pts):
        for _ in range(c):
            acc = grp.double(acc)
        acc = grp.add(acc, pt)
    return acc


@trace.traced("MSM::msm", log=False)
def msm(group, scalars: torch.Tensor, x, y, inf, assume_distinct: bool = False):
    """sum_i scalars[i] * (x_i, y_i): scalars (N, 16) int32 plain limbs,
    x, y (rows, N) affine Montgomery limbs (2L rows, c0 over c1, in G2),
    inf (N,) bool. Returns the group's projective coords (rows, 1).

    assume_distinct: the bases are pairwise DL-independent (every SRS), so
    the scan may use the distinct mixed add; repeated bases then give wrong
    sums. Otherwise the complete mixed add runs. JubJub's addition is
    complete either way.

    A G1 MSM on the card folds its windows there (``fold_device``, one
    launch); on the CPU, in G2 and in JubJub they fold on host ints
    (``_fold_host``), which on the CPU is 20-30x faster than the plain tree.
    """
    spec = group.spec
    ops = ops_for(group)
    n = scalars.shape[0]
    dev = x.device
    if n > CHUNK:
        acc = None
        for s in range(0, n, CHUNK):
            part = msm(group, scalars[s : s + CHUNK], x[:, s : s + CHUNK].contiguous(),
                       y[:, s : s + CHUNK].contiguous(), inf[s : s + CHUNK], assume_distinct)
            acc = part if acc is None else ops.add(spec, acc, part)
        return acc
    c, t_lanes = params(dev, n)
    n2 = 1 << max(t_lanes.bit_length() - 1, (n - 1).bit_length())
    if n2 != n:
        pad = n2 - n
        scalars = torch.cat([scalars, scalars.new_zeros((pad, scalars.shape[1]))], 0)
        x = torch.cat([x, x.new_zeros((x.shape[0], pad))], 1)
        y = torch.cat([y, y.new_zeros((y.shape[0], pad))], 1)
        inf = torch.cat([inf, inf.new_ones((pad,))], 0)
    trace.count("msm_points_run", n2)
    parts = _msm_body(spec, ops, _window_digits(scalars, inf, c), x, y, assume_distinct, c,
                      t_lanes)
    if ops is JACOBIAN_OPS and dev.type == "cuda":
        return fold_device(spec, parts, c, 1)
    return ops.from_host(spec, _fold_host(group, ops, parts, c), dev)


# ---------------------------------------------------------------------------
# batched MSM over shared bases, the window fold on the device (Hyrax)
# ---------------------------------------------------------------------------

ROW_STEPS = 128  # steps a lane of msm_rows scans: the lane tree stays small beside the scan
MAX_ROW_WINDOWS = 1 << 15  # windows a digit sort of msm_rows takes (K3's grid: below 2^16)


def rows_params(device: torch.device, n: int):
    """(c, T) for msm_rows over n points a row: c as ``params`` takes it,
    and T so that each lane scans ROW_STEPS steps (n a power of two). A
    single MSM of 2^11 points takes T = 1024 lanes of 2 steps, where the
    lane tree costs as much as the scan; B rows of it scan B W T lanes at
    once, so few lanes a window still fill the card (Hyrax at 22
    variables: 512 rows x 32 windows x 16 lanes a chunk)."""
    c, _ = params(device, n)
    return c, max(1, n // ROW_STEPS)


@trace.traced("MSM::fold_device", log=False)
def fold_device(spec: FieldSpec, parts, c: int, rows: int):
    """The window fold of ``rows`` G1 MSMs on the device, the counterpart of
    msm_tpu._combine_sw_device and _fold_device batched over rows: parts
    are _msm_body's G_last and sum G with columns row-major (rows W), and
    the result row b's sum_w 2^(c w) S_w, coords (L, rows). One K2a
    ``window_fold`` launch on the card (its plain version, a halving tree,
    on the CPU)."""
    trace.count("msm_device_folds", rows)
    return EC.window_fold(spec, parts, c, rows)


@trace.traced("MSM::msm_rows", log=False)
def msm_rows(group, scalars: torch.Tensor, x, y, inf, assume_distinct: bool = False):
    """B MSMs over the same N bases: row b is sum_i scalars[b, i] *
    (x_i, y_i). scalars (B, N, 16) int32 plain limbs; x, y (L, N) affine
    Montgomery limbs; inf (N,) bool. Returns Jacobian coords (L, B), each
    column the same group element as ``msm`` of that row.

    The rows' windows are sorted together in one K3 call (a row's W
    windows are W more keys rows), scanned in one ``madd_scan`` over B W T
    lanes, and summed by one lane tree and one Abel tree over all of them;
    the windows fold on the device (``fold_device``): no host work per row.
    Rows go through in chunks of at most CHUNK scalars (the kept prefixes
    take ~6.4 GB at 2^20 for c = 8). G1 only."""
    spec = group.spec
    ops = ops_for(group)
    if ops is not JACOBIAN_OPS:
        raise ValueError(f"{group.name}: msm_rows takes a G1 group")
    b_rows, n = scalars.shape[0], scalars.shape[1]
    dev = x.device
    if b_rows == 0 or n == 0:
        return ops.infinity(spec, b_rows, dev)
    n2 = 1 << (n - 1).bit_length()
    c, t_lanes = rows_params(dev, n2)
    n2 = max(n2, t_lanes)
    if n2 != n:
        pad = n2 - n
        scalars = torch.cat([scalars, scalars.new_zeros((b_rows, pad, scalars.shape[2]))], 1)
        x = torch.cat([x, x.new_zeros((x.shape[0], pad))], 1)
        y = torch.cat([y, y.new_zeros((y.shape[0], pad))], 1)
        inf = torch.cat([inf, inf.new_ones((pad,))], 0)
    trace.count("msm_points_run", b_rows * n2)
    w_count = SCALAR_BITS // c
    per_chunk = max(1, min(CHUNK // n2, MAX_ROW_WINDOWS // w_count))
    parts = []
    for s in range(0, b_rows, per_chunk):
        digs = _window_digits(scalars[s : s + per_chunk], inf, c).view(-1, n2)
        parts.append(_msm_body(spec, ops, digs, x, y, assume_distinct, c, t_lanes))
    parts = tuple(torch.cat([p[k] for p in parts], 1) for k in range(2 * ops.n_coords))
    return fold_device(spec, parts, c, b_rows)


# ---------------------------------------------------------------------------
# normalisation (kernel K1)
# ---------------------------------------------------------------------------


def jacobian_to_affine(spec: FieldSpec, p):
    """(x, y, z) (L, M) -> affine (x, y) (L, M); infinity maps to (0, 0).
    Counterpart of msm_tpu._jacobian_to_affine, batched over all M."""
    x, y, z = p
    zi = ff.batch_inv(spec, z)
    zi2 = ff.mont_mul(spec, zi, zi)
    return ff.mont_mul(spec, x, zi2), ff.mont_mul(spec, y, ff.mont_mul(spec, zi2, zi))


def jacobian_to_affine_fq2(spec: FieldSpec, p):
    """G2 (x, y, z) (2L, M) -> affine (x, y) (2L, M), one batched Fq2
    inversion (its norms share one Fermat inversion); infinity -> (0, 0)."""
    x, y, z = p
    zi = E2.batch_inv_lf(spec, z)
    zi2 = E2.mul_lf(spec, zi, zi)
    return E2.mul_lf(spec, x, zi2), E2.mul_lf(spec, y, E2.mul_lf(spec, zi2, zi))


# ---------------------------------------------------------------------------
# fixed-base batch multiplication (every scheme's SRS setup)
# ---------------------------------------------------------------------------


@trace.traced("MSM::fixed_base", log=False)
def fixed_base(group, gx, gy, scalars: torch.Tensor):
    """[s_i * g] in a Jacobian group (G1 or G2): gx, gy (rows, 1) affine
    limbs of g (not infinity), scalars (N, 16) int32 plain. Returns Jacobian
    coords (rows, N)."""
    spec = group.spec
    ops = ops_for(group)
    if ops is EDWARDS_OPS:
        raise ValueError("fixed_base takes a Weierstrass group")
    dev = gx.device
    c = fixed_base_window(dev)
    L = ops.rows(spec)
    w_count = SCALAR_BITS // c
    bsz = 1 << c
    n = scalars.shape[0]

    # 2^k g for k < 256, then all of them affine in one batched inversion
    p = ops.from_affine(spec, gx, gy)
    chain = []
    for _ in range(SCALAR_BITS):
        chain.append(p)
        p = ops.double(spec, p)
    cx, cy = ops.to_affine(spec, tuple(torch.cat([q[k] for q in chain], dim=1) for k in range(3)))

    # tab[w][d] = d 2^(c w) g: rows [k, 2k) = rows [0, k) + 2^(c w + j) g,
    # k = 2^j; the addend never equals +-row, so the distinct madd is exact
    tab = tuple(cc.view(L, w_count, 1) for cc in ops.infinity(spec, w_count, dev))
    for j in range(c):
        k = 1 << j
        ax = cx[:, j::c].unsqueeze(2).expand(L, w_count, k)
        ay = cy[:, j::c].unsqueeze(2).expand(L, w_count, k)
        new = ops.madd(spec, _flat(tab, L, w_count * k), *_flat((ax, ay), L, w_count * k), True)
        tab = tuple(torch.cat([t, nw.view(L, w_count, k)], dim=2) for t, nw in zip(tab, new))
    tx, ty = ops.to_affine(spec, _flat(tab, L, w_count * bsz))

    digs = _digits(scalars, c)
    acc = ops.infinity(spec, n, dev)
    for w in range(w_count):
        d = digs[w]
        idx = d.long() + w * bsz
        added = ops.madd(spec, acc, tx.index_select(1, idx), ty.index_select(1, idx), False)
        acc = EC.select(d != 0, added, acc)
    return acc
