"""The MSM window fold's inputs with known discrete logs, for the port's
fold tests on the CPU (tests/test_torch_msm.py) and on the card
(tests/test_torch_gpu.py). Torch and the port only, no JAX.

The parts of a fold are G_last and sum G of each window, Jacobian limbs
(L, rows W) with a row's windows side by side. Here each is a multiple of
the generator by a known log (0 for infinity), so a row's fold is the
generator times sum_w 2^(c w) ((2^c - 1) log G_last - log sum G).
"""

import numpy as np
import torch

from poly_commit_tpu_torch.core import ff, hostec, msm, msm_gpu


def fold_logs(r, c, windows, rows, seed):
    """Logs of (G_last, sum G) for ``rows`` rows of ``windows`` >= 4
    windows, each row's windows side by side. Row 0 random but for its
    edge windows: sum G = (2^c - 1) G_last (S_0 = 0), G_last = sum G
    (window 1), G_last = -sum G (window 2), G_last at infinity (window 3).
    Row 1 all zero (a row of zero scalars), row 2 one window non-zero, the
    rest random. Returns ([G_last logs, sum G logs], each row's log of its
    fold)."""
    rng = np.random.default_rng(seed)

    def rand():
        return int.from_bytes(rng.bytes(40), "little") % r

    last = [[rand() for _ in range(windows)] for _ in range(rows)]
    summ = [[rand() for _ in range(windows)] for _ in range(rows)]
    summ[0][0] = ((1 << c) - 1) * last[0][0] % r
    summ[0][1] = last[0][1]
    summ[0][2] = (r - last[0][2]) % r
    last[0][3] = 0
    if rows > 1:
        last[1], summ[1] = [0] * windows, [0] * windows
    if rows > 2:
        for w in range(windows):
            if w != 2:
                last[2][w] = summ[2][w] = 0
    want = [sum((((1 << c) - 1) * a - b) << (c * w) for w, (a, b) in enumerate(zip(la, sb))) % r
            for la, sb in zip(last, summ)]
    return [sum(last, []), sum(summ, [])], want


def host_fold_parts(group, logs, seed):
    """fold_logs' parts on the CPU from host multiples of the generator,
    each with a random z."""
    spec, hg = group.spec, hostec.host_group(group)
    rng = np.random.default_rng(seed)
    parts = ()
    for row in logs:
        pts = [hg.mul_fast((group.gen_x, group.gen_y), k) if k else None for k in row]
        x = ff.from_ints(spec, [0 if p is None else p[0] for p in pts], device="cpu")
        y = ff.from_ints(spec, [1 if p is None else p[1] for p in pts], device="cpu")
        inf = torch.tensor([p is None for p in pts])
        z = ff.from_ints(spec, [int.from_bytes(rng.bytes(40), "little") % spec.modulus or 1
                                for _ in pts], device="cpu")
        z2 = ff.plain("mul", spec, z, z)
        xj, yj = ff.plain("mul", spec, x, z2), ff.plain("mul", spec, y, ff.plain("mul", spec, z2, z))
        parts += (xj, yj, ff.select(inf, torch.zeros_like(z), z))
    return parts


def card_fold_parts(group, logs, device):
    """fold_logs' parts on ``device`` by the port's fixed-base
    multiplication of the generator (Jacobian, its own z)."""
    spec = group.spec
    gx = ff.from_ints(spec, [group.gen_x], device=device)
    gy = ff.from_ints(spec, [group.gen_y], device=device)
    parts = ()
    for row in logs:
        parts += msm_gpu.fixed_base(group, gx, gy,
                                    msm.scalars_from_ints(group.scalar_spec, row, device))
    return parts


def fold_to_host(group, coords):
    """A fold's (L, rows) Jacobian coords as host affine points."""
    return msm_gpu.JACOBIAN_OPS.to_host(group.spec, None, coords)


def want_points(group, want):
    """The generator times each row's log (None for 0)."""
    hg = hostec.host_group(group)
    return [hg.mul_fast((group.gen_x, group.gen_y), k) if k else None for k in want]
