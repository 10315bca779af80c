"""The reference's parts against the port's own, at small sizes on the CPU:
the seeded stream, the transcript, the curve arithmetic, the exact limb
sums, Hyrax's generators and point bytes, and the generated inputs."""

import random

import torch

from poly_commit_tpu_torch.core import field as F
from poly_commit_tpu_torch.core import field_params as FP
from poly_commit_tpu_torch.core import hostec
from poly_commit_tpu_torch.core import curve as C
from poly_commit_tpu_torch.core.serialize import point_to_bytes
from poly_commit_tpu_torch.core.transcript import PoseidonSponge
from poly_commit_tpu_torch.pcs import hyrax as PH
from poly_commit_tpu_torch.pcs.data_structures import HostRng

from port_bench import inputs, seeds
from port_bench.reference import ec, hyrax, limbs
from port_bench.reference.curves import BLS12_381, BN254
from port_bench.reference.poseidon import Sponge

torch.set_num_threads(1)


def test_host_rng_is_the_ports_stream():
    for seed in (0, 7, 2**31 + 5, seeds.derive(2**33, "setup")):
        mine, theirs = seeds.HostRng(seed), HostRng(seed)
        for spec in (FP.FR_BLS12_381, FP.FR_BN254, FP.FQ_BLS12_381):
            assert mine.field_ints(spec, 5) == theirs.field_ints(spec, 5)
        assert mine.u128() == theirs.u128()


def test_derive_separates_purposes():
    assert seeds.derive(1, "poly", 0, "r0p0") == seeds.derive(1, "poly", 0, "r0p0")
    assert len({seeds.derive(1, "poly", 0, "r0p0"), seeds.derive(1, "poly", 0, "r0p1"),
                seeds.derive(2, "poly", 0, "r0p0"), seeds.derive(1, "poly", 1, "r0p0")}) == 4
    assert 0 <= seeds.derive(2**40, "x") < 2**63


def test_poseidon_is_the_ports_transcript():
    rng = random.Random(3)
    for spec in (FP.FR_BLS12_381, FP.FR_BN254):
        mine, theirs = Sponge(spec.modulus), PoseidonSponge(spec)
        for _ in range(3):
            elems = [rng.randrange(spec.modulus) for _ in range(rng.randrange(1, 6))]
            data = bytes(rng.randrange(256) for _ in range(rng.randrange(1, 80)))
            mine.absorb_field(elems)
            theirs.absorb_field(elems)
            mine.absorb_bytes(data)
            theirs.absorb_bytes(data)
            assert mine.squeeze_challenge_128() == theirs.squeeze_challenge_128()
            assert mine.squeeze_field(3) == theirs.squeeze_field(3)


def test_curve_arithmetic_against_the_host_groups():
    rng = random.Random(5)
    for curve, group in ((BLS12_381, C.BLS12_381_G1), (BN254, C.BN254_G1)):
        hg = hostec.host_group(group)
        g = curve.g1
        assert (g[1] ** 2 - g[0] ** 3 - curve.b) % curve.q == 0
        assert ec.mul(curve.q, g, curve.r) is None
        ks = [rng.randrange(curve.r) for _ in range(6)]
        pts = [ec.mul(curve.q, g, k) for k in ks]
        assert pts == [tuple(hg.mul(g, k)) for k in ks]
        sc = [rng.randrange(curve.r) for _ in range(6)]
        want = ec.mul(curve.q, g, sum(a * b for a, b in zip(ks, sc)) % curve.r)
        assert ec.msm(curve.q, pts, sc) == want
        assert ec.add_affine(curve.q, pts[0], pts[0]) == ec.mul(curve.q, pts[0], 2)
        neg = (pts[0][0], (-pts[0][1]) % curve.q)
        assert ec.add_affine(curve.q, pts[0], neg) is None
        assert ec.msm(curve.q, [pts[0], pts[0], None], [1, 1, 5]) == ec.mul(curve.q, pts[0], 2)


def test_exact_limb_sums():
    p = BLS12_381.r
    rng = random.Random(9)
    vals = [rng.randrange(p) for _ in range(2500)]
    a = torch.tensor([[(v >> (16 * k)) & 0xFFFF for k in range(16)] for v in vals], dtype=torch.int32)
    x = rng.randrange(p)
    assert limbs.evaluate(a, x, p) == sum(v * pow(x, i, p) for i, v in enumerate(vals)) % p
    w = [rng.randrange(p) for _ in range(2500)]
    got = limbs.weighted_sums(a.reshape(5, 500, 16), w[:500], p)
    assert got == [sum(v * c for v, c in zip(vals[500 * m:500 * (m + 1)], w)) % p
                   for m in range(5)]
    # the worst case of every limb at 2^16 - 1 stays exact
    top = torch.full((1, 1 << 12, 16), 0xFFFF, dtype=torch.int32)
    big = (1 << 256) - 1
    assert limbs.weighted_sums(top, [big] * (1 << 12), p) == [big * big * (1 << 12) % p]


def test_hyrax_generators_and_point_bytes():
    gens, h = hyrax.generators("bn254", 8)
    assert gens + [h] == PH.sample_generators(9)
    for g in gens[:3] + [None]:
        triple = (g[0], g[1], False) if g else (0, 0, True)
        assert hyrax.point_bytes(BN254, g) == point_to_bytes(C.BN254_G1, triple)
        if g:
            neg = (g[0], (-g[1]) % BN254.q)
            assert hyrax.point_bytes(BN254, neg) == point_to_bytes(C.BN254_G1, (neg[0], neg[1], False))


def test_eq_tensor_is_the_ports():
    from poly_commit_tpu_torch.core import poly as P

    rng = random.Random(2)
    pt = [rng.randrange(BN254.r) for _ in range(3)]
    theirs = F.to_ints(FP.FR_BN254, P.eq_table(FP.FR_BN254, F.from_ints(FP.FR_BN254, pt, device="cpu")))
    assert hyrax.eq_tensor(pt, BN254.r) == [int(v) for v in theirs]


def test_inputs_are_seeded_field_elements():
    a = inputs.field_limbs(BN254.r, 4096, 123, "cpu")
    b = inputs.field_limbs(BN254.r, 4096, 123, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.int32 and a.shape == (4096, 16)
    assert not torch.equal(a, inputs.field_limbs(BN254.r, 4096, 124, "cpu"))
    vals = F.to_ints(FP.FR_BN254, a, mont=False)
    assert all(0 <= int(v) < BN254.r for v in vals)
    assert int(a[:, 15].max()) < BN254.r >> 240
