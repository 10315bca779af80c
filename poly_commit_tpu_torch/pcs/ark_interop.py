"""arkworks interop for the KZG family: the reference's exact randomness
chain, sponge and serialization, producing the committed golden vectors.

Counterpart of poly_commit_tpu/pcs/ark_interop.py. One full setup ->
commit -> open -> check transcript whose every byte is fixed by emulated
arkworks primitives (core/ark_compat.py: ChaCha12 test_rng,
ChaCha20Rng::from_rng, Fp::rand, G1/G2 Projective::rand with cofactor
clearing, the ark Poseidon test sponge; core/serialize.py: the ark
CanonicalSerialize point format). The port replays
tests/vectors/{marlin,marlin_bounded,sonic}_ark_golden.json byte for byte.

The Rust recipe that gives the same bytes on a live arkworks build
(arkworks v0.5, BLS12-381; cf. poly-commit/src/lib.rs:643-900):

    let rng = &mut ChaCha20Rng::from_rng(test_rng()).unwrap(); // lib.rs:681
    let pp = PC::setup(DEGREE, None, rng)?;                    // beta, g, gamma_g, h
    let (ck, vk) = PC::trim(&pp, DEGREE, HIDING, BOUNDS)?;
    let p = DensePolynomial::<Fr>::rand(DEGREE or BOUND, rng);
    let (comms, states) = PC::commit(&ck, [&lp], rng)?;
    let point = Fr::rand(rng);
    // open and check with test_sponge::<Fr>() (lib.rs:1385-1416)

The setup points are computed on host ints, as arkworks does, and moved to
the device; the verifier key's h and beta_h stay host triples (the port's
kzg10.UniversalParams). Commit and open run on ``device`` (``cuda`` unless
the caller passes another), so on the card the golden MSMs of 11 points
run the MSM kernels.
"""

from __future__ import annotations

from .. import device as D
from ..core import curve as C
from ..core import field as F
from ..core import field_params as FP
from ..core import hostec
from ..core.ark_compat import (
    ArkPoseidonSponge,
    ChaCha20Rng,
    ark_fp_rand,
    ark_g1_rand,
    ark_g2_rand,
    ark_test_rng,
)
from ..core.serialize import ark_point_to_bytes
from . import kzg10
from .data_structures import LabeledPolynomial
from .marlin_pc import MarlinKZG10
from .sonic_pc import SonicKZG10

FR = FP.FR_BLS12_381
DEGREE = 10


class ArkRng:
    """HostRng-shaped adapter over the emulated ChaCha20Rng: scheme code
    calling ``rng.field_ints`` draws through Fp::rand exactly as arkworks'
    ``Randomness::rand(...)`` hiding chain does (kzg10/mod.rs:181-206)."""

    def __init__(self, rng: ChaCha20Rng):
        self._rng = rng

    def field_int(self, spec) -> int:
        return ark_fp_rand(self._rng, spec)

    def field_ints(self, spec, n: int) -> list:
        return [ark_fp_rand(self._rng, spec) for _ in range(n)]


def ark_kzg_universal_params(max_degree: int, produce_g2_powers: bool = False, device=None):
    """KZG10::setup with arkworks' randomness chain (kzg10/mod.rs:53-124:
    beta = Fr::rand, g = G1::rand, gamma_g = G1::rand, h = G2::rand, then
    deterministic power tables; with produce_g2_powers also
    neg_powers_of_h[i] = beta^-i h, mod.rs:90-104, the SonicKZG10 setup,
    sonic_pc/mod.rs:151-157). Returns (UniversalParams, rng, secrets)."""
    dev = D.resolve(device)
    rng = ChaCha20Rng.from_rng(ark_test_rng())
    beta = ark_fp_rand(rng, FR)
    g = ark_g1_rand(rng, C.BLS12_381_G1)
    gamma_g = ark_g1_rand(rng, C.BLS12_381_G1)
    h = ark_g2_rand(rng, C.BLS12_381_G2)

    hg1 = hostec.host_group(C.BLS12_381_G1)
    hg2 = hostec.host_group(C.BLS12_381_G2)
    pows = kzg10.host_powers(beta, max_degree + 2, FR.modulus)
    powers_of_g = [hg1.mul_fast(g, pows[i]) for i in range(max_degree + 1)]
    powers_of_gamma_g = [hg1.mul_fast(gamma_g, pows[i]) for i in range(max_degree + 2)]
    beta_h = hg2.mul_fast(h, beta)
    neg_h_pts = None
    if produce_g2_powers:
        npows = kzg10.host_powers(pow(beta, -1, FR.modulus), max_degree + 1, FR.modulus)
        neg_h_pts = [hg2.mul_fast(h, e) for e in npows]

    pp = kzg10.UniversalParams(
        powers_of_g=hostec.host_points_to_device_affine(C.BLS12_381_G1, powers_of_g, dev),
        powers_of_gamma_g=hostec.host_points_to_device_affine(C.BLS12_381_G1, powers_of_gamma_g,
                                                              dev),
        h=hostec.host_to_triple(h, fq2=True),
        beta_h=hostec.host_to_triple(beta_h, fq2=True),
        neg_powers_of_h=None if neg_h_pts is None else hostec.host_points_to_device_affine(
            C.BLS12_381_G2, neg_h_pts, dev),
        max_degree=max_degree,
    )
    secrets = dict(beta=beta, g=g, gamma_g=gamma_g, h=h, beta_h=beta_h,
                   powers_of_g=powers_of_g, neg_powers_of_h=neg_h_pts)
    return pp, rng, secrets


def _pt_hex(group, host_pt) -> str:
    triple = hostec.host_to_triple(host_pt, hostec._is_g2(group))
    return ark_point_to_bytes(group, triple, compressed=True).hex()


def _rv_hex(rv):
    if rv is None:
        return None
    if isinstance(rv, (list, tuple)):
        rv = rv[0]
    return hex(int(rv))


def _horner(coeff_ints, point) -> int:
    value = 0
    for c in reversed(coeff_ints):
        value = (value * point + c) % FR.modulus
    return value


def _transcript(PC, degree, bound, hiding, device):
    """The shared chain: setup, trim, a random polynomial (of degree
    ``bound`` when bounded), commit, a random point, open and check with
    fresh test sponges."""
    pp, rng, secrets = ark_kzg_universal_params(degree, PC is SonicKZG10, device)
    enforced = None if bound is None else [bound]
    ck, vk = PC.trim(pp, degree, supported_hiding_bound=hiding or 0,
                     enforced_degree_bounds=enforced)
    coeff_ints = [ark_fp_rand(rng, FR) for _ in range((degree if bound is None else bound) + 1)]
    poly = LabeledPolynomial("f", F.from_ints(FR, coeff_ints, device=pp.powers_of_g[0].device),
                             degree_bound=bound, hiding_bound=hiding)
    comms, states = PC.commit(ck, [poly], rng=None if hiding is None else ArkRng(rng))
    point = ark_fp_rand(rng, FR)
    value = _horner(coeff_ints, point)
    proof = PC.open(ck, [poly], comms, point, ArkPoseidonSponge(FR), states)
    ok = PC.check(vk, comms, point, [value], proof, ArkPoseidonSponge(FR))
    return secrets, coeff_ints, comms, states, point, value, proof, ok


def marlin_ark_golden(degree: int = DEGREE, device=None) -> dict:
    """The unbounded, non-hiding MarlinKZG10 transcript; returns the
    golden-vector dict."""
    secrets, coeff_ints, comms, _, point, value, proof, ok = _transcript(
        MarlinKZG10, degree, None, None, device)
    g1, g2 = C.BLS12_381_G1, C.BLS12_381_G2
    # component KATs (localize a mismatch to one sub-chain)
    kat_rng = ChaCha20Rng.from_rng(ark_test_rng())
    kat_sponge = ArkPoseidonSponge(FR)
    return {
        "curve": "bls12_381",
        "scheme": "marlin_pc::MarlinKZG10",
        "degree": degree,
        "kat": {
            "chacha20_seed_from_test_rng": ark_test_rng().fill_bytes(32).hex(),
            "chacha20_first_u64": f"{kat_rng.next_u64():016x}",
            "fr_rand_first_from_test_rng": hex(ark_fp_rand(ark_test_rng(), FR)),
            "sponge_first_squeeze": hex(kat_sponge.squeeze_native_field_elements(1)[0]),
            "sponge_first_challenge_128": hex(ArkPoseidonSponge(FR).squeeze_challenge_128()),
        },
        "beta": hex(secrets["beta"]),
        "g": _pt_hex(g1, secrets["g"]),
        "gamma_g": _pt_hex(g1, secrets["gamma_g"]),
        "h": _pt_hex(g2, secrets["h"]),
        "beta_h": _pt_hex(g2, secrets["beta_h"]),
        "powers_of_g_1": _pt_hex(g1, secrets["powers_of_g"][1]),
        "powers_of_g_last": _pt_hex(g1, secrets["powers_of_g"][-1]),
        "poly_coeffs": [hex(c) for c in coeff_ints],
        "point": hex(point),
        "value": hex(value),
        "commitment": _pt_hex(g1, hostec.triple_to_host(comms[0].commitment.comm)),
        "proof_w": _pt_hex(g1, hostec.triple_to_host(proof.w)),
        "proof_random_v": None,
        "check": bool(ok),
    }


def marlin_ark_golden_bounded(degree: int = DEGREE, bound: int = 5, hiding: int = 2,
                              device=None) -> dict:
    """MarlinKZG10 with a degree bound AND hiding: the shifted powers
    (marlin_pc/mod.rs:219-228) and the gamma_g hiding-randomness chain
    (kzg10/mod.rs:181-206) that the unbounded transcript never touches.

    Divergence note: if the blinding polynomial's leading Fr::rand draw is
    0 (probability ~2^-255), arkworks re-draws while this emulation pins
    the coefficient to 1: unreachable in any committed vector."""
    secrets, coeff_ints, comms, states, point, value, proof, ok = _transcript(
        MarlinKZG10, degree, bound, hiding, device)
    g1 = C.BLS12_381_G1
    return {
        "curve": "bls12_381",
        "scheme": "marlin_pc::MarlinKZG10",
        "degree": degree,
        "degree_bound": bound,
        "hiding_bound": hiding,
        "beta": hex(secrets["beta"]),
        "poly_coeffs": [hex(c) for c in coeff_ints],
        "blinding_poly": [hex(c) for c in F.to_ints(FR, states[0].rand.blinding_polynomial)],
        "shifted_blinding_poly": [
            hex(c) for c in F.to_ints(FR, states[0].shifted_rand.blinding_polynomial)
        ],
        "point": hex(point),
        "value": hex(value),
        "commitment": _pt_hex(g1, hostec.triple_to_host(comms[0].commitment.comm)),
        "shifted_commitment": _pt_hex(g1, hostec.triple_to_host(comms[0].commitment.shifted_comm)),
        "proof_w": _pt_hex(g1, hostec.triple_to_host(proof.w)),
        "proof_random_v": _rv_hex(proof.random_v),
        "check": bool(ok),
    }


def sonic_ark_golden(degree: int = DEGREE, bound: int = 5, hiding: int = 2,
                     device=None) -> dict:
    """SonicKZG10 with a degree bound and hiding: the neg-G2 power chain
    (kzg10/mod.rs:90-104 via sonic_pc/mod.rs:151-157) and Sonic's
    combined-opening accumulation (sonic_pc/mod.rs:341-384)."""
    secrets, coeff_ints, comms, states, point, value, proof, ok = _transcript(
        SonicKZG10, degree, bound, hiding, device)
    g1, g2 = C.BLS12_381_G1, C.BLS12_381_G2
    return {
        "curve": "bls12_381",
        "scheme": "sonic_pc::SonicKZG10",
        "degree": degree,
        "degree_bound": bound,
        "hiding_bound": hiding,
        "beta": hex(secrets["beta"]),
        "neg_powers_of_h_1": _pt_hex(g2, secrets["neg_powers_of_h"][1]),
        "neg_powers_of_h_last": _pt_hex(g2, secrets["neg_powers_of_h"][-1]),
        "poly_coeffs": [hex(c) for c in coeff_ints],
        "blinding_poly": [hex(c) for c in F.to_ints(FR, states[0].blinding_polynomial)],
        "point": hex(point),
        "value": hex(value),
        "commitment": _pt_hex(g1, hostec.triple_to_host(comms[0].commitment.point)),
        "proof_w": _pt_hex(g1, hostec.triple_to_host(proof.w)),
        "proof_random_v": _rv_hex(proof.random_v),
        "check": bool(ok),
    }
