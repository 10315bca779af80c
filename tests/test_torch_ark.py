"""The PyTorch port's arkworks interop against the committed golden vectors
and the JAX package.

The three vectors of tests/vectors/ replay byte for byte from the port
alone (no JAX in that path). The port's ark_compat (ChaCha, StdRng,
ChaCha20Rng, Fp::rand, the Poseidon test sponge, G1/G2 sampling) and its
point codecs (arkworks compressed and uncompressed, the framework's own
format, zcash) give what the JAX package's give on the same inputs. The
port runs on the CPU.
"""

import json
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.ark_compat as jA  # noqa: E402
import poly_commit_tpu.core.curve as jC  # noqa: E402
import poly_commit_tpu.core.serialize as jS  # noqa: E402
import poly_commit_tpu_torch.core.ark_compat as tA  # noqa: E402
import poly_commit_tpu_torch.core.curve as tC  # noqa: E402
import poly_commit_tpu_torch.core.serialize as tS  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from poly_commit_tpu_torch.core import hostec  # noqa: E402
from poly_commit_tpu_torch.pcs import ark_interop  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

VECTORS = os.path.join(os.path.dirname(__file__), "vectors")
GOLDENS = {"marlin_ark_golden": lambda v, dev: ark_interop.marlin_ark_golden(v["degree"], device=dev),
           "marlin_bounded_ark_golden": lambda v, dev: ark_interop.marlin_ark_golden_bounded(
               v["degree"], v["degree_bound"], v["hiding_bound"], device=dev),
           "sonic_ark_golden": lambda v, dev: ark_interop.sonic_ark_golden(
               v["degree"], v["degree_bound"], v["hiding_bound"], device=dev)}
GROUPS = {"g1": (tC.BLS12_381_G1, jC.BLS12_381_G1), "g2": (tC.BLS12_381_G2, jC.BLS12_381_G2)}
RFC8439_BLOCK = bytes.fromhex(
    "10f1e7e4d13b5915500fdd1fa32071c4c7d1f4c733c068030422aa9ac3d46c4e"
    "d2826446079faa0914c2d705d98b02a2b5129cd1de164eb9cbd083e8a2503c4e")


@pytest.mark.parametrize("name", list(GOLDENS))
def test_golden_vectors_replay(name):
    with open(os.path.join(VECTORS, f"{name}.json")) as fh:
        committed = json.load(fh)
    assert GOLDENS[name](committed, "cpu") == committed
    assert committed["check"] is True


def test_chacha_block_and_splitmix64_known_outputs():
    """RFC 8439 section 2.3.2's block (counter and nonce words mapped into
    the 64/64 layout) and splitmix64(0)'s first outputs, and the JAX copy's."""
    key = np.frombuffer(bytes(range(32)), "<u4").astype(np.uint64)
    args = (key, 1 | (0x09000000 << 32), 0x4A000000)
    assert tA._chacha_block(*args, rounds=20) == RFC8439_BLOCK
    assert jA._chacha_block(*args, rounds=20) == RFC8439_BLOCK
    for seed in (0, 1, 0xDEADBEEF):
        t, j = tA.splitmix64_stream(seed), jA.splitmix64_stream(seed)
        assert [next(t) for _ in range(8)] == [next(j) for _ in range(8)]
    g = tA.splitmix64_stream(0)
    assert (next(g), next(g)) == (0xE220A8397B1DCDAF, 0x6E789E6AA1B965F4)


@pytest.mark.parametrize("make", ["test_rng", "seed_from_u64", "chacha20_from_rng"])
def test_rng_streams_match_jax(make):
    def build(A):
        if make == "test_rng":
            return A.ark_test_rng()
        if make == "seed_from_u64":
            return A.StdRng.seed_from_u64(42)
        return A.ChaCha20Rng.from_rng(A.ark_test_rng())

    t, j = build(tA), build(jA)
    assert [t.next_u64() for _ in range(40)] == [j.next_u64() for _ in range(40)]
    assert [t.next_bool() for _ in range(20)] == [j.next_bool() for _ in range(20)]
    assert t.fill_bytes(32) == j.fill_bytes(32)


@pytest.mark.parametrize("spec", [FP.FR_BLS12_381, FP.FQ_BLS12_381, FP.FR_BLS12_377, FP.FR_BN254],
                         ids=lambda s: s.name)
def test_fp_rand_matches_jax(spec):
    t, j = tA.ChaCha20Rng.from_rng(tA.ark_test_rng()), jA.ChaCha20Rng.from_rng(jA.ark_test_rng())
    got = [tA.ark_fp_rand(t, spec) for _ in range(6)]
    assert got == [jA.ark_fp_rand(j, spec) for _ in range(6)]
    assert all(0 <= v < spec.modulus for v in got)


def test_poseidon_sponge_matches_jax():
    spec = FP.FR_BLS12_381
    assert tA.poseidon_test_ark(spec) == jA.poseidon_test_ark(spec)
    t, j = tA.ArkPoseidonSponge(spec), jA.ArkPoseidonSponge(spec)
    assert t.squeeze_native_field_elements(3) == j.squeeze_native_field_elements(3)
    for s in (t, j):
        s.absorb([1, 2, 3])
        s.absorb([spec.modulus - 1])
    assert t.squeeze_bytes(40) == j.squeeze_bytes(40)
    assert t.squeeze_bits(300) == j.squeeze_bits(300)
    assert t.squeeze_challenge_128() == j.squeeze_challenge_128()
    first = tA.ArkPoseidonSponge(spec).squeeze_challenge_128()
    assert first == jA.ArkPoseidonSponge(spec).squeeze_challenge_128() and first < 1 << 128


def _in_subgroup(group, pt) -> bool:
    """r P is infinity by an unreduced double-and-add."""
    hg = hostec.host_group(group)
    acc = None
    r = FP.BLS12_381_R
    for bit in reversed(range(r.bit_length())):
        acc = hg._jdouble(acc)
        if (r >> bit) & 1:
            acc = hg._jmadd(acc, pt)
    return hg._jto_affine(acc) is None


@pytest.mark.parametrize("which", list(GROUPS))
def test_group_rand_matches_jax_and_is_in_subgroup(which):
    t_group, j_group = GROUPS[which]
    t, j = tA.ChaCha20Rng.from_rng(tA.ark_test_rng()), jA.ChaCha20Rng.from_rng(jA.ark_test_rng())
    fn_t, fn_j = ((tA.ark_g1_rand, jA.ark_g1_rand) if which == "g1"
                  else (tA.ark_g2_rand, jA.ark_g2_rand))
    pts = [fn_t(t, t_group) for _ in range(2)]
    assert pts == [tuple(fn_j(j, j_group)) for _ in range(2)]
    assert all(p is not None and _in_subgroup(t_group, p) for p in pts)


def _points(which):
    """The generator, its negation, two random multiples and infinity, as
    (x, y, inf) triples."""
    group = GROUPS[which][0]
    hg = hostec.host_group(group)
    gen = (group.gen_x, group.gen_y) if which == "g1" else group.generator_host()
    rnd = random.Random(5)
    pts = [gen, hg.neg(gen)] + [hg.mul_fast(gen, rnd.randrange(1, FP.BLS12_381_R)) for _ in range(2)]
    return [hostec.host_to_triple(p, which == "g2") for p in pts] + [hostec.host_to_triple(None, which == "g2")]


@pytest.mark.parametrize("compressed", [True, False], ids=["compressed", "uncompressed"])
@pytest.mark.parametrize("which", list(GROUPS))
def test_ark_codec_matches_jax(which, compressed):
    t_group, j_group = GROUPS[which]
    for pt in _points(which):
        data = tS.ark_point_to_bytes(t_group, pt, compressed=compressed)
        assert data == jS.ark_point_to_bytes(j_group, pt, compressed=compressed)
        back = tS.ark_point_from_bytes(t_group, data, compressed=compressed)
        assert back == jS.ark_point_from_bytes(j_group, data, compressed=compressed)
        if pt[2]:
            assert back[2] is True and data[-1] == tS.ARK_SW_INFINITY and not any(data[:-1])
        else:
            assert back == pt


@pytest.mark.parametrize("which", list(GROUPS))
def test_framework_codec_matches_jax(which):
    t_group, j_group = GROUPS[which]
    for pt in _points(which):
        assert tS.point_to_bytes(t_group, pt) == jS.point_to_bytes(j_group, pt)
        assert (tS.point_to_bytes_uncompressed(t_group, pt)
                == jS.point_to_bytes_uncompressed(j_group, pt))
    for compressed in (True, False):
        assert tS.point_size(t_group, compressed) == jS.point_size(j_group, compressed)
    spec = t_group.spec
    v = random.Random(1).randrange(spec.modulus)
    assert tS.field_from_bytes(spec, tS.field_to_bytes(spec, v)) == v
    with pytest.raises(ValueError):
        tS.field_from_bytes(spec, spec.modulus.to_bytes(spec.serialized_size(), "little"))


def test_zcash_generator_encodings():
    """The public zcash-format compressed encodings of the BLS12-381
    generators, and the JAX copy's bytes for every test point."""
    q = FP.BLS12_381_Q
    g1 = (FP.BLS12_381_G1_X, FP.BLS12_381_G1_Y, False)
    g2 = (FP.BLS12_381_G2_X, FP.BLS12_381_G2_Y, False)
    assert tS.zcash_g1_to_bytes(g1, q) == bytes.fromhex(
        "97f1d3a73197d7942695638c4fa9ac0fc3688c4f9774b905"
        "a14e3a3f171bac586c55e83ff97a1aeffb3af00adb22c6bb")
    assert tS.zcash_g2_to_bytes(g2, q) == bytes.fromhex(
        "93e02b6052719f607dacd3a088274f65596bd0d09920b61a"
        "b5da61bbdc7f5049334cf11213945d57e5ac7d055d042b7e"
        "024aa2b2f08f0a91260805272dc51051c6e47ad4fa403b02"
        "b4510b647ae3d1770bac0326a805bbefd48056c8c121bdb8")
    for which, fn in (("g1", "zcash_g1_to_bytes"), ("g2", "zcash_g2_to_bytes")):
        for pt in _points(which):
            assert getattr(tS, fn)(pt, q) == getattr(jS, fn)(pt, q)


@pytest.mark.parametrize("which", ["g1", "g2"])
def test_host_points_round_trip_through_device_affine(which):
    group = GROUPS[which][0]
    pts = [hostec.triple_to_host(t) for t in _points(which)]
    dev = hostec.host_points_to_device_affine(group, pts, "cpu")
    assert hostec.device_affine_to_host(group, dev) == pts
