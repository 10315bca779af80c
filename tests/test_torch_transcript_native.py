"""The port's native Poseidon permutation (csrc/poseidon.cpp) against the
JAX package's Python one.

For each field a sponge of the port uses, seeded random states and the
edge states (0, p - 1, one slot at p - 1) give the same state after one
permutation and after several, both through ``PoseidonSponge._permute`` and
through the library's k-permutation entry point in one call. The library
is built by the host compiler, not nvcc. The port runs on the CPU.
"""

import ctypes
import random

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

import poly_commit_tpu.core.field_params as jFP  # noqa: E402
import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
from poly_commit_tpu_torch import device as D  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SPECS = ("fr_bn254", "fr_bls12_381", "fr_bls12_377", "fr_jubjub")
STATES = 32
SEVERAL = 3


def _specs(name):
    return getattr(FP, name.upper()), getattr(jFP, name.upper())


def _states(p, seed):
    rng = random.Random(seed)
    edges = [[0, 0, 0], [p - 1] * 3, [p - 1, 0, 0], [0, p - 1, 0], [0, 0, p - 1],
             [p - 1, 1, rng.randrange(p)]]
    return edges + [[rng.randrange(p) for _ in range(3)] for _ in range(STATES - len(edges))]


@pytest.mark.parametrize("name", SPECS)
def test_native_permutation_matches_jax(name):
    spec, jspec = _specs(name)
    assert spec.modulus == jspec.modulus
    t, j = tT.PoseidonSponge(spec), jT.PoseidonSponge(jspec)
    lib = tT._lib()
    for i, state in enumerate(_states(spec.modulus, 17 + SPECS.index(name))):
        t.state, j.state = list(state), list(state)
        t._permute()
        j._permute()
        assert t.state == j.state, (name, i, "one permutation")
        for _ in range(SEVERAL - 1):
            t._permute()
            j._permute()
        assert t.state == j.state, (name, i, f"{SEVERAL} permutations")
        # the k-permutation entry point: SEVERAL more in one call
        buf = t._state_buffer()
        assert lib.pc_poseidon_permute(t.params, buf, SEVERAL) == SEVERAL
        t._load_state(buf)
        for _ in range(SEVERAL):
            j._permute()
        assert t.state == j.state, (name, i, "k in one call")
        assert all(0 <= v < spec.modulus for v in t.state)


@pytest.mark.parametrize("name", SPECS)
def test_native_params_pack_the_reference_constants(name):
    """The packed constants are the JAX package's, in Montgomery form, in
    the layout csrc/poseidon.cpp reads."""
    spec, jspec = _specs(name)
    p, R = spec.modulus, 1 << 256
    words = list(tT.native_params(spec))
    assert len(words) == 4 + 1 + 4 + 4 * 3 * (tT.FULL_ROUNDS + tT.PARTIAL_ROUNDS) + 4 * 9

    def elem(k):
        return sum(w << (64 * i) for i, w in enumerate(words[k : k + 4]))

    assert elem(0) == p and (words[4] * p) % (1 << 64) == (1 << 64) - 1
    assert elem(5) == R * R % p
    ark, mds = jT.poseidon_params(jspec)
    flat = [a for row in ark for a in row] + [m for row in mds for m in row]
    assert [elem(9 + 4 * i) for i in range(len(flat))] == [v * R % p for v in flat]


def test_the_library_builds_with_the_host_compiler(monkeypatch, tmp_path):
    """poseidon is host code: its build runs the host C++ compiler and never
    asks for nvcc, and its library is named by its own source and flags."""

    def no_nvcc():
        raise AssertionError("nvcc asked for host code")

    monkeypatch.setattr(D, "nvcc_path", no_nvcc)
    cmd = D._build_command("poseidon", tmp_path / "lib.so")
    assert cmd[0] == D.cxx_path() and str(D.CSRC / "poseidon.cpp") in cmd
    assert "poseidon" in D.HOST_SOURCES and "poseidon" not in D.SOURCES
    path = D.library_path("poseidon")
    assert path.parent == D.BUILD_DIR and path.name.startswith("libposeidon-")
    assert isinstance(D.library("poseidon"), ctypes.CDLL) and path.exists()
