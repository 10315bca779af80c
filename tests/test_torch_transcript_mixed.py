"""A mixed transcript through the port's sponge and the JAX package's.

One seeded sequence of absorbs (field elements, bytes, a Montgomery limb
tensor, ``absorb_bytes_many``), squeezes of every kind between them, mode
switches and clones runs through both packages' ``PoseidonSponge``: the
state, the rate position, the mode and every squeezed value agree after
each step, and the port's ``poseidon_permutations`` count what the JAX
sponge ran. ``absorb_bytes_many`` of chunks equals ``absorb_bytes`` of each
in turn, in one crossing into the native sponge; the crossings
(``poseidon_native_calls``) sit on ``Transcript::absorb`` and
``Transcript::squeeze`` spans only. The port runs on the CPU.
"""

import random

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several worker processes at once,
# and torch threads spinning beside them slow every worker many times over
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import poly_commit_tpu.core.field_params as jFP  # noqa: E402
import poly_commit_tpu.core.transcript as jT  # noqa: E402
import poly_commit_tpu_torch.core.transcript as tT  # noqa: E402
from poly_commit_tpu_torch.core import field as F  # noqa: E402
from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from poly_commit_tpu_torch.utils import trace  # noqa: E402
pytest_plugins = ("tests.torch_port_jax",)  # frees JAX executables between files

SPECS = ("fr_bn254", "fr_bls12_381", "fr_bls12_377", "fr_jubjub")
FIELD_LENGTHS = (0, 1, 2, 3, 1000)
BYTE_LENGTHS = (0, 1, 31, 32, 33, 4000)


class Counted:
    """The JAX sponge, counting the permutations it runs."""

    def __init__(self, sponge):
        self.sponge, self.permutations = sponge, 0
        inner = sponge._permute

        def permute():
            self.permutations += 1
            inner()

        sponge._permute = permute


def _squeeze(rng, s):
    """One squeeze of a kind drawn from rng (the same draws for both)."""
    kind = rng.randrange(5)
    if kind == 0:
        return s.squeeze_field(rng.randrange(1, 5))
    if kind == 1:
        return s.squeeze_bits(rng.randrange(1, 600))
    if kind == 2:
        return s.squeeze_bytes(rng.randrange(1, 70))
    if kind == 3:
        return s.squeeze_challenge_128()
    return s.squeeze_challenges_128(rng.randrange(1, 4))


def _steps(spec, seed):
    """The sequence: (kind, argument) pairs drawn from the seed."""
    rng = random.Random(seed)
    p = spec.modulus
    steps = []
    for n in FIELD_LENGTHS:
        steps.append(("field", [rng.randrange(p) for _ in range(n - 1)] + [p - 1][: n]))
        if rng.random() < 0.5:
            steps.append(("squeeze", rng.randrange(1 << 30)))
    for n in BYTE_LENGTHS:
        steps.append(("bytes", rng.randbytes(n)))
        steps.append(("squeeze", rng.randrange(1 << 30)))
        steps.append(("bytes", rng.randbytes(rng.randrange(40))))
    steps.append(("many", [rng.randbytes(n) for n in BYTE_LENGTHS + (33, 33, 33)]))
    steps.append(("squeeze", rng.randrange(1 << 30)))
    steps.append(("device", [rng.randrange(p) for _ in range(7)]))
    steps.append(("clone", None))
    steps.append(("field", [rng.randrange(p) for _ in range(5)]))
    steps.append(("squeeze", rng.randrange(1 << 30)))
    steps.append(("squeeze", rng.randrange(1 << 30)))
    steps.append(("many", []))  # nothing, as absorb_bytes of no chunk: the mode stays
    steps.append(("squeeze", rng.randrange(1 << 30)))
    return steps


def _run(spec, jspec, seed):
    """Runs the steps through both sponges, comparing after each; returns
    the port's sponge and the JAX one's permutation count."""
    t, j = tT.PoseidonSponge(spec), Counted(jT.PoseidonSponge(jspec))
    for i, (kind, arg) in enumerate(_steps(spec, seed)):
        if kind == "field":
            t.absorb_field(arg)
            j.sponge.absorb_field(arg)
        elif kind == "bytes":
            t.absorb_bytes(arg)
            j.sponge.absorb_bytes(arg)
        elif kind == "many":
            t.absorb_bytes_many(arg)
            for data in arg:
                j.sponge.absorb_bytes(data)
        elif kind == "device":
            t.absorb_device_field(spec, F.from_ints(spec, arg, device="cpu"))
            j.sponge.absorb_field(arg)
        elif kind == "clone":
            # the clone runs on, and the original is left as it was
            before = (list(t.state), t.pos, t.mode)
            t, old = t.clone(), t
            t.absorb_field([1, 2, 3])
            assert (old.state, old.pos, old.mode) == before
            j.sponge.absorb_field([1, 2, 3])
        else:
            assert _squeeze(random.Random(arg), t) == _squeeze(random.Random(arg), j.sponge), (
                i, kind)
        assert (t.state, t.pos, t.mode) == (j.sponge.state, j.sponge.pos, j.sponge.mode), (
            i, kind)
    return t, j.permutations


@pytest.mark.parametrize("name", SPECS)
def test_mixed_transcript_matches_jax(name):
    spec, jspec = getattr(FP, name.upper()), getattr(jFP, name.upper())
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, permutations = _run(spec, jspec, 41 + SPECS.index(name))
    recs = trace.records()
    trace.reset()
    assert permutations > 500
    assert sum(r.counts.get("poseidon_permutations", 0) for r in recs) == permutations
    where = {r.name for r in recs if "poseidon_native_calls" in r.counts}
    assert where == {"Transcript::absorb", "Transcript::squeeze"}
    assert all(r.name.startswith("Transcript::") for r in recs
               if "poseidon_permutations" in r.counts)


@pytest.mark.parametrize("name", SPECS)
def test_absorb_bytes_many_is_absorb_bytes_in_turn(name):
    """From each rate position and from squeeze mode, the same state as
    absorb_bytes of each chunk, in one crossing."""
    spec = getattr(FP, name.upper())
    rng = random.Random(7)
    chunks = [rng.randbytes(n) for n in (33, 0, 1, 31, 32, 62, 63, 200, 33)]
    for lead in range(4):  # 0, 1 or 2 rate slots taken, or squeezing
        a, b = tT.PoseidonSponge(spec), tT.PoseidonSponge(spec)
        for s in (a, b):
            if lead < 3:
                s.absorb_field(range(lead))
            else:
                s.squeeze_field(1)
        for data in chunks:
            a.absorb_bytes(data)
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            b.absorb_bytes_many(chunks)
        recs = trace.records()
        trace.reset()
        assert (a.state, a.pos, a.mode) == (b.state, b.pos, b.mode)
        assert [(r.name, r.counts["poseidon_native_calls"]) for r in recs] == [
            ("Transcript::absorb", 1)]
