"""End-to-end drive of every scheme of the port through its public API.

    python -m poly_commit_tpu_torch.demo [name-filter ...] [--device cpu|cuda]

For each of the ten schemes: setup -> trim -> commit -> open -> check on one
small polynomial, plus one tamper probe (a corrupted value or proof must be
rejected). Prints ``OK <scheme>`` or ``FAIL <scheme> (check=..,
tamper-rejected=..)`` and one ``time <scheme> setup=.. commit=.. open=..
check=.. tamper=.. ms`` line per scheme, and exits nonzero on any failure.
A filter selects a scheme when it is a substring of one of the scheme's
words in ``SCHEMES`` (as in the reference demo; several filters are or-ed).

It is the counterpart of the JAX package's examples/demo_all_schemes.py:
the same drives, degrees, variable counts and HostRng seeds, so the port's
commitments and opened values equal the reference's. It runs on the card
(``device.resolve()``); ``--device cpu`` runs the kernels' plain versions.
Without a CUDA device and without ``--device cpu`` it raises. On the card
every kernel source is built first (``device.build()``); a build that
fails raises before any scheme runs. A scheme that raises (a kernel that
does not launch included) is reported as FAIL, its traceback on stderr;
only the scheme's own error type (``pcs.errors.PCError``) counts as a
tamper probe's rejection.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
import traceback
from typing import Any, Callable, Optional

import torch

from . import device as D
from .core import field as F
from .core import poly as P
from .core.transcript import PoseidonSponge
from .pcs import multilinear_pc as ML
from .pcs import streaming_kzg as SK
from .pcs.data_structures import HostRng, LabeledPolynomial
from .pcs.errors import PCError
from .pcs.hyrax import HyraxPC
from .pcs.ipa_pc import InnerProductArgPC
from .pcs.linear_codes import MultilinearBrakedown, MultilinearLigero, UnivariateLigero
from .pcs.marlin_pc import MarlinKZG10
from .pcs.pst13 import MarlinPST13, MVPoly
from .pcs.sonic_pc import SonicKZG10

PHASES = ("setup", "commit", "open", "check", "tamper")


@dataclasses.dataclass
class Result:
    """One drive's outcome; commitments and values are host objects (the
    scheme's commitment structs, the opened field ints)."""

    name: str
    ok: bool = False
    tamper_rejected: bool = False
    ms: dict = dataclasses.field(default_factory=dict)  # phase -> wall ms
    commitments: Any = None
    values: Any = None
    error: Optional[str] = None

    @property
    def passed(self) -> bool:
        return self.ok and self.tamper_rejected and self.error is None


class _Clock:
    """Wall ms per phase, the device synchronised at both ends."""

    def __init__(self, dev: torch.device, ms: dict):
        self.dev, self.ms = dev, ms

    def __call__(self, phase: str, fn: Callable):
        self._sync()
        t0 = time.perf_counter()
        out = fn()
        self._sync()
        self.ms[phase] = self.ms.get(phase, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def _rejects(check: Callable[[], bool]) -> bool:
    """A tamper probe: True when the check refuses (False, or the scheme's
    own error); any other exception propagates and fails the scheme."""
    try:
        return not check()
    except PCError:
        return True


def _bump(spec, values: dict) -> dict:
    return {k: (v + 1) % spec.modulus for k, v in values.items()}


def drive_univariate(PC, res: Result, dev, degree=8, max_degree=16, hiding=True,
                     enforced=None, bound=None):
    clock = _Clock(dev, res.ms)
    rng = HostRng(42)

    def setup():
        pp = PC.setup(max_degree, rng=rng, device=dev)
        return PC.trim(pp, degree, 2 if hiding else 0, enforced)

    ck, vk = clock("setup", setup)
    poly_degree = bound if bound is not None else degree
    lp = LabeledPolynomial(
        "p", F.from_ints(PC.spec, rng.field_ints(PC.spec, poly_degree + 1), device=dev),
        degree_bound=bound, hiding_bound=2 if hiding else None,
    )
    comms, states = clock("commit", lambda: PC.commit(ck, [lp], rng))
    point = rng.field_int(PC.spec)
    qs = {("p", ("pt", point))}
    sponge = PoseidonSponge(PC.spec)
    proofs, values = clock("open", lambda: PC.batch_open(ck, [lp], comms, qs, sponge, states, rng))
    res.commitments, res.values = comms, values
    res.ok = bool(clock("check", lambda: PC.batch_check(
        vk, comms, qs, values, proofs, PoseidonSponge(PC.spec))))
    bad = _bump(PC.spec, values)
    res.tamper_rejected = clock("tamper", lambda: _rejects(lambda: PC.batch_check(
        vk, comms, qs, bad, proofs, PoseidonSponge(PC.spec))))


def drive_multilinear(PC, res: Result, dev, nv=4):
    clock = _Clock(dev, res.ms)
    rng = HostRng(43)
    hyrax = res.name == "hyrax"

    def setup():
        pp = PC.setup(0, num_vars=nv, rng=rng, device=dev)
        return PC.trim(pp, 0, 0, None)

    ck, vk = clock("setup", setup)
    lp = LabeledPolynomial(
        "p", F.from_ints(PC.spec, rng.field_ints(PC.spec, 1 << nv), device=dev), num_vars=nv,
        hiding_bound=1 if hyrax else None,
    )
    comms, states = clock("commit", lambda: PC.commit(ck, [lp], rng))
    point = tuple(rng.field_int(PC.spec) for _ in range(nv))
    qs = {("p", ("pt", point))}
    sponge = PoseidonSponge(PC.spec)
    proofs, values = clock("open", lambda: PC.batch_open(ck, [lp], comms, qs, sponge, states, rng))
    res.commitments, res.values = comms, values
    res.ok = bool(clock("check", lambda: PC.batch_check(
        vk, comms, qs, values, proofs, PoseidonSponge(PC.spec))))
    if hyrax:
        # hyrax binds the eval inside the proof; tamper with z instead
        proofs[0][0].z[0] = (proofs[0][0].z[0] + 1) % PC.spec.modulus
        bad = values
    else:
        bad = _bump(PC.spec, values)
    res.tamper_rejected = clock("tamper", lambda: _rejects(lambda: PC.batch_check(
        vk, comms, qs, bad, proofs, PoseidonSponge(PC.spec))))


def drive_multilinear_pc(res: Result, dev):
    SPEC = ML.SPEC
    clock = _Clock(dev, res.ms)
    rng = HostRng(44)
    nv = 3
    ck, vk = clock("setup", lambda: ML.trim(ML.setup(nv, rng, device=dev), nv))
    table = F.from_ints(SPEC, rng.field_ints(SPEC, 1 << nv), device=dev)
    point = [rng.field_int(SPEC) for _ in range(nv)]
    comm = clock("commit", lambda: ML.commit(ck, table))
    proof = clock("open", lambda: ML.open(ck, table, point))
    pt = F.from_ints(SPEC, [z % SPEC.modulus for z in point], device=dev)
    value = int(F.to_ints(SPEC, P.mle_evaluate(SPEC, table, pt)))
    res.commitments, res.values = comm, value
    res.ok = bool(clock("check", lambda: ML.check(vk, comm, point, value, proof)))
    res.tamper_rejected = clock("tamper", lambda: _rejects(
        lambda: ML.check(vk, comm, point, (value + 1) % SPEC.modulus, proof)))


def drive_pst13(res: Result, dev):
    PC = MarlinPST13
    clock = _Clock(dev, res.ms)
    rng = HostRng(45)
    nv, deg = 2, 2
    ck, vk = clock("setup", lambda: PC.trim(PC.setup(deg, num_vars=nv, rng=rng, device=dev), deg, 1))
    lp = LabeledPolynomial("p", MVPoly.rand(rng, nv, deg, 6), hiding_bound=1, num_vars=nv)
    comms, states = clock("commit", lambda: PC.commit(ck, [lp], rng))
    point = tuple(rng.field_int(PC.spec) for _ in range(nv))
    qs = {("p", ("pt", point))}
    sponge = PoseidonSponge(PC.spec)
    proofs, values = clock("open", lambda: PC.batch_open(ck, [lp], comms, qs, sponge, states, rng))
    res.commitments, res.values = comms, values
    res.ok = bool(clock("check", lambda: PC.batch_check(
        vk, comms, qs, values, proofs, PoseidonSponge(PC.spec))))
    bad = _bump(PC.spec, values)
    res.tamper_rejected = clock("tamper", lambda: _rejects(lambda: PC.batch_check(
        vk, comms, qs, bad, proofs, PoseidonSponge(PC.spec))))


def drive_streaming_kzg(res: Result, dev):
    SPEC = SK.SPEC
    clock = _Clock(dev, res.ms)
    rng = HostRng(46)
    ck = clock("setup", lambda: SK.CommitterKey.new(7, 2, rng, device=dev))
    vk = ck.verifier_key()
    f = F.from_ints(SPEC, rng.field_ints(SPEC, 8), device=dev)
    comm, chunked = clock("commit", lambda: (ck.commit(f), ck.commit_chunked(f, 4)))
    z = rng.field_int(SPEC)
    ev, proof = clock("open", lambda: ck.open(f, z))
    res.commitments, res.values = comm, ev
    res.ok = bool(clock("check", lambda: SK.verify(vk, comm, z, ev, proof))) \
        and comm.point == chunked.point
    res.tamper_rejected = clock("tamper", lambda: _rejects(
        lambda: SK.verify(vk, comm, z, (ev + 1) % SPEC.modulus, proof)))


# (scheme name, the filter words that select it, its drive), in the
# reference demo's order
SCHEMES = (
    ("marlin_kzg10", ("marlin",),
     lambda res, dev: drive_univariate(MarlinKZG10, res, dev, enforced=[6], bound=6)),
    ("sonic_kzg10", ("sonic",),
     lambda res, dev: drive_univariate(SonicKZG10, res, dev, enforced=[6], bound=6)),
    ("ipa_pc", ("ipa",),
     lambda res, dev: drive_univariate(InnerProductArgPC, res, dev, degree=7, max_degree=7)),
    ("univariate_ligero", ("ligero_uni", "univariate_ligero"),
     lambda res, dev: drive_univariate(UnivariateLigero, res, dev, degree=15, max_degree=15,
                                       hiding=False)),
    ("multilinear_ligero", ("ligero_ml", "multilinear_ligero"),
     lambda res, dev: drive_multilinear(MultilinearLigero, res, dev)),
    ("brakedown", ("brakedown",), lambda res, dev: drive_multilinear(MultilinearBrakedown, res, dev)),
    ("hyrax", ("hyrax",), lambda res, dev: drive_multilinear(HyraxPC, res, dev)),
    ("multilinear_pc", ("multilinear_pc", "xzzpd"), drive_multilinear_pc),
    ("pst13", ("pst13",), drive_pst13),
    ("streaming_kzg", ("streaming",), drive_streaming_kzg),
)
NAMES = tuple(name for name, _, _ in SCHEMES)


def selected(filters) -> list:
    """The scheme names a filter list selects: a filter selects a scheme when
    it is a substring of one of the scheme's words (all of them when none)."""
    filters = [f.lower() for f in filters]
    return [name for name, words, _ in SCHEMES
            if not filters or any(f in w for f in filters for w in words)]


def check_device(device=None) -> torch.device:
    """The device the demo runs on; raises when it is cuda and there is none."""
    dev = D.resolve(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port's kernels need one "
                           "(--device cpu runs their plain versions)")
    return dev


def run_scheme(name: str, device=None) -> Result:
    """One scheme's drive; an exception is kept in ``error`` (the scheme fails)."""
    dev = check_device(device)
    drive = {n: d for n, _, d in SCHEMES}[name]
    res = Result(name)
    try:
        drive(res, dev)
    except Exception:  # the scheme fails; the others still run
        res.error = traceback.format_exc()
    return res


def report(res: Result, out=None) -> None:
    out = out or sys.stdout
    if res.passed:
        print(f"OK {res.name}", file=out)
    else:
        print(f"FAIL {res.name} (check={res.ok}, tamper-rejected={res.tamper_rejected})", file=out)
        if res.error:
            print(res.error, file=sys.stderr)
    times = " ".join(f"{p}={res.ms[p]:.3f}" for p in PHASES if p in res.ms)
    print(f"time {res.name} {times} ms", file=out, flush=True)


def run(filters=(), device=None, out=None) -> list:
    """Every selected scheme in turn, each reported as it ends; on the card
    the kernels are built first, all sources at once."""
    dev = check_device(device)
    out = out or sys.stdout
    if dev.type == "cuda":
        t0 = time.perf_counter()
        D.build()
        print(f"build {time.perf_counter() - t0:.3f} s", file=out, flush=True)
    results = []
    for name in selected(filters):
        res = run_scheme(name, dev)
        report(res, out)
        results.append(res)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m poly_commit_tpu_torch.demo",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("filters", nargs="*", help="scheme-name substrings (all schemes when none)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default=None,
                    help="cuda by default; cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    results = run(args.filters, args.device)
    failed = [r.name for r in results if not r.passed]
    if failed:
        print("FAILED:", failed)
        return 1
    print("all driven schemes OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
