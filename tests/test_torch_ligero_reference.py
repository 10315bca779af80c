"""The multilinear Ligero reference's own parts (``port_bench/reference/
ligero_ml.py``): its NTT against a plain DFT, its Merkle tree against one
built by hand, its Montgomery reduction against Python ints, its sponge and
dimensions against the port's, and a check run in a process that loads
nothing of the port and no JAX."""

import contextlib
import json
import pickle
import random
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from hashlib import sha256  # noqa: E402

from poly_commit_tpu_torch.core import field_params as FP  # noqa: E402
from poly_commit_tpu_torch.core.transcript import PoseidonSponge  # noqa: E402
from poly_commit_tpu_torch.pcs.linear_codes import MultilinearLigeroBN254  # noqa: E402
from poly_commit_tpu_torch.pcs.linear_codes.utils import calculate_t  # noqa: E402
from port_bench import inputs  # noqa: E402
from port_bench.reference import ligero_ml as R  # noqa: E402
from port_bench.reference.curves import BN254  # noqa: E402
from port_bench.reference.poseidon import Sponge  # noqa: E402
from port_bench.schemes import ligero_ml as S  # noqa: E402
from tests import torch_trace_cells as cells  # noqa: E402

r = BN254.r
NV22 = json.loads((cells.REPO / "port_bench/configs/ligero_ml.bn254.nv22.json").read_text())


def test_ntt_is_the_dft():
    rng = random.Random(6)
    values = [rng.randrange(r) for _ in range(64)]
    w = R.root_of_unity(r, 64)
    assert pow(w, 32, r) == r - 1
    assert R.ntt(values, r) == [sum(v * pow(w, i * j, r) for j, v in enumerate(values)) % r
                                for i in range(64)]


def test_root_of_unity_is_the_ports():
    for log_n in (1, 6, 15, 28):
        w = pow(FP.FR_BN254.two_adic_root, 1 << (28 - log_n), r)
        assert R.root_of_unity(r, 1 << log_n) == w


def test_merkle_root_of_four_leaves():
    leaves = [bytes([i]) * 32 for i in range(4)]
    left, right = sha256(leaves[0] + leaves[1]).digest(), sha256(leaves[2] + leaves[3]).digest()
    levels = R.merkle_levels(leaves)
    assert levels[-1] == [sha256(left + right).digest()]
    assert R.siblings(levels, 2) == [leaves[3], left]
    with pytest.raises(ValueError):
        R.merkle_levels(leaves[:3])


def test_from_montgomery_is_x_over_r():
    rng = random.Random(7)
    big_r = 1 << (16 * BN254.limbs)
    xs = [0, 1, r - 1, r, r + 1, big_r - 1] + [rng.randrange(big_r) for _ in range(200)]
    limbs = torch.tensor([[(x >> (16 * k)) & 0xFFFF for k in range(BN254.limbs)] for x in xs],
                         dtype=torch.int32)
    got = R.to_ints(R.from_montgomery(limbs, r))
    assert got == [x * pow(big_r, -1, r) % r for x in xs]


def test_sponge_is_the_ports():
    mine, fast, port = Sponge(r), R.FastSponge(r), PoseidonSponge(FP.FR_BN254)
    for s in (mine, fast, port):
        s.absorb_bytes(b"root" * 8)
        s.absorb_field([5, r - 1, 7])
    assert mine.squeeze_field(3) == fast.squeeze_field(3) == port.squeeze_field(3)
    for n in (1, 2, 40):
        raw = fast.squeeze_bytes(n)
        assert raw == port.squeeze_bytes(n)
        fast.absorb_bytes(raw)
        port.absorb_bytes(raw)
    assert fast.state == port.state


@pytest.mark.parametrize("nv", [4, 8, 10, 16, 22])
def test_dimensions_are_the_ports(nv):
    cfg = {**NV22, "num_vars": nv}
    rows, cols, ext, t = R.dimensions(cfg, 1 << nv)
    ck, _ = MultilinearLigeroBN254.trim(MultilinearLigeroBN254.setup(0, num_vars=nv, device="cpu"))
    assert (rows, cols) == ck.compute_dimensions(1 << nv)
    assert ext == max(2, 1 << (cols * ck.rho_inv - 1).bit_length())
    assert t == calculate_t(ck.spec, ck.sec_param, ck.distance(), ext)
    if nv == 22:
        derived = NV22["derived"]
        assert (rows, cols, ext, t) == (derived["rows"], derived["columns"],
                                        derived["encoded_columns"], derived["t"])


def test_reference_loads_nothing_of_the_port(tmp_path):
    """A request's outputs, checked by the reference alone in a process
    that never imports the port."""
    cfg = cells.ADDED["configs/tiny_ligero.json"]
    traffic = json.loads((cells.REPO / "port_bench/traffic/commit_open.json").read_text())
    seed = 2**31 + 3
    ck = S.setup(cfg, None, seed, "cpu")
    plan = inputs.plan(traffic, cfg, S, seed, 0)
    outputs = S.request(ck, cfg, plan, seed, "cpu", lambda name: contextlib.nullcontext())
    dump = tmp_path / "request.pkl"
    dump.write_bytes(pickle.dumps((cfg, traffic, seed, plan, outputs)))
    code = f"""
import json, pickle, sys
sys.path.insert(0, {str(cells.REPO)!r})
from port_bench import harness
from port_bench.reference import ligero_ml
cfg, traffic, seed, plan, outputs = pickle.load(open({str(dump)!r}, "rb"))
result = ligero_ml.check(cfg, traffic, seed, plan, outputs, "cpu")
print(json.dumps([result, harness.check_modules(), "poly_commit_tpu_torch" in sys.modules]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    (wrong, checked), forbidden, port_loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert wrong == 0 and checked > 0
    assert forbidden == [] and port_loaded is False
