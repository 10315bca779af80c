"""The metrics' arithmetic on synthetic inputs: the rate, the 90th
percentile, the busy union and idle gaps, the MSM yardstick."""

import statistics

import pytest

from port_bench import tracing, yardstick
from port_bench.metrics import device_idle_share, msm_roofline, prover_coeffs_per_s, request_ms_p90


def test_rate_counts_finished_requests_to_the_last_end():
    finished = [(10.5, 100), (11.0, 100), (12.0, 300)]
    assert prover_coeffs_per_s.rate(10.0, finished) == pytest.approx(500 / 2.0)
    assert prover_coeffs_per_s.rate(10.0, []) is None


def test_p90_is_statistics_inclusive_decile():
    lat = [float(v) for v in range(1, 101)]
    assert request_ms_p90.p90(lat) == pytest.approx(90.1)
    assert request_ms_p90.p90(lat) == statistics.quantiles(lat, n=10, method="inclusive")[8]
    assert request_ms_p90.p90([5.0]) is None


def test_union_merges_overlaps_and_gaps_fill_the_rest():
    busy, merged = tracing.union([(0, 10), (5, 12), (20, 25), (25, 30), (40, 41)])
    assert busy == 12 + 10 + 1
    assert merged == [[0, 12], [20, 30], [40, 41]]
    assert tracing.gaps(merged, -5, 50) == [(-5, 0), (12, 20), (30, 40), (41, 50)]


def test_idle_share_and_its_absence():
    assert device_idle_share.idle_percent(3.0, 4.0) == pytest.approx(25.0)
    assert device_idle_share.idle_percent(0.0, 4.0) is None


def test_gaps_labelled_by_innermost_host_event():
    host = [(0, 100, "pb::request"), (0, 40, "pb::commit"), (10, 20, "aten::copy_"),
            (50, 100, "pb::open")]
    idle = [(12, 18), (30, 38), (60, 70), (101, 105)]
    totals = tracing.label_gaps(idle, host)
    assert totals == {"pb::commit > aten::copy_": 6e-9, "pb::commit > host": 8e-9,
                      "pb::open > host": 10e-9, "outside spans > host": 4e-9}


def test_kernel_identifiers_and_the_msm_layer():
    g1_scan = ("void (anonymous namespace)::k_scan<(anonymous namespace)::Fp<12>, true>"
               "((anonymous namespace)::ScanArgs, long, int, (anonymous namespace)::FieldConsts)")
    g2_ec = "void (anonymous namespace)::k_ec<(anonymous namespace)::Fp2Pair<12>, 4>(EcArgs, long)"
    sort = "k_pass(int const*, int*, int, int)"
    other = "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<int> >(int)"
    assert tracing.identifier(g1_scan) == ("k_scan", "<Fp<12>, true>")
    assert tracing.identifier(other)[0] == "vectorized_elementwise_kernel"
    names = msm_roofline.kernel_names()
    assert {"k_ec", "k_scan", "k_pass", "k_upsweep"} <= names
    assert msm_roofline.is_msm_kernel(g1_scan, names)
    assert msm_roofline.is_msm_kernel(sort, names)
    assert not msm_roofline.is_msm_kernel(g2_ec, names)
    assert not msm_roofline.is_msm_kernel(other, names)


def test_msm_yardstick():
    # 12 x 12-word products a BLS12-381 madd, 16 windows of a 255-bit scalar
    assert yardstick.imad_per_madd("bls12_381") == 11 * (4 * 144 + 12)
    assert yardstick.imad_per_madd("bn254") == 11 * (4 * 64 + 8)
    assert yardstick.msm_pairs(1 << 20, "bls12_381") == 16 << 20
    peak = 132 * 64 * 1980e6
    pairs = 12 * (1 << 24)
    least = pairs * yardstick.imad_per_madd("bls12_381") / peak
    assert msm_roofline.roofline(pairs, yardstick.imad_per_madd("bls12_381"), peak,
                                 2 * least) == pytest.approx(50.0)
    assert msm_roofline.roofline(pairs, 1, None, 1.0) is None
    assert msm_roofline.roofline(pairs, 1, peak, 0.0) is None


def _proof9():
    import json
    from pathlib import Path

    from port_bench import inputs
    from port_bench.schemes import marlin_kzg10

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "configs/marlin_kzg10.bls12_381.d20.json").read_text())
    traffic = json.loads((root / "traffic/proof9.json").read_text())
    return cfg, inputs.plan(traffic, cfg, marlin_kzg10, 2**31 + 3, 0), marlin_kzg10


def test_proof9_shapes_follow_the_ahp():
    cfg, plan, _ = _proof9()
    h = 1 << 18
    sizes = {p.label: p.size for p in plan.polys()}
    assert sizes == {"w": h - 1, "z_a": h + 1, "z_b": h + 1, "mask_poly": 3 * h, "t": h,
                     "g_1": h - 1, "h_1": 2 * h, "g_2": h - 1, "h_2": 3 * h - 3}
    assert max(sizes.values()) - 1 == 3 * h - 1 <= cfg["srs_degree"] == (1 << 20) - 1
    assert {p.label for p in plan.polys() if p.hiding} == {"w", "z_a", "z_b", "g_1"}
    assert {p.label: p.degree_bound for p in plan.polys() if p.degree_bound} == {
        "g_1": h - 2, "g_2": h - 2}
    assert [(q, labels) for q, _, labels in plan.groups()] == [
        ("beta", ["g_1", "h_1", "mask_poly", "t", "w", "z_a", "z_b"]), ("gamma", ["g_2", "h_2"])]


def test_msm_roofline_counts_the_schemes_shapes():
    import types

    cfg, plan, scheme = _proof9()
    h = 1 << 18
    commits = sum(p.size for p in plan.polys()) + 2 * (h - 1) + 5 * 3  # 4 + shifted g_1 hide
    opens = (3 * h - 1) + 2 + (h - 2) + 2 + (3 * h - 4) + (h - 2)  # beta, its bound; gamma
    assert scheme.msm_points(cfg, plan) == commits + opens
    summary = types.SimpleNamespace(kernels={"k_pass(int const*, int*, int, int)": 2.0})
    ctx = types.SimpleNamespace(trace=summary, scheme=scheme, cfg=cfg, plan=plan,
                                requests=[types.SimpleNamespace(error=None)] * 3,
                                card={"imad_per_s": 132 * 64 * 1980e6})
    pairs = 3 * 16 * (commits + opens)
    assert msm_roofline.read(ctx) == pytest.approx(
        100 * pairs * yardstick.imad_per_madd("bls12_381") / ctx.card["imad_per_s"] / 2.0)
    ctx.scheme = types.SimpleNamespace()  # a scheme that runs no MSM
    assert msm_roofline.read(ctx) is None
