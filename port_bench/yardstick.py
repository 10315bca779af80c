"""The fixed yardsticks of the benchmark: the card's integer-multiply peak
read from the card, and the least multiply work of an MSM's bucket
accumulation counted from the shapes of the traffic.

An MSM of N points with b-bit scalars adds each point into one bucket per
16-bit window: N ceil(b / 16) mixed additions (madd-2007-bl: 7
multiplications and 4 squarings in the base field), each product a CIOS
Montgomery product of 4 W^2 + W 32-bit multiply-adds for W words. The
card's peak is its SMs x 64 IMADs a clock (compute capability 9.0) x the
highest SM clock it reports.
"""

from __future__ import annotations

import subprocess

from .reference.curves import CURVES

IMAD_PER_SM_PER_CLK = 64
WINDOW_BITS = 16
MADD_PRODUCTS = 11


def imad_per_product(words: int) -> int:
    return 4 * words * words + words


def imad_per_madd(curve: str) -> int:
    words = -(-CURVES[curve].q.bit_length() // 32)
    return MADD_PRODUCTS * imad_per_product(words)


def msm_pairs(points: int, curve: str) -> int:
    """(point, 16-bit window) pairs of MSMs over ``points`` bases in all."""
    return points * -(-CURVES[curve].r.bit_length() // WINDOW_BITS)


def card(torch) -> dict:
    """The first CUDA card: name, SMs, power limit and highest SM clock
    (``nvidia-smi``), and its IMAD peak a second."""
    props = torch.cuda.get_device_properties(0)
    info = {"name": torch.cuda.get_device_name(0), "sms": props.multi_processor_count,
            "power_limit_w": None, "max_sm_clock_mhz": None, "imad_per_s": None}
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=power.limit,clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True, text=True,
                             check=True, timeout=30).stdout.strip().splitlines()[0]
        power, clock = (v.strip() for v in out.split(","))
        info["power_limit_w"] = float(power)
        info["max_sm_clock_mhz"] = float(clock)
        info["imad_per_s"] = info["sms"] * IMAD_PER_SM_PER_CLK * info["max_sm_clock_mhz"] * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        pass
    return info
