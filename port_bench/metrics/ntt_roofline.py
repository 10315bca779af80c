"""ntt_roofline: the least time of the window's NTT butterflies over the
device time of the NTT kernels, in percent.

The least time: rows x 2^(log_n - 1) x log_n butterflies for each batch of
transforms (``schemes/<scheme>.py``'s ``ntt_shapes``: (rows, log_n) pairs;
a scheme without it runs no NTT, and the metric is left out) of every
request the traced window ran, each butterfly one Montgomery product of
4 W^2 + W IMADs in the scalar field (W 32-bit words; the add and subtract
are not counted), over the card's IMAD peak (``yardstick.py``). The kernel
time: every device activity of a kernel that ``csrc/ntt.cu`` defines (K4a,
K4b, K4c), read from the port's source as ``msm_roofline`` reads its own.
"""

import functools
import importlib.util
from pathlib import Path

from port_bench import tracing, yardstick
from port_bench.metrics.msm_roofline import _GLOBAL, roofline
from port_bench.reference.curves import CURVES

SOURCE = "ntt.cu"


@functools.lru_cache(maxsize=1)
def kernel_names() -> frozenset:
    """The kernels ``csrc/ntt.cu`` defines, read from the port's csrc."""
    csrc = Path(importlib.util.find_spec("poly_commit_tpu_torch").origin).parent / "csrc"
    path = csrc / SOURCE
    return frozenset(_GLOBAL.findall(path.read_text())) if path.exists() else frozenset()


def butterflies(shapes) -> int:
    """Radix-2 butterflies of the (rows, log_n) batches of transforms."""
    return sum(rows * (1 << (log_n - 1)) * log_n for rows, log_n in shapes)


def imad_per_butterfly(curve: str) -> int:
    return yardstick.imad_per_product(-(-CURVES[curve].r.bit_length() // 32))


def read(ctx):
    ntt_shapes = getattr(ctx.scheme, "ntt_shapes", None)
    if ctx.trace is None or ntt_shapes is None:
        return None
    names = kernel_names()
    kernel_s = sum(s for name, s in ctx.trace.kernels.items()
                   if tracing.identifier(name)[0] in names)
    done = len([r for r in ctx.requests if r.error is None])
    return roofline(butterflies(ntt_shapes(ctx.cfg, ctx.plan)) * done,
                    imad_per_butterfly(ctx.cfg["curve"]), ctx.card["imad_per_s"], kernel_s)
