"""msm_roofline: the least time of the window's MSM bucket work over the
device time of the MSM layer's kernels, in percent.

The least time: one mixed addition for each (point, 16-bit window) pair of
every MSM of the requests the traced window ran (counted from the
traffic's shapes by ``schemes/<scheme>.py``'s ``msm_points``; a scheme
without it runs no MSM, and the metric is left out), at the IMADs of one
mixed addition in the curve's base field, over the card's IMAD peak
(``yardstick.py``). It does not change with the window width the port
chooses. The kernel time: every device activity of a kernel that
``csrc/ec_g1.cu`` (with the headers it includes, in a G1 instantiation) or
``csrc/digit_sort.cu`` defines.
"""

import functools
import importlib.util
import re
from pathlib import Path

from port_bench import tracing, yardstick

SOURCES = ("ec_g1.cu", "digit_sort.cu")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')


@functools.lru_cache(maxsize=1)
def kernel_names() -> frozenset:
    """The kernels the sources define, read from the port's csrc."""
    csrc = Path(importlib.util.find_spec("poly_commit_tpu_torch").origin).parent / "csrc"
    names, seen, todo = set(), set(), list(SOURCES)
    while todo:
        f = todo.pop()
        if f in seen or not (csrc / f).exists():
            continue
        seen.add(f)
        text = (csrc / f).read_text()
        names.update(_GLOBAL.findall(text))
        todo += _INCLUDE.findall(text)
    return frozenset(names)


def is_msm_kernel(name: str, names) -> bool:
    base, template = tracing.identifier(name)
    return base in names and "Fp2" not in template


def roofline(pairs, imad_per_madd, imad_per_s, kernel_s):
    if not pairs or not imad_per_s or kernel_s <= 0:
        return None
    return 100.0 * pairs * imad_per_madd / imad_per_s / kernel_s


def read(ctx):
    msm_points = getattr(ctx.scheme, "msm_points", None)
    if ctx.trace is None or msm_points is None:
        return None
    names = kernel_names()
    kernel_s = sum(s for name, s in ctx.trace.kernels.items() if is_msm_kernel(name, names))
    done = len([r for r in ctx.requests if r.error is None])
    pairs = yardstick.msm_pairs(msm_points(ctx.cfg, ctx.plan), ctx.cfg["curve"]) * done
    return roofline(pairs, yardstick.imad_per_madd(ctx.cfg["curve"]), ctx.card["imad_per_s"],
                    kernel_s)
