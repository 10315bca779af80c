"""Pairing-curve context: what a KZG-family scheme needs to run over one
(G1, G2, e) instantiation.

Counterpart of poly_commit_tpu/pcs/curve_ctx.py. The reference instantiates
every pairing scheme over BLS12-377 and BLS12-381 through generics over
`Pairing` (marlin_pc/mod.rs:531-815); here a small context object carries
the device G1 group, the G2 group, the scalar field, host mirrors
and the pairing backends. The pairing runs on the host engines unless
POLY_COMMIT_PAIRING=device (``pairing_backend``) sends a curve with a
device pairing (BLS12-381, core/pairing.py) to the device, as the JAX
package dispatches.
"""

from __future__ import annotations

import dataclasses
import functools
import os

from ..core import curve as C
from ..core import field_params as FP
from ..core import hostec
from ..core import pairing as PR
from ..core.field_params import FieldSpec


def pairing_backend() -> str:
    """'device' (core/pairing.py) or 'host' (core/host_pairing.py and
    core/pairing_generic.py): POLY_COMMIT_PAIRING={host,device}, else
    'host', as the JAX package chooses off the TPU. The pairing is O(1) a
    check and bound by latency; the host engines are the faster."""
    env = os.environ.get("POLY_COMMIT_PAIRING")
    return env if env in ("host", "device") else "host"


@dataclasses.dataclass(frozen=True)
class CurveCtx:
    name: str
    g1: C.WeierstrassGroup  # device group
    g2: C.G2Group  # its generator; Marlin keeps h and beta_h on the host
    spec: FieldSpec  # scalar field Fr
    device_pairing_ok: bool  # core/pairing.py exists for this curve

    @functools.cached_property
    def hg1(self):
        return hostec.host_group(self.g1)

    @functools.cached_property
    def hg2(self):
        return hostec.host_group(self.g2)

    @functools.cached_property
    def engine(self):
        """Generic host pairing engine (core/pairing_generic.py)."""
        from ..core import pairing_generic as PG

        return PG.bls12_381() if self.name == "bls12_381" else PG.bls12_377()

    def pairing_product_is_one(self, g1_triples, g2_triples, prepared=None, device=None) -> bool:
        """prod e(P_i, Q_i) == 1 from host int triples; dispatches between
        the device pairing (BLS12-381 under POLY_COMMIT_PAIRING=device, on
        ``device``, cuda unless the caller asks otherwise) and the host
        engines.

        prepared: optional list parallel to g2_triples of
        ``engine.prepare_g2`` outputs (the PreparedVerifierKey analogue,
        kzg10/data_structures.rs:285-312); used on the host engines."""
        if self.device_pairing_ok and pairing_backend() == "device":
            p_aff = C.affine_from_ints(self.g1, g1_triples, device)
            q_aff = C.affine_from_ints(self.g2, g2_triples, device)
            return bool(PR.pairing_check(p_aff, q_aff))
        if self.name == "bls12_381" and prepared is None:
            from ..core import host_pairing as HP

            return HP.pairing_product_is_one(g1_triples, g2_triples)
        return self.engine.pairing_product_is_one(g1_triples, g2_triples, prepared)

    def prepare_g2(self, q_triple):
        """Host-engine G2 line-coefficient precomputation."""
        return self.engine.prepare_g2(q_triple)


CTX_BLS12_381 = CurveCtx(
    name="bls12_381",
    g1=C.BLS12_381_G1,
    g2=C.BLS12_381_G2,
    spec=FP.FR_BLS12_381,
    device_pairing_ok=True,
)

CTX_BLS12_377 = CurveCtx(
    name="bls12_377",
    g1=C.BLS12_377_G1,
    g2=C.BLS12_377_G2,
    spec=FP.FR_BLS12_377,
    device_pairing_ok=False,
)
