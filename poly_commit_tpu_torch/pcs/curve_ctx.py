"""Pairing-curve context: what a KZG-family scheme needs to run over one
(G1, G2, e) instantiation.

Counterpart of poly_commit_tpu/pcs/curve_ctx.py. The reference instantiates
every pairing scheme over BLS12-377 and BLS12-381 through generics over
`Pairing` (marlin_pc/mod.rs:531-815); here a small context object carries
the device G1 group, the G2 group, the scalar field, host mirrors
and the host pairing engines. The pairing runs on the host, as it does in
the JAX package off the TPU.
"""

from __future__ import annotations

import dataclasses
import functools

from ..core import curve as C
from ..core import field_params as FP
from ..core import hostec
from ..core.field_params import FieldSpec


@dataclasses.dataclass(frozen=True)
class CurveCtx:
    name: str
    g1: C.WeierstrassGroup  # device group
    g2: C.G2Group  # its generator; Marlin keeps h and beta_h on the host
    spec: FieldSpec  # scalar field Fr

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

    def pairing_product_is_one(self, g1_triples, g2_triples, prepared=None) -> bool:
        """prod e(P_i, Q_i) == 1 from host int triples.

        prepared: optional list parallel to g2_triples of
        ``engine.prepare_g2`` outputs (the PreparedVerifierKey analogue,
        kzg10/data_structures.rs:285-312)."""
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
)

CTX_BLS12_377 = CurveCtx(
    name="bls12_377",
    g1=C.BLS12_377_G1,
    g2=C.BLS12_377_G2,
    spec=FP.FR_BLS12_377,
)
