"""Linear-code PCS family: the generic engine, Ligero (Reed-Solomon) and
Brakedown (expander codes)."""

from ...core.field_params import FR_BLS12_381, FR_BN254
from .brakedown import make_multilinear_brakedown
from .engine import LinearCodePCS
from .ligero import make_multilinear_ligero, make_univariate_ligero

# default instantiations matching the reference's benches (BN254 Fr) and tests
UnivariateLigero = make_univariate_ligero(FR_BLS12_381)
MultilinearLigero = make_multilinear_ligero(FR_BLS12_381)
MultilinearBrakedown = make_multilinear_brakedown(FR_BN254)
UnivariateLigeroBN254 = make_univariate_ligero(FR_BN254)
MultilinearLigeroBN254 = make_multilinear_ligero(FR_BN254)

__all__ = ["LinearCodePCS", "UnivariateLigero", "MultilinearLigero", "MultilinearBrakedown",
           "UnivariateLigeroBN254", "MultilinearLigeroBN254", "make_univariate_ligero",
           "make_multilinear_ligero", "make_multilinear_brakedown"]
