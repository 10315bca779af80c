"""Public constants of the curves the benchmark's configurations use:
the scalar field r, the base field q, b of y^2 = x^3 + b, and the standard
G1 generator."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Curve:
    name: str
    r: int
    q: int
    b: int
    g1: tuple

    @property
    def limbs(self) -> int:
        """16-bit limbs of a scalar-field element."""
        return -(-self.r.bit_length() // 16)


BLS12_381 = Curve(
    name="bls12_381",
    r=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    q=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    b=4,
    g1=(3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569),
)

BN254 = Curve(
    name="bn254",
    r=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    q=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    b=3,
    g1=(1, 2),
)

CURVES = {c.name: c for c in (BLS12_381, BN254)}
