"""In-circuit verification interface (the reference's R1CS gadget layer).

Counterpart of poly_commit_tpu/pcs/constraints.py, a copy: the module is
plain dataclasses and protocols. It re-designs the reference's
src/constraints.rs (feature `r1cs`): trait `PCCheckVar`
(constraints.rs:119-190) is an INTERFACE for verifying PC openings inside
an arithmetic circuit, beside the allocated-variable containers
(LinearCombinationVar :58-100, QuerySetVar :204, EvaluationsVar :213-234,
PCCheckRandomDataVar :104-115, PrepareGadget :40-43). No scheme in the
reference crate implements it; it exists for downstream SNARK recursion,
and like the reference no scheme of this package implements it either.
pcs/r1cs.py holds the constraint system and one concrete gadget.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Protocol, Tuple


@dataclasses.dataclass
class LinearCombinationCoeffVar:
    """constraints.rs:47-55: either the constant one or an allocated var."""

    is_one: bool = False
    var: Any = None


@dataclasses.dataclass
class LinearCombinationVar:
    """constraints.rs:58-100: label + (coeff, poly-label) terms."""

    label: str
    terms: List[Tuple[LinearCombinationCoeffVar, str]]


@dataclasses.dataclass
class PCCheckRandomDataVar:
    """constraints.rs:104-115: the opening/batching randomness, allocated."""

    opening_challenges: List[Any]
    opening_challenges_bits: List[List[Any]]
    batching_rands: List[Any]
    batching_rands_bits: List[List[Any]]


@dataclasses.dataclass
class LabeledPointVar:
    name: str
    value: Any


@dataclasses.dataclass
class QuerySetVar:
    """constraints.rs:204: {(poly_label, labeled_point)}."""

    entries: set


@dataclasses.dataclass
class EvaluationsVar:
    """constraints.rs:213-234: {(label, point_var) -> value_var}."""

    evals: dict

    def get_lc_eval(self, lc_label: str, point: Any):
        key = (lc_label, id(point))
        return self.evals.get(key)


class PrepareGadget(Protocol):
    """constraints.rs:40-43: prepare an allocated value for pairing use."""

    def prepare(self, unprepared: Any) -> Any: ...


class PCCheckVar(Protocol):
    """constraints.rs:119-190 — the scheme-generic in-circuit verifier.

    Implementations supply allocated variable types for verifier key,
    prepared verifier key, commitment, prepared commitment, linear
    combination, batch LC proof, and proof, then provide the two circuit
    builders below. The constraint system itself is the downstream SNARK's;
    this protocol only fixes the call shape (as the reference does).
    """

    def batch_check_evaluations(
        self,
        cs: Any,
        verification_key: Any,
        commitments: List[Any],
        query_set: QuerySetVar,
        evaluations: EvaluationsVar,
        proofs: List[Any],
        rand_data: PCCheckRandomDataVar,
    ) -> Any:
        """constraints.rs:154-162 — boolean variable asserting validity."""
        ...

    def prepared_check_combinations(
        self,
        cs: Any,
        prepared_verification_key: Any,
        linear_combinations: List[LinearCombinationVar],
        prepared_commitments: List[Any],
        query_set: QuerySetVar,
        evaluations: EvaluationsVar,
        proof: Any,
        rand_data: PCCheckRandomDataVar,
    ) -> Any:
        """constraints.rs:166-175."""
        ...
