"""State carried across from the JAX package.

``params_from_jax`` takes the fields of a poly_commit_tpu
``kzg10.UniversalParams`` as numpy arrays (the caller runs ``np.asarray`` on
the JAX side; this module imports nothing of that package) and returns the
port's ``UniversalParams``. Both packages keep G1 coordinates as 16-bit
Montgomery limbs with the same R, so the G1 powers carry over bit for bit;
the G2 points h and beta_h become host int triples, and SonicKZG10's G2
powers keep their limbs. With it, both packages commit against the very
same SRS.

``ligero_params_from_jax`` and ``lincode_state_from_jax`` carry Ligero
parameters and a commitment's prover state across (read by attribute), so
the port can open what the JAX package committed.
``multilinear_params_from_jax``, ``ipa_params_from_jax`` and
``hyrax_params_from_jax`` do the same for MultilinearPC's, IPA-PC's and
Hyrax's universal parameters: device points keep their limbs (G2 as
(N, 2, L) pairs), host points stay host ints. ``brakedown_params_from_jax``
carries Brakedown's parameters with their sparse matrices, as row indices
and value ints. ``pst13_params_from_jax`` and ``streaming_key_from_jax``
carry MarlinPST13's universal parameters (the G1 powers over every
monomial with their limbs; the term index, gamma powers and G2 points as
host values) and a streaming KZG committer key (G1 powers with their
limbs, G2 powers as host triples).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as D
from ..core import ff
from ..core import field_params as FP
from . import hyrax, ipa_pc, kzg10, multilinear_pc, pst13, streaming_kzg
from .curve_ctx import CTX_BLS12_381, CurveCtx
from .linear_codes.brakedown import BrakedownPCParams, SparseMat
from .linear_codes.engine import LinCodePCCommitmentState
from .linear_codes.ligero import LigeroPCParams


def _affine(t, device):
    """A device affine batch (x, y, inf) from any arrays numpy reads
    (uint32 Montgomery limbs, G2 as (N, 2, L)) -> int32 tensors."""
    x, y, inf = (np.asarray(a) for a in t)

    def limbs(a):
        return torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(device)

    return limbs(x), limbs(y), torch.from_numpy(inf.astype(bool)).to(device)


def _g2(t, ctx: CurveCtx):
    x, y, inf = (np.asarray(a) for a in t)
    spec = ctx.g1.spec  # G2 coordinates live in Fq2 over the same Fq
    xs = ff.limbs_to_ints(spec, x.reshape(2, spec.n_limbs))
    ys = ff.limbs_to_ints(spec, y.reshape(2, spec.n_limbs))
    return (tuple(xs), tuple(ys), bool(inf))


def params_from_jax(d: dict, ctx: CurveCtx = CTX_BLS12_381, device=None) -> kzg10.UniversalParams:
    """d: {"powers_of_g", "powers_of_gamma_g": (x (N, L), y (N, L), inf (N,)),
    "h", "beta_h": (x (2, L), y (2, L), inf ()), "max_degree": int}, and
    optionally SonicKZG10's "neg_powers_of_h": (x (N, 2, L), y (N, 2, L),
    inf (N,)), the arrays in the JAX package's layout (uint32 Montgomery
    limbs)."""
    dev = D.resolve(device)
    neg = d.get("neg_powers_of_h")
    return kzg10.UniversalParams(
        powers_of_g=_affine(d["powers_of_g"], dev),
        powers_of_gamma_g=_affine(d["powers_of_gamma_g"], dev),
        h=_g2(d["h"], ctx),
        beta_h=_g2(d["beta_h"], ctx),
        neg_powers_of_h=None if neg is None else _affine(neg, dev),
        max_degree=int(d["max_degree"]),
    )


_SPECS = {s.name: s for s in (FP.FR_BLS12_381, FP.FR_BN254)}  # Ligero's fields


def ligero_params_from_jax(p, device=None) -> LigeroPCParams:
    """A JAX ``LigeroPCParams`` (read by attribute) -> the port's, whose
    ``check`` re-encodes on ``device``. The field spec is matched by name."""
    return LigeroPCParams(spec=_SPECS[p.spec.name], sec_param=int(p.sec_param),
                          rho_inv=int(p.rho_inv),
                          check_well_formedness=bool(p.check_well_formedness),
                          device=None if device is None else str(device))


def lincode_state_from_jax(st, device=None) -> LinCodePCCommitmentState:
    """A JAX ``LinCodePCCommitmentState`` -> the port's on ``device``: its
    ``mat`` and ``ext_mat`` (uint32 Montgomery limbs, field-last, any
    array that numpy reads) become int32 tensors with the same limbs, and
    the column hashes carry over."""
    dev = D.resolve(device)

    def limbs(a):
        return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)

    return LinCodePCCommitmentState(mat=limbs(st.mat), ext_mat=limbs(st.ext_mat),
                                    leaves=[bytes(leaf) for leaf in st.leaves])


def _host(t):
    """A host triple with numpy scalars -> Python ints and bool."""
    def conv(v):
        return tuple(int(c) for c in v) if isinstance(v, (tuple, list)) else int(v)

    return (conv(t[0]), conv(t[1]), bool(t[2]))


def multilinear_params_from_jax(pp, device=None) -> multilinear_pc.UniversalParams:
    """A JAX MultilinearPC ``UniversalParams`` (read by attribute) -> the
    port's: per-level G1 and G2 powers as device tensors with the same
    limbs, g, h and g_mask as host triples."""
    dev = D.resolve(device)
    return multilinear_pc.UniversalParams(
        num_vars=int(pp.num_vars), g=_host(pp.g), h=_host(pp.h),
        g_mask=[_host(t) for t in pp.g_mask],
        powers_of_g=[_affine(t, dev) for t in pp.powers_of_g],
        powers_of_h=[_affine(t, dev) for t in pp.powers_of_h])


def ipa_params_from_jax(pp, device=None) -> ipa_pc.UniversalParams:
    """A JAX IPA-PC ``UniversalParams`` (read by attribute) -> the port's:
    the Pedersen key on the device, h and s as host points."""
    def pt(v):
        return (int(v[0]), int(v[1]))

    return ipa_pc.UniversalParams(comm_key=_affine(pp.comm_key, D.resolve(device)),
                                  h=pt(pp.h), s=pt(pp.s), max_degree=int(pp.max_degree))


def hyrax_params_from_jax(pp, device=None) -> hyrax.UniversalParams:
    """A JAX Hyrax ``UniversalParams`` (read by attribute) -> the port's:
    the Pedersen key on the device with the same limbs, h and the key's
    host points as ints."""
    def pt(v):
        return (int(v[0]), int(v[1]))

    return hyrax.UniversalParams(com_key=_affine(pp.com_key, D.resolve(device)), h=pt(pp.h),
                                 com_key_host=[pt(v) for v in pp.com_key_host])


def brakedown_params_from_jax(p, device=None) -> BrakedownPCParams:
    """A JAX ``BrakedownPCParams`` (read by attribute) -> the port's, whose
    matrices live on ``device`` and whose ``check`` re-encodes there. Each
    sparse matrix carries over as its row indices and its values' ints."""
    dev = D.resolve(device)
    spec = _SPECS[p.spec.name]

    def mat(a) -> SparseMat:
        idx = np.asarray(a.row_idx).astype(np.int64)
        vals = ff.limbs_to_ints(spec, np.asarray(a.val).reshape(-1, spec.n_limbs))
        val = ff.ints_to_limbs(spec, vals).astype(np.int32).reshape(idx.shape + (spec.n_limbs,))
        return SparseMat(n=int(a.n), m=int(a.m), row_idx=torch.from_numpy(idx).to(dev),
                         val=torch.from_numpy(val).to(dev))

    return BrakedownPCParams(
        spec=spec, sec_param=int(p.sec_param), alpha=tuple(p.alpha), beta=tuple(p.beta),
        rho_inv=tuple(p.rho_inv), base_len=int(p.base_len), n=int(p.n), m=int(p.m),
        m_ext=int(p.m_ext), a_dims=[tuple(d) for d in p.a_dims], b_dims=[tuple(d) for d in p.b_dims],
        start=list(p.start), end=list(p.end), a_mats=[mat(a) for a in p.a_mats],
        b_mats=[mat(b) for b in p.b_mats], check_well_formedness=bool(p.check_well_formedness),
        device=None if device is None else str(device))


def pst13_params_from_jax(pp, device=None) -> pst13.UniversalParams:
    """A JAX MarlinPST13 ``UniversalParams`` (read by attribute) -> the
    port's: ``powers_of_g`` on the device with the same limbs; the term
    index, gamma_g, the gamma powers, h and beta_h as host values."""
    return pst13.UniversalParams(
        num_vars=int(pp.num_vars), max_degree=int(pp.max_degree),
        term_index={tuple(int(e) for e in t): int(i) for t, i in pp.term_index.items()},
        powers_of_g=_affine(pp.powers_of_g, D.resolve(device)), gamma_g=_host(pp.gamma_g),
        powers_of_gamma_g=[[_host(t) for t in row] for row in pp.powers_of_gamma_g],
        h=_host(pp.h), beta_h=[_host(t) for t in pp.beta_h])


def streaming_key_from_jax(ck, device=None) -> streaming_kzg.CommitterKey:
    """A JAX streaming KZG ``CommitterKey`` (read by attribute) -> the
    port's: the G1 powers on the device with the same limbs, the G2 powers
    as host triples."""
    return streaming_kzg.CommitterKey(powers_of_g=_affine(ck.powers_of_g, D.resolve(device)),
                                      powers_of_g2=[_host(t) for t in ck.powers_of_g2])
