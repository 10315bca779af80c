"""poly_commit_tpu_torch: the PyTorch/CUDA port of poly_commit_tpu.

The same polynomial-commitment library, written in PyTorch for one NVIDIA
Hopper GPU (sm_90a). Every Pallas kernel of the JAX package that a ported
path runs is a CUDA C++ kernel here (``csrc/``), built at first use with
nvcc and bound through ctypes; each kernel's wrapper keeps a plain PyTorch
version beside it, which runs only for tensors on the CPU (the tests).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The package imports neither JAX nor anything of ``poly_commit_tpu``; the
host modules it needs (field parameters, host curve groups, pairing
engines, errors) are its own copies.

Ported so far (see ROADMAP.md):
  pcs.kzg10, pcs.marlin_pc  — MarlinKZG10 over BLS12-381 and BLS12-377
  pcs.sonic_pc              — SonicKZG10 over BLS12-381 and BLS12-377 (its
                              G2 powers on the device)
  pcs.ark_interop           — the arkworks golden transcripts (MarlinKZG10,
                              bounded and hiding, SonicKZG10), with
                              core.ark_compat (arkworks' test RNG, sampling
                              and Poseidon test sponge) and the arkworks and
                              zcash point codecs of core.serialize
  pcs.linear_codes          — Ligero, univariate and multilinear, over the
                              BLS12-381 and BN254 scalar fields, and
                              MultilinearBrakedown over BN254
  pcs.multilinear_pc        — MultilinearPC over BLS12-381 (G1 and G2)
  pcs.ipa_pc                — InnerProductArgPC over JubJub
  pcs.hyrax                 — Hyrax over BN254
  pcs.pst13                 — MarlinPST13 over BLS12-381 and BLS12-377
  pcs.streaming_kzg         — streaming KZG (Gemini): time and space provers
  parallel.mesh             — meshes of torch.distributed ranks, the sharded
                              MSM, NTT and batch operations, and the schemes'
                              mesh branches under ``use_mesh``;
                              parallel.launch starts local ranks
  core.msm_gpu              — Pippenger MSM (G1, G2, JubJub) and fixed-base
                              multiplication (G1, G2)
  core.extfield             — Fq2 on the port's tensors
  core.ntt / core.ntt_lf    — the radix-2 NTT, portable and limbs-first
  core.ff / core.ec_lf / core.sort_gpu / core.ntt_lf — the kernels K1, K2a
                              (G1), K2c (G2), K2b (JubJub), K3 and
                              K4a/K4b/K4c
"""

__version__ = "0.1.0"
