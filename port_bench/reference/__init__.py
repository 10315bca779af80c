"""The plain reference that decides ``correct``.

Plain Python integers, NumPy and PyTorch only: it imports neither JAX, the
JAX package, nor anything of ``poly_commit_tpu_torch``, and takes nothing the
port made. It regenerates each checked request's inputs from the seed
(``port_bench.inputs``), replays the seeded draws the port was handed
(``port_bench.seeds``), works out the KZG trapdoor and Hyrax's generators
again, and compares the port's outputs with what it computes, exactly.
``reference/<scheme>.py`` holds one scheme's ``check``.
"""
