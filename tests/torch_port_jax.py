"""A pytest plugin that the port's test files load (``pytest_plugins``):
between two test files, it drops JAX's compiled executables once the
process holds many memory mappings.

Every executable JAX loads keeps its code mapped, and an xdist worker runs
many files in turn without releasing them: ``test_ipa_pc.py`` leaves
~38,000 mappings, ``test_mesh.py`` ~35,000, ``test_torch_ipa.py`` ~25,000.
A process past the kernel's default limit of 65,530 segfaults in its next
large compile or cache load; ``test_pairing.py``'s pairing alone takes
~18,000, and xdist's master then waits for the dead worker until the run's
time limit. Clearing at ``CLEAR_ABOVE`` leaves room for the largest file.
Later files reload what they need from the persistent compile cache.
"""

import gc

CLEAR_ABOVE = 20_000  # mappings; the largest single file adds ~38,000


def _mappings() -> int:
    try:
        with open("/proc/self/maps") as fh:
            return sum(1 for _ in fh)
    except OSError:  # no procfs: nothing to measure
        return 0


def pytest_runtest_teardown(item, nextitem):
    if nextitem is not None and nextitem.path == item.path:
        return
    if _mappings() > CLEAR_ABOVE:
        import jax

        jax.clear_caches()
        gc.collect()
