"""Scoped phase timers: the reference's `print-trace` feature analogue.

Counterpart of poly_commit_tpu/utils/trace.py. The reference wraps every
phase in ark_std::{start_timer!, end_timer!} pairs compiled in under
feature "print-trace" (e.g. kzg10/mod.rs:61,165-208). Here the same tree of
labelled scopes is enabled with POLY_COMMIT_TRACE=1 and prints an indented
enter/leave log with wall-clock durations to stderr; each scope is also a
``torch.profiler.record_function`` span, so a profile of the run (CPU and
CUDA activities) carries the same labels.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

import torch

_DEPTH = 0


def enabled() -> bool:
    return os.environ.get("POLY_COMMIT_TRACE", "") not in ("", "0")


@contextlib.contextmanager
def scope(label: str):
    """Timer scope; no-op unless POLY_COMMIT_TRACE is set."""
    global _DEPTH
    if not enabled():
        yield
        return
    indent = "··" * _DEPTH
    print(f"{indent}Start: {label}", file=sys.stderr)
    _DEPTH += 1
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        _DEPTH -= 1
        dt = time.perf_counter() - t0
        print(f"{indent}End: {label} {dt*1e3:.3f}ms", file=sys.stderr)


def traced(label: str):
    """Decorator form of :func:`scope` for whole phases, the analogue of
    the reference's per-function start_timer!/end_timer! pairs. Place under
    @classmethod: ``@classmethod`` / ``@traced("X::commit")`` / ``def …``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with scope(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
