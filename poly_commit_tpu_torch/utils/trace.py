"""Named scopes and counters: the reference's `print-trace` analogue, and
the port's spans on the profiler's clock.

Counterpart of poly_commit_tpu/utils/trace.py. The reference wraps every
phase in ark_std::{start_timer!, end_timer!} pairs compiled in under
feature "print-trace" (e.g. kzg10/mod.rs:61,165-208). A scope here has two
switches:

* **The stderr log**, ``POLY_COMMIT_TRACE=1``: the scheme-level scopes
  (``scope``, ``@traced``) print an indented enter/leave log with
  wall-clock durations to stderr. Quiet scopes (``log=False``: the finer
  ones inside the MSM, the polynomial ops, the transcript and the
  device-to-host reads) never print.
* **Recording**, on while a ``torch.profiler`` profile runs: every scope
  enters ``torch.profiler.record_function(label)``, so it shows in the
  profile (``export_chrome_trace``, ``key_averages``) beside the kernels it
  launches, and keeps a :class:`Record` in memory (``records()``): its id,
  its parent's and its root's (the outermost open scope: one call's scopes
  share it), its start and end on ``time.perf_counter_ns()``, and the
  counts (``count``) made while it was the innermost open scope. A scope
  named as the open scope around it records nothing, so a loop of absorbs
  under one ``Transcript::absorb`` stays one record. The list keeps at most
  ``CAP`` records; past it, records are dropped and counted (``dropped()``).

An operator gets the spans by running the port under ``torch.profiler``:

    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        ...
    prof.export_chrome_trace("trace.json")  # spans beside the kernels
    trace.records()                          # the same spans, with counts

The port's counters: ``host_syncs``, one wherever the host waits for the
card (each read from it, each copy to it from pageable host memory: what
torch's sync debug mode warns of); ``msm_points_run``, the points an MSM
scans after padding; ``poseidon_permutations``; ``poseidon_native_calls``,
one a crossing into the native sponge (csrc/poseidon.cpp);
``blake2s_device_columns``, the columns a launch of the card's column hash
digests (utils/merkle.py ``blake2s_columns``).

With neither switch on, a quiet scope costs one flag read and a logging
one the environment read besides; ``count`` costs one flag read.
"""

from __future__ import annotations

import functools
import os
import sys
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

CAP = 1 << 20  # records kept at most


def recording() -> bool:
    """A torch profiler is running: scopes record."""
    return _autograd_profiler._is_profiler_enabled


_DEPTH = 0
_RECORDS: list = []
_DROPPED = 0
_IDS = iter(range(1, 1 << 62))
_LOCAL = threading.local()  # .stack: the open recorded scopes of a thread


class Record:
    """One recorded scope. ``parent`` and ``root`` are ids (None at a
    root: ``root`` is then the record's own id); ``end_ns`` is None while it
    is open."""

    __slots__ = ("id", "parent", "root", "name", "start_ns", "end_ns", "counts")

    def __init__(self, id, parent, root, name, start_ns):
        self.id, self.parent, self.root, self.name = id, parent, root, name
        self.start_ns, self.end_ns, self.counts = start_ns, None, {}


def enabled() -> bool:
    """The stderr log's switch, POLY_COMMIT_TRACE."""
    return os.environ.get("POLY_COMMIT_TRACE", "") not in ("", "0")


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def records() -> list:
    """The kept records, in the order their scopes opened."""
    return list(_RECORDS)


def dropped() -> int:
    """Records dropped past ``CAP`` since the last ``reset``."""
    return _DROPPED


def reset() -> None:
    """Forget the kept records and the drop count."""
    global _DROPPED
    _RECORDS.clear()
    _DROPPED = 0


def count(name: str, n: int = 1) -> None:
    """Adds n to counter ``name`` of the innermost open recorded scope,
    while recording."""
    if recording():
        stack = _stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


class scope:
    """A named scope (a context manager): logged under POLY_COMMIT_TRACE
    unless ``log`` is False, recorded while a torch profiler runs."""

    __slots__ = ("label", "log", "_record", "_range", "_t0")

    def __init__(self, label: str, log: bool = True):
        self.label, self.log = label, log

    def __enter__(self):
        global _DEPTH, _DROPPED
        self._record = self._range = None
        if recording():
            stack = _stack()
            top = stack[-1] if stack else None
            if top is None or top.name != self.label:
                if len(_RECORDS) < CAP:
                    rid = next(_IDS)
                    rec = Record(rid, top and top.id, top.root if top else rid, self.label, 0)
                    _RECORDS.append(rec)
                    stack.append(rec)
                    self._record = rec
                else:
                    _DROPPED += 1
                self._range = torch.profiler.record_function(self.label)
                self._range.__enter__()
                if self._record is not None:
                    self._record.start_ns = time.perf_counter_ns()
        if self.log and enabled():
            print(f"{'··' * _DEPTH}Start: {self.label}", file=sys.stderr)
            _DEPTH += 1
            self._t0 = time.perf_counter()
        else:
            self._t0 = None
        return self

    def __exit__(self, *exc):
        global _DEPTH
        if self._t0 is not None:
            _DEPTH -= 1
            dt = time.perf_counter() - self._t0
            print(f"{'··' * _DEPTH}End: {self.label} {dt * 1e3:.3f}ms", file=sys.stderr)
        if self._record is not None:
            self._record.end_ns = time.perf_counter_ns()
            stack = _stack()
            if stack and stack[-1] is self._record:
                stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def traced(label: str, log: bool = True):
    """Decorator form of :class:`scope` for whole phases, the analogue of
    the reference's per-function start_timer!/end_timer! pairs. Place under
    @classmethod: ``@classmethod`` / ``@traced("X::commit")`` / ``def …``."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not recording() and not (log and enabled()):
                return fn(*args, **kwargs)
            with scope(label, log):
                return fn(*args, **kwargs)

        return wrapper

    return deco
