"""Profiling, tracing and failure recording.

The port's copy of ``vietnamese_qa_system_tpu/core/tracing.py`` (which
imports jax):

- :func:`trace` (and :func:`start_trace` / :func:`stop_trace`): a
  ``torch.profiler`` trace of the host's operators and, on a GPU, the
  device's kernels, written as a Chrome trace (``trace_*.json``) that
  Perfetto or ``chrome://tracing`` opens;
- :func:`span` and :func:`record`: the port's named spans, kept in
  memory while a ``torch.profiler`` session runs and read with
  :func:`spans`;
- :func:`count`: the port's counters, read for the whole process with
  :func:`totals` and for the latest profiler session with :func:`counts`;
- :func:`record_errors`: writes a JSON error file before re-raising, for
  an external supervisor.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import traceback
from collections import deque
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler


def start_trace(log_dir: str = "runs/profile", device: str | torch.device = "cuda"):
    """Start a ``torch.profiler`` trace of the host's operators and, for a
    CUDA ``device``, its kernels; returns the profiler for
    :func:`stop_trace`."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof, log_dir: str = "runs/profile") -> str:
    """Stop ``prof`` and write its Chrome trace under ``log_dir``; returns
    the file's path."""
    prof.stop()
    path = os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile", device: str | torch.device = "cuda"):
    """Trace the block (see :func:`start_trace`); yields ``log_dir``."""
    prof = start_trace(log_dir, device)
    try:
        yield log_dir
    finally:
        stop_trace(prof, log_dir)


# ---- spans ------------------------------------------------------------------
#
# A span records only while a torch.profiler session runs, whichever thread
# started it: the recorder reads the process-wide flag that the profiler sets
# at its start and clears at its stop (``torch.autograd._profiler_enabled()``
# answers for the calling thread alone, and is False on a thread that was
# running before the session began, such as the continuous engine's).
# Times are ``time.time_ns()``: the clock of the profiler's own events, so a
# span lines up with the device activity of the same trace.  Each session the
# profiler starts gets a number, counted by wrapping the function that sets
# the flag at the start; :func:`spans` returns the latest session's spans, so
# the short sessions a caller runs before the one it measures (to initialize
# the profiler) never reach it.

MAX_SPANS = 1 << 16  # the newest are kept


class Span(NamedTuple):
    name: str
    t0: int  # ns, time.time_ns()
    t1: int
    thread: int  # threading.get_ident() of the recording thread
    id: int
    parent: Optional[int]  # the id of the span open on the same thread when this one began
    rid: Optional[int]  # the request's id, for a request's spans
    args: dict  # a few integers
    session: int  # the profiler session it was recorded in


_spans: deque = deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_open = threading.local()  # .stack: the spans open on this thread, innermost last
_session = 0


def _count_session(_start=_profiler._run_on_profiler_start) -> None:
    global _session
    _session += 1
    _start()


if not getattr(_profiler._run_on_profiler_start, "counts_sessions", False):
    _count_session.counts_sessions = True
    _profiler._run_on_profiler_start = _count_session


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _Off:
    """What :func:`span` returns while no profiler runs: nothing is
    allocated or recorded."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **ints) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "rid", "args", "id", "parent", "session", "t0", "rf")

    def __init__(self, name: str, rid, args: dict):
        self.name, self.rid, self.args = name, rid, args

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(_ids)
        self.session = _session
        stack.append(self)
        # the span in a trace that records this thread's host events (Perfetto, train --profile-steps)
        self.rf = torch.profiler.record_function(self.name) if torch.autograd._profiler_enabled() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _stack().pop()
        _spans.append(Span(self.name, self.t0, t1, threading.get_ident(), self.id, self.parent, self.rid, self.args,
                           self.session))
        return False

    def set(self, **ints) -> None:
        """Add integer arguments known only inside the span."""
        self.args.update(ints)


def span(name: str, *, rid: Optional[int] = None, **ints):
    """A context manager that records the block as a span named ``name``
    (request id ``rid``, integer arguments ``ints``; more with ``.set()``
    inside) while a profiler session runs; otherwise it costs one check."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, rid, ints)


def record(name: str, t0: int, t1: int, *, rid: Optional[int] = None, **ints) -> None:
    """Record a span whose ends were stamped (``time.time_ns()``) by the
    caller, its start perhaps on another thread.  Its parent is the span
    open on the calling thread that began at or before ``t0``, if any."""
    if not _profiler._is_profiler_enabled:
        return
    parent = next((s.id for s in reversed(_stack()) if s.t0 <= t0), None)
    _spans.append(Span(name, t0, t1, threading.get_ident(), next(_ids), parent, rid, ints, _session))


def spans() -> list[Span]:
    """The spans of the latest profiler session started, in the order they
    ended."""
    latest = _session
    return [s for s in list(_spans) if s.session == latest]


# ---- counters ---------------------------------------------------------------
#
# A counter tallies one kind of event for the life of the process; the events
# of a running profiler session are also tallied for that session alone, so
# a reader of a traced window gets the window's own count, as it gets its
# spans.

_count_lock = threading.Lock()
_totals: dict[str, int] = {}
_session_counts: dict[str, int] = {}  # of profiler session _counted_session
_counted_session = 0


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    global _counted_session
    with _count_lock:
        _totals[name] = _totals.get(name, 0) + n
        if _profiler._is_profiler_enabled:
            if _counted_session != _session:
                _session_counts.clear()
                _counted_session = _session
            _session_counts[name] = _session_counts.get(name, 0) + n


def totals() -> dict[str, int]:
    """Every counter's tally since the process started."""
    with _count_lock:
        return dict(_totals)


def counts() -> dict[str, int]:
    """The counters' tallies in the latest profiler session started."""
    with _count_lock:
        return dict(_session_counts) if _counted_session == _session else {}


ERROR_FILE_ENV = "VQA_TPU_ERROR_FILE"


def record_errors(fn=None, *, error_file: Optional[str] = None):
    """Decorator: on an exception, write {time, type, message, traceback,
    process_index} as JSON to ``$VQA_TPU_ERROR_FILE`` (or ``error_file``)
    and re-raise.  The port runs one process: its index is 0."""

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            try:
                return f(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 -- record everything
                path = error_file or os.environ.get(ERROR_FILE_ENV)
                if path:
                    try:
                        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                        with open(path, "w") as fh:
                            json.dump({"time": time.time(), "type": type(e).__name__, "message": str(e),
                                       "traceback": traceback.format_exc(), "process_index": 0}, fh, indent=2)
                    except OSError:
                        pass
                raise

        return wrapper

    return deco(fn) if fn is not None else deco
