"""The traced run: a ``torch.profiler`` trace of a steady sub-window, and
its reduction to what the per-layer metrics read.

- device busy time: the union of every device activity's interval;
- device time by kernel name, and the longest idle gaps summed by the
  benchmark's ``pb.*`` span that the host had open when each began;
- each hand-written kernel launch of the port with its integer arguments
  (shapes, valid rows, k), from a ``pb.launch:<kernel>:<ints>`` span that
  :func:`instrument_kernels` puts around ``Kernel.launch``, and the device
  time of the activities it launched: a device activity belongs to the
  span that holds its runtime call (the runtime event shares the
  activity's correlation id); in a device-only phase, the tally of the
  launches instead.

The reduction works on plain tuples (:func:`reduce`), so the tests feed it
a synthetic trace.
"""

from __future__ import annotations

import bisect
import ctypes
import time

LAUNCH = "pb.launch:"
_tally: list | None = None  # (kernel, ints) of each launch while a device-only phase runs


def instrument_kernels() -> None:
    """Wrap every kernel of the port's ``ops/cuda_kernels.py`` in a span
    naming it and its integer arguments.  The span costs a call only while
    a profiler runs."""
    import torch

    from vietnamese_qa_system_tpu_torch.ops import cuda_kernels as ck

    for kern in ck.KERNELS:
        if getattr(kern, "_pb_wrapped", False):
            continue
        orig = kern.launch
        ints_at = [i for i, t in enumerate(kern.argtypes) if t is ctypes.c_int]

        def launch(*args, _orig=orig, _name=kern.name, _at=ints_at, **kw):
            ints = [args[i] for i in _at if i < len(args)]
            tally = _tally
            if tally is not None:
                tally.append((_name, ints))
            with torch.profiler.record_function(LAUNCH + _name + ":" + ",".join(map(str, ints))):
                return _orig(*args, **kw)

        kern.launch = launch
        kern._pb_wrapped = True


class Tracer:
    """Starts and stops the profiler over the one sub-window a driver
    chooses, in one of two forms:

    - full: the calling thread's host spans and operators, and the device;
      for closed loops driven from the main thread (search, ingest);
    - lean: the device alone, while ``instrument_kernels``' wrappers tally
      the launches; for the engine, whose host loop runs on a thread of
      its own, where recording its ~14,000 operators a chunk would slow
      the host-paced loop it measures.  The kernels' share of their bound
      then sums the tallied launches' bounds against the device time of
      the kernels of that name."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.phase = None  # (profiler, lean, window_s, note, tally)
        self.prof = None
        self.overhead_s = 0.0  # host time spent starting and stopping the profiler

    @property
    def active(self) -> bool:
        return self.prof is not None

    @property
    def done(self) -> bool:
        return self.phase is not None

    @staticmethod
    def _profile(lean: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] if lean else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        return profile(activities=acts)

    def warm(self) -> None:
        """Short sessions before the window: the profiler's first start
        initializes it, which takes seconds."""
        if not self.enabled:
            return
        import torch

        for lean in (True, False):
            p = self._profile(lean)
            p.start()
            torch.ones(8, device="cuda").sum().item()
            p.stop()

    def start(self, note: str, lean: bool = False) -> None:
        global _tally
        if not self.enabled or self.prof is not None or self.done:
            return
        import torch

        t = time.perf_counter()
        torch.cuda.synchronize()  # no launch of before the sub-window runs in it
        self._tally = []
        if lean:
            _tally = self._tally
        self.prof = self._profile(lean)
        self.prof.start()
        self._t0 = time.perf_counter()
        self._lean = lean
        self._note = f"{'device only' if lean else 'host and device'}: {note}"
        self.overhead_s += self._t0 - t

    def stop(self) -> None:
        global _tally
        if self.prof is None:
            return
        import torch

        torch.cuda.synchronize()
        t = time.perf_counter()
        self.prof.stop()
        _tally = None
        self.phase = (self.prof, self._lean, t - self._t0, self._note, self._tally)
        self.prof = None
        self.overhead_s += time.perf_counter() - t

    def result(self) -> dict | None:
        if self.phase is None:
            return None
        from torch.autograd import DeviceType

        prof, _, window_s, note, tally = self.phase
        dev, host, runtime = [], [], []
        for name, a, b, dt, corr, thread, annotation in _events(prof):
            if dt == DeviceType.CUDA:
                # a user span's device-side twin covers its kernels and the gaps between them
                if not (annotation or name.startswith("pb.")):
                    dev.append((name, a, b, corr))
            elif name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
                runtime.append((name, a, b, corr, thread))
            elif name.startswith("pb."):
                host.append((name, a, b, thread))
        out = reduce(dev, host, runtime, window_s * 1e6)
        out["note"] = f"{note}, {window_s:.3f} s"
        out["tally"] = tally
        return out


def _events(prof):
    """(name, start us, end us, device type, correlation id, thread, is a
    user annotation) of every event, read from the profiler's raw results:
    building its Python event objects takes minutes on a whole generation
    window."""
    kr = prof.profiler.kineto_results
    t0 = kr.trace_start_ns()
    for e in kr.events():
        ann = getattr(e, "is_user_annotation", None)
        yield (e.name(), (e.start_ns() - t0) / 1e3, (e.end_ns() - t0) / 1e3, e.device_type(), e.correlation_id(),
               e.start_thread_id(), bool(ann()) if ann is not None else False)


def _union(intervals) -> tuple[float, list]:
    """Total length and the merged segments of (start, end) intervals."""
    segs = []
    for a, b in sorted(intervals):
        if segs and a <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], b)
        else:
            segs.append([a, b])
    return sum(b - a for a, b in segs), segs


def short_name(name: str) -> str:
    n = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return n.split("(")[0][:120]


def reduce(dev, host, runtime, window_us: float) -> dict:
    """``dev``: (name, start, end, correlation id) device activities;
    ``host``: (name, start, end, thread) spans; ``runtime``: (name, start,
    end, correlation id, thread) runtime calls; times in us from the
    trace's start, which is the sub-window's start."""
    busy_us, segs = _union((a, b) for _, a, b, _ in dev)
    by_name = {}
    for name, a, b, _ in dev:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a)
    # idle gaps inside the window, by the latest-opened span at each gap's start
    labelled = sorted((a, b, n) for n, a, b, _ in host if not n.startswith(LAUNCH))
    starts = [x[0] for x in labelled]
    edges = [0.0] + [x for s in segs for x in s] + [max(window_us, segs[-1][1] if segs else 0.0)]
    idle = {}
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0)
        label = "(no span)"
        for a, b, n in reversed(labelled[max(0, i - 64): i]):
            if b > g0:
                label = n
                break
        idle[label] = idle.get(label, 0.0) + (g1 - g0)
    # device activities by the runtime call that launched them
    dev_by_corr = {}
    for name, a, b, corr in dev:
        dev_by_corr.setdefault(corr, []).append((name, a, b))
    rt = sorted((a, corr, th) for _, a, _, corr, th in runtime)
    rt_starts = [x[0] for x in rt]

    def launched(a, b, thread):
        lo, hi = bisect.bisect_left(rt_starts, a), bisect.bisect_right(rt_starts, b)
        calls = [corr for _, corr, th in rt[lo:hi] if th == thread] or [corr for _, corr, _ in rt[lo:hi]]
        return [d for corr in calls for d in dev_by_corr.get(corr, ())]

    launches = {}
    for name, a, b, thread in host:
        if name.startswith(LAUNCH):
            _, kern, args = name.split(":", 2)
            acts = launched(a, b, thread)
            if acts:
                ints = [int(x) for x in args.split(",") if x]
                launches.setdefault(kern, []).append((ints, sum(y - x for _, x, y in acts) / 1e6))
    return {
        "window_s": window_us / 1e6,
        "busy_s": busy_us / 1e6,
        "kernel_s": {k: v / 1e6 for k, v in by_name.items()},
        "device_ops": [[k, v / 1e6] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[k, v / 1e6] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        "launches": launches,
    }
