"""Phase timing and, in trace mode, the program's spans.

Counterpart of `morfem_tpu/utils/timing.py`. PyTorch returns before the
card finishes, so an enabled phase on the card synchronises it before it
starts and before it ends: the bucket then holds device completion, not
the time to enqueue, as the reference's phases do by blocking on their
outputs. The card synchronised is ``device`` when one is given, else the
current CUDA device once CUDA is initialised; a disabled timer
synchronises nothing.

``trace=True`` wraps each phase in `torch.profiler.record_function` (a
range in a `torch.profiler` trace, on the CPU and on the card) and, where
CUDA is available, in an NVTX range (Nsight Systems) — the counterpart of
the reference's `jax.profiler.TraceAnnotation`.

Spans. A trace-mode timer also records what the program does inside its
phases. Program code marks its steps with the module-level `span(name)`
and reads values back to the host through `host_read(fn, *args)` (a
``"host sync"`` span); the entry points open a root span named after
themselves with `PhaseTimer.span`. Each span records its name, its start
and end on `time.time_ns()` (the clock of a `torch.profiler` trace:
``baseTimeNanoseconds + ts·1000``), its parent (the enclosing span or
phase), its call (the number of the outermost span open, the entry
point's root span) and ``device_s``: on the card, the time between two
timing events recorded on the current stream at entry and exit, read
after the enclosing phase's closing synchronise (none is added); while
the stream captures a CUDA graph, and on the CPU, the host time. Two
kinds of span record no events and take their host time: a root span,
because the phases inside it synchronise the card, and a ``"host sync"``
span, because its read returns only once the card has run all that was
queued before it (two events there would time only the copy, at twice
the cost of the span). Each span is a
`record_function` range while a profiler records (and an NVTX range on
the card), under its own name, so a profiler trace names the step.
``timer.spans`` keeps the records in memory; ``timer.times[name]`` adds
up each span name's ``device_s`` beside the phase buckets, and
``timer.counts[name]`` counts the spans of each name.

``timer.export(path)`` writes the spans as chrome-trace JSON (``"X"``
events, ``ts`` in microseconds of Unix time, ``call``, ``parent`` and
``device_s`` in ``args``), which Perfetto or ``chrome://tracing`` opens.
``timer.export(path, profiler_trace=p)`` writes them instead into a copy
of the `torch.profiler` export at ``p``, shifted to its
``baseTimeNanoseconds``: one file, the program's spans beside the
profiler's ranges and the card's kernels on one time axis.

With no trace-mode timer open, `span` returns one shared object that does
nothing and `host_read` calls its function: no range, no event and no
synchronise. The open timer is one pointer for the whole process, so
spans follow one thread at a time.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

HOST_SYNC = "host sync"
SPAN_TID = 0  # the exported spans' track, apart from the profiler's threads

# the trace-mode timer whose phase or root span is open, if any
_active: Optional["PhaseTimer"] = None


# what `span` returns with no trace-mode timer open
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span of the trace-mode timer whose phase is open, else the shared
    no-op context."""
    timer = _active
    return _NO_SPAN if timer is None else _Span(timer, name)


def host_read(fn, *args):
    """``fn(*args)``, a read that waits for the card (``float(t)``,
    ``int(t)``, ``t.cpu``), inside a ``"host sync"`` span when a
    trace-mode timer is open; returns what ``fn(*args)`` returns."""
    timer = _active
    if timer is None:
        return fn(*args)
    with _Span(timer, HOST_SYNC, timed=False):
        return fn(*args)


class SpanRecord:
    """One span: name, Unix-time bounds in ns, parent and call numbers,
    device seconds (None until read), and whether it is a phase."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "call", "device_s",
                 "phase", "events")

    def __init__(self, name, parent, call, phase):
        self.name, self.parent, self.call = name, parent, call
        self.phase = phase
        self.start_ns = self.end_ns = 0
        self.device_s = None
        self.events = None

    def host_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


class _Span:
    """Context of one span (or of a phase's record) on `timer`."""

    __slots__ = ("timer", "name", "phase", "timed", "rec", "prev", "range")

    def __init__(self, timer, name, phase=False, timed=True):
        self.timer, self.name, self.phase = timer, name, phase
        self.timed = timed

    def __enter__(self):
        global _active
        timer = self.timer
        number, stack = len(timer.spans), timer._stack
        if stack:
            parent, call = stack[-1][0], stack[-1][1].call
        else:
            parent, call = None, number
            timer._open()
        rec = self.rec = SpanRecord(self.name, parent, call, self.phase)
        stack.append((number, rec))
        timer.spans.append(rec)
        self.prev, _active = _active, timer
        self.range = None
        # stamped outside the range, so that the span holds it: the
        # profiler's first range of a trace pays for its set-up after its
        # own start
        rec.start_ns = time.time_ns()
        if rec.phase:  # the phase opens its own ranges
            return rec
        if torch.autograd._profiler_enabled():
            self.range = torch.profiler.record_function(rec.name)
            self.range.__enter__()
        if timer._on_cuda:
            torch.cuda.nvtx.range_push(rec.name)
            if self.timed and parent is not None and not (
                    torch.cuda.is_current_stream_capturing()):
                rec.events = (timer._event(), timer._event())
                rec.events[0].record(timer._stream())
        return rec

    def __exit__(self, *exc):
        global _active
        timer, rec = self.timer, self.rec
        if not rec.phase:
            if rec.events is not None:
                rec.events[1].record(timer._stream())
            if timer._on_cuda:
                torch.cuda.nvtx.range_pop()
            if self.range is not None:
                self.range.__exit__(*exc)
        rec.end_ns = time.time_ns()
        if rec.events is not None:
            timer._pending.append(rec)
        else:
            rec.device_s = rec.host_s()
            if not rec.phase:
                timer._total(rec)
        timer._stack.pop()
        _active = self.prev
        if not timer._stack and timer._pending:
            timer._resolve(wait=False)
        return False


class PhaseTimer:
    """Accumulates named wall-clock phase buckets.

    Usage::

        timer = PhaseTimer()
        with timer.phase("offline"):
            ...
        print(timer.report())
    """

    def __init__(self, disabled: bool = False, trace: bool = False, *,
                 device=None):
        self.times: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.spans: List[SpanRecord] = []
        self.disabled = disabled
        self.trace = trace
        self.device = torch.device(device) if device is not None else None
        self._start = time.perf_counter()
        self._stack = []  # (number, record) of the open spans and phases
        self._pending: List[SpanRecord] = []  # device times not read yet
        self._free_events = []
        self._on_cuda = False
        self._device_index = None
        self._raw_stream = self._current_stream = None

    def _sync(self):
        if self.device is None:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
        elif self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _open(self):
        """At the outermost span or phase: whether spans time the card
        (the card `_sync` waits for)."""
        if self.device is None:
            self._on_cuda = torch.cuda.is_initialized()
        else:
            self._on_cuda = self.device.type == "cuda"
        self._device_index = None

    def _stream(self):
        """The current stream, looked up again only when its handle
        changes (`torch.cuda.current_stream` costs more than the
        record)."""
        if self._device_index is None:
            self._device_index = torch.cuda.current_device()
        raw = torch._C._cuda_getCurrentRawStream(self._device_index)
        if raw != self._raw_stream:
            self._raw_stream = raw
            self._current_stream = torch.cuda.current_stream()
        return self._current_stream

    def _ranges(self, name: str):
        stack = contextlib.ExitStack()
        if self.trace:
            stack.enter_context(torch.profiler.record_function(name))
            if torch.cuda.is_available():
                stack.enter_context(torch.cuda.nvtx.range(name))
        return stack

    def _event(self):
        if self._free_events:
            return self._free_events.pop()
        return torch.cuda.Event(enable_timing=True)

    def _total(self, rec: SpanRecord):
        self.times[rec.name] = self.times.get(rec.name, 0.0) + rec.device_s
        self.counts[rec.name] = self.counts.get(rec.name, 0) + 1

    def _resolve(self, wait: bool):
        """Read the device times of the pending spans: all of them after a
        synchronise (`wait`), else those whose end event has completed,
        in order."""
        done = 0
        for rec in self._pending:
            start, end = rec.events
            if not wait and not end.query():
                break
            rec.device_s = start.elapsed_time(end) / 1e3
            rec.events = None
            self._free_events += (start, end)
            self._total(rec)
            done += 1
        del self._pending[:done]

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.disabled:
            yield
            return
        self._sync()
        record = _Span(self, name, phase=True) if self.trace else _NO_SPAN
        t0 = time.perf_counter()
        with record, self._ranges(name):
            yield
            self._sync()
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0
        if self._pending:
            self._resolve(wait=True)

    def span(self, name: str):
        """A span on this timer, open or not: the entry points' root span.
        A disabled or plain timer returns the shared no-op context."""
        if self.disabled or not self.trace:
            return _NO_SPAN
        return _Span(self, name)

    def add(self, name: str, seconds: float):
        self.times[name] = self.times.get(name, 0.0) + seconds

    def total(self) -> float:
        """Wall time since construction ('Whole' in the reference)."""
        return time.perf_counter() - self._start

    def as_dict(self) -> Dict[str, float]:
        d = dict(self.times)
        d["whole"] = self.total()
        return d

    def report(self) -> str:
        """Reference-style text report: seconds and % of whole."""
        whole = self.total()
        lines = [f"whole: {whole:.3f} s | 100.00%"]
        for name, t in self.times.items():
            pct = 100.0 * t / whole if whole > 0 else 0.0
            lines.append(f"{name}: {t:.3f} s | {pct:.2f}%")
        return "\n".join(lines)

    def export(self, path, profiler_trace=None):
        """Write the spans (phases included) as chrome-trace JSON to `path`;
        with `profiler_trace`, the path of a `torch.profiler` export, into
        a copy of it, on its time base. Device times still unread are read
        first, waiting for their end events."""
        for rec in self._pending:
            rec.events[1].synchronize()
        self._resolve(wait=True)
        doc, base_ns = {"traceEvents": []}, 0
        if profiler_trace is not None:
            with open(profiler_trace) as f:
                doc = json.load(f)
            base_ns = int(doc.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        doc["traceEvents"].append({"name": "thread_name", "ph": "M",
                                   "pid": pid, "tid": SPAN_TID,
                                   "args": {"name": "morfem spans"}})
        for number, rec in enumerate(self.spans):
            doc["traceEvents"].append({
                "name": rec.name, "ph": "X",
                "cat": "phase" if rec.phase else "span",
                "ts": (rec.start_ns - base_ns) / 1e3,
                "dur": (rec.end_ns - rec.start_ns) / 1e3,
                "pid": pid, "tid": SPAN_TID,
                "args": {"span": number, "call": rec.call,
                         "parent": rec.parent, "device_s": rec.device_s},
            })
        with open(path, "w") as f:
            json.dump(doc, f)
