"""Device selection for the port's entry points.

Entry points take ``device="cuda"`` by default: the port is written for an
NVIDIA card, and the CPU runs only when the caller asks for it (the tests
do). A CUDA request without a visible card raises instead of quietly
running somewhere else. The CUDA-graph capture and the timers here are
the ones the flagship step and `chip_smoke.py` share.
"""

from __future__ import annotations

import statistics
import time

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "morfem_tpu_torch: CUDA was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# the one stream of each card that captures run on (see capture_graph)
_capture_streams = {}


def capture_graph(dev: torch.device, fn, *args):
    """Record ``fn(*args)`` as one CUDA graph on `dev` → (graph, outputs).

    One warm-up call runs first, so that lazy set-up (cuBLAS and cuSOLVER
    handles, the allocator's first blocks) stays out of the graph. Both
    run on one side stream that every capture on the card shares: PyTorch
    keeps a cuBLAS workspace for each stream cuBLAS meets, for the life of
    the process, so a new stream for each capture held up to 1 GB more
    (an H100, the full sweep: 0.136 GB for its first capture's four
    streams). The capture leaves the caching allocator as it is: the
    `torch.cuda.graph` context would first synchronise the card and hand
    every cached block back to the driver, for the next allocations to
    take back by `cudaMalloc` (an H100, the full sweep, which captures
    once a call: 0.345 s a sweep with that flush, 0.319 s without). The
    outputs are the graph's static tensors: they hold the warm-up's
    values until the first replay overwrites them. A failure to capture
    raises.
    """
    current = torch.cuda.current_stream(dev)
    key = current.device_index
    if key not in _capture_streams:
        _capture_streams[key] = torch.cuda.Stream(current.device)
    stream = _capture_streams[key]
    stream.wait_stream(current)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        fn(*args)
        graph.capture_begin()
        try:
            out = fn(*args)
        finally:
            graph.capture_end()
    current.wait_stream(stream)
    return graph, out


def median_event_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream, each of
    `reps` calls timed alone between two CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def median_wall_s(fn, reps: int, dev: torch.device) -> float:
    """Median wall seconds of ``fn()`` over `reps` calls, each one
    synchronised before and after."""
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
