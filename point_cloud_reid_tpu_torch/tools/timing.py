"""How chip_smoke.py and the A/B tools read a kernel's time on the card.

time_ms: CUDA events around `iters` calls made one after another from
Python. This is the `ms` of every kernel row: what a caller pays a call,
which for a kernel shorter than the host's enqueue (tens of us of Python
and ctypes) is the host's pace, not the kernel's.

graph_ms: the device time of one call, `iters` calls captured in one CUDA
graph and replayed between CUDA events, so the host's enqueue is not in
the clock. It is the `device_ms` beside `ms` where the two differ (kNN,
linear attention and FPS).

device_kernels: the names of the device kernels one call runs, from
torch.profiler beside a control kernel that proves the trace saw the
device, as chip_smoke.py and the CUDA tests count FPS's.
"""
from __future__ import annotations

import torch


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms of fn() over `iters` calls from Python, after `warmup`."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 3) -> float:
    """Mean device ms of fn() over `iters` calls in one CUDA graph, the
    graph replayed `replays` times. fn runs once before the capture, which
    builds and loads the kernel, and once on a side stream, as capture
    needs."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def device_kernels(fn, attempts: int = 3) -> list:
    """Names of the device kernels (and copies) that one fn() runs, traced
    by torch.profiler after one call outside the trace.

    Each trace opens with a control kernel (`torch.cuda._sleep`'s
    spin_kernel). A trace that holds no control kernel saw no device
    activity at all, as CUPTI's first session in a process sometimes does:
    it is traced again, up to `attempts` traces, and then raises rather
    than report that fn ran nothing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        control = [n for n in names if "spin_kernel" in n]
        if control:
            return [n for n in names if "spin_kernel" not in n]
    raise RuntimeError(f"torch.profiler recorded no device activity in "
                       f"{attempts} traces, not even the control kernel")
