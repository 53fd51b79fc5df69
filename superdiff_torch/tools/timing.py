"""Timers for kernels on the card, shared by ``chip_smoke.py`` and
``tools/tune_flash_fwd.py``.

- :func:`cuda_time_ms`: CUDA-event time per call of back-to-back calls. At
  small shapes it is set by the host's enqueue rate, not by the kernels.
- :func:`kernel_device_ms`: the kernels' own device time per call, from
  ``torch.profiler`` kernel events.
- :func:`graph_time_ms`: CUDA-event time per call of calls captured in one
  CUDA graph and replayed: device time without the host's enqueue between
  launches, and without the profiler (which loses events in long runs).
"""


def cuda_time_ms(fn, iters, warmup=3):
    """CUDA-event ms per call over ``iters`` back-to-back calls of ``fn``,
    after ``warmup`` calls."""
    import torch

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


def kernel_device_ms(fn, iters=20, kernel=("flash_fwd_kernel",),
                     attempts=3):
    """Device ms per call of the kernels whose names contain one of
    ``kernel`` (all kernels for ``None``), or ``"not measured"``.

    The profiler sometimes loses kernel events (seen on the H100 in long
    runs), so a window's plain sum would read low. A call launches the same
    kernels each time: each kernel seen is counted at least once per call,
    its count per call is the largest seen in five one-call windows and in
    a window of ``iters`` calls, and the time per call is the sum over the
    kernels of that count times the kernel's mean duration in the
    ``iters``-call window. With no event lost this is that window's sum
    over ``iters``. A measurement that comes to no positive time is taken
    again, up to ``attempts`` times in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and (
                    kernel is None or any(k in e.name for k in kernel)):
                times.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        return times

    def measure():
        ones = [window(1) for _ in range(5)]
        many = window(iters)
        per_call = {name: max(1, max(len(w.get(name, ())) for w in ones),
                              round(len(many.get(name, ())) / iters))
                    for name in set(many).union(*ones)}
        if not many or any(name not in many for name in per_call):
            return "not measured"
        ms = sum(n * sum(many[name]) / len(many[name])
                 for name, n in per_call.items()) / 1e3
        return ms if ms > 0 else "not measured"

    fn()
    torch.cuda.synchronize()
    ms = "not measured"
    for _ in range(attempts):
        if ms == "not measured":
            ms = measure()
    return ms


def graph_time_ms(fn, calls=20, replays=10):
    """CUDA-event ms per call of ``fn``, ``calls`` calls captured in one
    CUDA graph (after a warm-up call on a side stream) and the graph
    replayed ``replays`` times. ``fn`` must be capturable: no host
    synchronisation, no read-back."""
    import torch

    from superdiff_torch.utils import graphs

    def run():
        for _ in range(calls):
            fn()

    graphs.warm_up(fn)
    graph, _ = graphs.capture(run)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (calls * replays)
    del graph
    return ms
