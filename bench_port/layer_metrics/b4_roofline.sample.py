"""Kernel B4's (``csrc/group_norm_silu.cu``) share of its roofline over the
traced sampling window, in percent: the least time of the chains the
window ran (per chain the larger of bytes over the memory bandwidth and
operations over the float32 peak, ``common/counts.py``, from the plain
reference's chain shapes) over B4's device time in the trace.

B4 runs one ``gn_cluster`` per chain in its cluster regime and
``gn_stats`` + ``gn_finalize`` + ``gn_apply`` in its three-pass one; one
of ``CALL_KERNELS`` per chain. The window's chains are its denoiser calls
times the reference's chains per call. Where the trace holds no B4 kernel,
or a count of B4 calls more than 5 % off that, nothing is read; where the
profiler lost a few events, the time is scaled by the chains expected over
those seen."""

from bench_port.common.counts import b4_bound_s, peaks

KERNELS = ("gn_cluster", "gn_stats", "gn_finalize", "gn_apply")
CALL_KERNELS = ("gn_cluster", "gn_apply")


def read(cell, out):
    w = out.get("window")
    if w is None or "calls" not in w.counts:
        return None
    import torch

    chains = out["static"]["b4_chains"]
    expected = len(chains) * w.counts["calls"]
    seconds, _ = w.kernel_s(KERNELS)
    _, seen = w.kernel_s(CALL_KERNELS)
    if not seen or abs(seen - expected) > 0.05 * expected:
        return None
    pk = peaks(torch.cuda.get_device_name())
    bound = b4_bound_s(chains, out["static"]["b4_elt_bytes"], pk) \
        * w.counts["calls"]
    return 100.0 * bound / (seconds * expected / seen)
