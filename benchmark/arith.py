"""The benchmark's metric arithmetic: published peaks, a kernel's bound,
kernel 1's operations and bytes, CUDA-event timing, a host-read counter
and the statistics of a window.

`PEAK_FLOPS`, `PEAK_HBM_BYTES`, `bound`, `fused_work`, `cuda_ms` and
`HostReads` are frozen copies of `chip_smoke.py`'s `PEAK_FLOPS`,
`PEAK_HBM_BYTES`, `bound`, `_fused_work`, `cuda_ms` and `_HostReads`,
kept here so that the yardstick does not move with the program.
"""
from __future__ import annotations

import math
import statistics

# The card's peaks (NVIDIA's H100 SXM data sheet, dense, at 700 W): f32
# and f64 outside the tensor cores, and HBM3. Copied from chip_smoke.py.
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
PEAK_HBM_BYTES = 3.35e12


def bound(flops, nbytes, dtype="float32"):
    """(bound_ms, bound_by): the least time the card could take for work
    of `flops` operations on `dtype` inputs moving `nbytes`, the larger
    of the operation time and the byte time. Copied from
    chip_smoke.bound."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), (
        "operations" if t_ops >= t_bytes else "bytes")


def fused_work(B, n, m, ml, k, refine):
    """(operations, bytes) of k fused ADMM iterations on B lanes sharing
    A (m, n), M^-1 and M (n, n): the products' FMAs and each input (A,
    M^-1, M where refined, q, rho, lam, l, u, x, z, y) read once and x,
    z, y written once, in f32. Copied from chip_smoke._fused_work."""
    flops = 2 * B * k * (2 * m * n + (1 + 2 * refine) * n * n)
    nbytes = 4 * (m * n + n * n * (2 if refine else 1) + n + m + ml
                  + 2 * B * m + 2 * B * (n + 2 * m))
    return flops, nbytes


def cuda_ms(fn, reps=10, warmup=2):
    """Median milliseconds of fn() by CUDA events, one event pair per
    call. Copied from chip_smoke.cuda_ms."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


class HostReads:
    """Counts the host's reads of device values inside the block: calls
    of item, tolist, bool, float and int on CUDA tensors, each of which
    waits for the card. Copied from chip_smoke._HostReads."""

    NAMES = ("item", "tolist", "__bool__", "__float__", "__int__")

    def __enter__(self):
        import torch
        self.count = 0
        self.own = {n: torch.Tensor.__dict__.get(n) for n in self.NAMES}
        for name in self.NAMES:
            setattr(torch.Tensor, name, self._counted(getattr(torch.Tensor,
                                                              name)))
        return self

    def _counted(self, fn):
        def read(t, *a, **k):
            if t.is_cuda:
                self.count += 1
            return fn(t, *a, **k)
        return read

    def __exit__(self, *exc):
        import torch
        for name, fn in self.own.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)


def percentile(values, q):
    """The q-th percentile (0..100) of every value, by linear
    interpolation between the order statistics (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
