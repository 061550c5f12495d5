"""The device's side of a traced run: ``torch.profiler`` over a sub-window.

The busy share copies the arithmetic of ``tools/profile_torch_serve.py``
(device events only: kernels, copies and fills, never an operator's own
device time, which repeats its kernels'), but over the union of the
events' intervals, so work that two threads overlap on the card counts
once. The window opens with one-element int16 fills, as
``chip_smoke.primed_profile`` does: late in a long process the profiler
drops the first device records of a window, and the fills take that
loss; they are left out of every sum. A sub-window of a few seconds, not
the whole run, is traced, since the profiler also loses records in long
windows.
"""
from __future__ import annotations

import time

PRIMER_FILLS = 64
PRIMER_KERNEL = "FillFunctor<short>"
_MARK = "bench.window_mark"


class TraceWindow:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.t0 = self.t1 = None
        self.mark = None

    def prime(self) -> None:
        """Open and close one profiling session in set-up: the profiler's
        first start takes seconds, which would otherwise come out of the
        traced sub-window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            self.torch.zeros(1, device="cuda").add_(1)
            self.torch.cuda.synchronize()

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile, record_function

        primer = torch.zeros(1, dtype=torch.int16, device="cuda")
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        for _ in range(PRIMER_FILLS):
            primer.fill_(1)
        torch.cuda.synchronize()
        with record_function(_MARK):
            self.mark = time.monotonic()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)

    def summary(self, spans) -> dict:
        """busy_s, window_s, per kernel name (count, seconds), and the
        breakdown: the ten device operations that took most time and the
        ten longest idle gaps, each named by the harness spans and the
        host's torch operators under way at its middle."""
        cuda = self.torch.autograd.DeviceType.CUDA
        events = list(self.prof.events())
        mark = next((e for e in events if e.name == _MARK), None)
        # profiler microseconds -> monotonic seconds
        offset = (self.mark - mark.time_range.start / 1e6
                  if mark is not None else None)
        dev, host = [], []
        for e in events:
            if e.device_type == cuda:
                if PRIMER_KERNEL not in e.name:
                    dev.append((e.time_range.start, e.time_range.end,
                                e.name))
            elif e.name != _MARK:
                host.append((e.time_range.start, e.time_range.end, e.name))
        lo = (self.t0 - offset) * 1e6 if offset is not None else None
        hi = (self.t1 - offset) * 1e6 if offset is not None else None
        if lo is not None:
            dev = [(max(a, lo), min(b, hi), n) for a, b, n in dev
                   if b > lo and a < hi]
        kernels: dict[str, list] = {}
        for a, b, name in dev:
            k = kernels.setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += (b - a) / 1e6
        merged: list[list[float]] = []
        for a, b, _ in sorted(dev):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy = sum(b - a for a, b in merged) / 1e6
        window = self.t1 - self.t0
        gaps = []
        if lo is not None:
            edges = [lo] + [x for ab in merged for x in ab] + [hi]
            for a, b in zip(edges[0::2], edges[1::2]):
                if b > a:
                    gaps.append((b - a, a, b))
        gaps.sort(reverse=True)
        named_gaps = []
        for length, a, b in gaps[:10]:
            mid = (a + b) / 2
            t_mid = mid / 1e6 + offset
            names = sorted({s[0] for s in spans if s[1] <= t_mid <= s[2]})
            ops = sorted({n for s, e, n in host if s <= mid <= e})[:3]
            label = "+".join(names) or "no harness span"
            if ops:
                label += " | " + ", ".join(ops)
            named_gaps.append([label, length / 1e6])
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
        return {"busy_s": busy, "window_s": window, "t0": self.t0,
                "t1": self.t1, "kernels": kernels,
                "breakdown": {"device_ops": [[n[:200], v[1]] for n, v in top],
                              "idle_gaps": named_gaps}}
