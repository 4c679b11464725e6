"""The device trace of a window (`--trace 1`): torch.profiler over the
whole window, reduced to the device's busy time (the union of every
device operation's interval: kernels, copies, sets), the time of kernels
by name, and the longest idle gaps, each named by the innermost host
operation or annotation that was running at its middle."""

import math
import time

import torch

class Trace:
    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile
        self.cuda = cuda
        self.prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        self.window_s = self.reduce_s = 0.0

    def __enter__(self):
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        t = time.perf_counter()
        self.prof.__exit__(*exc)
        self._reduce()
        self.reduce_s = time.perf_counter() - t
        return False

    def _reduce(self):
        from torch.autograd import DeviceType
        events = self.prof.events()
        dev, host = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", False):
                    dev.append(e)
            else:
                host.append(e)
        self.by_name: dict[str, float] = {}
        spans = []
        for e in dev:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            self.by_name[e.name] = (self.by_name.get(e.name, 0.0)
                                    + (b - a) / 1e6)
        spans.sort()
        busy, gaps, end = 0.0, [], -math.inf
        for a, b in spans:
            if a > end and end > -math.inf:
                gaps.append((a - end, end, a))
            if b > end:
                busy += b - max(a, end)
                end = b
        self.busy_s = busy / 1e6
        self.kernels = len(dev)
        gaps.sort(reverse=True)
        main = {e.thread for e in host if e.name == "serve"}
        if main:
            host = [e for e in host if e.thread in main]
        self.idle_gaps = [(self._host_at(host, (s + e) / 2), g / 1e6)
                          for g, s, e in gaps[:10]]

    @staticmethod
    def _host_at(host, t) -> str:
        """The innermost host event running at time t (us)."""
        best = None
        for e in host:
            r = e.time_range
            if r.start <= t <= r.end and (
                    best is None or r.start >= best.time_range.start):
                best = e
        return best.name if best is not None else "outside tts() (the loop)"

    def kernel_s(self, *keys: str) -> float:
        """Seconds of the device operations whose name holds any key."""
        return sum(s for n, s in self.by_name.items()
                   if any(k in n for k in keys))

    def top_ops(self, n: int = 10) -> list:
        return [[name[:160], s] for name, s in
                sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]]
