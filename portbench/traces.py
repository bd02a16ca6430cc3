"""Reading a torch.profiler trace (Chrome trace format, as
``prof.export_chrome_trace`` and the port's ``Trainer.run(profile_dir=...)``
write it): the device's records, the host's ranges, and what the per-layer
metrics and the breakdown take from them.  Times are the trace's µs."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# the longest idle gaps labelled by the host's event; the rest summed
LABELLED_GAPS = 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")


@dataclass
class Trace:
    # (start, end, name, correlation) of each device record
    device: List[Tuple[float, float, str, int]] = field(default_factory=list)
    # (start, end, name, thread, category) of each host event
    host: List[Tuple[float, float, str, int, str]] = field(default_factory=list)
    # correlation id -> (start, thread) of the host call that launched it
    launch_ts: Dict[int, Tuple[float, int]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        t = cls()
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                t.device.append((ts, ts + dur, e.get("name", ""), int(args.get("correlation", -1))))
            elif cat in HOST_CATS:
                t.host.append((ts, ts + dur, e.get("name", ""), e.get("tid"), cat))
                if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
                    t.launch_ts[int(args["correlation"])] = (ts, e.get("tid"))
        t.device.sort()
        return t

    def range_window(self, name: str) -> Optional[Tuple[float, float]]:
        """The span of the host range ``name`` (its first), extended to the
        end of the last device record that starts inside it."""
        spans = [(a, b) for a, b, n, _, c in self.host if n == name and c == "user_annotation"]
        if not spans:
            return None
        a, b = spans[0]
        end = max([b] + [d1 for d0, d1, _, _ in self.device if a <= d0 <= b])
        return a, end

    def records(self, window: Tuple[float, float]):
        a, b = window
        return [d for d in self.device if d[1] > a and d[0] < b]

    def busy_us(self, window: Tuple[float, float]) -> float:
        """µs of ``window`` in which a device record ran (their union)."""
        return sum(e - s for s, e in self._merged(window))

    def _merged(self, window) -> List[Tuple[float, float]]:
        a, b = window
        out: List[List[float]] = []
        for s, e, _, _ in self.records(window):
            s, e = max(s, a), min(e, b)
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def device_us(self, window, substrings: Sequence[str]) -> float:
        """µs of the device records in ``window`` whose names hold one of
        ``substrings``."""
        return sum(e - s for s, e, n, _ in self.records(window)
                   if any(sub in n for sub in substrings))

    def range_device_us(self, window, prefix: str) -> Dict[str, float]:
        """Device µs of the records launched inside each host range whose
        name starts with ``prefix`` (the innermost such range on the
        launching thread), by range name."""
        ranges = [(a, b, n, tid) for a, b, n, tid, c in self.host
                  if c == "user_annotation" and n.startswith(prefix)]
        out: Dict[str, float] = {}
        for s, e, _, corr in self.records(window):
            launch = self.launch_ts.get(corr)
            if launch is None:
                continue
            ts, tid = launch
            inside = [r for r in ranges if r[3] == tid and r[0] <= ts <= r[1]]
            if inside:
                name = min(inside, key=lambda r: r[1] - r[0])[2]
                out[name] = out.get(name, 0.0) + (e - s)
        return out

    def breakdown(self, window, k: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps'
        time by what the host was doing then (the innermost host event at
        each gap's middle), in seconds, ``k`` of each."""
        ops: Dict[str, float] = {}
        for s, e, n, _ in self.records(window):
            ops[n] = ops.get(n, 0.0) + (e - s)
        a, b = window
        merged = self._merged(window)
        gaps, prev = [], a
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if b > prev:
            gaps.append((prev, b))
        gaps.sort(key=lambda g: g[0] - g[1])
        idle: Dict[str, float] = {}
        if gaps:
            hs = np.array([h[0] for h in self.host] or [0.0])
            he = np.array([h[1] for h in self.host] or [-1.0])
            for s, e in gaps[:LABELLED_GAPS]:
                mid = (s + e) / 2
                cover = np.nonzero((hs <= mid) & (he >= mid))[0]
                name = (self.host[cover[np.argmin((he - hs)[cover])]][2] if len(cover)
                        else "(host idle)")
                idle[name] = idle.get(name, 0.0) + (e - s)
            rest = sum(e - s for s, e in gaps[LABELLED_GAPS:])
            if rest:
                idle["(shorter gaps)"] = rest
        top = lambda d: [[n, v / 1e6] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:k]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}
