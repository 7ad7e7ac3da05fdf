"""Tracing / profiling utilities (counterpart of
``lightglue_tpu/utils/profiling.py``).

The reference's observability is cudaEvent brackets in the demo loop
(demo/demo_mono.cpp:194-200) plus trtexec latency histograms. Here a device
trace is a ``torch.profiler`` Chrome trace (viewable in Perfetto or
chrome://tracing), and ``SectionTimer`` times named host sections that end
in a device synchronisation. For device time free of host overhead, replay
a CUDA graph between CUDA events (``cli/bench.py``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write ``<log_dir>/trace.json`` (Chrome trace
    format): ``with device_trace('traces'): ...``. CUDA activity is
    recorded when a card is present, host activity always."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities, record_shapes=True) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def _cuda_devices(tree, found: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, found)
    elif isinstance(tree, (list, tuple)):  # NamedTuples (Extraction, Matches) too
        for v in tree:
            _cuda_devices(v, found)
    return found


class SectionTimer:
    """Named wall-clock sections with mean/p50/p95 summaries, the cudaEvent
    bracket analog. ``block`` waits for the devices of a result's CUDA
    tensors, so a section that ends in it covers the device's work."""

    def __init__(self) -> None:
        self.samples: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append((time.perf_counter() - t0) * 1e3)

    def block(self, tree) -> None:
        for dev in _cuda_devices(tree, set()):
            torch.cuda.synchronize(dev)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.samples.items():
            arr = np.asarray(vals)
            out[name] = {
                "count": int(arr.size),
                "mean_ms": float(arr.mean()),
                "p50_ms": float(np.percentile(arr, 50)),
                "p95_ms": float(np.percentile(arr, 95)),
                "min_ms": float(arr.min()),
            }
        return out

    def report(self) -> str:
        lines = []
        for name, s in self.summary().items():
            lines.append(
                f"{name:24s} n={s['count']:4d} mean {s['mean_ms']:8.3f} ms  "
                f"p50 {s['p50_ms']:8.3f}  p95 {s['p95_ms']:8.3f}"
            )
        return "\n".join(lines)
