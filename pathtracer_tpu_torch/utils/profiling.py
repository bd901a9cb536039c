"""Profiling and metrics: wall-clock phases, Mrays/s, profiler traces.

Counterpart of ``pathtracer_tpu/utils/profiling.py``. Every CLI render
reports rays cast, wall-clock per phase and Mrays/s; ``--profile DIR``
captures a ``torch.profiler`` trace (CPU and, with a card, CUDA activity:
the kernel's launches included) and writes it to DIR as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional


@dataclasses.dataclass
class PhaseTimer:
    """Accumulates wall-clock seconds per named phase."""
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> str:
        return "  ".join(f"{k}={v:.3f}s" for k, v in self.phases.items())


@dataclasses.dataclass
class RenderMetrics:
    rays_cast: float
    wall_seconds: float
    width: int
    height: int
    spp: int
    nan_samples: float = 0.0

    @property
    def mrays_per_sec(self) -> float:
        return (self.rays_cast / self.wall_seconds / 1e6
                if self.wall_seconds > 0 else 0.0)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Capture a ``torch.profiler`` trace into ``log_dir``/trace.json (open
    it in chrome://tracing or Perfetto) when a directory is given; a no-op
    otherwise."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
