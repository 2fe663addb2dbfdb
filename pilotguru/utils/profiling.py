"""Per-stage wall-time reporting + JAX profiler hooks.

The reference has no tracing at all (SURVEY.md section 5: plain -O3 builds,
only per-epoch throughput logs in Python). Here observability is
first-class: pipelines wrap their phases in ``StageTimer`` scopes, and
setting PILOTGURU_PROFILE_DIR captures a full JAX/XLA profiler trace
(viewable in TensorBoard / Perfetto) around any timed region.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List

PROFILE_DIR_ENV = "PILOTGURU_PROFILE_DIR"


@dataclass
class StageTimer:
    """Accumulates wall time per named stage.

    Usage:
        timer = StageTimer("fit_motion")
        with timer.stage("solve"):
            ...
        timer.report()
    """

    name: str
    stages: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    order: List[str] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, stage_name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            if stage_name not in self.stages:
                self.order.append(stage_name)
                self.stages[stage_name] = 0.0
                self.counts[stage_name] = 0
            self.stages[stage_name] += elapsed
            self.counts[stage_name] += 1

    def total_seconds(self) -> float:
        return sum(self.stages.values())

    def as_dict(self) -> Dict[str, float]:
        return {k: self.stages[k] for k in self.order}

    def report(self, out=None) -> str:
        lines = [f"[{self.name}] stage wall times:"]
        total = self.total_seconds()
        for stage_name in self.order:
            seconds = self.stages[stage_name]
            count = self.counts[stage_name]
            share = 100.0 * seconds / total if total > 0 else 0.0
            lines.append(
                f"  {stage_name:<24} {seconds * 1e3:10.1f} ms"
                f"  ({share:5.1f}%)  x{count}"
            )
        lines.append(f"  {'total':<24} {total * 1e3:10.1f} ms")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text

    def write_jsonl(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(
                json.dumps(
                    {
                        "name": self.name,
                        "stages": self.as_dict(),
                        "counts": dict(self.counts),
                        "total_sec": self.total_seconds(),
                    }
                )
                + "\n"
            )


@contextlib.contextmanager
def maybe_jax_profiler_trace(region_name: str = "pilotguru"):
    """Capture a JAX profiler trace when PILOTGURU_PROFILE_DIR is set."""
    profile_dir = os.environ.get(PROFILE_DIR_ENV)
    if not profile_dir:
        yield
        return
    import jax

    target = os.path.join(profile_dir, region_name)
    os.makedirs(target, exist_ok=True)
    with jax.profiler.trace(target):
        yield
