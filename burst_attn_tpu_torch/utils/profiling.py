"""Step timing (port of the StepTimer that burst_attn_tpu/utils/profiling.py
re-exports; the obs registry it also feeds is not ported)."""

import time
from typing import List, Optional

import torch


class StepTimer:
    """Wall-clock step timer that waits for the step's device work at exit:

        with timer as t:
            state, metrics = step(state, batch)
            t.watch(metrics["loss"])

    `watch` names tensors of the step; exit synchronizes the CUDA device
    they live on (CPU tensors need no wait)."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None
        self._watched = None

    def watch(self, *outputs):
        """Register the step's outputs; exit blocks until they are ready."""
        self._watched = outputs
        return outputs[0] if len(outputs) == 1 else outputs

    def __enter__(self):
        self._watched = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            if self._watched is None:
                raise RuntimeError(
                    "StepTimer: call t.watch(outputs) inside the block")
            for dev in {t.device for t in _tensors(self._watched)
                        if t.device.type == "cuda"}:
                torch.cuda.synchronize(dev)
            self.times.append(time.perf_counter() - self._t0)
        self._watched = None
        return False

    def summary(self, skip_first: int = 1) -> dict:
        """Stats over recorded steps; the first `skip_first` are dropped as
        warm-up unless that would drop every step."""
        ts = self.times[skip_first:] or self.times
        if not ts:
            return {"steps": 0, "mean_s": 0.0, "min_s": 0.0, "max_s": 0.0,
                    "p50_s": 0.0, "std_s": 0.0}
        mean = sum(ts) / len(ts)
        var = sum((t - mean) ** 2 for t in ts) / len(ts)
        return {"steps": len(ts), "mean_s": mean, "min_s": min(ts),
                "max_s": max(ts), "p50_s": sorted(ts)[len(ts) // 2],
                "std_s": var ** 0.5}


def _tensors(x):
    """Every tensor inside nested tuples/lists/dicts."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
