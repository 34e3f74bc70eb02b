"""Timing / observability helpers (port of zdr_tpu/profiling.py): a device
timer and a small structured run logger for optimization loops.

A CUDA launch returns before the device finishes, so a host clock around it
measures the enqueue: `device_time` times a call on the card by CUDA events
around the calls (synchronising after the last), on the CPU by the host
clock.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Callable, Dict, Optional

import torch


def _device_of(out) -> torch.device:
    """The device of the first tensor in a call's result (a tensor, or one
    in a tuple, list or dict), the CPU where there is none."""
    if isinstance(out, torch.Tensor):
        return out.device
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _device_of(x)
            if dev.type != "cpu":
                return dev
    return torch.device("cpu")


def device_time(fn: Callable, *args, iters: int = 5, warmup: int = 1, **kwargs) -> float:
    """Average seconds per call of fn(*args, **kwargs) after `warmup` calls
    (at least 1), on the device of the warm-up's result: CUDA events on a
    CUDA device, the host clock on the CPU."""
    if warmup < 1:
        raise ValueError("device_time needs a warm-up call to find the result's device")
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    dev = _device_of(out)
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                fn(*args, **kwargs)
            end.record()
            end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return (time.perf_counter() - t0) / iters


class RunLogger:
    """Structured per-iteration logging (jsonl) for optimization loops: a
    record {"step", "t" (seconds since the logger started), the metrics}
    a logged step, to `path` or, without one, to stderr."""

    def __init__(self, path: Optional[str] = None, every: int = 1):
        self.path = path
        self.every = every
        self._fh = open(path, "a") if path else None
        self._t0 = time.perf_counter()

    def log(self, step: int, **metrics: Any) -> None:
        if step % self.every:
            return
        rec: Dict[str, Any] = {
            "step": step,
            "t": round(time.perf_counter() - self._t0, 3),
        }
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        line = json.dumps(rec)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()
        else:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh:
            self._fh.close()
