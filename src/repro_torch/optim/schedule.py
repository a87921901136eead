"""LR schedules. The paper uses constant lr 1e-6 with 0 warmup (Table 7);
warmup-cosine provided for general use. The port of
``src/repro/optim/schedule.py``: plain floats of the step."""
from __future__ import annotations

import math


def constant(lr: float):
    return lambda step: float(lr)


def warmup_cosine(lr: float, warmup: int, total: int, floor: float = 0.1):
    def fn(step):
        step = float(step)
        warm = lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog)))
        return warm if step < warmup else cos
    return fn
