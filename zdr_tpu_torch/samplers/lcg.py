"""Hash-seeded LCG sampler (port of zdr_tpu/samplers/lcg.py).

State is a uint32 (held as int64) per lane; `next1` / `next2_xy` return
(value, new_sampler).
"""

from __future__ import annotations

import dataclasses

import torch

from .hashes import lcg_step, lcg_to_unit_float, mul32, u32, xxhash32_4

SALT = 0x5F356495


@dataclasses.dataclass(frozen=True)
class LCGSampler:
    state: torch.Tensor  # uint32 as int64
    _RESTART_VARYING = ("state",)

    def next1(self):
        s = lcg_step(self.state)
        return lcg_to_unit_float(s), LCGSampler(s)

    def salt(self) -> torch.Tensor:
        """Per-lane uint32 that varies each bounce, for side-channel draws
        (the gradient's splat corner) that must not advance the stream."""
        return self.state ^ SALT

    def next2_xy(self):
        s1 = lcg_step(self.state)
        s2 = lcg_step(s1)
        return (lcg_to_unit_float(s1), lcg_to_unit_float(s2)), LCGSampler(s2)


def lcg_fresh_state(px, py, seed, sample_index) -> torch.Tensor:
    """State of a fresh sampler at (pixel, seed, sample_index)."""
    mixed = u32(seed) ^ mul32(u32(sample_index), 987654347)
    return xxhash32_4(px, py, mixed, 0x9E3779B9)


def make_lcg_sampler_xy(px, py, seed, spp: int, sample_index) -> LCGSampler:
    """px/py: int tensors; seed and sample_index ints or tensors like px."""
    state = lcg_fresh_state(px, py, seed, torch.as_tensor(sample_index, device=px.device))
    return LCGSampler(state.expand(px.shape))
