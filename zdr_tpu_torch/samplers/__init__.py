"""Counter-based samplers: per-(pixel, seed, spp, sample_index) streams.

Kinds (zdr_tpu/samplers/__init__.py): "pmj02bn", "corrmj" and "lcg", at
any spp >= 1.
"""

import dataclasses

import torch

from .lcg import LCGSampler, make_lcg_sampler_xy
from .corrmj import CorrMJSampler, CorrMJSamplerP2, make_corrmj_sampler_xy
from .pmj02bn import PMJ02BNSampler, PMJ02BNSamplerP2, make_pmj02bn_sampler_xy

SAMPLERS = ("lcg", "pmj02bn", "corrmj")


def make_sampler_xy(kind: str, px, py, seed, spp: int, sample_index, bn=None):
    """Fresh sampler of `kind` at each lane's (pixel, seed, sample_index)."""
    if kind == "lcg":
        return make_lcg_sampler_xy(px, py, seed, spp, sample_index)
    if kind == "pmj02bn":
        return make_pmj02bn_sampler_xy(px, py, seed, spp, sample_index, bn)
    if kind == "corrmj":
        return make_corrmj_sampler_xy(px, py, seed, spp, sample_index)
    raise ValueError(f"unknown sampler kind: {kind!r}")


def make_sampler(kind: str, pixel, seed, spp: int, sample_index, bn=None):
    """make_sampler_xy over (N, 2) integer pixel coordinates (JAX
    samplers/__init__.py:62)."""
    return make_sampler_xy(kind, pixel[..., 0], pixel[..., 1], seed, spp, sample_index, bn)


def select_on_restart(restart, new_smp, smp):
    """where(restart, new_smp, smp) per lane over the sampler's fields that a
    restart changes (`_RESTART_VARYING`); the others (pixel, seed, spp, the
    blue-noise rows) are the same for a lane's every sample (JAX
    samplers/__init__.py:22)."""
    return dataclasses.replace(smp, **{
        f: torch.where(restart, getattr(new_smp, f), getattr(smp, f))
        for f in type(smp)._RESTART_VARYING})


def sampler_probe_plain(kind: str, spp: int, lanes, k: int, bn=None):
    """(3k, N) draws of a fresh sampler per lane: for each j, next1 then
    next2's x and y (the plain version of kernels.sampler_probe). lanes:
    (4, N) int32 px, py, seed, sample_idx."""
    seed = lanes[2].to(torch.int64)
    smp = make_sampler_xy(kind, lanes[0], lanes[1], seed, spp, lanes[3], bn)
    out = []
    for _ in range(k):
        u, smp = smp.next1()
        (ux, uy), smp = smp.next2_xy()
        out += [u, ux, uy]
    return torch.stack(out)


__all__ = [
    "SAMPLERS",
    "LCGSampler",
    "CorrMJSampler",
    "CorrMJSamplerP2",
    "PMJ02BNSampler",
    "PMJ02BNSamplerP2",
    "make_sampler",
    "make_sampler_xy",
    "select_on_restart",
    "sampler_probe_plain",
]
