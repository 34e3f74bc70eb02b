"""The persistent-lane path walk, forward and PRB backward (port of
zdr_tpu/integrators/path_persistent.py).

One loop in which every lane always has work: when a lane's path ends, its
radiance is committed and the same iteration restarts the lane on its
pixel's next sample (a fresh sampler at (pixel, seed, spp, sample) and a
camera ray), so the image equals the per-sample walk's (path.py) and the
loop runs ~spp * E[path length] iterations, not spp * max_depth.

The backward cycles each lane through phase 0 (the Le replay walk) and
phase 1 (the gradient walk on the same stream, path.path_backward's
algebra), then the next sample. Its taps splat every iteration (path.splat):
the stochastic single corner (the default), the four bilinear corners, or,
under nearest filtering, the texel the forward read. With the stochastic
splat (a splat to one texel), splat_merge > 1 or packed_splat take JAX's
splat buffer
(path_persistent.py:211-242, :300-340, _SplatBuffer): a lane's taps merged
into a pending tap over each group of splat_merge iterations, a buffer of
SCATTER_BATCH rows (bf16-rounded where packed), flushed every splat_merge *
SCATTER_BATCH iterations.

The port takes one lane a pixel (JAX's lanes_per_pixel 1). Every bounce
traces through accel.trace_closest / trace_any: on the card the trace
kernels.
"""

from __future__ import annotations

import torch

from ..camera import camera_const, camera_ray
from ..microfacet import ggx_shade_vjp
from ..samplers import make_sampler, select_on_restart
from ..samplers.hashes import lcg_step, lcg_to_unit_float
from ..samplers.pmj02bn import bluenoise
from ..texture import (SPLAT_BATCH, nearest_ids, reservoir_merge_taps, scatter_add4,
                       stochastic_corner_ids)
from ..vec import div
from .path import (apply_rr, bilinear_of, depths, nee_term, next_beta, splat, stochastic_of,
                   walk_one_bounce)

RADIANCE_CLAMP = 1e5


class Starter:
    """Fresh samplers and camera rays of (pixel, seed, spp, sample)
    (path_persistent.py:41)."""

    def __init__(self, coords, camera, seed: int, cfg):
        self.coords, self.seed, self.cfg = coords, seed, cfg
        self.cam = camera_const(camera).to(coords.device)
        self.bn = bluenoise(coords.device) if cfg.sampler == "pmj02bn" else None

    def __call__(self, sample_idx):
        cfg = self.cfg
        smp = make_sampler(cfg.sampler, self.coords, self.seed, cfg.spp, sample_idx, self.bn)
        (u0, u1), smp = smp.next2_xy()
        o, d = camera_ray(self.cam, self.coords[:, 0], self.coords[:, 1], u0, u1, cfg.res,
                          cfg.use_tent_filter)
        return smp, o, d


def _sel(mask, a, b):
    return tuple(torch.where(mask, x, y) for x, y in zip(a, b))


def render_path_persistent(data, material, camera, seed: int, cfg, coords) -> torch.Tensor:
    """spp-averaged radiance of the pixels coords (N, 2) -> (N, 3)."""
    md, rr_d = depths(cfg)
    n, dev = coords.shape[0], coords.device
    start = Starter(coords, camera, seed, cfg)
    sample_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    smp, o, d = start(sample_idx)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    acc = cur = (zero, zero, zero)
    beta = (zero + 1.0, zero + 1.0, zero + 1.0)
    pdf_prev = zero + 1e30
    depth = torch.zeros_like(sample_idx)
    for _ in range((cfg.spp + 1) * md + md):
        lane_live = sample_idx < cfg.spp
        if not bool(lane_live.any()):
            break
        v, smp = walk_one_bounce(data, material, o, d, pdf_prev, lane_live, smp, cfg)
        nee = nee_term(v)
        cur = tuple(cur[c] + beta[c] * v.add_emit[c] for c in range(3))
        cur = tuple(cur[c] + torch.where(v.nee_ok, beta[c] * nee[c], 0.0) for c in range(3))
        alive, beta_next = next_beta(beta, v, depth, rr_d)
        alive = alive & (depth + 1 < md)

        # a path that ends commits its sample (NaN guard and clamp) and the
        # lane restarts on its next one
        terminated = lane_live & ~alive
        good = ~(torch.isnan(cur[0]) | torch.isnan(cur[1]) | torch.isnan(cur[2]))
        acc = tuple(acc[c] + torch.where(terminated & good,
                                         torch.clamp(cur[c], 0.0, RADIANCE_CLAMP), 0.0)
                    for c in range(3))
        sample_idx = sample_idx + terminated.to(torch.int32)
        new_smp, new_o, new_d = start(sample_idx)
        restart = terminated & (sample_idx < cfg.spp)
        o = _sel(restart, new_o, _sel(alive, v.next_o, o))
        d = _sel(restart, new_d, _sel(alive, v.next_d, d))
        smp = select_on_restart(restart, new_smp, smp)
        cur = tuple(torch.where(terminated, 0.0, x) for x in cur)
        beta = tuple(torch.where(terminated, 1.0, x) for x in beta_next)
        pdf_prev = torch.where(terminated, 1e30, torch.where(alive, v.pdf_bounce, pdf_prev))
        depth = torch.where(terminated, 0, depth + 1)
    return div(torch.stack(acc, dim=1), float(cfg.spp))


class _SplatBuffer:
    """The JAX walk's splat buffer (path_persistent.py:211-242, :300-340,
    texture.py:265-319): SCATTER_BATCH rows of each lane's (id, 4 channels),
    rounded to bf16 at emission where packed; with merge > 1 a pending tap a
    lane, into which each iteration's tap is reservoir-merged (u_m from the
    salt's next LCG state), rewritten into the slot of its group and reset
    at the group's end; a flush every merge * SCATTER_BATCH iterations, and
    one at the end, adds the rows' per-texel totals (rounded to bf16 where
    packed) to the gradient."""

    def __init__(self, n: int, n_bins: int, merge: int, packed: bool, dev):
        self.n_bins, self.merge, self.packed = n_bins, merge, packed
        self.ids = torch.full((SPLAT_BATCH, n), n_bins, dtype=torch.int64, device=dev)
        self.vals = torch.zeros((SPLAT_BATCH, n, 4), dtype=torch.float32, device=dev)
        zero = torch.zeros((n,), dtype=torch.float32, device=dev)
        self.pend0 = (self.ids[0].clone(), zero, zero, zero, zero)
        self.pend = self.pend0

    def add(self, d_mat, it: int, ids, grads, salt):
        """Iteration it's taps, (N,) ids and 4 (N,) channels -> d_mat."""
        tap = (ids, *grads)
        slot, batch = it % SPLAT_BATCH, SPLAT_BATCH
        if self.merge > 1:
            u_m = lcg_to_unit_float(lcg_step(salt))
            tap = reservoir_merge_taps(self.pend, tap, u_m, self.n_bins)
            group_end = it % self.merge == self.merge - 1
            self.pend = self.pend0 if group_end else tap
            slot, batch = (it // self.merge) % SPLAT_BATCH, self.merge * SPLAT_BATCH
        self.ids[slot] = tap[0]
        self.vals[slot] = torch.stack(tap[1:], 1)
        if it % batch == batch - 1:
            return self.flush(d_mat)
        return d_mat

    def flush(self, d_mat):
        """d_mat plus the buffer's per-texel totals; the buffer emptied."""
        h, w = d_mat.shape[0], d_mat.shape[1]
        add = scatter_add4(self.ids.reshape(-1), self.vals.reshape(-1, 4), self.n_bins,
                           packed=self.packed, prepacked=self.packed)
        self.ids.fill_(self.n_bins)
        self.vals.zero_()
        return d_mat + add.reshape(h, w, 4)


def render_path_backward_persistent(data, material, camera, seed: int, cfg, coords,
                                    le_grad) -> torch.Tensor:
    """PRB texture gradient of the pixels coords (N, 2), given their (N, 3)
    per-sample adjoint -> d_material (H, W, 4)."""
    md, rr_d = depths(cfg)
    n, dev = coords.shape[0], coords.device
    material = material.detach()
    start = Starter(coords, camera, seed, cfg)
    stochastic, bilinear = stochastic_of(cfg), bilinear_of(cfg)
    d_mat = torch.zeros_like(material)
    lg_in = tuple(le_grad[:, c] for c in range(3))
    sample_idx = torch.zeros((n,), dtype=torch.int32, device=dev)
    smp, o, d = start(sample_idx)
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    cur = le_rem = (zero, zero, zero)
    beta = (zero + 1.0, zero + 1.0, zero + 1.0)
    pdf_prev = zero + 1e30
    depth = torch.zeros_like(sample_idx)
    phase = torch.zeros_like(sample_idx)  # 0: the Le walk, 1: the gradient walk
    gok = torch.ones((n,), dtype=torch.bool, device=dev)  # False once Le was NaN
    h, w = material.shape[0], material.shape[1]
    buf = None
    if stochastic and (cfg.splat_merge > 1 or cfg.packed_splat):
        buf = _SplatBuffer(n, h * w, max(int(cfg.splat_merge), 1), bool(cfg.packed_splat), dev)
    for it in range(2 * (cfg.spp + 1) * md + 2 * md):
        lane_live = sample_idx < cfg.spp
        if not bool(lane_live.any()):
            break
        in_le = phase == 0
        in_grad = lane_live & ~in_le
        v, smp = walk_one_bounce(data, material, o, d, pdf_prev, lane_live, smp, cfg)

        # phase 0: accumulate Le
        dif = (v.mat[:, 0], v.mat[:, 1], v.mat[:, 2])
        b_nee, b_bounce, vjp = ggx_shade_vjp(v.wo_local, v.wi_nee_local, v.wi_bounce_local,
                                             dif, v.mat[:, 3])
        nee_w = tuple(v.nee_weight * v.nee_light_eval[c] for c in range(3))
        nee_contrib = tuple(beta[c] * v.bsdf_nee[c] * nee_w[c] for c in range(3))
        cur = tuple(cur[c] + torch.where(in_le, beta[c] * v.add_emit[c], 0.0) for c in range(3))
        cur = tuple(cur[c] + torch.where(in_le & v.nee_ok, nee_contrib[c], 0.0)
                    for c in range(3))

        # phase 1: take this vertex's terms from le_rem, inject the adjoints
        le_rem = tuple(le_rem[c] - torch.where(in_grad, beta[c] * v.add_emit[c], 0.0)
                       for c in range(3))
        le_rem = tuple(le_rem[c] - torch.where(in_grad & v.nee_ok, nee_contrib[c], 0.0)
                       for c in range(3))
        ct_nee = tuple(torch.where(in_grad & v.nee_ok & gok, beta[c] * nee_w[c] * lg_in[c], 0.0)
                       for c in range(3))
        ct_bounce = tuple(
            torch.where(in_grad & v.active & gok & (b_bounce[c] > 1e-8),
                        le_rem[c] / torch.clamp_min(b_bounce[c], 1e-8) * lg_in[c], 0.0)
            for c in range(3))
        grads = vjp((ct_nee, ct_bounce))
        on = in_grad & (v.nee_ok | v.active)
        if buf is None:
            d_mat = splat(d_mat, v.uv, grads, on, smp.salt(), stochastic, bilinear)
        else:
            salt = smp.salt()
            if bilinear:
                ids = stochastic_corner_ids(v.uv, lcg_to_unit_float(salt), h, w)
            else:
                ids = nearest_ids(v.uv[:, 0], v.uv[:, 1], h, w)
            ids = torch.where(on, ids, h * w)
            grads = tuple(torch.where(on & ~torch.isnan(g), g, 0.0) for g in grads)
            d_mat = buf.add(d_mat, it, ids, grads, salt)

        # continuation or termination
        inv_pdf = 1.0 / torch.clamp_min(v.pdf_bounce, 1e-9)
        b = tuple(beta[c] * v.bsdf_bounce[c] * inv_pdf for c in range(3))
        alive, rr = apply_rr(depth, b, v.active, v.u_rr, rr_d)
        alive = alive & (depth + 1 < md)
        terminated = lane_live & ~alive
        end_le = terminated & in_le
        end_grad = terminated & ~in_le
        le_ok = ~(torch.isnan(cur[0]) | torch.isnan(cur[1]) | torch.isnan(cur[2]))

        # a lane that ends its Le walk replays the same sample's stream; one
        # that ends its gradient walk starts the next sample
        sample_idx = sample_idx + end_grad.to(torch.int32)
        phase = torch.where(end_le, 1, torch.where(end_grad, 0, phase))
        new_smp, new_o, new_d = start(sample_idx)
        restart = terminated & (sample_idx < cfg.spp)
        o = _sel(restart, new_o, _sel(alive, v.next_o, o))
        d = _sel(restart, new_d, _sel(alive, v.next_d, d))
        smp = select_on_restart(restart, new_smp, smp)
        le_rem = tuple(torch.where(end_le, torch.where(le_ok, cur[c], 0.0), le_rem[c])
                       for c in range(3))
        cur = tuple(torch.where(terminated, 0.0, x) for x in cur)
        gok = torch.where(end_le, le_ok, gok)
        beta = tuple(torch.where(terminated, 1.0, torch.where(alive, b[c] * rr, beta[c]))
                     for c in range(3))
        pdf_prev = torch.where(terminated, 1e30, torch.where(alive, v.pdf_bounce, pdf_prev))
        depth = torch.where(terminated, 0, depth + 1)
    return d_mat if buf is None else buf.flush(d_mat)
