#!/usr/bin/env python3
"""Where the unfused path walk and the loop route part on the flagship.

chip_smoke.py phase 21 holds the walk (scene.fused = False) against the
loop route (the path_loop / path_loop_grad kernels) on the cornell box,
pmj02bn, 512², UNFUSED_SPP spp, a 1024² material of 0.5. This study finds
the values that differ most and says why:

1. the image (seed 0): the pixel values past the golden bar (atol 2e-4,
   rtol 1e-4), or the TOP worst where none is; for each pixel, every
   sample's radiance by both routes (the loop kernel on that pixel's lane
   with its stop at 1, 2, ... spp samples; the walk's path_estimator on the
   same sampler and camera ray), the loop's plain version on the same lane
   beside the kernel, and for the sample that differs both walks bounce by
   bounce (hit point, uv, shade, shadow test, roulette draw and its q, the
   radiance added) up to the first decision that differs, with its margin;
2. the gradient (the backward's seed 1): the texels past phase 7's rtol
   1e-4, and how many of them pair with a neighbour whose difference
   cancels theirs (a tap whose stochastic corner moved one texel).

    python3 studies/unfused_flips.py [--spp 4] [--res 512] [--top 3]
        [--device cuda] [--out studies/_build/unfused_flips.json]

On the card the routes launch their kernels; with --device cpu (small
--res) every kernel's plain version runs, which checks the script. Prints
one summary line; the full record goes to --out. Imports nothing of JAX.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from zdr_tpu_torch import kernels  # noqa: E402
from zdr_tpu_torch.integrators import path as pw  # noqa: E402
from zdr_tpu_torch.integrators import path_loop as pl  # noqa: E402
from zdr_tpu_torch.integrators.path_persistent import Starter  # noqa: E402
from zdr_tpu_torch.integrators.wrapper import with_accel  # noqa: E402


def _f(x):
    return float(x) if x is not None else None


class _Spy:
    """While entered, module attribute `name` of `mod` records each call's
    arguments and result into `log` (through `keep`) and passes it on."""

    def __init__(self, mod, name, log, keep):
        self.mod, self.name, self.log, self.keep = mod, name, log, keep

    def __enter__(self):
        self.fn = getattr(self.mod, self.name)

        def wrap(*args, **kw):
            out = self.fn(*args, **kw)
            self.log.append(self.keep(args, kw, out))
            return out
        setattr(self.mod, self.name, wrap)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)


def loop_samples(tb, px, py, spp, mat, dev):
    """Each sample's radiance (3, spp) of pixel (px, py) by the loop kernel
    (the prefix sums of lanes that stop after 1..spp samples), and by its
    plain version."""
    out = {}
    for name, run in (("kernel", kernels.path_loop), ("plain", pl.render_path_loop_plain)):
        acc = []
        for stop in range(1, spp + 1):
            lanes = torch.tensor([[px], [py], [stop]], dtype=torch.int32, device=dev)
            carry = run(tb, lanes, mat, pl.init_carry(lanes), tb.n_steps)
            acc.append(carry.f[0:3, 0].double().cpu())
        acc = torch.stack(acc, 1)
        out[name] = torch.cat([acc[:, :1], acc[:, 1:] - acc[:, :-1]], 1)
    return out


def walk_samples(data, cfg, camera, px, py, spp, mat, dev):
    """Each sample's radiance (3, spp) of pixel (px, py) by the walk's
    per-sample estimator, clamped as the walk commits it."""
    coords = torch.tensor([[px, py]], dtype=torch.int32, device=dev)
    start = Starter(coords, camera, 0, cfg)
    cols = []
    for k in range(spp):
        smp, o, d = start(torch.full((1,), k, dtype=torch.int32, device=dev))
        rad = torch.stack(pw.path_estimator(data, mat, o, d, smp, cfg), 0)[:, 0]
        cols.append(torch.clamp(rad, 0.0, 1e5).double().cpu())
    return torch.stack(cols, 1)


def walk_bounces(data, cfg, camera, px, py, k, mat, dev):
    """The walk's sample k of pixel (px, py), bounce by bounce."""
    coords = torch.tensor([[px, py]], dtype=torch.int32, device=dev)
    smp, o, d = Starter(coords, camera, 0, cfg)(torch.full((1,), k, dtype=torch.int32,
                                                           device=dev))
    md, rr_d = pw.depths(cfg)
    beta, pdf_prev = pw._start(o)
    active = torch.ones_like(pdf_prev, dtype=torch.bool)
    rows = []
    for depth in range(md):
        if not bool(active[0]):
            break
        hits, occ = [], []
        with _Spy(pw, "trace_closest", hits, lambda a, kw, h: h), \
                _Spy(pw, "trace_any", occ, lambda a, kw, r: r):
            v, smp = pw.walk_one_bounce(data, mat, o, d, pdf_prev, active, smp, cfg)
        h = hits[0]
        b = tuple(beta[c] * v.bsdf_bounce[c] / torch.clamp_min(v.pdf_bounce, 1e-9)
                  for c in range(3))
        lum = pw.luminance(b)
        nee = pw.nee_term(v)
        added = [float(beta[c][0] * v.add_emit[c][0]
                       + (beta[c][0] * nee[c][0] if bool(v.nee_ok[0]) else 0.0))
                 for c in range(3)]
        active, beta = pw.next_beta(beta, v, depth, rr_d)
        p = tuple(h_o[0] + h.t[0] * h_d[0] for h_o, h_d in zip(o, d))
        rows.append({"depth": depth, "prim": int(h.prim[0]), "t": _f(h.t[0]),
                     "p": [_f(x) for x in p], "uv": [_f(x) for x in v.uv[0]],
                     "occluded": bool(occ[0][0]), "nee_ok": bool(v.nee_ok[0]),
                     "bounce_ok": bool(v.active[0]), "u_rr": _f(v.u_rr[0]),
                     "q": max(_f(lum[0]), 0.05), "alive": bool(active[0]), "added": added})
        pdf_prev = torch.where(active, v.pdf_bounce, pdf_prev)
        o, d = v.next_o, v.next_d
    return rows


def loop_bounces(tb, px, py, k, mat, dev):
    """The loop's plain version on pixel (px, py)'s lane, its sample k, step
    by step: the vertex each step shades (from the carry), its shadow test,
    the roulette's q and the radiance the step adds."""
    lanes = torch.tensor([[px], [py], [k + 1]], dtype=torch.int32, device=dev)
    carry = pl.init_carry(lanes)
    F, I = pl.F_IDX, pl.I_IDX
    rows = []
    for _ in range(tb.n_steps):
        fi, ii = carry.f[:, 0], carry.i[:, 0]
        if int(ii[I["sample_idx"]]) > k:
            break
        occ, lum = [], []
        with _Spy(pl, "occluded", occ, lambda a, kw, r: r), \
                _Spy(pl, "luminance", lum, lambda a, kw, r: r):
            nxt = pl.loop_step(carry, tb, lanes, mat)
        mine = int(ii[I["sample_idx"]]) == k and int(ii[I["in_flight"]]) == 1
        if mine:
            cur = [float(carry.f[F[f"cur_{c}"], 0]) for c in "rgb"]
            ncur = [float(nxt.f[F[f"cur_{c}"], 0]) for c in "rgb"]
            ended = int(nxt.i[I["sample_idx"], 0]) > k
            # a step that ends the sample commits cur + rad and resets cur
            added = [float(nxt.f[F[f"acc_{c}"], 0] - carry.f[F[f"acc_{c}"], 0]) - cur[j]
                     if ended else ncur[j] - cur[j] for j, c in enumerate("rgb")]
            rows.append({"depth": int(ii[I["depth"]]),
                         "p": [_f(fi[F[f"p_{a}"]]) for a in "xyz"],
                         "uv": [_f(fi[F["uv_x"]]), _f(fi[F["uv_y"]])],
                         "shade": bool(ii[I["shade"]]), "occluded": bool(occ[0][0]),
                         "u_rr": _f(fi[F["u_rr"]]), "q": max(_f(lum[0][0]), 0.05),
                         "alive": not ended and int(nxt.i[I["in_flight"], 0]) == 1,
                         "added": added})
        carry = nxt
    return rows


def first_split(walk, loop):
    """The first bounce at which the two walks' decisions differ -> a note."""
    for w, l in zip(walk, loop):
        dp = max(abs(a - b) for a, b in zip(w["p"], l["p"]))
        duv = max(abs(a - b) for a, b in zip(w["uv"], l["uv"]))
        base = f"bounce {w['depth']}: |dp| {dp:.2e}, |duv| {duv:.2e}"
        if dp > 1e-3:
            return base + " (the rays hit different places: an edge or a grazing hit)"
        if w["occluded"] != l["occluded"]:
            return base + (f", the shadow ray occluded by the walk {w['occluded']}, by the loop "
                           f"{l['occluded']}")
        if w["alive"] != l["alive"]:
            why = ""
            if w["u_rr"] == l["u_rr"] and (w["u_rr"] >= w["q"]) != (l["u_rr"] >= l["q"]):
                why = (f": the roulette draw {w['u_rr']!r} against q {w['q']!r} (walk) and "
                       f"{l['q']!r} (loop), q apart by {abs(w['q'] - l['q']):.2e}")
            return base + f", the path goes on by the walk {w['alive']}, by the loop " \
                f"{l['alive']}{why}"
        dadd = max(abs(a - b) for a, b in zip(w["added"], l["added"]))
        if dadd > 1e-3 * max(1e-6, max(abs(a) for a in l["added"])):
            return base + f", radiance added differs by {dadd:.3e} (walk {w['added']}, loop " \
                f"{l['added']})"
    if len(walk) != len(loop):
        return f"the walks take {len(walk)} and {len(loop)} bounces, every decision equal"
    return "no decision differs"


def pairing(diff, rel, past):
    """Texels past the bar whose largest channel difference a neighbour's
    (3 x 3) cancels within a quarter -> (paired, [unpaired rel err])."""
    h, w, _ = diff.shape
    ys, xs = torch.nonzero(past, as_tuple=True)
    paired, loose = 0, []
    for y, x in zip(ys.tolist(), xs.tolist()):
        c = int(diff[y, x].abs().argmax())
        a = float(diff[y, x, c])
        hit = False
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                yy, xx = y + dy, x + dx
                if (dy or dx) and 0 <= yy < h and 0 <= xx < w:
                    b = float(diff[yy, xx, c])
                    hit |= a * b < 0 and abs(a + b) <= 0.25 * max(abs(a), abs(b))
        if hit:
            paired += 1
        else:
            loose.append(float(rel[y, x]))
    return paired, loose


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spp", type=int, default=cs.UNFUSED_SPP)
    ap.add_argument("--res", type=int, default=cs.RES[0])
    ap.add_argument("--top", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "studies", "_build", "unfused_flips.json"))
    args = ap.parse_args()
    t0 = time.perf_counter()
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device(args.device)
    res, spp = (args.res, args.res), args.spp
    scene = cs._flagship(dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    images, grads = {}, {}
    for fused in ("auto", False):
        scene.fused = fused
        m = mat.clone().requires_grad_()
        img = scene.render(m, res=res, spp=spp, seed=0)
        img[..., :3].sum().backward()
        images[fused], grads[fused] = img.detach()[..., :3], m.grad.detach()
    scene.fused = "auto"
    diff = (images[False] - images["auto"]).abs()
    ratio = diff / (cs.GOLDEN_ATOL + cs.GOLDEN_RTOL * images["auto"].abs())
    n_over = int((ratio > 1).sum())
    flat = ratio.flatten()
    picks = torch.argsort(flat, descending=True)[:max(n_over, args.top)].tolist()
    pixels = sorted({((i // 3) % res[0], (i // 3) // res[0]) for i in picks})

    data = with_accel(scene._render_data("path"))
    cfg = dataclasses.replace(scene._config(res, spp), fused=False)
    tb = pl.build_loop_tables(scene._data, scene.camera, scene._config(res, spp), 0)
    rec = {"res": res, "spp": spp, "device": args.device, "image_values": diff.numel(),
           "over_golden_bar": n_over, "pixels": []}
    notes = []
    for px, py in pixels:
        loop = loop_samples(tb, px, py, spp, mat, dev)
        walk = walk_samples(data, cfg, scene.camera, px, py, spp, mat, dev)
        d_s = (walk - loop["kernel"]).abs().amax(0)
        k = int(d_s.argmax())
        wb = walk_bounces(data, cfg, scene.camera, px, py, k, mat, dev)
        lb = loop_bounces(tb, px, py, k, mat, dev)
        split = first_split(wb, lb)
        entry = {"pixel": [px, py], "walk_image": images[False][py, px].tolist(),
                 "loop_image": images["auto"][py, px].tolist(),
                 "ratio_to_bar": float(ratio[py, px].max()),
                 "samples_walk": walk.T.tolist(), "samples_loop_kernel": loop["kernel"].T.tolist(),
                 "samples_loop_plain": loop["plain"].T.tolist(),
                 "plain_equals_kernel": bool(torch.equal(loop["plain"], loop["kernel"])),
                 "sample_that_differs": k, "sample_diff": d_s.tolist(),
                 "walk_bounces": wb, "loop_bounces": lb, "split": split}
        rec["pixels"].append(entry)
        notes.append(f"({px}, {py}) x{entry['ratio_to_bar']:.1f} the bar, sample {k} "
                     f"(|d| {float(d_s[k]):.3e}; others ≤ "
                     f"{float(d_s[torch.arange(spp) != k].max()) if spp > 1 else 0.0:.1e}; plain "
                     f"loop = kernel: {entry['plain_equals_kernel']}): {split}")

    g_u, g_l = grads[False], grads["auto"]
    gd = g_u - g_l
    mag = g_l.abs().amax(-1)
    big = mag > 1e-3 * float(mag.max())
    rel = torch.where(big, gd.abs().amax(-1) / torch.clamp_min(mag, 1e-30), 0.0)
    past = big & (rel > 1e-4)
    paired, loose = pairing(gd.cpu(), rel.cpu(), past.cpu())
    rec["gradient"] = {"texels": int(big.sum()), "past_1e-4": int(past.sum()), "paired": paired,
                       "unpaired_rel": sorted(loose, reverse=True)[:50],
                       "unpaired_past_3e-4": sum(r > 3e-4 for r in loose),
                       "sums_rel": ((gd.double().sum((0, 1)) / g_l.double().sum((0, 1))).abs()
                                    .tolist())}
    rec["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    gr = rec["gradient"]
    print(f"[unfused flips] {res[0]}² {spp} spp on {args.device}: {n_over} of {diff.numel()} "
          f"image values past the golden bar; " + "; ".join(notes)
          + f"; gradient: {gr['past_1e-4']} of {gr['texels']} texels past 1e-4, {gr['paired']} "
          f"paired with a neighbour that cancels them, {gr['unpaired_past_3e-4']} unpaired past "
          f"3e-4 (largest {max(loose) if loose else 0.0:.2e}); {rec['seconds']:.1f} s; "
          f"record {os.path.relpath(args.out, ROOT)}", flush=True)


if __name__ == "__main__":
    main()
