#!/usr/bin/env python3
"""The BVH env forward of the path integrator (path_loop_env_bvh) at blocks
of 64, 128 and 256 threads, on sphere meshes of several sizes under two
scene layouts, on one CUDA card: which block wins, and whether the choice
follows the size of the tree or the layout.

    python3 studies/env_block.py [OUT.json]

The layouts (512x512, 64 spp, a 1024^2 material of 0.5, the render at
seed 0, the BVH):
  env_scene   tools/bench_round3.py's (chip_smoke._env_scene): a uv sphere
              of 0.6 under make_test_envmap(128, 256), its camera, no light
              triangle; much of the image is the envmap;
  big mesh    tools/bench_bigmesh.py's (chip_smoke._bigmesh): a uv sphere of
              0.5 and a 2-triangle quad light of 40 under
              make_test_envmap(256, 512), its camera; the sphere fills most
              of the image.
Each layout's sphere at n_lat x n_lon of 16 x 32 (960 triangles, the
env_scene's), 40 x 80, 80 x 160 and 160 x 160 (50,880, the big mesh's).
Each block is timed in turns 256, 128, 64, 64, 128, 256 (CUDA events, the
median of 5 after a warm-up each turn), and its carry held bit for bit
against the first block's; the launch is kernels.loop_launch with the
block given. Prints, for each scene, the tree's bytes (nodes and rows),
tests and node visits a sample, and the times; writes them to OUT.json (by
default studies/_build/env_block.json). Imports nothing of JAX.
"""

import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BLOCKS = (256, 128, 64)
MESHES = ((16, 32), (40, 80), (80, 160), (160, 160))


def scene_of(layout, n_lat, n_lon, dev):
    """The layout's scene with its sphere at n_lat x n_lon."""
    import zdr_tpu_torch as zt
    from zdr_tpu_torch.envmap import make_test_envmap
    from zdr_tpu_torch.geometry.procedural import make_quad, make_uv_sphere

    if layout == "env_scene":
        models = [(make_uv_sphere(0.6, n_lat=n_lat, n_lon=n_lon), None, None)]
        camera, env = zt.Camera(fov=0.9, origin=(0.0, 0.3, 2.0), target=(0.0, 0.0, 0.0)), 128
    else:
        models = [(make_uv_sphere(0.5, n_lat=n_lat, n_lon=n_lon), None, None),
                  (make_quad(size=1.0, y=-2.0), None, 40.0)]
        camera, env = zt.Camera(fov=0.8, origin=(1.5, 0.2, 0.0), target=(0.0, 0.0, 0.0)), 256
    scene = zt.Scene(models, "path", accel="bvh", device=dev)
    scene.camera = camera
    scene.add_envmap(make_test_envmap(env, 2 * env))
    return scene


def main():
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from zdr_tpu_torch import kernels
    from zdr_tpu_torch.integrators import path_loop as pl

    _name, smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lib = kernels.load_library()
    lanes = pl.pixel_lanes(cs.RES, cs.SPP, dev)
    mat = torch.full((cs.TEX, cs.TEX, 4), 0.5, dtype=torch.float32, device=dev)
    n_samples = lanes.shape[1] * cs.SPP
    out = {"card": smi, "scenes": {}}
    for layout in ("env_scene", "big mesh"):
        for n_lat, n_lon in MESHES:
            scene = scene_of(layout, n_lat, n_lon, dev)
            data = scene._render_data("path")
            tb = pl.build_loop_tables(data, scene.camera, scene._config(cs.RES, cs.SPP), 0)
            tree = (tb.bvh.nodes.numel() + tb.bvh.geom.numel()) * 4
            runs, ref, counts = {b: [] for b in BLOCKS}, None, None
            for b in BLOCKS + BLOCKS[::-1]:
                def fwd(b=b):
                    return kernels.loop_launch(lib, tb, lanes, mat, pl.init_carry(lanes),
                                               tb.n_steps, block=b)
                carry, c, plan = fwd()
                if plan["block"] != b:
                    raise AssertionError(f"asked for {b} threads a block, got {plan}")
                if ref is None:
                    ref, counts = carry, c.tolist()
                elif not (torch.equal(carry.f, ref.f) and torch.equal(carry.i, ref.i)):
                    raise AssertionError(f"{layout} {n_lat}x{n_lon}: block {b}'s carry differs")
                runs[b].append(cs._event_ms(fwd)[0])
            row = {"rows": tb.bvh.geom.shape[0], "nodes": tb.bvh.nodes.shape[0],
                   "tree_bytes": tree, "tests_a_sample": counts[0] / n_samples,
                   "visits_a_sample": counts[1] / n_samples, "ms": runs}
            out["scenes"][f"{layout} {n_lat}x{n_lon}"] = row
            print(f"[env block] {layout} sphere {n_lat}x{n_lon}: {row['rows']} rows, {row['nodes']} "
                  f"nodes, {tree} bytes, "
                  f"{row['tests_a_sample']:.2f} tests and {row['visits_a_sample']:.2f} visits "
                  f"a sample; path_loop_env_bvh ms by block (two turns): "
                  + ", ".join(f"{b}: {v[0]:.4f}, {v[1]:.4f}" for b, v in runs.items())
                  + f"; card {smi}", flush=True)
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "_build", "env_block.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
