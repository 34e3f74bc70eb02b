#!/usr/bin/env python3
"""Run phase functions of chip_smoke.py from two checkouts on one card, in
turns A, B, B, A, so that their times can be compared within one machine.

    python3 chip_compare.py DIR_A DIR_B [PHASE_FUNCTION ...]

Each turn is a process of its own, started in that checkout's directory: it
builds that checkout's kernels and calls its chip_smoke.py functions by
name (by default phase_grad, phase_main_grad, phase_bigmesh and
phase_variants: phases 7, 8, 13 and 14), whose lines it prints under the
checkout's name. A phase that fails makes the turn, and the script, fail.
Needs one CUDA card; imports nothing of JAX.
"""

import os
import subprocess
import sys
import time

DEFAULT = ("phase_grad", "phase_main_grad", "phase_bigmesh", "phase_variants")

TURN = """
import inspect, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
name, smi = cs.phase_device()
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
cs.phase_build()
for fn in sys.argv[1:]:
    phase = getattr(cs, fn)
    args = (dev, smi)[:len(inspect.signature(phase).parameters)]
    phase(*args)
"""


def main():
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    roots, fns = sys.argv[1:3], sys.argv[3:] or list(DEFAULT)
    for label, root in (("A", roots[0]), ("B", roots[1]), ("B", roots[1]), ("A", roots[0])):
        t0 = time.perf_counter()
        print(f"=== turn {label}: {os.path.abspath(root)}, {' '.join(fns)}", flush=True)
        proc = subprocess.run([sys.executable, "-c", TURN, *fns], cwd=root)
        if proc.returncode != 0:
            raise SystemExit(f"turn {label} ({root}) failed with code {proc.returncode}")
        print(f"=== turn {label}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
