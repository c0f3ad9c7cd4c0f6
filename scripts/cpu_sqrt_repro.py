#!/usr/bin/env python3
"""A fresh process's first multi-threaded float32 `torch.sqrt` on the CPU,
against numpy's correctly rounded sqrt, in many processes under load.

    python3 scripts/cpu_sqrt_repro.py [--procs 24] [--burners 4]

Each child draws the same 48,010 float32 values (27 % zeros, the rest
squares of normals scaled like an Adam second moment), sets 8 threads,
calls `torch.sqrt` once and counts the results that differ from numpy's.
`--burners` processes keep the CPU busy with matmuls meanwhile. Prints
one JSON line per child and a summary: torch's own sqrt differs from
numpy's by at most an ulp (1.2e-7 relative) in a few hundred results;
a child whose worst error is far past that is the fault this script
reproduces. Nothing of the repository is imported.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

CHILD = r"""
import json, numpy as np, torch
torch.set_num_threads(8)
rng = np.random.default_rng(0)
n = 48010
x = np.where(rng.random(n) < 0.27, 0,
             (rng.standard_normal(n) * 1e-3) ** 2 * 1e-3).astype(np.float32)
got = torch.sqrt(torch.from_numpy(x).clone()).numpy()
want = np.sqrt(x)
bad = got != want
rel = float((abs(got[bad] - want[bad]) / want[bad]).max()) if bad.any() else 0.0
print(json.dumps({"differ": int(bad.sum()), "max_rel": rel}))
"""

BURN = r"""
import time, torch
torch.set_num_threads(8)
a = torch.randn(512, 512)
t = time.time()
while time.time() - t < %f:
    a = torch.tanh(a @ a)
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=24)
    ap.add_argument("--burners", type=int, default=4)
    ap.add_argument("--burn-s", type=float, default=25.0)
    args = ap.parse_args()
    burners = [subprocess.Popen([sys.executable, "-c", BURN % args.burn_s])
               for _ in range(args.burners)]
    time.sleep(2)
    kids = [subprocess.Popen([sys.executable, "-c", CHILD],
                             stdout=subprocess.PIPE, text=True)
            for _ in range(args.procs)]
    results = [json.loads(k.communicate()[0]) for k in kids]
    for b in burners:
        b.wait()
    for r in results:
        print(json.dumps(r))
    import torch
    faulty = [r for r in results if r["max_rel"] > 1e-6]
    print(json.dumps({"torch": torch.__version__, "threads": 8,
                      "values": 48010, "procs": args.procs,
                      "burners": args.burners, "faulty_procs": len(faulty),
                      "worst_rel": max(r["max_rel"] for r in results)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
