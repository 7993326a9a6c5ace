"""The JAX package's gust-load study at a fleet's size, as the reference
for `chip_smoke.py`'s run of the port's.

Runs `flightjax/demos/c172_demos.py::turbulent_fleet_loads` on the CPU in
float32 (JAX's default precision, whose `monte_carlo_c172` draws the
port's float32 draws equal), at the given batch, and writes the peaks'
summary and exceedance fractions as JSON (default
`tools/jax_turbulent_loads.json`, which `chip_smoke.py` reads):

    python tools/jax_turbulent_loads.py [--batch 4096] [--t-end 60]
                                        [--W20 10] [--seed 0] [--out FILE]

Takes a few minutes on a CPU at batch 4096.
"""

import argparse
import json
import os
import sys
import time

import jax
import numpy as np

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from flightjax.demos import c172_demos as D  # noqa: E402

THRESHOLDS = (1.5, 2.0, 2.5)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=60.0)
    ap.add_argument("--W20", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tools", "jax_turbulent_loads.json"))
    args = ap.parse_args()
    t0 = time.time()
    final, peaks, frac = D.turbulent_fleet_loads(
        batch=args.batch, t_end=args.t_end, W20=args.W20,
        thresholds=THRESHOLDS, seed=args.seed)
    dtype = str(np.asarray(peaks).dtype)
    peaks = np.asarray(peaks, np.float64)
    out = {"batch": args.batch, "t_end": args.t_end, "W20": args.W20,
           "seed": args.seed, "dtype": dtype,
           "thresholds": list(THRESHOLDS),
           "exceedance": [float(f) for f in np.asarray(frac)],
           "median": float(np.median(peaks)), "max": float(peaks.max()),
           "min": float(peaks.min()),
           "above_5": int((peaks >= 5.0).sum()),
           "terminated": int(np.asarray(final.s["terminated"]).sum()),
           "wall_s": time.time() - t0}
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
