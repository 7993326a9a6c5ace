"""The JAX package's joint navigation study at a fleet's size, as the
reference for `chip_smoke.py`'s run of the port's.

Runs `flightjax/demos/estimation_demos.py::joint_navigation_study` on the
CPU in float32 (JAX's default precision, whose draws the port's float32
draws equal) with the study's key PRNGKey(0x17A), and writes the peaks'
quantiles, the exceedance fractions and the alarm fractions as JSON
(default `tools/jax_nav_study.json`, which `chip_smoke.py` reads):

    python tools/jax_nav_study.py [--lanes 4096] [--t-end 30] [--out FILE]

Takes minutes on a CPU at 4096 lanes.
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

from flightjax.demos import estimation_demos as D  # noqa: E402

ATT_THRESHOLDS = (0.5, 1.0, 2.0, 5.0)
POS_THRESHOLDS = (2.0, 5.0, 10.0, 25.0)


def summary(peak_att, peak_pos, att_exc, pos_exc, alarm):
    """The record's numbers of one study run (numpy inputs)."""
    att = np.asarray(peak_att, np.float64)
    pos = np.asarray(peak_pos, np.float64)
    return {"att_p50": float(np.percentile(att, 50.0)),
            "att_p95": float(np.percentile(att, 95.0)),
            "att_max": float(att.max()),
            "pos_p50": float(np.percentile(pos, 50.0)),
            "pos_p95": float(np.percentile(pos, 95.0)),
            "pos_max": float(pos.max()),
            "att_exceedance": [float(f) for f in np.asarray(att_exc)],
            "pos_exceedance": [float(f) for f in np.asarray(pos_exc)],
            "alarm_fraction": {k: float(v) for k, v in alarm.items()}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=4096)
    ap.add_argument("--t-end", type=float, default=30.0)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "tools", "jax_nav_study.json"))
    args = ap.parse_args()
    t0 = time.time()
    r = D.joint_navigation_study(n_lanes=args.lanes, t_end=args.t_end,
                                 att_thresholds=ATT_THRESHOLDS,
                                 pos_thresholds=POS_THRESHOLDS,
                                 key=jax.random.PRNGKey(0x17A))
    out = {"lanes": args.lanes, "t_end": args.t_end, "key": 0x17A,
           "dtype": str(np.asarray(r["peak_att_deg"]).dtype),
           "att_thresholds": list(ATT_THRESHOLDS),
           "pos_thresholds": list(POS_THRESHOLDS),
           **summary(r["peak_att_deg"], r["peak_pos_m"],
                     r["att_exceedance"], r["pos_exceedance"],
                     r["alarm_fraction"]),
           "wall_s": time.time() - t0}
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
