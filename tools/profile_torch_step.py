#!/usr/bin/env python3
"""Profile flightjax_torch's flagship fleet step on one CUDA card: where the
device time goes, by kernel, and how much of the step the device is idle.

    python3 tools/profile_torch_step.py [--batch 4096] [--steps 50]

A warm window of `--steps` steps of `fleet_rollout` runs under
`torch.profiler` (CPU and CUDA activities). Printed: the card's name and
power limit, the host-clock ms per step of the same window run without the
profiler, the device time per step summed over every kernel and copy, the
idle share 1 - device / host, and the device time per step of the costliest
kernels. The last line is the same as
one JSON object. Fails without a card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=1016)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    from flightjax_torch.parallel.fleet import fleet_rollout
    from flightjax_torch.testing import perturbed_fleet_sim

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    sim, st = perturbed_fleet_sim(args.batch, args.seed, "cuda",
                                  torch.float32)
    st = fleet_rollout(sim, st, 10)  # build, warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fleet_rollout(sim, st, args.steps)
    torch.cuda.synchronize()
    bare_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fleet_rollout(sim, st, args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies), so no time counts twice
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda and device_us(e) > 0]
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    host_ms = 1e3 * wall / args.steps
    dev_ms = sum(r[1] for r in rows) / 1e3 / args.steps
    print(f"card: {card}")
    print(f"B = {args.batch}, {args.steps} steps, f32: host {bare_ms:.4f} "
          f"ms/step ({host_ms:.4f} under the profiler), device {dev_ms:.4f} "
          f"ms/step, idle share {1.0 - dev_ms / bare_ms:.4f}")
    for key, us, count in rows[:args.top]:
        print(f"  {us / 1e3 / args.steps:9.4f} ms/step  "
              f"{count / args.steps:6.1f}/step  {key[:90]}")
    print(json.dumps({
        "card": card, "batch": args.batch, "steps": args.steps,
        "host_ms_per_step": bare_ms, "profiled_host_ms_per_step": host_ms,
        "device_ms_per_step": dev_ms, "idle_share": 1.0 - dev_ms / bare_ms,
        "launches_per_step": sum(r[2] for r in rows) / args.steps,
        "top": [{"name": k, "ms_per_step": us / 1e3 / args.steps,
                 "per_step": c / args.steps} for k, us, c in rows[:args.top]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
