#!/usr/bin/env python3
"""Profile flightjax_torch's step paths on one CUDA card: where the device
time goes, by kernel, and how much of the step the device is idle.

    python3 tools/profile_torch_step.py [--paths subsystems,vehicle,megakernel,
                                         xv1_subsystems,xv1_vehicle,
                                         xv1_megakernel,xv2_subsystems,
                                         xv2_vehicle,xv2_megakernel,
                                         msn_subsystems,msn_vehicle,
                                         msn_megakernel,turb_fleet,
                                         turb_vehicle,turb_megakernel,
                                         nav_fleet,nav_vehicle,
                                         nav_megakernel,
                                         xv1_turb_megakernel,
                                         sensor_fed_megakernel,
                                         xv2_turb_fleet,xv2_turb_vehicle,
                                         xv2_turb_megakernel,msn_turb_fleet,
                                         msn_turb_vehicle,
                                         msn_turb_megakernel,xv2_nav_fleet,
                                         xv2_nav_vehicle,xv2_nav_megakernel,
                                         msn_nav_fleet,msn_nav_vehicle,
                                         msn_nav_megakernel]
                                        [--batch 4096] [--steps 50]

The paths are, on the C172S flagship, `subsystems` (`fleet_rollout` over
`Simulation.fleet_step`, the five cluster kernels), `vehicle`
(`make_cluster_step(split="vehicle")`, rk4_stage x 4 + rk4_finish) and
`megakernel` (`make_megakernel_step`, one launch per step); and on the
C172Xv1 flying the turning climb with its control laws
(`testing.xv1_fleet_sim`), `xv1_subsystems` and `xv1_vehicle`, the same two
splits with the fly-by-wire kernel instances and the periodic pass (the
`ctl_laws` kernel) after every step, and `xv1_megakernel`, the fly-by-wire
megakernel with the pass inside it; and on the C172Xv2 flying the
guidance scenario (`testing.xv2_fleet_sim`: segments and circles), the
same three, `xv2_*`, with the `gdc_ctl_laws` kernel as the splits' pass
and `megakernel_gdc`; and on the mission fleet (`testing.msn_fleet_sim`:
the LOWS traffic pattern's phase machine over the C172Xv2, half the lanes
on the final approach, half cold on the runway) the same three, `msn_*`,
with the `msn_ctl_laws` kernel as the splits' pass and `megakernel_msn`;
and on the turbulent C172S fleet (`testing.turb_study_sim`: W20 = 10
m/s, the shear on every third lane, a discrete gust on every third lane)
`turb_fleet` (`fleet_rollout`, whose `Simulation.fleet_step` runs
rk4_stage_turb x 4 + rk4_finish_turb, compensated), `turb_vehicle` and
`turb_megakernel` (`megakernel_turb`); and on the joint navigation
study's fleet (`testing.nav_fleet_sim`: the turbulent C172Xv1 on its
navigation avionics, per-lane severity, dispersion and sensor grade)
`nav_fleet` (`fleet_rollout`: rk4_stage_fbw_turb x 4, rk4_finish_fbw_turb,
the navigation pass with its `systems_fbw` truth and the `ctl_laws` kernel,
`geoid` every step; the pass is the `nav_pass` kernel), `nav_vehicle` (the
vehicle split on the same), `nav_megakernel` (`megakernel_nav_turb`, the
navigation pass inside the step) and, on its truth-fed twin
(`testing.xv1_turb_fleet_sim`), `xv1_turb_megakernel`
(`megakernel_fbw_turb`); and on the sensor-fed autopilot fleet
(`testing.sensor_fed_fleet_sim`: the calm C172Xv1 on its navigation
avionics, the turning climb, lane k's sensor stream seeded k)
`sensor_fed_megakernel` (`megakernel_nav`); and the turbulent C172Xv2
(`testing.xv2_turb_fleet_sim`: the guidance scenario in the turbulent
fleet's turbulence) and a mission on it (`testing.msn_turb_fleet_sim`),
`xv2_turb_*` and `msn_turb_*` (`fleet_rollout` and the vehicle split on
rk4_stage_fbw_turb x 4, rk4_finish_fbw_turb and the pass kernel;
`megakernel_gdc_turb`, `megakernel_msn_turb`); and the loiter on estimates
(`testing.loiter_fleet_sim`: the calm sensor-fed C172Xv2 on circular
guidance over the filter's solution) `xv2_nav_fleet`, `xv2_nav_vehicle`
(rk4_stage_fbw x 4, rk4_finish_fbw, the `systems_fbw` truth, `nav_pass`,
`gdc_ctl_laws`, `geoid` every step) and `xv2_nav_megakernel`
(`megakernel_gdc_nav`); and the sensor-fed missions
(`testing.msn_nav_fleet_sim`: half the lanes on the radar-gated landing,
half on the cold-start takeoff) `msn_nav_fleet`, `msn_nav_vehicle`
(`nav_pass`'s mission instance, then `msn_nav_ctl_laws`) and
`msn_nav_megakernel` (`megakernel_msn_nav`).
For each, a warm window of
`--steps` steps runs under
`torch.profiler` (CPU and CUDA activities). Printed per path: the host-clock
ms per step of the same window run without the profiler, the device time per
step summed over every kernel and copy, the idle share 1 - device / host,
the device launches per step, and the device time per step of the costliest
kernels; then the card's name and power limit, and as the last line all of
it as one JSON object. Fails without a card.
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

PATHS = ("subsystems", "vehicle", "megakernel", "xv1_subsystems",
         "xv1_vehicle", "xv1_megakernel", "xv2_subsystems", "xv2_vehicle",
         "xv2_megakernel", "msn_subsystems", "msn_vehicle", "msn_megakernel",
         "turb_fleet", "turb_vehicle", "turb_megakernel", "nav_fleet",
         "nav_vehicle", "nav_megakernel", "xv1_turb_megakernel",
         "sensor_fed_megakernel", "xv2_turb_fleet", "xv2_turb_vehicle",
         "xv2_turb_megakernel", "msn_turb_fleet", "msn_turb_vehicle",
         "msn_turb_megakernel", "xv2_nav_fleet", "xv2_nav_vehicle",
         "xv2_nav_megakernel", "msn_nav_fleet", "msn_nav_vehicle",
         "msn_nav_megakernel")
# the fleets of the paths' prefixes, the longer first
PREFIXES = ("xv1_turb_", "xv2_turb_", "msn_turb_", "xv2_nav_", "msn_nav_",
            "xv1_", "xv2_", "msn_", "turb_", "nav_", "sensor_fed_")


def device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def stepper(path, sim, st):
    """`run(n)`: n more steps of `path` from where the last call ended."""
    from flightjax_torch.parallel.clusterstep import make_cluster_step
    from flightjax_torch.parallel.fleet import fleet_rollout
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    box = {"st": st, "i": int(st.i[0])}
    for pre in PREFIXES:
        if path.startswith(pre):
            path = path[len(pre):]
            break
    if path in ("subsystems", "fleet"):
        def run(n):
            box["st"] = fleet_rollout(sim, box["st"], n)
    elif path == "vehicle":
        box["st"] = st._replace(c=None)  # the vehicle path is uncompensated
        step = make_cluster_step(sim, box["st"], split="vehicle")

        def run(n):
            for _ in range(n):
                box["st"] = step(box["st"], i=box["i"])
                box["i"] += 1
    elif path == "megakernel":
        box["bufs"], step_packed, _ = make_megakernel_step(sim, st)

        def run(n):
            for _ in range(n):
                box["bufs"] = step_packed(box["bufs"])
    else:
        raise ValueError(f"unknown path {path!r}")
    return run


def profile(path, sim, st, steps, top):
    run = stepper(path, sim, st)
    run(10)  # build, warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    bare_ms = 1e3 * (time.perf_counter() - t0) / steps

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events only (kernels, copies), so no time counts twice
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()
            if getattr(e, "device_type", None) == cuda and device_us(e) > 0]
    if not rows:
        raise RuntimeError("the profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in rows) / 1e3 / steps
    return {
        "path": path, "host_ms_per_step": bare_ms,
        "profiled_host_ms_per_step": 1e3 * wall / steps,
        "device_ms_per_step": dev_ms, "idle_share": 1.0 - dev_ms / bare_ms,
        "launches_per_step": sum(r[2] for r in rows) / steps,
        "top": [{"name": k, "ms_per_step": us / 1e3 / steps,
                 "per_step": c / steps} for k, us, c in rows[:top]],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--paths", default=",".join(PATHS))
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seed", type=int, default=1016)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 2
    from flightjax_torch.testing import (loiter_fleet_sim, msn_fleet_sim,
                                         msn_nav_fleet_sim,
                                         msn_turb_fleet_sim, nav_fleet_sim,
                                         perturbed_fleet_sim,
                                         sensor_fed_fleet_sim, turb_study_sim,
                                         xv1_fleet_sim, xv1_turb_fleet_sim,
                                         xv2_fleet_sim, xv2_turb_fleet_sim)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    fleets = {}
    out = []
    for path in args.paths.split(","):
        kind = next((pre[:-1] for pre in PREFIXES if path.startswith(pre)),
                    "c172s")
        if kind not in fleets:
            make = {"xv1": xv1_fleet_sim, "xv2": xv2_fleet_sim,
                    "msn": msn_fleet_sim, "turb": turb_study_sim,
                    "nav": nav_fleet_sim, "xv1_turb": xv1_turb_fleet_sim,
                    "sensor_fed": lambda b, _, d, t: sensor_fed_fleet_sim(
                        b, d, t),
                    "xv2_turb": xv2_turb_fleet_sim,
                    "msn_turb": msn_turb_fleet_sim,
                    "xv2_nav": lambda b, _, d, t: loiter_fleet_sim(b, d, t),
                    "msn_nav": lambda b, _, d, t: msn_nav_fleet_sim(b, d, t),
                    "c172s": perturbed_fleet_sim}[kind]
            fleets[kind] = make(args.batch, args.seed, "cuda",
                                torch.float32)[:2]
        r = profile(path, *fleets[kind], args.steps, args.top)
        out.append(r)
        print(f"{path}: B = {args.batch}, {args.steps} steps, f32: host "
              f"{r['host_ms_per_step']:.4f} ms/step "
              f"({r['profiled_host_ms_per_step']:.4f} under the profiler), "
              f"device {r['device_ms_per_step']:.4f} ms/step, idle share "
              f"{r['idle_share']:.4f}, {r['launches_per_step']:.1f} "
              f"launches/step", flush=True)
        for t in r["top"]:
            print(f"  {t['ms_per_step']:9.4f} ms/step  {t['per_step']:6.1f}"
                  f"/step  {t['name'][:90]}", flush=True)
    print(f"card: {card}")
    print(json.dumps({"card": card, "batch": args.batch,
                      "steps": args.steps, "paths": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
