#!/usr/bin/env python3
"""Build flightjax_torch's CUDA kernels and drive its step paths on one
NVIDIA card: the C172S flagship's three, the C172Xv1 autopilot's three,
the C172Xv2 guidance's three, the scripted missions' three, the
turbulent Monte Carlo fleet's three, the sensor-fed navigation fleet's
four, the sensor-fed autopilot fleet's megakernel, the C172Xv2's last
three megakernels (in turbulence, a mission on it, the loiter on
estimates), the sensor-fed missions' three, the sensor-fed C172Xv2's
and missions' six in turbulence and the C172Xv1 with a second-order
elevator's two; exit non-zero if any phase fails.

    python3 chip_smoke.py

The paths, each an entry point a user calls:
- `subsystems`: `Simulation.fleet_step` through `parallel/fleet.py::
  fleet_rollout`, five cluster kernels per step (kinair, systems, dynamics
  x 4 stages; finish_kin, finish_sys) and the `geoid` kernel on every 128th
  step, Kahan-compensated position in float32;
- `vehicle`: `make_cluster_step(split="vehicle")`, rk4_stage x 4 and
  rk4_finish per step and `geoid` on every 128th step, uncompensated as the
  JAX vehicle path is;
- `megakernel`: `make_megakernel_step`, the whole `Simulation.step` (geoid
  refreshed every step, compensated) in one launch on a state resident on
  the card;
- `xv1_subsystems`, `xv1_vehicle`, `xv1_megakernel`: the same three entry
  points on the fly-by-wire C172Xv1 flying the turning climb with its
  gain-scheduled control laws (`LON_EAS_CLM` at EAS 45 m/s and 1.5 m/s
  climb, `LAT_CHI_BETA` onto course pi / 2), through the fly-by-wire
  instances of the systems kernels (`systems_fbw`, `finish_sys_fbw`;
  `rk4_stage_fbw`, `rk4_finish_fbw`) with the periodic pass after every
  step (dt = periodic_dt = 0.02 s) as the `ctl_laws` kernel on what the
  finish kernels store, and `megakernel_fbw`, the whole step with the pass
  inside it;
- `xv2_subsystems`, `xv2_vehicle`, `xv2_megakernel`: the same three entry
  points on the C172Xv2 flying its guidance scenario (`testing.
  xv2_fleet_sim`: half the lanes on segments due east through the trim
  point, shifted by up to 400 m, half on a 1500 m circle 2 km north of it,
  either way round, a few lanes computing their guidance without engaging
  it), with the `gdc_ctl_laws` kernel as the splits' pass (the guidance,
  then the control laws on the requests it overrides) and
  `megakernel_gdc`, the whole step with that pass inside it;
- `msn_subsystems`, `msn_vehicle`, `msn_megakernel`: the same three entry
  points on the mission fleet (`testing.msn_fleet_sim`): the C172Xv2
  flying the LOWS traffic pattern's phase machine (`models/c172/
  missions.py`) over the runway-elevation terrain, half the lanes on the
  final approach at the final-leg trim under a 3-9 m/s easterly crosswind
  (the crosswind landing), half cold on the threshold, engine off (the
  full circuit), with the `msn_ctl_laws` kernel as the splits' pass (the
  phase machine, then the guidance and the control laws on the inputs the
  phase overrides, then the phase's flaps, brake and starter inputs) and
  `megakernel_msn`, the whole step with that pass inside it;
- `turb_fleet`, `turb_vehicle`, `turb_megakernel`: the C172S with Dryden
  turbulence (`testing.turb_study_sim`: W20 = 10 m/s, the shear on every
  third lane, a discrete gust on every third lane): `Simulation.fleet_step`
  through `fleet_rollout`, which on a turbulent vehicle runs
  `rk4_stage_turb` x 4 + `rk4_finish_turb` (compensated) and `geoid` on
  every 128th step, the vehicle split on the same instances
  (uncompensated), and `megakernel_turb`;
- `nav_fleet`, `nav_vehicle`, `xv1_turb_megakernel`: the joint navigation
  study's fleet (`testing.nav_fleet_sim`: the turbulent C172Xv1 on
  `NavAvionics(ControlLaws)`, each lane's Dryden severity, dispersion,
  sensor grade and stream its own) through `Simulation.fleet_step` and
  the vehicle split: `rk4_stage_fbw_turb` x 4, `rk4_finish_fbw_turb`, the
  navigation pass (the truth's systems through `systems_fbw`, the sensors,
  the filter and its monitors as the `nav_pass` kernel, the inner laws as
  the `ctl_laws` kernel on the estimates), `geoid` every step;
  `nav_megakernel`, the same fleet through `megakernel_nav_turb` (the
  step, the truth at the new state, the pass and the control laws in one
  launch); and its truth-fed twin on the control laws through
  `megakernel_fbw_turb`;
- `sensor_fed_megakernel`: the sensor-fed autopilot fleet of the JAX
  package's benchmark report (`testing.sensor_fed_fleet_sim`: the calm
  C172Xv1 on its navigation avionics, the turning climb) through
  `megakernel_nav`;
- `xv2_turb_megakernel`, `msn_turb_megakernel`: the C172Xv2's guidance
  scenario and the mission fleet in the turbulent fleet's Dryden
  turbulence (`testing.xv2_turb_fleet_sim`, `msn_turb_fleet_sim`: W20 =
  10 m/s, the shear on every third lane, a discrete gust on every third
  lane) through `megakernel_gdc_turb` and `megakernel_msn_turb`;
- `xv2_nav_megakernel`: the loiter on estimates of the JAX package's
  `tests/test_navigation.py:276-327` on a fleet (`testing.
  loiter_fleet_sim`: the calm C172Xv2 on `NavAvionics` around its
  guidance and control laws, a 1500 m circle 2 km north, EAS_ref 40 m/s,
  lane k's sensors seeded k) through `megakernel_gdc_nav`;
- `msn_nav_fleet`, `msn_nav_vehicle`, `msn_nav_megakernel`: the sensor-fed
  LOWS missions (`testing.msn_nav_fleet_sim`: `NavAvionics(
  MissionAvionics(...), use_radar=True)` over the calm C172Xv2, half the
  lanes on the radar-gated crosswind landing, half on the cold-start
  takeoff) through `Simulation.fleet_step` and the vehicle split (the
  navigation pass's mission instance of `nav_pass`, then
  `msn_nav_ctl_laws`, the phase machine, guidance and control laws on the
  estimates) and through `megakernel_msn_nav`; and the two missions each
  on B lanes through `megakernel_msn_nav` to their JAX tests' ends;
- `xv2_nav_turb_fleet`, `xv2_nav_turb_vehicle`, `xv2_nav_turb_megakernel`:
  the loiter on estimates in Dryden turbulence (`testing.
  turb_loiter_fleet_sim`: W20 = 10 m/s on every lane, lane k's sensor and
  turbulence streams seeded k) through `Simulation.fleet_step` and the
  vehicle split (`rk4_stage_fbw_turb` x 4, `rk4_finish_fbw_turb`, the
  `systems_fbw` truth, `nav_pass`, `gdc_ctl_laws`, `geoid` every step) and
  through `megakernel_gdc_nav_turb`; `msn_nav_turb_fleet`,
  `msn_nav_turb_vehicle`, `msn_nav_turb_megakernel`: the two sensor-fed
  missions in turbulence (`testing.msn_nav_fleet_sim(turbulence=True)`)
  alike, `msn_nav_ctl_laws` the splits' pass, through
  `megakernel_msn_nav_turb`;
- `a2_vehicle`, `a2_megakernel`: the C172Xv1 on the turning climb with an
  `Actuator2` elevator (`testing.xv1_fleet_sim(a2=("elevator",))`, each
  lane's elevator rate drawn) through the vehicle split
  (`rk4_stage_fbw_a2` x 4, `rk4_finish_fbw_a2`, `ctl_laws`) and through
  `megakernel_fbw_a2`; `Simulation.fleet_step` refuses it on the card by
  name (its subsystems instances are still to port).

Phases:
1. device and toolchain: the card's name and power limit, nvcc's version;
2. build: the kernels of flightjax_torch/csrc compiled for sm_90a; the
   machine code of each kernel instance that `tools/sass_torch_record.json`
   holds (every instance, the turbulent ones too)
   held to its record (`tools/sass_torch_kernels.py`;
   not compared under another nvcc than the record's; a change that means
   to change a recorded instance's machine code records the file anew),
   read by cuobjdump in a thread of its own beside phases 3-8 and held
   before the kernels line;
3. per kernel at B = 4096, on the same card tensors as its plain PyTorch
   version, float64 to 1e-12 and float32 to 1e-5 (relative to
   max(1, |plain|); flags and states exactly), the four fly-by-wire
   instances exactly (error 0) in both, at 32 and 64 aircraft per block,
   on the fly-by-wire cluster operands (the same lanes, servo states and
   commands drawn past their ranges) and on the airborne C172Xv1 fleet:
   the eight other kernels on
   the cluster operands (lanes on each runway surface, a terminated lane, a
   lane that crashes during the step, stalled lanes, every engine state),
   kinair, dynamics and finish_kin also on the ISA-layer operands (heights
   in every ISA layer and on the first layer's ceiling, NaN sea-level
   temperatures: NaN where plain is NaN) at 32 and 64 aircraft (threads for
   dynamics) per block, finish_kin and finish_sys also at 64 per block and
   on the airborne flight fleet, and one megakernel step on the cluster
   operands' fleet, with and without residuals; `ctl_laws` exactly, at 32
   and 64 aircraft per block, on the mode-rich operands (`testing.
   ctl_laws_args`: every lon and lat mode, mode changes, lanes on the
   ground, both sides of the altitude machine's switch points, saturation
   flags of both signs) and on the pass of the C172Xv1 fleet;
   `megakernel_fbw` exactly, one step at 32 and 64 aircraft per block, on
   the C172Xv1 cluster state with the mode-rich avionics (with and without
   residuals, and the pass firing on every other lane at twice the step)
   and on the C172Xv1 fleet; `gdc_ctl_laws` and `megakernel_gdc` alike,
   on the mode-rich guidance over the mode-rich control laws (`testing.
   gdc_laws_args`, `xv2_operand_state`: every guidance mode, the ground
   override, every pair of requests, cross-track errors on both sides of
   the 1000 m gate, far off and exactly on the track, reversed segments)
   and on the C172Xv2 fleet; `msn_ctl_laws` and `megakernel_msn` alike,
   on the mode-rich mission operands (`testing.msn_laws_args`,
   `msn_operand_state`: lanes in every phase, each phase's predicate on
   both sides of its switch, a phase past the end) and on the mission
   fleet;
4. the paths: the trimmed C172S flagship and the trimmed C172Xv1 on the
   turning climb, each at 4096 perturbed aircraft in float32, each path
   from its launch counts set to 0 to their reading just after:
   `subsystems` and `xv2_subsystems` 50 steps and `xv1_subsystems` 100
   (from step 100, so the refresh at step 128 is among them),
   `xv1_megakernel` 200 steps (4 s), `xv2_megakernel` 6000 (120 s),
   `vehicle`, `megakernel` and `xv2_vehicle` 50, `xv1_vehicle` 100 (cut
   from 500 for time: the plain references take most of the run). Every
   leaf finite, no
   lane terminated,
   no lane's stall flag set at any step, altitude and EAS in a physical
   band (on the C172Xv1 above the stall speed in its 45 deg bank), launch
   counts as the path prescribes; on the C172Xv1 also the servo commands
   within their ranges and every lane's modes `LON_EAS_CLM` /
   `LAT_CHI_BETA`; on the C172Xv2 the servo commands within their ranges,
   every lane in `LAT_CHI_BETA` and `LON_EAS_ALT` or `LON_THR_EAS`, and
   after its 120 s the megakernel's fleet within the JAX tests' bounds on
   the median lane (`tests/test_c172x2.py:131-138`, `:170-180`: segment
   lanes' course within 0.05 rad of pi / 2, height within 5 m of the
   segment's, cross-track error under 500 m; circle lanes' radial error
   under 150 m, height within 5 m); `msn_subsystems` (from step 100) and
   `msn_vehicle` 100 steps, `msn_megakernel` the whole 700 s circuit
   (35,000 steps), its
   median lanes held to the JAX mission tests' bounds at their own times
   (`tests/test_missions.py:56-87`: at 20 s the landing lanes still on the
   final, 10-60 m lower, under 100 m off its track; at 40 s the pattern
   lanes past the startup with the engine running), no lane terminated by
   40 s, no NaN, the commands in range, and at 700 s the lanes per phase,
   the terminated lanes, the landing lanes' cross-track at touchdown and
   share stopped and the pattern lanes' highest phase reported (the
   reference's behaviour, not gated); the same steps through the plain
   versions (run in PLAIN_WORKERS worker processes on the card beside
   phases 3-4, on the same fleets made from the same seed) agree within
   the 10 s float32 envelope of BENCHMARKS.md scaled
   to the steps flown (n / 500 of it; `xv2_megakernel` over its first
   100 steps, `xv1_megakernel` and `msn_megakernel` over their first
   200); 20 steps of the
   mission's paths and 10 of the others in float64 agree with plain to
   1e-9; host and device ms per step, launches per step and the device's
   idle share of the nine C172X paths under torch.profiler
   (`tools/profile_torch_step.py`);
5. timings: per kernel the warm median of the bare launch, of the wrapper
   and of the plain version, and the bound (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s, the larger; the operations of the plain
   version, those of the control laws' pass counted as far as the lanes'
   modes enable them, and of the guidance the branch each lane's mode
   selects, the mission's phases as far as the lanes' phases select them,
   `pass_op_weights`). A kernel's time (`ms`) is taken
   inside a captured CUDA graph of 20 launches, so it is the card's time
   and not the host's launch rate; the time by CUDA events around 20
   launches from Python stands beside it (`event_ms`). The role kernels
   (several threads per aircraft: kinair, finish_kin, systems, finish_sys, rk4_stage,
   rk4_finish, megakernel) also by aircraft per block (32, 64), on the
   airborne flight fleet (`airborne_ms`) and on the kernel-check operands
   with lanes on the runway (`runway_ms`), beside an empty kernel launched
   the same way,
   and the megakernel at B = 16384 and 65536 too. Every number of a kernel's row but those is taken on one set
   of operands: the flight fleet (the state its path steps) for the
   megakernels and the passes (the pass at the C172X fleet's state), the
   kernel-check operands for the others (the C172Xv1 fleet for the
   fly-by-wire instances' airborne times; the mission's "airborne" time is
   its fleet's, half of it on the runway). Then vehicle-steps/s of the
   twelve paths and the plain one, interleaved windows, median and
   aggregate.

6. the turbulent C172S: `rk4_stage_turb`, `rk4_finish_turb` (with and
   without residuals) and `megakernel_turb` (one step, with and without
   residuals) against their plain versions in float64 (1e-12) and float32
   (1e-5) at 32 and 64 aircraft per block, on `testing.turb_operands` at
   B (W20 of 0, 7.7, 15.4 and 23.2; heights below 10 ft, in the low band,
   in the blend and above 2000 ft; V below V_MIN; the shear on and off, h
   below z0; before, during and after a discrete gust; seeds above 2^24;
   terminated and crashing lanes); its three paths at B in float32,
   TURB_STEPS steps each against the plain path within the scaled 10 s
   envelope, launch counts from 0, and 10 float64 steps to 1e-9; the
   gust-load study (`demos/c172_demos.py::turbulent_fleet_loads(batch=B,
   t_end=60, W20=10)`, held to `tests/test_missions.py:95-99`: every peak
   finite above 0.7, the exceedance monotone, none terminated; its upper
   bound of 5 g, set for 8 lanes, as the JAX package's own run of the
   same study at B holds it: the peaks' median and max within 1% of
   `tools/jax_turbulent_loads.json`, the exceedance fractions within
   0.005, lanes at 5 g or more where and only where it has them);
   BASELINE's Monte Carlo row, B lanes of `monte_carlo_c172` at W20 = 10
   flown 600 s through `megakernel_turb`: no NaN; none terminated at 60
   s, and at 600 s the terminated lanes reported, each on the terrain
   (the Monte Carlo's wind is N(0, 5 m/s) on each NED axis,
   `parallel/fleet.py`, so a lane that sinks with its air mass reaches
   the ground within 600 s and crashes there, as the reference's would);
   at 60 s and 600 s, over the lanes in flight, the across-lane mean of
   (gust / sigma)^2 per axis within 25% of 1 and the mean within 0.2
   sigma (`tests/test_turbulence.py:65-103`; the gust from the state by
   the plain `gust`, beside the path); the three instances' times, bounds, launches
   per step and share of their path's device time, and the three paths'
   profiles.

7. the navigation fleet: `rk4_stage_fbw_turb`, `rk4_finish_fbw_turb`
   (with and without residuals) and `megakernel_fbw_turb` (one step, with
   and without residuals, the pass every step and every other step)
   against their plain versions in float64 (1e-12) and float32 (1e-5) at
   32 and 64 aircraft per block, on `testing.fbw_turb_operands` at B (the
   turbulent operands with every servo command past its range on both
   sides); `ctl_laws` and `gdc_ctl_laws` on the navigation fleet's
   estimated VehicleY; `nav_pass`, `megakernel_nav` and
   `megakernel_nav_turb` at B in float64 and float32, 32 and 64 aircraft
   per block, on the mode-rich navigation operands (the study's setting,
   the radar setting, shadow mode, the synthetic airflow angles, the
   covariance stepped every firing) and on the study's fleet at its first
   GPS epoch, as `testing.nav_hold` holds them; its four paths at B in
   float32, NAV_STEPS steps each, launch counts from 0: the navigation
   fleet's three on its estimates against the plain step in float64
   (`testing.nav_twin`), within the float32 plain run's own distance from
   it, the truth-fed twin's megakernel against its plain path within the
   scaled 10 s envelope; and 10 float64 steps to 1e-9; the joint
   navigation study at B for its 30 s
   (`demos/estimation_demos.py::joint_navigation_study`) through
   `Simulation.fleet_step` and through `megakernel_nav_turb`, launches
   counted (the kernels line's counts of `nav_pass` and
   `megakernel_nav_turb`), against the JAX package's own run
   (`tools/jax_nav_study.json`,
   the same key and lanes): the p50 and p95 of the peak attitude and
   position errors within 2%, each exceedance fraction within 0.01, the
   alarm fractions within 0.001 of its; the sensor-fed autopilot fleet's
   600 s through `megakernel_nav` within the benchmark report's gates; the
   paths' profiles, the navigation stage's share of the step, and the
   instances' times (on and off an aiding epoch), bounds and launches.

8. the C172Xv2's last instances: `megakernel_gdc_turb` and
   `megakernel_msn_turb` (one step, with and without residuals, the pass
   every step and every other step) against their plain versions in
   float64 (1e-12) and float32 (exactly) at 32 and 64
   aircraft per block, on `testing.xv2_turb_operand_state` and
   `msn_turb_operand_state` at B (the turbulent operands with the
   mode-rich guidance and every phase) and on their fleets;
   `megakernel_gdc_nav` on the sensor-fed C172Xv2's mode-rich operands
   (`testing.nav_operand_state(gdc=True)`) in each of the six navigation
   settings (XV2_NAV_SETTINGS) and on the loiter fleet at its start and at
   its first GPS epoch, as `testing.nav_hold` holds it; the two turbulent
   paths XV2_TURB_STEPS steps against plain within the scaled 10 s
   envelope; the loiter on estimates at B for its 60 s through
   `megakernel_gdc_nav`, every lane held to the JAX test's assertions (not
   terminated, altitude within 10 m, the final radial error under 0.7 of
   the start's, no GPS or baro alarm at a save) and the fleet to the JAX
   package's own float32 run of the same lanes (`tools/jax_loiter.json`,
   LOITER_MATCH), its first LOITER_WINDOW steps held to the float64 plain step as the navigation fleet's; the
   instances' times (the loiter's on and off an aiding epoch), bounds,
   launches and the paths' graphed profiles.

9. the sensor-fed missions: `msn_nav_ctl_laws` against its plain version
   in float64 (1e-12) and float32 (exactly) at 32 and 64 aircraft per
   block, on the mode-rich mission operands whose final leg ends at the
   radar gate (`testing.msn_nav_laws_args`) and on the estimates of the
   two-mission fleet; `nav_pass`'s mission instance and
   `megakernel_msn_nav` on the sensor-fed mission operands
   (`testing.msn_nav_operand_state`: each phase of both missions, lanes
   either side of the radar gate, the radar out of range, a latched radar
   monitor, a radar NIS past its gate) in each navigation setting
   (MSN_NAV_SETTINGS) and on the fleet at its first GPS epoch, at 32 and
   64 aircraft per block, as `testing.nav_hold` holds them (the phases
   exactly in float64; in float32 exactly but on lanes at the radar gate,
   `testing.msn_gate_lanes`); the fleet's three paths MSN_NAV_STEPS steps
   in float32 from their launch counts set to 0, held to the float64 plain
   step as the navigation fleet's; the sensor-fed landing (`testing.
   landing_nav_fleet_sim`, seeds 100 + k) LANDING_NAV_STEPS steps (100 s)
   through `megakernel_msn_nav`, every lane held to
   `tests/test_missions.py:178-187` (phase 2, not terminated, under 2 m/s,
   no monitor alarm), the touchdown cross-track and wheels-stop
   along-track quantiles reported; the sensor-fed takeoff (`testing.
   takeoff_nav_fleet_sim`, seeds k) TAKEOFF_NAV_STEPS steps (80 s), every
   lane held to `tests/test_missions.py:268-300` (phase 3 or later, more
   than 100 m above the field at the end, altitude error under 3 m
   sampled every TAKEOFF_NAV_EVERY steps, under 1 m on the runway phases,
   no alarm, not terminated), its attitude bound of 2 deg on lane 0, the
   JAX test's seed (the JAX package's own run exceeds it on other seeds),
   and the lanes' peak attitude errors to the JAX package's own run of
   the same lanes (`tools/jax_takeoff_nav.json`); the two instances'
   times (the megakernel's on and off an aiding epoch), bounds, launches
   and the megakernel path's graphed profile.

10. the sensor-fed C172Xv2 and missions in turbulence:
   `megakernel_gdc_nav_turb` and `megakernel_msn_nav_turb` against their
   plain versions in float64 and float32 at 32 and 64 aircraft per block,
   on the turbulent mode-rich operands (`testing.nav_operand_state(
   turbulence=True, gdc=True)`, `msn_nav_operand_state(turbulence=True)`)
   in each navigation setting once (NAV_TURB_CASES, the pass every step
   and every other step) and on their fleets at the first GPS epoch, as
   `testing.nav_hold` holds them (around the missions with
   `testing.msn_gate_lanes`), the turbulence's counters exactly; the six
   paths NAV_TURB_STEPS steps in float32 from their launch counts set to
   0, held to the float64 plain step as phase 9's; the turbulent loiter
   on estimates at B for its 60 s through `megakernel_gdc_nav_turb`, held
   to the JAX package's own float32 run of the same lanes
   (`tools/jax_loiter_turb.json`, LOITER_MATCH), as phase 8's calm loiter
   is held to `tools/jax_loiter.json`; the instances' times on and off an
   aiding epoch, bounds, launches and the megakernel paths' graphed
   profiles.

11. the C172Xv1 with a second-order elevator: `rk4_stage_fbw_a2`,
   `rk4_finish_fbw_a2` (with and without residuals) and
   `megakernel_fbw_a2` (with and without residuals, the pass every step
   and every other step) against their plain versions exactly in float64
   and float32 at 32 and 64 aircraft per block, on the runway operands
   and the airborne fleet; its two paths A2_STEPS float32 steps from their
   launch counts set to 0 with phase 4's checks of `xv1_vehicle` and
   `xv1_megakernel`, and F64_A2_STEPS float64 steps to 1e-9; the 60 s
   turning climb through `megakernel_fbw_a2` held to its first-order twin
   and, lane by lane in its stalls, to the JAX package's own run of the
   same lanes (`tools/jax_turning_climb.json`);
   `Simulation.fleet_step`'s named refusal; the instances' times, bounds,
   launches, code and registers, and the paths' vehicle-steps/s beside
   `xv1_vehicle` and `xv1_megakernel`.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors, times and bounds.
"""

import atexit
import collections
import json
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import torch

B = 4096
STEPS = 500
# the steps each path is held to plain over in phase 4, the subsystems
# paths from step SUB_I0 (so the refresh at step 128 is among them): the
# splits 100 and the C172X megakernels' window 200, the C172S's and the
# C172Xv2's cut to half of that for time (the plain references take most
# of the run; the C172Xv1's autopilot gate needs its 2 s)
SUB_I0 = 100
PATH_STEPS = {"subsystems": 50, "vehicle": 50, "megakernel": 50,
              "xv1_subsystems": 100, "xv1_vehicle": 100, "xv1_megakernel": 200,
              "xv2_subsystems": 50, "xv2_vehicle": 50, "xv2_megakernel": 100,
              "msn_subsystems": 100, "msn_vehicle": 100,
              "msn_megakernel": 200}
# the C172Xv2 megakernel's flight: 120 s, the JAX tests' horizon
XV2_FLIGHT = 6000
# the mission megakernel's flight: the whole 700 s circuit of the traffic
# pattern demo; the JAX mission tests' horizons, 20 s (the landing lanes)
# and 40 s (the pattern lanes); the steps between touchdown checks
MSN_FLIGHT, MSN_LANDING_CHECK, MSN_PATTERN_CHECK, MSN_EVERY = (
    35000, 1000, 2000, 25)
# the float64 steps against plain: the mission's 20, the earlier paths' 10
F64_STEPS = {"msn": 20, "": 10}
SEED = 1016
DEVICE = "cuda"
# steps per throughput window (the plain path is ~40x slower)
WINDOW = {"subsystems": 200, "vehicle": 500, "megakernel": 500, "plain": 20,
          "xv1_subsystems": 100, "xv1_vehicle": 100, "xv1_megakernel": 500,
          "xv2_subsystems": 100, "xv2_vehicle": 100, "xv2_megakernel": 500,
          "msn_subsystems": 100, "msn_vehicle": 100, "msn_megakernel": 500}
# the H100 SXM's published peaks: HBM3 bandwidth and dense float32 rate
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12

# the 10 s float32 envelope (BENCHMARKS.md:34): position, velocity,
# attitude, EAS
ENV_POS_M, ENV_VEL, ENV_ATT_RAD, ENV_EAS = 0.73, 5e-5, 7e-7, 5e-5
# phase 4's plain references (each plain step is ~29,000 host-bound
# PyTorch ops on one core) run in this many worker processes of their own
# on the same card, beside phases 3-4
PLAIN_WORKERS = 5

# kernel: (source, the TPU kernel it replaces, the path that launches it)
KERNELS = {
    "kinair": ("flightjax_torch/csrc/kinair.cu",
               "flightjax/parallel/clusterstep.py:250", "subsystems"),
    "systems": ("flightjax_torch/csrc/systems.cu",
                "flightjax/parallel/clusterstep.py:274", "subsystems"),
    "dynamics": ("flightjax_torch/csrc/dynamics.cu",
                 "flightjax/parallel/clusterstep.py:403", "subsystems"),
    "finish_kin": ("flightjax_torch/csrc/finish_kin.cu",
                   "flightjax/parallel/clusterstep.py:433", "subsystems"),
    "finish_sys": ("flightjax_torch/csrc/finish_sys.cu",
                   "flightjax/parallel/clusterstep.py:452", "subsystems"),
    "rk4_stage": ("flightjax_torch/csrc/rk4_stage.cu",
                  "flightjax/parallel/clusterstep.py:81", "vehicle"),
    "rk4_finish": ("flightjax_torch/csrc/rk4_finish.cu",
                   "flightjax/parallel/clusterstep.py:97", "vehicle"),
    "geoid": ("flightjax_torch/csrc/geoid.cu",
              "flightjax/parallel/megakernel.py:144", "vehicle"),
    "megakernel": ("flightjax_torch/csrc/megakernel.cu",
                   "flightjax/parallel/megakernel.py:43", "megakernel"),
    # the C172Xv1 instances of the kernels TPU's pallas_block builds by
    # tracing the fly-by-wire model's lane functions
    "systems_fbw": ("flightjax_torch/csrc/systems.cu",
                    "flightjax/parallel/clusterstep.py:274",
                    "xv1_subsystems"),
    "finish_sys_fbw": ("flightjax_torch/csrc/finish_sys.cu",
                       "flightjax/parallel/clusterstep.py:452",
                       "xv1_subsystems"),
    "rk4_stage_fbw": ("flightjax_torch/csrc/rk4_stage.cu",
                      "flightjax/parallel/clusterstep.py:81", "xv1_vehicle"),
    "rk4_finish_fbw": ("flightjax_torch/csrc/rk4_finish.cu",
                       "flightjax/parallel/clusterstep.py:97",
                       "xv1_vehicle"),
    # the megakernel's instance on the C172Xv1, with the masked periodic
    # pass of the control laws inside it, and that pass as a kernel of its
    # own, which the two C172Xv1 splits launch after each firing step
    "megakernel_fbw": ("flightjax_torch/csrc/megakernel.cu",
                       "flightjax/parallel/megakernel.py:43",
                       "xv1_megakernel"),
    "ctl_laws": ("flightjax_torch/csrc/ctl_laws.cu",
                 "flightjax/parallel/megakernel.py:43", "xv1_vehicle"),
    # the megakernel's instance on the C172Xv2, with the guidance and the
    # control laws' pass inside it, and that pass as a kernel of its own
    "megakernel_gdc": ("flightjax_torch/csrc/megakernel.cu",
                       "flightjax/parallel/megakernel.py:43",
                       "xv2_megakernel"),
    "gdc_ctl_laws": ("flightjax_torch/csrc/ctl_laws.cu",
                     "flightjax/parallel/megakernel.py:43", "xv2_vehicle"),
    # the megakernel's instance over a world that flies a scripted mission
    # (flightjax/core/mission.py:48-102 around the C172Xv2's avionics), and
    # its pass as a kernel of its own (the splits' XLA glue,
    # flightjax/parallel/clusterstep.py:591-607)
    "megakernel_msn": ("flightjax_torch/csrc/megakernel.cu",
                       "flightjax/parallel/megakernel.py:43",
                       "msn_megakernel"),
    "msn_ctl_laws": ("flightjax_torch/csrc/ctl_laws.cu",
                     "flightjax/parallel/megakernel.py:43", "msn_vehicle"),
    # the turbulent C172S's instances (DrydenTurbulence on the vehicle):
    # the whole-vehicle kernels, which `Simulation.fleet_step` runs on it
    # (compensated) as the vehicle split does, and the megakernel
    "rk4_stage_turb": ("flightjax_torch/csrc/rk4_stage.cu",
                       "flightjax/parallel/clusterstep.py:81", "turb_fleet"),
    "rk4_finish_turb": ("flightjax_torch/csrc/rk4_finish.cu",
                        "flightjax/parallel/clusterstep.py:97",
                        "turb_fleet"),
    "megakernel_turb": ("flightjax_torch/csrc/megakernel.cu",
                        "flightjax/parallel/megakernel.py:43",
                        "turb_megakernel"),
    # the turbulent C172Xv1's instances (the joint navigation study's
    # vehicle, c172x.build_vehicle(turbulence=)): the whole-vehicle
    # kernels, which both entry points of the navigation fleet run, and the
    # megakernel of its truth-fed twin on the control laws
    "rk4_stage_fbw_turb": ("flightjax_torch/csrc/rk4_stage.cu",
                           "flightjax/parallel/clusterstep.py:81",
                           "nav_fleet"),
    "rk4_finish_fbw_turb": ("flightjax_torch/csrc/rk4_finish.cu",
                            "flightjax/parallel/clusterstep.py:97",
                            "nav_fleet"),
    "megakernel_fbw_turb": ("flightjax_torch/csrc/megakernel.cu",
                            "flightjax/parallel/megakernel.py:43",
                            "xv1_turb_megakernel"),
    # the sensor-fed C172Xv1's instances (NavAvionics around its control
    # laws): the navigation pass as a kernel of its own, which both splits
    # of the navigation fleet launch (the JAX package's splits run it as
    # XLA glue, flightjax/parallel/clusterstep.py:591-607), and the
    # megakernel with the pass inside it, in turbulence (the joint study's
    # fleet) and calm (the sensor-fed autopilot fleet)
    "nav_pass": ("flightjax_torch/csrc/nav_pass.cu",
                 "flightjax/parallel/megakernel.py:43", "nav_vehicle"),
    "megakernel_nav_turb": ("flightjax_torch/csrc/megakernel.cu",
                            "flightjax/parallel/megakernel.py:43",
                            "nav_megakernel"),
    "megakernel_nav": ("flightjax_torch/csrc/megakernel.cu",
                       "flightjax/parallel/megakernel.py:43",
                       "sensor_fed_megakernel"),
    # the C172Xv2's last instances: in Dryden turbulence, a mission flown
    # on it, and on its navigation avionics (the loiter on estimates)
    "megakernel_gdc_turb": ("flightjax_torch/csrc/megakernel_gdc_turb.cu",
                            "flightjax/parallel/megakernel.py:43",
                            "xv2_turb_megakernel"),
    "megakernel_msn_turb": ("flightjax_torch/csrc/megakernel_msn_turb.cu",
                            "flightjax/parallel/megakernel.py:43",
                            "msn_turb_megakernel"),
    "megakernel_gdc_nav": ("flightjax_torch/csrc/megakernel_gdc_nav.cu",
                           "flightjax/parallel/megakernel.py:43",
                           "xv2_nav_megakernel"),
    # the sensor-fed missions: the megakernel's instance with the
    # navigation pass and the phase machine on the estimates, and the
    # mission's pass on the estimates as a kernel of its own, which both
    # splits launch after nav_pass's mission instance
    "megakernel_msn_nav": ("flightjax_torch/csrc/megakernel_msn_nav.cu",
                           "flightjax/parallel/megakernel.py:43",
                           "msn_nav_megakernel"),
    "msn_nav_ctl_laws": ("flightjax_torch/csrc/ctl_laws.cu",
                         "flightjax/parallel/megakernel.py:43",
                         "msn_nav_vehicle"),
    # the sensor-fed C172Xv2 and missions in Dryden turbulence: the
    # megakernel's instances with the turbulence and the navigation pass
    "megakernel_gdc_nav_turb": (
        "flightjax_torch/csrc/megakernel_gdc_nav_turb.cu",
        "flightjax/parallel/megakernel.py:43", "xv2_nav_turb_megakernel"),
    "megakernel_msn_nav_turb": (
        "flightjax_torch/csrc/megakernel_msn_nav_turb.cu",
        "flightjax/parallel/megakernel.py:43", "msn_nav_turb_megakernel"),
    # the C172Xv1 with a second-order elevator: the whole-vehicle kernels
    # and the megakernel with its control laws
    "rk4_stage_fbw_a2": ("flightjax_torch/csrc/rk4_stage.cu",
                         "flightjax/parallel/clusterstep.py:81",
                         "a2_vehicle"),
    "rk4_finish_fbw_a2": ("flightjax_torch/csrc/rk4_finish.cu",
                          "flightjax/parallel/clusterstep.py:97",
                          "a2_vehicle"),
    "megakernel_fbw_a2": ("flightjax_torch/csrc/megakernel_fbw_a2.cu",
                          "flightjax/parallel/megakernel.py:43",
                          "a2_megakernel"),
}
FBW_NAMES = ("systems_fbw", "finish_sys_fbw", "rk4_stage_fbw",
             "rk4_finish_fbw")
# the kernels that run on the cluster operands (the megakernels step a
# state, ctl_laws runs the control laws), C172S first
TURB_NAMES = ("rk4_stage_turb", "rk4_finish_turb", "megakernel_turb")
NAV_NAMES = ("rk4_stage_fbw_turb", "rk4_finish_fbw_turb",
             "megakernel_fbw_turb", "nav_pass", "megakernel_nav_turb",
             "megakernel_nav")
XV2_LAST_NAMES = ("megakernel_gdc_turb", "megakernel_msn_turb",
                  "megakernel_gdc_nav", "megakernel_msn_nav",
                  "msn_nav_ctl_laws", "megakernel_gdc_nav_turb",
                  "megakernel_msn_nav_turb")
LANE_KERNELS = tuple(k for k in KERNELS if k not in (
    "megakernel", "megakernel_fbw", "ctl_laws", "megakernel_gdc",
    "gdc_ctl_laws", "megakernel_msn", "msn_ctl_laws") and k not in FBW_NAMES
    and k not in TURB_NAMES and k not in NAV_NAMES
    and k not in XV2_LAST_NAMES and not k.endswith("_a2"))
XV1_PATHS = ("xv1_subsystems", "xv1_vehicle", "xv1_megakernel")
XV2_PATHS = ("xv2_subsystems", "xv2_vehicle", "xv2_megakernel")
XV_PATHS = XV1_PATHS + XV2_PATHS
MSN_PATHS = ("msn_subsystems", "msn_vehicle", "msn_megakernel")
# the turbulent C172S's paths (`testing.turb_study_sim`: W20 = 10 m/s, the
# shear on every third lane, a discrete gust on every third lane), held to
# plain over TURB_STEPS steps; the gust-load study (`demos/c172_demos.py::
# turbulent_fleet_loads` at its own t_end and W20) and BASELINE's Monte
# Carlo flight (600 s through megakernel_turb, its gust statistics checked
# at 60 s and at 600 s)
TURB_PATHS = ("turb_fleet", "turb_vehicle", "turb_megakernel")
TURB_STEPS = 50
LOADS_T_END, LOADS_W20 = 60.0, 10.0
MC_CHECKS = (3000, 30000)
# the JAX package's own run of the gust-load study at B (its peaks'
# median and max held to 1% here, the exceedance fractions to 0.005)
JAX_LOADS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "jax_turbulent_loads.json")
LOADS_MATCH = (0.01, 0.005)
# the joint navigation study's fleet (`testing.nav_fleet_sim`: the
# turbulent C172Xv1 on its navigation avionics) through its two entry
# points, and its truth-fed twin's megakernel (`testing.xv1_turb_fleet_sim`),
# held to plain over NAV_STEPS steps; the study itself
# (`demos/estimation_demos.py::joint_navigation_study` at B for its 30 s)
# against the JAX package's own run (tools/jax_nav_study.py): the peaks'
# p50 and p95 within 2%, each exceedance fraction within 0.01
NAV_PATHS = ("nav_fleet", "nav_vehicle", "nav_megakernel",
             "xv1_turb_megakernel")
# the sensor-fed autopilot fleet of the JAX package's benchmark report
# (tools/bench_report.py:215-290, `testing.sensor_fed_fleet_sim`): B lanes
# of the calm C172Xv1 on its navigation avionics, the turning climb, lane
# k's sensor stream seeded k, flown 600 s through megakernel_nav and held
# to the report's gates (mean EAS within 1.0 of 45 m/s, mean climb within
# 0.3 of 1.5 m/s, every leaf finite), no lane terminated
SENSOR_FED_T_END = 600.0
SENSOR_FED_EAS, SENSOR_FED_CLIMB = (45.0, 1.0), (1.5, 0.3)
NAV_STEPS = 10  # its tenth step makes the first GPS epoch
# the steps each profile of a navigation path runs (its launches a step
# are thousands: the profiler's trace of more takes minutes to read)
NAV_PROFILE_STEPS = 3
NAV_T_END = 30.0
JAX_NAV = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tools", "jax_nav_study.json")
NAV_MATCH = (0.02, 0.01)
# the C172Xv2's last instances' megakernel paths: the turbulent C172Xv2's
# guidance scenario and the turbulent mission fleet (`testing.
# xv2_turb_fleet_sim`, `msn_turb_fleet_sim`: the turbulent fleet's W20,
# shear and gusts), held to plain over XV2_TURB_STEPS steps; the loiter on
# estimates (`testing.loiter_fleet_sim`) through megakernel_gdc_nav, held
# to plain over LOITER_WINDOW steps as the navigation fleet is, then flown its
# LOITER_STEPS and held to the JAX test's assertions on every lane
# (`tests/test_navigation.py:276-327`; the alarms read every
# LOITER_SAVE_EVERY steps, as that test's log saves them)
XV2_TURB_PATHS = ("xv2_turb_megakernel", "msn_turb_megakernel")
XV2_NAV_PATH = "xv2_nav_megakernel"
XV2_TURB_STEPS = 10
LOITER_SAVE_EVERY = 100
# megakernel_gdc_nav's mode-rich checks: every navigation setting once, the
# default in both dtypes; the loiter's window against plain (each plain
# step of a navigation world takes half a second of the run's 1200)
XV2_NAV_SETTINGS = {torch.float64: ("default", "radar", "synthetic",
                                    "immediate"),
                    torch.float32: ("default", "shadow", "perturb")}
LOITER_WINDOW = 5
# the JAX package's own float32 runs of the loiter on estimates at B, calm
# and in turbulence at W20 = 10 m/s (tools/jax_loiter.py; the same lanes,
# seeds and start): the p50 and p95 of the final |e_cb|, of the largest
# |h_e - h0| and of the final-to-start ratio held within LOITER_MATCH[0]
# relative or LOITER_MATCH[1] m, the lanes failing an assertion of the JAX
# test within LOITER_MATCH[2] lanes of the JAX run's count (exactly none
# where it has none)
JAX_LOITER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "jax_loiter.json")
JAX_LOITER_TURB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tools", "jax_loiter_turb.json")
LOITER_MATCH = (0.02, 0.5, 4)
# the sensor-fed missions: the paths' window against plain, the navigation
# settings of the mode-rich checks (each once, the default in both
# dtypes), the landing's 100 s and the takeoff's 80 s (their JAX tests'
# horizons) and the takeoff's samples (that test's log, save_every 10)
MSN_NAV_PATHS = ("msn_nav_fleet", "msn_nav_vehicle", "msn_nav_megakernel")
MSN_NAV_STEPS = 10
MSN_NAV_SETTINGS = {torch.float64: ("default", "radar", "immediate"),
                    torch.float32: ("default", "shadow", "synthetic",
                                    "perturb")}
LANDING_NAV_STEPS, TAKEOFF_NAV_STEPS, TAKEOFF_NAV_EVERY = 5000, 4000, 10
# the sensor-fed C172Xv2 and missions in Dryden turbulence: the paths of
# the turbulent loiter on estimates (`testing.turb_loiter_fleet_sim`) and
# of the two missions in turbulence (`testing.msn_nav_fleet_sim(
# turbulence=True)`), held to the float64 plain step over NAV_TURB_STEPS
# steps; the mode-rich checks' (setting, steps per pass) in each dtype,
# each navigation setting once
NAV_TURB_PATHS = ("xv2_nav_turb_fleet", "xv2_nav_turb_vehicle",
                  "xv2_nav_turb_megakernel", "msn_nav_turb_fleet",
                  "msn_nav_turb_vehicle", "msn_nav_turb_megakernel")
NAV_TURB_STEPS = 10
NAV_TURB_CASES = {torch.float64: (("default", 1), ("radar", 2),
                                  ("immediate", 1)),
                  torch.float32: (("default", 1), ("shadow", 2),
                                  ("synthetic", 1), ("perturb", 1))}
# the landing's touchdown looked for every this many steps
LANDING_NAV_EVERY = 5
# the JAX package's own run of the takeoff at B (tools/jax_takeoff_nav.py):
# the peak attitude errors' p50 and p95 held within 2%, the exceedance
# fractions within 0.01, as the navigation study's are
JAX_TAKEOFF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tools", "jax_takeoff_nav.json")
TAKEOFF_MATCH = (0.02, 0.01)
# the sub-controllers of the control laws' lon and lat passes, each under
# the comment `# ---- <name>` that opens it in `ControlLaws.lon_step` /
# `lat_step` (`models/c172/c172x_ctl.py`), with the modes that enable it;
# each but theta2q reads the gain table of its name
CTL_PARTS = {"lon": {"v2t": (5, 6, 7), "c2theta": (7,), "theta2q": (3, 6, 7),
                     "q2e": (2, 3, 5, 6, 7), "te2te": (1, 2, 3, 5, 6, 7),
                     "tv2te": (4,), "vh2te": (8,)},
             "lat": {"p2phi": (2,), "chi2phi": (4,), "ar2ar": (1,),
                     "phibeta2ar": (2, 3, 4)}}
# the kernel-check operands' lanes: on the runway, terminated, and crashing
# during the step (on the runway, sinking past what the gear takes)
GROUND_LANES, TERMINATED_LANES, CRASH_LANE = (3, 77), (5,), 78
# the C172Xv1 with a second-order elevator (phase 11): its two paths, held
# to plain over A2_STEPS float32 and F64_A2_STEPS float64 steps (the plain
# steps take most of the phase), and the megakernel's turning climb of
# A2_FLIGHT steps (60 s)
A2_PATHS = ("a2_vehicle", "a2_megakernel")
A2_STEPS, F64_A2_STEPS, A2_FLIGHT = 20, 5, 3000
# the JAX package's own float32 run of that climb on the same lanes
# (tools/jax_turning_climb.py): its stalled lanes, within B // 100 lanes of
# the card's set, and its mean EAS at 60 s, within A2_EAS_MATCH m/s
JAX_CLIMB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools", "jax_turning_climb.json")
A2_EAS_MATCH = 0.1


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def code_bytes(nvcc, so):
    """(kernel, bytes of machine code) of the float32 kernels in the built
    library, from the section table `cuobjdump -elf` prints; a long kernel
    that runs once per launch pays for fetching its code. Empty where the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return []
    out = subprocess.run([tool, "-elf", so], capture_output=True, text=True,
                         timeout=120).stdout
    from sass_torch_kernels import kernel_name
    found = re.findall(r"^\s*\w+\s+\w+\s+(\w+)\s.*PROGBITS.*\.text\._Z\d+"
                       r"(\w+?)_kernelI(?:Li(\d+)E)?N2fj6StrictIfEE"
                       r"(?:Li(\d)E)?", out, re.M)
    return sorted((kernel_name(name, act, av), int(size, 16))
                  for size, name, act, av in found)


def registers(log_path):
    """{kernel: {f32/f64: (registers, spill store bytes, spill load
    bytes)}} from ptxas's report in the build log."""
    from sass_torch_kernels import KERNEL, kernel_name
    out = collections.defaultdict(dict)
    entry = mangled = props = None
    spill = (0, 0)
    with open(log_path) as fh:
        for line in fh:
            m = re.search(r"Compiling entry function '(_Z\w+)'", line)
            k = m and KERNEL.match(m.group(1))
            if k:
                name, act, ftype, av = k.groups()
                mangled, spill = m.group(1), (0, 0)
                entry = (kernel_name(name, act, av),
                         "f32" if ftype == "f" else "f64")
                continue
            m = re.search(r"Function properties for (\w+)", line)
            if m:
                props = m.group(1)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and entry and props == mangled:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                out[entry[0]][entry[1]] = (int(m.group(1)), *spill)
                entry = None
    return dict(out)


def rel_err(got, ref, equal_nan=False):
    """max |got - ref| / max(1, |ref|) over all elements; with `equal_nan`,
    NaN where `ref` is NaN counts as equal, NaN anywhere else as infinitely
    far."""
    g, r = got.double(), ref.double()
    if equal_nan:
        if not torch.equal(g.isnan(), r.isnan()):
            return float("inf")
        g, r = g[~r.isnan()], r[~r.isnan()]
    return float(((g - r).abs() / r.abs().clamp_min(1.0)).max())


def leaves(tree):
    from flightjax_torch.core.modeling import tree_leaves_with_path
    return tree_leaves_with_path(tree)


def leaf_pairs(got, ref):
    """(path, got leaf, ref leaf) of two trees of one structure; flags and
    integer states as float64, so that they must agree exactly."""
    return [(p, a, b) if a.dtype.is_floating_point else (p, a.double(),
                                                         b.double())
            for (p, a), (_, b) in zip(leaves(got), leaves(ref))]


def cuda_ms(fn, reps=7, calls=20, warm=3):
    """Warm median milliseconds per call, CUDA events around `calls`
    back-to-back calls, after `warm` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def graph_ms(fn, reps=7, calls=20):
    """Warm median milliseconds per call of `calls` calls replayed from one
    captured CUDA graph: the device's time, free of the host's launch
    rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def graph_profile(label, name, step_packed, bufs, bare, steps=200):
    """The form of `tools/profile_torch_step.py::profile` for a megakernel
    path, without the profiler (which misses some of its launches): host
    ms a step, wall clock around `steps` warm steps ending in a
    synchronize; device ms, the kernel `name`'s launch `bare` replayed
    from a captured CUDA graph (`graph_ms`)."""
    for _ in range(10):
        bufs = step_packed(bufs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        bufs = step_packed(bufs)
    torch.cuda.synchronize()
    host = 1e3 * (time.perf_counter() - t0) / steps
    dev = graph_ms(bare)
    return {"path": label, "host_ms_per_step": host,
            "device_ms_per_step": dev, "idle_share": 1.0 - dev / host,
            "launches_per_step": 1.0, "device_by": "graph",
            "top": [{"name": name, "ms_per_step": dev, "per_step": 1.0}]}


def count_ops(fn, weight=None, matmul=False):
    """Arithmetic operations of `fn` as PyTorch runs them: the elements of
    the output of every pointwise op and of the input of every reduction
    (copies, views, concatenations, gathers and fills are not counted),
    each op's count times `weight(output)` if given; with `matmul` also
    2 m n k for each matrix product of m x k by k x n (the navigation
    filter's algebra)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    reductions = {"sum", "amax", "amin", "any", "all", "argmax", "argmin",
                  "prod", "mean", "norm", "linalg_vector_norm"}
    skip = {"copy_", "clone", "fill_", "_to_copy", "lift_fresh"}
    total = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.__name__.split(".")[0]
            if name in skip:
                return out
            o = out[0] if isinstance(out, (tuple, list)) else out
            w = 1.0 if weight is None or not isinstance(
                o, torch.Tensor) else weight(o)
            if matmul and name in ("mm", "bmm", "addmm", "baddbmm"):
                a, b = args[-2], args[-1]
                total["ops"] += 2 * a.numel() * b.shape[-1]
            elif name in reductions and isinstance(args[0], torch.Tensor):
                total["ops"] += w * args[0].numel()
            elif torch.Tag.pointwise in func.tags:
                if isinstance(o, torch.Tensor):
                    total["ops"] += w * o.numel()
            return out

    with Count():
        fn()
    return round(total["ops"])


def control_laws(avionics):
    """The `ControlLaws` of the C172Xv1's avionics, the C172Xv2's or a
    mission's over them."""
    from flightjax_torch.parallel import kernels as K
    return K.control_laws(avionics)


def gain_widths(avionics):
    """{channel: the gain values of its table} (`FusedSchedule.split`)."""
    import math
    avionics = control_laws(avionics)
    width = collections.Counter()
    for fused in (avionics.lon_gains, avionics.lat_gains):
        for ch, _, tail in fused.split:
            width[ch] += math.prod(tail)
    return width


def pass_op_weights(avionics, s_in, s_out, fires=None, gdc_lanes=None):
    """`weight` for `count_ops` of a step with the control laws' pass
    whose avionics state goes from s_in to s_out: what the kernels do of
    the plain pass, which works out every sub-controller on every lane and
    selects. Where the pass fires (`fires`, default every lane), the mode
    logic counts on each lane, a sub-controller's ops on the lanes whose
    new mode enables it, its re-seed where that mode is also a change, and
    a per-value op of the fused gain lookup for the values of the tables
    the lanes' modes enable; the masked selects of `tree_where` count
    nothing. Ops outside the pass count in full. On the C172Xv2 the
    guidance runs first on every lane (the plain version works out both
    branches): its mode logic and selects count on each firing lane, its
    segment branch on the `gdc_lanes` (a pair of masks: the lanes that work
    out the segment, the lanes that work out the circle) that work it out,
    its circle branch alike; its override of the control laws' requests is
    masked selects and counts nothing. Over a mission (the plain version
    works out every phase's `apply` and `done` and every phase's `systems`
    on every lane) a phase function counts on the firing lanes whose phase
    selects it (the old phase for `apply` and `done`, the new for
    `systems`), the phase machine's own logic on each firing lane."""
    import inspect
    from flightjax_torch.core.mission import MissionAvionics
    from flightjax_torch.core.modeling import tree_where
    from flightjax_torch.models.c172.c172x_ctl import ControlLaws
    from flightjax_torch.models.c172.c172x_gdc import GuidanceLaws
    from flightjax_torch.models.c172.missions import (MissionApply,
                                                      MissionDone,
                                                      MissionSystems)
    from flightjax_torch.parallel.clusterstep import _periodic
    width = gain_widths(avionics)
    msn_frac, msn_own = {}, ()
    if isinstance(avionics, MissionAvionics):
        n = len(avionics.phases)
        fire0 = (torch.ones_like(s_in["phase"], dtype=torch.bool)
                 if fires is None else fires)
        old = s_in["phase"].clamp(0, n - 1)
        new = s_out["phase"].clamp(0, n - 1)
        for k, p in enumerate(avionics.phases):
            for fn, ph in ((p.apply, old), (p.done, old), (p.systems, new)):
                if fn is not None:
                    msn_frac[id(fn)] = msn_frac.get(id(fn), 0.0) + (
                        fire0 & (ph == k)).double().mean().item()
        msn_own = tuple(getattr(MissionAvionics, m).__code__
                        for m in ("overrides", "advance", "assign"))
    msn_calls = tuple(c.__call__.__code__ for c in (MissionApply, MissionDone,
                                                    MissionSystems))
    s_in, s_out = s_in.get("inner", s_in), s_out.get("inner", s_out)
    s_in, s_out = s_in.get("ctl", s_in), s_out.get("ctl", s_out)
    like = s_out["lon"]["mode_prev"]
    fire = (torch.ones_like(like, dtype=torch.bool) if fires is None
            else fires)
    fire_frac = fire.double().mean().item()
    sides = {}
    for side, parts in CTL_PARTS.items():
        fn = getattr(ControlLaws, f"{side}_step")
        lines, first = inspect.getsourcelines(fn)
        marks, end, gains_line = [], None, None
        for k, text in enumerate(lines):
            m = re.match(r"\s*# ---- (\w+)", text)
            if m:
                marks.append((first + k, m.group(1)))
            elif "s_new = {" in text:
                end = first + k
            elif "_gains(EAS, h_e)" in text:
                gains_line = first + k
        if sorted(n for _, n in marks) != sorted(parts) or None in (
                end, gains_line):
            raise AssertionError(f"pass_op_weights: ControlLaws.{side}_step "
                                 f"has parts {marks}, not {list(parts)}")
        mode, prev = s_out[side]["mode_prev"], s_in[side]["mode_prev"]
        on = {n: fire & torch.isin(mode, torch.tensor(modes,
                                                      device=mode.device))
              for n, modes in parts.items()}
        values = sum(on[n].double() * width[n] for n in parts if n in width)
        sides[fn.__code__] = dict(
            marks=marks, end=end, gains_line=gains_line,
            on={n: v.double().mean().item() for n, v in on.items()},
            reset={n: (v & (mode != prev)).double().mean().item()
                   for n, v in on.items()},
            width=sum(width[n] for n in parts if n in width),
            per_value=(values.mean() / sum(width[n] for n in parts
                                           if n in width)).item())
    resets = ("_pid_reset", "_int_reset", "_lqr_reset")
    guide = GuidanceLaws.f_periodic
    override = GuidanceLaws.override_ctl_u.__code__
    g_lines, g_first = inspect.getsourcelines(guide)
    g_marks = [(g_first + k, m.group(1)) for k, text in enumerate(g_lines)
               for m in [re.match(r"\s*# ---- (\w+)", text)] if m]
    if [n for _, n in g_marks] != ["mode", "segment", "circle", "select"]:
        raise AssertionError(f"pass_op_weights: GuidanceLaws.f_periodic has "
                             f"parts {g_marks}")
    branch = {"mode": fire_frac, "select": fire_frac}
    if gdc_lanes is not None:
        for name, lanes in zip(("segment", "circle"), gdc_lanes):
            branch[name] = (fire & lanes).double().mean().item()

    def weight(out):
        f, reset = sys._getframe(1), False
        while f is not None:
            code = f.f_code
            if code in (tree_where.__code__, override):
                return 0.0
            if code.co_name in resets:
                reset = True
            if code in sides:
                break
            if code is guide.__code__:
                part = [n for at, n in g_marks if at <= f.f_lineno]
                return branch[part[-1]] if part else fire_frac
            if code is _periodic.__code__ or code in msn_own:
                return fire_frac
            if code in msn_calls:
                return msn_frac.get(id(f.f_locals["self"]), 0.0)
            f = f.f_back
        else:
            return 1.0
        side, line = sides[code], f.f_lineno
        if line == side["gains_line"]:
            return (side["per_value"] if out.dim() and out.shape[-1]
                    == side["width"] else fire_frac)
        part = [n for at, n in side["marks"] if at <= line < side["end"]]
        if not part:
            return fire_frac
        return (side["reset"] if reset else side["on"])[part[-1]]

    return weight


def geoid_cells(geo, q_ew):
    """The EGM96 grid values the bilinear lookups under `q_ew` read (the
    four corners of each lane's cell, shared corners once)."""
    from flightjax_torch.core.modeling import divc
    from flightjax_torch.ops.geodesy import latlon_from_nvector, \
        nvector_from_qew
    lk = geo.lookup
    lat, lon = latlon_from_nvector(nvector_from_qew(q_ew))
    lon = torch.remainder(lon + 2 * torch.pi, 2 * torch.pi)
    i0 = torch.clamp(torch.floor(divc(lat - lk.x0, lk.d0)).long(), 0,
                     lk.n0 - 2)
    t1 = torch.clamp(divc(lon - lk.y0, lk.d1), 0.0, lk.n1 - 1.0)
    i1 = torch.clamp(torch.floor(t1).long(), 0, lk.n1 - 2)
    corners = torch.cat([(i0 + a) * lk.n1 + i1 + b
                         for a in (0, 1) for b in (0, 1)])
    return int(torch.unique(corners).numel())


def bound(nbytes, ops):
    """(bound ms, what bounds it) on the H100's published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ------------------------------------------------------------ inputs

def kernel_operands(batch=B):
    from flightjax_torch.testing import cluster_operands
    return cluster_operands(batch, SEED, GROUND_LANES, TERMINATED_LANES,
                            (CRASH_LANE,))


def kernel_inputs(dtype):
    """numpy-seeded operands of LANE_KERNELS at B lanes (as the CPU
    parity tests draw them, two lanes on the runway, one terminated, one
    crashing in the step, lanes in every engine state), on the card."""
    from flightjax_torch.models.c172.c172s import build_vehicle
    from flightjax_torch.parallel.kernels import operand_args
    return operand_args(kernel_operands(), build_vehicle(device=DEVICE,
                                                         dtype=dtype),
                        DEVICE, dtype, adt=0.01, dt=0.02)


def isa_inputs(dtype):
    """The operands of kinair, dynamics and finish_kin on the ISA-layer
    fleet (`testing.isa_layer_operands`) at B lanes, on the card."""
    from flightjax_torch.models.c172.c172s import build_vehicle
    from flightjax_torch.parallel.kernels import operand_args
    from flightjax_torch.testing import isa_layer_operands
    return operand_args(isa_layer_operands(B, SEED),
                        build_vehicle(device=DEVICE, dtype=dtype), DEVICE,
                        dtype, adt=0.01, dt=0.02)


def fbw_operands(batch=B):
    from flightjax_torch.testing import fbw_cluster_operands
    return fbw_cluster_operands(batch, SEED, GROUND_LANES, TERMINATED_LANES,
                                (CRASH_LANE,))


def fbw_inputs(dtype):
    """The wrapper arguments of the fly-by-wire instances (keyed by
    instance) on the fly-by-wire cluster operands at B lanes, on the
    card."""
    from flightjax_torch.models.c172.c172x import build_vehicle
    from flightjax_torch.parallel import kernels as K
    args = K.operand_args(fbw_operands(), build_vehicle(device=DEVICE,
                                                        dtype=dtype),
                          DEVICE, dtype, adt=0.01, dt=0.02)
    return {K.FBW.names[k]: args[k] for k in K.FBW.names}


def fbw_flight_inputs(sim, st):
    """The wrapper arguments of the fly-by-wire instances on the airborne
    C172Xv1 fleet `st` (`testing.flight_operand_args`)."""
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.testing import flight_operand_args
    args = flight_operand_args(sim, st)
    return {K.FBW.names[k]: args[k] for k in K.FBW.names}


def fbw_plain(name):
    from flightjax_torch.parallel import kernels as K
    return getattr(K, name[:-len("_fbw")] + "_plain")


def fbw_wrapper(name):
    from flightjax_torch.parallel import kernels as K
    return getattr(K, name[:-len("_fbw")])


def unpacked(name, ref):
    """The plain result of kinair, dynamics, finish_kin or finish_sys in
    the form `kernel_rows` gives the kernel's output: a list of dicts of
    its row groups (finish_kin's residuals left out where plain carries
    none)."""
    if name == "dynamics":
        return [ref]
    if name == "finish_sys":
        return list(ref[:2])
    if name == "finish_kin":
        x_kin, x_dyn, kin, air, c = ref
        return [x_kin, x_dyn, kin._asdict(), air._asdict()] + (
            [c] if c is not None else [])
    kin_dot, kin, air, xi_dyn = ref
    return [kin_dot, kin._asdict(), air._asdict(), xi_dyn]


def kernel_rows(name, out, n_ref):
    """The packed output of kinair, dynamics, finish_kin or finish_sys as
    a list of dicts of its row groups, the first n_ref of them."""
    from flightjax_torch.parallel import kernels as K
    layout = {"kinair": K.KINAIR_OUT, "dynamics": K.DYN_OUT,
              "finish_kin": K.FIN_OUT, "finish_sys": K.FSYS_OUT}[name]
    return K.unpack(layout, out, typed=True)[:n_ref]


def mega_inputs(dtype, comp):
    """(sim, SimState) of the cluster operands' fleet at step 126, with
    zero residuals when `comp`."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.models.c172.c172s import flagship_sim
    from flightjax_torch.testing import operand_state
    sim, _, _ = flagship_sim(DEVICE, dtype)
    st = operand_state(kernel_operands(), DEVICE, dtype, i0=126)
    return sim, st._replace(c=comp_residuals(st.x, force=True) if comp
                            else None)


def flight_operands(sim, st):
    """The packed operands (as `K.PACK` gives them) of the kernels but the
    geoid and the megakernel on the airborne flight fleet `st`
    (`testing.flight_operand_args`: the stage kernels at x + adt k1, the
    finish kernels with the k-sum 6 k1, finish_kin compensated as
    `Simulation.fleet_step` runs it, rk4_finish uncompensated as the
    vehicle path runs it)."""
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.testing import flight_operand_args
    return {name: K.PACK[name](*args)
            for name, args in flight_operand_args(sim, st).items()}


def ctl_flight_args(sim, st):
    """The arguments of `ctl_laws` at the C172Xv1 fleet `st`: its pass on
    the VehicleY there (the plain `Vehicle.output`) with its avionics."""
    aircraft = sim.system.aircraft
    vy = aircraft.vehicle.output(st.x["vehicle"], st.u["vehicle"],
                                 st.s["vehicle"])
    from flightjax_torch.parallel import kernels as K
    return (aircraft.avionics, K.ctl_y(vy), st.u["avionics"],
            st.s["avionics"], sim.periodic_dt)


def xv1_mega_inputs(dtype, comp, spp=1):
    """(sim, SimState) of the C172Xv1 cluster state with the mode-rich
    avionics (`testing.xv1_operand_state`, the kernel-check lanes) at step
    126, with zero residuals when `comp`; with `spp` 2 the pass fires
    every other step and every other lane's counter is odd."""
    from flightjax_torch.core.sim import Simulation, comp_residuals
    from flightjax_torch.models.c172.c172x import c172xv1_sim
    from flightjax_torch.testing import xv1_operand_state
    sim, _, _ = c172xv1_sim(DEVICE, dtype)
    if spp != 1:
        sim = Simulation(sim.system, dt=sim.dt, periodic_dt=spp * sim.dt,
                         geoid_every=sim.geoid_every)
    st = xv1_operand_state(B, SEED, DEVICE, dtype, GROUND_LANES,
                           TERMINATED_LANES, (CRASH_LANE,), i0=126)
    st = st._replace(i=st.i + torch.arange(B, dtype=torch.int32,
                                           device=DEVICE) % spp)
    return sim, st._replace(c=comp_residuals(st.x, force=True) if comp
                            else None)


def gdc_flight_args(sim, st):
    """The arguments of `gdc_ctl_laws` at the C172Xv2 fleet `st`: its pass
    on the VehicleY there (the plain `Vehicle.output`) with its
    avionics."""
    from flightjax_torch.parallel import kernels as K
    aircraft = sim.system.aircraft
    vy = aircraft.vehicle.output(st.x["vehicle"], st.u["vehicle"],
                                 st.s["vehicle"])
    return (aircraft.avionics, K.gdc_y(vy), st.u["avionics"],
            st.s["avionics"], sim.periodic_dt)


def xv2_mega_inputs(dtype, comp, spp=1):
    """(sim, SimState) of the C172Xv2 cluster state with the mode-rich
    guidance and control laws (`testing.xv2_operand_state`, the
    kernel-check lanes) at step 126, as `xv1_mega_inputs`."""
    from flightjax_torch.core.sim import Simulation, comp_residuals
    from flightjax_torch.models.c172.c172x import c172xv2_sim
    from flightjax_torch.testing import xv2_operand_state
    sim, _, _ = c172xv2_sim(DEVICE, dtype)
    if spp != 1:
        sim = Simulation(sim.system, dt=sim.dt, periodic_dt=spp * sim.dt,
                         geoid_every=sim.geoid_every)
    st = xv2_operand_state(B, SEED, DEVICE, dtype, GROUND_LANES,
                           TERMINATED_LANES, (CRASH_LANE,), i0=126)
    st = st._replace(i=st.i + torch.arange(B, dtype=torch.int32,
                                           device=DEVICE) % spp)
    return sim, st._replace(c=comp_residuals(st.x, force=True) if comp
                            else None)


def msn_flight_args(sim, st):
    """The arguments of `msn_ctl_laws` at the mission fleet `st`: its pass
    on the VehicleY there (the plain `Vehicle.output`) with its avionics
    and the systems' inputs."""
    from flightjax_torch.parallel import kernels as K
    aircraft = sim.system.aircraft
    vy = aircraft.vehicle.output(st.x["vehicle"], st.u["vehicle"],
                                 st.s["vehicle"])
    return (aircraft.avionics, K.msn_y(vy), st.u["avionics"],
            st.s["avionics"], sim.periodic_dt, st.u["vehicle"]["systems"])


def msn_mega_inputs(dtype, comp, spp=1):
    """(sim, SimState) of the mission's cluster state (`testing.
    msn_operand_state`: the C172Xv2 cluster state with the mode-rich
    guidance and control laws, lanes in every phase and past the end, the
    kernel-check lanes) at step 126, as `xv1_mega_inputs`."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.testing import msn_operand_state, msn_sim
    sim = msn_sim(DEVICE, dtype, spp)
    st = msn_operand_state(B, SEED, DEVICE, dtype, GROUND_LANES,
                           TERMINATED_LANES, (CRASH_LANE,), i0=126)
    st = st._replace(i=st.i + torch.arange(B, dtype=torch.int32,
                                           device=DEVICE) % spp)
    return sim, st._replace(c=comp_residuals(st.x, force=True) if comp
                            else None)


def msn_overrides(sim, st, new):
    """The guidance's inputs the mission's pass of the step from `st` to
    `new` reads (the lanes' phases at `st` applied to its stored inputs, at
    the VehicleY of `new`) and the guidance's mode there."""
    aircraft = sim.system.aircraft
    vy = aircraft.vehicle.output(new.x["vehicle"], new.u["vehicle"],
                                 new.s["vehicle"])
    u = aircraft.avionics.overrides(st.s["avionics"], st.u["avionics"], vy)
    mode = aircraft.avionics.inner.gdc.f_periodic(u["gdc"], vy).mode
    return u["gdc"], mode


def gdc_branches(u_gdc, mode):
    """(segment lanes, circle lanes) of a guidance pass whose mode after
    the ground override is `mode`: the branch each lane works out. Where
    `u_gdc` is given (the megakernel, which writes no GdcY), only the lanes
    whose lateral or vertical guidance is requested in a guided mode."""
    from flightjax_torch.models.c172.c172x_gdc import (GDC_CIRCULAR,
                                                       GDC_DIRECT)
    need = torch.ones_like(mode, dtype=torch.bool)
    if u_gdc is not None:
        need = (mode != GDC_DIRECT) & (u_gdc["hor_gdc_req"]
                                       | u_gdc["vrt_gdc_req"])
    crc = mode == GDC_CIRCULAR
    return need & ~crc, need & crc


def gain_values(avionics, EAS, h, lon_mode, lat_mode):
    """The gain values one pass reads: the corners of each lane's (EAS, h)
    cell in each table its lon and lat modes enable, a value shared by
    lanes once."""
    lk = control_laws(avionics).gains["v2t"]["k_p"]  # every table's grid
    cells = []
    for x, ax, uni in zip((EAS, h), lk.axes, lk._uni):
        i = torch.floor((x - uni[0]) / uni[1]).long()
        cells.append(i.clamp(0, ax.numel() - 2).tolist())
    width = gain_widths(avionics)
    seen = set()
    for i0, i1, lon, lat in zip(*cells, lon_mode.tolist(), lat_mode.tolist()):
        for side, m in (("lon", lon), ("lat", lat)):
            for ch, modes in CTL_PARTS[side].items():
                if m in modes and ch in width:
                    seen.update((ch, i0 + a, i1 + b) for a in (0, 1)
                                for b in (0, 1))
    return sum(width[ch] for ch, _, _ in seen)


# ------------------------------------------------------------ paths

def fleet(dtype, seed=SEED):
    from flightjax_torch.testing import perturbed_fleet_sim
    return perturbed_fleet_sim(B, seed, DEVICE, dtype)


def xv1_fleet(dtype, seed=SEED):
    """The C172Xv1 on the turning climb, `B` perturbed aircraft."""
    from flightjax_torch.testing import xv1_fleet_sim
    return xv1_fleet_sim(B, seed, DEVICE, dtype)


def msn_fleet(dtype, seed=SEED):
    """The mission fleet, `B` aircraft: (sim, SimState, (landing lanes,
    pattern lanes))."""
    from flightjax_torch.testing import msn_fleet_sim
    return msn_fleet_sim(B, seed, DEVICE, dtype)


def xv2_fleet(dtype, seed=SEED):
    """The C172Xv2 on its guidance scenario, `B` perturbed aircraft:
    (sim, SimState, (segment lanes, circle lanes, idle lanes, h0))."""
    from flightjax_torch.testing import xv2_fleet_sim
    return xv2_fleet_sim(B, seed, DEVICE, dtype)


def at_step(sim, st, i0):
    """`st` moved to step counter i0 (t to match)."""
    return st._replace(i=torch.full_like(st.i, i0),
                       t=torch.full_like(st.t, sim.t_start + i0 * sim.dt))


def plain_rollout(sim, st, n, geoid_every=None):
    """`n` steps of the plain cluster step (no kernel), from the state's
    step counter."""
    from flightjax_torch.parallel.clusterstep import cluster_step
    i = int(st.i[0])
    for k in range(n):
        st = cluster_step(sim, st, i + k, plain=True, geoid_every=geoid_every)
    return st


def plain_reference(label, n, dtype_name):
    """A worker's task: the plain reference of phase 4's path `label` over
    `n` steps, on its fleet made anew in `dtype_name` (the same lanes from
    the same seed), returned on the CPU."""
    from flightjax_torch.core.modeling import tree_map
    from flightjax_torch.parallel import kernels as K
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prefix = next((p for p in ("xv1_", "xv2_", "msn_")
                   if label.startswith(p)), "")
    f = {"": fleet, "xv1_": xv1_fleet, "xv2_": xv2_fleet,
         "msn_": msn_fleet}[prefix](getattr(torch, dtype_name))
    K.reset_launches()
    ref = Paths(f[0], f[1], prefix).run_plain(label, n)
    torch.cuda.synchronize()
    if any(K.LAUNCHES.values()):
        raise AssertionError(f"{label}: plain run launched a kernel")
    return tree_map(lambda v: v.cpu(), ref)


def plain_references():
    """Phase 4's plain references, float32 over PATH_STEPS and float64 over
    F64_STEPS, started in PLAIN_WORKERS worker processes (the longest
    first): (the pool, closed, and terminated at exit if still running;
    {(label, dtype name): AsyncResult})."""
    pool = multiprocessing.get_context("spawn").Pool(PLAIN_WORKERS)
    atexit.register(pool.terminate)
    tasks = sorted(PATH_STEPS.items(), key=lambda kv: -kv[1])
    pending = {(label, "float32"): pool.apply_async(
        plain_reference, (label, n, "float32")) for label, n in tasks}
    for label in ("subsystems", "vehicle", "megakernel") + XV_PATHS + \
            MSN_PATHS:
        n = F64_STEPS["msn" if label in MSN_PATHS else ""]
        pending[label, "float64"] = pool.apply_async(
            plain_reference, (label, n, "float64"))
    pool.close()
    return pool, pending


def plain_result(pending, label, dtype_name):
    """A worker's plain reference, back on the card."""
    from flightjax_torch.core.modeling import tree_map
    return tree_map(lambda v: v.to(DEVICE),
                    pending.pop((label, dtype_name)).get())


class Paths:
    """The kernel paths and their plain references on one fleet (the
    C172S's three, or with `prefix` "xv1_" the C172Xv1's three): `run(label,
    n)` steps a path from its start state and returns the final
    SimState."""

    def __init__(self, sim, st0, prefix=""):
        from flightjax_torch.parallel.clusterstep import make_cluster_step
        from flightjax_torch.parallel.megakernel import make_megakernel_step
        self.sim, self.prefix = sim, prefix
        self.st = {"subsystems": at_step(sim, st0, SUB_I0),
                   "vehicle": st0._replace(c=None), "megakernel": st0}
        self.vehicle = make_cluster_step(sim, self.st["vehicle"],
                                         split="vehicle")
        self.bufs, self.step_packed, self.unpack = make_megakernel_step(
            sim, st0)

    def run(self, label, n, watch=None):
        """`watch(state)`, if given, sees the state after every step (the
        subsystems path then takes its steps one `fleet_rollout` each)."""
        from flightjax_torch.parallel.fleet import fleet_rollout
        label = label[len(self.prefix):]
        if label == "subsystems":
            if watch is None:
                return fleet_rollout(self.sim, self.st[label], n)
            st = self.st[label]
            for _ in range(n):
                st = fleet_rollout(self.sim, st, 1)
                watch(st)
            return st
        if label == "vehicle":
            st = self.st[label]
            i0 = int(st.i[0])
            for k in range(n):
                st = self.vehicle(st, i=i0 + k)
                if watch is not None:
                    watch(st)
            return st
        bufs = self.bufs
        for _ in range(n):
            bufs = self.step_packed(bufs)
            if watch is not None:
                watch(self.unpack(bufs))
        return self.unpack(bufs)

    def flight(self, n, snap_at):
        """n megakernel steps from the start state, watching each lane's
        stall flag in the buffer: (the state after n steps, the state after
        snap_at steps, each lane's stall flag or-ed over the flight)."""
        from flightjax_torch.parallel import kernels as K
        aircraft = self.sim.system.aircraft
        lay = K.layout_of(aircraft.vehicle, aircraft.avionics)
        row = 1 + K.rows_of(lay.rkfin_in, ("aero", "stall")).start
        bufs, snap = self.bufs, None
        stalled = torch.zeros_like(bufs[0][row], dtype=torch.bool)
        for k in range(n):
            bufs = self.step_packed(bufs)
            stalled.logical_or_(bufs[0][row] > 0.5)
            if k + 1 == snap_at:
                snap = self.unpack(bufs)
        return self.unpack(bufs), snap, stalled

    def run_plain(self, label, n):
        label = label[len(self.prefix):]
        st = self.st[label]
        if label == "megakernel":
            return plain_rollout(self.sim, st, n, geoid_every=1)
        return plain_rollout(self.sim, st, n)


def expected_launches(label, n, i0=0):
    """The launch counts of `n` steps of a path from step i0."""
    from flightjax_torch.parallel import kernels as K
    want = dict.fromkeys(K.LAUNCHES, 0)
    geoid = sum((i0 + k + 1) % 128 == 0 for k in range(n))
    fbw = "_fbw" if label.startswith(("xv1_", "xv2_", "msn_")) else ""
    av = label[:3] if fbw else None
    label = label[len("xv1_"):] if fbw else label
    if label == "subsystems":
        want.update({"kinair": 4 * n, "systems" + fbw: 4 * n,
                     "dynamics": 4 * n, "finish_kin": n,
                     "finish_sys" + fbw: n, "geoid": geoid})
    elif label == "vehicle":
        want.update({"rk4_stage" + fbw: 4 * n, "rk4_finish" + fbw: n,
                     "geoid": geoid})
    else:
        want[{"xv2": "megakernel_gdc", "msn": "megakernel_msn"}.get(
            av, "megakernel" + fbw)] = n
    if fbw and label != "megakernel":  # the pass after every step
        want[{"xv2": "gdc_ctl_laws", "msn": "msn_ctl_laws"}.get(
            av, "ctl_laws")] = n
    return want


def eas(state):
    from flightjax_torch.parallel import kernels as K
    xv, uv, sv = state.x["vehicle"], state.u["vehicle"], state.s["vehicle"]
    z = lambda d: {k: torch.zeros_like(v) for k, v in d.items()}
    _, kin, air, _ = K.kinair_plain(
        xv["kinematics"], xv["dynamics"], z(xv["kinematics"]),
        z(xv["dynamics"]), sv["geoid_N"], uv["atm"], 0.0,
        torch.zeros_like(sv["geoid_N"]))
    return air.EAS


def compare_runs(a, b):
    """Kernel run `a` against plain run `b`: position (m), velocity (m/s),
    attitude (rad), EAS (m/s)."""
    from flightjax_torch.ops.geodesy import nvector_from_qew
    ka, kb = a.x["vehicle"]["kinematics"], b.x["vehicle"]["kinematics"]
    da, db = a.x["vehicle"]["dynamics"], b.x["vehicle"]["dynamics"]
    dn = (nvector_from_qew(ka["q_ew"].double())
          - nvector_from_qew(kb["q_ew"].double())).norm(dim=-1) * 6.371e6
    pos = float(torch.maximum(dn, (ka["h_e"].double()
                                   - kb["h_e"].double()).abs()).max())
    vel = float((da["v_eb_b"].double() - db["v_eb_b"].double()).abs().max())
    att = float(2 * (ka["q_wb"].double() - kb["q_wb"].double()).norm(
        dim=-1).max())
    de = float((eas(a).double() - eas(b).double()).abs().max())
    return pos, vel, att, de


def check_autopilot(label, out):
    """The C172Xv1's servo commands within their ranges, every lane in the
    turning climb's modes, and, once every lane's clock has passed a
    second (the fleet starts from 50 m/s), the fleet's mean EAS within
    3 m/s of the 45 m/s it is flown to."""
    from flightjax_torch.models.c172 import c172x_ctl as CTL
    from flightjax_torch.models.c172.c172x import ACT_RANGES
    act = out.u["vehicle"]["systems"]["act"]
    for ch in ("throttle", "aileron", "elevator", "rudder"):
        lo, hi = ACT_RANGES[ch]
        if not bool(((act[ch] >= lo) & (act[ch] <= hi)).all()):
            raise AssertionError(f"{label}: {ch} command out of range")
    lon = out.s["avionics"]["lon"]["mode_prev"]
    lat = out.s["avionics"]["lat"]["mode_prev"]
    if not (bool((lon == CTL.LON_EAS_CLM).all())
            and bool((lat == CTL.LAT_CHI_BETA).all())):
        raise AssertionError(f"{label}: a lane left the autopilot modes")
    cmd = {ch: (float(act[ch].min()), float(act[ch].max()))
           for ch in ("throttle", "aileron", "elevator", "rudder")}
    mean = float(eas(out).double().mean())
    log(f"{label}: commands {cmd}, every lane in LON_EAS_CLM / "
        f"LAT_CHI_BETA, mean EAS {mean:.2f} m/s (flown to 45)")
    if float(out.t.min()) >= 1.0 and not abs(mean - 45.0) < 3.0:
        raise AssertionError(f"{label}: the fleet's mean EAS is {mean}")


def check_guidance(label, out, lanes):
    """The C172Xv2's servo commands within their ranges, every lane in
    course hold and in the altitude modes (the engaged lanes by their
    guidance, the idle lanes by their own requests)."""
    from flightjax_torch.models.c172 import c172x_ctl as CTL
    from flightjax_torch.models.c172.c172x import ACT_RANGES
    act = out.u["vehicle"]["systems"]["act"]
    for ch in ("throttle", "aileron", "elevator", "rudder"):
        lo, hi = ACT_RANGES[ch]
        if not bool(((act[ch] >= lo) & (act[ch] <= hi)).all()):
            raise AssertionError(f"{label}: {ch} command out of range")
    ctl = out.s["avionics"]["ctl"]
    lon, lat = ctl["lon"]["mode_prev"], ctl["lat"]["mode_prev"]
    alt = (lon == CTL.LON_EAS_ALT) | (lon == CTL.LON_THR_EAS)
    if not (bool(alt.all()) and bool((lat == CTL.LAT_CHI_BETA).all())):
        raise AssertionError(f"{label}: a lane left the guided modes")
    cmd = {ch: (float(act[ch].min()), float(act[ch].max()))
           for ch in ("throttle", "aileron", "elevator", "rudder")}
    log(f"{label}: commands {cmd}, every lane in LAT_CHI_BETA and "
        f"LON_EAS_ALT ({int((lon == CTL.LON_EAS_ALT).sum())}) or "
        f"LON_THR_EAS ({int((lon == CTL.LON_THR_EAS).sum())}); "
        f"{len(lanes[2])} lanes not engaged")


def check_guided_flight(label, sim, out, lanes):
    """The C172Xv2 fleet after its flight, on the median lane of each kind,
    against the bounds of the JAX package's guidance tests
    (`tests/test_c172x2.py:131-138`, `:170-180`): segment lanes' ground
    course within 0.05 rad of pi / 2, height within 5 m of the segment's,
    cross-track error under 500 m; circle lanes' radial error under 150 m,
    height within 5 m of the circle's. The spread across lanes beside."""
    import math
    from flightjax_torch.models.c172.c172x_gdc import (circle_data,
                                                       segment_data)
    from flightjax_torch.ops.attitude import wrap_to_pi
    seg, crc, idle, h0 = lanes
    seg = torch.as_tensor(sorted(set(seg) - set(idle)), device=DEVICE)
    crc = torch.as_tensor(sorted(set(crc) - set(idle)), device=DEVICE)
    vy = sim.system.aircraft.vehicle.output(out.x["vehicle"],
                                            out.u["vehicle"], out.s["vehicle"])
    kin, g = vy.kinematics, out.u["avionics"]["gdc"]
    d = segment_data(g["target"], kin.n_e, kin.h_e)
    c = circle_data(g["orbit"], kin.n_e, kin.h_e)
    dh = (kin.h_e - h0).abs()
    rows = {"segment |chi_gnd - pi/2| (rad)": (wrap_to_pi(
                kin.chi_gnd - math.pi / 2).abs(), seg, 0.05),
            "segment |h_e - h0| (m)": (dh, seg, 5.0),
            "segment |e_sb| (m)": (d.e_sb.abs(), seg, 500.0),
            "circle |e_cb| (m)": (c.e_cb.abs(), crc, 150.0),
            "circle |h_e - h0| (m)": (dh, crc, 5.0)}
    far = (dh > 100.0).nonzero().flatten()
    ctl = out.s["avionics"]["ctl"]["lon"]
    log(f"{label}: {far.numel()} lanes more than 100 m from the guidance's "
        f"altitude: lanes {far[:12].tolist()}, lon modes "
        f"{ctl['mode_prev'][far[:12]].tolist()}, altitude machine "
        f"{ctl['h_state'][far[:12]].tolist()}, h_e - h0 "
        f"{[round(float(v), 1) for v in (kin.h_e - h0)[far[:12]]]}, bank "
        f"{[round(float(v), 3) for v in kin.e_nb[far[:12], 2]]}")
    for what, (v, idx, lim) in rows.items():
        v = v[idx].double()
        q = torch.quantile(v, torch.tensor([0.05, 0.5, 0.95], device=DEVICE,
                                           dtype=torch.float64))
        log(f"{label}: {what}: median {float(q[1]):.4g} (bound {lim}), "
            f"5-95% {float(q[0]):.4g}..{float(q[2]):.4g}, min "
            f"{float(v.min()):.4g}, max {float(v.max()):.4g} over "
            f"{v.numel()} lanes")
        if not float(q[1]) < lim:
            raise AssertionError(f"{label}: median {what} {float(q[1])} "
                                 f">= {lim}")


def check_mission(label, out, terminated=False):
    """The mission fleet: every leaf finite, every servo command within its
    range (the control laws' and the phases' flaps and brakes), and unless
    `terminated` no lane terminated. Logs the lanes per phase."""
    from flightjax_torch.models.c172.c172x import ACT_RANGES
    for p, v in leaves({"x": out.x, "s": out.s, "c": out.c, "t": out.t,
                        "u": out.u}):
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite leaf {p}")
    act = out.u["vehicle"]["systems"]["act"]
    for ch, (lo, hi) in ACT_RANGES.items():
        if not bool(((act[ch] >= lo) & (act[ch] <= hi)).all()):
            raise AssertionError(f"{label}: {ch} command out of range")
    term = int(out.s["terminated"].sum())
    phases = torch.bincount(out.s["avionics"]["phase"].long(),
                            minlength=10).tolist()
    log(f"{label}: t = {float(out.t[0]):.2f} s, lanes per phase {phases}, "
        f"{term} lanes terminated, every command within its range")
    if term and not terminated:
        raise AssertionError(f"{label}: {term} lanes terminated")


def msn_flight(paths, n, snaps, lanes):
    """n megakernel steps of the mission fleet from its start: ({k: the
    state after k steps} for k in `snaps` and n, each landing lane's
    cross-track error from the final leg where it was first found rolling
    out, NaN if never), the rollout looked for every MSN_EVERY steps on
    the buffer's own rows."""
    from flightjax_torch.models.c172 import c172x_gdc as GDC
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.ops.geodesy import nvector_from_qew
    from flightjax_torch.parallel import kernels as K
    aircraft = paths.sim.system.aircraft
    lay = K.layout_of(aircraft.vehicle, aircraft.avionics)
    row_ph = K.rows_of(lay.mega, "phase").start
    q_rows, h_row = (K.rows_of(lay.mega, "q_ew"),
                     K.rows_of(lay.mega, "h_e").start)
    bufs = paths.bufs
    land = torch.as_tensor(lanes[0], device=bufs[0].device)
    final = GDC.Segment(*(v.to(device=bufs[0].device, dtype=bufs[0].dtype)
                          for v in M.lows_pattern()["final"]))
    touch = torch.full(land.shape, float("nan"), dtype=torch.float64,
                       device=land.device)
    seen = torch.zeros(land.shape, dtype=torch.bool, device=land.device)
    out = {}
    for k in range(1, n + 1):
        bufs = paths.step_packed(bufs)
        if k % MSN_EVERY == 0:
            b = bufs[0][:, land]
            new = (b[row_ph] > M.GROUND - 0.5) & ~seen
            e = GDC.segment_data(final, nvector_from_qew(b[q_rows].t()),
                                 b[h_row]).e_sb.double()
            touch = torch.where(new, e, touch)
            seen |= new
        if k in snaps or k == n:
            out[k] = paths.unpack(bufs)
    return out, touch


def check_mission_gates(label, sim, st0, at20, at40, lanes):
    """The JAX mission tests' bounds at their own times, on the median lane
    (`tests/test_missions.py:56-87`): at 20 s the landing lanes still in
    the final, 10-60 m lower than at the start and under 100 m off the
    final leg's track; at 40 s the pattern lanes past the startup (phase 2
    or later) with the engine running; no lane terminated by 40 s."""
    from flightjax_torch.models.c172 import c172x_gdc as GDC
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.physics.piston import ENG_RUNNING
    land = torch.as_tensor(lanes[0], device=DEVICE)
    pattern = torch.as_tensor(lanes[1], device=DEVICE)
    vehicle = sim.system.aircraft.vehicle
    y20 = vehicle.output(at20.x["vehicle"], at20.u["vehicle"],
                         at20.s["vehicle"])
    final = GDC.Segment(*(v.to(device=DEVICE, dtype=st0.t.dtype)
                          for v in M.lows_pattern()["final"]))
    e = GDC.segment_data(final, y20.kinematics.n_e, y20.kinematics.h_e).e_sb
    sink = (st0.x["vehicle"]["kinematics"]["h_e"]
            - at20.x["vehicle"]["kinematics"]["h_e"])
    med = lambda v: float(torch.quantile(v.double(), 0.5))
    ph20 = at20.s["avionics"]["phase"][land].double()
    ph40 = at40.s["avionics"]["phase"][pattern].double()
    eng40 = at40.s["vehicle"]["systems"]["pwp"]["engine"]["state"][
        pattern].double()
    rows = {"landing lanes' phase at 20 s (final is 7)": (ph20, 7, 7),
            "landing lanes' sink over 20 s (m)": (sink[land], 10.0, 60.0),
            "landing lanes' |e_sb| from the final leg at 20 s (m)": (
                e[land].abs(), 0.0, 100.0),
            "pattern lanes' phase at 40 s (>= 2)": (ph40, 2, 9),
            "pattern lanes' engine state at 40 s (running is 2)": (
                eng40, ENG_RUNNING, ENG_RUNNING)}
    for what, (v, lo, hi) in rows.items():
        m = med(v)
        log(f"{label}: {what}: median {m:.4g} (bound {lo}..{hi}), min "
            f"{float(v.min()):.4g}, max {float(v.max()):.4g} over "
            f"{v.numel()} lanes")
        if not lo <= m <= hi:
            raise AssertionError(f"{label}: median {what} {m} not in "
                                 f"{lo}..{hi}")
    term = int(at40.s["terminated"].sum())
    log(f"{label}: {term} lanes terminated by 40 s")
    if term:
        raise AssertionError(f"{label}: {term} lanes terminated by 40 s")


def report_mission(label, sim, end, touch, lanes):
    """The fleet at the end of the circuit, reported and not gated (the
    reference's behaviour): lanes per phase, terminated lanes, the landing
    lanes' cross-track error at touchdown and share stopped (ground speed
    under 2 m/s), the pattern lanes' highest phase."""
    from flightjax_torch.models.c172 import missions as M
    land = torch.as_tensor(lanes[0], device=DEVICE)
    pattern = torch.as_tensor(lanes[1], device=DEVICE)
    vy = sim.system.aircraft.vehicle.output(end.x["vehicle"],
                                            end.u["vehicle"],
                                            end.s["vehicle"])
    phase = end.s["avionics"]["phase"]
    down = touch[~touch.isnan()].abs()
    stopped = float((vy.kinematics.v_gnd[land] < 2.0).double().mean())
    per = {k: torch.bincount(phase[v].long(), minlength=10).tolist()
           for k, v in (("landing", land), ("pattern", pattern))}
    term = {k: int(end.s["terminated"][v].sum())
            for k, v in (("landing", land), ("pattern", pattern))}
    td = (f"median {float(down.median()):.3f} m, max "
          f"{float(down.max()):.3f} m" if down.numel() else "none")
    top = int(phase[pattern].max())
    name = M.traffic_pattern_phases()[min(top, M.GROUND)].name
    log(f"{label} at {float(end.t[0]):.1f} s (reported, not gated): lanes "
        f"per phase {per}; terminated {term}; landing lanes' |cross-track| "
        f"at touchdown over {down.numel()} lanes: {td}; landing lanes "
        f"stopped (v_gnd < 2 m/s): {stopped:.4f}; pattern lanes' highest "
        f"phase {top} ({name}), {int((phase[pattern] == M.GROUND).sum())} "
        f"of {pattern.numel()} rolling out")


# the EAS band of the C172S paths, trimmed at 50 m/s and flown open loop;
# the C172Xv1 lanes that turn in a 45 deg bank while climbing at full
# throttle bleed speed, so their floor is the C172's clean stall speed
# (48 KIAS, 24.7 m/s) in that bank: 24.7 / sqrt(cos 45 deg) = 29.4 m/s
EAS_BAND = {"c172s": (35.0, 70.0), "xv1": (29.4, 70.0)}


def stall_of(state):
    return state.s["vehicle"]["systems"]["aero"]["stall"]


def check_flight(sim, label, out, stalled, height_band=True):
    """Every leaf finite, no lane terminated, none stalled at any step
    (`stalled`: each lane's stall flag or-ed over the run), EAS and (with
    `height_band`, for the flights of a few seconds) height in band."""
    for p, v in leaves({"x": out.x, "s": out.s, "c": out.c, "t": out.t,
                        "u": out.u}):
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{label}: non-finite leaf {p}")
    if bool(out.s["terminated"].any()):
        raise AssertionError(f"{label}: a lane terminated")
    if bool(stalled.any()):
        raise AssertionError(f"{label}: {int(stalled.sum())} lanes stalled")
    h = sim.system.aircraft.vehicle.h_agl(out.x["vehicle"], out.u["vehicle"],
                                          out.s["vehicle"])
    e = eas(out)
    log(f"{label}: height above terrain {float(h.min()):.1f}.."
        f"{float(h.max()):.1f} m, EAS {float(e.min()):.2f}.."
        f"{float(e.max()):.2f} m/s, t = {float(out.t[0]):.2f} s")
    if height_band and not (800.0 < float(h.min())
                            and float(h.max()) < 1300.0):
        raise AssertionError(f"{label}: height left the 800..1300 m band")
    lo, hi = EAS_BAND["xv1" if label in XV_PATHS + A2_PATHS else "c172s"]
    if not (lo < float(e.min()) and float(e.max()) < hi):
        raise AssertionError(f"{label}: EAS left the {lo}..{hi} m/s band")


# ------------------------------------------------------------ turbulence

def turb_gusts(sim, st):
    """Each lane's body-axes gust at the state `st` from its filter states,
    with the plain `DrydenTurbulence.gust` at the airspeed against the
    sheared mean wind and the height above the terrain
    (`Vehicle.apply_disturbances`), and the lanes' (sigma_u, sigma_v,
    sigma_w) from `scales` there: a check beside the path, not on it."""
    from flightjax_torch.ops.quaternions import qrot_inv
    from flightjax_torch.physics.atmosphere import norm3
    from flightjax_torch.physics.kinematics import WA
    from flightjax_torch.physics.turbulence import scales, shear_scale
    vehicle = sim.system.aircraft.vehicle
    xv, uv, sv = st.x["vehicle"], st.u["vehicle"], st.s["vehicle"]
    _, kin = WA().f_ode(xv["kinematics"], xv["dynamics"], sv["geoid_N"])
    h_agl = kin.h_o - vehicle.terrain.terrain_data(uv["trn"]).elevation
    k = shear_scale(uv["turb"], h_agl)
    wind = uv["atm"]["wind"]
    v_mean = wind * torch.stack([k, k, torch.ones_like(k)], dim=-1)
    V = norm3(kin.v_eb_b - qrot_inv(kin.q_nb, v_mean))
    g = vehicle.turbulence.gust(xv["turb"], uv["turb"], V, h_agl, st.t)
    _, _, _, s_u, s_v, s_w = scales(h_agl, uv["turb"]["W20"])
    return g, torch.stack([s_u, s_v, s_w], dim=-1)


def turb_phase(card, t_start, check, errs, regs, sizes):
    """The turbulent C172S: its three kernel instances against their plain
    versions; its three paths against their plain paths; the gust-load
    study; BASELINE's Monte Carlo flight; the instances' timings and the
    paths' profiles. Returns the instances' rows of the kernels line."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.demos.c172_demos import turbulent_fleet_loads
    from flightjax_torch.models.c172.c172s import (build_vehicle,
                                                   turbulent_flagship_sim)
    from flightjax_torch.ops import random as R
    from flightjax_torch.parallel import fleet as F
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.clusterstep import (make_cluster_step,
                                                      vehicle_step)
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.physics.turbulence import FT, V_MIN, DrydenTurbulence
    from flightjax_torch.testing import (turb_operand_args,
                                         turb_operand_state, turb_operands,
                                         turb_study_sim)
    from profile_torch_step import profile

    # kernel checks: f64 to 1e-12 and f32 to 1e-5, at 32 and 64 aircraft
    # per block, on the turbulent operands
    log(f"elapsed {time.time() - t_start:.1f} s (turbulence: kernel checks)")
    d = turb_operands(B, SEED, GROUND_LANES, TERMINATED_LANES, (CRASH_LANE,))
    h_ft = (d["x_kin"]["h_e"] - d["geoid_N"]) / FT
    u, tau = d["u_turb"], (d["t"] - d["u_turb"]["gust_t0"]) / d[
        "u_turb"]["gust_T"]
    v = (d["x_dyn"]["v_eb_b"] ** 2).sum(-1) ** 0.5
    log(f"turbulent operands: W20 {sorted(set(u['W20'].tolist()))}; lanes "
        f"below 10 ft {int((h_ft < 10).sum())}, in the low band "
        f"{int(((h_ft >= 10) & (h_ft < 1000)).sum())}, in the blend "
        f"{int(((h_ft >= 1000) & (h_ft < 2000)).sum())}, above 2000 ft "
        f"{int((h_ft >= 2000).sum())}; V below V_MIN "
        f"{int((v < V_MIN).sum())}; shear on {int((u['shear_z0_ft'] > 0).sum())}"
        f" (h below z0 {int((h_ft < u['shear_z0_ft']).sum())}); discrete "
        f"gust before {int((tau < 0).sum())}, during "
        f"{int(((tau >= 0) & (tau <= 2)).sum())}, after {int((tau > 2).sum())}"
        f"; seeds above 2^24 {int((u['seed'] > 2 ** 24).sum())}; terminated "
        f"{list(TERMINATED_LANES)}, crashing {CRASH_LANE}")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        vehicle = build_vehicle(device=DEVICE, dtype=dtype,
                                turbulence=DrydenTurbulence(0.02))
        args = turb_operand_args(d, vehicle, DEVICE, dtype)
        for name, comp in (("rk4_stage_turb", False),
                           ("rk4_finish_turb", False),
                           ("rk4_finish_turb", True)):
            a = args[name[:-len("_turb")]]
            if name == "rk4_finish_turb" and not comp:
                a = a[:7] + (None,) + a[8:]
            ref = getattr(K, name[:-len("_turb")] + "_plain")(*a)
            for lanes in (32, 64):
                buf, n_out, scal, ops = K.PACK[name](*a)
                out = L.launch(name, buf, n_out, scal, block=lanes, **ops)
                got = K.unpack_out(name, out, comp, ops.get("ints"))
                torch.cuda.synchronize()
                check(name, dtype, tol, leaf_pairs(got, ref),
                      f" (turbulent operands, {'compensated, ' * comp}"
                      f"block {lanes})")
            if name == "rk4_finish_turb" and not (
                    bool(got[1]["crashed"][CRASH_LANE])
                    and torch.equal(got[-1]["n"], a[4]["turb"]["n"] + 1)):
                raise AssertionError("rk4_finish_turb: the crash lane or "
                                     "the drive's counter")
        sim, _, _ = turbulent_flagship_sim(DEVICE, dtype)
        st = turb_operand_state(d, DEVICE, dtype)
        for comp in (False, True):
            st_ = st._replace(c=comp_residuals(st.x, force=True) if comp
                              else None)
            ref = megakernel_step_plain(sim, st_)
            for lanes in (32, 64):
                bufs, step_packed, unpack = make_megakernel_step(
                    sim, st_, block=lanes)
                got = unpack(step_packed(bufs))
                torch.cuda.synchronize()
                if not (torch.equal(got.i, ref.i) and torch.equal(
                        got.s["vehicle"]["turb"]["n"],
                        ref.s["vehicle"]["turb"]["n"])
                        and bool(got.s["terminated"][CRASH_LANE])):
                    raise AssertionError("megakernel_turb: counters or the "
                                         "crash latch")
                check("megakernel_turb", dtype, tol, leaf_pairs(
                    (got.t, got.x, got.u, got.s, got.c),
                    (ref.t, ref.x, ref.u, ref.s, ref.c)),
                    f" (turbulent operands, comp {comp}, block {lanes})")
        del args, st, sim

    # the paths at B in f32 against their plain paths, launch counts from 0
    log(f"elapsed {time.time() - t_start:.1f} s (turbulence: paths)")
    tsim, tst0 = turb_study_sim(B, SEED, DEVICE, torch.float32)
    i0 = int(tst0.i[0])
    geoid = sum((i0 + k + 1) % 128 == 0 for k in range(TURB_STEPS))
    launches = {}

    def run_path(label, sim, st, n, plain=False):
        if label == "turb_megakernel":
            if plain:
                for _ in range(n):
                    st = megakernel_step_plain(sim, st)
                return st
            bufs, step_packed, unpack = make_megakernel_step(sim, st)
            for _ in range(n):
                bufs = step_packed(bufs)
            return unpack(bufs)
        comp = label == "turb_fleet"
        st = st if comp else st._replace(c=None)
        if plain:
            for k in range(n):
                st = vehicle_step(sim, st, i0 + k, comp=comp, plain=True)
            return st
        if comp:
            return F.fleet_rollout(sim, st, n)
        step = make_cluster_step(sim, st, split="vehicle")
        for k in range(n):
            st = step(st, i=i0 + k)
        return st

    for label in TURB_PATHS:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.time()
        out = run_path(label, tsim, tst0, TURB_STEPS)
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        want = dict.fromkeys(K.LAUNCHES, 0)
        if label == "turb_megakernel":
            want["megakernel_turb"] = TURB_STEPS
        else:
            want.update(rk4_stage_turb=4 * TURB_STEPS,
                        rk4_finish_turb=TURB_STEPS, geoid=geoid)
        log(f"{label}: {TURB_STEPS} steps x {B} aircraft from step {i0} in "
            f"{time.time() - t0:.2f} s (first run); launches "
            f"{ {k: v for k, v in got.items() if v} }")
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        for name, (_, _, path) in KERNELS.items():
            if path == label:
                launches[name] = got[name]
        for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
            if val.dtype.is_floating_point and not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"{label}: non-finite leaf {p}")
        if bool(out.s["terminated"].any()):
            raise AssertionError(f"{label}: a lane terminated")
        K.reset_launches()
        ref = run_path(label, tsim, tst0, TURB_STEPS, plain=True)
        torch.cuda.synchronize()
        if any(K.LAUNCHES.values()):
            raise AssertionError(f"{label}: plain run launched a kernel")
        pos, vel, att, de = compare_runs(out, ref)
        env = [e * TURB_STEPS / STEPS for e in (ENV_POS_M, ENV_VEL,
                                               ENV_ATT_RAD, ENV_EAS)]
        eta_err = rel_err(out.s["vehicle"]["turb"]["eta"],
                          ref.s["vehicle"]["turb"]["eta"])
        log(f"{label} kernels vs plain after {TURB_STEPS} steps (f32): "
            f"position {pos:.3e} m (env {env[0]:.3g}), velocity {vel:.3e} "
            f"m/s (env {env[1]:.3g}), attitude {att:.3e} rad (env "
            f"{env[2]:.3g}), EAS {de:.3e} m/s (env {env[3]:.3g}); the drive "
            f"{eta_err:.3e}")
        if not all(v_ <= e for v_, e in zip((pos, vel, att, de), env)):
            raise AssertionError(f"{label}: kernel and plain runs disagree")
        if not torch.equal(out.s["vehicle"]["turb"]["n"],
                           ref.s["vehicle"]["turb"]["n"]):
            raise AssertionError(f"{label}: the drive's counter")
    del out, ref
    sim64, st64 = turb_study_sim(B, SEED, DEVICE, torch.float64)
    for label in TURB_PATHS:
        a = run_path(label, sim64, st64, F64_STEPS[""])
        b = run_path(label, sim64, st64, F64_STEPS[""], plain=True)
        torch.cuda.synchronize()
        worst = max(rel_err(va, vb) for _, va, vb in leaf_pairs(
            {"x": a.x, "s": a.s, "u": a.u}, {"x": b.x, "s": b.s, "u": b.u}))
        log(f"{label} f64 {F64_STEPS['']} steps kernels vs plain: max rel "
            f"err {worst:.3e} (tol 1e-9)")
        if not worst <= 1e-9:
            raise AssertionError(f"{label}: f64 run disagrees")
    del sim64, st64, a, b

    # the gust-load study: the demo's own settings at BASELINE's batch
    log(f"elapsed {time.time() - t_start:.1f} s (turbulence: gust loads)")
    torch.cuda.synchronize()
    t0 = time.time()
    final, peaks, frac = turbulent_fleet_loads(batch=B, t_end=LOADS_T_END,
                                               W20=LOADS_W20)
    torch.cuda.synchronize()
    wall = time.time() - t0
    pk = peaks.double()
    log(f"gust-load study: B = {B}, {LOADS_T_END:.0f} s at W20 = "
        f"{LOADS_W20} m/s in {wall:.2f} s wall ({int(final.i[0])} steps, "
        f"loads every 5): peak n median {float(pk.median()):.4f}, max "
        f"{float(pk.max()):.4f}, min {float(pk.min()):.4f}; exceedance of "
        f"(1.5, 2.0, 2.5) {[round(float(f), 6) for f in frac]}; terminated "
        f"{int(final.s['terminated'].sum())} [{card}]")
    # the bounds of tests/test_missions.py:95-99, set for 8 lanes: finite
    # peaks above 0.7, the exceedance monotone, none terminated; the upper
    # bound 5 is held as the reference holds it at this fleet's size: the
    # JAX package's own run of the same study (tools/jax_turbulent_loads.py,
    # float32, the same draws) within LOADS_MATCH
    with open(JAX_LOADS) as fh:
        jref = json.load(fh)
    if (jref["batch"], jref["t_end"], jref["W20"], jref["seed"]) != (
            B, LOADS_T_END, LOADS_W20, 0):
        raise AssertionError(f"{JAX_LOADS} is of another study: {jref}")
    above = int((pk >= 5.0).sum())
    log(f"gust-load study against the JAX package's own run at B = "
        f"{jref['batch']} ({JAX_LOADS}, float32 on a CPU): median "
        f"{jref['median']:.4f}, max {jref['max']:.4f}, min {jref['min']:.4f}"
        f", exceedance {[round(f, 6) for f in jref['exceedance']]}, peaks "
        f"at 5 g or more {jref['above_5']} (here {above})")
    if not (bool(torch.isfinite(pk).all()) and float(pk.min()) > 0.7):
        raise AssertionError("gust-load study: a peak not finite or below "
                             "0.7")
    if not bool((frac[1:] - frac[:-1] <= 1e-12).all()):
        raise AssertionError("gust-load study: exceedance not monotone")
    if bool(final.s["terminated"].any()):
        raise AssertionError("gust-load study: a lane terminated")
    rel, fr = LOADS_MATCH
    if not (abs(float(pk.median()) - jref["median"]) <= rel * jref["median"]
            and abs(float(pk.max()) - jref["max"]) <= rel * jref["max"]
            and all(abs(float(a) - b) <= fr
                    for a, b in zip(frac, jref["exceedance"]))
            and (above == 0) == (jref["above_5"] == 0)):
        raise AssertionError("gust-load study: peaks and exceedance differ "
                             "from the JAX package's run")
    del final, peaks

    # BASELINE's Monte Carlo row: 4096 randomized C172S at W20 = 10 for
    # 600 s through the turbulent megakernel
    log(f"elapsed {time.time() - t_start:.1f} s (turbulence: Monte Carlo)")
    msim, mst, _ = turbulent_flagship_sim(DEVICE, torch.float32)
    mst = F.monte_carlo_c172(F.broadcast_state(mst, B),
                             R.PRNGKey(SEED, DEVICE))
    uv = mst.u["vehicle"]
    mst = mst._replace(u=dict(mst.u, vehicle=dict(uv, turb=dict(
        uv["turb"], W20=torch.full((B,), LOADS_W20, device=DEVICE)))))
    bufs, step_packed, unpack = make_megakernel_step(msim, mst)
    torch.cuda.synchronize()
    t0, done = time.time(), 0
    for at in MC_CHECKS:
        t1 = time.time()
        for _ in range(at - done):
            bufs = step_packed(bufs)
        torch.cuda.synchronize()
        log(f"Monte Carlo: steps {done}..{at} in {time.time() - t1:.2f} s "
            f"({(time.time() - t1) / (at - done) * 1e3:.4f} ms a step)")
        done = at
        st = unpack(bufs)
        for p, val in leaves({"x": st.x, "s": st.s}):
            if val.dtype.is_floating_point and not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"Monte Carlo: NaN in {p} at step {at}")
        term = st.s["terminated"]
        h = msim.system.aircraft.vehicle.h_agl(st.x["vehicle"],
                                               st.u["vehicle"],
                                               st.s["vehicle"])
        down = mst.u["vehicle"]["atm"]["wind"][:, 2]
        n_down = int((term & (down > 0)).sum())
        mean_down = float(down[term].mean()) if bool(term.any()) else 0.0
        log(f"Monte Carlo at {float(st.t[0]):.0f} s: {int(term.sum())} lanes "
            f"terminated (crashed on the terrain), {n_down} of them under a "
            f"downdraft (its mean {mean_down:.2f} m/s; the fleet's vertical "
            f"wind N(0, 5 m/s)); height of the "
            f"others {float(h[~term].min()):.1f}..{float(h[~term].max()):.1f}"
            f" m, EAS {float(eas(st)[~term].min()):.2f}.."
            f"{float(eas(st)[~term].max()):.2f} m/s")
        # none by 60 s; later a lane that sinks with its air mass reaches
        # the terrain and crashes there, as the reference's does
        if at == MC_CHECKS[0] and bool(term.any()):
            raise AssertionError(f"Monte Carlo: {int(term.sum())} lanes "
                                 f"terminated by step {at}")
        if bool(term.any()) and not bool((h[term] < 5.0).all()):
            raise AssertionError("Monte Carlo: a lane terminated above the "
                                 "terrain")
        g, sig = turb_gusts(msim, st)
        r = (g.double() / sig.double())[~term]
        ms2, mean = (r * r).mean(0), r.mean(0)
        log(f"Monte Carlo at {float(st.t[0]):.0f} s, the {int((~term).sum())}"
            f" lanes in flight: mean (gust/sigma)^2 (u, v, w) "
            f"{[round(float(v_), 4) for v_ in ms2]}, mean gust/sigma "
            f"{[round(float(v_), 4) for v_ in mean]}")
        if not (bool(((ms2 - 1).abs() <= 0.25).all())
                and bool((mean.abs() <= 0.2).all())):
            raise AssertionError(f"Monte Carlo: gust statistics at {at}")
    wall = time.time() - t0
    log(f"Monte Carlo: {B} lanes x {MC_CHECKS[-1]} steps "
        f"({MC_CHECKS[-1] * 0.02:.0f} s) through megakernel_turb in "
        f"{wall:.2f} s wall (two state reads and checks among them): "
        f"{B * MC_CHECKS[-1] / wall:.0f} vehicle-steps/s [{card}]")
    del bufs, st, mst

    # timings (f32, B) on the study fleet's state, and the paths' profiles
    log(f"elapsed {time.time() - t_start:.1f} s (turbulence: timings)")
    profiles = {}
    vehicle = tsim.system.aircraft.vehicle
    params = K.system_params(vehicle)
    grid = K.geoid_grid(vehicle.geoid)
    mbufs, mstep, munpack = make_megakernel_step(tsim, tst0)

    def mega(lanes=None):
        return L.launch_megakernel(mbufs[0], mbufs[1], params, grid, 0.02,
                                   0.0, True, lanes, turb=True)
    for label in TURB_PATHS:
        r = (graph_profile(label, "megakernel_turb", mstep, mbufs, mega)
             if label == "turb_megakernel" else profile(label, tsim, tst0,
                                                        20, 8))
        profiles[label] = r
        log(f"profile {label}: B = {B}, 20 steps, f32: host "
            f"{r['host_ms_per_step']:.4f} ms/step, device "
            f"{r['device_ms_per_step']:.4f} ms/step, idle share "
            f"{r['idle_share']:.4f}, {r['launches_per_step']:.1f} device "
            f"launches/step [{card}]")
        for t in r["top"]:
            log(f"  {t['ms_per_step']:9.4f} ms/step {t['per_step']:6.1f}"
                f"/step  {t['name'][:90]}")
    lay = K.TURB
    xv, uv, sv = (tst0.x["vehicle"], tst0.u["vehicle"], tst0.s["vehicle"])
    full = K.pack_vehicle(vehicle, xv, uv, sv, tst0.s["terminated"],
                          tst0.c["vehicle"]["kinematics"], t=tst0.t)
    ints = K.pack_turb_int(tst0.i, uv, sv)
    stage_in = full[:K.rows(lay.stage_in)]
    k1 = K.rk4_stage_packed(vehicle, stage_in, torch.zeros(
        (K.rows(lay.stage_out), B), device=DEVICE), 0.0)
    ksum = 6.0 * k1
    rows = []

    def share(label, name):
        """The kernel's share of its path's device time a step, both as
        the profiler reads them."""
        r = profiles[label]
        return sum(t["ms_per_step"] for t in r["top"]
                   if name in t["name"]) / r["device_ms_per_step"]

    cases = {
        "rk4_stage_turb": (
            lambda lanes=None: L.launch("rk4_stage_turb", stage_in, K.rows(
                lay.stage_out), (0.01,), block=lanes, k=k1, params=params),
            lambda: K.rk4_stage_packed(vehicle, stage_in, k1, 0.01),
            lambda: K.rk4_stage_packed_plain(vehicle, stage_in, k1, 0.01),
            stage_in.numel() + 2 * k1.numel() + params.numel(), 4),
        "rk4_finish_turb": (
            lambda lanes=None: L.launch(
                "rk4_finish_turb", full, K.rows(lay.rkfin_out),
                (0.02 / 6.0, 1, 0.02, 0.0), block=lanes, k=ksum,
                params=params, ints=ints),
            lambda: K.rk4_finish_packed(vehicle, full, ksum, 0.02, True,
                                        None, ints),
            lambda: K.rk4_finish_packed_plain(vehicle, full, ksum, 0.02,
                                              True, ints),
            full.numel() + ksum.numel() + K.rows(lay.rkfin_out) * B
            + ints.numel() + params.numel(), 1)}
    q_new = munpack(mstep(mbufs)).x["vehicle"]["kinematics"]["q_ew"]
    cases["megakernel_turb"] = (
        mega, lambda: mstep(mbufs),
        lambda: megakernel_step_plain(tsim, tst0),
        2 * (mbufs[0].numel() + mbufs[1].numel()) + params.numel()
        + geoid_cells(vehicle.geoid, q_new), 1)
    for name, (bare, wrapper, plain, n_elems, per_step) in cases.items():
        ms = graph_ms(bare)
        label = KERNELS[name][2]
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=launches[name],
            max_abs_err=errs[name], ms=ms,
            plain_ms=cuda_ms(plain, reps=3, calls=1, warm=1),
            nbytes=4 * n_elems, ops=count_ops(plain), library_ms=None,
            event_ms=cuda_ms(bare), wrapper_ms=cuda_ms(wrapper),
            block_ms={n: graph_ms(lambda: bare(n)) for n in (32, 64)},
            launches_per_step=per_step,
            share=share(label, name[:-len("_turb")] + "_"
                        if name != "megakernel_turb" else "megakernel_")))
    log("turbulent profiles: " + json.dumps(profiles))
    return rows


# ------------------------------------------------------------ navigation

def nav_at_epoch(st, n=9):
    """A sensor-fed fleet state `st` moved to step and sensor epoch `n`
    (at 9 its next firing makes the first GPS epoch, where every lane
    aids)."""
    av = st.s["avionics"]
    sens = dict(av["sens"], n=torch.full_like(av["sens"]["n"], n))
    return st._replace(i=torch.full_like(st.i, n),
                       t=torch.full_like(st.t, n * 0.02),
                       s=dict(st.s, avionics=dict(av, sens=sens)))


# the navigation megakernel of each of its paths
KERNELS_OF_PATH = {"nav_megakernel": "megakernel_nav_turb",
                   "sensor_fed_megakernel": "megakernel_nav"}


def nav_summary(peak_att, peak_pos, att_exc, pos_exc, alarm):
    """The numbers of one navigation study run, as `tools/jax_nav_study.py`
    records the JAX package's: the peaks' p50, p95 and max, the
    exceedance and alarm fractions."""
    import numpy as np
    att = peak_att.double().cpu().numpy()
    pos = peak_pos.double().cpu().numpy()
    return {"att_p50": float(np.percentile(att, 50.0)),
            "att_p95": float(np.percentile(att, 95.0)),
            "att_max": float(att.max()),
            "pos_p50": float(np.percentile(pos, 50.0)),
            "pos_p95": float(np.percentile(pos, 95.0)),
            "pos_max": float(pos.max()),
            "att_exceedance": [float(f) for f in att_exc],
            "pos_exceedance": [float(f) for f in pos_exc],
            "alarm_fraction": dict(alarm)}


def nav_held(name, dtype, got, ref, ref_cpu, s_got, s_ref, nav, what,
             errs, gate=None):
    """Hold a navigation kernel's output `got` to the card's plain run
    `ref` and the reference `ref_cpu` of `testing.nav_reference`
    (`testing.nav_hold`; `gate` a mission's lanes at its radar gate), log
    it and keep the float32 error against `ref` for the kernels line."""
    from flightjax_torch.testing import nav_hold
    p_err, n_bad, n_far, worst = nav_hold(dtype, got, ref, ref_cpu, s_got,
                                          s_ref, nav, f"{name}{what}", gate)
    top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:6]
    log(f"check {name}{what} {str(dtype)[6:]}: P per lane {p_err:.3e}; "
        f"integers and flags differ on {n_bad} lanes, {n_bad - n_far} of "
        f"them with an NIS near its gate; the worst leaves (error, limit) "
        + ", ".join(f"{k} {e:.2e} ({lim:.1e})" for k, (e, lim) in top))
    if dtype == torch.float32:
        keep = ~(s_got["sens"]["n"] != s_ref["sens"]["n"])
        inner = s_got.get("inner")
        if isinstance(inner, dict) and "phase" in inner:
            keep = keep & (inner["phase"] == s_ref["inner"]["phase"])
        for k in ("gps", "vel", "baro", "mag", "radar"):
            for f in ("bits", "alarm"):
                keep = keep & (s_got["mon_" + k][f].long()
                               == s_ref["mon_" + k][f].long())
        errs[name] = max(errs.get(name, 0.0), *(
            float((a.double() - b.double())[keep].abs().max())
            for _, a, b in leaf_pairs(got, ref) if a.dim()))


def nav_kernel_checks(t_start, errs):
    """nav_pass, megakernel_nav and megakernel_nav_turb at B, float64 and
    float32, 32 and 64 aircraft per block, on the mode-rich navigation
    operands (`testing.nav_operand_state`: the study's setting, the radar
    setting, shadow mode, the synthetic airflow angles, the covariance
    stepped every firing) and on the study's fleet at its first GPS epoch,
    against their plain versions (`testing.nav_hold`)."""
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (nav_fleet_sim, nav_operand_state,
                                         nav_pass_args, nav_reference)
    log(f"elapsed {time.time() - t_start:.1f} s (navigation: the "
        f"navigation kernels)")

    def study(dtype, turbulence=True):  # the study's first GPS epoch
        sim, st = nav_fleet_sim(B, SEED, DEVICE, dtype)
        av = st.s["avionics"]
        sens = dict(av["sens"], n=torch.full_like(av["sens"]["n"], 9))
        return sim, st._replace(
            i=torch.full_like(st.i, 9), t=torch.full_like(st.t, 0.18),
            s=dict(st.s, avionics=dict(av, sens=sens)))

    for dtype in (torch.float64, torch.float32):
        cases = [("mode-rich", lambda d, turbulence=True: nav_operand_state(
                      B, SEED, DEVICE, d, turbulence=turbulence), (True,
                                                                   False)),
                 ("mode-rich, radar", lambda d, turbulence=True:
                  nav_operand_state(B, SEED, DEVICE, d, setting="radar"),
                  ()),
                 ("mode-rich, shadow", lambda d, turbulence=True:
                  nav_operand_state(B, SEED, DEVICE, d, setting="shadow"),
                  (True,)),
                 ("mode-rich, synthetic", lambda d, turbulence=True:
                  nav_operand_state(B, SEED, DEVICE, d, setting="synthetic"),
                  (True,)),
                 ("mode-rich, immediate", lambda d, turbulence=False:
                  nav_operand_state(B, SEED, DEVICE, d, turbulence=turbulence,
                                    setting="immediate"), (False,)),
                 ("the study's fleet", study, (True,))]
        for what, make, megas in cases:
            sim, st = make(dtype)
            args = nav_pass_args(sim, st)
            ref = K.nav_pass_plain(*args)
            ref_c = nav_reference(sim, dtype, lambda s_, a: K.nav_pass_plain(
                s_.system.aircraft.avionics, *a), args[1:])
            for lanes in (32, 64):
                got = K.nav_pass(*args, block=lanes)
                torch.cuda.synchronize()
                nav_held("nav_pass", dtype, got, ref, ref_c, got[0], ref[0],
                         args[0], f" ({what}, block {lanes})", errs)
            # the megakernel's instances on the same state, turbulent (the
            # study's fleet) and calm
            for turb in megas:
                if not turb:
                    sim, st = make(dtype, turbulence=False)
                name = "megakernel_nav_turb" if turb else "megakernel_nav"
                ref = megakernel_step_plain(sim, st)
                ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
                tr = lambda x: (x.t, x.x, x.u, x.s)
                for lanes in (32, 64):
                    bufs, step_packed, unpack = make_megakernel_step(
                        sim, st, block=lanes)
                    got = unpack(step_packed(bufs))
                    torch.cuda.synchronize()
                    if not torch.equal(got.i, ref.i):
                        raise AssertionError(f"{name}: step counter")
                    nav_held(name, dtype, tr(got), tr(ref), tr(ref_c),
                             got.s["avionics"], ref.s["avionics"],
                             sim.system.aircraft.avionics,
                             f" ({what}, block {lanes})", errs)
            del sim, st, args, ref, ref_c


def nav_study(card, t_start, mega, launches):
    """The joint navigation study at B for NAV_T_END (through
    `make_megakernel_step` with `mega`), its launches counted from 0 (the
    navigation kernels' counts of the kernels line, into `launches`), held
    to the JAX package's run of it (`tools/jax_nav_study.json`): the
    peaks' p50 and p95 within 2%, the exceedance fractions within 0.01,
    the alarm fractions within 0.001 of its (none where it has none).
    Returns the wall seconds."""
    from flightjax_torch.demos.estimation_demos import joint_navigation_study
    from flightjax_torch.parallel import kernels as K
    how = "megakernel_nav_turb" if mega else "fleet_step"
    log(f"elapsed {time.time() - t_start:.1f} s (navigation: the study "
        f"through {how})")
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.time()
    r = joint_navigation_study(B, t_end=NAV_T_END, megakernel=mega)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n = int(round(NAV_T_END / 0.02))
    want = ({"megakernel_nav_turb": n} if mega else
            {"rk4_stage_fbw_turb": 4 * n, "rk4_finish_fbw_turb": n,
             "systems_fbw": n, "nav_pass": n, "ctl_laws": n, "geoid": n})
    got_l = {k: v for k, v in K.LAUNCHES.items() if v}
    if got_l != want:
        raise AssertionError(f"navigation study through {how}: launches "
                             f"{got_l} != {want}")
    name = "megakernel_nav_turb" if mega else "nav_pass"
    launches[name] = got_l[name]
    got = nav_summary(r["peak_att_deg"], r["peak_pos_m"],
                      r["att_exceedance"].tolist(),
                      r["pos_exceedance"].tolist(), r["alarm_fraction"])
    with open(JAX_NAV) as fh:
        jref = json.load(fh)
    log(f"navigation study through {how}: B = {B}, {NAV_T_END:.0f} s in "
        f"{wall:.2f} s wall ({int(r['final'].i[0])} steps, errors every "
        f"10; launches {got_l}): {got} [{card}]")
    log(f"navigation study, the JAX package's run ({JAX_NAV}, "
        f"{jref['dtype']} on a CPU, {jref['wall_s']:.0f} s): "
        f"{ {k: jref[k] for k in got} }")
    if (jref["lanes"], jref["t_end"], jref["key"]) != (B, NAV_T_END, 0x17A):
        raise AssertionError(f"{JAX_NAV} is of another study: {jref}")
    rel, fr = NAV_MATCH
    far = {k: (got[k], jref[k]) for k in ("att_p50", "att_p95", "pos_p50",
                                          "pos_p95")
           if abs(got[k] - jref[k]) > rel * abs(jref[k])}
    far.update({k: (got[k], jref[k]) for k in ("att_exceedance",
                                              "pos_exceedance")
                if any(abs(a - b) > fr for a, b in zip(got[k], jref[k]))})
    # no false alarm (tests/test_nav_study.py, 8 lanes); where the JAX
    # package's own run at B latches some, the port is held to its count
    # within one lane in a thousand
    alarms = {k: (v, jref["alarm_fraction"][k])
              for k, v in got["alarm_fraction"].items()
              if v != 0.0 and abs(v - jref["alarm_fraction"][k]) > 1e-3}
    log(f"navigation study alarms through {how}: {got['alarm_fraction']} "
        f"(the JAX run's {jref['alarm_fraction']}; zero bound "
        f"{'held' if not any(got['alarm_fraction'].values()) else 'missed'})")
    if far or alarms:
        raise AssertionError(f"navigation study through {how}: outside the "
                             f"JAX run's bounds {far}, alarms {alarms}")
    if not (bool(torch.isfinite(r["peak_att_deg"]).all())
            and bool(torch.isfinite(r["peak_pos_m"]).all())):
        raise AssertionError("navigation study: a peak not finite")
    return wall


def sensor_fed_flight(card, t_start, launches):
    """The sensor-fed autopilot fleet (`testing.sensor_fed_fleet_sim`) at
    B for SENSOR_FED_T_END through `megakernel_nav`, its launches counted
    from 0, held to `tools/bench_report.py:280-285`: every leaf finite, no
    lane terminated, the mean EAS and climb at their references."""
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.physics.kinematics import WA
    from flightjax_torch.testing import sensor_fed_fleet_sim
    log(f"elapsed {time.time() - t_start:.1f} s (navigation: the sensor-fed "
        f"autopilot fleet)")
    sim, st = sensor_fed_fleet_sim(B, DEVICE, torch.float32)
    n = int(round(SENSOR_FED_T_END / sim.dt))
    bufs, step_packed, unpack = make_megakernel_step(sim, st)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.time()
    for _ in range(n):
        bufs = step_packed(bufs)
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = {k: v for k, v in K.LAUNCHES.items() if v}
    if got != {"megakernel_nav": n}:
        raise AssertionError(f"sensor-fed fleet: launches {got}")
    launches["megakernel_nav"] = n
    out = unpack(bufs)
    for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
        if val.dtype.is_floating_point and not bool(
                torch.isfinite(val).all()):
            raise AssertionError(f"sensor-fed fleet: non-finite leaf {p}")
    xv, sv = out.x["vehicle"], out.s["vehicle"]
    _, kin = WA().f_ode(xv["kinematics"], xv["dynamics"], sv["geoid_N"])
    mean_eas = float(eas(out).double().mean())
    climb = float((-kin.v_eb_n[:, 2]).double().mean())
    term = int(out.s["terminated"].sum())
    alarms = {k: int(out.s["avionics"]["mon_" + k]["alarm"].sum())
              for k in K.MONITORS}
    log(f"sensor-fed autopilot fleet: B = {B}, {SENSOR_FED_T_END:.0f} s "
        f"({n} steps) through megakernel_nav in {wall:.2f} s wall, "
        f"{B * n / wall:.0f} vehicle-steps/s; mean EAS {mean_eas:.4f} m/s, "
        f"mean climb {climb:.4f} m/s, {term} lanes terminated, alarms "
        f"{alarms} [{card}]")
    if (term or abs(mean_eas - SENSOR_FED_EAS[0]) >= SENSOR_FED_EAS[1]
            or abs(climb - SENSOR_FED_CLIMB[0]) >= SENSOR_FED_CLIMB[1]):
        raise AssertionError("sensor-fed autopilot fleet: outside the "
                             "benchmark report's gates")


def nav_paths(t_start):
    """The navigation fleet's three entry points and the truth-fed twin's
    megakernel at B, NAV_STEPS steps in float32, launch counts from 0.
    The navigation fleet flies on its estimates and is held to the plain
    step in float64 on the same state and filter constants
    (`testing.nav_twin`): two faithful float32 runs of the filter's update
    part by its conditioning (`testing.nav_hold`), and the control laws on
    the estimates carry that into the vehicles, so the kernels' run is
    held within NAV_SPREAD times the float32 plain run's own distance from
    the twin: every leaf as `testing.nav_hold` holds it, and position,
    velocity, attitude and EAS within that or the scaled 10 s envelope.
    The truth-fed twin's megakernel is held to its plain path within the
    envelope. Then 10 float64 steps of each to 1e-9. Returns the paths'
    launch counts of the kernels they launch and the float32 fleets."""
    from flightjax_torch.parallel import fleet as F
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel.clusterstep import (make_cluster_step,
                                                      vehicle_step)
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import nav_fleet_sim, xv1_turb_fleet_sim
    from flightjax_torch.testing import NAV_SPREAD, nav_hold, nav_reference
    log(f"elapsed {time.time() - t_start:.1f} s (navigation: paths)")
    fleets = {"nav": nav_fleet_sim(B, SEED, DEVICE, torch.float32),
              "twin": xv1_turb_fleet_sim(B, SEED, DEVICE, torch.float32)}

    def plain_steps(mega, sim, st, n):
        i0 = int(st.i[0])
        for k in range(n):
            st = (megakernel_step_plain(sim, st) if mega else vehicle_step(
                sim, st, i0 + k, comp=st.c is not None, plain=True))
        return st

    def run_path(label, fl, n, plain=False):
        sim, st = fl["twin" if label == "xv1_turb_megakernel" else "nav"]
        if plain:
            return plain_steps(label.endswith("megakernel"), sim, st, n)
        if label.endswith("megakernel"):
            bufs, step_packed, unpack = make_megakernel_step(sim, st)
            for _ in range(n):
                bufs = step_packed(bufs)
            return unpack(bufs)
        if label == "nav_fleet":
            return F.fleet_rollout(sim, st, n)
        i0 = int(st.i[0])
        step = make_cluster_step(sim, st, split="vehicle")
        for k in range(n):
            st = step(st, i=i0 + k)
        return st

    # the plain runs, one for both splits (the same plain step)
    kind = lambda label: ("xv1" if label == "xv1_turb_megakernel" else
                          "mega" if label.endswith("megakernel") else "split")
    refs, twins = {}, {}
    tr = lambda x: (x.t, x.x, x.u, x.s)
    env = [e * NAV_STEPS / STEPS for e in (ENV_POS_M, ENV_VEL, ENV_ATT_RAD,
                                          ENV_EAS)]
    launches = {}
    for label in NAV_PATHS:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.time()
        out = run_path(label, fleets, NAV_STEPS)
        torch.cuda.synchronize()
        got = dict(K.LAUNCHES)
        want = dict.fromkeys(K.LAUNCHES, 0)
        if label == "xv1_turb_megakernel":
            want["megakernel_fbw_turb"] = NAV_STEPS
        elif label == "nav_megakernel":
            want["megakernel_nav_turb"] = NAV_STEPS
        else:  # the truth's systems in the pass, the geoid every step
            want.update(rk4_stage_fbw_turb=4 * NAV_STEPS,
                        rk4_finish_fbw_turb=NAV_STEPS, ctl_laws=NAV_STEPS,
                        systems_fbw=NAV_STEPS, geoid=NAV_STEPS,
                        nav_pass=NAV_STEPS)
        log(f"{label}: {NAV_STEPS} steps x {B} aircraft in "
            f"{time.time() - t0:.2f} s (first run); launches "
            f"{ {k: v for k, v in got.items() if v} }")
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        for name, (_, _, path) in KERNELS.items():
            if path == label:
                launches[name] = got[name]
        for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
            if val.dtype.is_floating_point and not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"{label}: non-finite leaf {p}")
        if bool(out.s["terminated"].any()):
            raise AssertionError(f"{label}: a lane terminated")
        k = kind(label)
        if k not in refs:
            K.reset_launches()
            refs[k] = run_path(label, fleets, NAV_STEPS, plain=True)
            torch.cuda.synchronize()
            if any(K.LAUNCHES.values()):
                raise AssertionError(f"{label}: plain run launched a kernel")
        ref = refs[k]
        if k == "xv1":
            dist = compare_runs(out, ref)
            log(f"{label} kernels vs plain after {NAV_STEPS} steps (f32): "
                f"position {dist[0]:.3e} m (env {env[0]:.3g}), velocity "
                f"{dist[1]:.3e} m/s (env {env[1]:.3g}), attitude "
                f"{dist[2]:.3e} rad (env {env[2]:.3g}), EAS {dist[3]:.3e} "
                f"m/s (env {env[3]:.3g})")
            if not all(v_ <= e for v_, e in zip(dist, env)):
                raise AssertionError(f"{label}: kernel and plain runs "
                                     f"disagree")
            continue
        sim, st = fleets["nav"]
        if k not in twins:
            twins[k] = nav_reference(sim, torch.float32, lambda s_, x: (
                plain_steps(k == "mega", s_, x, NAV_STEPS)), st)
        twin = twins[k]
        p_err, n_bad, n_far, worst = nav_hold(
            torch.float32, tr(out), tr(ref), tr(twin), out.s["avionics"],
            ref.s["avionics"], sim.system.aircraft.avionics, label)
        d_k, d_p = compare_runs(out, twin), compare_runs(ref, twin)
        lim = [max(NAV_SPREAD * p_, e) for p_, e in zip(d_p, env)]
        top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:4]
        log(f"{label} after {NAV_STEPS} steps on the estimates (f32), "
            f"kernels / plain vs the float64 plain step: position "
            f"{d_k[0]:.3e} / {d_p[0]:.3e} m (limit {lim[0]:.3g}), velocity "
            f"{d_k[1]:.3e} / {d_p[1]:.3e} m/s (limit {lim[1]:.3g}), "
            f"attitude {d_k[2]:.3e} / {d_p[2]:.3e} rad (limit "
            f"{lim[2]:.3g}), EAS {d_k[3]:.3e} / {d_p[3]:.3e} m/s (limit "
            f"{lim[3]:.3g}); P per lane {p_err:.3e}; flags differ on "
            f"{n_bad} lanes ({n_bad - n_far} near a gate); the worst leaves "
            f"(error, limit) "
            + ", ".join(f"{k_} {e:.2e} ({l_:.1e})" for k_, (e, l_) in top))
        if not all(v_ <= l_ for v_, l_ in zip(d_k, lim)):
            raise AssertionError(f"{label}: the kernels' run is further "
                                 f"from the float64 step than the plain "
                                 f"run's limit")
    del out, refs, twins
    f64 = {"nav": nav_fleet_sim(B, SEED, DEVICE, torch.float64),
           "twin": xv1_turb_fleet_sim(B, SEED, DEVICE, torch.float64)}
    refs = {}
    for label in NAV_PATHS:
        a = run_path(label, f64, F64_STEPS[""])
        if kind(label) not in refs:
            refs[kind(label)] = run_path(label, f64, F64_STEPS[""],
                                         plain=True)
        b = refs[kind(label)]
        torch.cuda.synchronize()
        worst = max(rel_err(va, vb) for _, va, vb in leaf_pairs(
            {"x": a.x, "s": a.s, "u": a.u}, {"x": b.x, "s": b.s, "u": b.u}))
        log(f"{label} f64 {F64_STEPS['']} steps kernels vs plain: max rel "
            f"err {worst:.3e} (tol 1e-9)")
        if not worst <= 1e-9:
            raise AssertionError(f"{label}: f64 run disagrees")
    del f64, a, b, refs
    return launches, fleets


def nav_phase(card, t_start, check, errs, regs, sizes):
    """The sensor-fed navigation fleet: the turbulent C172Xv1's three
    kernel instances against their plain versions, and the inner laws'
    passes on an estimated VehicleY; the navigation kernels (nav_pass,
    megakernel_nav, megakernel_nav_turb) against theirs; the navigation
    fleet's three entry points and the twin's megakernel against their
    plain paths; the joint navigation study through fleet_step and through
    megakernel_nav_turb against the JAX package's run; the sensor-fed
    autopilot fleet's 600 s through megakernel_nav; the instances' timings
    and the paths' profiles. Returns the instances' rows of the kernels
    line."""
    from flightjax_torch.core.sim import Simulation, comp_residuals
    from flightjax_torch.models.c172.c172x import (build_vehicle as
                                                   fbw_vehicle, c172xv1_sim)
    from flightjax_torch.ops.random import normal_table
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import (fbw_turb_operand_state,
                                         fbw_turb_operands, gdc_laws_args,
                                         nav_fleet_sim, turb_operand_args)
    from profile_torch_step import profile

    # kernel checks: f64 to 1e-12 and f32 to 1e-5, at 32 and 64 aircraft
    # per block, on the turbulent operands with the servos
    log(f"elapsed {time.time() - t_start:.1f} s (navigation: kernel checks)")
    d = fbw_turb_operands(B, SEED, GROUND_LANES, TERMINATED_LANES,
                          (CRASH_LANE,))
    from flightjax_torch.models.c172.c172x import ACT_RANGES
    sat = {ch: (int((v < ACT_RANGES[ch][0]).sum()),
                int((v > ACT_RANGES[ch][1]).sum()))
           for ch, v in d["u_sys"]["act"].items() if ch in ACT_RANGES}
    log(f"turbulent fly-by-wire operands: commands below / above their "
        f"ranges {sat}; W20 {sorted(set(d['u_turb']['W20'].tolist()))}; "
        f"seeds above 2^24 {int((d['u_turb']['seed'] > 2 ** 24).sum())}")
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        vehicle = fbw_vehicle(device=DEVICE, dtype=dtype,
                              turbulence=DrydenTurbulence(0.02))
        args = turb_operand_args(d, vehicle, DEVICE, dtype)
        for name, comp in (("rk4_stage_fbw_turb", False),
                           ("rk4_finish_fbw_turb", False),
                           ("rk4_finish_fbw_turb", True)):
            base = name[:-len("_fbw_turb")]
            a = args[base]
            if base == "rk4_finish" and not comp:
                a = a[:7] + (None,) + a[8:]
            ref = getattr(K, base + "_plain")(*a)
            for lanes in (32, 64):
                buf, n_out, scal, ops = K.PACK[name](*a)
                out = L.launch(name, buf, n_out, scal, block=lanes, **ops)
                got = K.unpack_out(name, out, comp, ops.get("ints"))
                torch.cuda.synchronize()
                check(name, dtype, tol, leaf_pairs(got, ref),
                      f" (turbulent fly-by-wire operands, "
                      f"{'compensated, ' * comp}block {lanes})")
            if base == "rk4_finish" and not (
                    bool(got[1]["crashed"][CRASH_LANE])
                    and torch.equal(got[-1]["n"], a[4]["turb"]["n"] + 1)):
                raise AssertionError(f"{name}: the crash lane or the "
                                     f"drive's counter")
        sim0, _, _ = c172xv1_sim(DEVICE, dtype,
                                 turbulence=DrydenTurbulence(0.02))
        st = fbw_turb_operand_state(d, DEVICE, dtype)
        for spp in (1, 2):
            sim = Simulation(sim0.system, dt=0.02, periodic_dt=0.02 * spp)
            for comp in (False, True):
                st_ = st._replace(c=comp_residuals(st.x, force=True) if comp
                                  else None)
                ref = megakernel_step_plain(sim, st_)
                for lanes in (32, 64):
                    bufs, step_packed, unpack = make_megakernel_step(
                        sim, st_, block=lanes)
                    got = unpack(step_packed(bufs))
                    torch.cuda.synchronize()
                    if not (torch.equal(got.i, ref.i) and torch.equal(
                            got.s["vehicle"]["turb"]["n"],
                            ref.s["vehicle"]["turb"]["n"])
                            and bool(got.s["terminated"][CRASH_LANE])):
                        raise AssertionError("megakernel_fbw_turb: counters "
                                             "or the crash latch")
                    check("megakernel_fbw_turb", dtype, tol, leaf_pairs(
                        (got.t, got.x, got.u, got.s, got.c),
                        (ref.t, ref.x, ref.u, ref.s, ref.c)),
                        f" (mode-rich operands, pass every {spp}, comp "
                        f"{comp}, block {lanes})")
        # the inner laws' passes on an estimated VehicleY: the navigation
        # fleet's estimates at its start, on its control laws and on the
        # mode-rich guidance
        nsim, nst = nav_fleet_sim(B, SEED, DEVICE, dtype)
        nav = nsim.system.aircraft.avionics
        veh = nsim.system.aircraft.vehicle
        xv, uv, sv = nst.x["vehicle"], nst.u["vehicle"], nst.s["vehicle"]
        _, _, dyn = K.vehicle_truth(veh, xv, uv, sv, nst.t)
        vy = veh.output(xv, uv, sv, nst.t)._replace(dynamics=dyn)
        s_av, u_av = nst.s["avionics"], nst.u["avionics"]
        s_av = dict(s_av, sens=dict(s_av["sens"], n=s_av["sens"]["n"] + 9))
        _, y_est, _ = nav.nav_pass(s_av, u_av, vy, veh.terrain.terrain_data(
            uv["trn"]).elevation, aid=True)
        gargs = gdc_laws_args(B, SEED, DEVICE, dtype, GROUND_LANES)
        for name, a in (
                ("ctl_laws", (nav.inner, K.ctl_y(y_est), u_av["inner"],
                              s_av["inner"], 0.02)),
                ("gdc_ctl_laws", (gargs[0], K.gdc_y(y_est), *gargs[2:]))):
            ref = getattr(K, name + "_plain")(*a)
            for lanes in (32, 64):
                buf, n_out, scal, ops = K.PACK[name](*a)
                got = K.unpack_out(name, L.launch(name, buf, n_out, scal,
                                                  block=lanes, **ops))
                torch.cuda.synchronize()
                check(name, dtype, tol, leaf_pairs(got, ref),
                      f" (the navigation fleet's estimated VehicleY, block "
                      f"{lanes})")
        del args, st, sim, sim0, nsim, nst, y_est, vy
    nav_kernel_checks(t_start, errs)

    launches, fleets = nav_paths(t_start)

    # the joint navigation study at B for its 30 s, against the JAX
    # package's own run of the same study (tools/jax_nav_study.py): through
    # Simulation.fleet_step (the vehicle split with nav_pass), then through
    # megakernel_nav_turb
    studies = {}
    for mega in (False, True):
        studies[mega] = nav_study(card, t_start, mega, launches)
    log(f"navigation study wall time: fleet_step {studies[False]:.2f} s, "
        f"megakernel {studies[True]:.2f} s [{card}]")
    sensor_fed_flight(card, t_start, launches)

    # the paths' profiles (B, f32) and the navigation stage's share of the
    # vehicle split's step (against the twin's vehicle split, whose step
    # is the same but for the navigation stage), then the instances' rows
    log(f"elapsed {time.time() - t_start:.1f} s (navigation: timings)")
    nsim, nst0 = fleets["nav"]
    tsim, tst0 = fleets["twin"]
    tavionics = tsim.system.aircraft.avionics
    tveh = tsim.system.aircraft.vehicle
    tparams, tgrid = K.system_params(tveh), K.geoid_grid(tveh.geoid)
    tgains = K.ctl_gains(tavionics)
    mbufs, mstep, munpack = make_megakernel_step(tsim, tst0)

    def mega(lanes=None):
        return L.launch_megakernel(mbufs[0], mbufs[1], tparams, tgrid,
                                   tsim.dt, tsim.t_start, False, lanes,
                                   tgains, tsim.steps_per_periodic,
                                   tsim.periodic_dt, turb=True)
    # the navigation megakernels on the study's fleet and on the sensor-fed
    # autopilot fleet, each at its first GPS epoch (every lane aids)
    from flightjax_torch.testing import nav_pass_args, sensor_fed_fleet_sim

    nav_mega = {}
    for label, (sim, st) in (
            ("nav_megakernel", (nsim, nav_at_epoch(nst0))),
            ("sensor_fed_megakernel", (lambda f: (f[0], nav_at_epoch(f[1])))(
                sensor_fed_fleet_sim(B, DEVICE, torch.float32)))):
        av = sim.system.aircraft.avionics
        veh = sim.system.aircraft.vehicle
        b_, step_, unpack_ = make_megakernel_step(sim, st)
        p_, g_, gn_ = (K.system_params(veh), K.geoid_grid(veh.geoid),
                       K.ctl_gains(av))
        tab = normal_table(DEVICE)

        def bare(lanes=None, b_=b_, sim=sim, p_=p_, g_=g_, gn_=gn_,
                 turb=veh.turbulence is not None):
            return L.launch_megakernel(b_[0], b_[1], p_, g_, sim.dt,
                                       sim.t_start, False, lanes, gn_,
                                       sim.steps_per_periodic,
                                       sim.periodic_dt, turb=turb,
                                       table=tab)
        nav_mega[label] = dict(sim=sim, st=st, bufs=b_, step=step_,
                               unpack=unpack_, bare=bare, params=p_,
                               gains=gn_)
    profiles = {}
    for label in NAV_PATHS + ("xv1_turb_vehicle", "sensor_fed_megakernel"):
        if label == "xv1_turb_megakernel":
            pr = graph_profile(label, "megakernel_fbw_turb", mstep, mbufs,
                               mega)
        elif label in nav_mega:
            m = nav_mega[label]
            pr = graph_profile(label, KERNELS_OF_PATH[label], m["step"],
                               m["bufs"], m["bare"])
        else:
            sim, st = fleets["twin" if label.startswith("xv1_turb")
                             else "nav"]
            # the kernels sit below the glue's first dozens
            pr = profile(label, sim, st, NAV_PROFILE_STEPS, 60)
        profiles[label] = pr
        log(f"profile {label}: B = {B}, f32: host "
            f"{pr['host_ms_per_step']:.4f} ms/step, device "
            f"{pr['device_ms_per_step']:.4f} ms/step, idle share "
            f"{pr['idle_share']:.4f}, {pr['launches_per_step']:.1f} device "
            f"launches/step, {B / pr['host_ms_per_step'] * 1e3:.0f} "
            f"vehicle-steps/s [{card}]")
        for t in pr["top"][:10]:
            log(f"  {t['ms_per_step']:9.4f} ms/step {t['per_step']:6.1f}"
                f"/step  {t['name'][:90]}")
    nav, twin = profiles["nav_vehicle"], profiles["xv1_turb_vehicle"]
    nav_ms, twin_ms = nav["host_ms_per_step"], twin["host_ms_per_step"]
    dev_ms = nav["device_ms_per_step"] - twin["device_ms_per_step"]
    log(f"the navigation stage (sensors, filter, monitors, estimated "
        f"VehicleY, the truth's systems): {nav_ms - twin_ms:.4f} of "
        f"{nav_ms:.4f} host ms a step of nav_vehicle, share "
        f"{1 - twin_ms / nav_ms:.4f}; device {dev_ms:.4f} of "
        f"{nav['device_ms_per_step']:.4f} ms [{card}]")

    vehicle = nsim.system.aircraft.vehicle
    params = K.system_params(vehicle)
    lay = K.FBW_TURB
    xv, uv, sv = nst0.x["vehicle"], nst0.u["vehicle"], nst0.s["vehicle"]
    full = K.pack_vehicle(vehicle, xv, uv, sv, nst0.s["terminated"],
                          t=nst0.t)
    ints = K.pack_turb_int(nst0.i, uv, sv)
    stage_in = full[:K.rows(lay.stage_in)]
    k1 = K.rk4_stage_packed(vehicle, stage_in, torch.zeros(
        (K.rows(lay.stage_out), B), device=DEVICE), 0.0)
    ksum = 6.0 * k1
    rows = []

    def share(label, name):
        pr = profiles[label]
        return sum(t["ms_per_step"] for t in pr["top"]
                   if name in t["name"]) / pr["device_ms_per_step"]

    cases = {
        "rk4_stage_fbw_turb": (
            lambda lanes=None: L.launch(
                "rk4_stage_fbw_turb", stage_in, K.rows(lay.stage_out),
                (0.01,), block=lanes, k=k1, params=params),
            lambda: K.rk4_stage_packed(vehicle, stage_in, k1, 0.01),
            lambda: K.rk4_stage_packed_plain(vehicle, stage_in, k1, 0.01),
            stage_in.numel() + 2 * k1.numel() + params.numel(), 4),
        "rk4_finish_fbw_turb": (
            lambda lanes=None: L.launch(
                "rk4_finish_fbw_turb", full, K.rows(lay.rkfin_out),
                (0.02 / 6.0, 0, 0.02, 0.0), block=lanes, k=ksum,
                params=params, ints=ints),
            lambda: K.rk4_finish_packed(vehicle, full, ksum, 0.02, False,
                                        None, ints),
            lambda: K.rk4_finish_packed_plain(vehicle, full, ksum, 0.02,
                                              False, ints),
            full.numel() + ksum.numel() + K.rows(lay.rkfin_out) * B
            + ints.numel() + params.numel(), 1)}
    new = munpack(mstep(mbufs))
    fires = (tst0.i + 1) % tsim.steps_per_periodic == 0
    cases["megakernel_fbw_turb"] = (
        mega, lambda: mstep(mbufs),
        lambda: megakernel_step_plain(tsim, tst0),
        2 * (mbufs[0].numel() + mbufs[1].numel()) + tparams.numel()
        + geoid_cells(tveh.geoid, new.x["vehicle"]["kinematics"]["q_ew"])
        + gain_values(tavionics, eas(new),
                      new.x["vehicle"]["kinematics"]["h_e"],
                      new.s["avionics"]["lon"]["mode_prev"],
                      new.s["avionics"]["lat"]["mode_prev"]), 1)
    weights = {"megakernel_fbw_turb": pass_op_weights(
        tavionics, tst0.s["avionics"], new.s["avionics"], fires)}
    # nav_pass on the study's fleet at its first GPS epoch (every lane
    # aids: the plain version's ungated work is the kernel's)
    nargs = nav_pass_args(nsim, nav_at_epoch(nst0))
    nbuf, n_out, _, nops = K.pack_nav_pass(*nargs)
    tab = normal_table(DEVICE)
    n_draws = 29 * B  # the table entries the epoch's draws read
    n_navp = len(K.nav_param_values(nargs[0]))
    cases["nav_pass"] = (
        lambda lanes=None: L.launch_nav_pass(nbuf, n_out, nops["ints"],
                                             nops["gains"], tab, lanes),
        lambda: K.nav_pass(*nargs), lambda: K.nav_pass_plain(*nargs),
        nbuf.numel() + 2 * nops["ints"].numel() + n_out * B + n_draws
        + n_navp, 1)
    for label, m in nav_mega.items():
        name = KERNELS_OF_PATH[label]
        msim, mst, mav = m["sim"], m["st"], m["sim"].system.aircraft.avionics
        mveh = msim.system.aircraft.vehicle
        mnew = m["unpack"](m["step"](m["bufs"]))
        cases[name] = (
            m["bare"], (lambda m=m: m["step"](m["bufs"])),
            (lambda msim=msim, mst=mst: megakernel_step_plain(msim, mst)),
            2 * (m["bufs"][0].numel() + m["bufs"][1].numel())
            + m["params"].numel() + n_draws + n_navp
            + geoid_cells(mveh.geoid, mnew.x["vehicle"]["kinematics"]["q_ew"])
            + gain_values(mav, eas(mnew),
                          mnew.x["vehicle"]["kinematics"]["h_e"],
                          mnew.s["avionics"]["inner"]["lon"]["mode_prev"],
                          mnew.s["avionics"]["inner"]["lat"]["mode_prev"]), 1)
    for name, (bare, wrapper, plain, n_elems, per_step) in cases.items():
        label = KERNELS[name][2]
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=launches[name],
            max_abs_err=errs[name], ms=graph_ms(bare),
            plain_ms=(cuda_ms(plain, reps=1, calls=1, warm=1) if name in (
                "nav_pass", "megakernel_nav", "megakernel_nav_turb")
                else cuda_ms(plain, reps=3, calls=1, warm=1)),
            nbytes=4 * n_elems,
            ops=count_ops(plain, weights.get(name),
                          matmul=name in ("nav_pass", "megakernel_nav",
                                          "megakernel_nav_turb")),
            library_ms=None, event_ms=cuda_ms(bare),
            wrapper_ms=cuda_ms(wrapper),
            block_ms={n: graph_ms(lambda: bare(n)) for n in (32, 64)},
            launches_per_step=per_step,
            share=(1.0 if label in nav_mega else share(
                label, "nav_pass_kernel" if name == "nav_pass"
                else name[:-len("_fbw_turb")] + "_"))))
    # the navigation megakernels off an aiding epoch (no lane aids: the
    # four firings in five that run no aiding block)
    for label, m in nav_mega.items():
        off = make_megakernel_step(m["sim"], nav_at_epoch(m["st"], 10))[0]
        sim = m["sim"]
        veh = sim.system.aircraft.vehicle
        row = next(r for r in rows if r["name"] == KERNELS_OF_PATH[label])
        row["off_epoch_ms"] = graph_ms(lambda: L.launch_megakernel(
            off[0], off[1], m["params"], K.geoid_grid(veh.geoid), sim.dt,
            sim.t_start, False, None, m["gains"], sim.steps_per_periodic,
            sim.periodic_dt, turb=veh.turbulence is not None,
            table=normal_table(DEVICE)))
        log(f"time {row['name']}: {row['off_epoch_ms']:.4f} ms off an "
            f"aiding epoch, {row['ms']:.4f} ms on one [{card}]")
    log("navigation profiles: " + json.dumps(profiles))
    return rows


def loiter_flight(card, sim, st0, orbit, launches, name="megakernel_gdc_nav",
                  label=XV2_NAV_PATH, jax_path=JAX_LOITER):
    """The loiter on estimates at B through `name` in float32 for
    LOITER_STEPS steps, its launches counted from 0 (the kernels line's
    count), held to the JAX package's own float32 run of the same fleet
    (`tools/jax_loiter.py`, its JSON `jax_path`): every lane to each of the
    JAX test's assertions (`tests/test_navigation.py:276-327`: not
    terminated, altitude within 10 m of the start's at the end, the final
    radial error under 0.7 of the start's, no GPS alarm, of the position
    or the velocity monitor, and no baro alarm at any of the saves, every
    LOITER_SAVE_EVERY steps) that the JAX run meets on every lane, and
    where it does not, the lanes failing it within LOITER_MATCH[2] of the
    JAX run's count; the p50 and p95 of the final |e_cb|, of the largest
    |h_e - h0| at the saves and of the ratio of the final |e_cb| to the
    start's within LOITER_MATCH[0] of the JAX run's, relative, or
    LOITER_MATCH[1] m (the ratio: that over the start's |e_cb|). Returns
    the state after LOITER_WINDOW steps, for the window against plain."""
    import numpy as np
    from flightjax_torch.models.c172.c172x_gdc import Circle, circle_data
    from flightjax_torch.ops.geodesy import nvector_from_qew
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import LOITER_STEPS
    with open(jax_path) as fh:
        jref = json.load(fh)
    if jref["lanes"] != B or jref["t_end"] != LOITER_STEPS * 0.02:
        raise AssertionError(f"{jax_path} holds {jref['lanes']} lanes, "
                             f"{jref['t_end']} s")
    crc = Circle(*(v.expand(B, *v.shape).contiguous() for v in orbit))

    def e_cb(st):
        kin = st.x["vehicle"]["kinematics"]
        return circle_data(crc, nvector_from_qew(kin["q_ew"]),
                           kin["h_e"]).e_cb.double()
    h0 = st0.x["vehicle"]["kinematics"]["h_e"].double()
    d0 = e_cb(st0)
    bufs, step_packed, unpack = make_megakernel_step(sim, st0)
    alarm = {k: torch.zeros(B, dtype=torch.bool, device=DEVICE)
             for k in ("gps", "baro")}
    dh = torch.zeros(B, dtype=torch.float64, device=DEVICE)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.time()
    window = None
    for k in range(1, LOITER_STEPS + 1):
        bufs = step_packed(bufs)
        if k == LOITER_WINDOW:
            window = unpack(bufs)
        if k % LOITER_SAVE_EVERY == 0:
            st = unpack(bufs)
            s_av = st.s["avionics"]
            alarm["gps"] |= s_av["mon_gps"]["alarm"] | s_av["mon_vel"][
                "alarm"]
            alarm["baro"] |= s_av["mon_baro"]["alarm"]
            dh = torch.maximum(dh, (st.x["vehicle"]["kinematics"][
                "h_e"].double() - h0).abs())
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = {k: v for k, v in K.LAUNCHES.items() if v}
    if got != {name: LOITER_STEPS}:
        raise AssertionError(f"{label}: launches {got}")
    launches[name] = LOITER_STEPS
    out = unpack(bufs)
    for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
        if val.dtype.is_floating_point and not bool(
                torch.isfinite(val).all()):
            raise AssertionError(f"{label}: non-finite leaf {p}")
    dh_end = (out.x["vehicle"]["kinematics"]["h_e"].double() - h0).abs()
    d1 = e_cb(out)
    fails = {"terminated": out.s["terminated"].bool(),
             "|h_e - h0| >= 10 m": dh_end >= 10.0,
             "|e_cb| >= 0.7 |e_cb(0)|": d1.abs() >= 0.7 * d0.abs(),
             "a GPS or baro alarm": alarm["gps"] | alarm["baro"]}
    q = lambda v: [round(float(x), 3) for x in torch.quantile(
        v, torch.tensor([0.0, 0.5, 0.95, 1.0], device=DEVICE,
                        dtype=torch.float64))]
    log(f"{label}: the loiter on estimates (W20 = {jref['W20']} m/s), B = "
        f"{B}, {LOITER_STEPS} steps (60 s) through {name} in {wall:.2f} s "
        f"wall, {B * LOITER_STEPS / wall:.0f} vehicle-steps/s; e_cb at the "
        f"start {q(d0)} m, at the end (min, median, p95, max of |e_cb|) "
        f"{q(d1.abs())} m, largest |h_e - h0| at the saves {q(dh)} m; lanes "
        f"failing the JAX test's assertions: "
        + ", ".join(f"{k} {int(v.sum())}" for k, v in fails.items())
        + f" (the JAX run's {jref['test_fails']}) [{card}]")
    # against the JAX package's own run of the same lanes
    e1 = d1.abs().cpu().numpy()
    d = {"e_cb_end": e1, "dh_max": dh.cpu().numpy(),
         "e_cb_ratio": e1 / d0.abs().cpu().numpy()}
    rel, abs_m, n_lanes = LOITER_MATCH
    far = {}
    for key, v in d.items():
        tol_abs = abs_m / (jref["e_cb_start"]["p50"]
                           if key == "e_cb_ratio" else 1.0)
        for qk, pct in (("p50", 50.0), ("p95", 95.0)):
            g, r = float(np.percentile(v, pct)), jref[key][qk]
            if abs(g - r) > max(rel * abs(r), tol_abs):
                far[f"{key} {qk}"] = (g, r)
    ja = {k: np.asarray(jref[k + "_m"]) for k in ("e_cb_end", "dh_max")}
    near = {k: float((np.abs(d[k] - ja[k]) <= abs_m).mean()) for k in ja}
    counts = {k: (int(v.sum()), jref["test_fails"][k])
              for k, v in fails.items()}
    log(f"{label} against the JAX package's own run of the same lanes "
        f"({os.path.basename(jax_path)}): final |e_cb| p50 "
        f"{np.percentile(e1, 50.0):.4f} / {jref['e_cb_end']['p50']:.4f}, p95 "
        f"{np.percentile(e1, 95.0):.4f} / {jref['e_cb_end']['p95']:.4f} m; "
        f"largest |h_e - h0| p50 {np.percentile(d['dh_max'], 50.0):.4f} / "
        f"{jref['dh_max']['p50']:.4f}, p95 "
        f"{np.percentile(d['dh_max'], 95.0):.4f} / "
        f"{jref['dh_max']['p95']:.4f} m; ratio p50 "
        f"{np.percentile(d['e_cb_ratio'], 50.0):.6f} / "
        f"{jref['e_cb_ratio']['p50']:.6f}, p95 "
        f"{np.percentile(d['e_cb_ratio'], 95.0):.6f} / "
        f"{jref['e_cb_ratio']['p95']:.6f} (within {rel:.0%} or {abs_m} m); "
        f"lane 0 final |e_cb| {e1[0]:.3f} / {jref['lane0']['e_cb_end']:.3f} "
        f"m; lanes within {abs_m} m of the JAX run's: final |e_cb| "
        f"{near['e_cb_end']:.4f}, largest |h_e - h0| {near['dh_max']:.4f}; "
        f"lanes failing each assertion (port, JAX) {counts}; GPS alarms "
        f"{int(alarm['gps'].sum())} / {jref['gps_alarm_lanes']}, baro "
        f"{int(alarm['baro'].sum())} / {jref['baro_alarm_lanes']} [{card}]")
    bad = {k: c for k, c in counts.items()
           if (c[0] if c[1] == 0 else abs(c[0] - c[1]) > n_lanes)}
    if far or bad:
        raise AssertionError(f"{label}: outside the JAX run's bounds {far},"
                             f" assertion counts {bad}")
    return window


def xv2_last_phase(card, t_start, check, errs, regs, sizes):
    """The C172Xv2's last instances: megakernel_gdc_turb and
    megakernel_msn_turb against their plain versions in float64 (1e-12)
    and float32 (exactly) at 32 and 64 aircraft per block, on the turbulent
    mode-rich operands (`testing.xv2_turb_operand_state`,
    `msn_turb_operand_state`: every branch of the turbulence, every
    guidance mode, every phase; with and without residuals, the pass every
    step and every other step) and on their fleets; megakernel_gdc_nav on
    the sensor-fed C172Xv2's mode-rich operands in each navigation setting
    (XV2_NAV_SETTINGS) and on the loiter fleet, at its start and at its
    first GPS epoch, as `testing.nav_hold` holds it; the three megakernel
    paths at B in float32 from their launch counts set to 0: the turbulent
    two XV2_TURB_STEPS steps against plain within the scaled 10 s
    envelope, the loiter on estimates its 60 s on every lane within the
    JAX test's assertions, its first LOITER_WINDOW steps held to the
    float64 plain step as the navigation fleet's are; the instances'
    timings and the paths' profiles.
    Returns the instances' rows of the kernels line."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.ops.random import normal_table
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    from flightjax_torch.testing import (NAV_SPREAD, fbw_turb_operands,
                                         loiter_fleet_sim, msn_sim,
                                         msn_turb_fleet_sim,
                                         msn_turb_operand_state, nav_hold,
                                         nav_operand_state, nav_reference,
                                         xv2_turb_fleet_sim,
                                         xv2_turb_operand_state, xv2_turb_sim)
    log(f"elapsed {time.time() - t_start:.1f} s (the C172Xv2's last "
        f"instances: kernel checks)")
    tr = lambda x: (x.t, x.x, x.u, x.s)
    turb_fleets = {"gdc": xv2_turb_fleet_sim, "msn": msn_turb_fleet_sim}
    d = fbw_turb_operands(B, SEED, GROUND_LANES, TERMINATED_LANES,
                          (CRASH_LANE,))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for avk in ("gdc", "msn"):
            name = f"megakernel_{avk}_turb"
            cases = []
            for comp, spp in ((False, 1), (True, 2)):
                if avk == "gdc":
                    sim = xv2_turb_sim(DEVICE, dtype, spp)
                    st = xv2_turb_operand_state(d, DEVICE, dtype)
                else:
                    sim = msn_sim(DEVICE, dtype, spp,
                                  turbulence=DrydenTurbulence(0.02))
                    st = msn_turb_operand_state(d, DEVICE, dtype)
                st = st._replace(c=comp_residuals(st.x, force=True) if comp
                                 else None)
                cases.append((f"mode-rich operands, pass every {spp}, comp "
                              f"{comp}", sim, st))
            cases.append(("fleet", *turb_fleets[avk](B, SEED, DEVICE,
                                                     dtype)[:2]))
            for what, sim, st in cases:
                ref = megakernel_step_plain(sim, st)
                for lanes in (32, 64):
                    bufs, step_packed, unpack = make_megakernel_step(
                        sim, st, block=lanes)
                    got = unpack(step_packed(bufs))
                    torch.cuda.synchronize()
                    if not (torch.equal(got.i, ref.i) and torch.equal(
                            got.s["vehicle"]["turb"]["n"],
                            ref.s["vehicle"]["turb"]["n"])):
                        raise AssertionError(f"{name}: counters")
                    # exact in float32, as the turbulent and the guided
                    # instances they compose are
                    check(name, dtype, tol if dtype == torch.float64
                          else 0.0, leaf_pairs(
                              (got.t, got.x, got.u, got.s, got.c),
                              (ref.t, ref.x, ref.u, ref.s, ref.c)),
                          f" ({what}, block {lanes})")
                if what.startswith("mode-rich") and not bool(
                        got.s["terminated"][CRASH_LANE]):
                    raise AssertionError(f"{name}: the crash lane did not "
                                         f"latch")
            del cases, sim, st, ref, got
        # megakernel_gdc_nav: the mode-rich operands in every setting, the
        # loiter fleet at its start and at its first GPS epoch
        lsim, lst, _ = loiter_fleet_sim(B, DEVICE, dtype)
        nav_cases = [(f"mode-rich, {s_}", *nav_operand_state(
            B, SEED, DEVICE, dtype, turbulence=False, setting=s_, gdc=True))
            for s_ in XV2_NAV_SETTINGS[dtype]]
        nav_cases += [("loiter fleet", lsim, lst),
                      ("loiter fleet, first GPS epoch", lsim,
                       nav_at_epoch(lst))]
        for what, sim, st in nav_cases:
            ref = megakernel_step_plain(sim, st)
            ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
            for lanes in (32, 64):
                bufs, step_packed, unpack = make_megakernel_step(
                    sim, st, block=lanes)
                got = unpack(step_packed(bufs))
                torch.cuda.synchronize()
                if not torch.equal(got.i, ref.i):
                    raise AssertionError("megakernel_gdc_nav: step counter")
                nav_held("megakernel_gdc_nav", dtype, tr(got), tr(ref),
                         tr(ref_c), got.s["avionics"], ref.s["avionics"],
                         sim.system.aircraft.avionics,
                         f" ({what}, block {lanes})", errs)
        del nav_cases, lsim, lst, ref, ref_c, got

    # the paths, from their launch counts set to 0
    log(f"elapsed {time.time() - t_start:.1f} s (the C172Xv2's last "
        f"instances: paths)")
    launches = {}
    env = [e * XV2_TURB_STEPS / STEPS for e in (ENV_POS_M, ENV_VEL,
                                                ENV_ATT_RAD, ENV_EAS)]
    fleets = {f"{avk}_turb": turb_fleets[avk](B, SEED, DEVICE,
                                              torch.float32)[:2]
              for avk in ("gdc", "msn")}
    for label, key in zip(XV2_TURB_PATHS, ("gdc_turb", "msn_turb")):
        name = "megakernel_" + key
        sim, st = fleets[key]
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.time()
        for _ in range(XV2_TURB_STEPS):
            bufs = step_packed(bufs)
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        if got != {name: XV2_TURB_STEPS}:
            raise AssertionError(f"{label}: launches {got}")
        launches[name] = got[name]
        out = unpack(bufs)
        for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
            if val.dtype.is_floating_point and not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"{label}: non-finite leaf {p}")
        if bool(out.s["terminated"].any()):
            raise AssertionError(f"{label}: a lane terminated")
        ref = st
        for _ in range(XV2_TURB_STEPS):
            ref = megakernel_step_plain(sim, ref)
        dist = compare_runs(out, ref)
        log(f"{label}: {XV2_TURB_STEPS} steps x {B} aircraft in {wall:.3f} s "
            f"(first run; launches {got}); kernels vs plain (f32): position "
            f"{dist[0]:.3e} m (env {env[0]:.3g}), velocity {dist[1]:.3e} m/s "
            f"(env {env[1]:.3g}), attitude {dist[2]:.3e} rad (env "
            f"{env[2]:.3g}), EAS {dist[3]:.3e} m/s (env {env[3]:.3g})")
        if not all(v_ <= e for v_, e in zip(dist, env)):
            raise AssertionError(f"{label}: kernel and plain runs disagree")
    # the loiter on estimates: its 60 s on every lane, its first NAV_STEPS
    # against the float64 plain step as the navigation fleet's
    lsim, lst0, orbit = loiter_fleet_sim(B, DEVICE, torch.float32)
    fleets["gdc_nav"] = (lsim, lst0)
    log(f"elapsed {time.time() - t_start:.1f} s (the C172Xv2's last "
        f"instances: the loiter on estimates)")
    window = loiter_flight(card, lsim, lst0, orbit, launches)

    def plain_steps(sim, st, n=LOITER_WINDOW):
        for _ in range(n):
            st = megakernel_step_plain(sim, st)
        return st
    ref = plain_steps(lsim, lst0)
    twin = nav_reference(lsim, torch.float32, plain_steps, lst0)
    p_err, n_bad, n_far, worst = nav_hold(
        torch.float32, tr(window), tr(ref), tr(twin), window.s["avionics"],
        ref.s["avionics"], lsim.system.aircraft.avionics, XV2_NAV_PATH)
    env_w = [e * LOITER_WINDOW / STEPS for e in (ENV_POS_M, ENV_VEL,
                                                 ENV_ATT_RAD, ENV_EAS)]
    d_k, d_p = compare_runs(window, twin), compare_runs(ref, twin)
    lim = [max(NAV_SPREAD * p_, e) for p_, e in zip(d_p, env_w)]
    top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:4]
    log(f"{XV2_NAV_PATH} after {LOITER_WINDOW} steps on the estimates (f32), "
        f"kernels / plain vs the float64 plain step: position "
        f"{d_k[0]:.3e} / {d_p[0]:.3e} m (limit {lim[0]:.3g}), velocity "
        f"{d_k[1]:.3e} / {d_p[1]:.3e} m/s (limit {lim[1]:.3g}), attitude "
        f"{d_k[2]:.3e} / {d_p[2]:.3e} rad (limit {lim[2]:.3g}), EAS "
        f"{d_k[3]:.3e} / {d_p[3]:.3e} m/s (limit {lim[3]:.3g}); P per lane "
        f"{p_err:.3e}; flags differ on {n_bad} lanes ({n_bad - n_far} near "
        f"a gate); the worst leaves (error, limit) "
        + ", ".join(f"{k_} {e:.2e} ({l_:.1e})" for k_, (e, l_) in top))
    if not all(v_ <= l_ for v_, l_ in zip(d_k, lim)):
        raise AssertionError(f"{XV2_NAV_PATH}: the kernels' run is further "
                             f"from the float64 step than the plain run's "
                             f"limit")
    del window, ref, twin

    # timings and profiles, on the paths' fleets (the loiter at its first
    # GPS epoch, every lane aiding, and off an aiding epoch)
    log(f"elapsed {time.time() - t_start:.1f} s (the C172Xv2's last "
        f"instances: timings)")
    rows, profiles = [], {}
    for key, label in (("gdc_turb", "xv2_turb_megakernel"),
                       ("msn_turb", "msn_turb_megakernel"),
                       ("gdc_nav", XV2_NAV_PATH)):
        name = "megakernel_" + key
        sim, st = fleets[key]
        nav = key == "gdc_nav"
        if nav:
            st = nav_at_epoch(st)
        av = sim.system.aircraft.avionics
        veh = sim.system.aircraft.vehicle
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
        params, grid, gains = (K.system_params(veh), K.geoid_grid(veh.geoid),
                               K.ctl_gains(av))
        table = normal_table(DEVICE) if nav else None

        def bare(lanes=None, b_=bufs, sim=sim, params=params, grid=grid,
                 gains=gains, comp=st.c is not None, nav=nav, table=table,
                 msn=key == "msn_turb"):
            return L.launch_megakernel(
                b_[0], b_[1], params, grid, sim.dt, sim.t_start, comp, lanes,
                gains, sim.steps_per_periodic, sim.periodic_dt, gdc=not msn,
                msn=msn, turb=not nav, table=table)
        new = unpack(step_packed(bufs))
        plain = lambda sim=sim, st=st: megakernel_step_plain(sim, st)
        inner = new.s["avionics"].get("inner", new.s["avionics"])
        ctl = inner.get("ctl", inner)
        n_elems = (2 * (bufs[0].numel() + bufs[1].numel()) + params.numel()
                   + geoid_cells(veh.geoid,
                                 new.x["vehicle"]["kinematics"]["q_ew"])
                   + gain_values(av, eas(new),
                                 new.x["vehicle"]["kinematics"]["h_e"],
                                 ctl["lon"]["mode_prev"],
                                 ctl["lat"]["mode_prev"]))
        if nav:
            n_elems += 29 * B + len(K.nav_param_values(av))
            ops = count_ops(plain, matmul=True)
        else:
            fires = (st.i + 1) % sim.steps_per_periodic == 0
            if key == "msn_turb":
                n_elems += K.mission_table(av).numel()
                u_gdc, g_mode = msn_overrides(sim, st, new)
            else:
                u_gdc = st.u["avionics"]["gdc"]
                g_mode = K.gdc_ctl_laws_plain(*gdc_flight_args(
                    sim, new))[2]["mode"]
            ops = count_ops(plain, pass_op_weights(
                av, st.s["avionics"], new.s["avionics"], fires,
                gdc_branches(u_gdc, g_mode)))
        row = dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=launches[name],
            max_abs_err=errs[name], ms=graph_ms(bare),
            plain_ms=cuda_ms(plain, reps=1, calls=1, warm=1),
            nbytes=4 * n_elems, ops=ops, library_ms=None,
            event_ms=cuda_ms(bare),
            wrapper_ms=cuda_ms(lambda: step_packed(bufs)),
            block_ms={n: graph_ms(lambda: bare(n)) for n in (32, 64)},
            launches_per_step=1, share=1.0)
        if nav:
            off = make_megakernel_step(sim, nav_at_epoch(fleets[key][1],
                                                         10))[0]
            row["off_epoch_ms"] = graph_ms(lambda: bare(b_=off))
            log(f"time {name}: {row['off_epoch_ms']:.4f} ms off an aiding "
                f"epoch, {row['ms']:.4f} ms on one [{card}]")
        rows.append(row)
        pr = graph_profile(label, name, step_packed, bufs, bare)
        profiles[label] = pr
        log(f"profile {label}: B = {B}, f32: host "
            f"{pr['host_ms_per_step']:.4f} ms/step, device "
            f"{pr['device_ms_per_step']:.4f} ms/step, idle share "
            f"{pr['idle_share']:.4f}, {B / pr['host_ms_per_step'] * 1e3:.0f} "
            f"vehicle-steps/s [{card}]")
    log("the C172Xv2's last instances' profiles: " + json.dumps(profiles))
    return rows


def landing_nav_flight(card, launches):
    """The sensor-fed crosswind landing at B through megakernel_msn_nav in
    float32 for LANDING_NAV_STEPS steps (100 s), its launches counted from
    0 (the kernels line's count), every lane held to `tests/
    test_missions.py:178-187`: on the ground phase, not terminated, under
    2 m/s, no monitor alarm; the cross-track error from the final leg where
    each lane first rolls out (the phase read from the buffer's own row)
    and the along-track distance to go at wheels-stop
    reported by quantiles (the rollout looked for every LANDING_NAV_EVERY
    steps). Returns (the Simulation, the state at the start)."""
    from flightjax_torch.models.c172 import c172x_gdc as GDC
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.ops.geodesy import nvector_from_qew
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import landing_nav_fleet_sim
    sim, st0 = landing_nav_fleet_sim(B, DEVICE, torch.float32)
    lay = K.layout_of(sim.system.aircraft.vehicle, sim.system.aircraft.avionics)
    row_ph = K.rows_of(lay.mega, "phase").start
    q_rows, h_row = (K.rows_of(lay.mega, "q_ew"),
                     K.rows_of(lay.mega, "h_e").start)
    final = GDC.Segment(*(v.to(device=DEVICE, dtype=torch.float32)
                          for v in M.lows_pattern()["final"]))
    bufs, step_packed, unpack = make_megakernel_step(sim, st0)
    td = torch.full((B,), float("nan"), dtype=torch.float64, device=DEVICE)
    seen = torch.zeros(B, dtype=torch.bool, device=DEVICE)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.time()
    for k in range(1, LANDING_NAV_STEPS + 1):
        bufs = step_packed(bufs)
        if k % LANDING_NAV_EVERY == 0:  # no synchronisation
            b = bufs[0]
            new = (b[row_ph] > 1.5) & ~seen
            e = GDC.segment_data(final, nvector_from_qew(b[q_rows].t()),
                                 b[h_row]).e_sb.double()
            td = torch.where(new, e, td)
            seen |= new
    torch.cuda.synchronize()
    wall = time.time() - t0
    got = {k: v for k, v in K.LAUNCHES.items() if v}
    if got != {"megakernel_msn_nav": LANDING_NAV_STEPS}:
        raise AssertionError(f"the sensor-fed landing: launches {got}")
    launches["megakernel_msn_nav"] = LANDING_NAV_STEPS
    out = unpack(bufs)
    for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
        if val.dtype.is_floating_point and not bool(
                torch.isfinite(val).all()):
            raise AssertionError(f"the sensor-fed landing: non-finite leaf "
                                 f"{p}")
    s_av = out.s["avionics"]
    v = torch.linalg.vector_norm(out.x["vehicle"]["dynamics"]["v_eb_b"],
                                 dim=-1)
    alarm = torch.zeros(B, dtype=torch.bool, device=DEVICE)
    for mon in ("gps", "vel", "baro", "mag", "radar"):
        alarm |= s_av["mon_" + mon]["alarm"]
    fails = {"phase != 2": s_av["inner"]["phase"] != 2,
             "terminated": out.s["terminated"].bool(),
             "|v| >= 2 m/s": v >= 2.0, "a monitor alarm": alarm}
    kin = out.x["vehicle"]["kinematics"]
    stop = GDC.segment_data(final, nvector_from_qew(kin["q_ew"]),
                            kin["h_e"])
    qs = torch.tensor([0.0, 0.05, 0.5, 0.95, 1.0], device=DEVICE,
                      dtype=torch.float64)
    q = lambda x: [round(float(y), 2) for y in torch.quantile(
        x[~x.isnan()], qs)] if bool((~x.isnan()).any()) else "none"
    log(f"the sensor-fed landing: B = {B}, {LANDING_NAV_STEPS} steps (100 s)"
        f" through megakernel_msn_nav in {wall:.2f} s wall, "
        f"{B * LANDING_NAV_STEPS / wall:.0f} vehicle-steps/s; touchdown "
        f"cross-track (min, p5, median, p95, max) {q(td)} m on "
        f"{int(seen.sum())} lanes; wheels-stop cross-track "
        f"{q(stop.e_sb.double())} m, along-track distance to go "
        f"{q(stop.s_2b.double())} m; speed at the end {q(v.double())} m/s; "
        f"lanes failing `tests/test_missions.py:178-187`: "
        + ", ".join(f"{k} {int(x.sum())}" for k, x in fails.items())
        + f" [{card}]")
    bad = torch.stack(list(fails.values())).any(dim=0)
    if bool(bad.any()):
        raise AssertionError(f"the sensor-fed landing: {int(bad.sum())} of "
                             f"{B} lanes fail the JAX test's assertions "
                             f"(lanes {bad.nonzero().flatten()[:16].tolist()}"
                             f")")
    return sim, st0


def takeoff_nav_flight(card):
    """The sensor-fed takeoff at B through megakernel_msn_nav in float32
    for TAKEOFF_NAV_STEPS steps (80 s), on samples every TAKEOFF_NAV_EVERY
    steps (the log of `tests/test_missions.py:254-300`): every lane held to
    that test's assertions that the JAX package's own run of the same
    lanes meets on every lane (`tools/jax_takeoff_nav.json`): phase 3 or
    later and more than 100 m above the field at the end, not terminated,
    the estimated altitude within 3 m of the truth throughout and within
    1 m on the runway phases (standby, startup), no alarm at a sample. The
    test's attitude bound, 2 deg throughout, holds in the JAX package for
    its one aircraft (seed 0) and not for every seed (seeds 5, 8 and 12
    peak at 4.2, 2.0 and 3.1 deg in its own run): lane 0 is held to it,
    and the lanes' peak attitude errors to the JAX run's, their p50 and
    p95 within TAKEOFF_MATCH[0] and each exceedance fraction within
    TAKEOFF_MATCH[1]."""
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import takeoff_nav_fleet_sim
    with open(JAX_TAKEOFF) as fh:
        jref = json.load(fh)
    if jref["lanes"] != B or jref["t_end"] != TAKEOFF_NAV_STEPS * 0.02:
        raise AssertionError(f"{JAX_TAKEOFF} holds {jref['lanes']} lanes, "
                             f"{jref['t_end']} s")
    sim, st0 = takeoff_nav_fleet_sim(B, DEVICE, torch.float32)
    bufs, step_packed, unpack = make_megakernel_step(sim, st0)
    h_err = torch.zeros(B, dtype=torch.float64, device=DEVICE)
    h_rwy = torch.zeros_like(h_err)
    att = torch.zeros_like(h_err)
    alarm = torch.zeros(B, dtype=torch.bool, device=DEVICE)
    on_rwy = torch.zeros_like(alarm)
    torch.cuda.synchronize()
    t0 = time.time()
    for k in range(1, TAKEOFF_NAV_STEPS + 1):
        bufs = step_packed(bufs)
        if k % TAKEOFF_NAV_EVERY:
            continue
        st = unpack(bufs)
        xv, s_av = st.x["vehicle"], st.s["avionics"]
        kin = K._WA.f_ode(xv["kinematics"], xv["dynamics"],
                          st.s["vehicle"]["geoid_N"])[1]
        h_est = st.u["avionics"]["origin"]["h0"] - s_av["nav"].p_n[:, 2]
        e = (h_est.double() - kin.h_e.double()).abs()
        h_err = torch.maximum(h_err, e)
        rwy = s_av["inner"]["phase"] <= 1
        on_rwy |= rwy
        h_rwy = torch.maximum(h_rwy, torch.where(rwy, e, 0.0))
        dot = (kin.q_nb.double() * s_av["nav"].q_nb.double()).sum(-1)
        att = torch.maximum(att, torch.rad2deg(2 * torch.arccos(
            dot.abs().clamp(0.0, 1.0))))
        for mon in ("gps", "vel", "baro", "mag", "radar"):
            alarm |= s_av["mon_" + mon]["alarm"]
    torch.cuda.synchronize()
    wall = time.time() - t0
    out = unpack(bufs)
    xv = out.x["vehicle"]
    agl = (xv["kinematics"]["h_e"] - out.s["vehicle"]["geoid_N"]).double() \
        - M.H_LOWS15
    fails = {"phase < 3": out.s["avionics"]["inner"]["phase"] < 3,
             "terminated": out.s["terminated"].bool(),
             "AGL <= 100 m": agl <= 100.0, "|h error| >= 3 m": h_err >= 3.0,
             "|h error| >= 1 m on the runway": h_rwy >= 1.0,
             "never on the runway phases": ~on_rwy, "an alarm": alarm}
    # the JAX run's own lanes meet the same (its worst lane's numbers)
    jfails = {"phase < 3": jref["phase_end_min"] < 3,
              "terminated": jref["terminated_lanes"] > 0,
              "AGL <= 100 m": jref["agl_end_min"] <= 100.0,
              "|h error| >= 3 m": jref["h_err_max"] >= 3.0,
              "|h error| >= 1 m on the runway":
                  jref["h_err_runway_max"] >= 1.0,
              "an alarm": jref["alarm_lanes"] > 0}
    if any(jfails.values()):
        raise AssertionError(f"the JAX run {JAX_TAKEOFF} fails {jfails}")
    # the attitude: lane 0 (the JAX test's seed) within 2 deg; the peaks'
    # distribution against the JAX run's
    import numpy as np
    a = att.cpu().numpy()
    ja = np.asarray(jref["peak_att_deg"])
    got = {"att_p50": float(np.percentile(a, 50.0)),
           "att_p95": float(np.percentile(a, 95.0)),
           "att_exceedance": [float((a >= t).mean())
                              for t in jref["att_thresholds"]]}
    att_ok = (float(a[0]) < 2.0
              and all(abs(got[k] / jref[k] - 1.0) <= TAKEOFF_MATCH[0]
                      for k in ("att_p50", "att_p95"))
              and all(abs(g - r) <= TAKEOFF_MATCH[1] for g, r in zip(
                  got["att_exceedance"], jref["att_exceedance"])))
    agree = float(((a >= 2.0) == (ja >= 2.0)).mean())
    near = float((np.abs(a - ja) <= 0.1).mean())
    qs = torch.tensor([0.0, 0.5, 0.95, 1.0], device=DEVICE,
                      dtype=torch.float64)
    q = lambda x: [round(float(y), 3) for y in torch.quantile(x, qs)]
    log(f"the sensor-fed takeoff: B = {B}, {TAKEOFF_NAV_STEPS} steps (80 s) "
        f"through megakernel_msn_nav in {wall:.2f} s wall with a sample "
        f"every {TAKEOFF_NAV_EVERY} steps; AGL at the end (min, median, p95,"
        f" max) {q(agl)} m, peak |h error| {q(h_err)} m (runway phases "
        f"{q(h_rwy)} m), peak attitude error {q(att)} deg, phases at the end "
        f"{torch.bincount(out.s['avionics']['inner']['phase'].long(), minlength=4).tolist()}"
        f"; lanes failing `tests/test_missions.py:268-300` but its attitude "
        f"bound: "
        + ", ".join(f"{k} {int(x.sum())}" for k, x in fails.items())
        + f" [{card}]")
    log(f"the sensor-fed takeoff's peak attitude errors against the JAX "
        f"package's own run of the same lanes ({JAX_TAKEOFF}): lane 0 (the "
        f"JAX test's seed) {float(a[0]):.3f} deg (JAX {ja[0]:.3f}; bound "
        f"2); p50 {got['att_p50']:.4f} / {jref['att_p50']:.4f}, p95 "
        f"{got['att_p95']:.4f} / {jref['att_p95']:.4f} deg (within "
        f"{TAKEOFF_MATCH[0]:.0%}); exceedance of {jref['att_thresholds']} "
        f"deg {[round(g, 4) for g in got['att_exceedance']]} / "
        f"{[round(r, 4) for r in jref['att_exceedance']]} (within "
        f"{TAKEOFF_MATCH[1]}); max {float(a.max()):.3f} / "
        f"{jref['att_max']:.3f}; the lanes on the same side of 2 deg as "
        f"JAX's {agree:.4f}, within 0.1 deg of JAX's {near:.4f} [{card}]")
    if not att_ok:
        raise AssertionError("the sensor-fed takeoff's peak attitude errors "
                             "disagree with the JAX run's")
    bad = torch.stack(list(fails.values())).any(dim=0)
    if bool(bad.any()):
        raise AssertionError(f"the sensor-fed takeoff: {int(bad.sum())} of "
                             f"{B} lanes fail the JAX test's assertions "
                             f"(lanes {bad.nonzero().flatten()[:16].tolist()}"
                             f")")


def msn_nav_phase(card, t_start, check, errs, regs, sizes):
    """The sensor-fed missions: msn_nav_ctl_laws, nav_pass's mission
    instance and megakernel_msn_nav against their plain versions; the
    two-mission fleet's three paths MSN_NAV_STEPS steps against the
    float64 plain step; the landing's 100 s and the takeoff's 80 s at B on
    every lane within their JAX tests' assertions; the instances' times,
    bounds and launches and the megakernel path's profile. Returns the two
    instances' rows of the kernels line."""
    from flightjax_torch.ops.random import normal_table
    from flightjax_torch.parallel import fleet as F
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.clusterstep import (make_cluster_step,
                                                      vehicle_step)
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (NAV_SPREAD, msn_gate_lanes,
                                         msn_nav_fleet_sim, msn_nav_laws_args,
                                         msn_nav_operand_state,
                                         msn_nav_pass_args, nav_hold,
                                         nav_pass_args, nav_reference)
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed missions: "
        f"kernel checks)")
    tr = lambda x: (x.t, x.x, x.u, x.s)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        fsim, fst = msn_nav_fleet_sim(B, DEVICE, dtype)
        # the mission's pass on the estimates: exact in float32, as the
        # truth-fed pass it instantiates
        for what, args in (
                ("mode-rich operands", msn_nav_laws_args(
                    B, SEED, DEVICE, dtype, GROUND_LANES)),
                ("the fleet's estimates", msn_nav_pass_args(fsim, fst))):
            ref = K.msn_nav_ctl_laws_plain(*args)
            for lanes in (32, 64):
                buf, n_out, scal, ops = K.PACK["msn_nav_ctl_laws"](*args)
                got = K.unpack_out("msn_nav_ctl_laws", L.launch(
                    "msn_nav_ctl_laws", buf, n_out, scal, block=lanes, **ops))
                torch.cuda.synchronize()
                check("msn_nav_ctl_laws", dtype, tol if dtype == torch.float64
                      else 0.0, leaf_pairs(got, ref),
                      f" ({what}, block {lanes})")
        # the navigation pass's mission instance and the megakernel on the
        # mode-rich operands in each setting and on the fleet at its first
        # GPS epoch
        cases = [(f"mode-rich, {s_}", *msn_nav_operand_state(
            B, SEED, DEVICE, dtype, setting=s_))
            for s_ in MSN_NAV_SETTINGS[dtype]]
        cases.append(("fleet, first GPS epoch", fsim, nav_at_epoch(fst)))
        for what, sim, st in cases:
            nav = sim.system.aircraft.avionics
            args = nav_pass_args(sim, st)
            ref = K.nav_pass_plain(*args)
            ref_c = nav_reference(sim, dtype, lambda s_, a: K.nav_pass_plain(
                s_.system.aircraft.avionics, *a), args[1:])
            for lanes in (32, 64):
                got = K.nav_pass(*args, block=lanes)
                torch.cuda.synchronize()
                nav_held("nav_pass", dtype, got, ref, ref_c, got[0], ref[0],
                         nav, f" (mission instance, {what}, block {lanes})",
                         errs)
            ref = megakernel_step_plain(sim, st)
            ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
            gate = msn_gate_lanes(sim, ref)
            for lanes in (32, 64):
                bufs, step_packed, unpack = make_megakernel_step(
                    sim, st, block=lanes)
                got = unpack(step_packed(bufs))
                torch.cuda.synchronize()
                if not torch.equal(got.i, ref.i):
                    raise AssertionError("megakernel_msn_nav: step counter")
                nav_held("megakernel_msn_nav", dtype, tr(got), tr(ref),
                         tr(ref_c), got.s["avionics"], ref.s["avionics"],
                         nav, f" ({what}, block {lanes})", errs,
                         gate | msn_gate_lanes(sim, got))
        del cases, fsim, fst, ref, ref_c, got

    # the two-mission fleet's paths, from their launch counts set to 0,
    # against the float64 plain step (one plain run for fleet_step and the
    # megakernel, which compensate, one for the vehicle split)
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed missions: "
        f"paths)")
    sim, st0 = msn_nav_fleet_sim(B, DEVICE, torch.float32)
    nav = sim.system.aircraft.avionics

    def plain_steps(mega, sim_, st, n=MSN_NAV_STEPS):
        for k in range(n):
            st = (megakernel_step_plain(sim_, st) if mega else vehicle_step(
                sim_, st, k, plain=True))
        return st

    launches, refs, twins = {}, {}, {}
    env = [e * MSN_NAV_STEPS / STEPS for e in (ENV_POS_M, ENV_VEL,
                                              ENV_ATT_RAD, ENV_EAS)]
    per_step = {"msn_nav_fleet": dict(kinair=4, systems_fbw=5, dynamics=4,
                                      finish_kin=1, finish_sys_fbw=1,
                                      geoid=1, nav_pass=1,
                                      msn_nav_ctl_laws=1),
                "msn_nav_vehicle": dict(rk4_stage_fbw=4, rk4_finish_fbw=1,
                                        systems_fbw=1, geoid=1, nav_pass=1,
                                        msn_nav_ctl_laws=1),
                "msn_nav_megakernel": dict(megakernel_msn_nav=1)}
    for label in MSN_NAV_PATHS:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.time()
        if label == "msn_nav_megakernel":
            bufs, step_packed, unpack = make_megakernel_step(sim, st0)
            for _ in range(MSN_NAV_STEPS):
                bufs = step_packed(bufs)
            out = unpack(bufs)
        elif label == "msn_nav_fleet":
            out = F.fleet_rollout(sim, st0, MSN_NAV_STEPS)
        else:
            step = make_cluster_step(sim, st0, split="vehicle")
            out = st0
            for k in range(MSN_NAV_STEPS):
                out = step(out, i=k)
        torch.cuda.synchronize()
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        want = {k: v * MSN_NAV_STEPS for k, v in per_step[label].items()}
        log(f"{label}: {MSN_NAV_STEPS} steps x {B} aircraft in "
            f"{time.time() - t0:.2f} s (first run); launches {got}")
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        if label == "msn_nav_vehicle":
            launches["msn_nav_ctl_laws"] = got["msn_nav_ctl_laws"]
        for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
            if val.dtype.is_floating_point and not bool(
                    torch.isfinite(val).all()):
                raise AssertionError(f"{label}: non-finite leaf {p}")
        if bool(out.s["terminated"].any()):
            raise AssertionError(f"{label}: a lane terminated")
        mega = label != "msn_nav_vehicle"
        if mega not in refs:
            K.reset_launches()
            refs[mega] = plain_steps(mega, sim, st0)
            torch.cuda.synchronize()
            if any(K.LAUNCHES.values()):
                raise AssertionError(f"{label}: plain run launched a kernel")
            twins[mega] = nav_reference(sim, torch.float32, lambda s_, x: (
                plain_steps(mega, s_, x)), st0)
        ref, twin = refs[mega], twins[mega]
        p_err, n_bad, n_far, worst = nav_hold(
            torch.float32, tr(out), tr(ref), tr(twin), out.s["avionics"],
            ref.s["avionics"], nav, label,
            msn_gate_lanes(sim, ref) | msn_gate_lanes(sim, out))
        d_k, d_p = compare_runs(out, twin), compare_runs(ref, twin)
        lim = [max(NAV_SPREAD * p_, e) for p_, e in zip(d_p, env)]
        top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:4]
        log(f"{label} after {MSN_NAV_STEPS} steps on the estimates (f32), "
            f"kernels / plain vs the float64 plain step: position "
            f"{d_k[0]:.3e} / {d_p[0]:.3e} m (limit {lim[0]:.3g}), velocity "
            f"{d_k[1]:.3e} / {d_p[1]:.3e} m/s (limit {lim[1]:.3g}), "
            f"attitude {d_k[2]:.3e} / {d_p[2]:.3e} rad (limit "
            f"{lim[2]:.3g}), EAS {d_k[3]:.3e} / {d_p[3]:.3e} m/s (limit "
            f"{lim[3]:.3g}); P per lane {p_err:.3e}; integers, flags and "
            f"phases differ on {n_bad} lanes ({n_bad - n_far} at a gate); "
            f"the worst leaves (error, limit) "
            + ", ".join(f"{k_} {e:.2e} ({l_:.1e})" for k_, (e, l_) in top))
        if not all(v_ <= l_ for v_, l_ in zip(d_k, lim)):
            raise AssertionError(f"{label}: the kernels' run is further from "
                                 f"the float64 step than the plain run's "
                                 f"limit")
    del refs, twins, out, ref, twin

    # the two missions at B to their JAX tests' ends
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed missions: "
        f"the landing and the takeoff)")
    lsim, lst0 = landing_nav_flight(card, launches)
    takeoff_nav_flight(card)

    # timings: the megakernel on the landing fleet at its first GPS epoch
    # (every lane aiding) and off an aiding epoch, the pass on the fleet's
    # estimates; the megakernel path's profile
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed missions: "
        f"timings)")
    rows = []
    st = nav_at_epoch(lst0)
    lnav = lsim.system.aircraft.avionics
    veh = lsim.system.aircraft.vehicle
    bufs, step_packed, unpack = make_megakernel_step(lsim, st)
    params, grid, gains = (K.system_params(veh), K.geoid_grid(veh.geoid),
                           K.ctl_gains(lnav))
    table = normal_table(DEVICE)

    def bare(lanes=None, b_=bufs):
        return L.launch_megakernel(
            b_[0], b_[1], params, grid, lsim.dt, lsim.t_start,
            st.c is not None, lanes, gains, lsim.steps_per_periodic,
            lsim.periodic_dt, msn=True, table=table)
    new = unpack(step_packed(bufs))
    plain = lambda: megakernel_step_plain(lsim, st)
    ctl = new.s["avionics"]["inner"]["inner"]["ctl"]
    n_elems = (2 * (bufs[0].numel() + bufs[1].numel()) + params.numel()
               + geoid_cells(veh.geoid, new.x["vehicle"]["kinematics"]["q_ew"])
               + gain_values(lnav, eas(new),
                             new.x["vehicle"]["kinematics"]["h_e"],
                             ctl["lon"]["mode_prev"], ctl["lat"]["mode_prev"])
               + 29 * B + len(K.nav_param_values(lnav))
               + len(K.mission_table_values(lnav.inner)))
    row = dict(name="megakernel_msn_nav", route="cuda",
               source=KERNELS["megakernel_msn_nav"][0],
               replaces=KERNELS["megakernel_msn_nav"][1],
               launches=launches["megakernel_msn_nav"],
               max_abs_err=errs["megakernel_msn_nav"], ms=graph_ms(bare),
               plain_ms=cuda_ms(plain, reps=1, calls=1, warm=1),
               nbytes=4 * n_elems, ops=count_ops(plain, matmul=True),
               library_ms=None, event_ms=cuda_ms(bare),
               wrapper_ms=cuda_ms(lambda: step_packed(bufs)),
               block_ms={n: graph_ms(lambda: bare(n)) for n in (32, 64)},
               launches_per_step=1, share=1.0)
    off = make_megakernel_step(lsim, nav_at_epoch(lst0, 10))[0]
    row["off_epoch_ms"] = graph_ms(lambda: bare(b_=off))
    log(f"time megakernel_msn_nav: {row['off_epoch_ms']:.4f} ms off an "
        f"aiding epoch, {row['ms']:.4f} ms on one [{card}]")
    # nav_pass's mission instance (launched under nav_pass's name and
    # counted in its row) on the same fleet at the same epoch
    pbuf, pn_out, _, pops = K.pack_nav_pass(*nav_pass_args(lsim, st))
    log(f"time nav_pass (its mission instance, the h_o row): "
        f"{graph_ms(lambda: L.launch_nav_pass(pbuf, pn_out, pops['ints'], pops['gains'], table, ho=True)):.4f} "
        f"ms on an aiding epoch, {graph_ms(lambda: L.launch_nav_pass(pbuf, pn_out - 1, pops['ints'], pops['gains'], table)):.4f} "
        f"ms for the other instance on the same operands [{card}]")
    del pbuf, pops
    rows.append(row)
    pr = graph_profile("msn_nav_megakernel", "megakernel_msn_nav",
                       step_packed, bufs, bare)
    log(f"profile msn_nav_megakernel: B = {B}, f32: host "
        f"{pr['host_ms_per_step']:.4f} ms/step, device "
        f"{pr['device_ms_per_step']:.4f} ms/step, idle share "
        f"{pr['idle_share']:.4f}, {B / pr['host_ms_per_step'] * 1e3:.0f} "
        f"vehicle-steps/s [{card}]")
    del bufs, off, new
    # msn_nav_ctl_laws on the two-mission fleet's estimates at its start
    # (half on the final approach, half parked)
    args = msn_nav_pass_args(sim, st0)
    packed = K.PACK["msn_nav_ctl_laws"](*args)

    def bare_pass(lanes=None):
        buf, n_out, scal, ops = packed
        return L.launch("msn_nav_ctl_laws", buf, n_out, scal, block=lanes,
                        **ops)
    ref = K.msn_nav_ctl_laws_plain(*args)
    buf, n_out, _, _ = packed
    inner = args[0]
    n_elems = buf.numel() + n_out * B + K.mission_table(inner).numel() \
        + gain_values(inner, args[1]["EAS"], args[1]["h_e"],
                      ref[0]["inner"]["ctl"]["lon"]["mode_prev"],
                      ref[0]["inner"]["ctl"]["lat"]["mode_prev"])
    blocks = {n: graph_ms(lambda: bare_pass(n)) for n in (32, 64)}
    rows.append(dict(
        name="msn_nav_ctl_laws", route="cuda",
        source=KERNELS["msn_nav_ctl_laws"][0],
        replaces=KERNELS["msn_nav_ctl_laws"][1],
        launches=launches["msn_nav_ctl_laws"],
        max_abs_err=errs["msn_nav_ctl_laws"], ms=blocks[L.LANES],
        plain_ms=cuda_ms(lambda: K.msn_nav_ctl_laws_plain(*args), reps=3,
                         calls=2, warm=1),
        nbytes=4 * n_elems,
        ops=count_ops(lambda: K.msn_nav_ctl_laws_plain(*args),
                      pass_op_weights(inner, args[3], ref[0],
                                      gdc_lanes=gdc_branches(
                                          None, ref[2]["mode"]))),
        library_ms=None, event_ms=cuda_ms(bare_pass),
        wrapper_ms=cuda_ms(lambda: K.msn_nav_ctl_laws(*args)),
        block_ms=blocks, launches_per_step=1))
    log("the sensor-fed missions' profile: " + json.dumps(pr))
    return rows


def nav_turb_phase(card, t_start, check, errs, regs, sizes):
    """The sensor-fed C172Xv2 and missions in Dryden turbulence:
    megakernel_gdc_nav_turb and megakernel_msn_nav_turb against their plain
    versions in float64 and float32 at 32 and 64 aircraft per block, on
    their mode-rich operands in each navigation setting once
    (NAV_TURB_CASES, the pass every step and every other step) and on
    their fleets at the first GPS epoch, as `testing.nav_hold` holds them
    (around the missions with `testing.msn_gate_lanes`); the six paths
    NAV_TURB_STEPS steps in float32 from their launch counts set to 0,
    held to the float64 plain step as the sensor-fed missions' are; the
    turbulent loiter on estimates at B for its 60 s through
    megakernel_gdc_nav_turb, held to the JAX package's own run
    (`tools/jax_loiter_turb.json`); the instances' times on and off an
    aiding epoch, bounds and launches and the megakernel paths' profiles.
    Returns the two instances' rows of the kernels line."""
    from flightjax_torch.ops.random import normal_table
    from flightjax_torch.parallel import fleet as F
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.clusterstep import (make_cluster_step,
                                                      vehicle_step)
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (NAV_SPREAD, msn_gate_lanes,
                                         msn_nav_fleet_sim,
                                         msn_nav_operand_state, nav_hold,
                                         nav_operand_state, nav_reference,
                                         turb_loiter_fleet_sim)
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed C172Xv2 and "
        f"missions in turbulence: kernel checks)")
    tr = lambda x: (x.t, x.x, x.u, x.s)

    def fleet_of(avk, dtype):
        if avk == "gdc":
            return turb_loiter_fleet_sim(B, DEVICE, dtype)[:2]
        return msn_nav_fleet_sim(B, DEVICE, dtype, turbulence=True)

    def gates(avk, sim, *states):
        if avk != "msn":
            return None
        out = msn_gate_lanes(sim, states[0])
        for st in states[1:]:
            out = out | msn_gate_lanes(sim, st)
        return out

    for dtype in (torch.float64, torch.float32):
        for avk in ("gdc", "msn"):
            name = f"megakernel_{avk}_nav_turb"
            cases = []
            for setting, spp in NAV_TURB_CASES[dtype]:
                if avk == "gdc":
                    sim, st = nav_operand_state(
                        B, SEED, DEVICE, dtype, turbulence=True,
                        setting=setting, spp=spp, gdc=True)
                else:
                    sim, st = msn_nav_operand_state(
                        B, SEED, DEVICE, dtype, setting=setting, spp=spp,
                        turbulence=True)
                cases.append((f"mode-rich, {setting}, pass every {spp}",
                              sim, st))
            fsim, fst = fleet_of(avk, dtype)
            cases.append(("fleet, first GPS epoch", fsim, nav_at_epoch(fst)))
            for what, sim, st in cases:
                ref = megakernel_step_plain(sim, st)
                ref_c = nav_reference(sim, dtype, megakernel_step_plain, st)
                for lanes in (32, 64):
                    bufs, step_packed, unpack = make_megakernel_step(
                        sim, st, block=lanes)
                    got = unpack(step_packed(bufs))
                    torch.cuda.synchronize()
                    if not (torch.equal(got.i, ref.i) and torch.equal(
                            got.s["vehicle"]["turb"]["n"],
                            ref.s["vehicle"]["turb"]["n"])):
                        raise AssertionError(f"{name}: counters")
                    nav_held(name, dtype, tr(got), tr(ref), tr(ref_c),
                             got.s["avionics"], ref.s["avionics"],
                             sim.system.aircraft.avionics,
                             f" ({what}, block {lanes})", errs,
                             gates(avk, sim, ref, got))
            del cases, fsim, fst, ref, ref_c, got

    # the six paths, from their launch counts set to 0, against the
    # float64 plain step (one plain run for fleet_step and the megakernel,
    # which compensate, one for the vehicle split)
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed C172Xv2 and "
        f"missions in turbulence: paths)")
    launches = {}
    env = [e * NAV_TURB_STEPS / STEPS for e in (ENV_POS_M, ENV_VEL,
                                               ENV_ATT_RAD, ENV_EAS)]

    def plain_steps(mega, sim_, st, n=NAV_TURB_STEPS):
        for k in range(n):
            st = (megakernel_step_plain(sim_, st) if mega else vehicle_step(
                sim_, st, k, plain=True))
        return st
    fleets = {}
    for avk, pre in (("gdc", "xv2_nav_turb"), ("msn", "msn_nav_turb")):
        sim, st0 = fleets[avk] = fleet_of(avk, torch.float32)
        laws = "gdc_ctl_laws" if avk == "gdc" else "msn_nav_ctl_laws"
        split = dict(rk4_stage_fbw_turb=4, rk4_finish_fbw_turb=1,
                     systems_fbw=1, geoid=1, nav_pass=1, **{laws: 1})
        refs, twins = {}, {}
        for label in (pre + "_fleet", pre + "_vehicle", pre + "_megakernel"):
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.time()
            mega = not label.endswith("_vehicle")
            if label.endswith("_megakernel"):
                bufs, step_packed, unpack = make_megakernel_step(sim, st0)
                for _ in range(NAV_TURB_STEPS):
                    bufs = step_packed(bufs)
                out = unpack(bufs)
                want = {f"megakernel_{avk}_nav_turb": NAV_TURB_STEPS}
            else:
                if label.endswith("_fleet"):
                    out = F.fleet_rollout(sim, st0, NAV_TURB_STEPS)
                else:
                    step = make_cluster_step(sim, st0, split="vehicle")
                    out = st0
                    for k in range(NAV_TURB_STEPS):
                        out = step(out, i=k)
                want = {k: v * NAV_TURB_STEPS for k, v in split.items()}
            torch.cuda.synchronize()
            got = {k: v for k, v in K.LAUNCHES.items() if v}
            log(f"{label}: {NAV_TURB_STEPS} steps x {B} aircraft in "
                f"{time.time() - t0:.2f} s (first run); launches {got}")
            if got != want:
                raise AssertionError(f"{label}: launch counts {got} != "
                                     f"{want}")
            if label.endswith("_megakernel"):
                launches.update(got)
            for p, val in leaves({"x": out.x, "s": out.s, "u": out.u}):
                if val.dtype.is_floating_point and not bool(
                        torch.isfinite(val).all()):
                    raise AssertionError(f"{label}: non-finite leaf {p}")
            if bool(out.s["terminated"].any()):
                raise AssertionError(f"{label}: a lane terminated")
            if mega not in refs:
                K.reset_launches()
                refs[mega] = plain_steps(mega, sim, st0)
                torch.cuda.synchronize()
                if any(K.LAUNCHES.values()):
                    raise AssertionError(f"{label}: plain run launched a "
                                         f"kernel")
                twins[mega] = nav_reference(sim, torch.float32, lambda s_, x: (
                    plain_steps(mega, s_, x)), st0)
            ref, twin = refs[mega], twins[mega]
            p_err, n_bad, n_far, worst = nav_hold(
                torch.float32, tr(out), tr(ref), tr(twin), out.s["avionics"],
                ref.s["avionics"], sim.system.aircraft.avionics, label,
                gates(avk, sim, ref, out))
            d_k, d_p = compare_runs(out, twin), compare_runs(ref, twin)
            lim = [max(NAV_SPREAD * p_, e) for p_, e in zip(d_p, env)]
            top = sorted(worst.items(), key=lambda kv: -kv[1][0])[:4]
            log(f"{label} after {NAV_TURB_STEPS} steps on the estimates "
                f"(f32), kernels / plain vs the float64 plain step: position "
                f"{d_k[0]:.3e} / {d_p[0]:.3e} m (limit {lim[0]:.3g}), "
                f"velocity {d_k[1]:.3e} / {d_p[1]:.3e} m/s (limit "
                f"{lim[1]:.3g}), attitude {d_k[2]:.3e} / {d_p[2]:.3e} rad "
                f"(limit {lim[2]:.3g}), EAS {d_k[3]:.3e} / {d_p[3]:.3e} m/s "
                f"(limit {lim[3]:.3g}); P per lane {p_err:.3e}; integers, "
                f"flags and phases differ on {n_bad} lanes ({n_bad - n_far} "
                f"at a gate); the worst leaves (error, limit) "
                + ", ".join(f"{k_} {e:.2e} ({l_:.1e})"
                            for k_, (e, l_) in top))
            if not all(v_ <= l_ for v_, l_ in zip(d_k, lim)):
                raise AssertionError(f"{label}: the kernels' run is further "
                                     f"from the float64 step than the plain "
                                     f"run's limit")
        del refs, twins, out, ref, twin

    # the turbulent loiter on estimates: its 60 s on every lane, against
    # the JAX package's own run of the same fleet
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed C172Xv2 and "
        f"missions in turbulence: the turbulent loiter on estimates)")
    lsim, lst0, orbit = turb_loiter_fleet_sim(B, DEVICE, torch.float32)
    loiter_flight(card, lsim, lst0, orbit, launches,
                  name="megakernel_gdc_nav_turb",
                  label="xv2_nav_turb_megakernel", jax_path=JAX_LOITER_TURB)
    del lsim, lst0

    # timings: each instance on its fleet at the first GPS epoch (every
    # lane aiding) and off an aiding epoch; the megakernel paths' profiles
    log(f"elapsed {time.time() - t_start:.1f} s (the sensor-fed C172Xv2 and "
        f"missions in turbulence: timings)")
    rows, profiles = [], {}
    table = normal_table(DEVICE)
    for avk, label in (("gdc", "xv2_nav_turb_megakernel"),
                       ("msn", "msn_nav_turb_megakernel")):
        name = f"megakernel_{avk}_nav_turb"
        sim, st0 = fleets[avk]
        st = nav_at_epoch(st0)
        av = sim.system.aircraft.avionics
        veh = sim.system.aircraft.vehicle
        bufs, step_packed, unpack = make_megakernel_step(sim, st)
        params, grid, gains = (K.system_params(veh), K.geoid_grid(veh.geoid),
                               K.ctl_gains(av))

        def bare(lanes=None, b_=bufs, sim=sim, params=params, grid=grid,
                 gains=gains, comp=st.c is not None, msn=avk == "msn"):
            return L.launch_megakernel(
                b_[0], b_[1], params, grid, sim.dt, sim.t_start, comp, lanes,
                gains, sim.steps_per_periodic, sim.periodic_dt, gdc=not msn,
                msn=msn, turb=True, table=table)
        new = unpack(step_packed(bufs))
        plain = lambda sim=sim, st=st: megakernel_step_plain(sim, st)
        inner = new.s["avionics"]["inner"]
        ctl = inner["inner"]["ctl"] if avk == "msn" else inner["ctl"]
        n_elems = (2 * (bufs[0].numel() + bufs[1].numel()) + params.numel()
                   + geoid_cells(veh.geoid,
                                 new.x["vehicle"]["kinematics"]["q_ew"])
                   + gain_values(av, eas(new),
                                 new.x["vehicle"]["kinematics"]["h_e"],
                                 ctl["lon"]["mode_prev"],
                                 ctl["lat"]["mode_prev"])
                   + 29 * B + len(K.nav_param_values(av)))
        if avk == "msn":
            n_elems += len(K.mission_table_values(av.inner))
        row = dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=launches[name],
            max_abs_err=errs[name], ms=graph_ms(bare),
            plain_ms=cuda_ms(plain, reps=1, calls=1, warm=1),
            nbytes=4 * n_elems, ops=count_ops(plain, matmul=True),
            library_ms=None, event_ms=cuda_ms(bare),
            wrapper_ms=cuda_ms(lambda: step_packed(bufs)),
            block_ms={n: graph_ms(lambda: bare(n)) for n in (32, 64)},
            launches_per_step=1, share=1.0)
        off = make_megakernel_step(sim, nav_at_epoch(st0, 10))[0]
        row["off_epoch_ms"] = graph_ms(lambda: bare(b_=off))
        log(f"time {name}: {row['off_epoch_ms']:.4f} ms off an aiding "
            f"epoch, {row['ms']:.4f} ms on one [{card}]")
        rows.append(row)
        pr = graph_profile(label, name, step_packed, bufs, bare)
        profiles[label] = pr
        log(f"profile {label}: B = {B}, f32: host "
            f"{pr['host_ms_per_step']:.4f} ms/step, device "
            f"{pr['device_ms_per_step']:.4f} ms/step, idle share "
            f"{pr['idle_share']:.4f}, {B / pr['host_ms_per_step'] * 1e3:.0f} "
            f"vehicle-steps/s [{card}]")
        del bufs, off, new
    log("the sensor-fed C172Xv2's and missions' turbulent profiles: "
        + json.dumps(profiles))
    return rows


# ------------------------------------------------------------ Actuator2

def servo2_phase(card, t_start, check, errs, regs, sizes):
    """The C172Xv1 with a second-order elevator (`Actuator2`, the vehicle
    of the JAX package's `tests/test_actuators.py:95`): rk4_stage_fbw_a2,
    rk4_finish_fbw_a2 (with and without residuals) and megakernel_fbw_a2
    (with and without residuals, the pass every step and every other step)
    against their plain versions in float64 and float32 exactly at 32 and
    64 aircraft per block, on the runway operands (`testing.
    fbw_cluster_operands(a2=)`, `xv1_operand_state(a2=)`: servo positions
    and the elevator's position past their ranges, its rate and derivative
    drawn, lanes on the runway, a terminated and a crashing lane) and on
    the airborne turning-climb fleet (`testing.xv1_fleet_sim(a2=)`, each
    lane's elevator rate drawn); the vehicle and megakernel paths at B in float32 from their
    launch counts set to 0, A2_STEPS steps against the plain path within
    the scaled 10 s envelope, with the checks of phase 4's `xv1_vehicle`
    and `xv1_megakernel`, and F64_A2_STEPS float64 steps to 1e-9; the
    megakernel's turning climb for A2_FLIGHT steps (60 s), held to its
    twin on first-order servos (`megakernel_fbw` on the same lanes): the
    lanes that stall at some step the same but for 1% of B, the mean EAS
    within 1 m/s and the mean height within 10 m; the refusal of
    `Simulation.fleet_step` on the card, whose subsystems instances are
    still to port; the instances' times, bounds and launches, and the
    paths' vehicle-steps/s beside `xv1_vehicle` and `xv1_megakernel`.
    Returns the three instances' rows of the kernels line."""
    from flightjax_torch.core.sim import comp_residuals
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import (fbw_cluster_operands,
                                         flight_operand_args, xv1_fleet_sim,
                                         xv1_operand_state)
    t_phase = time.time()
    log(f"elapsed {t_phase - t_start:.1f} s (the second-order elevator: "
        f"kernel checks)")
    a2 = K.A2_CARD
    lay = K.FBW_A2
    names = {k: lay.names[k] for k in ("rk4_stage", "rk4_finish")}

    def a2_fleet(dtype):
        return xv1_fleet_sim(B, SEED, DEVICE, dtype, a2=a2)

    def a2_sim(dtype, spp):
        # a system of its own: a Simulation sets its system's periodic_dt
        from flightjax_torch.core.sim import Simulation
        from flightjax_torch.models.c172.c172x import Actuator2, c172xv1_sim
        sim, _, _ = c172xv1_sim(DEVICE, dtype,
                                actuators={"elevator": Actuator2()})
        return Simulation(sim.system, dt=sim.dt, periodic_dt=spp * sim.dt,
                          geoid_every=sim.geoid_every)

    def runway_args(dtype):
        from flightjax_torch.models.c172.c172x import Actuator2
        from flightjax_torch.models.c172.c172x import build_vehicle as fbw
        d = fbw_cluster_operands(B, SEED, GROUND_LANES, TERMINATED_LANES,
                                 (CRASH_LANE,), a2=a2)
        args = K.operand_args(d, fbw(device=DEVICE, dtype=dtype, actuators={
            "elevator": Actuator2()}), DEVICE, dtype, adt=0.01, dt=0.02)
        return {names[k]: args[k] for k in names}

    for dtype in (torch.float64, torch.float32):
        fsim, fst = a2_fleet(dtype)
        flight = flight_operand_args(fsim, fst)
        cases = {"runway operands": runway_args(dtype),
                 "turning-climb fleet": {names[k]: flight[k]
                                         for k in names}}
        for what, args in cases.items():
            for name, a in args.items():
                base = name[:-len("_fbw_a2")]
                comps = (False, True) if (
                    base == "rk4_finish" and len(a) == 8) else (False,)
                for comp in comps:
                    a_ = a if comp or len(a) == 7 else a[:-1] + (None,)
                    ref = getattr(K, base + "_plain")(*a_)
                    before = K.LAUNCHES[name]
                    got = getattr(K, base)(*a_)  # the wrapper
                    torch.cuda.synchronize()
                    if K.LAUNCHES[name] != before + 1:
                        raise AssertionError(f"{name}: the wrapper did not "
                                             f"launch it")
                    tag = f" ({what}{', comp' * comp}"
                    check(name, dtype, 0.0, leaf_pairs(got, ref),
                          tag + ", wrapper)")
                    for lanes in (32, 64):
                        buf, n_out, scal, ops = K.PACK[name](*a_)
                        got = K.unpack_out(name, L.launch(
                            name, buf, n_out, scal, block=lanes, **ops),
                            comp)
                        torch.cuda.synchronize()
                        check(name, dtype, 0.0, leaf_pairs(got, ref),
                              tag + f", block {lanes})")
                    if base == "rk4_finish" and what.startswith("runway") \
                            and not bool(got[1]["crashed"][CRASH_LANE]):
                        raise AssertionError(f"{name}: the crash lane did "
                                             f"not latch crashed")
        # megakernel_fbw_a2 on the runway state and the fleet
        mega_cases = []
        for comp, spp in ((False, 1), (True, 2)):
            st = xv1_operand_state(B, SEED, DEVICE, dtype, GROUND_LANES,
                                   TERMINATED_LANES, (CRASH_LANE,), i0=126,
                                   a2=a2)
            st = st._replace(i=st.i + torch.arange(
                B, dtype=torch.int32, device=DEVICE) % spp)
            mega_cases.append((f"runway state, comp {comp}, pass every "
                               f"{spp}", a2_sim(dtype, spp), st._replace(
                                   c=comp_residuals(st.x, force=True)
                                   if comp else None)))
        mega_cases.append(("turning-climb fleet", fsim, fst))
        for what, msim, mst in mega_cases:
            ref = megakernel_step_plain(msim, mst)
            for lanes in (32, 64):
                bufs, step_packed, unpack = make_megakernel_step(
                    msim, mst, block=lanes)
                got = unpack(step_packed(bufs))
                torch.cuda.synchronize()
                check("megakernel_fbw_a2", dtype, 0.0,
                      leaf_pairs(tuple(got), tuple(ref)),
                      f" ({what}, block {lanes})")
            if what.startswith("runway") and not bool(
                    got.s["vehicle"]["systems"]["crashed"][CRASH_LANE]):
                raise AssertionError("megakernel_fbw_a2: the crash lane did "
                                     "not latch crashed")
        elv = fst.x["vehicle"]["systems"]["act"]["elevator"]
        log(f"the second-order elevator ({str(dtype)[6:]}): the fleet's "
            f"rates {float(elv['v'].min()):.3f}..{float(elv['v'].max()):.3f}"
            f", buffer rows {bufs[0].shape[0]} (megakernel_fbw's + 1)")
        del flight, cases, mega_cases, ref, got

    # the paths, from their launch counts set to 0
    log(f"elapsed {time.time() - t_start:.1f} s (the second-order elevator: "
        f"paths)")
    from flightjax_torch.parallel.clusterstep import make_cluster_step
    sim, st0 = a2_fleet(torch.float32)
    vst0 = st0._replace(c=None)
    vstep = make_cluster_step(sim, vst0, split="vehicle")
    env = [e * A2_STEPS / STEPS for e in (ENV_POS_M, ENV_VEL, ENV_ATT_RAD,
                                          ENV_EAS)]
    launches = {}
    for label in A2_PATHS:
        torch.cuda.synchronize()
        K.reset_launches()
        stalled = torch.zeros(B, dtype=torch.bool, device=DEVICE)
        t0 = time.time()
        if label == "a2_vehicle":
            out = vst0
            for k in range(A2_STEPS):
                out = vstep(out, i=k)
                stalled.logical_or_(stall_of(out))
            want = {names["rk4_stage"]: 4 * A2_STEPS,
                    names["rk4_finish"]: A2_STEPS, "ctl_laws": A2_STEPS}
        else:
            bufs, step_packed, unpack = make_megakernel_step(sim, st0)
            for _ in range(A2_STEPS):
                bufs = step_packed(bufs)
                stalled.logical_or_(stall_of(unpack(bufs)))
            out = unpack(bufs)
            want = {"megakernel_fbw_a2": A2_STEPS}
        torch.cuda.synchronize()
        got = {k: v for k, v in K.LAUNCHES.items() if v}
        log(f"{label}: {A2_STEPS} steps x {B} aircraft in "
            f"{time.time() - t0:.2f} s (first run); launches {got}")
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        launches.update(got)
        check_flight(sim, label, out, stalled)
        check_autopilot(label, out)
        ref = plain_rollout(sim, vst0 if label == "a2_vehicle" else st0,
                            A2_STEPS, None if label == "a2_vehicle" else 1)
        dist = compare_runs(out, ref)
        log(f"{label} kernels vs plain after {A2_STEPS} steps (f32): "
            f"position {dist[0]:.3e} m (env {env[0]:.3g}), velocity "
            f"{dist[1]:.3e} m/s (env {env[1]:.3g}), attitude {dist[2]:.3e} "
            f"rad (env {env[2]:.3g}), EAS {dist[3]:.3e} m/s (env "
            f"{env[3]:.3g})")
        if not all(v_ <= e for v_, e in zip(dist, env)):
            raise AssertionError(f"{label}: kernel and plain runs disagree")
    # float64, kernels against plain
    sim64, st64 = a2_fleet(torch.float64)
    for label in A2_PATHS:
        if label == "a2_vehicle":
            a = st64._replace(c=None)
            step = make_cluster_step(sim64, a, split="vehicle")
            for k in range(F64_A2_STEPS):
                a = step(a, i=k)
            b = plain_rollout(sim64, st64._replace(c=None), F64_A2_STEPS)
        else:
            bufs, step_packed, unpack = make_megakernel_step(sim64, st64)
            for _ in range(F64_A2_STEPS):
                bufs = step_packed(bufs)
            a = unpack(bufs)
            b = plain_rollout(sim64, st64, F64_A2_STEPS, 1)
        torch.cuda.synchronize()
        worst = max(rel_err(va, vb) for _, va, vb in leaf_pairs(
            {"x": a.x, "s": a.s, "u": a.u}, {"x": b.x, "s": b.s, "u": b.u}))
        log(f"{label} f64 {F64_A2_STEPS} steps kernels vs plain: max rel "
            f"err {worst:.3e} (tol 1e-9)")
        if not worst <= 1e-9:
            raise AssertionError(f"{label}: f64 run disagrees")
    del sim64, st64, a, b
    # the turning climb's 60 s through the megakernel, beside its twin on
    # first-order servos (the same lanes through megakernel_fbw): the fleet
    # loses ~4.6% of its lanes to a stall on either servo from ~15 s on (a
    # 45 deg bank at EAS 45 from the perturbed starts), as the JAX
    # package's fleet does, so the flight is held to its twin's outcome and
    # to the JAX run's lane by lane
    def climb(s_, st_):
        aircraft = s_.system.aircraft
        lay_ = K.avionics_layout(aircraft.vehicle, aircraft.avionics)
        row = K.rows_of(lay_.rkfin_in, ("aero", "stall")).start + 1
        b_, step_, unpack_ = make_megakernel_step(s_, st_)
        stalled_ = torch.zeros(B, dtype=torch.bool, device=DEVICE)
        K.reset_launches()
        t0_ = time.time()
        for _ in range(A2_FLIGHT):
            b_ = step_(b_)
            stalled_.logical_or_(b_[0][row] > 0.5)
        out_ = unpack_(b_)
        torch.cuda.synchronize()
        return (out_, stalled_, time.time() - t0_,
                {k: v for k, v in K.LAUNCHES.items() if v})
    end, stalled, wall, got = climb(sim, st0)
    xsim, xst = xv1_fleet(torch.float32)
    twin, t_stalled, _, t_got = climb(xsim, xst)
    log(f"a2_megakernel: the turning climb for {A2_FLIGHT} steps (60 s) x "
        f"{B} aircraft in {wall:.2f} s; launches {got}, the twin's {t_got}")
    if got != {"megakernel_fbw_a2": A2_FLIGHT}:
        raise AssertionError(f"a2_megakernel: launch counts {got}")
    for p, v in leaves({"x": end.x, "s": end.s, "u": end.u}):
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"a2_megakernel: non-finite leaf {p}")
    if bool(end.s["terminated"].any()):
        raise AssertionError("a2_megakernel: a lane terminated")
    check_autopilot("a2_megakernel", end)
    h_of = lambda s_, o: s_.system.aircraft.vehicle.h_agl(
        o.x["vehicle"], o.u["vehicle"], o.s["vehicle"])
    e_a, e_t = float(eas(end).double().mean()), float(eas(twin).double(
    ).mean())
    h_a, h_t = (float(h_of(sim, end).double().mean()),
                float(h_of(xsim, twin).double().mean()))
    apart = int((stalled != t_stalled).sum())
    elv = end.x["vehicle"]["systems"]["act"]["elevator"]
    log(f"a2_megakernel at 60 s: {int(stalled.sum())} lanes stalled at some "
        f"step (the twin {int(t_stalled.sum())}, {apart} lanes apart), mean "
        f"EAS {e_a:.3f} m/s (the twin {e_t:.3f}), mean height above terrain "
        f"{h_a:.2f} m (the twin {h_t:.2f}); elevator position "
        f"{float(elv['p'].min()):.4f}..{float(elv['p'].max()):.4f}, rate "
        f"{float(elv['v'].min()):.4f}..{float(elv['v'].max()):.4f}")
    if not (apart <= B // 100 and abs(e_a - e_t) < 1.0
            and abs(h_a - h_t) < 10.0):
        raise AssertionError("a2_megakernel: the flight parted from its "
                             "twin on first-order servos")
    with open(JAX_CLIMB) as fh:
        jax_climb = json.load(fh)
    j_stalled = torch.zeros(B, dtype=torch.bool, device=DEVICE)
    j_stalled[jax_climb["stalled"]] = True
    j_apart = int((stalled != j_stalled).sum())
    log(f"a2_megakernel against the JAX package's f32 run of the same lanes "
        f"(tools/jax_turning_climb.json): {jax_climb['stalled_lanes']} lanes "
        f"stalled there, {j_apart} lanes apart; mean EAS "
        f"{jax_climb['eas_mean']:.4f} m/s there, {e_a:.4f} here")
    if not (jax_climb["lanes"] == B and jax_climb["steps"] == A2_FLIGHT
            and j_apart <= B // 100
            and abs(e_a - jax_climb["eas_mean"]) < A2_EAS_MATCH):
        raise AssertionError("a2_megakernel: the flight parted from the "
                             "JAX package's")
    del end, twin, xsim, xst
    # the subsystems split's instances are still to port: a named refusal
    try:
        sim.fleet_step(st0, i=0)
    except NotImplementedError as e:
        log(f"Simulation.fleet_step on the card refuses the second-order "
            f"elevator: {e}")
        if "systems_fbw_a2" not in str(e):
            raise AssertionError("the refusal does not name its instance")
    else:
        raise AssertionError("Simulation.fleet_step ran the second-order "
                             "elevator on the card")

    # timings, on the runway operands and on the fleet the paths step
    log(f"elapsed {time.time() - t_start:.1f} s (the second-order elevator: "
        f"timings)")
    rows = []
    runway = runway_args(torch.float32)
    flight = flight_operand_args(sim, st0)
    params = K.system_params(sim.system.aircraft.vehicle)
    for key, name in names.items():
        a = flight[key]
        buf, n_out, scal, ops = K.PACK[name](*a)
        rbuf, _, rscal, rops = K.PACK[name](*(
            runway[name][:7] + (None,) if key == "rk4_finish"
            else runway[name]))
        bare = lambda bs=None, b_=buf, sc=scal, o=ops, n=name: L.launch(
            n, b_, n_out, sc, block=bs, **o)
        rbare = lambda bs=None, b_=rbuf, sc=rscal, o=rops, n=name: L.launch(
            n, b_, n_out, sc, block=bs, **o)
        wrap, plain = getattr(K, key), getattr(K, key + "_plain")
        n_elems = buf.numel() + n_out * B + sum(v.numel()
                                                for v in ops.values())
        rows.append(dict(
            name=name, route="cuda", source=KERNELS[name][0],
            replaces=KERNELS[name][1], launches=launches[name],
            max_abs_err=errs[name], ms=graph_ms(bare),
            plain_ms=cuda_ms(lambda: plain(*a), reps=3, calls=2, warm=1),
            nbytes=4 * n_elems, ops=count_ops(lambda: plain(*a)),
            library_ms=None, event_ms=cuda_ms(bare),
            wrapper_ms=cuda_ms(lambda: wrap(*a)),
            block_ms={n: graph_ms(lambda: bare(n)) for n in (32, 64)},
            runway_ms=graph_ms(rbare),
            launches_per_step=4 if key == "rk4_stage" else 1))
    avionics = sim.system.aircraft.avionics
    veh = sim.system.aircraft.vehicle
    grid, gains = K.geoid_grid(veh.geoid), K.ctl_gains(avionics)
    bufs, step_packed, unpack = make_megakernel_step(sim, st0)
    rst = xv1_operand_state(B, SEED, DEVICE, torch.float32, GROUND_LANES,
                            TERMINATED_LANES, (CRASH_LANE,), i0=126, a2=a2)
    rbufs, _, _ = make_megakernel_step(sim, rst._replace(
        c=comp_residuals(rst.x, force=True)))

    def mega(b=bufs, lanes=None):
        return L.launch_megakernel(b[0], b[1], params, grid, sim.dt,
                                   sim.t_start, True, lanes, gains,
                                   sim.steps_per_periodic, sim.periodic_dt,
                                   a2=True)
    new = unpack(step_packed(bufs))
    n_elems = (2 * (bufs[0].numel() + bufs[1].numel()) + params.numel()
               + geoid_cells(veh.geoid,
                             new.x["vehicle"]["kinematics"]["q_ew"])
               + gain_values(avionics, eas(new),
                             new.x["vehicle"]["kinematics"]["h_e"],
                             new.s["avionics"]["lon"]["mode_prev"],
                             new.s["avionics"]["lat"]["mode_prev"]))
    plain = lambda: megakernel_step_plain(sim, st0)
    rows.append(dict(
        name="megakernel_fbw_a2", route="cuda",
        source=KERNELS["megakernel_fbw_a2"][0],
        replaces=KERNELS["megakernel_fbw_a2"][1],
        launches=launches["megakernel_fbw_a2"],
        max_abs_err=errs["megakernel_fbw_a2"], ms=graph_ms(mega),
        plain_ms=cuda_ms(plain, reps=3, calls=1, warm=1),
        nbytes=4 * n_elems,
        ops=count_ops(plain, pass_op_weights(
            avionics, st0.s["avionics"], new.s["avionics"],
            (st0.i + 1) % sim.steps_per_periodic == 0)),
        library_ms=None, event_ms=cuda_ms(mega),
        wrapper_ms=cuda_ms(lambda: step_packed(bufs)),
        block_ms={n: graph_ms(lambda: mega(lanes=n)) for n in (32, 64)},
        runway_ms=graph_ms(lambda: mega(rbufs)), launches_per_step=1))
    for r in rows:
        log(f"time {r['name']}: graph {r['ms']:.4f} ms (airborne fleet; "
            f"runway operands {r['runway_ms']:.4f} ms), events "
            f"{r['event_ms']:.4f} ms, {r['launches_per_step']} launches per "
            f"step, registers {regs.get(r['name'])} [{card}]")
    del runway, flight, new, rbufs

    # vehicle-steps/s beside the C172Xv1's paths on the same card,
    # interleaved warm windows
    xsim, xst = xv1_fleet(torch.float32)
    xv = xst._replace(c=None)
    mk = lambda s_, st_: make_megakernel_step(s_, st_)[1::-1]
    runs = {"xv1_vehicle": (make_cluster_step(xsim, xv, split="vehicle"),
                            xv),
            "a2_vehicle": (vstep, vst0),
            "xv1_megakernel": mk(xsim, xst), "a2_megakernel": mk(sim, st0)}
    windows = collections.defaultdict(list)
    for label in tuple(runs) * 3:
        step, state = runs[label]
        n = WINDOW[label.replace("a2_", "xv1_")]

        def go(k, state=state):
            for j in range(k):
                state = (step(state, i=j) if label.endswith("vehicle")
                         else step(state))
            return state
        go(2)
        torch.cuda.synchronize()
        t0 = time.time()
        go(n)
        torch.cuda.synchronize()
        windows[label].append(B * n / (time.time() - t0))
    for label, rates in windows.items():
        log(f"fleet step {label}: median {statistics.median(rates):.0f} "
            f"vehicle-steps/s over {len(rates)} windows of "
            f"{WINDOW[label.replace('a2_', 'xv1_')]} steps (runs "
            f"{[round(r) for r in rates]}, B = {B}, f32) [{card}]")
    log(f"the second-order elevator's phase: {time.time() - t_phase:.1f} s")
    return rows


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    t_start = time.time()
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.megakernel import (make_megakernel_step,
                                                     megakernel_step_plain)
    from flightjax_torch.testing import flight_operand_args

    # 1. device and toolchain
    card = card_line()
    log(f"card: {card}")
    nvcc = subprocess.run([L._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    log(f"nvcc: {nvcc.strip().splitlines()[-1]}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    t0 = time.time()
    L.library()
    log(f"build: {time.time() - t0:.1f} s -> {L.BUILD_INFO['so']}")
    with open(L.BUILD_INFO["log"]) as fh:
        for line in fh:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())
            elif line.startswith("nvcc "):
                log("  " + line.strip())
    # the machine code's sizes and its digests against the record, read by
    # cuobjdump's processes in a thread of their own beside phases 3-8 (a
    # minute of the run); held and logged before the kernels line
    from sass_torch_kernels import compare, nvcc_version
    record = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tools", "sass_torch_record.json")
    with open(record) as fh:
        rec_nvcc = json.load(fh)["nvcc"]
    sizes, sass = {}, {}

    def machine_code():
        try:
            sizes.update(code_bytes(L._nvcc(), L.BUILD_INFO["so"]))
            if rec_nvcc == nvcc_version(L._nvcc()):
                sass["cmp"] = compare(L.BUILD_INFO["so"], record, L._nvcc())
        except BaseException as e:  # raised in the main thread
            sass["error"] = e
    reader = threading.Thread(target=machine_code)
    reader.start()
    regs = registers(L.BUILD_INFO["log"])
    for name in KERNELS:
        log(f"  registers {name}: " + ", ".join(
            f"{dt} {r} (spill stores {ss} B, loads {sl} B)"
            for dt, (r, ss, sl) in sorted(regs.get(name, {}).items())))

    pool, pending = plain_references()

    # 3. per-kernel checks (f64 at 1e-12, f32 at 1e-5)
    log(f"elapsed {time.time() - t_start:.1f} s")
    errs = {}

    def check(name, dtype, tol, pairs, what="", equal_nan=False):
        worst = 0.0
        for p, a, b in pairs:
            e = rel_err(a, b, equal_nan)
            worst = max(worst, e)
            if not e <= tol:
                raise AssertionError(f"{name}{what} {dtype} {p}: {e} > {tol}")
        log(f"check {name}{what} {str(dtype)[6:]}: max rel err {worst:.3e} "
            f"(tol {tol})")
        if dtype == torch.float32:
            errs[name] = max(errs.get(name, 0.0), *(
                float((a.double() - b.double())[~b.isnan()].abs().max())
                for _, a, b in pairs))

    def check_blocks(name, dtype, tol, args, what, equal_nan=False):
        """Kernel `name` launched at 32 and 64 aircraft (threads for
        dynamics) per block on the wrapper's arguments, against plain."""
        ref = unpacked(name, getattr(K, name + "_plain")(*args))
        for lanes in (32, 64):
            buf, n_out, scal, ops = K.PACK[name](*args)
            out = L.launch(name, buf, n_out, scal, block=lanes, **ops)
            got = kernel_rows(name, out, len(ref))
            torch.cuda.synchronize()
            check(name, dtype, tol, leaf_pairs(got, ref),
                  f" ({what}, block {lanes})", equal_nan=equal_nan)

    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = kernel_inputs(dtype)
        for name in LANE_KERNELS:
            kern, plain = getattr(K, name), getattr(K, name + "_plain")
            got, ref = kern(*args[name]), plain(*args[name])
            torch.cuda.synchronize()
            check(name, dtype, tol, leaf_pairs(got, ref))
            if name == "finish_sys" and not (
                    bool(got[1]["crashed"][CRASH_LANE])
                    and not bool(args[name][4]["crashed"][CRASH_LANE])):
                raise AssertionError("finish_sys: the crash lane did not "
                                     "latch crashed")
        # the finish kernels at both block sizes, on the kernel-check
        # operands and on the airborne flight fleet
        fsim, fst = fleet(dtype)
        flight = flight_operand_args(fsim, fst)
        for name in ("finish_kin", "finish_sys"):
            check_blocks(name, dtype, tol, args[name], "kernel-check operands")
            check_blocks(name, dtype, tol, flight[name], "flight fleet")
        del fsim, fst, flight
        # kinair, dynamics and finish_kin (with and without residuals) on
        # the ISA-layer operands at both block sizes
        isa = isa_inputs(dtype)
        for name in ("kinair", "dynamics", "finish_kin"):
            check_blocks(name, dtype, tol, isa[name], "ISA layers",
                         equal_nan=True)
        check_blocks("finish_kin", dtype, tol, isa["finish_kin"][:-1]
                     + (None,), "ISA layers, uncompensated", equal_nan=True)
        for comp in (False, True):
            sim, st = mega_inputs(dtype, comp)
            bufs, step_packed, unpack = make_megakernel_step(sim, st)
            got, ref = unpack(step_packed(bufs)), megakernel_step_plain(sim,
                                                                       st)
            torch.cuda.synchronize()
            if not torch.equal(got.i, ref.i):
                raise AssertionError("megakernel: step counter")
            check("megakernel", dtype, tol, leaf_pairs(
                (got.t, got.x, got.s, got.c), (ref.t, ref.x, ref.s, ref.c)),
                f" (comp {comp})")

    # the fly-by-wire instances exactly, at 32 and 64 aircraft per block,
    # on the fly-by-wire cluster operands and the airborne C172Xv1 fleet
    for dtype in (torch.float64, torch.float32):
        fargs = fbw_inputs(dtype)
        xsim, xst = xv1_fleet(dtype)
        xflight = fbw_flight_inputs(xsim, xst)
        for name in FBW_NAMES:
            cases = [("cluster operands", fargs[name], False),
                     ("C172Xv1 fleet", xflight[name], False)]
            if name == "rk4_finish_fbw":
                cases.append(("cluster operands, compensated",
                              fargs[name][:-1] + (fargs[name][-1],), True))
                cases[0] = ("cluster operands", fargs[name][:-1] + (None,),
                            False)
            for what, a, comp in cases:
                ref = fbw_plain(name)(*a)
                got = fbw_wrapper(name)(*a)  # at the default block
                torch.cuda.synchronize()
                check(name, dtype, 0.0, leaf_pairs(got, ref),
                      f" ({what}, wrapper)")
                for lanes in (32, 64):
                    buf, n_out, scal, ops = K.PACK[name](*a)
                    out = L.launch(name, buf, n_out, scal, block=lanes, **ops)
                    got = K.unpack_out(name, out, comp)
                    torch.cuda.synchronize()
                    check(name, dtype, 0.0, leaf_pairs(got, ref),
                          f" ({what}, block {lanes})")
                if name in ("finish_sys_fbw", "rk4_finish_fbw") and \
                        what.startswith("cluster"):
                    s_in = a[4]["systems"] if name == "rk4_finish_fbw" \
                        else a[4]
                    if not (bool(got[1]["crashed"][CRASH_LANE])
                            and not bool(s_in["crashed"][CRASH_LANE])):
                        raise AssertionError(f"{name}: the crash lane did "
                                             "not latch crashed")
        del fargs, xsim, xst, xflight

    # the control laws' pass and the fly-by-wire megakernel exactly, at 32
    # and 64 aircraft per block
    from flightjax_torch.testing import ctl_laws_args
    for dtype in (torch.float64, torch.float32):
        xsim, xst = xv1_fleet(dtype)
        cases = [("mode-rich operands", ctl_laws_args(B, SEED, DEVICE, dtype,
                                                      GROUND_LANES)),
                 ("C172Xv1 fleet", ctl_flight_args(xsim, xst))]
        for what, a in cases:
            ref = K.ctl_laws_plain(*a)
            got = K.ctl_laws(*a)  # the wrapper
            torch.cuda.synchronize()
            check("ctl_laws", dtype, 0.0, leaf_pairs(got, ref),
                  f" ({what}, wrapper)")
            for lanes in (32, 64):
                buf, n_out, scal, ops = K.PACK["ctl_laws"](*a)
                out = L.launch("ctl_laws", buf, n_out, scal, block=lanes,
                               **ops)
                got = K.unpack_out("ctl_laws", out)
                torch.cuda.synchronize()
                check("ctl_laws", dtype, 0.0, leaf_pairs(got, ref),
                      f" ({what}, block {lanes})")
            modes = (sorted(set(ref[0]["lon"]["mode_prev"].tolist())),
                     sorted(set(ref[0]["lat"]["mode_prev"].tolist())))
            log(f"ctl_laws ({what}): lon modes {modes[0]}, lat modes "
                f"{modes[1]}")
            if what.startswith("mode-rich") and modes != (list(range(9)),
                                                           list(range(5))):
                raise AssertionError("ctl_laws: the operands miss a mode")
        mega_cases = [("cluster state", *xv1_mega_inputs(dtype, False)),
                      ("cluster state, compensated",
                       *xv1_mega_inputs(dtype, True)),
                      ("cluster state, pass every 2nd step",
                       *xv1_mega_inputs(dtype, True, spp=2)),
                      ("C172Xv1 fleet", xsim, xst)]
        for what, msim, mst in mega_cases:
            ref = megakernel_step_plain(msim, mst)
            for lanes in (32, 64):
                bufs, step_packed, unpack = make_megakernel_step(
                    msim, mst, block=lanes)
                got = unpack(step_packed(bufs))
                torch.cuda.synchronize()
                check("megakernel_fbw", dtype, 0.0,
                      leaf_pairs(tuple(got), tuple(ref)),
                      f" ({what}, block {lanes})")
            if what.startswith("cluster") and not (
                    bool(got.s["vehicle"]["systems"]["crashed"][CRASH_LANE])
                    and not bool(mst.s["vehicle"]["systems"]["crashed"][
                        CRASH_LANE])):
                raise AssertionError("megakernel_fbw: the crash lane did not "
                                     "latch crashed")
        del xsim, xst, cases, mega_cases

    # the C172Xv2's pass and megakernel exactly, at 32 and 64 aircraft per
    # block
    from flightjax_torch.testing import gdc_laws_args
    for dtype in (torch.float64, torch.float32):
        vsim, vst, _ = xv2_fleet(dtype)
        cases = [("mode-rich operands", gdc_laws_args(B, SEED, DEVICE, dtype,
                                                      GROUND_LANES)),
                 ("C172Xv2 fleet", gdc_flight_args(vsim, vst))]
        for what, a in cases:
            ref = K.gdc_ctl_laws_plain(*a)
            got = K.gdc_ctl_laws(*a)  # the wrapper
            torch.cuda.synchronize()
            check("gdc_ctl_laws", dtype, 0.0, leaf_pairs(got, ref),
                  f" ({what}, wrapper)")
            for lanes in (32, 64):
                buf, n_out, scal, ops = K.PACK["gdc_ctl_laws"](*a)
                out = L.launch("gdc_ctl_laws", buf, n_out, scal, block=lanes,
                               **ops)
                got = K.unpack_out("gdc_ctl_laws", out)
                torch.cuda.synchronize()
                check("gdc_ctl_laws", dtype, 0.0, leaf_pairs(got, ref),
                      f" ({what}, block {lanes})")
            g = ref[2]
            modes = sorted(set(g["mode"].tolist()))
            log(f"gdc_ctl_laws ({what}): guidance modes {modes}, lateral "
                f"guidance on {int(g['hor_gdc'].sum())}, vertical on "
                f"{int(g['vrt_gdc'].sum())} of {B} lanes; lon modes "
                f"{sorted(set(ref[0]['ctl']['lon']['mode_prev'].tolist()))},"
                f" lat modes "
                f"{sorted(set(ref[0]['ctl']['lat']['mode_prev'].tolist()))}")
            if what.startswith("mode-rich") and modes != [0, 1, 2]:
                raise AssertionError("gdc_ctl_laws: the operands miss a mode")
        mega_cases = [("cluster state", *xv2_mega_inputs(dtype, False)),
                      ("cluster state, compensated",
                       *xv2_mega_inputs(dtype, True)),
                      ("cluster state, pass every 2nd step",
                       *xv2_mega_inputs(dtype, True, spp=2)),
                      ("C172Xv2 fleet", vsim, vst)]
        for what, msim, mst in mega_cases:
            ref = megakernel_step_plain(msim, mst)
            for lanes in (32, 64):
                bufs, step_packed, unpack = make_megakernel_step(
                    msim, mst, block=lanes)
                got = unpack(step_packed(bufs))
                torch.cuda.synchronize()
                check("megakernel_gdc", dtype, 0.0,
                      leaf_pairs(tuple(got), tuple(ref)),
                      f" ({what}, block {lanes})")
            if what.startswith("cluster") and not (
                    bool(got.s["vehicle"]["systems"]["crashed"][CRASH_LANE])
                    and not bool(mst.s["vehicle"]["systems"]["crashed"][
                        CRASH_LANE])):
                raise AssertionError("megakernel_gdc: the crash lane did not "
                                     "latch crashed")
        del vsim, vst, cases, mega_cases

    # the mission's pass and megakernel exactly, at 32 and 64 aircraft per
    # block
    from flightjax_torch.testing import msn_laws_args
    for dtype in (torch.float64, torch.float32):
        nsim, nst0, _ = msn_fleet(dtype)
        cases = [("mode-rich operands", msn_laws_args(B, SEED, DEVICE, dtype,
                                                      GROUND_LANES)),
                 ("mission fleet", msn_flight_args(nsim, nst0))]
        for what, a in cases:
            ref = K.msn_ctl_laws_plain(*a)
            got = K.msn_ctl_laws(*a)  # the wrapper
            torch.cuda.synchronize()
            check("msn_ctl_laws", dtype, 0.0, leaf_pairs(got, ref),
                  f" ({what}, wrapper)")
            for lanes in (32, 64):
                buf, n_out, scal, ops = K.PACK["msn_ctl_laws"](*a)
                out = L.launch("msn_ctl_laws", buf, n_out, scal, block=lanes,
                               **ops)
                got = K.unpack_out("msn_ctl_laws", out)
                torch.cuda.synchronize()
                check("msn_ctl_laws", dtype, 0.0, leaf_pairs(got, ref),
                      f" ({what}, block {lanes})")
            moved = ref[0]["phase"] != a[3]["phase"]
            log(f"msn_ctl_laws ({what}): lanes per phase "
                f"{torch.bincount(a[3]['phase'].long()).tolist()}, "
                f"{int(moved.sum())} advance; guidance modes "
                f"{sorted(set(ref[2]['mode'].tolist()))}")
            if what.startswith("mode-rich") and not (bool(moved.any())
                                                    and bool((~moved).any())):
                raise AssertionError("msn_ctl_laws: the operands advance no "
                                     "lane or every lane")
        mega_cases = [("cluster state", *msn_mega_inputs(dtype, False)),
                      ("cluster state, compensated",
                       *msn_mega_inputs(dtype, True)),
                      ("cluster state, pass every 2nd step",
                       *msn_mega_inputs(dtype, True, spp=2)),
                      ("mission fleet", nsim, nst0)]
        for what, sim_, st_ in mega_cases:
            ref = megakernel_step_plain(sim_, st_)
            for lanes in (32, 64):
                bufs, step_packed, unpack = make_megakernel_step(
                    sim_, st_, block=lanes)
                got = unpack(step_packed(bufs))
                torch.cuda.synchronize()
                check("megakernel_msn", dtype, 0.0,
                      leaf_pairs(tuple(got), tuple(ref)),
                      f" ({what}, block {lanes})")
            if what.startswith("cluster") and not (
                    bool(got.s["vehicle"]["systems"]["crashed"][CRASH_LANE])
                    and not bool(st_.s["vehicle"]["systems"]["crashed"][
                        CRASH_LANE])):
                raise AssertionError("megakernel_msn: the crash lane did not "
                                     "latch crashed")
        del nsim, nst0, cases, mega_cases

    # 4. the paths in f32: kernels, each from counts 0, against plain
    log(f"elapsed {time.time() - t_start:.1f} s")
    sim, st0 = fleet(torch.float32)
    paths = Paths(sim, st0)
    xsim, xst0 = xv1_fleet(torch.float32)
    xpaths = Paths(xsim, xst0, "xv1_")
    vsim, vst0, vlanes = xv2_fleet(torch.float32)
    vpaths = Paths(vsim, vst0, "xv2_")
    nsim, nst0, nlanes = msn_fleet(torch.float32)
    npaths = Paths(nsim, nst0, "msn_")

    def paths_of(label):
        return ((xsim, xpaths) if label in XV1_PATHS else
                (vsim, vpaths) if label in XV2_PATHS else
                (nsim, npaths) if label in MSN_PATHS else (sim, paths))

    launches = {}
    for label, n in PATH_STEPS.items():
        psim, paths_ = paths_of(label)
        i0 = int(paths_.st[label[len(paths_.prefix):]].i[0])
        flown = {"xv2_megakernel": XV2_FLIGHT,
                 "msn_megakernel": MSN_FLIGHT}.get(label, n)
        torch.cuda.synchronize()
        K.reset_launches()
        stalled = torch.zeros(B, dtype=torch.bool, device=DEVICE)

        def watch(st):
            stalled.logical_or_(stall_of(st))

        t0 = time.time()
        if label == "xv2_megakernel":
            # the 120 s flight, and the state after the window it is held
            # to plain over
            end, out, stalled = paths_.flight(XV2_FLIGHT, n)
        elif label == "msn_megakernel":
            # the 700 s circuit; the states after the window it is held to
            # plain over and at the JAX tests' horizons
            snaps, touch = msn_flight(paths_, MSN_FLIGHT, (
                n, MSN_LANDING_CHECK, MSN_PATTERN_CHECK), nlanes)
            out, end = snaps[n], snaps[MSN_FLIGHT]
        else:
            out = end = paths_.run(label, n, None if label in MSN_PATHS
                                   else watch)
        torch.cuda.synchronize()
        dt_run = time.time() - t0
        got = dict(K.LAUNCHES)
        log(f"{label}: {flown} steps x {B} aircraft from step {i0} in "
            f"{dt_run:.2f} s (first run, stall flags read every step); "
            f"launches {got}")
        want = expected_launches(label, flown, i0)
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        for name, (_, _, path) in KERNELS.items():
            if path == label:
                launches[name] = got[name]
        if label == "xv2_megakernel":
            check_guided_flight(label, psim, end, vlanes)
        if label == "msn_megakernel":
            check_mission_gates(label, psim, nst0, snaps[MSN_LANDING_CHECK],
                                snaps[MSN_PATTERN_CHECK], nlanes)
            check_mission(label, snaps[MSN_PATTERN_CHECK])
            check_mission(label, end, terminated=True)
            report_mission(label, psim, end, touch, nlanes)
            del snaps
        elif label in MSN_PATHS:
            check_mission(label, end)
        else:
            # the 120 s guided flight is held to its median lanes' bounds;
            # its heights are reported
            check_flight(psim, label, end, stalled,
                         label != "xv2_megakernel")
        if label in XV1_PATHS:
            check_autopilot(label, end)
        if label in XV2_PATHS:
            check_guidance(label, end, vlanes)
        ref = plain_result(pending, label, "float32")
        pos, vel, att, de = compare_runs(out, ref)
        del end
        # the 10 s envelope scaled to the steps flown
        env = [e * n / STEPS for e in (ENV_POS_M, ENV_VEL, ENV_ATT_RAD,
                                       ENV_EAS)]
        log(f"{label} kernels vs plain after {n} steps (f32): position "
            f"{pos:.3e} m (env {env[0]:.3g}), velocity {vel:.3e} m/s "
            f"(env {env[1]:.3g}), attitude {att:.3e} rad (env {env[2]:.3g}), "
            f"EAS {de:.3e} m/s (env {env[3]:.3g})")
        if not all(v <= e for v, e in zip((pos, vel, att, de), env)):
            raise AssertionError(f"{label}: kernel and plain runs disagree")

    # 20 steps of the mission's paths and 10 of the others in f64, kernels
    # against plain, 1e-9
    log(f"elapsed {time.time() - t_start:.1f} s")
    sim64, st64 = fleet(torch.float64)
    paths64 = Paths(sim64, st64)
    xsim64, xst64 = xv1_fleet(torch.float64)
    xpaths64 = Paths(xsim64, xst64, "xv1_")
    vsim64, vst64, _ = xv2_fleet(torch.float64)
    vpaths64 = Paths(vsim64, vst64, "xv2_")
    nsim64, nst64, _ = msn_fleet(torch.float64)
    npaths64 = Paths(nsim64, nst64, "msn_")
    for label in ("subsystems", "vehicle", "megakernel") + XV_PATHS + \
            MSN_PATHS:
        p64 = (xpaths64 if label in XV1_PATHS else
               vpaths64 if label in XV2_PATHS else
               npaths64 if label in MSN_PATHS else paths64)
        n64 = F64_STEPS["msn" if label in MSN_PATHS else ""]
        a = p64.run(label, n64)
        b = plain_result(pending, label, "float64")
        torch.cuda.synchronize()
        worst = max(rel_err(va, vb) for _, va, vb in leaf_pairs(
            {"x": a.x, "s": a.s, "u": a.u}, {"x": b.x, "s": b.s, "u": b.u}))
        log(f"{label} f64 {n64} steps kernels vs plain: max rel err "
            f"{worst:.3e} (tol 1e-9)")
        if not worst <= 1e-9:
            raise AssertionError(f"{label}: f64 run disagrees")
    del sim64, st64, paths64, xsim64, xst64, xpaths64, vsim64, vst64
    del vpaths64, nsim64, nst64, npaths64
    pool.join()  # every reference taken: the workers leave the card

    # host and device ms per step, launches per step and idle share of the
    # C172X paths
    from profile_torch_step import profile
    profiles = {}
    for label in XV_PATHS + MSN_PATHS:
        psim, pst = ((xsim, xst0) if label in XV1_PATHS else
                     (nsim, nst0) if label in MSN_PATHS else (vsim, vst0))
        r = profile(label, psim, pst, 20, 8)
        profiles[label] = r
        log(f"profile {label}: B = {B}, 20 steps, f32: host "
            f"{r['host_ms_per_step']:.4f} ms/step, device "
            f"{r['device_ms_per_step']:.4f} ms/step, idle share "
            f"{r['idle_share']:.4f}, {r['launches_per_step']:.1f} device "
            f"launches/step [{card}]")
        for t in r["top"]:
            log(f"  {t['ms_per_step']:9.4f} ms/step {t['per_step']:6.1f}"
                f"/step  {t['name'][:90]}")

    # 5. timings and bounds (f32, B = 4096)
    log(f"elapsed {time.time() - t_start:.1f} s")
    args = kernel_inputs(torch.float32)
    vehicle = sim.system.aircraft.vehicle
    params, grid = K.system_params(vehicle), K.geoid_grid(vehicle.geoid)
    flight = flight_operands(sim, st0)

    def role_times(name, air, runway, batch, n_params):
        """A role kernel's graph times: on the airborne flight fleet (at 32
        and 64 aircraft per block) and on the kernel-check operands with
        lanes on the runway, and an empty kernel launched the same way."""
        shape = L.role_launch_shape(name, batch, L.LANES, n_params, 4)
        lanes = {n: graph_ms(lambda: air(n)) for n in (32, 64)}
        rlanes = {n: graph_ms(lambda: runway(n)) for n in (32, 64)}
        return dict(airborne_ms=lanes[L.LANES], runway_ms=rlanes[L.LANES],
                    lanes_ms=lanes, runway_lanes_ms=rlanes,
                    empty_ms=graph_ms(lambda: L.launch_empty(*shape)),
                    empty_event_ms=cuda_ms(lambda: L.launch_empty(*shape)),
                    launch_shape=shape)

    rows = []
    for name in LANE_KERNELS:
        src, replaces, _ = KERNELS[name]
        buf, n_out, scal, ops = K.PACK[name](*args[name])
        bare = lambda bs=None: L.launch(name, buf, n_out, scal, block=bs,
                                        **ops)
        ms, event_ms = graph_ms(bare), cuda_ms(bare)
        kern, plain = getattr(K, name), getattr(K, name + "_plain")
        wrapper_ms = cuda_ms(lambda: kern(*args[name]))
        plain_ms = cuda_ms(lambda: plain(*args[name]), reps=3, calls=2, warm=1)
        extra = {}
        if name in L.ROLE_KERNELS:
            fbuf, _, fscal, fops = flight[name]
            air = lambda bs=None: L.launch(name, fbuf, n_out, fscal,
                                           block=bs, **fops)
            extra = role_times(name, air, bare, B, params.numel())
            blocks = extra["runway_lanes_ms"]
        else:
            blocks = {bs: graph_ms(lambda: bare(bs)) for bs in (32, 64, 128)}
        n_elems = buf.numel() + n_out * buf.shape[1] + sum(
            v.numel() for k, v in ops.items() if k != "grid")
        if name == "geoid":
            n_elems += geoid_cells(args["geoid"][0], args["geoid"][1])
        n_ops = count_ops(lambda: plain(*args[name]))
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         nbytes=4 * n_elems, ops=n_ops, library_ms=None,
                         event_ms=event_ms, wrapper_ms=wrapper_ms,
                         block_ms=blocks, **extra))

    # the megakernel: on the airborne flight fleet (the main path's data,
    # `ms`) and on the kernel-check fleet with lanes on the runway
    msim, mst = mega_inputs(torch.float32, True)
    rbufs, _, _ = make_megakernel_step(msim, mst)
    bufs, step_packed, unpack = paths.bufs, paths.step_packed, paths.unpack

    def mega(b, lanes=None):
        return L.launch_megakernel(b[0], b[1], params, grid, sim.dt,
                                   sim.t_start, True, lanes)

    extra = role_times("megakernel", lambda n=None: mega(bufs, n),
                       lambda n=None: mega(rbufs, n), B, params.numel())
    by_batch = {}
    for mult in (4, 16):  # the same fleets, tiled to B = 16384 and 65536
        big, rbig = (tuple(t.repeat(1, mult) for t in b)
                     for b in (bufs, rbufs))
        by_batch[B * mult] = dict(
            airborne_ms=graph_ms(lambda: mega(big)),
            runway_ms=graph_ms(lambda: mega(rbig)),
            airborne_64_ms=graph_ms(lambda: mega(big, 64)),
            empty_ms=graph_ms(lambda: L.launch_empty(*L.role_launch_shape(
                "megakernel", B * mult, L.LANES, params.numel(), 4))))
        del big, rbig
    wrapper_ms = cuda_ms(lambda: step_packed(bufs))
    plain_ms = cuda_ms(lambda: megakernel_step_plain(sim, st0), reps=3,
                       calls=1, warm=1)
    q_new = unpack(step_packed(bufs)).x["vehicle"]["kinematics"]["q_ew"]
    n_elems = 2 * (bufs[0].numel() + bufs[1].numel()) + params.numel() \
        + geoid_cells(vehicle.geoid, q_new)
    rows.append(dict(name="megakernel", route="cuda",
                     source=KERNELS["megakernel"][0],
                     replaces=KERNELS["megakernel"][1],
                     launches=launches["megakernel"],
                     max_abs_err=errs["megakernel"], ms=extra["airborne_ms"],
                     plain_ms=plain_ms, nbytes=4 * n_elems,
                     ops=count_ops(lambda: megakernel_step_plain(sim, st0)),
                     library_ms=None,
                     event_ms=cuda_ms(lambda: mega(bufs)),
                     wrapper_ms=wrapper_ms, block_ms=extra["lanes_ms"],
                     by_batch_ms=by_batch, **extra))

    # the fly-by-wire instances: on their cluster operands (rk4_finish_fbw
    # uncompensated, as the vehicle path runs it) and, airborne, on the
    # C172Xv1 fleet the paths step
    fargs = fbw_inputs(torch.float32)
    xflight = {n: K.PACK[n](*a)
               for n, a in fbw_flight_inputs(xsim, xst0).items()}
    xparams = K.system_params(xsim.system.aircraft.vehicle)
    for name in FBW_NAMES:
        src, replaces, _ = KERNELS[name]
        a = fargs[name]
        if name == "rk4_finish_fbw":
            a = a[:-1] + (None,)
        buf, n_out, scal, ops = K.PACK[name](*a)
        bare = lambda bs=None: L.launch(name, buf, n_out, scal, block=bs,
                                        **ops)
        ms, event_ms = graph_ms(bare), cuda_ms(bare)
        wrapper_ms = cuda_ms(lambda: fbw_wrapper(name)(*a))
        plain_ms = cuda_ms(lambda: fbw_plain(name)(*a), reps=3, calls=2,
                           warm=1)
        fbuf, _, fscal, fops = xflight[name]
        air = lambda bs=None: L.launch(name, fbuf, n_out, fscal, block=bs,
                                       **fops)
        extra = role_times(name, air, bare, B, xparams.numel())
        n_elems = buf.numel() + n_out * buf.shape[1] + sum(
            v.numel() for v in ops.values())
        rows.append(dict(name=name, route="cuda", source=src,
                         replaces=replaces, launches=launches[name],
                         max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                         nbytes=4 * n_elems,
                         ops=count_ops(lambda: fbw_plain(name)(*a)),
                         library_ms=None, event_ms=event_ms,
                         wrapper_ms=wrapper_ms,
                         block_ms=extra["runway_lanes_ms"], **extra))
    del fargs, xflight

    # ctl_laws: on the pass of the C172Xv1 fleet the paths step (airborne)
    # and on the mode-rich operands (lanes on the ground)
    from flightjax_torch.testing import ctl_laws_args
    xavionics = xsim.system.aircraft.avionics
    air_args = ctl_flight_args(xsim, xst0)
    ctl_packed = {"air": K.PACK["ctl_laws"](*air_args),
                  "rich": K.PACK["ctl_laws"](*ctl_laws_args(
                      B, SEED, DEVICE, torch.float32, GROUND_LANES))}

    def ctl(which, lanes=None):
        buf, n_out, scal, ops = ctl_packed[which]
        return L.launch("ctl_laws", buf, n_out, scal, block=lanes, **ops)

    extra = role_times("ctl_laws", lambda n=None: ctl("air", n),
                       lambda n=None: ctl("rich", n), B, 0)
    ref = K.ctl_laws_plain(*air_args)
    buf, n_out, _, _ = ctl_packed["air"]
    n_elems = buf.numel() + n_out * B + gain_values(
        xavionics, air_args[1]["EAS"], air_args[1]["h_e"],
        ref[0]["lon"]["mode_prev"], ref[0]["lat"]["mode_prev"])
    rows.append(dict(name="ctl_laws", route="cuda",
                     source=KERNELS["ctl_laws"][0],
                     replaces=KERNELS["ctl_laws"][1],
                     launches=launches["ctl_laws"],
                     max_abs_err=errs["ctl_laws"], ms=extra["airborne_ms"],
                     plain_ms=cuda_ms(lambda: K.ctl_laws_plain(*air_args),
                                      reps=3, calls=2, warm=1),
                     nbytes=4 * n_elems,
                     ops=count_ops(lambda: K.ctl_laws_plain(*air_args),
                                   pass_op_weights(xavionics, air_args[3],
                                                   ref[0])),
                     library_ms=None, event_ms=cuda_ms(lambda: ctl("air")),
                     wrapper_ms=cuda_ms(lambda: K.ctl_laws(*air_args)),
                     block_ms=extra["lanes_ms"], **extra))
    del ctl_packed

    # megakernel_fbw: on the C172Xv1 fleet the path steps (airborne) and on
    # the C172Xv1 cluster state with the mode-rich avionics (runway)
    xgrid = K.geoid_grid(xsim.system.aircraft.vehicle.geoid)
    xgains = K.ctl_gains(xavionics)
    _, rst = xv1_mega_inputs(torch.float32, True)
    rbufs, _, _ = make_megakernel_step(xsim, rst)
    xbufs = xpaths.bufs

    def mega_fbw(b, lanes=None):
        return L.launch_megakernel(b[0], b[1], xparams, xgrid, xsim.dt,
                                   xsim.t_start, True, lanes, xgains,
                                   xsim.steps_per_periodic,
                                   xsim.periodic_dt)

    extra = role_times("megakernel_fbw", lambda n=None: mega_fbw(xbufs, n),
                       lambda n=None: mega_fbw(rbufs, n), B, xparams.numel())
    new = xpaths.unpack(xpaths.step_packed(xbufs))
    n_elems = (2 * (xbufs[0].numel() + xbufs[1].numel()) + xparams.numel()
               + geoid_cells(xsim.system.aircraft.vehicle.geoid,
                             new.x["vehicle"]["kinematics"]["q_ew"])
               + gain_values(xavionics, eas(new),
                             new.x["vehicle"]["kinematics"]["h_e"],
                             new.s["avionics"]["lon"]["mode_prev"],
                             new.s["avionics"]["lat"]["mode_prev"]))
    rows.append(dict(
        name="megakernel_fbw", route="cuda",
        source=KERNELS["megakernel_fbw"][0],
        replaces=KERNELS["megakernel_fbw"][1],
        launches=launches["megakernel_fbw"],
        max_abs_err=errs["megakernel_fbw"], ms=extra["airborne_ms"],
        plain_ms=cuda_ms(lambda: megakernel_step_plain(xsim, xst0), reps=3,
                         calls=1, warm=1),
        nbytes=4 * n_elems,
        ops=count_ops(lambda: megakernel_step_plain(xsim, xst0),
                      pass_op_weights(xavionics, xst0.s["avionics"],
                                      new.s["avionics"],
                                      (xst0.i + 1) % xsim.steps_per_periodic
                                      == 0)),
        library_ms=None, event_ms=cuda_ms(lambda: mega_fbw(xbufs)),
        wrapper_ms=cuda_ms(lambda: xpaths.step_packed(xbufs)),
        block_ms=extra["lanes_ms"], **extra))
    del rbufs, rst, new

    # gdc_ctl_laws: on the pass of the C172Xv2 fleet the paths step
    # (airborne) and on the mode-rich operands (lanes on the ground)
    vavionics = vsim.system.aircraft.avionics
    air_args = gdc_flight_args(vsim, vst0)
    gdc_packed = {"air": K.PACK["gdc_ctl_laws"](*air_args),
                  "rich": K.PACK["gdc_ctl_laws"](*gdc_laws_args(
                      B, SEED, DEVICE, torch.float32, GROUND_LANES))}

    def gdc(which, lanes=None):
        buf, n_out, scal, ops = gdc_packed[which]
        return L.launch("gdc_ctl_laws", buf, n_out, scal, block=lanes, **ops)

    extra = role_times("gdc_ctl_laws", lambda n=None: gdc("air", n),
                       lambda n=None: gdc("rich", n), B, 0)
    ref = K.gdc_ctl_laws_plain(*air_args)
    buf, n_out, _, _ = gdc_packed["air"]
    n_elems = buf.numel() + n_out * B + gain_values(
        vavionics, air_args[1]["EAS"], air_args[1]["h_e"],
        ref[0]["ctl"]["lon"]["mode_prev"], ref[0]["ctl"]["lat"]["mode_prev"])
    rows.append(dict(name="gdc_ctl_laws", route="cuda",
                     source=KERNELS["gdc_ctl_laws"][0],
                     replaces=KERNELS["gdc_ctl_laws"][1],
                     launches=launches["gdc_ctl_laws"],
                     max_abs_err=errs["gdc_ctl_laws"],
                     ms=extra["airborne_ms"],
                     plain_ms=cuda_ms(lambda: K.gdc_ctl_laws_plain(
                         *air_args), reps=3, calls=2, warm=1),
                     nbytes=4 * n_elems,
                     ops=count_ops(lambda: K.gdc_ctl_laws_plain(*air_args),
                                   pass_op_weights(
                                       vavionics, air_args[3], ref[0],
                                       gdc_lanes=gdc_branches(
                                           None, ref[2]["mode"]))),
                     library_ms=None, event_ms=cuda_ms(lambda: gdc("air")),
                     wrapper_ms=cuda_ms(lambda: K.gdc_ctl_laws(*air_args)),
                     block_ms=extra["lanes_ms"], **extra))
    del gdc_packed

    # megakernel_gdc: on the C172Xv2 fleet the path steps (airborne) and on
    # the C172Xv2 cluster state with the mode-rich avionics (runway)
    vparams = K.system_params(vsim.system.aircraft.vehicle)
    vgrid = K.geoid_grid(vsim.system.aircraft.vehicle.geoid)
    vgains = K.ctl_gains(vavionics)
    _, rst = xv2_mega_inputs(torch.float32, True)
    rbufs, _, _ = make_megakernel_step(vsim, rst)
    vbufs = vpaths.bufs

    def mega_gdc(b, lanes=None):
        return L.launch_megakernel(b[0], b[1], vparams, vgrid, vsim.dt,
                                   vsim.t_start, True, lanes, vgains,
                                   vsim.steps_per_periodic,
                                   vsim.periodic_dt, gdc=True)

    extra = role_times("megakernel_gdc", lambda n=None: mega_gdc(vbufs, n),
                       lambda n=None: mega_gdc(rbufs, n), B, vparams.numel())
    new = vpaths.unpack(vpaths.step_packed(vbufs))
    fires = (vst0.i + 1) % vsim.steps_per_periodic == 0
    g_mode = K.gdc_ctl_laws_plain(*gdc_flight_args(vsim, new))[2]["mode"]
    n_elems = (2 * (vbufs[0].numel() + vbufs[1].numel()) + vparams.numel()
               + geoid_cells(vsim.system.aircraft.vehicle.geoid,
                             new.x["vehicle"]["kinematics"]["q_ew"])
               + gain_values(vavionics, eas(new),
                             new.x["vehicle"]["kinematics"]["h_e"],
                             new.s["avionics"]["ctl"]["lon"]["mode_prev"],
                             new.s["avionics"]["ctl"]["lat"]["mode_prev"]))
    rows.append(dict(
        name="megakernel_gdc", route="cuda",
        source=KERNELS["megakernel_gdc"][0],
        replaces=KERNELS["megakernel_gdc"][1],
        launches=launches["megakernel_gdc"],
        max_abs_err=errs["megakernel_gdc"], ms=extra["airborne_ms"],
        plain_ms=cuda_ms(lambda: megakernel_step_plain(vsim, vst0), reps=3,
                         calls=1, warm=1),
        nbytes=4 * n_elems,
        ops=count_ops(lambda: megakernel_step_plain(vsim, vst0),
                      pass_op_weights(vavionics, vst0.s["avionics"],
                                      new.s["avionics"], fires,
                                      gdc_branches(vst0.u["avionics"]["gdc"],
                                                   g_mode))),
        library_ms=None, event_ms=cuda_ms(lambda: mega_gdc(vbufs)),
        wrapper_ms=cuda_ms(lambda: vpaths.step_packed(vbufs)),
        block_ms=extra["lanes_ms"], **extra))
    del rbufs, rst, new

    # msn_ctl_laws: on the pass of the mission fleet the paths step (half
    # on the final approach, half on the runway) and on the mode-rich
    # mission operands
    navionics = nsim.system.aircraft.avionics
    air_args = msn_flight_args(nsim, nst0)
    msn_packed = {"air": K.PACK["msn_ctl_laws"](*air_args),
                  "rich": K.PACK["msn_ctl_laws"](*msn_laws_args(
                      B, SEED, DEVICE, torch.float32, GROUND_LANES))}

    def msn(which, lanes=None):
        buf, n_out, scal, ops = msn_packed[which]
        return L.launch("msn_ctl_laws", buf, n_out, scal, block=lanes, **ops)

    extra = role_times("msn_ctl_laws", lambda n=None: msn("air", n),
                       lambda n=None: msn("rich", n), B, 0)
    ref = K.msn_ctl_laws_plain(*air_args)
    buf, n_out, _, _ = msn_packed["air"]
    n_elems = buf.numel() + n_out * B + K.mission_table(navionics).numel() \
        + gain_values(navionics, air_args[1]["EAS"], air_args[1]["h_e"],
                      ref[0]["inner"]["ctl"]["lon"]["mode_prev"],
                      ref[0]["inner"]["ctl"]["lat"]["mode_prev"])
    rows.append(dict(name="msn_ctl_laws", route="cuda",
                     source=KERNELS["msn_ctl_laws"][0],
                     replaces=KERNELS["msn_ctl_laws"][1],
                     launches=launches["msn_ctl_laws"],
                     max_abs_err=errs["msn_ctl_laws"],
                     ms=extra["airborne_ms"],
                     plain_ms=cuda_ms(lambda: K.msn_ctl_laws_plain(
                         *air_args), reps=3, calls=2, warm=1),
                     nbytes=4 * n_elems,
                     ops=count_ops(lambda: K.msn_ctl_laws_plain(*air_args),
                                   pass_op_weights(
                                       navionics, air_args[3], ref[0],
                                       gdc_lanes=gdc_branches(
                                           None, ref[2]["mode"]))),
                     library_ms=None, event_ms=cuda_ms(lambda: msn("air")),
                     wrapper_ms=cuda_ms(lambda: K.msn_ctl_laws(*air_args)),
                     block_ms=extra["lanes_ms"], **extra))
    del msn_packed

    # megakernel_msn: on the mission fleet the path steps (half on the
    # runway) and on the mission's cluster state with the mode-rich
    # avionics and every phase (runway lanes too)
    nparams = K.system_params(nsim.system.aircraft.vehicle)
    ngrid = K.geoid_grid(nsim.system.aircraft.vehicle.geoid)
    ngains = K.ctl_gains(navionics)
    rsim, rst = msn_mega_inputs(torch.float32, True)
    rbufs, _, _ = make_megakernel_step(rsim, rst)
    rgains = K.ctl_gains(rsim.system.aircraft.avionics)
    nbufs = npaths.bufs

    def mega_msn(b, lanes=None, gains=ngains):
        return L.launch_megakernel(b[0], b[1], nparams, ngrid, nsim.dt,
                                   nsim.t_start, True, lanes, gains,
                                   nsim.steps_per_periodic,
                                   nsim.periodic_dt, msn=True)

    extra = role_times("megakernel_msn", lambda n=None: mega_msn(nbufs, n),
                       lambda n=None: mega_msn(rbufs, n, rgains), B,
                       nparams.numel())
    new = npaths.unpack(npaths.step_packed(nbufs))
    fires = (nst0.i + 1) % nsim.steps_per_periodic == 0
    u_over, g_mode = msn_overrides(nsim, nst0, new)
    n_elems = (2 * (nbufs[0].numel() + nbufs[1].numel()) + nparams.numel()
               + K.mission_table(navionics).numel()
               + geoid_cells(nsim.system.aircraft.vehicle.geoid,
                             new.x["vehicle"]["kinematics"]["q_ew"])
               + gain_values(navionics, eas(new),
                             new.x["vehicle"]["kinematics"]["h_e"],
                             new.s["avionics"]["inner"]["ctl"]["lon"][
                                 "mode_prev"],
                             new.s["avionics"]["inner"]["ctl"]["lat"][
                                 "mode_prev"]))
    rows.append(dict(
        name="megakernel_msn", route="cuda",
        source=KERNELS["megakernel_msn"][0],
        replaces=KERNELS["megakernel_msn"][1],
        launches=launches["megakernel_msn"],
        max_abs_err=errs["megakernel_msn"], ms=extra["airborne_ms"],
        plain_ms=cuda_ms(lambda: megakernel_step_plain(nsim, nst0), reps=3,
                         calls=1, warm=1),
        nbytes=4 * n_elems,
        ops=count_ops(lambda: megakernel_step_plain(nsim, nst0),
                      pass_op_weights(navionics, nst0.s["avionics"],
                                      new.s["avionics"], fires,
                                      gdc_branches(u_over, g_mode))),
        library_ms=None, event_ms=cuda_ms(lambda: mega_msn(nbufs)),
        wrapper_ms=cuda_ms(lambda: npaths.step_packed(nbufs)),
        block_ms=extra["lanes_ms"], **extra))
    del rbufs, rst, rsim, new

    # the turbulent C172S: kernel checks, paths, the gust-load study, the
    # Monte Carlo flight, timings
    rows += turb_phase(card, t_start, check, errs, regs, sizes)
    # the sensor-fed navigation fleet: kernel checks, paths, the study,
    # timings
    rows += nav_phase(card, t_start, check, errs, regs, sizes)
    # the C172Xv2's last instances: the turbulent C172Xv2 and mission, the
    # sensor-fed C172Xv2 (the loiter on estimates)
    rows += xv2_last_phase(card, t_start, check, errs, regs, sizes)
    # the sensor-fed missions: the radar-gated landing and the cold-start
    # takeoff on the navigation avionics' estimates
    rows += msn_nav_phase(card, t_start, check, errs, regs, sizes)
    # the sensor-fed C172Xv2 and missions in turbulence: the turbulent
    # loiter on estimates and the two missions in gusts
    rows += nav_turb_phase(card, t_start, check, errs, regs, sizes)
    # the C172Xv1 with a second-order elevator: its whole-vehicle instances
    # and megakernel
    rows += servo2_phase(card, t_start, check, errs, regs, sizes)

    reader.join()
    if "error" in sass:
        raise sass["error"]
    log(f"  code bytes (f32 kernels): {sizes or 'not measured'}")
    if "cmp" in sass:
        same, changed, missing = sass["cmp"]
        log(f"SASS: the {len(same)} recorded kernel instances are "
            f"instruction for instruction as recorded ({', '.join(same)})")
        if changed or missing:
            raise AssertionError(f"SASS changed {changed}, missing {missing}")
    else:
        log(f"SASS: not compared, the record is of {rec_nvcc}")

    for r in rows:
        r["bound_ms"], r["bound_by"] = bound(r["nbytes"], r["ops"])
        r["code_bytes"] = sizes.get(r["name"])
        r["registers"] = {dt: v[0] for dt, v in regs.get(r["name"],
                                                         {}).items()}
        log(f"time {r['name']}: kernel {r['ms']:.4f} ms, wrapper "
            f"{r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms by {r['bound_by']} ({r['nbytes']} B, "
            f"{r['ops']} ops; {r['bound_ms'] / r['ms']:.4f} of it reached), "
            f"by events from Python {r['event_ms']:.4f} ms, by "
            + ("aircraft per block " if "lanes_ms" in r else "block size ")
            + ", ".join(f"{k}: {v:.4f}" for k, v in r["block_ms"].items())
            + f" ms [{card}]")
        if "lanes_ms" in r:
            log(f"time {r['name']} (role kernel, graph times): airborne "
                f"flight fleet {r['airborne_ms']:.4f} ms (by aircraft per "
                f"block " + ", ".join(
                    f"{k}: {v:.4f}" for k, v in r["lanes_ms"].items())
                + f"), kernel-check operands with lanes on the runway "
                f"{r['runway_ms']:.4f} ms (by aircraft per block "
                + ", ".join(
                    f"{k}: {v:.4f}" for k, v in r["runway_lanes_ms"].items())
                + f"), an empty kernel launched the same way (grid, block, "
                f"shared bytes {r['launch_shape']}) {r['empty_ms']:.4f} ms "
                f"({r['empty_event_ms']:.4f} by events) [{card}]")
        for batch, t in r.get("by_batch_ms", {}).items():
            log(f"time {r['name']} at B = {batch}: airborne "
                f"{t['airborne_ms']:.4f} ms ({t['airborne_64_ms']:.4f} at 64 "
                f"aircraft per block), on the runway {t['runway_ms']:.4f} "
                f"ms, empty {t['empty_ms']:.4f} ms; "
                f"{batch / t['airborne_ms'] / 1e3:.2f}M vehicle-steps/s of "
                f"kernel time [{card}]")

    # throughput: interleaved warm windows of WINDOW[label] steps each
    windows = collections.defaultdict(list)
    labels = ("subsystems", "vehicle", "megakernel") + XV_PATHS + MSN_PATHS
    for label in (labels + ("plain",)) * 3 + labels * 2:
        p = paths_of(label)[1] if label != "plain" else paths
        run = (lambda n: paths.run_plain("subsystems", n)) \
            if label == "plain" else (lambda n: p.run(label, n))
        run(2)
        torch.cuda.synchronize()
        t0 = time.time()
        run(WINDOW[label])
        torch.cuda.synchronize()
        windows[label].append(time.time() - t0)
    for label, ts in windows.items():
        rates = [B * WINDOW[label] / t for t in ts]
        log(f"fleet step {label}: median {statistics.median(rates):.0f}, "
            f"aggregate {B * WINDOW[label] * len(ts) / sum(ts):.0f} "
            f"vehicle-steps/s over {len(ts)} windows of {WINDOW[label]} "
            f"steps (runs {[round(r) for r in rates]}, B = {B}, f32) "
            f"[{card}]")

    log(f"total: {time.time() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "event_ms", "wrapper_ms", "block_ms", "nbytes", "ops",
            "code_bytes", "registers", "airborne_ms", "runway_ms",
            "lanes_ms", "runway_lanes_ms", "empty_ms", "by_batch_ms",
            "launches_per_step", "share")
    log("profiles: " + json.dumps(profiles))
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
