#!/usr/bin/env python3
"""Build flightjax_torch's CUDA kernels and drive its step paths on one
NVIDIA card: the C172S flagship's three and the C172Xv1 autopilot's two;
exit non-zero if any phase fails.

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
- `xv1_subsystems`, `xv1_vehicle`: the same two splits on the fly-by-wire
  C172Xv1 flying the turning climb with its gain-scheduled control laws
  (`LON_EAS_CLM` at EAS 45 m/s and 1.5 m/s climb, `LAT_CHI_BETA` onto
  course pi / 2), through the fly-by-wire instances of the systems kernels
  (`systems_fbw`, `finish_sys_fbw`; `rk4_stage_fbw`, `rk4_finish_fbw`) and
  the periodic pass after every step (dt = periodic_dt = 0.02 s): the
  control laws as PyTorch ops on what the finish kernels store.

Phases:
1. device and toolchain: the card's name and power limit, nvcc's version;
2. build: the kernels of flightjax_torch/csrc compiled for sm_90a;
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
   operands' fleet, with and without residuals;
4. the paths: the trimmed C172S flagship and the trimmed C172Xv1 on the
   turning climb, each at 4096 perturbed aircraft in float32, each path
   from its launch counts set to 0 to their reading just after:
   `subsystems` and `xv1_subsystems` 100 steps (from step 28, so the
   refresh at step 128 is among them), `xv1_vehicle` 500 steps (10 s),
   `vehicle` and `megakernel` 200 steps (cut from 500 for time: the plain
   references take most of the run). Every leaf finite, no lane terminated,
   no lane's stall flag set at any step, altitude and EAS in a physical
   band (on the C172Xv1 above the stall speed in its 45 deg bank), launch
   counts as the path prescribes; on the C172Xv1 also the servo commands
   within their ranges and every lane's modes `LON_EAS_CLM` /
   `LAT_CHI_BETA`; the same steps through the plain versions agree within
   the 10 s float32 envelope of BENCHMARKS.md scaled to the steps flown
   (n / 500 of it); 20 steps of each path in float64 agree with plain to
   1e-9; host and device ms per step, launches per step and the device's
   idle share of the two C172Xv1 paths under torch.profiler
   (`tools/profile_torch_step.py`);
5. timings: per kernel the warm median of the bare launch, of the wrapper
   and of the plain version, and the bound (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s, the larger). A kernel's time (`ms`) is taken
   inside a captured CUDA graph of 20 launches, so it is the card's time
   and not the host's launch rate; the time by CUDA events around 20
   launches from Python stands beside it (`event_ms`). The role kernels
   (several threads per aircraft: kinair, finish_kin, systems, finish_sys, rk4_stage,
   rk4_finish, megakernel) also by aircraft per block (32, 64), on the
   airborne flight fleet (`airborne_ms`) and on the kernel-check operands
   with lanes on the runway (`runway_ms`), beside an empty kernel launched
   the same way,
   and the megakernel at B = 16384 and 65536 too. Every number of a
   kernel's row but those two is taken on one set of operands: the
   flight fleet (the state its path steps) for the megakernel, the
   kernel-check operands for the others (the C172Xv1 fleet for the
   fly-by-wire instances' airborne times). Then vehicle-steps/s of the
   five paths and the plain one, interleaved windows, median and
   aggregate.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors, times and bounds.
"""

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

B = 4096
STEPS = 500
SUB_STEPS, SUB_I0 = 100, 28
# the C172S paths but subsystems, cut for time (the plain references take
# most of the run)
MECH_STEPS = 200
F64_STEPS = 20
SEED = 1016
DEVICE = "cuda"
# steps per throughput window (the plain path is ~40x slower)
WINDOW = {"subsystems": 200, "vehicle": 500, "megakernel": 500, "plain": 20,
          "xv1_subsystems": 100, "xv1_vehicle": 100}
# the H100 SXM's published peaks: HBM3 bandwidth and dense float32 rate
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12

# the 10 s float32 envelope (BENCHMARKS.md:34): position, velocity,
# attitude, EAS
ENV_POS_M, ENV_VEL, ENV_ATT_RAD, ENV_EAS = 0.73, 5e-5, 7e-7, 5e-5

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
}
FBW_NAMES = ("systems_fbw", "finish_sys_fbw", "rk4_stage_fbw",
             "rk4_finish_fbw")
# the kernels that run on the cluster operands (the megakernel steps a
# state), C172S first
LANE_KERNELS = tuple(k for k in KERNELS
                     if k != "megakernel" and k not in FBW_NAMES)
XV1_PATHS = ("xv1_subsystems", "xv1_vehicle")
# the kernel-check operands' lanes: on the runway, terminated, and crashing
# during the step (on the runway, sinking past what the gear takes)
GROUND_LANES, TERMINATED_LANES, CRASH_LANE = (3, 77), (5,), 78


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
    found = re.findall(r"^\s*\w+\s+\w+\s+(\w+)\s.*PROGBITS.*\.text\._Z\d+"
                       r"(\w+?)_kernelI(?:Li(\d)E)?N2fj6StrictIfE", out, re.M)
    return sorted((name + ("_fbw" if act == "1" else ""), int(size, 16))
                  for size, name, act in found)


def registers(log_path):
    """{kernel: {f32/f64: (registers, spill store bytes, spill load
    bytes)}} from ptxas's report in the build log."""
    out = collections.defaultdict(dict)
    entry = mangled = props = None
    spill = (0, 0)
    with open(log_path) as fh:
        for line in fh:
            m = re.search(r"Compiling entry function '(_Z\d+(\w+?)_kernelI"
                          r"(?:Li(\d)E)?N2fj6StrictI([fd])E\w*)'", line)
            if m:
                mangled, spill = m.group(1), (0, 0)
                entry = (m.group(2) + ("_fbw" if m.group(3) == "1" else ""),
                         "f32" if m.group(4) == "f" else "f64")
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


def cuda_ms(fn, reps=7, calls=20):
    """Warm median milliseconds per call, CUDA events around `calls`
    back-to-back calls."""
    for _ in range(3):
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


def count_ops(fn):
    """Arithmetic operations of `fn` as PyTorch runs them: the elements of
    the output of every pointwise op and of the input of every reduction
    (copies, views, concatenations, gathers and fills are not counted)."""
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
            if name in reductions and isinstance(args[0], torch.Tensor):
                total["ops"] += args[0].numel()
            elif torch.Tag.pointwise in func.tags:
                o = out[0] if isinstance(out, (tuple, list)) else out
                if isinstance(o, torch.Tensor):
                    total["ops"] += o.numel()
            return out

    with Count():
        fn()
    return total["ops"]


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


# ------------------------------------------------------------ paths

def fleet(dtype, seed=SEED):
    from flightjax_torch.testing import perturbed_fleet_sim
    return perturbed_fleet_sim(B, seed, DEVICE, dtype)


def xv1_fleet(dtype, seed=SEED):
    """The C172Xv1 on the turning climb, `B` perturbed aircraft."""
    from flightjax_torch.testing import xv1_fleet_sim
    return xv1_fleet_sim(B, seed, DEVICE, dtype)


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


class Paths:
    """The kernel paths and their plain references on one fleet (the
    C172S's three, or with `prefix` "xv1_" the C172Xv1's two, which has no
    megakernel): `run(label, n)` steps a path from its start state and
    returns the final SimState."""

    def __init__(self, sim, st0, prefix=""):
        from flightjax_torch.parallel.clusterstep import make_cluster_step
        from flightjax_torch.parallel.megakernel import make_megakernel_step
        self.sim, self.prefix = sim, prefix
        self.st = {"subsystems": at_step(sim, st0, SUB_I0),
                   "vehicle": st0._replace(c=None), "megakernel": st0}
        self.vehicle = make_cluster_step(sim, self.st["vehicle"],
                                         split="vehicle")
        if not prefix:
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
    fbw = "_fbw" if label.startswith("xv1_") else ""
    label = label[len("xv1_"):] if fbw else label
    if label == "subsystems":
        want.update({"kinair": 4 * n, "systems" + fbw: 4 * n,
                     "dynamics": 4 * n, "finish_kin": n,
                     "finish_sys" + fbw: n, "geoid": geoid})
    elif label == "vehicle":
        want.update({"rk4_stage" + fbw: 4 * n, "rk4_finish" + fbw: n,
                     "geoid": geoid})
    else:
        want.update(megakernel=n)
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
    turning climb's modes, and the fleet's mean EAS within 3 m/s of the
    45 m/s it is flown to."""
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
    if not abs(mean - 45.0) < 3.0:
        raise AssertionError(f"{label}: the fleet's mean EAS is {mean}")


# the EAS band of the C172S paths, trimmed at 50 m/s and flown open loop;
# the C172Xv1 lanes that turn in a 45 deg bank while climbing at full
# throttle bleed speed, so their floor is the C172's clean stall speed
# (48 KIAS, 24.7 m/s) in that bank: 24.7 / sqrt(cos 45 deg) = 29.4 m/s
EAS_BAND = {"c172s": (35.0, 70.0), "xv1": (29.4, 70.0)}


def stall_of(state):
    return state.s["vehicle"]["systems"]["aero"]["stall"]


def check_flight(sim, label, out, stalled):
    """Every leaf finite, no lane terminated, none stalled at any step
    (`stalled`: each lane's stall flag or-ed over the run), height and EAS
    in band."""
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
    if not (800.0 < float(h.min()) and float(h.max()) < 1300.0):
        raise AssertionError(f"{label}: height left the 800..1300 m band")
    lo, hi = EAS_BAND["xv1" if label in XV1_PATHS else "c172s"]
    if not (lo < float(e.min()) and float(e.max()) < hi):
        raise AssertionError(f"{label}: EAS left the {lo}..{hi} m/s band")


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
    t0 = time.time()
    L.library()
    log(f"build: {time.time() - t0:.1f} s -> {L.BUILD_INFO['so']}")
    with open(L.BUILD_INFO["log"]) as fh:
        for line in fh:
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("  ptxas: " + line.strip())
    sizes = dict(code_bytes(L._nvcc(), L.BUILD_INFO["so"]))
    log(f"  code bytes (f32 kernels): {sizes or 'not measured'}")
    regs = registers(L.BUILD_INFO["log"])
    for name in KERNELS:
        log(f"  registers {name}: " + ", ".join(
            f"{dt} {r} (spill stores {ss} B, loads {sl} B)"
            for dt, (r, ss, sl) in sorted(regs.get(name, {}).items())))

    # 3. per-kernel checks (f64 at 1e-12, f32 at 1e-5)
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

    # 4. the paths in f32: kernels, each from counts 0, against plain
    sim, st0 = fleet(torch.float32)
    paths = Paths(sim, st0)
    xsim, xst0 = xv1_fleet(torch.float32)
    xpaths = Paths(xsim, xst0, "xv1_")
    launches = {}
    for label, n in (("subsystems", SUB_STEPS), ("vehicle", MECH_STEPS),
                     ("megakernel", MECH_STEPS),
                     ("xv1_subsystems", SUB_STEPS), ("xv1_vehicle", STEPS)):
        psim, paths_ = (xsim, xpaths) if label in XV1_PATHS else (sim, paths)
        i0 = int(paths_.st[label[len(paths_.prefix):]].i[0])
        torch.cuda.synchronize()
        K.reset_launches()
        stalled = torch.zeros(B, dtype=torch.bool, device=DEVICE)

        def watch(st):
            stalled.logical_or_(stall_of(st))

        t0 = time.time()
        out = paths_.run(label, n, watch)
        torch.cuda.synchronize()
        dt_run = time.time() - t0
        got = dict(K.LAUNCHES)
        log(f"{label}: {n} steps x {B} aircraft from step {i0} in "
            f"{dt_run:.2f} s (first run, stall flags read every step); "
            f"launches {got}")
        want = expected_launches(label, n, i0)
        if got != want:
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        for name, (_, _, path) in KERNELS.items():
            if path == label:
                launches[name] = got[name]
        check_flight(psim, label, out, stalled)
        if label in XV1_PATHS:
            check_autopilot(label, out)
        K.reset_launches()
        ref = paths_.run_plain(label, n)
        torch.cuda.synchronize()
        if any(K.LAUNCHES.values()):
            raise AssertionError(f"{label}: plain run launched a kernel")
        pos, vel, att, de = compare_runs(out, ref)
        # the 10 s envelope scaled to the steps flown
        env = [e * n / STEPS for e in (ENV_POS_M, ENV_VEL, ENV_ATT_RAD,
                                       ENV_EAS)]
        log(f"{label} kernels vs plain after {n} steps (f32): position "
            f"{pos:.3e} m (env {env[0]:.3g}), velocity {vel:.3e} m/s "
            f"(env {env[1]:.3g}), attitude {att:.3e} rad (env {env[2]:.3g}), "
            f"EAS {de:.3e} m/s (env {env[3]:.3g})")
        if not all(v <= e for v, e in zip((pos, vel, att, de), env)):
            raise AssertionError(f"{label}: kernel and plain runs disagree")

    # 20 steps of each path in f64, kernels against plain, 1e-9
    sim64, st64 = fleet(torch.float64)
    paths64 = Paths(sim64, st64)
    xsim64, xst64 = xv1_fleet(torch.float64)
    xpaths64 = Paths(xsim64, xst64, "xv1_")
    for label in ("subsystems", "vehicle", "megakernel") + XV1_PATHS:
        p64 = xpaths64 if label in XV1_PATHS else paths64
        a = p64.run(label, F64_STEPS)
        b = p64.run_plain(label, F64_STEPS)
        torch.cuda.synchronize()
        worst = max(rel_err(va, vb) for _, va, vb in leaf_pairs(
            {"x": a.x, "s": a.s, "u": a.u}, {"x": b.x, "s": b.s, "u": b.u}))
        log(f"{label} f64 {F64_STEPS} steps kernels vs plain: max rel err "
            f"{worst:.3e} (tol 1e-9)")
        if not worst <= 1e-9:
            raise AssertionError(f"{label}: f64 run disagrees")
    del sim64, st64, paths64, xsim64, xst64, xpaths64

    # host and device ms per step, launches per step and idle share of the
    # C172Xv1 paths (the control laws run as PyTorch ops between kernels)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    from profile_torch_step import profile
    profiles = {}
    for label in XV1_PATHS:
        r = profile(label, xsim, xst0, 20, 8)
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
        plain_ms = cuda_ms(lambda: plain(*args[name]), reps=5, calls=4)
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
                       calls=2)
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
        plain_ms = cuda_ms(lambda: fbw_plain(name)(*a), reps=5, calls=4)
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
    labels = ("subsystems", "vehicle", "megakernel") + XV1_PATHS
    for label in (labels + ("plain",)) * 3 + labels * 2:
        p = xpaths if label in XV1_PATHS else paths
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
            "lanes_ms", "runway_lanes_ms", "empty_ms", "by_batch_ms")
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
