#!/usr/bin/env python3
"""Build flightjax_torch's CUDA kernels and drive its flagship fleet step on
one NVIDIA card; exit non-zero if any phase fails.

    python3 chip_smoke.py

Phases:
1. device and toolchain: the card's name and power limit, nvcc's version;
2. build: the kernels of flightjax_torch/csrc compiled for sm_90a;
3. per kernel (kinair, systems, dynamics, finish_kin, finish_sys) at
   B = 4096: the kernel against its plain PyTorch version on the same card
   tensors, float64 to 1e-12 and float32 to 1e-5 (relative to
   max(1, |plain|));
4. the slice: the trimmed C172S flagship at 4096 perturbed aircraft, 500
   steps (10 s) of `fleet_rollout` in float32 through the kernels; every
   leaf finite, no lane terminated, altitude and EAS in a physical band,
   launch counts 4*500 for the stage kernels and 500 for the finish
   kernels; the same 500 steps with the plain versions agree within the
   10 s float32 envelope of BENCHMARKS.md; 20 steps in float64, kernels
   against plain, agree to 1e-9;
5. timings: warm median time per kernel against its plain version, and
   vehicle-steps/s of the fleet step with kernels and with plain versions
   (median and aggregate over several windows, interleaved).

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors and times.
"""

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

B = 4096
STEPS = 500
SEED = 1016
DEVICE = "cuda"
# steps per throughput window (the plain path is ~100x slower)
WINDOW = {"kernels": 200, "plain": 20}

# the 10 s float32 envelope (BENCHMARKS.md:34): position, velocity,
# attitude, EAS
ENV_POS_M, ENV_VEL, ENV_ATT_RAD, ENV_EAS = 0.73, 5e-5, 7e-7, 5e-5

# kernel: (source, the TPU kernel's lane function, launches per step)
KERNELS = {
    "kinair": ("flightjax_torch/csrc/kinair.cu",
               "flightjax/parallel/clusterstep.py:250", 4),
    "systems": ("flightjax_torch/csrc/systems.cu",
                "flightjax/parallel/clusterstep.py:274", 4),
    "dynamics": ("flightjax_torch/csrc/dynamics.cu",
                 "flightjax/parallel/clusterstep.py:403", 4),
    "finish_kin": ("flightjax_torch/csrc/finish_kin.cu",
                   "flightjax/parallel/clusterstep.py:433", 1),
    "finish_sys": ("flightjax_torch/csrc/finish_sys.cu",
                   "flightjax/parallel/clusterstep.py:452", 1),
}


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def rel_err(got, ref):
    """max |got - ref| / max(1, |ref|) over all elements."""
    g, r = got.double(), ref.double()
    return float(((g - r).abs() / r.abs().clamp_min(1.0)).max())


def leaves(tree):
    from flightjax_torch.core.modeling import tree_leaves_with_path
    return tree_leaves_with_path(tree)


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


# ------------------------------------------------------------ inputs

def kernel_inputs(dtype):
    """numpy-seeded operands of the kernels at B lanes (as the CPU parity
    tests draw them, two lanes on the runway, one terminated, lanes in
    every engine state), on the card."""
    from flightjax_torch.models.c172.c172s import build_vehicle
    from flightjax_torch.parallel.kernels import operand_args
    from flightjax_torch.testing import cluster_operands
    d = cluster_operands(B, SEED, ground_lanes=(3, 77), terminated_lanes=(5,))
    return operand_args(d, build_vehicle(device=DEVICE, dtype=dtype), DEVICE,
                        dtype, adt=0.01, dt=0.02)


# ------------------------------------------------------------ phases

@contextlib.contextmanager
def plain_clusters():
    """Test-only switch for this script: route the fleet step's kernel
    clusters to their plain PyTorch versions."""
    from flightjax_torch.parallel import kernels as K
    saved = {name: getattr(K, name) for name in KERNELS}
    for name in KERNELS:
        setattr(K, name, getattr(K, name + "_plain"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(K, name, fn)


def fleet(dtype, seed=SEED):
    from flightjax_torch.testing import perturbed_fleet_sim
    return perturbed_fleet_sim(B, seed, DEVICE, dtype)


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from flightjax_torch.parallel import fleet as F
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L

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

    # 3. per-kernel checks (f64 at 1e-12, f32 at 1e-5)
    errs = {}
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        args = kernel_inputs(dtype)
        for name in KERNELS:
            kern, plain = getattr(K, name), getattr(K, name + "_plain")
            got, ref = kern(*args[name]), plain(*args[name])
            torch.cuda.synchronize()
            worst = 0.0
            for (p, a), (_, b) in zip(leaves(got), leaves(ref)):
                e = rel_err(a, b)
                worst = max(worst, e)
                if not e <= tol:
                    raise AssertionError(f"{name} {dtype} {p}: {e} > {tol}")
            log(f"check {name} {str(dtype)[6:]}: max rel err {worst:.3e} "
                f"(tol {tol})")
            if dtype == torch.float32:
                errs[name] = max(float((a.double() - b.double()).abs().max())
                                 for (_, a), (_, b) in zip(leaves(got),
                                                           leaves(ref)))

    # 4. the slice: 500 steps, kernels
    sim, st0 = fleet(torch.float32)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    out = F.fleet_rollout(sim, st0, STEPS)
    torch.cuda.synchronize()
    t_kernel_run = time.time() - t0
    launches = dict(K.LAUNCHES)
    log(f"slice: {STEPS} steps x {B} aircraft in {t_kernel_run:.2f} s "
        f"(first run, includes warm-up); launches {launches}")
    want = {name: per_step * STEPS
            for name, (_, _, per_step) in KERNELS.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    for p, v in leaves({"x": out.x, "s": out.s, "c": out.c, "t": out.t}):
        if v.dtype.is_floating_point and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite leaf {p}")
    if bool(out.s["terminated"].any()):
        raise AssertionError("a lane terminated")
    h = sim.system.aircraft.vehicle.h_agl(out.x["vehicle"], out.u["vehicle"],
                                          out.s["vehicle"])
    e = eas(out)
    log(f"slice: height above terrain {float(h.min()):.1f}.."
        f"{float(h.max()):.1f} m, EAS {float(e.min()):.2f}.."
        f"{float(e.max()):.2f} m/s, t = {float(out.t[0]):.2f} s")
    if not (800.0 < float(h.min()) and float(h.max()) < 1300.0):
        raise AssertionError("height left the 800..1300 m band")
    if not (35.0 < float(e.min()) and float(e.max()) < 70.0):
        raise AssertionError("EAS left the 35..70 m/s band")

    # plain versions on the card, same 500 steps
    with plain_clusters():
        K.reset_launches()
        ref = F.fleet_rollout(sim, st0, STEPS)
        torch.cuda.synchronize()
        if any(K.LAUNCHES.values()):
            raise AssertionError("plain run launched a kernel")
    pos, vel, att, de = compare_runs(out, ref)
    log(f"slice kernel vs plain after {STEPS} steps (f32): position "
        f"{pos:.3e} m (env {ENV_POS_M}), velocity {vel:.3e} m/s "
        f"(env {ENV_VEL}), attitude {att:.3e} rad (env {ENV_ATT_RAD}), "
        f"EAS {de:.3e} m/s (env {ENV_EAS})")
    if not (pos <= ENV_POS_M and vel <= ENV_VEL and att <= ENV_ATT_RAD
            and de <= ENV_EAS):
        raise AssertionError("kernel and plain runs disagree")

    # 20 steps in f64, kernels against plain, 1e-9
    sim64, st64 = fleet(torch.float64)
    a = F.fleet_rollout(sim64, st64, 20)
    with plain_clusters():
        b = F.fleet_rollout(sim64, st64, 20)
    torch.cuda.synchronize()
    worst = max(rel_err(va, vb) for (_, va), (_, vb) in zip(
        leaves({"x": a.x, "s": a.s}), leaves({"x": b.x, "s": b.s}))
        if va.dtype.is_floating_point)
    log(f"slice f64 20 steps kernel vs plain: max rel err {worst:.3e} "
        f"(tol 1e-9)")
    if not worst <= 1e-9:
        raise AssertionError("f64 slice disagrees")

    # 5. timings (f32, B = 4096)
    args = kernel_inputs(torch.float32)
    rows = []
    for name, (src, replaces, _) in KERNELS.items():
        buf, n_out, scal, prm = K.PACK[name](*args[name])
        ms = cuda_ms(lambda: L.launch(name, buf, n_out, scal, params=prm))
        kern, plain = getattr(K, name), getattr(K, name + "_plain")
        wrapper_ms = cuda_ms(lambda: kern(*args[name]))
        plain_ms = cuda_ms(lambda: plain(*args[name]), reps=5, calls=4)
        blocks = {bs: cuda_ms(lambda: L.launch(name, buf, n_out, scal,
                                               block=bs, params=prm))
                  for bs in (32, 64, 128, 256)}
        log(f"time {name}: kernel {ms:.4f} ms, wrapper (pack+launch+unpack) "
            f"{wrapper_ms:.4f} ms, plain {plain_ms:.4f} ms; by block size "
            + ", ".join(f"{k}: {v:.4f}" for k, v in blocks.items())
            + f" ms [{card}]")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "wrapper_ms": wrapper_ms,
                     "block_ms": blocks})

    # throughput: interleaved warm windows of WINDOW[label] steps each
    windows = {}
    for label in ("kernels", "plain") * 3 + ("kernels", "kernels"):
        ctx = plain_clusters() if label == "plain" else \
            contextlib.nullcontext()
        with ctx:
            F.fleet_rollout(sim, st0, 2)
            torch.cuda.synchronize()
            t0 = time.time()
            F.fleet_rollout(sim, st0, WINDOW[label])
            torch.cuda.synchronize()
            windows.setdefault(label, []).append(time.time() - t0)
    for label, ts in windows.items():
        rates = [B * WINDOW[label] / t for t in ts]
        log(f"fleet step {label}: median {statistics.median(rates):.0f}, "
            f"aggregate {B * WINDOW[label] * len(ts) / sum(ts):.0f} "
            f"vehicle-steps/s over {len(ts)} windows of {WINDOW[label]} "
            f"steps (runs {[round(r) for r in rates]}, B = {B}, f32) "
            f"[{card}]")

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
