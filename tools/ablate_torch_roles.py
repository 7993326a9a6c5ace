#!/usr/bin/env python3
"""Which roles of flightjax_torch's role kernels is their time made of, and
which of two layouts is faster? Time the role kernels (systems, rk4_stage,
rk4_finish, megakernel) built from patched copies of their sources, on one
CUDA card.

    python3 tools/ablate_torch_roles.py [--batch 4096]
                                        [--variants none,aero,aero+engine]

For each variant the kernel sources are copied into a directory of their own
under `flightjax_torch/_build/`, the named patches are applied to the copy,
and the copy is built and bound as the package builds its own sources. Two
kinds of patch:
- a role's body compiled out: its call (`aero_parts`, `gear_leg`, `engine`,
  `propeller`) in `subsystem_roles` of `c172_systems.cuh`, which systems,
  rk4_stage and the megakernel all run, is replaced by zeros. The results of
  such a build are wrong and are not looked at; only its time is;
- a layout the kernels could have had: `sys7` runs systems in seven warps
  per block, with no KIN warp (role DRAG shares the KinData and AirData and
  sums the wrench); `finish_whole` has rk4_finish copy the whole parameter
  buffer into shared memory and `finish_head` only its scalar head, where
  the tree reads them through the read-only cache; `finish_atm` has the
  finish share the atmosphere (Tk, p, rho, a, q) as the stage does.

Times are warm medians of 20 launches replayed from a captured CUDA graph,
float32, at 32 and 64 aircraft per block: on the perturbed airborne
flagship fleet (as `chip_smoke.py` times them) and on the kernel-check
operands with lanes on the runway. The sources of the package are not
touched. `--variants` names the patches, `+` between patches of one variant
and `none` for the kernels as they are; the default is each role alone, aero
and engine, all four, and each layout. Prints one line per variant, then the
card's name and power limit, and as the last line all of it as one JSON
object. Fails without a card, and if a patch no longer finds its text.
"""

import argparse
import json
import os
import shutil
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)

Z3 = "{T(0.0), T(0.0), T(0.0)}"
N_PARAMS = "@N_PARAMS@"  # the parameter buffer's length, filled in at run time


def finish_copies(n):
    """The patch that has rk4_finish copy the first n values of the
    parameter buffer into shared memory and read them there."""
    return [("rk4_finish.cu", "  const RoleThread t = role_thread(B);\n",
             f"  T* sP = block_shared<T>();\n  share_params(P, {n}, sP);\n"
             "  const RoleThread t = role_thread(B);\n"),
            ("rk4_finish.cu",
             "finish_roles<false>(P, (const T*)nullptr, block_shared<T>(), t,",
             f"finish_roles<false>(sP, (const T*)nullptr, sP + {n}, t,"),
            ("rk4_finish.cu", "role_launch(B, lanes, 0, (int)sizeof(T)",
             f"role_launch(B, lanes, {n}, (int)sizeof(T)")]


AERO_ZERO = f"    a = {{T(0.0), T(0.0), {Z3}, T(0.0), T(0.0), {Z3}}};\n"
# patch: [(source file, text the copy must hold once, what replaces it)]
PATCHES = {
    "aero": [
        ("c172_systems.cuh", """\
    aero_parts<AERO_LIFT_MOMENTS>(P, xi[0], xi[1], act, in.s.stall, kin, air,
                                  in.trn.elevation, a);
""", AERO_ZERO),
        ("c172_systems.cuh", """\
    aero_parts<AERO_DRAG_SIDE>(P, T(0.0), T(0.0), act, false, kin, air,
                               in.trn.elevation, a);
""", AERO_ZERO)],
    "legs": [
        ("c172_systems.cuh", """\
    gear_leg(P, leg, xi[0], xi[1], steering, braking, kin, in.trn.elevation,
             in.trn.normal, in.trn.surface, d[0], d[1], F, tau);
""", f"    d[0] = d[1] = T(0.0);\n    F = tau = {Z3};\n")],
    "engine": [
        ("c172_systems.cuh", """\
    engine(P, xi[PW_OMEGA], xi[PW_IDLE], xi[PW_EFRC], act.throttle,
           act.mixture, in.u[US_E_MIXCTL], in.s.state, air, tau_shaft,
           d[PW_IDLE], d[PW_EFRC], mdot);
""", "    tau_shaft = d[PW_IDLE] = d[PW_EFRC] = mdot = T(0.0);\n")],
    "propeller": [
        ("c172_systems.cuh",
         "    const PropOut<T> prop = propeller(P, kin, air, "
         "gr * si(SH_XOMEGA));\n",
         f"    const PropOut<T> prop = {{{Z3}, {Z3}, {Z3}, T(0.0)}};\n")],
    "sys7": [
        ("systems.cu", "  const RoleThread t = role_thread(B);\n", """\
  RoleThread t = role_thread(B);  // seven warps: roles AERO.. only
  t.L = blockDim.x / (N_ROLES - 1);
  t.lane = threadIdx.x % t.L;
  t.role = 1 + threadIdx.x / t.L;
  t.valid = blockIdx.x * t.L + t.lane < B;
  t.b = t.valid ? blockIdx.x * t.L + t.lane : B - 1;
"""),
        ("systems.cu", """\
  if (t.role == ROLE_KIN) {
    share_kin_air(Out<T>{sh, t.L, t.lane}, load_kin(c, SI_KIN),
                  load_air(c, SI_AIR));
  } else {
""", """\
  if (t.role == ROLE_DRAG)
    share_kin_air(Out<T>{sh, t.L, t.lane}, load_kin(c, SI_KIN),
                  load_air(c, SI_AIR));
  {
"""),
        ("systems.cu", "  if (t.role == ROLE_KIN) {\n    V3<T> F_b, tau_b;",
         "  if (t.role == ROLE_DRAG) {\n    V3<T> F_b, tau_b;"),
        ("systems.cu", """\
  const RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T), SH_N);
""", """\
  RoleLaunch l = role_launch(B, lanes, n_params, (int)sizeof(T), SH_N);
  l.block -= lanes;
""")],
    "finish_head": finish_copies("P_HEAD"),
    "finish_whole": finish_copies(N_PARAMS),
    "finish_atm": [
        ("c172_systems.cuh", "    share_kin_air<false>(so, kin, air);\n",
         "    share_kin_air(so, kin, air);\n")],
}
VARIANTS = ((), ("aero",), ("legs",), ("engine",), ("propeller",),
            ("aero", "engine"), ("aero", "legs", "engine", "propeller"),
            ("sys7",), ("finish_head",), ("finish_whole",), ("finish_atm",))
TIMED = ("systems", "rk4_stage", "rk4_finish", "megakernel")


def patched_sources(csrc, build_dir, patches, n_params):
    """A copy of the sources with the patches applied, for a parameter
    buffer of n_params values; returns its path."""
    dst = os.path.join(build_dir, "ablate_" + ("_".join(patches) or "none"))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    for name in patches:
        for fname, old, new in PATCHES[name]:
            path = os.path.join(dst, fname)
            with open(path) as fh:
                text = fh.read()
            if text.count(old) != 1:
                raise SystemExit(f"ablate: patch {name!r} does not find its "
                                 f"text once in {fname}:\n{old}")
            with open(path, "w") as fh:
                fh.write(text.replace(old, new.replace(N_PARAMS,
                                                       str(n_params))))
    return dst


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--variants", default=",".join(
        "+".join(v) or "none" for v in VARIANTS))
    args = ap.parse_args()
    variants = [() if v == "none" else tuple(v.split("+"))
                for v in args.variants.split(",")]
    for v in variants:
        if set(v) - set(PATCHES):
            ap.error(f"unknown patch in {v}; the patches are {list(PATCHES)}")
    if not torch.cuda.is_available():
        print("ablate_torch_roles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import perturbed_fleet_sim

    card = S.card_line()
    csrc = L.CSRC
    sim, st = perturbed_fleet_sim(args.batch, S.SEED, S.DEVICE, torch.float32)
    vehicle = sim.system.aircraft.vehicle
    params, grid = K.system_params(vehicle), K.geoid_grid(vehicle.geoid)
    # operands: the airborne flight fleet, and the kernel-check operands
    # with lanes on the runway (at B = 4096, as chip_smoke.py draws them)
    ops = {"airborne": S.flight_operands(sim, st)}
    check = S.kernel_inputs(torch.float32)
    ops["runway"] = {n: K.PACK[n](*check[n]) for n in TIMED[:3]}
    msim, mst = S.mega_inputs(torch.float32, True)
    mega = {"airborne": make_megakernel_step(sim, st)[0],
            "runway": make_megakernel_step(msim, mst)[0]}

    def launcher(name, where, lanes):
        if name == "megakernel":
            b = mega[where]
            return lambda: L.launch_megakernel(b[0], b[1], params, grid,
                                               sim.dt, sim.t_start, True,
                                               lanes)
        buf, n_out, scal, kops = ops[where][name]
        return lambda: L.launch(name, buf, n_out, scal, block=lanes, **kops)

    results = []
    for patches in variants:
        L.CSRC = patched_sources(csrc, L.BUILD_DIR, patches, params.numel())
        L._LIB = None
        L._LAYOUTS.clear()
        row = {"patches": list(patches)}
        for name in TIMED:
            for where in ("airborne", "runway"):
                for lanes in (32, 64):
                    row[f"{name}_{where}_{lanes}_ms"] = S.graph_ms(
                        launcher(name, where, lanes))
        results.append(row)
        print("patched " + ("+".join(patches) or "nothing") + ": " + ", ".join(
            f"{k[:-3]} {v:.4f} ms" for k, v in row.items()
            if k != "patches") + f" (B = {args.batch}, f32) [{card}]",
            flush=True)
    print(card)
    print(json.dumps({"batch": args.batch, "card": card,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
