#!/usr/bin/env python3
"""Which roles of flightjax_torch's role kernels (rk4_stage, megakernel) is
their time made of? Time both kernels with the body of one or more roles
compiled out, on one CUDA card.

    python3 tools/ablate_torch_roles.py [--batch 4096]
                                        [--variants none,aero,aero+engine]

For each variant the kernel sources are copied into a directory of their own
under `flightjax_torch/_build/`, the copy of `c172_systems.cuh` is patched so
that inside `f_ode_roles` the named role's call (`aero_parts`, `gear_leg`,
`engine`, `propeller`) is replaced by zeros, and the copy is built and bound
as the package builds its own sources. The results of such a build are wrong
and are not looked at; only its time is. Times are warm medians of 20 launches
replayed from a captured CUDA graph, float32, on the perturbed airborne
flagship fleet, at 32 and 64 aircraft per block. The sources of the package
are not touched. `--variants` names the roles to take out, `+` between
roles of one variant and `none` for the kernels as they are; the default is
each role alone, aero and engine, and all four. Prints one line per variant, then the card's name and power
limit, and as the last line all of it as one JSON object. Fails without a
card, and if a patch no longer finds its text.
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
# role: [(the call inside f_ode_roles, what stands in its place)]
PATCHES = {
    "aero": [
        ("""      aero_parts<AERO_LIFT_MOMENTS>(
          P, xi[0], xi[1], act, c(r_ctx + CX_SSYS + SS_STALL).v != 0, kin,
          air, c(r_ctx + CX_TRN + TR_ELEV), a);
""", f"      a = {{T(0.0), T(0.0), {Z3}, T(0.0), T(0.0), {Z3}}};\n"),
        ("""      aero_parts<AERO_DRAG_SIDE>(P, T(0.0), T(0.0), act, false, kin, air,
                                 c(r_ctx + CX_TRN + TR_ELEV), a);
""", f"      a = {{T(0.0), T(0.0), {Z3}, T(0.0), T(0.0), {Z3}}};\n")],
    "legs": [
        ("""      gear_leg(P, leg, xi[0], xi[1], steering, braking, kin, trn.elevation,
               trn.normal, trn.surface, d[0], d[1], F, tau);
""", f"      d[0] = d[1] = T(0.0);\n      F = tau = {Z3};\n")],
    "engine": [
        ("""      engine(P, xi[PW_OMEGA], xi[PW_IDLE], xi[PW_EFRC], act.throttle,
             act.mixture, u[US_E_MIXCTL],
             int(c(r_ctx + CX_SSYS + SS_STATE).v), air, tau_shaft,
             d[PW_IDLE], d[PW_EFRC], mdot);
""", "      tau_shaft = d[PW_IDLE] = d[PW_EFRC] = mdot = T(0.0);\n")],
    "propeller": [
        ("      const PropOut<T> prop = propeller(P, kin, air, "
         "gr * si(SH_XOMEGA));\n",
         f"      const PropOut<T> prop = {{{Z3}, {Z3}, {Z3}, T(0.0)}};\n")],
}
VARIANTS = ((), ("aero",), ("legs",), ("engine",), ("propeller",),
            ("aero", "engine"), ("aero", "legs", "engine", "propeller"))


def patched_sources(csrc, build_dir, roles):
    """A copy of the sources with the roles' bodies out; returns its path."""
    dst = os.path.join(build_dir, "ablate_" + ("_".join(roles) or "none"))
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    path = os.path.join(dst, "c172_systems.cuh")
    with open(path) as fh:
        text = fh.read()
    head, body = text.split("void f_ode_roles(", 1)
    for role in roles:
        for old, new in PATCHES[role]:
            if body.count(old) != 1:
                raise SystemExit(f"ablate: the call of role {role!r} is not "
                                 f"in f_ode_roles as expected:\n{old}")
            body = body.replace(old, new)
    with open(path, "w") as fh:
        fh.write(head + "void f_ode_roles(" + body)
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
            ap.error(f"unknown role in {v}; the roles are {list(PATCHES)}")
    if not torch.cuda.is_available():
        print("ablate_torch_roles: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as S
    from flightjax_torch.core.modeling import tree_map
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.parallel import launch as L
    from flightjax_torch.parallel.megakernel import make_megakernel_step
    from flightjax_torch.testing import perturbed_fleet_sim

    card = S.card_line()
    csrc = L.CSRC
    sim, st = perturbed_fleet_sim(args.batch, S.SEED, S.DEVICE, torch.float32)
    vehicle = sim.system.aircraft.vehicle
    fx = st.x["vehicle"]
    results = []
    for roles in variants:
        L.CSRC = patched_sources(csrc, L.BUILD_DIR, roles)
        L._LIB = None
        L._LAYOUTS.clear()
        params, grid = K.system_params(vehicle), K.geoid_grid(vehicle.geoid)
        buf, n_out, _, ops = K.pack_rk4_stage(
            vehicle, fx, tree_map(torch.zeros_like, fx), st.u["vehicle"],
            st.s["vehicle"], st.s["terminated"], 0.0)
        bufs, _, _ = make_megakernel_step(sim, st)
        row = {"without": list(roles)}
        for lanes in (32, 64):
            row[f"rk4_stage_{lanes}_ms"] = S.graph_ms(lambda: L.launch(
                "rk4_stage", buf, n_out, (0.01,), block=lanes, **ops))
            row[f"megakernel_{lanes}_ms"] = S.graph_ms(
                lambda: L.launch_megakernel(bufs[0], bufs[1], params, grid,
                                            sim.dt, sim.t_start, True, lanes))
        results.append(row)
        print("without " + (", ".join(roles) or "nothing") + ": " + ", ".join(
            f"{k[:-3]} {v:.4f} ms" for k, v in row.items()
            if k != "without") + f" (B = {args.batch}, f32) [{card}]",
            flush=True)
    print(card)
    print(json.dumps({"batch": args.batch, "card": card,
                      "variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
