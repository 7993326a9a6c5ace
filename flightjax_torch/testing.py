"""Seeded numpy inputs shared by the parity tests and `chip_smoke.py`: the
perturbed flagship fleet and the operands of the five kernel clusters. Both
packages take these arrays, so the CPU parity tests and the card's checks
see the same fleet."""

import numpy as np
import torch

from flightjax_torch.bridge import tree_from_numpy
from flightjax_torch.core.modeling import tree_map
from flightjax_torch.core.sim import SimState
from flightjax_torch.models.c172.c172s import flagship_sim, load_flagship_state


# a crash lane's wheels below the runway (m) and its added sink rate along
# the body's z axis (m/s; the flagship flies near level, so about as much
# down): the strut compresses at about CRASH_SINK, well above XI_DOT_MAX
CRASH_DEPTH, CRASH_SINK = 0.15, 20.0


def qmul_np(a, b):
    """Hamilton product of numpy quaternion arrays."""
    r1, v1, r2, v2 = a[..., 0], a[..., 1:], b[..., 0], b[..., 1:]
    re = r1 * r2 - np.sum(v1 * v2, axis=-1)
    im = r1[..., None] * v2 + r2[..., None] * v1 + np.cross(v1, v2)
    return np.concatenate([re[..., None], im], axis=-1)


def perturbed_flagship(batch, seed, i0=0, ground_lanes=(),
                       terminated_lanes=(), crash_lanes=()):
    """numpy world-level (t, i, x, u, s) of `batch` trimmed flagships, each
    perturbed from a numpy seed: attitude tilted 1-3 deg about a random
    axis, body velocity +-3 m/s, wind ~N(0, 3 m/s), h_e +-30 m. The
    `ground_lanes` are lowered until the main wheels touch the runway and
    the `terminated_lanes` are latched terminated. The `crash_lanes` have
    their wheels CRASH_DEPTH into the runway and sink at CRASH_SINK: their
    struts compress faster than the gear takes (XI_DOT_MAX, 10 m/s), so
    the step latches them crashed. The other lanes' draws do not depend on
    the lane lists."""
    rng = np.random.default_rng(seed)
    x1, u1, s1, _, _ = load_flagship_state()
    x, u, s = (tree_map(lambda l: np.broadcast_to(
        l, (batch,) + np.shape(l)).copy(), t) for t in (x1, u1, s1))
    kin, dyn = x["vehicle"]["kinematics"], x["vehicle"]["dynamics"]
    axis = rng.normal(size=(batch, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = np.deg2rad(rng.uniform(1.0, 3.0, batch)) * rng.choice([-1, 1],
                                                                batch)
    dq = np.concatenate([np.cos(ang / 2)[:, None],
                         np.sin(ang / 2)[:, None] * axis], axis=-1)
    kin["q_wb"] = qmul_np(kin["q_wb"], dq)
    dyn["v_eb_b"] = dyn["v_eb_b"] + rng.uniform(-3.0, 3.0, (batch, 3))
    u["vehicle"]["atm"]["wind"] = rng.normal(0.0, 3.0, (batch, 3))
    kin["h_e"] = kin["h_e"] + rng.uniform(-30.0, 30.0, batch)
    lanes = list(ground_lanes)
    # wheels ~1.9 m below the body origin: 1.85 m puts the mains on the
    # runway (terrain at orthometric 0, h_e - geoid_N = h_o)
    kin["h_e"][lanes] = s["vehicle"]["geoid_N"][lanes] + 1.85
    crash = list(crash_lanes)
    kin["h_e"][crash] = s["vehicle"]["geoid_N"][crash] + 1.85 - CRASH_DEPTH
    dyn["v_eb_b"][crash, 2] += CRASH_SINK
    s["terminated"][list(terminated_lanes)] = True
    return (np.full(batch, i0 * 0.02), np.full(batch, i0, np.int32), x, u,
            s)


def perturbed_fleet_sim(batch, seed, device, dtype):
    """(sim, SimState) of `batch` perturbed flagships on `device`, with the
    flagship's position compensation in sub-float64 dtypes."""
    sim, _, _ = flagship_sim(device, dtype)
    t, i, x, u, s = perturbed_flagship(batch, seed)
    st = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                  i=torch.tensor(i, device=device),
                  x=tree_from_numpy(x, device, dtype),
                  u=tree_from_numpy(u, device, dtype),
                  s=tree_from_numpy(s, device, dtype))
    return sim, sim.with_compensation(st)


def flight_operand_args(sim, st, adt=0.01):
    """Positional arguments of the kernel wrappers (as `kernels.
    operand_args` gives them; the geoid and the megakernel aside) on the
    airborne flight fleet `st` of `perturbed_fleet_sim`: the stage kernels
    at x + adt k1, k1 the fleet's derivative (dynamics on the mass
    properties and wrench the systems give there); the finish kernels with
    the k-sum 6 k1, finish_kin with the state's residuals (when it carries
    them) as `Simulation.fleet_step` runs it, finish_sys at finish_kin's new
    KinData and AirData, rk4_finish uncompensated as the vehicle path runs
    it."""
    from flightjax_torch.parallel import kernels as K
    vehicle = sim.system.aircraft.vehicle
    xv, uv, sv = st.x["vehicle"], st.u["vehicle"], st.s["vehicle"]
    term = st.s["terminated"].to(xv["kinematics"]["h_e"].dtype)
    k1 = K.rk4_stage_plain(vehicle, xv, tree_map(torch.zeros_like, xv), uv,
                           sv, term, 0.0)
    ksum = tree_map(lambda k: 6.0 * k, k1)
    args = {"kinair": (xv["kinematics"], xv["dynamics"], k1["kinematics"],
                       k1["dynamics"], sv["geoid_N"], uv["atm"], adt, term)}
    _, kin, air, xi_dyn = K.kinair_plain(*args["kinair"])
    args["systems"] = (vehicle, xv["systems"], k1["systems"], uv["systems"],
                       sv["systems"], uv["trn"], kin, air, adt, term)
    _, mp, wr, hr = K.systems_plain(*args["systems"])
    args["dynamics"] = (xi_dyn, mp, wr, hr, kin.q_eb, kin.r_eb_e, term)
    args["finish_kin"] = (xv["kinematics"], xv["dynamics"],
                          ksum["kinematics"], ksum["dynamics"], sv["geoid_N"],
                          uv["atm"], sim.dt,
                          None if st.c is None else st.c["vehicle"][
                              "kinematics"])
    _, _, kin2, air2, _ = K.finish_kin_plain(*args["finish_kin"])
    args["finish_sys"] = (vehicle, xv["systems"], ksum["systems"],
                          uv["systems"], sv["systems"], uv["trn"], kin2, air2,
                          sim.dt)
    args["rk4_stage"] = (vehicle, xv, k1, uv, sv, term, adt)
    args["rk4_finish"] = (vehicle, xv, ksum, uv, sv, st.s["terminated"],
                          sim.dt)
    return args


def cluster_operands(batch, seed, ground_lanes=(), terminated_lanes=(),
                     crash_lanes=()):
    """numpy operands of the kernels (`parallel/kernels.py`) at the
    perturbed flagship: quaternion rates from body and transport rates,
    derivative sums, mass properties, wrench and rotor momentum of a C172
    in flight, small position residuals, and system states, derivatives,
    inputs and flags spread so that lanes 0-7 take every branch of the
    engine state machine, the stall latch, the mixture control and the
    runway surfaces; and positions all over the globe for the geoid. The
    lane lists are those of `perturbed_flagship`; a crash lane's height
    rate is its sink, so that the stage and the finish find it deeper in
    the runway, and it is not terminated on entry."""
    rng = np.random.default_rng(seed + 1)
    t, _, x, u, s = perturbed_flagship(batch, seed, 0, ground_lanes,
                                       terminated_lanes, crash_lanes)
    xk, xd = x["vehicle"]["kinematics"], x["vehicle"]["dynamics"]
    qdot = lambda q, w: 0.5 * qmul_np(q, np.concatenate(
        [np.zeros((batch, 1)), w], axis=-1))
    k_kin = {"q_wb": qdot(xk["q_wb"], rng.normal(0, 0.2, (batch, 3))),
             "q_ew": qdot(xk["q_ew"], rng.normal(0, 1e-5, (batch, 3))),
             "h_e": rng.normal(0, 3.0, batch)}
    k_kin["h_e"][list(crash_lanes)] = -CRASH_SINK
    k_dyn = {"omega_eb_b": rng.normal(0, 0.1, (batch, 3)),
             "v_eb_b": rng.normal(0, 2.0, (batch, 3))}
    J = np.diag([1300.0, 1800.0, 2700.0]) + rng.normal(0, 20.0,
                                                       (batch, 3, 3))
    q = xk["q_ew"]
    n_e = -np.stack([2 * q[:, 1] * q[:, 3] + 2 * q[:, 0] * q[:, 2],
                     2 * q[:, 2] * q[:, 3] - 2 * q[:, 0] * q[:, 1],
                     1 - 2 * (q[:, 1] ** 2 + q[:, 2] ** 2)], axis=-1)

    xs = x["vehicle"]["systems"]
    xs["ldg"]["frc"] = rng.normal(0, 0.3, (batch, 3, 2))
    eng = xs["pwp"]["engine"]
    eng["idle"] = rng.normal(0, 0.1, batch)
    eng["frc"] = rng.normal(0, 0.1, batch)
    k_sys = {"aero": {"alpha_filt": rng.normal(0, 0.5, batch),
                      "beta_filt": rng.normal(0, 0.5, batch)},
             "fuel": rng.normal(0, 1e-4, batch),
             "ldg": {"frc": rng.normal(0, 0.5, (batch, 3, 2))},
             "pwp": {"engine": {"omega": rng.normal(0, 20.0, batch),
                                "idle": rng.normal(0, 0.1, batch),
                                "frc": rng.normal(0, 0.1, batch)}}}
    us, ss = u["vehicle"]["systems"], s["vehicle"]["systems"]
    ue, se = us["pwp"]["engine"], ss["pwp"]["engine"]
    # lane 0: off + start; 1: starting above idle; 2: starting below idle,
    # start held; 3: running + stop, manual mixture; 4: stalled, wet
    # runway; 5: starting below idle, start released; 7: icy runway,
    # stalled
    se["state"][[0, 1, 2, 5]] = [0, 1, 1, 1]
    ue["start"][[0, 2]] = True
    ue["stop"][3] = True
    ue["mixture_ctl"][3] = 0
    eng["omega"][[2, 5]] = 30.0
    ss["aero"]["stall"][[4, 7]] = True
    u["vehicle"]["trn"]["surface"][[4, 7]] = [1, 2]
    # position quaternions spread over the globe, for the geoid
    q_globe = np.random.default_rng(seed + 2).normal(size=(batch, 4))
    q_globe /= np.linalg.norm(q_globe, axis=-1, keepdims=True)
    return dict(
        t=t, x_kin=xk, x_dyn=xd, k_kin=k_kin, k_dyn=k_dyn, q_globe=q_globe,
        ksum_kin={k: 6.0 * v for k, v in k_kin.items()},
        ksum_dyn={k: 6.0 * v for k, v in k_dyn.items()},
        geoid_N=s["vehicle"]["geoid_N"], u_atm=u["vehicle"]["atm"],
        term=s["terminated"].astype(np.float64),
        mp={"m": 1000.0 + rng.uniform(0, 150.0, batch),
            "J": 0.5 * (J + np.swapaxes(J, -1, -2)),
            "r_OG": [0.05, 0.0, 0.55] + rng.normal(0, 0.02, (batch, 3))},
        wr={"F": rng.normal(0, 400.0, (batch, 3)) + [0.0, 0.0, -1.0e4],
            "tau": rng.normal(0, 300.0, (batch, 3))},
        hr=[75.0, 0.0, 0.0] + rng.normal(0, 5.0, (batch, 3)),
        q_eb=qmul_np(q, xk["q_wb"]),
        r_eb_e=(6.378e6 + xk["h_e"])[:, None] * n_e,
        c_kin={"q_ew": rng.normal(0, 1e-9, (batch, 4)),
               "h_e": rng.normal(0, 1e-6, batch)},
        x_sys=xs, k_sys=k_sys,
        ksum_sys=tree_map(lambda v: 6.0 * v, k_sys),
        u_sys=us, s_sys=ss, u_trn=u["vehicle"]["trn"])


# orthometric heights h_o (m) whose geopotential height h_o A / (A + h_o)
# falls in each ISA layer, and on the first layer's ceiling: 0, 5 km, the
# float h_o whose float geopotential height is exactly 11 000 m and the two
# double h_o on either side of it (no double lands on it), 15, 25, 40, 49,
# 60, 80 and 90 km
_A = 6378137.0
ISA_HEIGHTS = (0.0, 5000.0 * _A / (_A - 5000.0), 11019.00390625,
               11019.003831706463, 11019.003831706465,
               *(g * _A / (_A - g) for g in (15e3, 25e3, 40e3, 49e3, 60e3,
                                             80e3, 90e3)))
# lanes whose sea-level temperature is NaN: at 0 m and at 5 km
ISA_NAN_LANES = (len(ISA_HEIGHTS), len(ISA_HEIGHTS) + 1)


def isa_layer_operands(batch, seed):
    """`cluster_operands` with lane b at orthometric height
    ISA_HEIGHTS[b % len(ISA_HEIGHTS)], its geoid undulation and height rate
    0 (so the stage's h_o is that height exactly) and its r_eb_e there, and
    a NaN sea-level temperature on ISA_NAN_LANES: every ISA layer, the
    ceiling of the first, and NaN through the atmosphere."""
    d = cluster_operands(batch, seed)
    h = np.resize(np.array(ISA_HEIGHTS), batch)
    n_e = d["r_eb_e"] / (6.378e6 + d["x_kin"]["h_e"])[:, None]
    d["x_kin"]["h_e"] = h
    d["k_kin"]["h_e"] = np.zeros(batch)
    d["ksum_kin"]["h_e"] = np.zeros(batch)
    d["geoid_N"] = np.zeros(batch)
    d["r_eb_e"] = (6.378e6 + h)[:, None] * n_e
    d["u_atm"]["T_sl"][[b for b in ISA_NAN_LANES if b < batch]] = np.nan
    return d


def operand_state(d, device, dtype, i0=0):
    """The world SimState (uncompensated) whose vehicle state, inputs and
    discrete state are those of the operand dict `d` of `cluster_operands`:
    the whole-step kernels see the same branches as the clusters."""
    B = d["geoid_N"].shape[0]
    x = {"vehicle": {"kinematics": d["x_kin"], "dynamics": d["x_dyn"],
                     "systems": d["x_sys"]}}
    u = {"vehicle": {"systems": d["u_sys"], "atm": d["u_atm"],
                     "trn": d["u_trn"]}}
    s = {"vehicle": {"systems": d["s_sys"], "geoid_N": d["geoid_N"]},
         "terminated": d["term"] > 0.5}
    return SimState(t=torch.full((B,), i0 * 0.02, dtype=dtype, device=device),
                    i=torch.full((B,), i0, dtype=torch.int32, device=device),
                    x=tree_from_numpy(x, device, dtype),
                    u=tree_from_numpy(u, device, dtype),
                    s=tree_from_numpy(s, device, dtype))


# ------------------------------------------------------------ the C172Xv1

def fbw_cluster_operands(batch, seed, ground_lanes=(), terminated_lanes=(),
                         crash_lanes=()):
    """`cluster_operands` for the fly-by-wire C172: the same lanes, with
    servo positions, their derivatives and the eight commands drawn from a
    numpy seed, some past their channel's range (the clamps of both the
    positions and the commands are taken), and the nose-wheel steering of
    the runway lanes near full deflection."""
    from flightjax_torch.parallel.kernels import FBW_CHANNELS
    from flightjax_torch.models.c172.c172x import ACT_RANGES
    d = cluster_operands(batch, seed, ground_lanes, terminated_lanes,
                         crash_lanes)
    rng = np.random.default_rng(seed + 3)
    x_act, k_act, u_act = {}, {}, {}
    for ch in FBW_CHANNELS:
        lo, hi = ACT_RANGES[ch]
        span = hi - lo
        x_act[ch] = rng.uniform(lo - 0.1 * span, hi + 0.1 * span, batch)
        k_act[ch] = rng.normal(0.0, 2.0, batch)
        u_act[ch] = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, batch)
    x_act["rudder"][list(ground_lanes)] = 0.9
    u_act["mixture"] = rng.uniform(-0.1, 1.1, batch)
    d["x_sys"]["act"] = x_act
    d["k_sys"]["act"] = k_act
    d["ksum_sys"]["act"] = {k: 6.0 * v for k, v in k_act.items()}
    d["u_sys"]["act"] = u_act
    return d


def perturbed_xv1(batch, seed, sas_lanes=(), ground_lanes=()):
    """numpy world-level (t, i, x, u, s) of `batch` trimmed C172Xv1 with
    the avionics started from the trim (`c172x.trimmed_xv1_state`, float64)
    and engaged on the turning climb (`c172x.turning_climb`), but on the
    `sas_lanes` in `LON_SAS` / `LAT_SAS`; each lane perturbed from a numpy
    seed as `perturbed_flagship` perturbs the flagship (attitude 1-3 deg,
    body velocity +-3 m/s, wind ~N(0, 3 m/s), h_e +-30 m), the
    `ground_lanes` with their main wheels on the runway."""
    from flightjax_torch.models.c172 import c172x, c172x_ctl as CTL
    st = c172x.turning_climb(c172x.trimmed_xv1_state(0.02, torch.float64,
                                                     "cpu"))
    t, i, x, u, s = _perturbed_c172x(st, batch, seed, ground_lanes)
    sas = list(sas_lanes)
    u["avionics"]["lon"]["mode_req"][sas] = CTL.LON_SAS
    u["avionics"]["lat"]["mode_req"][sas] = CTL.LAT_SAS
    return t, i, x, u, s


def _perturbed_c172x(st, batch, seed, ground_lanes=()):
    """numpy (t, i, x, u, s) of `batch` copies of the single C172X SimState
    `st`, perturbed as `perturbed_flagship` perturbs the flagship."""
    from flightjax_torch.bridge import tree_to_numpy
    one = tree_to_numpy(st)
    t, i, x, u, s = (tree_map(lambda l: np.broadcast_to(
        l, (batch,) + np.shape(l)).copy(), tree) for tree in one[:5])
    rng = np.random.default_rng(seed)
    kin, dyn = x["vehicle"]["kinematics"], x["vehicle"]["dynamics"]
    axis = rng.normal(size=(batch, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = np.deg2rad(rng.uniform(1.0, 3.0, batch)) * rng.choice([-1, 1],
                                                                batch)
    dq = np.concatenate([np.cos(ang / 2)[:, None],
                         np.sin(ang / 2)[:, None] * axis], axis=-1)
    kin["q_wb"] = qmul_np(kin["q_wb"], dq)
    dyn["v_eb_b"] = dyn["v_eb_b"] + rng.uniform(-3.0, 3.0, (batch, 3))
    u["vehicle"]["atm"]["wind"] = rng.normal(0.0, 3.0, (batch, 3))
    kin["h_e"] = kin["h_e"] + rng.uniform(-30.0, 30.0, batch)
    lanes = list(ground_lanes)
    kin["h_e"][lanes] = s["vehicle"]["geoid_N"][lanes] + 1.85
    return t, i, x, u, s


def xv1_fleet_sim(batch, seed, device, dtype, sas_lanes=(), ground_lanes=()):
    """(sim, SimState) of `perturbed_xv1` on `device`, with the position
    compensation `c172xv1_sim` gives in sub-float64 dtypes."""
    from flightjax_torch.models.c172.c172x import c172xv1_sim
    sim, _, _ = c172xv1_sim(device, dtype)
    t, i, x, u, s = perturbed_xv1(batch, seed, sas_lanes, ground_lanes)
    st = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                  i=torch.tensor(i, device=device),
                  x=tree_from_numpy(x, device, dtype),
                  u=tree_from_numpy(u, device, dtype),
                  s=tree_from_numpy(s, device, dtype))
    return sim, sim.with_compensation(st)


# ------------------------------------------------------------ control laws

# the altitude errors the mode-rich operands put around the lanes' heights:
# on both sides of the altitude machine's 9 m and 11 m switch points
H_ERRORS = (-12.0, -10.5, -9.5, -5.0, 5.0, 9.5, 10.5, 12.0)


def ctl_operands(batch, seed, h_e):
    """numpy (u, s) of the C172X control laws on `batch` lanes at heights
    `h_e`: lane k requests lon mode min(k % 10, 8) and lat mode k % 5,
    about half of the lanes change mode in this pass (their previous mode
    drawn), the altitude machine is in either state (acquiring on the lanes
    k % 10 == 8, holding on k % 10 == 9, which request the altitude mode,
    drawn elsewhere) with the altitude reference on both sides of its
    switch points (H_ERRORS), every saturation flag is drawn from -1, 0, 1,
    the controller states from N(0, 0.1), and the references, axes and
    offsets spread past their ranges."""
    from flightjax_torch.bridge import tree_to_numpy
    from flightjax_torch.models.c172.c172x_ctl import ControlLaws
    ctl = ControlLaws(device="cpu", dtype=torch.float64)
    u = tree_to_numpy(ctl.init_u((batch,)))
    s = tree_to_numpy(ctl.init_s((batch,)))
    rng = np.random.default_rng(seed)
    lane = np.arange(batch)
    for side, n_modes in (("lon", 9), ("lat", 5)):
        req = (np.minimum(lane % 10, 8) if side == "lon"
               else lane % n_modes).astype(np.int32)
        u[side]["mode_req"] = req
        s[side]["mode_prev"] = np.where(
            rng.random(batch) < 0.5, req,
            rng.integers(0, n_modes, batch)).astype(np.int32)
        for k, v in s[side].items():
            if hasattr(v, "_fields"):
                s[side][k] = v._replace(**{
                    f: (rng.integers(-1, 2, a.shape).astype(np.int32)
                        if a.dtype.kind == "i"
                        else rng.normal(0.0, 0.1, a.shape))
                    for f, a in zip(v._fields, v)})
        s[side]["out"] = {k: rng.uniform(-1.0, 1.0, batch)
                          for k in s[side]["out"]}
    lon, lat = u["lon"], u["lat"]
    s["lon"]["h_state"] = np.where(
        lane % 10 >= 8, lane % 2, rng.integers(0, 2, batch)).astype(np.int32)
    lon["h_ref"] = np.asarray(h_e) + rng.choice(H_ERRORS, batch)
    lon["EAS_ref"] = rng.uniform(35.0, 55.0, batch)
    lon["clm_ref"] = rng.uniform(-1.0, 2.0, batch)
    lon["theta_ref"] = rng.normal(0.05, 0.05, batch)
    lon["q_ref"] = rng.normal(0.0, 0.05, batch)
    for k in ("throttle", "elevator"):
        lon[k + "_axis"] = rng.uniform(-1.2, 1.2, batch)
        lon[k + "_offset"] = rng.uniform(-0.2, 0.2, batch)
    for k in ("aileron", "rudder"):
        lat[k + "_axis"] = rng.uniform(-1.2, 1.2, batch)
        lat[k + "_offset"] = rng.uniform(-0.2, 0.2, batch)
    lat["chi_ref"] = rng.uniform(-4.0, 4.0, batch)
    lat["p_ref"] = rng.normal(0.0, 0.05, batch)
    lat["beta_ref"] = rng.normal(0.0, 0.02, batch)
    lat["phi_ref"] = rng.normal(0.0, 0.3, batch)
    s["lon"]["prev_throttle_cmd"] = rng.uniform(0.0, 1.0, batch)
    s["lon"]["prev_te_zref_ele"] = rng.uniform(-0.3, 0.3, batch)
    s["lat"]["prev_pb_zref_phi"] = rng.normal(0.0, 0.2, batch)
    return u, s


def ctl_y_operands(batch, seed, ground_lanes=()):
    """numpy CTL_Y fields (`parallel/kernels.py`) of `batch` lanes: rates,
    attitudes (the bank past the laws' +-60 deg clip), courses all round,
    EAS and heights past both ends of the gain schedules' grid, airflow
    angles, speed ratios, commands and servo positions within their ranges;
    the `ground_lanes` with a wheel on the ground."""
    from flightjax_torch.models.c172.c172x import ACT_RANGES
    from flightjax_torch.parallel.kernels import CTL_CMD
    rng = np.random.default_rng(seed)
    om = rng.normal(0.0, 0.1, (batch, 3))
    alpha, beta = rng.normal(0.05, 0.05, batch), rng.normal(0.0, 0.05, batch)
    wow = np.zeros((batch, 3), bool)
    wow[list(ground_lanes), 1] = True
    return {
        "omega_wb_b": om, "omega_eb_b": om + rng.normal(0.0, 1e-4, om.shape),
        "e_nb": np.stack([rng.uniform(-np.pi, np.pi, batch),
                          rng.normal(0.05, 0.1, batch),
                          rng.uniform(-1.4, 1.4, batch)], axis=-1),
        "v_eb_n": rng.normal(0.0, 1.0, (batch, 3)) * [30.0, 30.0, 3.0],
        "chi_gnd": rng.uniform(-np.pi, np.pi, batch),
        "EAS": rng.uniform(20.0, 60.0, batch),
        "h_e": rng.uniform(-200.0, 3300.0, batch),
        "alpha": alpha, "beta": beta,
        "alpha_filt": alpha + rng.normal(0.0, 0.01, batch),
        "beta_filt": beta + rng.normal(0.0, 0.01, batch),
        "n": rng.uniform(0.3, 1.1, batch),
        "cmd": {ch: rng.uniform(*ACT_RANGES[ch], batch) for ch in CTL_CMD},
        "pos": {ch: rng.uniform(*ACT_RANGES[ch], batch) for ch in CTL_CMD},
        "wow": wow}


def ctl_laws_args(batch, seed, device, dtype, ground_lanes=(), dt=0.02):
    """The wrapper arguments of `ctl_laws` (avionics, y, u, s, dt) on the
    mode-rich operands (`ctl_y_operands`, `ctl_operands`), on `device`."""
    from flightjax_torch.models.c172.c172x_ctl import ControlLaws
    y = ctl_y_operands(batch, seed, ground_lanes)
    u, s = ctl_operands(batch, seed + 1, y["h_e"])
    return (ControlLaws(device=device, dtype=dtype),
            *(tree_from_numpy(t, device, dtype) for t in (y, u, s)), dt)


def xv1_operand_state(batch, seed, device, dtype, ground_lanes=(),
                      terminated_lanes=(), crash_lanes=(), i0=0):
    """The C172Xv1 world SimState (uncompensated) of the fly-by-wire cluster
    operands (`fbw_cluster_operands`) with the mode-rich avionics of
    `ctl_operands` at their heights, at step counter i0."""
    d = fbw_cluster_operands(batch, seed, ground_lanes, terminated_lanes,
                             crash_lanes)
    st = operand_state(d, device, dtype, i0)
    u_av, s_av = (tree_from_numpy(t, device, dtype) for t in ctl_operands(
        batch, seed + 5, d["x_kin"]["h_e"]))
    return st._replace(u=dict(st.u, avionics=u_av),
                       s=dict(st.s, avionics=s_av))


# ------------------------------------------------------------ the C172Xv2

# the cross-track distances (m) the mode-rich guidance operands put each
# segment or circle at from its lane: exactly on the segment (its first
# endpoint at the lane), inside the cross-track gate E_THR = 1000 m, on
# both sides of it, and far off the track, where the intercept's atan
# saturates
GDC_OFFSETS = (0.0, 400.0, -995.0, 1005.0, -1005.0, 995.0, 2.0e5, -2.0e5)
CIRCLE_RADIUS = 1500.0


def _level_points(n_e, h_e, north, east):
    """(lat, lon) of the points `north`, `east` metres from each lane's
    position (n_e, h_e) along its local level frame."""
    from flightjax_torch.models.c172.c172x import offset_point
    lat = np.arctan2(n_e[:, 2], np.hypot(n_e[:, 0], n_e[:, 1]))
    lon = np.arctan2(n_e[:, 1], n_e[:, 0])
    return offset_point(lat, lon, h_e, north, east)


def gdc_operands(batch, seed, n_e, h_e):
    """numpy guidance inputs (`GuidanceLaws.init_u` of `batch` lanes) at
    the lanes' positions (n_e, h_e): lane k requests guidance mode k % 3,
    lateral and vertical guidance in each of the four combinations
    ((k // 3) % 2, (k // 6) % 2), and puts its segment and its circle at
    the cross-track distance GDC_OFFSETS[k % 8] from itself (24 lanes hold
    every pair of mode and distance): the segment along a course drawn all
    round, its slope drawn, on lanes 8-15 of every 16 its endpoints swapped
    by `reversed_segment` (which turns the sign of the cross-track error);
    the circle of radius CIRCLE_RADIUS at a bearing drawn all round,
    turning either way. At offset 0 the segment starts at the lane's own
    position: exactly on the track. The lanes of `ctl_y_operands`'
    ground_lanes are on the ground, which forces the direct mode."""
    rng = np.random.default_rng(seed)
    lane = np.arange(batch)
    e = np.array(GDC_OFFSETS)[lane % len(GDC_OFFSETS)]
    chi = rng.uniform(-np.pi, np.pi, batch)
    along = rng.uniform(-3000.0, 3000.0, batch)
    length = rng.uniform(2000.0, 40000.0, batch)
    dh = rng.uniform(-300.0, 300.0, batch)
    c, s = np.cos(chi), np.sin(chi)
    # the first endpoint `along` metres before the lane and e to its left,
    # so that the lane is e to the right of the segment (e_sb = e)
    n1, e1 = -along * c + e * s, -along * s - e * c
    lat1, lon1 = _level_points(n_e, h_e, n1, e1)
    lat2, lon2 = _level_points(n_e, h_e, n1 + length * c, e1 + length * s)
    h1 = h_e + rng.uniform(-50.0, 50.0, batch)
    nv = lambda la, lo: np.stack([np.cos(la) * np.cos(lo),
                                  np.cos(la) * np.sin(lo), np.sin(la)], -1)
    n_e1, n_e2 = nv(lat1, lon1), nv(lat2, lon2)
    on = e == 0.0
    n_e1[on], h1[on] = n_e[on], h_e[on]
    h2 = h1 + dh
    rev = (lane // len(GDC_OFFSETS)) % 2 == 1
    n_e1[rev], n_e2[rev] = n_e2[rev].copy(), n_e1[rev].copy()
    h1[rev], h2[rev] = h2[rev].copy(), h1[rev].copy()
    sigma = rng.uniform(-np.pi, np.pi, batch)
    d = CIRCLE_RADIUS + e
    lat_c, lon_c = _level_points(n_e, h_e, -d * np.cos(sigma),
                                 -d * np.sin(sigma))
    return {"mode_req": (lane % 3).astype(np.int32),
            "target": {"n_e1": n_e1, "h_e1": h1, "n_e2": n_e2, "h_e2": h2},
            "orbit": {"n_e": nv(lat_c, lon_c),
                      "h_e": h_e + rng.uniform(-50.0, 50.0, batch),
                      "radius": np.full(batch, CIRCLE_RADIUS),
                      "turn_dir": rng.choice([-1.0, 1.0], batch)},
            "hor_gdc_req": (lane // 3) % 2 == 1,
            "vrt_gdc_req": (lane // 6) % 2 == 1}


def gdc_tree(u_gdc, device, dtype):
    """The numpy guidance inputs of `gdc_operands` as the port's tree (the
    segment and the circle as their NamedTuples) on `device`."""
    from flightjax_torch.models.c172.c172x_gdc import Circle, Segment
    t = tree_from_numpy(u_gdc, device, dtype)
    return dict(t, target=Segment(**t["target"]), orbit=Circle(**t["orbit"]))


def gdc_laws_args(batch, seed, device, dtype, ground_lanes=(), dt=0.02):
    """The wrapper arguments of `gdc_ctl_laws` (avionics, y, u, s, dt): the
    mode-rich control-law operands of `ctl_laws_args` with positions drawn
    over the globe (below +-69 deg latitude) and the mode-rich guidance of
    `gdc_operands` there, on `device`."""
    from flightjax_torch.models.c172.c172x_gdc import Avionics
    y = ctl_y_operands(batch, seed, ground_lanes)
    rng = np.random.default_rng(seed + 2)
    lat, lon = rng.uniform(-1.2, 1.2, batch), rng.uniform(-np.pi, np.pi,
                                                          batch)
    y["n_e"] = np.stack([np.cos(lat) * np.cos(lon),
                         np.cos(lat) * np.sin(lon), np.sin(lat)], -1)
    u, s = ctl_operands(batch, seed + 1, y["h_e"])
    u_gdc = gdc_operands(batch, seed + 3, y["n_e"], y["h_e"])
    t = lambda tree: tree_from_numpy(tree, device, dtype)
    return (Avionics(device=device, dtype=dtype), t(y),
            {"ctl": t(u), "gdc": gdc_tree(u_gdc, device, dtype)},
            {"ctl": t(s)}, dt)


def xv2_operand_state(batch, seed, device, dtype, ground_lanes=(),
                      terminated_lanes=(), crash_lanes=(), i0=0):
    """The C172Xv2 world SimState of `xv1_operand_state` (the fly-by-wire
    cluster operands with the mode-rich control laws) with the mode-rich
    guidance of `gdc_operands` at the lanes' positions."""
    st = xv1_operand_state(batch, seed, device, dtype, ground_lanes,
                           terminated_lanes, crash_lanes, i0)
    return with_guidance(st, seed + 6, device, dtype)


def with_guidance(st, seed, device, dtype):
    """The C172Xv1 world SimState `st` (its avionics the control laws')
    as the C172Xv2's, with the mode-rich guidance of `gdc_operands` at the
    lanes' positions drawn from `seed`."""
    kin = st.x["vehicle"]["kinematics"]
    q = kin["q_ew"].double().cpu().numpy()
    n_e = -np.stack([2 * q[:, 1] * q[:, 3] + 2 * q[:, 0] * q[:, 2],
                     2 * q[:, 2] * q[:, 3] - 2 * q[:, 0] * q[:, 1],
                     1 - 2 * (q[:, 1] ** 2 + q[:, 2] ** 2)], axis=-1)
    u_gdc = gdc_operands(q.shape[0], seed, n_e,
                         kin["h_e"].double().cpu().numpy())
    return st._replace(
        u=dict(st.u, avionics={"ctl": st.u["avionics"],
                               "gdc": gdc_tree(u_gdc, device, dtype)}),
        s=dict(st.s, avionics={"ctl": st.s["avionics"]}))


# the scenario of the C172Xv2 fleet: segments due east through the trim
# point, 50 km long from 25 km west of it, shifted north by a draw in
# +-SEGMENT_SHIFT m; circles of CIRCLE_RADIUS, CIRCLE_NORTH north of it
SEGMENT_SHIFT, CIRCLE_NORTH = 400.0, 2000.0
# every XV2_IDLE_EVERY-th lane computes its guidance but does not engage it
XV2_IDLE_EVERY = 64
# the altitude the engaged lanes' own requests hold, above the segment's
# and the circle's: where a lane's vertical guidance is off (beyond the
# 1000 m cross-track gate) its control laws climb it toward this
XV2_FALLBACK_DH = 100.0


def xv2_scenario(batch, seed, idle_lanes=None):
    """numpy (t, i, x, u, s) of `batch` trimmed C172Xv2, perturbed as
    `perturbed_xv1` perturbs the C172Xv1 (from the same trim), and
    (segment lanes, circle lanes, idle lanes, the trim's h_e): the first
    half flies `GDC_SEGMENT` on a segment due east through the trim point,
    shifted north by a draw in +-SEGMENT_SHIFT m (`tests/test_c172x2.py:
    115-121`), the second half `GDC_CIRCULAR` on the circle of
    CIRCLE_RADIUS CIRCLE_NORTH north of the trim point, turning either way
    (`:150-160`); lateral and vertical guidance requested but on the
    `idle_lanes` (default every XV2_IDLE_EVERY-th lane), which hold the
    trim's altitude and course pi / 2 with the control laws alone
    (`LON_EAS_ALT`, `LAT_CHI_BETA`). The engaged lanes' own lateral
    request is the trim start's (direct), their own longitudinal one the
    altitude mode XV2_FALLBACK_DH above the guidance's altitude, which
    holds them where their vertical guidance is off, beyond the
    cross-track gate."""
    from flightjax_torch.models.c172 import c172x, c172x_ctl as CTL
    from flightjax_torch.models.c172 import c172x_gdc as GDC
    from flightjax_torch.ops.geodesy import latlon_from_nvector
    from flightjax_torch.ops.geodesy import nvector_from_qew
    st = c172x.trimmed_xv2_state(0.02, torch.float64, "cpu")
    kin = st.x["vehicle"]["kinematics"]
    lat0, lon0 = (float(v) for v in latlon_from_nvector(nvector_from_qew(
        kin["q_ew"])))
    h0 = float(kin["h_e"])
    t, i, x, u, s = _perturbed_c172x(st, batch, seed)
    rng = np.random.default_rng(seed + 7)
    lane = np.arange(batch)
    seg_lanes, crc_lanes = lane[:batch // 2], lane[batch // 2:]
    idle = (lane % XV2_IDLE_EVERY == XV2_IDLE_EVERY - 1
            if idle_lanes is None else np.isin(lane, idle_lanes))
    shift = rng.uniform(-SEGMENT_SHIFT, SEGMENT_SHIFT, batch)
    lat1, lon1 = c172x.offset_point(lat0, lon0, h0, shift, -25000.0)
    seg = GDC.segment_from_vector(lat1, lon1, np.full(batch, h0),
                                  np.pi / 2, 50000.0, dh=0.0)
    lat_c, lon_c = c172x.offset_point(lat0, lon0, h0, CIRCLE_NORTH, 0.0)
    crc = GDC.circle(np.full(batch, float(lat_c)), np.full(batch,
                                                           float(lon_c)),
                     np.full(batch, h0), np.full(batch, CIRCLE_RADIUS),
                     rng.choice([-1.0, 1.0], batch))
    g = u["avionics"]["gdc"]
    g["mode_req"] = np.where(lane < batch // 2, GDC.GDC_SEGMENT,
                             GDC.GDC_CIRCULAR).astype(np.int32)
    g["target"] = seg._replace(**{k: v.numpy()
                                  for k, v in seg._asdict().items()})
    g["orbit"] = crc._replace(**{k: v.numpy()
                                 for k, v in crc._asdict().items()})
    g["hor_gdc_req"] = ~idle
    g["vrt_gdc_req"] = ~idle
    lon, lat = u["avionics"]["ctl"]["lon"], u["avionics"]["ctl"]["lat"]
    lon["mode_req"][:] = CTL.LON_EAS_ALT
    lon["h_ref"][:] = np.where(idle, h0, h0 + XV2_FALLBACK_DH)
    lat["mode_req"][idle] = CTL.LAT_CHI_BETA
    lat["chi_ref"][idle] = np.pi / 2
    return (t, i, x, u, s), (seg_lanes, crc_lanes, lane[idle], h0)


def xv2_fleet_sim(batch, seed, device, dtype):
    """(sim, SimState, lanes) of `xv2_scenario` on `device`, with the
    position compensation `c172xv2_sim` gives in sub-float64 dtypes."""
    from flightjax_torch.models.c172.c172x import c172xv2_sim
    sim, _, _ = c172xv2_sim(device, dtype)
    (t, i, x, u, s), lanes = xv2_scenario(batch, seed)
    st = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                  i=torch.tensor(i, device=device),
                  x=tree_from_numpy(x, device, dtype),
                  u=tree_from_numpy(u, device, dtype),
                  s=tree_from_numpy(s, device, dtype))
    return sim, sim.with_compensation(st), lanes


# ------------------------------------------------------------ the missions

# the offsets of a lane from a switch point of a phase's predicate, below
# and above it: the mission clock (s), the distance to go of a captured
# leg (m) and the height over the runway's end of the final leg (m)
CLOCK_SIDES = (4.98, 5.0)
CAPTURE_SIDES = (-205.0, -195.0)
FINAL_SIDES = (6.5, 5.5)
# the legs that end the four captured phases, in their order
CAPTURED_LEGS = ("departure", "crosswind", "downwind", "base")
# a phase index past the traffic pattern's ten, which the switch clips
PAST_END = 12


def _leg_point(leg, s_2b):
    """(n_e, h_e) in float64 of the point on `leg` whose distance to go to
    its second endpoint is about -s_2b."""
    from flightjax_torch.ops import geodesy as geo
    r1 = geo.cartesian_from_geographic(leg.n_e1, leg.h_e1)
    r2 = geo.cartesian_from_geographic(leg.n_e2, leg.h_e2)
    d = (r1 - r2) / torch.linalg.norm(r1 - r2)
    n_e, h = geo.geographic_from_cartesian(r2 + d * (-s_2b))
    return n_e.numpy(), float(h)


def msn_operands(batch, seed, y, legs):
    """numpy (phase, t, eng_state, u_sys) of a traffic-pattern mission on
    `batch` lanes, editing the MSN_Y fields `y` (the CTL_Y and n-vector of
    `gdc_laws_args`) in place: lanes in each of the ten phases and, for
    each done kind, a lane on each side of its switch: the clock at
    CLOCK_SIDES of the standby's 5 s; the engine running or starting in
    the startup; weight on wheels or none in the takeoff (airborne) and
    the flare (on the ground); the position at CAPTURE_SIDES of each
    captured leg's -200 m gate; the height FINAL_SIDES over the runway's
    end in the final; the last phase, which never advances; a phase index
    past the end (PAST_END). The other lanes cycle through the phases at
    clocks, engine states and positions drawn from the seed. u_sys holds
    the flaps, brake and starter inputs the phases may override, drawn."""
    from flightjax_torch.models.c172 import missions as M
    rng = np.random.default_rng(seed)
    lane = np.arange(batch)
    phase = (lane % 10).astype(np.int32)
    t = rng.uniform(0.0, 400.0, batch)
    eng = rng.integers(0, 3, batch).astype(np.int32)
    wow = y["wow"]
    special = []
    for c in CLOCK_SIDES:
        special.append((M.STANDBY, dict(t=c)))
    for e in (1, 2):  # starting, running
        special.append((M.STARTUP, dict(eng=e)))
    for ph in (M.TAKEOFF, M.FLARE):
        for on in (False, True):
            special.append((ph, dict(wow=on)))
    for k, name in enumerate(CAPTURED_LEGS):
        for s_2b in CAPTURE_SIDES:
            special.append((M.DEPARTURE + k, dict(leg=(legs[name], s_2b))))
    h_end = float(legs["final"].h_e2)
    for dh in FINAL_SIDES:
        special.append((M.FINAL, dict(h=h_end + dh)))
    special += [(M.GROUND, {}), (PAST_END, {})]
    for j, (ph, what) in enumerate(special[:batch]):
        phase[j] = ph
        if "t" in what:
            t[j] = what["t"]
        if "eng" in what:
            eng[j] = what["eng"]
        if "wow" in what:
            wow[j] = [False, what["wow"], False]
        if "leg" in what:
            y["n_e"][j], y["h_e"][j] = _leg_point(*what["leg"])
            wow[j] = False
        if "h" in what:
            y["h_e"][j] = what["h"]
    y["eng_state"] = eng
    u_sys = {"act": {k: rng.uniform(0.0, 1.0, batch)
                     for k in ("flaps", "brake_left", "brake_right")},
             "pwp": {"engine": {"start": rng.random(batch) < 0.5}}}
    return phase, t, eng, u_sys


def msn_laws_args(batch, seed, device, dtype, ground_lanes=(), dt=0.02):
    """The wrapper arguments of `msn_ctl_laws` (avionics, y, u, s, dt,
    u_sys): the traffic pattern's phase machine over the C172Xv2's
    avionics, on the mode-rich mission operands of `msn_operands` over the
    mode-rich guidance and control-law operands of `gdc_laws_args`, on
    `device`."""
    from flightjax_torch.models.c172 import missions as M
    y = ctl_y_operands(batch, seed, ground_lanes)
    rng = np.random.default_rng(seed + 2)
    lat, lon = rng.uniform(-1.2, 1.2, batch), rng.uniform(-np.pi, np.pi,
                                                          batch)
    y["n_e"] = np.stack([np.cos(lat) * np.cos(lon),
                         np.cos(lat) * np.sin(lon), np.sin(lat)], -1)
    u, s = ctl_operands(batch, seed + 1, y["h_e"])
    u_gdc = gdc_operands(batch, seed + 3, y["n_e"], y["h_e"])
    legs = M.lows_pattern()
    phase, t_m, _, u_sys = msn_operands(batch, seed + 4, y, legs)
    t = lambda tree: tree_from_numpy(tree, device, dtype)
    avionics = M.mission_avionics(M.traffic_pattern_phases(legs),
                                  device=device, dtype=dtype)
    return (avionics, t(y), {"ctl": t(u), "gdc": gdc_tree(u_gdc, device,
                                                          dtype)},
            {"inner": {"ctl": t(s)}, "phase": t(phase), "t": t(t_m)}, dt,
            t(u_sys))


def msn_sim(device, dtype, spp=1, turbulence=None):
    """The Simulation of the traffic pattern's phase machine as the operand
    states fly it: over the C172X's own terrain at 0 m (on which the
    cluster operands' runway lanes stand), in Dryden `turbulence` if
    given, dt 0.02 s, the pass every `spp` steps, the geoid every 128
    steps."""
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.models.c172 import c172x, missions as M
    from flightjax_torch.physics.aircraftbase import Aircraft, SimpleWorld
    aircraft = Aircraft(c172x.build_vehicle(device=device, dtype=dtype,
                                            turbulence=turbulence),
                        M.mission_avionics(M.traffic_pattern_phases(),
                                           device=device, dtype=dtype))
    return Simulation(SimpleWorld(aircraft), dt=0.02,
                      periodic_dt=spp * 0.02, geoid_every=128)


def msn_operand_state(batch, seed, device, dtype, ground_lanes=(),
                      terminated_lanes=(), crash_lanes=(), i0=0):
    """The mission world's SimState over the C172Xv2 cluster state of
    `xv2_operand_state` (the fly-by-wire cluster operands, the mode-rich
    control laws and guidance): lane k in phase k % 12 (the last two past
    the traffic pattern's ten), the clock drawn around the standby's 5 s
    on the standby lanes and over 400 s elsewhere."""
    st = xv2_operand_state(batch, seed, device, dtype, ground_lanes,
                           terminated_lanes, crash_lanes, i0)
    return with_phases(st, seed + 8, device, dtype)


def with_phases(st, seed, device, dtype):
    """The C172Xv2 world SimState `st` as a mission's over it: lane k in
    phase k % 12 (the last two past the traffic pattern's ten), the clock
    drawn from `seed` around the standby's 5 s on the standby lanes and
    over 400 s elsewhere."""
    batch = st.x["vehicle"]["kinematics"]["h_e"].shape[0]
    rng = np.random.default_rng(seed)
    lane = np.arange(batch)
    phase = (lane % 12).astype(np.int32)
    t = np.where(phase == 0, rng.uniform(4.9, 5.1, batch),
                 rng.uniform(0.0, 400.0, batch))
    s_av = {"inner": st.s["avionics"],
            "phase": torch.tensor(phase, device=device),
            "t": torch.tensor(t, dtype=dtype, device=device)}
    return st._replace(s=dict(st.s, avionics=s_av))


# the mission fleet: half the lanes land (the crosswind landing: the final
# leg's trim, an easterly crosswind in +-WIND_SPREAD of WIND_E, off the
# track by up to CROSS_TRACK m and off the trim's height by up to
# LANDING_DH m, the body velocity by up to 1 m/s), half fly the whole
# circuit from a cold start on the threshold (wind N(0, PATTERN_WIND) in
# the horizontal, the heading by up to HEADING_DEG)
WIND_E, WIND_SPREAD, CROSS_TRACK, LANDING_DH = 6.0, 3.0, 20.0, 5.0
PATTERN_WIND, HEADING_DEG = 2.0, 1.0


def pick_lanes(a, b, pick):
    """numpy (t, i, x, u, s) of a fleet whose lane k is the single-aircraft
    state `b` where `pick[k]`, else `a` (each a numpy SimState)."""
    return tuple(tree_map(lambda u, v: np.where(
        pick.reshape((-1,) + (1,) * np.ndim(u)), np.broadcast_to(
            v, (len(pick),) + np.shape(v)), np.broadcast_to(
            u, (len(pick),) + np.shape(u))).copy(), ta, tb)
        for ta, tb in zip(a[:5], b[:5]))


def msn_scenario(batch, seed):
    """numpy (t, i, x, u, s) of `batch` C172Xv2 flying the traffic
    pattern's phase set over the LOWS terrain, and (landing lanes,
    pattern lanes): the first half started in the final phase at the
    final-leg trim (`missions.landing_state`, the crosswind landing), the
    second half cold on the runway in the standby (`missions.
    runway_state`), each perturbed from a numpy seed."""
    from flightjax_torch.bridge import tree_to_numpy
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.models.c172.c172x import offset_point
    from flightjax_torch.ops import geodesy as geo
    phases = M.traffic_pattern_phases()
    lane = np.arange(batch)
    land, pattern = lane[:batch // 2], lane[batch // 2:]
    one = [tree_to_numpy(st) for st in (
        M.landing_state(0.02, torch.float64, "cpu", phases),
        M.runway_state(torch.float64, "cpu", phases))]
    t, i, x, u, s = pick_lanes(*one, lane >= batch // 2)
    rng = np.random.default_rng(seed)
    kin, dyn = x["vehicle"]["kinematics"], x["vehicle"]["dynamics"]
    wind = u["vehicle"]["atm"]["wind"]
    # the landing lanes: crosswind, cross-track and height offsets
    n = len(land)
    wind[land] = np.stack([np.zeros(n), rng.uniform(
        WIND_E - WIND_SPREAD, WIND_E + WIND_SPREAD, n), np.zeros(n)], -1)
    q = torch.as_tensor(kin["q_ew"][land])
    A, B = geo.get_psi_nw_ab(q)
    n_e = geo.nvector_from_qew(q)
    lat, lon = geo.latlon_from_nvector(n_e)
    off = rng.uniform(-CROSS_TRACK, CROSS_TRACK, n)
    chi = M.PSI_LOWS15 + np.pi / 2
    lat2, lon2 = offset_point(lat.numpy(), lon.numpy(), kin["h_e"][land],
                              off * np.cos(chi), off * np.sin(chi))
    kin["q_ew"][land] = geo.ltf(geo.nvector_from_latlon(
        torch.as_tensor(lat2), torch.as_tensor(lon2)),
        torch.atan2(A, B)).numpy()
    kin["h_e"][land] += rng.uniform(-LANDING_DH, LANDING_DH, n)
    dyn["v_eb_b"][land] += rng.uniform(-1.0, 1.0, (n, 3))
    s["avionics"]["phase"][land] = M.FINAL
    # the pattern lanes: wind and heading
    m = len(pattern)
    wind[pattern] = np.concatenate([rng.normal(0.0, PATTERN_WIND, (m, 2)),
                                    np.zeros((m, 1))], -1)
    dpsi = np.deg2rad(rng.uniform(-HEADING_DEG, HEADING_DEG, m))
    dq = np.stack([np.cos(dpsi / 2), np.zeros(m), np.zeros(m),
                   np.sin(dpsi / 2)], -1)
    kin["q_wb"][pattern] = qmul_np(dq, kin["q_wb"][pattern])
    return (t, i, x, u, s), (land, pattern)


def msn_fleet_sim(batch, seed, device, dtype):
    """(sim, SimState, (landing lanes, pattern lanes)) of `msn_scenario`
    on `device`: the traffic pattern's mission world over the LOWS terrain
    (`missions.mission_sim`: dt = periodic_dt = 0.02 s, the geoid every
    128 steps), with the position compensation it gives in sub-float64
    dtypes."""
    from flightjax_torch.models.c172 import missions as M
    sim = M.mission_sim(M.traffic_pattern_phases(), device=device,
                        dtype=dtype)
    (t, i, x, u, s), lanes = msn_scenario(batch, seed)
    st = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                  i=torch.tensor(i, device=device),
                  x=tree_from_numpy(x, device, dtype),
                  u=tree_from_numpy(u, device, dtype),
                  s=tree_from_numpy(s, device, dtype))
    return sim, sim.with_compensation(st), lanes


# ------------------------------------------------------------ turbulence

# the Dryden severities of the operands: off, light, moderate, severe
# (20-ft winds, m/s; `physics/turbulence.py`)
TURB_W20 = (0.0, 7.7, 15.4, 23.2)
# heights above the runway (m) that put a lane in the low-altitude band
# (10-1000 ft) and in the 1000-2000 ft blend; the flagship flies above
# 2000 ft and the runway lanes below 10 ft
TURB_H_LOW, TURB_H_BLEND = 150.0, 450.0
# shear roughness lengths (ft): off, Category C, otherwise; the runway
# lanes take TURB_Z0_HIGH, above their height, so h < z0 there
TURB_Z0 = (0.0, 0.15, 2.0)
TURB_Z0_HIGH = 10.0


def turb_trees(batch, seed, t, i, W20=None, shear_lanes=None,
               gust_lanes=None):
    """numpy x, u and s trees of the Dryden turbulence for `batch` lanes at
    times `t` and step counters `i`, from a numpy seed: filter states ~N(0,
    1) m/s, the drive ~N(0, 1), seeds above 2^24 on the odd lanes and drive
    counters up to 2^30. W20 cycles through TURB_W20 (or the given value on
    every lane); the shear's z0 through TURB_Z0 (or on `shear_lanes` only
    2 ft); the discrete gust is off, before, inside and after its window in
    turn (or inside it on `gust_lanes` only, for the whole of the first
    five steps after t)."""
    rng = np.random.default_rng(seed + 7)
    lanes = np.arange(batch)
    x = {"ug": rng.normal(0.0, 1.0, batch),
         "vg": rng.normal(0.0, 1.0, (batch, 2)),
         "wg": rng.normal(0.0, 1.0, (batch, 2))}
    seed_ = np.where(lanes % 2 == 1,
                     rng.integers(2 ** 24, 2 ** 31 - 1, batch),
                     rng.integers(0, 2 ** 16, batch)).astype(np.int32)
    if W20 is None:
        w20 = np.resize(np.array(TURB_W20), batch)
    else:
        w20 = np.full(batch, float(W20))
    amp = rng.normal(0.0, 3.0, (batch, 3))
    if gust_lanes is None:
        phase = lanes % 4
        t0 = np.where(phase == 0, 1e30, np.where(
            phase == 1, t + 1.0, np.where(phase == 2, t - 0.1, t - 5.0)))
        T = np.where(phase == 2, 0.5, 1.0)
        z0 = np.resize(np.array(TURB_Z0), batch)
    else:
        on = np.isin(lanes, list(gust_lanes))
        t0 = np.where(on, t + 0.015, 1e30)
        T = np.where(on, 0.05, 1.0)
        z0 = np.where(np.isin(lanes, list(shear_lanes or ())), 2.0, 0.0)
    u = {"seed": seed_, "W20": w20, "gust_amp": amp, "gust_t0": t0,
         "gust_T": T, "shear_z0_ft": z0}
    s = {"eta": rng.normal(0.0, 1.0, (batch, 3)),
         "n": np.where(lanes % 3 == 0, rng.integers(0, 2 ** 30, batch),
                       i).astype(np.int32)}
    return x, u, s


def turb_fleet(batch, seed, i0=0, ground_lanes=(), terminated_lanes=(),
               crash_lanes=(), W20=10.0, shear_lanes=(), gust_lanes=()):
    """numpy world-level (t, i, x, u, s) of `perturbed_flagship` with the
    turbulence's trees (`turb_trees` at W20 on every lane, the shear on
    `shear_lanes`, a discrete gust inside the first five steps on
    `gust_lanes`)."""
    t, i, x, u, s = perturbed_flagship(batch, seed, i0, ground_lanes,
                                       terminated_lanes, crash_lanes)
    xt, ut, st = turb_trees(batch, seed, t, i, W20, shear_lanes, gust_lanes)
    x["vehicle"]["turb"], u["vehicle"]["turb"] = xt, ut
    s["vehicle"]["turb"] = st
    return t, i, x, u, s


def turb_fleet_sim(batch, seed, device, dtype, **kw):
    """(sim, SimState) of `turb_fleet` on `device` in the turbulent
    flagship's Simulation (`c172s.turbulent_flagship_sim`), with its
    position compensation in sub-float64 dtypes."""
    from flightjax_torch.models.c172.c172s import turbulent_flagship_sim
    sim, _, _ = turbulent_flagship_sim(device, dtype)
    t, i, x, u, s = turb_fleet(batch, seed, **kw)
    st = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                  i=torch.tensor(i, device=device),
                  x=tree_from_numpy(x, device, dtype),
                  u=tree_from_numpy(u, device, dtype),
                  s=tree_from_numpy(s, device, dtype))
    return sim, sim.with_compensation(st)


def turb_operands(batch, seed, ground_lanes=(), terminated_lanes=(),
                  crash_lanes=()):
    """`cluster_operands` with the turbulence's operands that take every
    branch of the disturbance chain: the stage and finish times t and the
    step counters i (t = i dt, i up to 30 000), the filters' derivatives,
    `turb_trees`' severities, shear and discrete-gust phases; every fifth
    lane from lane 1 in the low-altitude band, from lane 2 in the blend,
    the runway lanes below 10 ft with a z0 above their height, and lane 4
    slower than V_MIN against the air. The lane lists are those of
    `perturbed_flagship`."""
    from flightjax_torch.physics.turbulence import FT
    d = cluster_operands(batch, seed, ground_lanes, terminated_lanes,
                         crash_lanes)
    rng = np.random.default_rng(seed + 11)
    i = rng.integers(0, 30000, batch).astype(np.int32)
    t = i * 0.02
    xt, ut, st = turb_trees(batch, seed, t, i)
    lanes = np.arange(batch)
    h = d["x_kin"]["h_e"]
    for r, h_agl in ((1, TURB_H_LOW), (2, TURB_H_BLEND)):
        sel = (lanes % 5 == r) & ~np.isin(lanes, list(ground_lanes)
                                           + list(crash_lanes))
        h[sel] = d["geoid_N"][sel] + h_agl
    ground = list(ground_lanes) + list(crash_lanes)
    ut["shear_z0_ft"][ground] = TURB_Z0_HIGH
    assert TURB_Z0_HIGH * FT > 1.85
    if batch > 4:
        d["x_dyn"]["v_eb_b"][4] = [1.0, 0.5, 0.2]
        d["u_atm"]["wind"][4] = [0.3, 0.0, 0.0]
    d.update(t=t, i=i, x_turb=xt, u_turb=ut, s_turb=st,
             k_turb={k: rng.normal(0.0, 0.5, np.shape(v))
                     for k, v in xt.items()})
    d["ksum_turb"] = {k: 6.0 * v for k, v in d["k_turb"].items()}
    return d


def turb_operand_state(d, device, dtype):
    """The turbulent world SimState (uncompensated) of the operand dict `d`
    of `turb_operands`: `operand_state` with the turbulence's trees, the
    times t and the step counters i."""
    st = operand_state(d, device, dtype)
    x, u, s = st.x, st.u, st.s
    x["vehicle"]["turb"] = tree_from_numpy(d["x_turb"], device, dtype)
    u["vehicle"]["turb"] = tree_from_numpy(d["u_turb"], device, dtype)
    s["vehicle"]["turb"] = tree_from_numpy(d["s_turb"], device, dtype)
    return st._replace(t=torch.tensor(d["t"], dtype=dtype, device=device),
                       i=torch.tensor(d["i"], device=device))


def turb_operand_args(d, vehicle, device, dtype, adt=0.01, dt=0.02):
    """Positional arguments of the turbulent instances' wrappers
    (`rk4_stage`, `rk4_finish`) from `turb_operands`' dict: the stage at
    t + adt, the finish at step counter i (t_start 0)."""
    from flightjax_torch.parallel import kernels as K
    args = K.operand_args(d, vehicle, device, dtype, adt, dt)
    tt = lambda v: tree_from_numpy(v, device, dtype)
    (_, xv, k, uv, sv, term, _) = args["rk4_stage"]
    xv = dict(xv, turb=tt(d["x_turb"]))
    uv = dict(uv, turb=tt(d["u_turb"]))
    sv = dict(sv, turb=tt(d["s_turb"]))
    k = dict(k, turb=tt(d["k_turb"]))
    ksum = dict(args["rk4_finish"][2], turb=tt(d["ksum_turb"]))
    t = torch.tensor(d["t"], dtype=dtype, device=device)
    i = torch.tensor(d["i"], device=device)
    return {"rk4_stage": (vehicle, xv, k, uv, sv, term, adt, t),
            "rk4_finish": (vehicle, xv, ksum, uv, sv, term > 0.5, dt,
                           args["rk4_finish"][7], i, 0.0)}


def fbw_turb_operands(batch, seed, ground_lanes=(), terminated_lanes=(),
                      crash_lanes=()):
    """`turb_operands` for the turbulent fly-by-wire C172X: every branch of
    the disturbance chain, with the servo positions, derivatives and
    commands of `fbw_cluster_operands` (some past their ranges, so that
    each channel saturates both ways)."""
    d = turb_operands(batch, seed, ground_lanes, terminated_lanes,
                      crash_lanes)
    f = fbw_cluster_operands(batch, seed, ground_lanes, terminated_lanes,
                             crash_lanes)
    for k in ("x_sys", "k_sys", "ksum_sys", "u_sys"):
        d[k] = f[k]
    return d


def fbw_turb_operand_state(d, device, dtype):
    """The turbulent C172Xv1 world SimState (uncompensated) of
    `fbw_turb_operands`' dict `d`, with the mode-rich avionics of
    `ctl_operands` at the lanes' heights (the pass firing on the lanes
    whose step counter makes a firing)."""
    st = turb_operand_state(d, device, dtype)
    u_av, s_av = (tree_from_numpy(t, device, dtype) for t in ctl_operands(
        d["geoid_N"].shape[0], 1021, d["x_kin"]["h_e"]))
    return st._replace(u=dict(st.u, avionics=u_av),
                       s=dict(st.s, avionics=s_av))


def xv2_turb_operand_state(d, device, dtype):
    """The turbulent C172Xv2 world SimState (uncompensated) of
    `fbw_turb_operands`' dict `d`: `fbw_turb_operand_state` with the
    mode-rich guidance of `gdc_operands` at the lanes' positions."""
    return with_guidance(fbw_turb_operand_state(d, device, dtype), 1022,
                         device, dtype)


def msn_turb_operand_state(d, device, dtype):
    """The world SimState of a mission flown on the turbulent C172Xv2 from
    `fbw_turb_operands`' dict `d`: `xv2_turb_operand_state` with every
    phase and clock of `with_phases`."""
    return with_phases(xv2_turb_operand_state(d, device, dtype), 1023,
                       device, dtype)


def xv2_turb_sim(device, dtype, spp=1):
    """The Simulation of the turbulent C172Xv2 (`c172x.build_xv2` in
    `DrydenTurbulence(0.02)`) as the operand states fly it: dt 0.02 s, the
    pass every `spp` steps, the geoid every 128 steps."""
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.models.c172.c172x import build_xv2
    from flightjax_torch.physics.aircraftbase import SimpleWorld
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    return Simulation(SimpleWorld(build_xv2(
        device=device, dtype=dtype, turbulence=DrydenTurbulence(0.02))),
        dt=0.02, periodic_dt=0.02 * spp, geoid_every=128)


def with_study_turb(tree, batch, seed):
    """numpy world-level (t, i, x, u, s) with the turbulence's trees of
    `turb_trees` at W20 = 10 m/s, the shear on every third lane and a
    discrete gust inside the first steps on every third lane from lane 1
    (the card's turbulent fleets, `turb_study_sim`)."""
    t, i, x, u, s = tree
    x["vehicle"]["turb"], u["vehicle"]["turb"], s["vehicle"]["turb"] = (
        turb_trees(batch, seed, t, i, 10.0, range(0, batch, 3),
                   range(1, batch, 3)))
    return t, i, x, u, s


def _fleet_state(sim, tree, device, dtype):
    t, i, x, u, s = tree
    st = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                  i=torch.tensor(i, device=device),
                  x=tree_from_numpy(x, device, dtype),
                  u=tree_from_numpy(u, device, dtype),
                  s=tree_from_numpy(s, device, dtype))
    return sim.with_compensation(st)


def xv2_turb_fleet_sim(batch, seed, device, dtype):
    """(sim, SimState, lanes) of `xv2_scenario` in Dryden turbulence
    (`c172x.c172xv2_sim(turbulence=)`, `with_study_turb`), with the
    position compensation it gives in sub-float64 dtypes."""
    from flightjax_torch.models.c172.c172x import c172xv2_sim
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    sim, _, _ = c172xv2_sim(device, dtype,
                            turbulence=DrydenTurbulence(0.02))
    tree, lanes = xv2_scenario(batch, seed)
    return (sim, _fleet_state(sim, with_study_turb(tree, batch, seed),
                              device, dtype), lanes)


def msn_turb_fleet_sim(batch, seed, device, dtype):
    """(sim, SimState, (landing lanes, pattern lanes)) of `msn_scenario`
    in Dryden turbulence (`missions.mission_sim(turbulence=)`,
    `with_study_turb`), with the position compensation it gives in
    sub-float64 dtypes."""
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    sim = M.mission_sim(M.traffic_pattern_phases(), device=device,
                        dtype=dtype, turbulence=DrydenTurbulence(0.02))
    tree, lanes = msn_scenario(batch, seed)
    return (sim, _fleet_state(sim, with_study_turb(tree, batch, seed),
                              device, dtype), lanes)


def turb_study_sim(batch, seed, device, dtype):
    """(sim, SimState) of the card's turbulent fleet: `turb_fleet_sim` at
    W20 = 10 m/s with the shear on every third lane and a discrete gust
    inside the first steps on every third lane from lane 1."""
    return turb_fleet_sim(batch, seed, device, dtype,
                          shear_lanes=range(0, batch, 3),
                          gust_lanes=range(1, batch, 3))


# ------------------------------------------------------------ navigation

def nav_fleet_sim(batch, seed, device, dtype):
    """(sim, SimState) of the joint navigation study's fleet
    (`demos/estimation_demos.py::nav_fleet_setup` from PRNGKey(seed)): the
    turbulent C172Xv1 on its navigation avionics, each lane's severity,
    dispersion, sensor grade and stream its own, at step 0."""
    from flightjax_torch.demos.estimation_demos import nav_fleet_setup
    from flightjax_torch.ops import random as R
    return nav_fleet_setup(batch, key=R.PRNGKey(seed), device=device,
                           dtype=dtype)


def xv1_turb_fleet_sim(batch, seed, device, dtype):
    """(sim, SimState) of the navigation fleet's truth-fed twin: the same
    lanes of the turbulent C172Xv1 (`nav_fleet_sim`) on their control laws
    alone (`c172x.c172xv1_sim(turbulence=)`), uncompensated as the study
    flies."""
    from flightjax_torch.models.c172.c172x import c172xv1_sim
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    nav_sim, st = nav_fleet_sim(batch, seed, device, dtype)
    dt = nav_sim.dt
    sim, _, _ = c172xv1_sim(device, dtype, turbulence=DrydenTurbulence(dt))
    sim.geoid_every = nav_sim.geoid_every
    av_u, av_s = st.u["avionics"]["inner"], st.s["avionics"]["inner"]
    return sim, st._replace(u=dict(st.u, avionics=av_u),
                            s=dict(st.s, avionics=av_s))


# ------------------------------------------------------------ navigation
# settings of the navigation avionics for the mode-rich operands: the
# study's; with the radar aiding and the cadences (GPS 2, baro and radar 3,
# mag 5) under which the firings run through every combination of epochs;
# shadow mode
NAV_SETTINGS = {"default": {},
                "radar": {"use_radar": True, "gps_every": 2,
                          "baro_every": 3, "mag_every": 5},
                "shadow": {"use_estimates": False},
                "synthetic": {"alpha_beta": "synthetic"},
                "perturb": {"alpha_beta": ("perturb", 0.01, -0.02)},
                "immediate": {"defer_cov": False}}
# lanes of the operands whose sensor catalog is `exact_suite_params` (zero
# sigmas and biases)
NAV_EXACT_LANES = (5, 23)
# the radar's height above the terrain on the lanes past the fault lanes:
# low, either side of radar_max_agl (150 m) and past h_max (762 m)
NAV_AGL = (40.0, 149.0, 151.0, 500.0, 770.0)


def nav_sim(device, dtype, turbulence=True, setting="default", spp=1,
            gdc=False):
    """(sim, trimmed single-aircraft SimState) of the sensor-fed C172Xv1
    (`c172x.build_xv1_nav` with the NAV_SETTINGS `setting`), in Dryden
    turbulence or calm, its pass every `spp` steps, the autopilot engaged
    on the turning climb, uncompensated; with `gdc` the sensor-fed C172Xv2
    (`c172x.build_xv2_nav`), its guidance not engaged."""
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.models.c172.c172x import (build_xv1_nav,
                                                   build_xv2_nav,
                                                   trimmed_xv1_state,
                                                   turning_climb)
    from flightjax_torch.physics.aircraftbase import SimpleWorld
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    kw = dict(NAV_SETTINGS[setting])
    use_est = kw.pop("use_estimates", True)
    pdt = 0.02 * spp
    turb = DrydenTurbulence(0.02) if turbulence else None
    tkw = {} if turb is None else {"turbulence": turb}

    def build(**k):
        return (build_xv2_nav if gdc else build_xv1_nav)(
            periodic_dt=pdt, use_estimates=use_est, nav_kw=kw, **k)
    sim = Simulation(SimpleWorld(build(device=device, dtype=dtype, **tkw)),
                     dt=0.02, periodic_dt=pdt)
    st = trimmed_xv1_state(pdt, dtype, device, build=build, turbulence=turb)
    return sim, (st if gdc else turning_climb(st))


def nav_operand_state(batch, seed, device, dtype, turbulence=True,
                      setting="default", spp=1, gdc=False):
    """(sim, SimState) of `batch` sensor-fed C172Xv1 lanes (`nav_sim`)
    whose navigation avionics are in every mode the pass takes, drawn from
    a numpy seed: each lane at its own sensor epoch (10 consecutive epochs
    on every 10 lanes, so the firings cover GPS, baro and mag epochs
    together, baro and mag alone and none; under the "radar" setting every
    combination), its stream's seed (above 2^24 on half the lanes); each
    fault channel in each mode before, inside and after its window (lanes
    0..47); the filter off the truth by position, velocity and attitude
    errors spread over three decades, so that each channel's NIS falls on
    both sides of its gate; a full P, the accumulator A and the hold
    registers random; each monitor one hit from latching on one lane and
    latched on another (lanes 12..21); the lanes past the faults at heights
    NAV_AGL over the terrain (the radar valid and not, either side of
    radar_max_agl); the
    NAV_EXACT_LANES with zero sigmas. Wind N(0, 3 m/s), height N(0, 30 m)
    and on the turbulent vehicle W20 ~ U(0, 8) with the discrete gust on
    some lanes. With `gdc` the sensor-fed C172Xv2 (`nav_sim(gdc=True)`)
    flying the mode-rich control laws of `ctl_operands` and the mode-rich
    guidance of `gdc_operands` at the lanes' positions; with `turbulence`
    too the turbulent sensor-fed C172Xv2's operands
    (`megakernel_gdc_nav_turb`)."""
    from flightjax_torch.core.sim import SimState
    from flightjax_torch.parallel import fleet
    from flightjax_torch.physics import navigation as N
    from flightjax_torch.physics.sensors import (exact_suite_params,
                                                 pressure_altitude)
    rng = np.random.default_rng(seed)
    sim, st1 = nav_sim("cpu", torch.float64, turbulence, setting, spp, gdc)
    st = fleet.broadcast_state(st1, batch)
    f64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))
    i64 = lambda a: torch.as_tensor(np.asarray(a, dtype=np.int64))
    x, u, s = st.x, st.u, st.s
    kin = dict(x["vehicle"]["kinematics"])
    kin["h_e"] = kin["h_e"] + f64(rng.normal(0.0, 30.0, batch))
    uv = dict(u["vehicle"])
    uv["atm"] = dict(uv["atm"], wind=f64(rng.normal(0.0, 3.0, (batch, 3))))
    if turbulence:
        tu = dict(uv["turb"])
        tu["W20"] = f64(rng.uniform(0.0, 8.0, batch))
        gust = rng.random(batch) < 0.3
        tu["gust_amp"] = f64(np.where(gust[:, None],
                                      rng.normal(0.0, 2.0, (batch, 3)), 0.0))
        tu["gust_t0"] = f64(np.where(gust, 0.0, 1e9))
        tu["gust_T"] = f64(np.full(batch, 0.5))
        tu["seed"] = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, batch),
                                     dtype=uv["turb"]["seed"].dtype)
        uv["turb"] = tu
    # the lanes past the faults at the radar's heights over the terrain
    # (flat, at orthometric 0)
    for k in range(48, batch):
        kin["h_e"][k] = (s["vehicle"]["geoid_N"][k]
                         + NAV_AGL[k % len(NAV_AGL)])
    nav = sim.system.aircraft.avionics
    av_u, av_s = dict(u["avionics"]), dict(s["avionics"])
    n = np.array([(k % 10) + 10 * (1 + (k // 10) % 5) + 2 for k in
                  range(batch)])
    sens_u = dict(av_u["sens"])
    sens_u["seed"] = torch.as_tensor(np.where(
        np.arange(batch) % 2 == 0, rng.integers(2 ** 24, 2 ** 31 - 1, batch),
        rng.integers(0, 2 ** 24, batch)), dtype=torch.int32)
    params = {g: dict(v) for g, v in sens_u["params"].items()}
    exact = exact_suite_params()
    for lane in NAV_EXACT_LANES:
        if lane < batch:
            for g, d in exact.items():
                for k, v in d.items():
                    params[g][k] = params[g][k].clone()
                    params[g][k][lane] = f64(v)
    sens_u["params"] = params
    av_u["sens"] = sens_u
    # the filter's origin and baro datum at each lane's own fix
    veh = sim.system.aircraft.vehicle
    xv = dict(x["vehicle"], kinematics=kin)
    y = veh.output(xv, uv, s["vehicle"], st.t)
    qnh = params["baro"]["qnh"]
    av_u["origin"] = dict(av_u["origin"], lat0=y.kinematics.lat,
                          lon0=y.kinematics.lon, h0=y.kinematics.h_e,
                          baro_datum=pressure_altitude(y.airflow.p)
                          - pressure_altitude(qnh) - y.kinematics.h_e)
    if gdc:  # the mode-rich control laws and guidance
        h_np = y.kinematics.h_e.numpy()
        u_ctl, s_ctl = (tree_from_numpy(t, "cpu", torch.float64)
                        for t in ctl_operands(batch, seed + 5, h_np))
        av_u["inner"] = {"ctl": u_ctl, "gdc": gdc_tree(gdc_operands(
            batch, seed + 6, y.kinematics.n_e.numpy(), h_np), "cpu",
            torch.float64)}
        av_s["inner"] = {"ctl": s_ctl}
    # the faults on lanes 0..47: channel, mode, window before, around,
    # after the record index k = n
    ch = np.zeros(batch, np.int64)
    mode = np.zeros(batch, np.int64)
    k0 = np.full(batch, N.NEVER, np.int64)
    k1 = np.full(batch, N.NEVER, np.int64)
    for k in range(min(48, batch)):
        ch[k], mode[k], when = 1 + k % 4, (k // 4) % 4, k // 16
        k0[k] = n[k] + (3, -2, -6)[when]
        k1[k] = n[k] + (10, 5, -1)[when]
    av_u["fault"] = {"channel": i64(ch).to(torch.int32),
                     "mode": i64(mode).to(torch.int32),
                     "k0": i64(k0).to(torch.int32),
                     "k1": i64(k1).to(torch.int32),
                     "delta": f64(rng.choice([-4.0, 3.0], batch))}
    # the filter off the truth, a full P, A, the hold registers
    scale = 10.0 ** rng.uniform(-1.0, 2.0, batch)
    filt = av_s["nav"]
    q = qmul_np(filt.q_nb.numpy(), np.concatenate(
        [np.ones((batch, 1)), rng.normal(0.0, 0.02, (batch, 3))
         * scale[:, None] / 10.0], axis=-1))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    # P = D^1/2 (I + R R^T) D^1/2 about the filter's initial variances D
    sd = np.sqrt(np.concatenate([[0.05 ** 2] * 3, [0.2 ** 2] * 3,
                                 [3.0 ** 2] * 3, [5e-3 ** 2] * 3,
                                 [0.05 ** 2] * 3]))
    R_ = rng.normal(0.0, 0.2, (batch, 15, 15))
    P = sd[None, :, None] * (np.eye(15)[None] + R_ @ np.swapaxes(
        R_, -1, -2)) * sd[None, None, :]
    P = 0.5 * (P + np.swapaxes(P, -1, -2))
    av_s["nav"] = filt._replace(
        q_nb=f64(q),
        v_n=filt.v_n + f64(rng.normal(0.0, 0.3, (batch, 3)) * scale[:, None]
                           / 3.0),
        p_n=filt.p_n + f64(rng.normal(0.0, 1.0, (batch, 3)) * scale[:, None]),
        b_g=f64(rng.normal(0.0, 1e-3, (batch, 3))),
        b_a=f64(rng.normal(0.0, 1e-2, (batch, 3))), P=f64(P))
    av_s["A"] = {k: f64(rng.normal(0.0, 0.02, (batch, 3, 3)))
                 for k in ("w", "cf", "c")}
    av_s["hold"] = {"gps_p": f64(rng.normal(0.0, 20.0, (batch, 3))),
                    "gps_v": f64(rng.normal(0.0, 2.0, (batch, 3))),
                    "h_baro": f64(rng.normal(300.0, 20.0, batch)),
                    "mag": f64(rng.normal(0.0, 3e-5, (batch, 3)))}
    av_s["nis"] = {k: f64(rng.uniform(0.0, 5.0, batch))
                   for k in ("baro", "gps", "gps_vel", "mag", "radar")}
    hits = nav.monitor_min_hits
    for j, k in enumerate(("gps", "vel", "baro", "mag", "radar")):
        # lanes 2j + 12: one hit from latching; 2j + 13: latched
        bits = np.zeros(batch, np.int64)
        alarm = np.zeros(batch, bool)
        for lane, b_, a_ in ((2 * j + 12, (1 << (hits - 1)) - 1, False),
                             (2 * j + 13, (1 << hits) - 1, True)):
            if lane < batch:
                bits[lane], alarm[lane] = b_, a_
        av_s["mon_" + k] = {"bits": i64(bits),
                            "alarm": torch.as_tensor(alarm)}
    sens_s = dict(av_s["sens"], n=i64(n).to(torch.int32))
    sens_s.update(b_g=f64(rng.normal(0.0, 1e-3, (batch, 3))),
                  b_a=f64(rng.normal(0.0, 1e-2, (batch, 3))),
                  gm_gps=f64(rng.normal(0.0, 1.5, (batch, 3))))
    av_s["sens"] = sens_s
    i = i64((n + 1) * spp - 1).to(st.i.dtype)
    t = (i.to(torch.float64) * sim.dt)
    state = SimState(t=t, i=i, x=dict(x, vehicle=dict(
        x["vehicle"], kinematics=kin)), u=dict(u, vehicle=uv, avionics=av_u),
        s=dict(s, avionics=av_s), c=None)
    sim_d, _ = nav_sim(device, dtype, turbulence, setting, spp, gdc)
    return sim_d, tree_map(lambda l: l.to(device=device, dtype=dtype)
                           if l.dtype == torch.float64 else l.to(device),
                           state)


def nav_pass_args(sim, st):
    """The `kernels.nav_pass` arguments at the state `st` of a sensor-fed
    fleet: (avionics, the truth-fed VehicleY, the truth the sensors read,
    the terrain's elevation, u, s), the truth at the state itself through
    the plain vehicle functions (`kernels.vehicle_truth`)."""
    from flightjax_torch.parallel import kernels as K
    veh = sim.system.aircraft.vehicle
    xv, uv, sv = st.x["vehicle"], st.u["vehicle"], st.s["vehicle"]
    _, _, dyn = K.vehicle_truth(veh, xv, uv, sv, st.t)
    vy = veh.output(xv, uv, sv, st.t)._replace(dynamics=dyn)
    h_trn = veh.terrain.terrain_data(uv["trn"]).elevation
    return (sim.system.aircraft.avionics, vy, vy, h_trn, st.u["avionics"],
            st.s["avionics"])


def sensor_fed_fleet_sim(batch, device, dtype):
    """(sim, SimState) of the sensor-fed autopilot fleet of the JAX
    package's benchmark report (`tools/bench_report.py:215-251`): the calm
    C172Xv1 on `NavAvionics(ControlLaws)` (`c172x.c172xv1_nav_sim`),
    engaged on the turning climb (EAS 45 m/s, 1.5 m/s climb, course pi /
    2), broadcast to `batch` lanes, lane k's sensor stream seeded k."""
    from flightjax_torch.models.c172.c172x import (c172xv1_nav_sim,
                                                   turning_climb)
    from flightjax_torch.parallel import fleet
    sim, st, _ = c172xv1_nav_sim(device, dtype)
    st = fleet.broadcast_state(turning_climb(st), batch)
    av_u = dict(st.u["avionics"])
    av_u["sens"] = dict(av_u["sens"], seed=torch.arange(
        batch, dtype=torch.int32, device=st.t.device))
    return sim, st._replace(u=dict(st.u, avionics=av_u))


# the loiter on estimates of `tests/test_navigation.py:276-327`: a circle of
# LOITER_RADIUS m centred LOITER_NORTH m north of the start at its height,
# flown at EAS_ref LOITER_EAS m/s for LOITER_STEPS steps (60 s)
LOITER_NORTH, LOITER_RADIUS, LOITER_EAS, LOITER_STEPS = (2000.0, 1500.0,
                                                         40.0, 3000)


def loiter_fleet_sim(batch, device, dtype, W20=None):
    """(sim, SimState, orbit) of the loiter on estimates on `batch` lanes:
    the trimmed sensor-fed C172Xv2 (`c172x.c172xv2_nav_sim`: the geoid
    every step, Kahan position in sub-float64 dtypes) on circular guidance,
    lateral and vertical, over the filter's solution, the circle `orbit`
    (a `Circle` of one lane's leaves) LOITER_NORTH m north of the start,
    EAS_ref LOITER_EAS, lane k's sensor stream seeded k (lane 0 the JAX
    test's single aircraft). With `W20` the vehicle flies in
    `DrydenTurbulence(0.02)` at that 20-ft wind on every lane, lane k's
    turbulence stream seeded k too, with no shear and no discrete gust
    (the turbulence's defaults), as `tools/jax_loiter.py` flies it."""
    from flightjax_torch.models.c172 import c172x
    from flightjax_torch.models.c172 import c172x_gdc as GDC
    from flightjax_torch.ops import geodesy as geo
    from flightjax_torch.parallel import fleet
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    turb = None if W20 is None else DrydenTurbulence(0.02)
    sim, st, _ = c172x.c172xv2_nav_sim(device, dtype, turbulence=turb)
    kin = st.x["vehicle"]["kinematics"]
    n_e = geo.nvector_from_qew(kin["q_ew"].double().cpu())
    h0 = float(kin["h_e"])
    lat, lon = (float(v) for v in geo.latlon_from_nvector(n_e))
    lat_c, lon_c = c172x.offset_point(lat, lon, h0, LOITER_NORTH, 0.0)
    orbit = GDC.circle(float(lat_c), float(lon_c), h0,
                       radius=LOITER_RADIUS, device=device, dtype=dtype)
    st = c172x.engage_guidance(st, GDC.GDC_CIRCULAR, orbit=orbit)
    av = st.u["avionics"]
    ctl = av["inner"]["ctl"]
    ctl = dict(ctl, lon=dict(ctl["lon"], EAS_ref=torch.full_like(
        ctl["lon"]["EAS_ref"], LOITER_EAS)))
    st = fleet.broadcast_state(st._replace(u=dict(st.u, avionics=dict(
        av, inner=dict(av["inner"], ctl=ctl)))), batch)
    seeds = torch.arange(batch, dtype=torch.int32, device=st.t.device)
    av_u = dict(st.u["avionics"])
    av_u["sens"] = dict(av_u["sens"], seed=seeds)
    uv = dict(st.u["vehicle"])
    if turb is not None:
        uv["turb"] = dict(uv["turb"], seed=seeds, W20=torch.full_like(
            uv["turb"]["W20"], float(W20)))
    return sim, st._replace(u=dict(st.u, vehicle=uv, avionics=av_u)), orbit


# the turbulent loiter's 20-ft wind (m/s), the severity of the JAX
# package's turbulent demos (`flightjax/demos/c172_demos.py:165`)
LOITER_W20 = 10.0


def turb_loiter_fleet_sim(batch, device, dtype):
    """(sim, SimState, orbit) of the loiter on estimates in Dryden
    turbulence: `loiter_fleet_sim` at W20 = LOITER_W20 on every lane, lane
    k's sensor and turbulence streams seeded k, no shear, no discrete
    gust (`tools/jax_loiter.py --W20 10` flies the same fleet in the JAX
    package)."""
    return loiter_fleet_sim(batch, device, dtype, W20=LOITER_W20)


def normal_table_for(seeds, ns):
    """A float32 table of 2^23 entries holding `ops/random.normal_table`'s
    values where the sensors' draws of `seeds` at epochs `ns` (int32
    tensors of one shape) read it, NaN elsewhere: what those draws need of
    the table, on the CPU, without its 2^23 erf_inv chains."""
    from flightjax_torch.ops import random as R
    from flightjax_torch.physics.sensors import KEY_BASE
    key = R.fold_in(R.fold_in(R.PRNGKey(KEY_BASE), seeds.reshape(-1)),
                    ns.reshape(-1))
    k = R.fold_in(key[:, None, :], torch.tensor([0, 1]))
    y0, y1 = R._counters(k, (20,))
    idx = torch.unique(((y0 ^ y1) >> 9).reshape(-1))
    table = torch.full((2 ** 23,), float("nan"), dtype=torch.float32)
    mant = (idx | 0x3F800000).to(torch.int32).view(torch.float32)
    table[idx] = R._normal_of_unit(mant)
    return table


# The navigation kernels against their plain versions on the same card
# tensors: P per lane within NAV_P_TOL of its own largest entry, and every
# other floating leaf within max(floor, NAV_SPREAD times the plain run's
# own distance from a reference) of that reference: in float64 the floor
# is 1e-12 of max(1, |reference|) and the reference the plain function
# run on the CPU (the first NAV_CPU_LANES lanes); in float32 the floor is
# 1e-5 and the reference the plain function in float64 on the same
# inputs and gusts (`nav_twin`). Two faithful runs of the pass differ by
# more than the floor where the arithmetic is ill-conditioned: the GPS
# fix's NED position is a
# difference of latitudes times the Earth's radius (an ulp of the latitude
# is 7e-10 m in float64, 0.38 m in float32), and the stacked solve weighs
# the GPS position's variance (400 m^2 in float32) against the velocity's
# (0.004 m^2/s^2); a truth an ulp apart (the card's libm against the
# CPU's) moves the fix by an ulp of latitude, 4.7e-12 of a 150 m estimate
# (2.7e-12 of `nav_pass`'s f64 p_n on the study's fleet against the CPU,
# the card's plain run as far; 1.8e-13 on the mode-rich operands). The
# integers and flags (the sensor epoch, the monitors'
# bits and alarms, a mission's phase) exactly, but on float32 lanes where
# an NIS lies within NAV_NEAR_GATE of its gate, or a sensor-fed mission's
# lane stands at its radar gate (`msn_gate_lanes`: its true height over
# the runway within NAV_NEAR_AGL m of the 6 m gate, in the phase the gate
# ends or the one after it), where two faithful float32 runs may switch
# one firing apart (none in float64).
NAV_P_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
NAV_FLOOR = NAV_P_TOL
NAV_SPREAD, NAV_CPU_LANES, NAV_NEAR_GATE = 4.0, 1024, 0.01
NAV_NEAR_AGL = 1.0


def nav_lanes(tree, device, dtype, n=None):
    """`tree` on `device`, its floating leaves in `dtype`, the
    batch-leading leaves cut to their first `n` lanes (a 0-dim leaf, a
    scalar of the model, as it is)."""
    def cut(v):
        v = v.to(device=device)
        if v.dtype.is_floating_point:
            v = v.to(dtype)
        return v[:n] if n is not None and v.dim() else v
    return tree_map(lambda v: cut(v) if isinstance(v, torch.Tensor) else v,
                    tree)


def _drive_in(turb, dtype):
    """A copy of the DrydenTurbulence `turb` whose redraw draws the drive
    in `dtype` and casts it to the state's: a float64 twin of a float32
    run flies the float32 run's gusts."""
    import copy
    twin = copy.copy(turb)
    f_step = type(turb).f_step

    def f_step_in(u, s):
        out = f_step(twin, u, dict(s, eta=s["eta"].to(dtype)))
        return dict(out, eta=out["eta"].to(s["eta"].dtype))
    twin.f_step = f_step_in
    return twin


def nav_twin(sim, device, dtype):
    """The sensor-fed C172Xv1 (or C172Xv2, or mission) Simulation `sim`
    rebuilt on `device` in `dtype` with its navigation settings and
    turbulence (a mission with its phases, over its terrain); its
    filter takes the GPS position variance of `sim`'s dtype and its
    turbulence draws the drive in `sim`'s dtype, so that a float64 twin
    runs a float32 filter's arithmetic in float64 through the float32
    run's gusts."""
    import copy
    from flightjax_torch.core.mission import MissionAvionics
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.models.c172.c172x import (build_xv1_nav,
                                                   build_xv2_nav)
    from flightjax_torch.models.c172.c172x_gdc import Avionics
    from flightjax_torch.physics.aircraftbase import SimpleWorld
    nav = sim.system.aircraft.avionics
    veh = sim.system.aircraft.vehicle
    kw = dict(periodic_dt=sim.periodic_dt, use_estimates=nav.use_estimates,
              nav_kw=dict(gps_every=nav.suite.gps_every,
                          baro_every=nav.baro_every,
                          mag_every=nav.mag_every, use_radar=nav.use_radar,
                          alpha_beta=nav.alpha_beta,
                          defer_cov=nav.defer_cov))
    if veh.turbulence is not None:
        kw["turbulence"] = _drive_in(veh.turbulence, nav.dtype)
    if isinstance(nav.inner, MissionAvionics):
        nav_kw = dict(kw["nav_kw"], use_estimates=nav.use_estimates)
        air = M.mission_nav_aircraft(nav.inner.phases, dt=sim.periodic_dt,
                                     nav_kw=nav_kw, device=device,
                                     dtype=dtype,
                                     turbulence=kw.get("turbulence"))
    else:
        build = (build_xv2_nav if isinstance(nav.inner, Avionics)
                 else build_xv1_nav)
        air = build(device=device, dtype=dtype, **kw)
    f = copy.copy(air.avionics.filter)
    f.r_pos = nav.filter.r_pos_eff(nav.dtype)
    air.avionics.filter = f
    return Simulation(SimpleWorld(air), dt=sim.dt,
                      periodic_dt=sim.periodic_dt,
                      geoid_every=sim.geoid_every)


def nav_reference(sim, dtype, run, inputs):
    """The reference `nav_hold` reads: in float64 the plain function `run`
    (a function of a Simulation and inputs) on the CPU over the first
    NAV_CPU_LANES lanes, in float32 the plain function in float64 on the
    card over every lane (`nav_twin`)."""
    from flightjax_torch.core.modeling import tree_leaves_with_path
    device = next(v.device for _, v in tree_leaves_with_path(inputs)
                  if isinstance(v, torch.Tensor))
    if dtype == torch.float64:
        return run(nav_twin(sim, "cpu", torch.float64),
                   nav_lanes(inputs, "cpu", torch.float64, NAV_CPU_LANES))
    return run(nav_twin(sim, device, torch.float64),
               nav_lanes(inputs, device, torch.float64))


def nav_hold(dtype, got, ref, ref_x, s_got, s_ref, nav, what="", gate=None):
    """Hold a navigation kernel's output tree `got` to the plain run `ref`
    on the same card tensors, `ref_x` the reference of `nav_reference`,
    as the comment above says; `s_got`, `s_ref` the navigation avionics'
    states in `got` and `ref`, `nav` the avionics, `gate` the lanes at a
    mission's radar gate (`msn_gate_lanes`). Raises AssertionError
    where it fails; returns (P's error, the lanes whose integers differ,
    those of them away from a gate, {leaf group: (error, limit)})."""
    from flightjax_torch.core.modeling import tree_leaves_with_path
    from flightjax_torch.parallel import kernels as K
    gates = {"gps": nav.gps_gate, "gps_vel": nav.vel_gate,
             "baro": nav.baro_gate, "mag": nav.mag_gate,
             "radar": nav.radar_gate}
    bad = s_got["sens"]["n"] != s_ref["sens"]["n"]
    for k in K.MONITORS:
        for f in ("bits", "alarm"):
            bad = bad | (s_got["mon_" + k][f].long()
                         != s_ref["mon_" + k][f].long())
    inner = s_got.get("inner")
    if isinstance(inner, dict) and "phase" in inner:  # a mission's phase
        bad = bad | (inner["phase"] != s_ref["inner"]["phase"])
    near = torch.zeros_like(bad)
    if dtype == torch.float32:
        for ch, g in gates.items():
            near = near | ((s_ref["nis"][ch] - g).abs() <= NAV_NEAR_GATE * g)
        if gate is not None:
            near = near | gate.to(near.device)
    n_bad, n_far = int(bad.sum()), int((bad & ~near).sum())
    if n_far or (dtype == torch.float64 and n_bad):
        raise AssertionError(f"{what} {dtype}: integers or flags differ on "
                             f"{n_far} lanes away from a gate ({n_bad} in "
                             f"all)")
    keep = (~bad).cpu()

    def rel(a, b):
        if a.numel() == 0:
            return 0.0
        a, b = a.double(), b.double()
        return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
    worst = {}
    for (p, a), (_, b), (_, c) in zip(tree_leaves_with_path(got),
                                      tree_leaves_with_path(ref),
                                      tree_leaves_with_path(ref_x)):
        if not a.dtype.is_floating_point or a.dim() == 0:
            continue
        a, b, c = a.cpu(), b.cpu(), c.cpu()
        n = c.shape[0]
        kn = keep[:n]
        e = rel(a[:n][kn], c[kn])
        lim = max(NAV_FLOOR[dtype], NAV_SPREAD * rel(b[:n][kn], c[kn]))
        if not e <= lim:
            raise AssertionError(f"{what} {dtype} {p}: {e} > {lim}")
        key = "/".join(map(str, p[:3]))
        if key not in worst or e > worst[key][0]:
            worst[key] = (e, lim)
    P_got = s_got["nav"].P.cpu()[keep].double()
    P_ref = s_ref["nav"].P.cpu()[keep].double()
    p_err = float(((P_got - P_ref).abs().amax(dim=(-2, -1))
                   / P_ref.abs().amax(dim=(-2, -1))).max())
    if not p_err <= NAV_P_TOL[dtype]:
        raise AssertionError(f"{what} {dtype}: P {p_err} > "
                             f"{NAV_P_TOL[dtype]}")
    return p_err, n_bad, n_far, worst


# ------------------------------------------------------------ sensor-fed
# missions

def msn_nav_phases(legs=None):
    """Both sensor-fed missions in one phase list, for fleets that fly
    both: the landing's (final on the radar gate, flare, ground: indices
    0..2), then the takeoff's (standby, startup, takeoff, departure:
    TAKEOFF_NAV0..); a lane starts in its mission's first phase. The
    landing's ground phase never ends, so neither mission runs into the
    other's."""
    from flightjax_torch.models.c172 import missions as M
    legs = M.lows_pattern() if legs is None else legs
    return (M.crosswind_landing_nav_phases(legs)
            + M.takeoff_nav_phases(legs))


# the first takeoff phase in `msn_nav_phases`, and each phase's index
(NAV_FINAL, NAV_FLARE, NAV_GROUND, NAV_STANDBY, NAV_STARTUP, NAV_TAKEOFF,
 NAV_DEPARTURE) = range(7)
TAKEOFF_NAV0 = NAV_STANDBY
# the lanes of the sensor-fed mission operands, cycled over the batch: the
# start (the landing's trim on the final or the takeoff's parked aircraft),
# the phase and what is set: "agl" the height of the CoM over the runway
# (m), "clock" the mission clock (s), "eng" the engine's state, "h_max" the
# radar's range (m) with "dh" the filter's altitude that far below the
# truth (m), "latched" the radar monitor latched. The first eight are the
# CPU parity test's: one lane crosses the 6 m radar gate inside five steps
# (0), one stands above it on the truth but under it on its estimate, the
# radar out of range (1), one's standby clock reaches 5 s in the window
# (5). Then each gate's two sides, the radar valid and not, a latched radar
# monitor and a filter whose radar NIS passes its gate
MSN_NAV_LANES = (
    ("land", NAV_FINAL, {"agl": 6.25}),
    ("land", NAV_FINAL, {"agl": 6.5, "h_max": 3.0, "dh": 2.5}),
    ("land", NAV_FINAL, {}),
    ("land", NAV_FLARE, {"agl": 3.0}),
    ("rwy", NAV_FLARE, {}),
    ("rwy", NAV_STANDBY, {"clock": 4.96}),
    ("rwy", NAV_STARTUP, {"eng": 1}),
    ("land", NAV_TAKEOFF, {}),
    ("land", NAV_FINAL, {"agl": 5.5}),
    ("land", NAV_FINAL, {"agl": 151.0}),
    ("land", NAV_FINAL, {"agl": 770.0}),
    ("rwy", NAV_STANDBY, {"clock": 4.98}),
    ("rwy", NAV_STANDBY, {"clock": 5.0}),
    ("rwy", NAV_TAKEOFF, {}),
    ("land", NAV_FINAL, {"agl": 6.5, "latched": True}),
    ("land", NAV_FINAL, {"agl": 40.0, "dh": 8.0}),
    ("rwy", NAV_GROUND, {}),
    ("land", NAV_DEPARTURE, {}),
    ("rwy", NAV_STARTUP, {"eng": 2}),
)


def msn_nav_sim(device, dtype, setting="default", spp=1, turbulence=False):
    """The Simulation of `msn_nav_phases` on the navigation avionics with
    the NAV_SETTINGS `setting` (the radar aiding always on), dt 0.02 s, the
    pass every `spp` steps, the geoid every step; with `turbulence` on the
    vehicle in `DrydenTurbulence(0.02)`."""
    from flightjax_torch.core.sim import Simulation
    from flightjax_torch.models.c172 import missions as M
    from flightjax_torch.physics.turbulence import DrydenTurbulence
    pdt = 0.02 * spp
    return Simulation(M.mission_nav_world(
        msn_nav_phases(), dt=pdt, nav_kw=NAV_SETTINGS[setting],
        device=device, dtype=dtype,
        turbulence=DrydenTurbulence(0.02) if turbulence else None),
        dt=0.02, periodic_dt=pdt)


def msn_nav_operand_state(batch, seed, device, dtype, setting="default",
                          spp=1, i0=None, turbulence=False):
    """(sim, SimState) of `batch` sensor-fed mission lanes (`msn_nav_sim`)
    whose phase machines and navigation avionics are in the modes of
    MSN_NAV_LANES (cycled), drawn from a numpy seed: the landing lanes from
    the trim on the final (`missions.landing_nav_state`, their CoM moved to
    the lane's height, the filter's altitude with it), the takeoff lanes
    parked on the threshold (`missions.runway_nav_state`); each lane's
    sensor stream its own (above 2^24 on half the lanes). With `i0` every
    lane at step and sensor epoch i0; else each at its own epoch (10
    consecutive on every 10 lanes: GPS, baro, mag and radar epochs together,
    alone and none), the step counter the one that makes it. With
    `turbulence` the missions fly the turbulent C172Xv2
    (`msn_nav_sim(turbulence=True)`) in the turbulence of `with_study_turb`
    (W20 = 10 m/s, the shear on every third lane, a discrete gust on every
    third lane from lane 1, the filters and the drive drawn)."""
    from flightjax_torch.bridge import tree_to_numpy
    from flightjax_torch.models.c172 import missions as M
    rng = np.random.default_rng(seed)
    F = torch.float64
    phases = msn_nav_phases()
    kw = dict(dt=0.02 * spp, nav_kw=NAV_SETTINGS[setting])
    one = [tree_to_numpy(st) for st in (
        M.landing_nav_state(F, "cpu", phases, **kw),
        M.runway_nav_state(F, "cpu", phases, **kw))]
    lanes = [MSN_NAV_LANES[k % len(MSN_NAV_LANES)] for k in range(batch)]
    t, i, x, u, s = pick_lanes(
        *one, np.array([base == "rwy" for base, _, _ in lanes]))
    kin = x["vehicle"]["kinematics"]
    av_u, av_s = u["avionics"], s["avionics"]
    p_n = av_s["nav"].p_n
    geoid_N = s["vehicle"]["geoid_N"]
    eng = s["vehicle"]["systems"]["pwp"]["engine"]["state"]
    radar = av_u["sens"]["params"]["radar"]
    hits = M.mission_nav_avionics([], device="cpu", dtype=F).monitor_min_hits
    clock = rng.uniform(0.0, 60.0, batch)
    phase = np.zeros(batch, np.int32)
    for k, (_, ph, what) in enumerate(lanes):
        phase[k] = ph
        if "agl" in what:
            h = geoid_N[k] + M.H_LOWS15 + what["agl"]
            p_n[k, 2] -= h - kin["h_e"][k]
            kin["h_e"][k] = h
        p_n[k, 2] += what.get("dh", 0.0)
        if "clock" in what:
            clock[k] = what["clock"]
        if "eng" in what:
            eng[k] = what["eng"]
        if "h_max" in what:
            radar["h_max"][k] = what["h_max"]
        if what.get("latched"):
            av_s["mon_radar"]["bits"][k] = (1 << hits) - 1
            av_s["mon_radar"]["alarm"][k] = True
    av_s["inner"]["phase"] = phase
    av_s["inner"]["t"] = clock
    av_u["sens"]["seed"] = np.where(
        np.arange(batch) % 2 == 0, rng.integers(2 ** 24, 2 ** 31 - 1, batch),
        rng.integers(0, 2 ** 24, batch)).astype(np.int32)
    if i0 is None:
        n = np.array([(k % 10) + 10 * (1 + (k // 10) % 5) + 2
                      for k in range(batch)])
        i = (n + 1) * spp - 1
    else:
        n = np.full(batch, int(i0))
        i = n.copy()
    av_s["sens"]["n"] = n.astype(np.int32)
    t = i * 0.02
    if turbulence:
        t, i, x, u, s = with_study_turb((t, i, x, u, s), batch, seed)
    sim = msn_nav_sim(device, dtype, setting, spp, turbulence)
    state = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                     i=torch.tensor(i, dtype=torch.int32, device=device),
                     x=tree_from_numpy(x, device, dtype),
                     u=tree_from_numpy(u, device, dtype),
                     s=tree_from_numpy(s, device, dtype))
    return sim, state


def msn_nav_pass_args(sim, st):
    """The arguments of `msn_nav_ctl_laws` at a sensor-fed mission state
    `st`: the estimates its plain navigation pass makes there
    (`kernels.nav_pass_plain` on the plain truth, `nav_pass_args`; the
    MSN_NAV_Y fields with the truth's engine state), the mission's
    avionics, inputs and state and the systems' inputs."""
    from flightjax_torch.parallel import kernels as K
    _, y = K.nav_pass_plain(*nav_pass_args(sim, st))
    eng = st.s["vehicle"]["systems"]["pwp"]["engine"]["state"]
    return (sim.system.aircraft.avionics.inner, dict(y, eng_state=eng),
            st.u["avionics"]["inner"], st.s["avionics"]["inner"],
            sim.periodic_dt, st.u["vehicle"]["systems"])


def msn_nav_laws_args(batch, seed, device, dtype, ground_lanes=(),
                      dt=0.02):
    """The wrapper arguments of `msn_nav_ctl_laws` (avionics, y, u, s, dt,
    u_sys): `msn_laws_args`'s mode-rich traffic pattern with its final leg
    ended by the radar gate on h_o (`final_done_agl`) in place of the
    height over the runway's end, and the MSN_NAV_Y rows: h_o drawn, and on
    the lanes around the final's switch on the other side of the radar gate
    than h_e is of the old gate, so that a pass reading h_e fails."""
    from flightjax_torch.core.mission import Phase
    from flightjax_torch.models.c172 import missions as M
    avionics, y, u, s_av, dt, u_sys = msn_laws_args(
        batch, seed, device, dtype, ground_lanes, dt)
    legs = M.lows_pattern()
    lib = M.mission_phase_lib(legs)
    phases = list(avionics.phases)
    final = phases[M.FINAL]
    phases[M.FINAL] = Phase(final.name, final.apply, lib["final_done_agl"],
                            final.systems)
    avionics = M.mission_avionics(phases, device=device, dtype=dtype)
    rng = np.random.default_rng(seed + 9)
    h_o = rng.uniform(M.H_LOWS15 - 2.0, M.H_LOWS15 + 300.0, batch)
    h_end = float(legs["final"].h_e2)
    h_e = y["h_e"].cpu().double().numpy()
    for k in range(batch):
        if int(s_av["phase"][k]) == M.FINAL:
            above = h_e[k] - h_end >= M.FINAL_DH
            h_o[k] = M.H_LOWS15 + (FINAL_SIDES[1] if above
                                   else FINAL_SIDES[0])
    y = dict(y, h_o=torch.tensor(h_o, dtype=dtype, device=device))
    return avionics, y, u, s_av, dt, u_sys


def _nav_fleet(sim, st, batch, seeds):
    from flightjax_torch.parallel import fleet
    st = fleet.broadcast_state(st, batch)
    av_u = dict(st.u["avionics"])
    av_u["sens"] = dict(av_u["sens"], seed=torch.as_tensor(
        seeds, dtype=torch.int32).to(st.t.device))
    return sim, sim.with_compensation(st._replace(u=dict(st.u,
                                                         avionics=av_u)))


def landing_nav_fleet_sim(batch, device, dtype):
    """(sim, SimState) of the sensor-fed crosswind landing on `batch` lanes
    (`tests/test_missions.py:157-205` on a fleet): the trim 1500 m up the
    final under the 6 m/s crosswind (`missions.landing_nav_state`), lane k's
    sensor stream seeded 100 + k as JAX's fleet test seeds its lanes;
    `missions.mission_nav_sim`, the position compensated in sub-float64
    dtypes."""
    from flightjax_torch.models.c172 import missions as M
    sim = M.mission_nav_sim(M.crosswind_landing_nav_phases(), device=device,
                            dtype=dtype)
    return _nav_fleet(sim, M.landing_nav_state(dtype, device), batch,
                      100 + np.arange(batch))


def takeoff_nav_fleet_sim(batch, device, dtype):
    """(sim, SimState) of the sensor-fed takeoff on `batch` lanes
    (`tests/test_missions.py:254-300`, `c172_demos.py:485-532`): parked on
    the threshold, aligned cold once on the parked truth that every lane
    shares (`missions.runway_nav_state`), lane k's sensor stream seeded
    k."""
    from flightjax_torch.models.c172 import missions as M
    sim = M.mission_nav_sim(M.takeoff_nav_phases(), device=device,
                            dtype=dtype)
    return _nav_fleet(sim, M.runway_nav_state(dtype, device), batch,
                      np.arange(batch))


# the numpy seed of the turbulent two-mission fleet's turbulence
MSN_NAV_TURB_SEED = 1017


def msn_nav_fleet_sim(batch, device, dtype, turbulence=False):
    """(sim, SimState) of both sensor-fed missions in one fleet
    (`msn_nav_phases`): the first half of the lanes the crosswind landing
    (`landing_nav_fleet_sim`'s start, seeds 100 + k), the second half the
    takeoff (`takeoff_nav_fleet_sim`'s, seeds k, in the standby phase), at
    step 0; the position compensated in sub-float64 dtypes. With
    `turbulence` on the turbulent C172Xv2 in the turbulence of
    `with_study_turb` (W20 = 10 m/s, the shear on every third lane, a
    discrete gust on every third lane from lane 1; numpy seed
    MSN_NAV_TURB_SEED)."""
    from flightjax_torch.bridge import tree_to_numpy
    from flightjax_torch.models.c172 import missions as M
    F = torch.float64
    phases = msn_nav_phases()
    one = [tree_to_numpy(st) for st in (
        M.landing_nav_state(F, "cpu", phases),
        M.runway_nav_state(F, "cpu", phases))]
    lane = np.arange(batch)
    pick = lane >= batch // 2
    t, i, x, u, s = pick_lanes(*one, pick)
    s["avionics"]["inner"]["phase"][pick] = TAKEOFF_NAV0
    u["avionics"]["sens"]["seed"] = np.where(
        pick, lane - batch // 2, lane + 100).astype(np.int32)
    turb = None
    if turbulence:
        from flightjax_torch.physics.turbulence import DrydenTurbulence
        turb = DrydenTurbulence(0.02)
        t, i, x, u, s = with_study_turb((t, i, x, u, s), batch,
                                        MSN_NAV_TURB_SEED)
    sim = M.mission_nav_sim(phases, device=device, dtype=dtype,
                            turbulence=turb)
    state = SimState(t=torch.tensor(t, dtype=dtype, device=device),
                     i=torch.tensor(i, dtype=torch.int32, device=device),
                     x=tree_from_numpy(x, device, dtype),
                     u=tree_from_numpy(u, device, dtype),
                     s=tree_from_numpy(s, device, dtype))
    return sim, sim.with_compensation(state)


def msn_gate_lanes(sim, st):
    """The lanes of a sensor-fed mission's state `st` that stand at its
    radar gate (`nav_hold`): in a phase the gate ends (MD_AGL) or the one
    after it, their true height over the runway within NAV_NEAR_AGL of the
    gate."""
    from flightjax_torch.models.c172 import missions as M
    phases = sim.system.aircraft.avionics.inner.phases
    ph = st.s["avionics"]["inner"]["phase"].long()
    h_o = (st.x["vehicle"]["kinematics"]["h_e"]
           - st.s["vehicle"]["geoid_N"]).double()
    out = torch.zeros_like(ph, dtype=torch.bool)
    for k, p in enumerate(phases):
        if getattr(p.done, "kind", None) == M.MD_AGL:
            near = ((h_o - p.done.values["value"] - M.FINAL_DH).abs()
                    <= NAV_NEAR_AGL)
            out = out | (((ph == k) | (ph == k + 1)) & near)
    return out
