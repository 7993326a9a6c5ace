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
    from flightjax_torch.bridge import tree_to_numpy
    from flightjax_torch.models.c172 import c172x, c172x_ctl as CTL
    st = c172x.turning_climb(c172x.trimmed_xv1_state(0.02, torch.float64,
                                                     "cpu"))
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
    sas = list(sas_lanes)
    u["avionics"]["lon"]["mode_req"][sas] = CTL.LON_SAS
    u["avionics"]["lat"]["mode_req"][sas] = CTL.LAT_SAS
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
