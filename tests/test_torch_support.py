"""Shared inputs and comparisons for the flightjax_torch parity tests, and
the tests of the numpy bridge and the kernel buffer layouts.

Every parity test draws its inputs with numpy from a seed and hands the same
arrays to `flightjax` (JAX, float64, CPU) and to `flightjax_torch` (float64,
CPU), then compares leaf by leaf with max|a - b| <= tol * max(1, |b|).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flightjax_torch.bridge import tree_from_numpy, tree_to_numpy
from flightjax_torch.core.modeling import tree_leaves_with_path, tree_map
from flightjax_torch.parallel import kernels as K
from flightjax_torch.testing import perturbed_flagship

B = 8
SEED = 20261016
CONTACT_LANES = (2, 5)
TERMINATED_LANE = 6
F64 = torch.float64


def perturbed_fleet(i0=0):
    """The perturbed flagship fleet of the parity tests (numpy)."""
    return perturbed_flagship(B, SEED, i0, CONTACT_LANES, (TERMINATED_LANE,))


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def to_torch(tree):
    return tree_from_numpy(tree, "cpu", F64)


def jax_np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_close(got, ref, tol, what=""):
    """max|a - b| <= tol * max(1, |b|), elementwise, over matching leaves
    (torch or numpy `got`, numpy `ref`); bool/int leaves must be equal."""
    g = np.asarray(got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
                   else got)
    r = np.asarray(ref)
    assert g.shape == r.shape, (what, g.shape, r.shape)
    if r.dtype.kind in "biu":
        np.testing.assert_array_equal(g, r, err_msg=what)
        return
    err = np.abs(g.astype(np.float64) - r.astype(np.float64))
    lim = tol * np.maximum(1.0, np.abs(r))
    assert np.all(err <= lim), (what, float(np.max(err)),
                                float(np.max(err / lim * tol)))


def assert_tree_close(got, ref, tol, what=""):
    """Compare a torch tree with a numpy/JAX tree of the same dict/tuple
    structure, leaf by leaf in path order."""
    g = tree_leaves_with_path(got)
    r = tree_leaves_with_path(tree_map(
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v),
        ref))
    assert [p for p, _ in g] == [p for p, _ in r], (what, [p for p, _ in g],
                                                     [p for p, _ in r])
    for (path, a), (_, b) in zip(g, r):
        assert_close(a, b, tol, f"{what}{'/'.join(map(str, path))}")


# --------------------------------------------------------------- tests

def test_bridge_roundtrip_keeps_types():
    t, i, x, u, s = perturbed_fleet()
    tree = {"t": t, "i": i, "x": x, "u": u, "s": s}
    back = tree_to_numpy(to_torch(tree))
    for (p, a), (_, b) in zip(tree_leaves_with_path(back),
                              tree_leaves_with_path(tree)):
        assert a.dtype == (np.float64 if b.dtype.kind == "f" else b.dtype), p
        np.testing.assert_array_equal(a, b)


def _csrc(name):
    path = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc", name)
    with open(path) as fh:
        return fh.read()


def _constexprs(src, env):
    for decl in re.findall(r"constexpr int ([^;]+);", src):
        for item in decl.split(","):
            name, expr = item.split("=")
            env[name.strip()] = eval(expr.strip(), {}, dict(env))
    return env


def _enums(src):
    """{enum name: [members]} of the `enum X : int { ... };` blocks."""
    return {name: [m.strip() for m in body.split(",") if m.strip()]
            for name, body in re.findall(r"enum (\w+) : int \{([^}]*)\}",
                                         src)}


def test_kernel_layouts_match_csrc():
    """The Python column maps and the row counts the CUDA sources declare
    agree (the library also reports them at load time on the card)."""
    env = _constexprs(_csrc("flight_math.cuh"), {})
    for name, groups in (("KINAIR_N_IN", K.KINAIR_IN),
                         ("KINAIR_N_OUT", K.KINAIR_OUT),
                         ("DYN_N_IN", K.DYN_IN), ("DYN_N_OUT", K.DYN_OUT),
                         ("FIN_N_IN", K.FIN_IN), ("FIN_N_OUT", K.FIN_OUT)):
        assert env[name] == K.rows(groups), name


def test_system_layouts_match_csrc():
    """The systems kernels' row maps and parameter enums
    (`csrc/c172_systems.cuh`) against `parallel/kernels.py`: row counts,
    the parameter names in order, and the buffer head."""
    src = _csrc("c172_systems.cuh")
    enums = _enums(src)
    env = _constexprs(_csrc("flight_math.cuh"), {})
    for members in enums.values():
        env.update({m: i for i, m in enumerate(members)})
    env = _constexprs(src, env)
    for name, groups in (("SYS_N_IN", K.SYS_IN), ("SYS_N_OUT", K.SYS_OUT),
                         ("FSYS_N_IN", K.FSYS_IN),
                         ("FSYS_N_OUT", K.FSYS_OUT)):
        assert env[name] == K.rows(groups), name
    assert env["N_XSYS"] == K.rows((K.X_SYS,))
    assert env["N_USYS"] == K.rows((K.U_SYS,))
    for enum, prefix, names in (("AeroP", "AE_", K.AERO_P),
                                ("LegP", "LG_", K.LEG_P),
                                ("EngP", "EN_", K.ENG_P),
                                ("PropP", "PR_", K.PROP_P),
                                ("MassP", "MS_", K.MASS_P),
                                ("TableP", "TB_", K.TABLES)):
        members = enums[enum]
        assert members[-1] == prefix + "N", enum
        assert [m[len(prefix):] for m in members[:-1]] == list(names), enum
    from flightjax_torch.models.c172.c172s import build_vehicle
    veh = build_vehicle(device="cpu", dtype=F64)
    scal = K.param_scalars(veh)
    assert [len(v) for v in scal.values()] == [
        len(K.AERO_P), env["N_LEGS"] * len(K.LEG_P), len(K.ENG_P),
        len(K.PROP_P), len(K.MASS_P)]
    buf = K.system_params(veh)
    assert env["P_HEAD"] == sum(map(len, scal.values())) + len(K.TABLES)
    assert buf.dtype == F64 and buf.shape[0] > env["P_HEAD"]


def _decode_lookup(t, x):
    """numpy version of `csrc/flight_math.cuh::lookup` over an encoded
    table `t` at one coordinate tuple `x`."""
    d, nout = int(t[0]), int(t[1])
    heads = [t[2 + 5 * a:7 + 5 * a] for a in range(d)]
    n = [int(h[0]) for h in heads]
    kn = 2 + 5 * d
    vals = np.asarray(t[kn + sum(n):]).reshape(tuple(n) + (nout,))
    idx, w = [], []
    for a, h in enumerate(heads):
        knots = np.asarray(t[kn:kn + n[a]])
        kn += n[a]
        if n[a] == 1:
            idx.append(0)
            w.append(None)
            continue
        if h[2]:
            i = int(min(max(np.floor((x[a] - h[3]) / h[4]), 0), n[a] - 2))
            wa = (x[a] - h[3]) / h[4] - i
        else:
            i = min(max(int(np.sum(knots <= x[a])) - 1, 0), n[a] - 2)
            wa = (x[a] - knots[i]) / (knots[i + 1] - knots[i])
        idx.append(i)
        w.append(wa if h[1] else min(max(wa, 0.0), 1.0))
    out = 0.0
    for c in range(1 << d):
        hi = [(c >> a) & 1 for a in range(d)]
        if any(h and n[a] == 1 for a, h in enumerate(hi)):
            continue
        wt = np.prod([(w[a] if h else 1.0 - w[a]) for a, h in enumerate(hi)
                      if n[a] > 1])
        out = out + vals[tuple(idx[a] + h for a, h in enumerate(hi))] * wt
    return out


def test_encoded_tables_decode_to_the_lookups():
    """Each table of the parameter buffer, read back the way the kernels
    read it, gives its `Lookup`'s values, inside and outside the grid."""
    from flightjax_torch.models.c172.c172s import build_vehicle
    rng = np.random.default_rng(3)
    veh = build_vehicle(device="cpu", dtype=F64)
    for name, lk in K.param_tables(veh).items():
        t = K.encode_table(lk)
        lo = np.array([float(a[0]) for a in lk.axes])
        hi = np.array([float(a[-1]) for a in lk.axes])
        span = np.maximum(hi - lo, 1.0)
        pts = rng.uniform(lo - 0.2 * span, hi + 0.2 * span, (16, len(lo)))
        ref = lk(*[torch.as_tensor(pts[:, a]) for a in range(len(lo))])
        got = np.stack([_decode_lookup(t, p) for p in pts])
        np.testing.assert_allclose(got.reshape(ref.shape), ref.numpy(),
                                   rtol=1e-13, atol=1e-13, err_msg=name)


@pytest.mark.parametrize("groups", ["FIN_OUT", "SYS_IN", "FSYS_OUT"])
def test_pack_unpack_roundtrip(groups):
    rng = np.random.default_rng(0)
    groups = getattr(K, groups)
    n = K.rows(groups)
    buf = torch.as_tensor(rng.normal(size=(n, 5)))
    objs = K.unpack(groups, buf)
    again = K.pack(groups, objs, 5)
    assert torch.equal(again, buf)


@pytest.mark.parametrize("bad", ["device", "dtype", "shape", "contiguous"])
def test_launch_rejects_bad_operands(bad):
    from flightjax_torch.parallel.launch import check_operand
    t = torch.zeros((4, 3), dtype=F64)
    kw = dict(n_rows=4, B=3, dtype=F64, device=t.device)
    if bad == "device":
        kw["device"] = torch.device("meta")
    elif bad == "dtype":
        kw["dtype"] = torch.float32
    elif bad == "shape":
        kw["B"] = 4
    else:
        t = torch.zeros((3, 4), dtype=F64).t()
    with pytest.raises(ValueError):
        check_operand(t, **kw)


def test_sass_digests_hold_an_instance_to_its_form_before(monkeypatch,
                                                          tmp_path):
    """`tools/sass_torch_kernels.py` keys each kernel section by its
    instance (the ActKind template argument read, not kept in the name),
    digests only the instructions (not their addresses and encodings), and
    tells a changed instruction apart."""
    import importlib.util
    import subprocess
    spec = importlib.util.spec_from_file_location("sass_torch_kernels", (
        os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                     "sass_torch_kernels.py")))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)

    def dump(kernel_name, instr):
        return (f"\tcode for sm_90a\n\t\tFunction : {kernel_name}\n"
                f"        /*0000*/   {instr} ;   /* 0x000fe4 */\n"
                f"        /*0010*/   EXIT ;   /* 0x000fe5 */\n")

    before = "_Z17megakernel_kernelIN2fj6StrictIfEEEvPKT_"
    after = "_Z17megakernel_kernelILi0EN2fj6StrictIfEEEvPKT0_"
    fbw = "_Z17megakernel_kernelILi1EN2fj6StrictIdEEEvPKT0_"
    outs = iter([dump(before, "MOV R1, c[0x0][0x28]"),
                 dump(after, "MOV R1, c[0x0][0x28]")
                 + dump(fbw, "MOV R2, R3"),
                 dump(after, "MOV R1, c[0x0][0x30]")])
    monkeypatch.setattr(subprocess, "run", lambda *a, **k: type(
        "R", (), {"stdout": next(outs)})())
    a, b, c = (S.digests("lib.so", "/cuda/bin/nvcc") for _ in range(3))
    assert set(a) == {"megakernel_f32"}
    assert set(b) == {"megakernel_f32", "megakernel_fbw_f64"}
    assert a["megakernel_f32"] == b["megakernel_f32"] != c["megakernel_f32"]


def test_pass_bound_counts_what_the_modes_enable():
    """`chip_smoke.py` bounds `ctl_laws` and `megakernel_fbw` by the
    operations the kernels do of the control laws' pass
    (`pass_op_weights`), not by the plain pass, which works out every
    sub-controller on every lane and selects: on the mode-rich operands
    nothing counts where the pass does not fire, the masked selects count
    nothing, the lanes' counts sum to the fleet's, lanes of the same modes
    and mode changes count alike, and a lane in the direct modes counts
    only the mode logic, the least of all."""
    import importlib.util
    from flightjax_torch.core.modeling import tree_where
    from flightjax_torch.testing import ctl_laws_args
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    batch = 24
    args = ctl_laws_args(batch, 1016, "cpu", torch.float64, (3, 17))
    s_out = K.ctl_laws_plain(*args)[0]

    def ops(fires=None):
        return S.count_ops(lambda: K.ctl_laws_plain(*args),
                           S.pass_op_weights(args[0], args[3], s_out, fires))

    fleet = ops()
    assert 0 < fleet < S.count_ops(lambda: K.ctl_laws_plain(*args))
    assert ops(torch.zeros(batch, dtype=torch.bool)) == 0
    mask = torch.arange(batch) % 2 == 0
    assert S.count_ops(lambda: tree_where(mask, s_out, args[3]),
                       S.pass_op_weights(args[0], args[3], s_out)) == 0
    lone = [ops(torch.arange(batch) == k) for k in range(batch)]
    assert abs(sum(lone) - fleet) <= batch
    # (lon mode, lat mode, lon changed, lat changed) of each lane
    mode = [s_out[side]["mode_prev"] for side in ("lon", "lat")]
    changed = [m != args[3][side]["mode_prev"]
               for m, side in zip(mode, ("lon", "lat"))]
    key = list(zip(*(t.tolist() for t in mode + changed)))
    by_key = {}
    for k in range(batch):
        by_key.setdefault(key[k], set()).add(lone[k])
    assert all(max(v) - min(v) <= 1 for v in by_key.values()), by_key
    direct = [lone[k] for k in range(batch) if key[k][:2] == (0, 0)]
    assert direct and max(direct) <= min(lone)


def test_guidance_bound_counts_the_branch_each_mode_selects():
    """`chip_smoke.py` bounds `gdc_ctl_laws` and `megakernel_gdc` by the
    operations the kernels do of the guidance (`pass_op_weights` with
    `gdc_lanes`): the segment branch on the lanes that work it out, the
    circle branch on theirs, the mode logic and the selects on every firing
    lane; the plain guidance works out both everywhere. The counts add up:
    both branches on every lane and on none count as much as each branch
    alone on every lane; nothing counts where the pass does not fire."""
    import importlib.util
    from flightjax_torch.testing import gdc_laws_args
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    batch = 24
    args = gdc_laws_args(batch, 1016, "cpu", torch.float64, (3, 17))
    s_out, _, g = K.gdc_ctl_laws_plain(*args)
    yes, no = (torch.ones(batch, dtype=torch.bool),
               torch.zeros(batch, dtype=torch.bool))

    def ops(lanes, fires=None):
        return S.count_ops(lambda: K.gdc_ctl_laws_plain(*args),
                           S.pass_op_weights(args[0], args[3], s_out, fires,
                                             lanes))

    full, none = ops((yes, yes)), ops((no, no))
    seg, crc = ops((yes, no)), ops((no, yes))
    assert abs(seg + crc - (full + none)) <= 2
    assert none < seg < full and none < crc < full
    fleet = ops(S.gdc_branches(None, g["mode"]))
    assert none < fleet < full
    assert fleet < S.count_ops(lambda: K.gdc_ctl_laws_plain(*args))
    assert ops((yes, yes), no) == 0
    # the megakernel works out only the lanes whose guidance is requested
    seg_m, crc_m = S.gdc_branches(args[2]["gdc"], g["mode"])
    seg_k, crc_k = S.gdc_branches(None, g["mode"])
    assert bool((seg_m <= seg_k).all() and (crc_m <= crc_k).all())
    assert int(seg_m.sum() + crc_m.sum()) < batch


def test_count_ops_counts_matrix_products_when_asked():
    """`chip_smoke.py`'s operation count takes 2 m n k for each matrix
    product of m x k by k x n where it is asked to (the navigation
    filter's algebra), and nothing for it otherwise."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(
        os.path.dirname(__file__), os.pardir, "chip_smoke.py"))
    S = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(S)
    a, b = torch.ones(4, 3, 5), torch.ones(4, 5, 2)
    assert S.count_ops(lambda: a @ b) == 0
    assert S.count_ops(lambda: a @ b, matmul=True) == 2 * 4 * 3 * 5 * 2
    assert S.count_ops(lambda: a[0] @ b[0] + 1.0, matmul=True) == (
        2 * 3 * 5 * 2 + 3 * 2)


def test_nav_hold_takes_rounding_and_refuses_faults():
    """`testing.nav_hold`, the navigation kernels' check: a run equal to
    the plain one passes; a latched alarm that the plain run has not, on a
    lane whose NIS lies far from its gate, fails in float32 as in float64,
    and so does a filter state off by more than 1e-12 of the reference in
    float64, or a P off by more than its tolerance."""
    from flightjax_torch.parallel import kernels as K
    from flightjax_torch.testing import (nav_hold, nav_operand_state,
                                         nav_pass_args)
    sim, st = nav_operand_state(8, 1016, "cpu", torch.float64)
    args = nav_pass_args(sim, st)
    ref = K.nav_pass_plain(*args)
    nav = args[0]
    for dtype in (torch.float64, torch.float32):
        nav_hold(dtype, ref, ref, ref, ref[0], ref[0], nav)
    bad = K.nav_pass_plain(*args)
    bad[0]["mon_baro"]["alarm"][6] = ~bad[0]["mon_baro"]["alarm"][6]
    bad[0]["nis"]["baro"][6] = 3.0 * nav.baro_gate
    for dtype in (torch.float64, torch.float32):
        with pytest.raises(AssertionError, match="integers or flags"):
            nav_hold(dtype, bad, ref, ref, bad[0], ref[0], nav)
    off = K.nav_pass_plain(*args)
    off[0]["nav"].v_n[2] += 1e-3
    with pytest.raises(AssertionError, match="v_n"):
        nav_hold(torch.float64, off, ref, ref, off[0], ref[0], nav)
    p_off = K.nav_pass_plain(*args)
    p_off[0]["nav"].P[3, 4, 4] *= 1.0 + 1e-9
    with pytest.raises(AssertionError, match="P"):
        nav_hold(torch.float64, p_off, ref, ref, p_off[0], ref[0], nav)
