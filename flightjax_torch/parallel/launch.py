"""Launch harness for the hand-written CUDA kernels (the role
`flightjax/parallel/pallas_block.py` plays for the TPU kernels).

The kernels under `flightjax_torch/csrc/` have a plain C interface. At first
use they are compiled by `nvcc` for `sm_90a` into one shared library in
`flightjax_torch/_build/` (keyed by a hash of the sources and flags) and
loaded with `ctypes`. Tensors cross as device pointers, the stream as
PyTorch's current stream. Each kernel reads and writes batch-minor
`[n_fields, B]` buffers, so neighbouring threads (aircraft) touch
neighbouring addresses.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         os.pardir, "_build")

# default IEEE sqrt/division and math library (no --use_fast_math): the
# kernels' own arithmetic avoids FMA contraction through Strict<F> (see
# csrc/flight_math.cuh), the library calls stay those PyTorch's ops make
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

# threads per block of the kernels that carry one aircraft per thread
# (dynamics, geoid); 4096 aircraft in 128-thread blocks occupy 32 of the
# H100's 132 SMs
BLOCK = 128
# aircraft (lanes) per block of the role kernels, which carry one aircraft
# in several threads, one warp per role (kinair's roles in
# csrc/flight_math.cuh, which finish_kin runs too; finish_sys's legs and
# rest in csrc/finish_sys.cu; the subsystem roles of the others in
# csrc/c172_systems.cuh): a multiple of 32 up to 64. At 32, 4096 aircraft
# are 128 blocks, one block on each of 128 SMs (see PERF.md)
LANES = 32
# the instances of the systems kernels for the fly-by-wire C172 (its seven
# servo states and their commands), built from the same sources as their
# mechanical twins (csrc/c172_systems.cuh, `ActKind`)
FBW_KERNELS = ("systems_fbw", "finish_sys_fbw", "rk4_stage_fbw",
               "rk4_finish_fbw")
# the avionics' instances: the whole step with the C172Xv1's control laws,
# with the C172Xv2's guidance and control laws and with a scripted mission
# over them, and their passes as kernels of their own
AV_KERNELS = ("megakernel_fbw", "ctl_laws", "megakernel_gdc", "gdc_ctl_laws",
              "megakernel_msn", "msn_ctl_laws")
# the instances for the C172S with Dryden turbulence (csrc/turbulence.cuh):
# the whole-vehicle kernels and the megakernel
TURB_KERNELS = ("rk4_stage_turb", "rk4_finish_turb", "megakernel_turb")
# and for the turbulent fly-by-wire C172X (the C172Xv1 of the navigation
# fleet): the whole-vehicle kernels and the megakernel with its control laws
FBW_TURB_KERNELS = ("rk4_stage_fbw_turb", "rk4_finish_fbw_turb",
                    "megakernel_fbw_turb")
# and for the sensor-fed C172Xv1 (the navigation avionics around its control
# laws, csrc/nav.cuh): their pass as a kernel of its own, which the splits
# launch, and the megakernel's instances, calm and turbulent; and the calm
# sensor-fed C172Xv2's megakernel (the navigation avionics around its
# guidance and control laws)
NAV_KERNELS = ("nav_pass", "megakernel_nav", "megakernel_nav_turb",
               "megakernel_gdc_nav")
# the megakernel's instances over the turbulent C172Xv2 and a mission flown
# on it (their splits run the FBW_TURB_KERNELS)
GDC_TURB_KERNELS = ("megakernel_gdc_turb", "megakernel_msn_turb")
# the sensor-fed missions: the megakernel's instance and the mission's pass
# on the estimates, which the splits launch after `nav_pass`
MSN_NAV_KERNELS = ("megakernel_msn_nav", "msn_nav_ctl_laws")
# the megakernel's instances over the sensor-fed C172Xv2 in turbulence and a
# mission flown on it (their splits run the FBW_TURB_KERNELS, `nav_pass`
# and the passes on the estimates)
NAV_TURB_KERNELS = ("megakernel_gdc_nav_turb", "megakernel_msn_nav_turb")
ROLE_KERNELS = ("kinair", "finish_kin", "systems", "finish_sys", "rk4_stage",
                "rk4_finish", "megakernel", *FBW_KERNELS, *AV_KERNELS,
                *TURB_KERNELS, *FBW_TURB_KERNELS, *NAV_KERNELS,
                *GDC_TURB_KERNELS, *MSN_NAV_KERNELS, *NAV_TURB_KERNELS)
# the role kernels that copy the parameter buffer into shared memory and so
# take its length; finish_sys and rk4_finish read their few scalars through
# the read-only cache (csrc/finish_sys.cu, csrc/rk4_finish.cu)
COPY_PARAMS = ("systems", "rk4_stage", "megakernel", "systems_fbw",
               "rk4_stage_fbw", "megakernel_fbw", "megakernel_gdc",
               "megakernel_msn", "rk4_stage_turb", "megakernel_turb",
               "rk4_stage_fbw_turb", "megakernel_fbw_turb", "megakernel_nav",
               "megakernel_nav_turb", "megakernel_gdc_nav",
               *GDC_TURB_KERNELS, "megakernel_msn_nav", *NAV_TURB_KERNELS)

# values at the head of the geoid grid buffer (csrc/flight_math.cuh)
GEO_HEAD = 6
# the gain tables at the head of the control laws' buffer
# (csrc/c172x_ctl.cuh)
N_GAIN_TABLES = 10

KERNELS = ("kinair", "dynamics", "finish_kin", "systems", "finish_sys",
           "rk4_stage", "rk4_finish", "geoid", "megakernel", *FBW_KERNELS,
           *AV_KERNELS, *TURB_KERNELS, *FBW_TURB_KERNELS, *NAV_KERNELS,
           *GDC_TURB_KERNELS, *MSN_NAV_KERNELS, *NAV_TURB_KERNELS)
# kernels that take a second [n_x, B] operand (k_prev or the k-sum), the
# systems' parameter buffer, the geoid grid, the int32 [3, B] rows (step
# counter, stream seed, drive counter) of the turbulent vehicle
WITH_K = ("rk4_stage", "rk4_finish", "rk4_stage_fbw", "rk4_finish_fbw",
          "rk4_stage_turb", "rk4_finish_turb", "rk4_stage_fbw_turb",
          "rk4_finish_fbw_turb")
WITH_PARAMS = ("systems", "finish_sys", "rk4_stage", "rk4_finish",
               "megakernel", *FBW_KERNELS, *TURB_KERNELS, *FBW_TURB_KERNELS)
WITH_GRID = ("geoid", "megakernel", "megakernel_turb", "megakernel_fbw_turb")
WITH_GAINS = ("ctl_laws", "gdc_ctl_laws", "msn_ctl_laws", "msn_nav_ctl_laws")
WITH_INTS = ("rk4_finish_turb", "rk4_finish_fbw_turb")
# rows of the turbulent vehicle's int32 operand
N_TURB_INT = 3
# rows of the navigation avionics' int32 operand (NAV_INT of csrc/nav.cuh),
# and of the work buffer of their 15 x 15 algebra
N_NAV_INT, N_NAV_WORK = 11, 1556

_LIB = None
_LOCK = threading.Lock()
BUILD_INFO = {}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    names = sorted(n for n in os.listdir(CSRC)
                   if n.endswith(".cu") or n.endswith(".cuh"))
    return [os.path.join(CSRC, n) for n in names]


def _compile(src, obj):
    """Start nvcc on one source; returns (command, process)."""
    cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def build():
    """Compile the kernels if the library for the current sources is not
    built yet; returns its path. Every source compiles in its own nvcc, all
    at once, then one link. Raises with nvcc's output on failure."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as fh:
            h.update(os.path.basename(p).encode() + fh.read())
    key = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"flight_kernels_{key}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{key}.{os.getpid()}"
    jobs = [_compile(p, os.path.join(
        BUILD_DIR, f"{os.path.basename(p)[:-3]}_{tag}.o"))
        for p in srcs if p.endswith(".cu")]
    log, failed = [], []
    t0 = time.time()
    for cmd, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        log.append(f"nvcc {os.path.basename(cmd[-1])}: done by "
                   f"{time.time() - t0:.1f} s")
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{out}")
    objs = [cmd[-2] for cmd, _ in jobs]
    if not failed:
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *LINK_FLAGS, "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}"
                          f"{proc.stderr}")
    with open(so[:-3] + ".log", "w") as fh:
        fh.write("\n".join(log))
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = build()
            lib = ctypes.CDLL(so)
            P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
            for name in (*KERNELS, "systems_params", "systems_fbw_params",
                         "systems_turb_params", "systems_fbw_turb_params"):
                f = getattr(lib, f"{name}_layout")
                f.argtypes = [ctypes.POINTER(I), ctypes.POINTER(I)]
                f.restype = None
            for f in (lib.vehicle_layout, lib.vehicle_fbw_layout,
                      lib.vehicle_turb_layout, lib.vehicle_fbw_turb_layout):
                f.argtypes = [ctypes.POINTER(I)] * 4
                f.restype = None
            sig = {"kinair": [P, P, I, D, I, P],
                   "dynamics": [P, P, I, I, P],
                   "finish_kin": [P, P, I, D, I, I, P],
                   "systems": [P, P, P, I, I, D, I, P],
                   "finish_sys": [P, P, P, I, D, I, P],
                   "rk4_stage": [P, P, P, P, I, I, D, I, P],
                   "rk4_finish": [P, P, P, P, I, D, I, I, P],
                   "geoid": [P, P, P, I, I, P],
                   "megakernel": [P, P, P, P, P, P, I, I, D, D, I, I, P],
                   "megakernel_fbw": [P, P, P, P, P, P, P, I, I, D, D, I, I,
                                      D, I, P],
                   "ctl_laws": [P, P, P, I, D, I, P]}
            sig.update({k: sig[k[:-len("_fbw")]] for k in FBW_KERNELS})
            sig.update(megakernel_gdc=sig["megakernel_fbw"],
                       gdc_ctl_laws=sig["ctl_laws"],
                       megakernel_msn=sig["megakernel_fbw"],
                       msn_ctl_laws=sig["ctl_laws"],
                       msn_nav_ctl_laws=sig["ctl_laws"],
                       rk4_stage_turb=sig["rk4_stage"],
                       rk4_finish_turb=[P, P, P, P, P, I, D, I, D, D, I, P],
                       megakernel_turb=sig["megakernel"],
                       rk4_stage_fbw_turb=sig["rk4_stage"],
                       megakernel_fbw_turb=sig["megakernel_fbw"],
                       megakernel_gdc_turb=sig["megakernel_fbw"],
                       megakernel_msn_turb=sig["megakernel_fbw"])
            sig["rk4_finish_fbw_turb"] = sig["rk4_finish_turb"]
            sig["nav_pass"] = [P] * 7 + [I, I, I, P]
            for name in ("megakernel_nav", "megakernel_nav_turb",
                         "megakernel_gdc_nav", "megakernel_msn_nav",
                         *NAV_TURB_KERNELS):
                sig[name] = [P] * 9 + [I, I, D, D, I, I, D, I, P]
            for name, argtypes in sig.items():
                for suffix in ("f32", "f64"):
                    f = getattr(lib, f"{name}_{suffix}")
                    f.argtypes = argtypes
                    f.restype = I
            for name in ROLE_KERNELS:
                f = getattr(lib, f"{name}_launch_shape")
                f.argtypes = [I] * 4 + [ctypes.POINTER(I)] * 3
                f.restype = None
            lib.nav_rows.argtypes = [ctypes.POINTER(I)] * 6
            lib.nav_rows.restype = None
            lib.empty_launch.argtypes = [I, I, I, P]
            lib.empty_launch.restype = I
            BUILD_INFO["so"] = so
            BUILD_INFO["log"] = so[:-3] + ".log"
            _LIB = lib
        return _LIB


_LAYOUTS = {}


def layout(name):
    """(n_in, n_out) rows as the compiled kernel declares them."""
    if name not in _LAYOUTS:
        n_in, n_out = ctypes.c_int(), ctypes.c_int()
        getattr(library(), f"{name}_layout")(ctypes.byref(n_in),
                                             ctypes.byref(n_out))
        _LAYOUTS[name] = n_in.value, n_out.value
    return _LAYOUTS[name]


def vehicle_layout(fbw=False, turb=False):
    """{x, ctx, c, mega}: rows of the whole-vehicle groups X, CTX, C and of
    the megakernel's state buffer, as the compiled kernels declare them,
    for the mechanical C172, with `fbw` the fly-by-wire one, with `turb`
    the turbulent C172S, with both the turbulent fly-by-wire C172X (its
    megakernel with the control laws)."""
    key = "vehicle" + ("_fbw" if fbw else "") + ("_turb" if turb else "")
    if key not in _LAYOUTS:
        v = [ctypes.c_int() for _ in range(4)]
        getattr(library(), f"{key}_layout")(*map(ctypes.byref, v))
        _LAYOUTS[key] = dict(zip(("x", "ctx", "c", "mega"),
                                 (i.value for i in v)))
    return _LAYOUTS[key]


def check_operand(t, n_rows, B, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError("kernel operand must be a tensor")
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"kernel operand on {t.device}/{t.dtype}, "
                         f"expected {device}/{dtype}")
    if tuple(t.shape) != (n_rows, B):
        raise ValueError(f"kernel operand shape {tuple(t.shape)}, "
                         f"expected {(n_rows, B)}")
    if not t.is_contiguous():
        raise ValueError("kernel operand must be contiguous")


def check_params(params, dtype, device, fbw=False, turb=False):
    """The C172 systems' parameter buffer (`kernels.system_params`): a
    contiguous 1-D tensor at least as long as the head the kernels (the
    fly-by-wire instances with `fbw`, the turbulent ones with `turb`)
    read."""
    if not isinstance(params, torch.Tensor):
        raise TypeError("kernel parameters must be a tensor")
    if params.device != device or params.dtype != dtype:
        raise ValueError(f"kernel parameters on {params.device}/"
                         f"{params.dtype}, expected {device}/{dtype}")
    n_head, _ = layout("systems" + ("_fbw" if fbw else "")
                       + ("_turb" if turb else "") + "_params")
    if params.dim() != 1 or params.shape[0] < n_head:
        raise ValueError(f"kernel parameters of shape {tuple(params.shape)}"
                         f", the head alone has {n_head}")
    if not params.is_contiguous():
        raise ValueError("kernel parameters must be contiguous")
    if params.data_ptr() % 16:  # the role kernels copy them 16 bytes a turn
        raise ValueError("kernel parameters must be 16-byte aligned")


def check_grid(grid, dtype, device):
    """The EGM96 grid buffer (`kernels.geoid_grid`): a contiguous
    `[n_lat + 1, n_lon]` tensor, its head in row 0."""
    if not isinstance(grid, torch.Tensor):
        raise TypeError("geoid grid must be a tensor")
    if grid.device != device or grid.dtype != dtype:
        raise ValueError(f"geoid grid on {grid.device}/{grid.dtype}, "
                         f"expected {device}/{dtype}")
    if grid.dim() != 2 or grid.shape[0] < 3 or grid.shape[1] < GEO_HEAD:
        raise ValueError(f"geoid grid of shape {tuple(grid.shape)}, "
                         f"expected [n_lat + 1, n_lon]")
    if not grid.is_contiguous():
        raise ValueError("geoid grid must be contiguous")


def check_gains(gains, dtype, device):
    """The control laws' gain buffer (`kernels.ctl_gains`): a contiguous
    1-D tensor that holds at least its table offsets."""
    if not isinstance(gains, torch.Tensor):
        raise TypeError("control-law gains must be a tensor")
    if gains.device != device or gains.dtype != dtype:
        raise ValueError(f"control-law gains on {gains.device}/"
                         f"{gains.dtype}, expected {device}/{dtype}")
    if gains.dim() != 1 or gains.shape[0] <= N_GAIN_TABLES:
        raise ValueError(f"control-law gains of shape {tuple(gains.shape)}")
    if not gains.is_contiguous():
        raise ValueError("control-law gains must be contiguous")


def _fn(name, dtype, device):
    if device.type != "cuda":
        raise ValueError("launch needs a CUDA tensor")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    return getattr(library(),
                   f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")


def _run(name, fn, args, block):
    """`block`: threads per block, or for the ROLE_KERNELS aircraft per
    block; None takes BLOCK or LANES."""
    stream = torch.cuda.current_stream().cuda_stream
    if block is None:
        block = LANES if name in ROLE_KERNELS else BLOCK
    err = fn(*args, int(block), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def role_launch_shape(name, B, lanes, n_params, elem_size):
    """(grid, threads per block, dynamic shared bytes) of the launch of
    role kernel `name` for B aircraft at `lanes` per block, with a
    parameter buffer of n_params values of elem_size bytes."""
    v = [ctypes.c_int() for _ in range(3)]
    getattr(library(), f"{name}_launch_shape")(B, lanes, n_params, elem_size,
                                               *map(ctypes.byref, v))
    return tuple(i.value for i in v)


def launch_empty(grid, block, shared):
    """Launch the kernel that does nothing, on the current stream."""
    err = library().empty_launch(grid, block, shared,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def launch(name, packed_in, n_out, scalars, block=None, params=None, k=None,
           grid=None, gains=None, ints=None):
    """Run kernel `name` on a packed `[n_in, B]` CUDA tensor, with its
    other operands: `k` (k_prev or the k-sum, `[n_x, B]`) for the two RK4
    kernels, the parameter buffer for the kernels of the C172 systems, the
    geoid grid for `geoid`, the control laws' gains for `ctl_laws`,
    `gdc_ctl_laws`, `msn_ctl_laws` and `msn_nav_ctl_laws` (with the
    mission table for the last two, `kernels.ctl_gains`), the int32 `[3, B]` rows (i, seed, n) for
    `rk4_finish_turb` and `rk4_finish_fbw_turb`.
    Returns the packed `[n_out, B]` output. Does not synchronise."""
    dtype, device = packed_in.dtype, packed_in.device
    fn = _fn(name, dtype, device)
    n_in, n_out_k = layout(name)
    B = packed_in.shape[1]
    check_operand(packed_in, n_in, B, dtype, device)
    if n_out != n_out_k:
        raise ValueError(f"{name}: {n_out} output rows, kernel has {n_out_k}")
    ptrs = [packed_in.data_ptr()]
    for key, val, kernels in (("k", k, WITH_K), ("params", params,
                                                 WITH_PARAMS),
                              ("grid", grid, WITH_GRID),
                              ("gains", gains, WITH_GAINS),
                              ("ints", ints, WITH_INTS)):
        if (name in kernels) != (val is not None):
            raise ValueError(f"{name}: operand {key} "
                             + ("missing" if val is None else "not taken"))
    fbw = name in FBW_KERNELS or name in FBW_TURB_KERNELS
    turb = name in TURB_KERNELS or name in FBW_TURB_KERNELS
    if k is not None:
        check_operand(k, vehicle_layout(fbw, turb)["x"], B, dtype, device)
        ptrs.append(k.data_ptr())
    if params is not None:
        check_params(params, dtype, device, fbw, turb)
        ptrs.append(params.data_ptr())
    if ints is not None:
        check_operand(ints, N_TURB_INT, B, torch.int32, device)
        ptrs.append(ints.data_ptr())
    if grid is not None:
        check_grid(grid, dtype, device)
        ptrs.append(grid.data_ptr())
    if gains is not None:
        check_gains(gains, dtype, device)
        ptrs.append(gains.data_ptr())
    out = torch.empty((n_out, B), dtype=dtype, device=device)
    if name in COPY_PARAMS:
        scalars = (params.numel(), *scalars)
    _run(name, fn, (*ptrs, out.data_ptr(), B, *scalars), block)
    return out


def nav_rows():
    """{u, s, i, t, work, params}: the rows of the navigation blocks NAV_U,
    NAV_S, NAV_INT, NAV_T, of the work buffer and the length of the filter's
    parameter block, as the compiled kernels declare them."""
    if "nav" not in _LAYOUTS:
        v = [ctypes.c_int() for _ in range(6)]
        library().nav_rows(*map(ctypes.byref, v))
        _LAYOUTS["nav"] = dict(zip(("u", "s", "i", "t", "work", "params"),
                                   (x.value for x in v)))
    return _LAYOUTS["nav"]


def check_table(table, device):
    """The sensors' normal table (`ops/random.normal_table`): 2^23 float32
    values on the device."""
    if not isinstance(table, torch.Tensor):
        raise TypeError("the normal table must be a tensor")
    if (table.device != device or table.dtype != torch.float32
            or tuple(table.shape) != (2 ** 23,) or not table.is_contiguous()):
        raise ValueError(f"normal table {tuple(table.shape)} "
                         f"{table.dtype} on {table.device}, expected "
                         f"(2^23,) float32 on {device}")


def _nav_work(B, dtype, device):
    if nav_rows()["work"] != N_NAV_WORK:
        raise ValueError(f"the kernels' work buffer has {nav_rows()['work']}"
                         f" rows, the harness {N_NAV_WORK}")
    return torch.empty((N_NAV_WORK, B), dtype=dtype, device=device)


def launch_nav_pass(packed_in, n_out, ints, gains, table, block=None,
                    ho=False):
    """The navigation pass `nav_pass` on a packed `[n_in, B]` CUDA tensor
    (csrc/nav_pass.cu), with the NAV_INT rows `ints` (int32 `[11, B]`), the
    gains holding the filter's constants and the normal table; a work
    buffer for the filter's matrices is allocated here. With `ho` (around a
    mission) its instance that also writes the orthometric height the
    mission's radar gate reads, one row after the others. Returns the
    packed `[n_out, B]` output and the new int32 rows. `block` is the
    aircraft per block (32 or 64). Does not synchronise."""
    dtype, device = packed_in.dtype, packed_in.device
    fn = _fn("nav_pass", dtype, device)
    n_in, n_out_k = layout("nav_pass")
    n_out_k += int(bool(ho))
    B = packed_in.shape[1]
    check_operand(packed_in, n_in, B, dtype, device)
    if n_out != n_out_k:
        raise ValueError(f"nav_pass: {n_out} output rows, kernel has "
                         f"{n_out_k}")
    check_operand(ints, N_NAV_INT, B, torch.int32, device)
    check_gains(gains, dtype, device)
    check_table(table, device)
    work = _nav_work(B, dtype, device)
    out = torch.empty((n_out, B), dtype=dtype, device=device)
    i_out = torch.empty_like(ints)
    _run("nav_pass", fn, (packed_in.data_ptr(), ints.data_ptr(),
                          gains.data_ptr(), table.data_ptr(),
                          work.data_ptr(), out.data_ptr(), i_out.data_ptr(),
                          B, int(bool(ho))), block)
    return out, i_out


def launch_megakernel(state, i, params, grid, dt, t_start, comp, block=None,
                      gains=None, spp=1, periodic_dt=0.0, gdc=False,
                      msn=False, turb=False, table=None):
    """One whole step on the megakernel's resident state: `state` is the
    `[mega, B]` buffer, `i` the int32 `[1, B]` step counter. Returns the
    new (state, i) in fresh buffers. `block` is the aircraft per block.
    With the control laws' `gains` the fly-by-wire instance
    `megakernel_fbw`, whose periodic pass fires every `spp` steps at
    `periodic_dt`, with `gdc` the C172Xv2's `megakernel_gdc`, whose pass
    runs the guidance first, or with `msn` a mission's `megakernel_msn`,
    whose pass runs the phase machine first (its gains hold the mission
    table), or with `turb` the turbulent C172S's `megakernel_turb`, whose
    `i` is the int32 `[3, B]` rows (i, seed, n), with `turb` and the gains
    the turbulent C172Xv1's `megakernel_fbw_turb`, whose `i` is those rows
    too, and with `gdc` or `msn` the turbulent C172Xv2's
    `megakernel_gdc_turb` or `megakernel_msn_turb`. With the sensors'
    normal `table` (and the gains of the navigation avionics,
    `kernels.ctl_gains`) the sensor-fed C172Xv1's `megakernel_nav`, with
    `turb` its `megakernel_nav_turb`, with `gdc` the calm sensor-fed
    C172Xv2's `megakernel_gdc_nav`, with `msn` the calm sensor-fed
    missions' `megakernel_msn_nav` (its gains hold the filter's constants,
    then the mission table), and with `turb` too the turbulent C172Xv2's
    and missions' `megakernel_gdc_nav_turb` and `megakernel_msn_nav_turb`,
    whose `i` also holds the NAV_INT rows (`[1 + 11, B]`; turbulent
    `[3 + 11, B]`: i, seed, n, then NAV_INT); their work buffer is
    allocated here. Does not synchronise."""
    fbw = gains is not None
    nav = table is not None
    if (gdc or msn or nav) and not fbw:
        raise ValueError("the avionics' megakernels take the control laws' "
                         "gains")
    name = ("megakernel_msn_nav" + "_turb" * turb if msn and nav
            else "megakernel_msn" + "_turb" * turb if msn
            else "megakernel_gdc_nav" + "_turb" * turb if gdc and nav
            else "megakernel_gdc" + "_turb" * turb if gdc
            else "megakernel_nav_turb" if nav and turb
            else "megakernel_nav" if nav
            else "megakernel_fbw_turb" if fbw and turb
            else "megakernel_fbw" if fbw else "megakernel_turb" if turb
            else "megakernel")
    dtype, device = state.dtype, state.device
    fn = _fn(name, dtype, device)
    B = state.shape[1]
    check_operand(state, layout(name)[0], B, dtype, device)
    check_operand(i, (N_TURB_INT if turb else 1) + (N_NAV_INT if nav else 0),
                  B, torch.int32, device)
    check_params(params, dtype, device, fbw, turb)
    check_grid(grid, dtype, device)
    out, i_out = torch.empty_like(state), torch.empty_like(i)
    ptrs = [state.data_ptr(), i.data_ptr(), params.data_ptr(),
            grid.data_ptr()]
    tail = ()
    if fbw:
        check_gains(gains, dtype, device)
        if int(spp) < 1:
            raise ValueError(f"steps per periodic pass {spp} < 1")
        ptrs.append(gains.data_ptr())
        tail = (int(spp), float(periodic_dt))
    if nav:
        check_table(table, device)
        ptrs += [table.data_ptr(), _nav_work(B, dtype, device).data_ptr()]
    _run(name, fn, (*ptrs, out.data_ptr(), i_out.data_ptr(), B,
                    params.numel(), float(dt), float(t_start),
                    int(bool(comp)), *tail), block)
    return out, i_out
