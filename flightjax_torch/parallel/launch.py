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

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir,
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         os.pardir, "_build")

# default IEEE sqrt/division and math library (no --use_fast_math): the
# kernels' own arithmetic avoids FMA contraction through Strict<F> (see
# csrc/flight_math.cuh), the library calls stay those PyTorch's ops make
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# threads per block; 4096 aircraft in 128-thread blocks occupy 32 of the
# H100's 132 SMs (see csrc/*.cu headers and PERF.md)
BLOCK = 128

KERNELS = ("kinair", "dynamics", "finish_kin", "systems", "finish_sys")

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


def build():
    """Compile the kernels if the library for the current sources is not
    built yet; returns its path. Raises with nvcc's output on failure."""
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
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[p for p in srcs if p.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(so[:-3] + ".log", "w") as fh:
        fh.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
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
            for name in (*KERNELS, "systems_params"):
                f = getattr(lib, f"{name}_layout")
                f.argtypes = [ctypes.POINTER(I), ctypes.POINTER(I)]
                f.restype = None
            for suffix in ("f32", "f64"):
                f = getattr(lib, f"kinair_{suffix}")
                f.argtypes = [P, P, I, D, I, P]
                f.restype = I
                f = getattr(lib, f"dynamics_{suffix}")
                f.argtypes = [P, P, I, I, P]
                f.restype = I
                f = getattr(lib, f"finish_kin_{suffix}")
                f.argtypes = [P, P, I, D, I, I, P]
                f.restype = I
                for name in ("systems", "finish_sys"):
                    f = getattr(lib, f"{name}_{suffix}")
                    f.argtypes = [P, P, P, I, D, I, P]
                    f.restype = I
            BUILD_INFO["so"] = so
            BUILD_INFO["log"] = so[:-3] + ".log"
            _LIB = lib
        return _LIB


def layout(name):
    """(n_in, n_out) rows as the compiled kernel declares them."""
    n_in, n_out = ctypes.c_int(), ctypes.c_int()
    getattr(library(), f"{name}_layout")(ctypes.byref(n_in),
                                         ctypes.byref(n_out))
    return n_in.value, n_out.value


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


def check_params(params, dtype, device):
    """The C172 systems' parameter buffer (`kernels.system_params`): a
    contiguous 1-D tensor at least as long as the head the kernels read."""
    if not isinstance(params, torch.Tensor):
        raise TypeError("kernel parameters must be a tensor")
    if params.device != device or params.dtype != dtype:
        raise ValueError(f"kernel parameters on {params.device}/"
                         f"{params.dtype}, expected {device}/{dtype}")
    n_head, _ = layout("systems_params")
    if params.dim() != 1 or params.shape[0] < n_head:
        raise ValueError(f"kernel parameters of shape {tuple(params.shape)}"
                         f", the head alone has {n_head}")
    if not params.is_contiguous():
        raise ValueError("kernel parameters must be contiguous")


def launch(name, packed_in, n_out, scalars, block=None, params=None):
    """Run kernel `name` on a packed `[n_in, B]` CUDA tensor (and, for the
    systems kernels, their parameter buffer); returns the packed
    `[n_out, B]` output. Does not synchronise."""
    dtype, device = packed_in.dtype, packed_in.device
    if device.type != "cuda":
        raise ValueError("launch needs a CUDA tensor")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported dtype {dtype}")
    lib = library()
    n_in, n_out_k = layout(name)
    B = packed_in.shape[1]
    check_operand(packed_in, n_in, B, dtype, device)
    if n_out != n_out_k:
        raise ValueError(f"{name}: {n_out} output rows, kernel has {n_out_k}")
    ptrs = [packed_in.data_ptr()]
    if name in ("systems", "finish_sys"):
        check_params(params, dtype, device)
        ptrs.append(params.data_ptr())
    elif params is not None:
        raise ValueError(f"{name} takes no parameter buffer")
    out = torch.empty((n_out, B), dtype=dtype, device=device)
    fn = getattr(lib, f"{name}_{'f32' if dtype == torch.float32 else 'f64'}")
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*ptrs, out.data_ptr(), B, *scalars,
             BLOCK if block is None else int(block), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out
