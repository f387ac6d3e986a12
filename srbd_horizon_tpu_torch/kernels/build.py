"""Build, load and bind the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into its own shared library under `build/kernels/`
(listed in `.gitignore`), then loaded with `ctypes`. The entries, each in
float32 and float64 (`<entry>_f32`, `<entry>_f64`):

  riccati_backward  K1 `riccati_backward`, K2 `spd_inverse`; and, with
                    no type suffix, `riccati_backward_smem_bytes` and
                    `riccati_backward_blocks_per_sm`
  riccati_backward_square_feet  the same entries at the square-feet
                    biped's four shapes (riccati_backward.cu's body,
                    compiled apart so the two build in parallel)
  riccati_backward_line_feet  K1 at the line-feet quadruped's four shapes
                    (the same body, a third library; its `spd_inverse`
                    entry knows no size)
  srbd_rollout      K3 `srbd_trial`, `srbd_evaluate`; and, with no type
                    suffix, `srbd_trial_occupancy`, `srbd_evaluate_occupancy`
  srbd_linearize    K4 `srbd_linearize`; `srbd_linearize_occupancy`
  isrbd_rollout     K6 `isrbd_trial`, `isrbd_evaluate`; and, with no
                    type suffix, `isrbd_trial_occupancy`,
                    `isrbd_evaluate_occupancy`
  isrbd_linearize   K5 `isrbd_linearize`; `isrbd_linearize_occupancy`
  isrbd_al          K7 `isrbd_al_constraints`, K8 `isrbd_al_shift`,
                    `isrbd_al_params`, `isrbd_al_prior_update`; and, with
                    no type suffix, `isrbd_al_constraints_occupancy`
  lip_linearize     K10 `lip_linearize`; `lip_linearize_occupancy`
  lip_rollout       K11 `lip_trial` (and `lip_trial_chain`, its chain
                    alone), `lip_evaluate`; and, with no type suffix,
                    `lip_trial_occupancy`, `lip_evaluate_occupancy`
  riccati_associative  K12 `riccati_associative` (its three phases, launched
                    from one entry); `riccati_associative_occupancy`
  linear_trial      K13 `linear_trial`; `linear_trial_occupancy`

K3, `srbd_evaluate` and K4 include `csrc/srbd_common.cuh`, K5, K6,
`isrbd_evaluate`, K7 and K8 `csrc/isrbd_common.cuh`, and both of those
`csrc/rigid_common.cuh`; K10, K11 and `lip_evaluate` include
`csrc/lip_common.cuh`; K1, K3, K6, K7 and K11 include `csrc/dmma.cuh`
(K11 its bulk copies and mbarriers);
K1 and K12 include `csrc/riccati_common.cuh` (K2's inverse, the Cholesky
routine and the tiles they run on); K13 includes both `srbd_common.cuh` and
`lip_common.cuh`.
`isrbd_al` is compiled with `-fmad=false`: K7 and K8 round each product
and sum on their own, as the plain twins' torch ops do. A change to
any file under `csrc/` rebuilds every library. The build runs at first
use; `build_all` starts one `nvcc` per stale source, all at once. Nothing
here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Callable, Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = ("riccati_backward", "riccati_backward_square_feet",
                  "riccati_backward_line_feet", "srbd_rollout",
                  "srbd_linearize",
                  "isrbd_rollout", "isrbd_linearize", "isrbd_al",
                  "lip_linearize", "lip_rollout", "riccati_associative",
                  "linear_trial")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# flags of one source only
SOURCE_FLAGS = {"isrbd_al": ("-fmad=false",)}

_loaded: Dict[str, ctypes.CDLL] = {}
# seconds from the start of `build_all` to the end of each library's nvcc
build_seconds: Dict[str, float] = {}
_host_setups: Dict[tuple, tuple] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def log_path(name: str) -> Path:
    """nvcc's output for `name`, with ptxas' register/shared-memory report."""
    return BUILD_DIR / f"{name}.log"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    src_time = max(p.stat().st_mtime for p in CSRC.glob("*.cu*"))
    return lib.stat().st_mtime < src_time


def build_all(names: Iterable[str] = KERNEL_SOURCES, force: bool = False) -> Dict[str, Path]:
    """Compile every stale kernel library in parallel; raise with nvcc's
    output if any compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for name in names:
        if not force and not _stale(name):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        # nvcc writes its report (ptxas' lines for every kernel) straight
        # to the log: through a pipe, a long report would stall the
        # compile until the pipe was read
        with open(log_path(name), "w") as log:
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True))
    failed = []
    pending = dict(procs)
    while pending:                       # each compile's own seconds
        for name in [n for n, (_, p) in pending.items() if p.poll() is not None]:
            build_seconds[name] = time.monotonic() - t0
            del pending[name]
        time.sleep(0.2)
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n"
                          f"{log_path(name).read_text()}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def check_tensor(name, t, shape, dtype, device, rows=False):
    """Raise unless `t` is what a kernel takes: on `device`, of `dtype` and
    `shape`, contiguous (the kernels index raw pointers) — or, with
    `rows`, its rows contiguous each, for a kernel that takes the row
    stride of a 2-D `t`."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if rows:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have contiguous rows")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_tensors(items, dtype, device):
    """`check_tensor` on each (name, tensor, shape) of `items`, every
    tensor of `dtype` on `device`: one pass of cheap comparisons, and the
    full check (which raises) only for a tensor that fails them."""
    for name, t, shape in items:
        if (t.dtype != dtype or t.device != device or t.shape != shape
                or not t.is_contiguous()):
            check_tensor(name, t, shape, dtype, device)


OUT_ALIGN = 16                # bytes: where each output starts in its buffer


def layout_of(shapes, dtype):
    """Where outputs of `shapes` ((slot, shape), …) lie in one buffer of
    `dtype`: ((slot, shape, stride, element offset), …) in that order,
    each starting OUT_ALIGN bytes apart from the buffer's start, and the
    buffer's elements."""
    import torch

    step = OUT_ALIGN // (torch.finfo(dtype).bits // 8)
    views, off = [], 0
    for slot, shape in shapes:
        stride, n = [], 1
        for d in reversed(shape):
            stride.insert(0, n)
            n *= d
        views.append((slot, tuple(shape), tuple(stride), off))
        off += -(-n // step) * step
    return tuple(views), off


def output_views(layout, total: int, dtype, device):
    """One `torch.empty` of `total` elements cut into the contiguous views
    of `layout` (`layout_of`): (the buffer, the views)."""
    import torch

    buf = torch.empty(total, dtype=dtype, device=device)
    return buf, [buf.as_strided(shape, stride, off)
                 for _, shape, stride, off in layout]


def out_slots(layout, dtype):
    """(slot, byte offset) of each view of a `layout_of` layout."""
    import torch

    e = torch.finfo(dtype).bits // 8
    return tuple((slot, off * e) for slot, _, _, off in layout)


def launch(name, fn, dev, *args):
    """Call the C entry `fn` on `args` and the current raw stream of `dev`
    (under a device context only where `dev` is not the current device);
    raise RuntimeError on a failed launch."""
    import torch

    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"{name} kernel failed: CUDA error {err}")


def host_setup(terms, key: tuple, make: Callable[[], Any]):
    """`make()`, computed once for each (terms, *key): the host work of a
    wrapper that does not change between its calls, such as its shape
    check and its scalars' ctypes array. A `make` that raises caches
    nothing. The entry holds `terms`, so its id is not reused while the
    entry stands."""
    k = (id(terms),) + key
    hit = _host_setups.get(k)
    if hit is None:
        hit = _host_setups[k] = (terms, make())
    return hit[1]


def clear_host_setups() -> None:
    """Forget every `host_setup` result (the next call of each wrapper
    redoes its host work)."""
    _host_setups.clear()


# the fields an evaluation entry's occupancy query writes, in order
EVALUATE_OCCUPANCY_FIELDS = ("blocks_per_sm", "warps_per_block",
                             "shared_memory_bytes", "registers_per_thread",
                             "local_bytes_per_thread")


def occupancy_query(lib_name: str, entry: str, fields, *args) -> dict:
    """A kernel's occupancy on the current card from the query `entry` of
    `lib<lib_name>.so`, called with the int `args` and an int array it
    fills with len(`fields`) values, named so in the result."""
    fn = getattr(library(lib_name), entry)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(fields))()
    err = fn(*args, out)
    if err != 0:
        raise RuntimeError(f"{entry} failed: error {err}")
    return dict(zip(fields, out))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
