#!/usr/bin/env python3
"""A cycle split of K7 (`isrbd_al_constraints`), in either of its two
designs: the block that stages x, u and the four parameter runs with
one-element `cp.async` copies and reads ρ, the bounds, λ and the μ's from
device memory as it goes (the port before its redesign), or the block
that stages every run the mode reads in one round of 16-byte `cp.async`
copies and reads nothing from device memory after it (since).

    python3 tools/torch_k7_trace.py TREE [TREE ...]

Each TREE holds a kernel source and wrapper (`.` for this checkout, or an
unpacked archive of another commit, e.g. `git archive 80c41b2
srbd_horizon_tpu_torch | tar -x -C TREE` for the first design). For each
tree the script copies `srbd_horizon_tpu_torch/csrc/isrbd_al.cu` with
`clock64()` marks added between the kernel's passes (lane 0 of the first
and of the last warp of the grid's middle block, B/2; one store a mark
into a device array), builds
the copies with nvcc in parallel, runs each through its tree's own
wrapper at the Kangaroo's AL shape at B = 1, 256 and 4096 in the online and
offline modes (float32, static bounds, `chip_smoke.k7_point`) and prints
one JSON line a case: the cycles of each pass on those threads (the last
warp's up to the reduction, which warp 0 finishes) and the traced call's
ms. A pass's loads show where their values are first used.
The marks cost a few cycles each; the copies are not kernels of the port.
Needs a CUDA card and nvcc.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

N_MARKS = 16
# the first design: (text, mark placed right after it; "<": before it)
PARENT_ANCHORS = (
    ("  constexpr bool kOff = kMode == kOffline;\n", 0),
    ("  cp_async_commit();\n  cp_async_wait_all();\n  __syncthreads();\n", 1),
    ("  T vmax = T(0);\n", 2),
    ("      C::node_inertia(s + n * Rec::size + Rec::xu, k, geo + n * kGeo);\n", 3),
    ("<  // the x boxes, every node\n", 4),
    ("<  // the u boxes, the stage nodes\n", 5),
    ("<  __syncthreads();                                   // the geometry is in\n", 6),
    ("  __syncthreads();                                   // the geometry is in\n", 7),
    ("<  // the terminal equalities hT = S_T·h_raw,T, and λ_T + (ρw_T)·hT\n", 8),
    ("<  // the member's violation, then the penalty schedule\n", 9),
    ("    v = isrbd::warp_nan_max(v);\n", 10),
    ("        P.out[O_RHO][b] = grow ? grown : rho;\n      }\n", 11),
)
PARENT_PASSES = ("staging", "rho", "geometry", "cones", "x_boxes", "u_boxes",
                 "geometry_barrier", "equality_rows", "terminal_rows",
                 "reduction", "writes")
# the second design
BULK_ANCHORS = (
    ("  constexpr bool kOff = kMode == kOffline;\n", 0),
    ("<  cp_async_wait_all();\n  __syncthreads();                                   // every run is in\n", 1),
    ("  __syncthreads();                                   // every run is in\n", 2),
    ("<  // the other stage equality rows, row by row (a warp's lanes on one or\n", 3),
    ("<  // the terminal equalities hT = S_T·h_raw,T, and λ_T + (ρw_T)·hT\n", 4),
    ("<  // the cones: g = A_fc f ≤ 0 (bounded above by 0 only)\n", 5),
    ("<  // the x boxes, every node\n", 6),
    ("<  // the u boxes, the stage nodes\n", 7),
    ("<  // the member's violation, then the penalty schedule\n", 8),
    ("    v = isrbd::warp_nan_max(v);\n", 9),
    ("        P.out[O_RHO][b] = grow ? grown : rho;\n      }\n", 10),
)
BULK_PASSES = ("issue", "staging_wait", "euler_rows", "equality_rows",
               "terminal_rows", "cones", "x_boxes", "u_boxes", "reduction",
               "writes")


def instrumented(src: str):
    """The source with its marks, and whether it holds the second design."""
    bulk = "stage_run(" in src
    anchors = BULK_ANCHORS if bulk else PARENT_ANCHORS
    out = src
    for text, i in anchors:
        before = text.startswith("<")
        text = text.lstrip("<")
        if out.count(text) != 1:
            raise SystemExit(f"anchor not found once in the source: {text!r}")
        mark = ("  if (blockIdx.x == gridDim.x / 2 && threadIdx.x % (32 * (kWarps - 1)) == 0) "
                f"k7_trace[(threadIdx.x != 0) * {N_MARKS} + {i}] = clock64();\n")
        out = out.replace(text, mark + text if before else text + mark)
    out = out.replace("namespace {\n", "__device__ long long k7_trace[%d];\n"
                      "namespace {\n" % (2 * N_MARKS), 1)
    out += ('\nextern "C" int k7_trace_read(long long* marks) {\n'
            "  return static_cast<int>(cudaMemcpyFromSymbol(marks, k7_trace, "
            "sizeof(k7_trace)));\n}\n")
    return out, bulk


def split(marks, bulk):
    """Cycles of each pass on thread 0 of block 0, and in all; and on lane
    0 of its last warp, up to the reduction (which warp 0 finishes)."""
    names = BULK_PASSES if bulk else PARENT_PASSES
    last = marks[N_MARKS:]
    stop = names.index("reduction")
    return dict(
        passes={n: marks[i + 1] - marks[i] for i, n in enumerate(names)},
        total=marks[len(names)] - marks[0],
        last_warp_passes={n: last[i + 1] - last[i]
                          for i, n in enumerate(names[:stop])},
        last_warp_to_reduction=last[stop] - last[0])


def main():
    import torch

    import chip_smoke as c
    from srbd_horizon_tpu_torch.kernels import build

    out_dir = build.BUILD_DIR / "k7_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees, procs = [Path(t).resolve() for t in sys.argv[1:]], []
    for i, tree in enumerate(trees):
        csrc = tree / "srbd_horizon_tpu_torch" / "csrc"
        text, bulk = instrumented((csrc / "isrbd_al.cu").read_text())
        src = out_dir / f"isrbd_al_trace{i}.cu"
        src.write_text(text)
        log = open(out_dir / f"nvcc{i}.log", "w")
        procs.append((bulk, log, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS,
             *build.SOURCE_FLAGS["isrbd_al"], "-I", str(csrc), "-o",
             str(out_dir / f"libisrbd_al_trace{i}.so"), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    p = c.k7_point("kangaroo", dev, c.SEED + 200)
    for i, (tree, (bulk, log, proc)) in enumerate(zip(trees, procs)):
        proc.wait()
        log.close()
        if proc.returncode != 0:
            raise SystemExit((out_dir / f"nvcc{i}.log").read_text())
        lib = ctypes.CDLL(str(out_dir / f"libisrbd_al_trace{i}.so"))
        wrapper = c.other_wrapper(tree, "isrbd_al", {"isrbd_al": lib})
        read = lib.k7_trace_read
        read.argtypes = [ctypes.c_void_p]
        read.restype = ctypes.c_int
        for mode in ("online", "offline"):
            for Bw in (1, c.B_CONSTRAINED, c.B_LARGE):
                a, kw = c.k7_args(p, torch.float32, mode, Bw=Bw, nan=False)
                for _ in range(3):
                    wrapper.isrbd_al_constraints(*a, **kw)
                torch.cuda.synchronize()
                marks = (ctypes.c_longlong * (2 * N_MARKS))()
                if read(marks) != 0:
                    raise SystemExit("reading the trace failed")
                c.emit("k7_trace", tree=str(tree.relative_to(HERE)
                                            if tree.is_relative_to(HERE)
                                            else tree),
                       design="one_round" if bulk else "cp_async_rows", card=smi,
                       dtype="float32", shape="kangaroo", mode=mode, B=Bw,
                       **split(list(marks), bulk),
                       ms=c.cuda_ms(lambda: wrapper.isrbd_al_constraints(
                           *a, **kw), reps=50))


if __name__ == "__main__":
    main()
