#!/usr/bin/env python3
"""A cycle split of K11's (`lip_trial`'s) chain, in either of its two
designs: one warp a (member, α) that issues its own `cp.async` copies at
every node and evaluates the residual rows on the chain (the port before
its redesign), or a block a member whose operands a copier warp stages by
bulk copies (K through a ring of pieces), the chains carrying x̂ and u
alone and the cost evaluated after them (since).

    python3 tools/torch_k11_trace.py TREE [TREE ...]

Each TREE holds a kernel source and wrapper (`.` for this checkout, or an
unpacked archive of another commit, e.g. `git archive 153f56d
srbd_horizon_tpu_torch | tar -x -C TREE` for the first design). For each
tree the script copies `srbd_horizon_tpu_torch/csrc/lip_rollout.cu` with
`clock64()` marks added around the steps of the chain loop (lane 0 of the
first chain warp of block 0; one store a mark into a device array), builds
the copies with nvcc in parallel, runs each through its tree's own wrapper
at B = 1 and 512 with one and four α (float32, the LIP problem at a drawn
iterate, `chip_smoke.k13_point`) and prints one JSON line a case: the
cycles a node of each step averaged over the stage nodes past the first
two, and the cycles of the launch's phases on that warp. The marks cost a
few cycles each; the copies are not kernels of the port. Needs a CUDA card
and nvcc.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

N_MARKS = 16
MAX_NODES = 32
N_SLOTS = MAX_NODES * N_MARKS
LOOP = "  for (int n = 0; n < ns; ++n) {\n"
# the first design: (text in the chain loop, mark placed right after it)
PARENT_ANCHORS = (
    (LOOP, 0),
    ("               ahead, ns, lane);\n", 1),
    ("    cp_async_wait_group<kStages - 1>();            // node n has arrived\n", 2),
    ("    cp_async_wait_group<kStages - 1>();            // node n has arrived\n"
     "    __syncwarp();\n", 3),
    ("      Xo[lane] = xh[lane];\n    }\n", 4),
    ("      Xo[lane] = xh[lane];\n    }\n    __syncwarp();\n", 5),
    ("        Un[((a * B + b) * ns + n) * nu + lane] = ui;\n      }\n    }\n", 6),
    ("        Un[((a * B + b) * ns + n) * nu + lane] = ui;\n      }\n    }\n"
     "    __syncwarp();\n", 7),
    ("    acc += lip::stage_sq_lane<S>(lane, xh, u, buf + NB::p, k);\n", 8),
    ("           om * buf[NB::d + lane];\n", 9),
    ("           om * buf[NB::d + lane];\n    __syncwarp();\n", 10),
    ("    if (lane < nx) xh[lane] = xn;\n", 11),
    ("    if (lane < nx) xh[lane] = xn;\n    __syncwarp();\n", 12),
)
# the steps: (name, [(from mark, to mark), ...])
PARENT_STEPS = (
    ("copy_issue", [(0, 1)]),
    ("copy_wait", [(1, 2)]),
    ("syncwarps", [(2, 3), (4, 5), (6, 7), (9, 10), (11, 12)]),
    ("dx_and_Xn_store", [(3, 4)]),
    ("K_product_and_u", [(5, 6)]),
    ("residual_rows", [(7, 8)]),
    ("euler_step", [(8, 9), (10, 11)]),
)
# the second design: marks in the chain loop ("<": before the text), and
# the launch's phases
BULK_ANCHORS = (
    ("    for (int n = 0; n < ns; ++n) {\n", 0),
    ("      if (m == 0) mbarrier_wait(full + s, use & 1);\n", 1),
    ("                    Ul[n * nu], kl[n * nu], xh, alpha, om, k, Xo, Uo, rec,\n"
         "                    lane);\n", 2),
    ("<    }\n    if (lane < nx) {                               // x̂_N\n", 3),
)
BULK_STEPS = (("piece_wait", [(0, 1)]), ("node", [(1, 2)]),
              ("piece_release", [(2, 3)]))
BULK_EDGES = (
    ("  const int nthreads = blockDim.x;\n", 0),
    ("    mbarrier_wait(runs, 0);                        // X, d, U, k are in\n", 1),
    ("      Xo[lane] = xh;\n      rec[lane] = xh;\n    }\n", 2),
    ("                             : lip::terminal_sq<S>(rc, p, k);\n    }\n", 3),
    ("                  (al >= alpha_min);\n", 4),
)
BULK_PHASES = (("staging", 0, 1), ("chain", 1, 2), ("evaluation", 2, 3),
               ("armijo", 3, 4))


def _insert(src, anchors, mark):
    out = src
    for texts, i in sorted(anchors, key=lambda a: -len(a[0])):
        texts = (texts,) if isinstance(texts, str) else texts
        found = [t for t in texts if out.count(t.lstrip("<")) == 1]
        if not found:
            raise SystemExit(f"anchor not found once in the source: {texts!r}")
        text = found[0]
        if text.startswith("<"):
            out = out.replace(text[1:], mark(i) + text[1:])
        elif text.endswith("\n"):
            out = out.replace(text, text + mark(i))
        else:                      # a call: the mark after its statement
            at = out.index(text)
            end = out.index(";\n", at) + 2
            out = out[:end] + mark(i) + out[end:]
    return out


def instrumented(src: str):
    """The source with its marks, and whether it holds the second design."""
    bulk = "tma_bulk(" in src
    head = ("__device__ long long k11_trace[%d];\n"
            "__device__ long long k11_edges[8];\n" % N_SLOTS)
    if bulk:
        out = _insert(src, BULK_ANCHORS, lambda i: (
            f"      if (blockIdx.x == 0 && tid == 0 && n < {MAX_NODES}) "
            f"k11_trace[n * {N_MARKS} + {i}] = clock64();\n"))
        out = _insert(out, BULK_EDGES, lambda i: (
            f"  if (blockIdx.x == 0 && tid == 0) k11_edges[{i}] = clock64();\n"))
    else:
        out = _insert(src, PARENT_ANCHORS, lambda i: (
            f"    if (g == 0 && lane == 0 && n < {MAX_NODES}) "
            f"k11_trace[n * {N_MARKS} + {i}] = clock64();\n"))
        start = ("  if (g >= static_cast<long long>(B) * nA) return;   "
                 "// whole warp leaves\n")
        end = ("    ok_out[o] = (merit0[b] - merit >= beta * exp_min) && "
               "isfinite(merit) &&\n")
        if out.count(start) != 1 or out.count(end) != 1:
            raise SystemExit("kernel entry or exit anchor not found")
        out = out.replace(start, start + "  if (g == 0 && lane == 0) "
                          "k11_edges[0] = clock64();\n")
        out = out.replace(end, "    if (g == 0) k11_edges[4] = clock64();\n"
                          + end)
    out = out.replace("namespace {\n", head + "namespace {\n", 1)
    out += ("\nextern \"C\" int k11_trace_read(long long* marks, "
            "long long* edges) {\n"
            "  cudaError_t e = cudaMemcpyFromSymbol(marks, k11_trace, "
            "sizeof(k11_trace));\n"
            "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(edges, k11_edges, "
            "sizeof(k11_edges));\n"
            "  return static_cast<int>(e);\n}\n")
    return out, bulk


def split(marks, edges, ns, bulk):
    """Cycles a node of each step, averaged over stage nodes 2 … ns−1, and
    the launch's phases."""
    nodes = range(2, ns)
    m = lambda n, i: marks[n * N_MARKS + i]
    avg = lambda pairs: sum(m(n, j) - m(n, i) for n in nodes
                            for i, j in pairs) / len(nodes)
    node = sum(m(n + 1, 0) - m(n, 0) for n in range(2, ns - 1)) / (ns - 3)
    if not bulk:
        return dict(cycles_per_node={k: avg(p) for k, p in PARENT_STEPS},
                    node_cycles=node, launch_cycles=edges[4] - edges[0])
    return dict(cycles_per_node={k: avg(p) for k, p in BULK_STEPS},
                node_cycles=node, launch_cycles=edges[4] - edges[0],
                phases={k: edges[j] - edges[i] for k, i, j in BULK_PHASES})


def main():
    import torch

    import chip_smoke as c
    from srbd_horizon_tpu_torch.kernels import build

    out_dir = build.BUILD_DIR / "k11_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees, procs = [Path(t).resolve() for t in sys.argv[1:]], []
    for i, tree in enumerate(trees):
        csrc = tree / "srbd_horizon_tpu_torch" / "csrc"
        text, bulk = instrumented((csrc / "lip_rollout.cu").read_text())
        src = out_dir / f"lip_rollout_trace{i}.cu"
        src.write_text(text)
        log = open(out_dir / f"nvcc{i}.log", "w")
        procs.append((bulk, log, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(out_dir / f"liblip_rollout_trace{i}.so"), str(src)],
            stdout=log, stderr=subprocess.STDOUT)))
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    p = c.k13_point("lip", dev, c.SEED + 181)
    s, ns = p["s"], p["ocp"].ns
    for i, (tree, (bulk, log, proc)) in enumerate(zip(trees, procs)):
        proc.wait()
        log.close()
        if proc.returncode != 0:
            raise SystemExit((out_dir / f"nvcc{i}.log").read_text())
        lib = ctypes.CDLL(str(out_dir / f"liblip_rollout_trace{i}.so"))
        wrapper = c.other_wrapper(tree, "lip_rollout", {"lip_rollout": lib})
        read = lib.k11_trace_read
        read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        read.restype = ctypes.c_int
        for Bw in (1, c.B_MAIN):
            for nA in (1, 4):
                a = c.modes_k13_args(p, Bw, torch.float32, nA)
                args = (*a[:5], a[7], *a[8:14], s.terms, p["ocp"].dt,
                        *s._family_args(torch.float32), s.opts.defect_weight,
                        s.opts.beta, s.opts.alpha_converge_threshold)
                for _ in range(3):
                    wrapper.lip_trial(*args)
                torch.cuda.synchronize()
                marks = (ctypes.c_longlong * N_SLOTS)()
                edges = (ctypes.c_longlong * 8)()
                if read(marks, edges) != 0:
                    raise SystemExit("reading the trace failed")
                c.emit("k11_trace", tree=str(tree.relative_to(HERE)
                                             if tree.is_relative_to(HERE)
                                             else tree),
                       design="bulk" if bulk else "warp", card=smi,
                       dtype="float32", B=Bw, nA=nA, ns=ns,
                       **split(marks, edges, ns, bulk),
                       ms=c.cuda_ms(lambda: wrapper.lip_trial(*args), reps=50))


if __name__ == "__main__":
    main()
