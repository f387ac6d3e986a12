#!/usr/bin/env python3
"""A cycle split of K10 (`lip_linearize`) and `lip_evaluate`, in either of
their two designs each.

K10: groups of 16 member-nodes, each block forming every template in
shared memory and streaming the group's outputs element by element (the
port before its redesign, "stream"); or groups of one member-node at small
B and of 16 bytes' worth of member-nodes at fleet sizes, the templates
formed once on the host and held a slot a thread in registers, the records
of the next group loaded while the stores of this one run (since, "slots").
lip_evaluate: a block of seven warps a member, a warp a node (before,
"warp_node"); or a warp a member and a thread a node, several members a
block, the members' runs staged by bulk copies (since, "thread_node").

    python3 tools/torch_lip_trace.py TREE [TREE ...]

Each TREE holds the kernel sources and wrappers (`.` for this checkout, or
an unpacked archive of another commit, e.g. `git archive 2eb35bf
srbd_horizon_tpu_torch chip_smoke.py | tar -x -C TREE` for the first
designs). For each tree the script copies
`srbd_horizon_tpu_torch/csrc/lip_linearize.cu` and `lip_rollout.cu` with
`clock64()` marks added between the kernels' phases (thread 0 of block 0,
which takes a full group of stage nodes in K10 and the member sums in
lip_evaluate): each mark adds the cycles since the last one to its phase,
so a phase that a block runs once a group sums over its groups; the
totals go to a device array at the thread's last mark. It builds the
copies with nvcc in parallel, runs each through its tree's own wrapper at
B = 1, 512 and 4096 (float32, the LIP problem at a drawn iterate,
`chip_smoke.k13_point`; lip_evaluate with and without x0) and prints one
JSON line a case: the cycles of each phase on that thread, their total,
and the traced call's ms. A load's wait shows where its value is first
used. The marks cost a few cycles each; the copies are not kernels of the
port. Needs a CUDA card and nvcc.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

N_PHASES = 8
START = ("  const bool lip_tr = blockIdx.x == 0 && threadIdx.x == 0;\n"
         "  long long lip_tp = clock64(), lip_ta[{n}] = {{}};\n")
MARK = ("  if (lip_tr) {{ const long long t = clock64(); lip_ta[{i}] += t - lip_tp; "
        "lip_tp = t; }}\n")
END = ("  if (lip_tr) {{ for (int i = 0; i < {n}; ++i) lip_trace_{k}[i] = lip_ta[i]; }}\n")

# (kernel, design): the phases and the anchors, each (text, what goes
# there, placed after the text or, for "<", before it). "start" opens the
# trace, an int the mark of that phase, "end" the mark of the last phase
# and the store of the totals.
DESIGNS = {
    ("k10", "stream"): (
        ("templates", "loop_barrier", "staging", "streams"),
        (("<  form_templates(s, scale, table, k);\n", "start"),
         ("  form_templates(s, scale, table, k);\n", 0),
         ("    __syncthreads();                       // templates; the last group's reads\n", 1),
         ("<      stream_template<kSx>(s + tSx, Sx + q0 * kSx, nv * kSx);\n", 2),
         ("<    } else {                               // kNodes members' terminal pairs\n", 3),
         ("<      stream_template<kJt>(s + tJt, Jt + b0 * kJt, nv * kJt);\n", 2),
         ("        ro[i] = lip::tracking_row<S>(i - w * nt, r + rX, r + rP, T(1), k);\n      }\n", 3),
         ("<}\n\nint sm_count() {", "end"))),
    ("k10", "slots"): (
        ("slot_setup", "record_loads", "record_barrier", "stage_stores",
         "terminal_setup", "terminal_stores"),
        (("<  const int tid = threadIdx.x;\n  // this thread's record slots", "start"),
         ("<  // the stage groups\n", 0),
         ("<    // the group's records are in\n", 1),
         ("    // the group's records are in\n    __syncthreads();\n", 2),
         ("<    // the end of a stage group\n", 3),
         ("<    for (; g < n_groups; g += gridDim.x) {\n", 4),
         ("<      // the end of a terminal group\n", 5),
         ("<  // the block is done\n", "end"))),
    ("ev", "warp_node"): (
        ("stage_x_u", "pin_stores", "stage_params", "evaluation", "sums"),
        (("<  int from = 0;\n", "start"),
         ("  cp_async_wait_group<1>();                        // x and u are in\n"
          "  __syncthreads();\n", 0),
         ("<  cp_async_wait_group<0>();                        // the parameter rows too\n", 1),
         ("  cp_async_wait_group<0>();                        // the parameter rows too\n"
          "  __syncthreads();\n", 2),
         ("      node_dmax[n] = dm;\n    }\n  }\n  __syncthreads();\n", 3),
         ("      dmax_out[b] = m;\n", "end"))),
    ("ev", "thread_node"): (
        ("staging", "pin_stores", "evaluation", "sums"),
        (("<  const int tid = threadIdx.x, m = tid / 32, n = tid % 32;\n", "start"),
         ("<  // the pinned plan, with wide stores\n", 0),
         ("<  // a node a thread\n", 1),
         ("<  // the member's sums, one thread\n", 2),
         ("    dmax_out[b0 + m] = dmax;\n", "end"))),
}
PHASE_OF_END = {("k10", "stream"): 3, ("k10", "slots"): 5,
                ("ev", "warp_node"): 4, ("ev", "thread_node"): 3}


def design_of(kernel: str, src: str) -> str:
    if kernel == "k10":
        return "slots" if "kSlotThreads" in src else "stream"
    return "thread_node" if "kEvalMembers" in src else "warp_node"


def instrumented(kernel: str, src: str):
    """The source with its marks, and its design."""
    design = design_of(kernel, src)
    names, anchors = DESIGNS[kernel, design]
    n = len(names)
    out = src
    for text, what in anchors:
        before = text.startswith("<")
        text = text[1:] if before else text
        if out.count(text) != 1:
            raise SystemExit(f"anchor not found once in the source: {text!r}")
        if what == "start":
            code = START.format(n=n)
        elif what == "end":
            code = (MARK.format(i=PHASE_OF_END[kernel, design])
                    + END.format(n=n, k=kernel))
        else:
            code = MARK.format(i=what)
        out = out.replace(text, code + text if before else text + code)
    out = out.replace("namespace {\n",
                      f"__device__ long long lip_trace_{kernel}[{N_PHASES}];\n"
                      "namespace {\n", 1)
    out += (f'\nextern "C" int lip_trace_{kernel}_read(long long* marks) {{\n'
            f"  return static_cast<int>(cudaMemcpyFromSymbol(marks, lip_trace_{kernel}, "
            f"sizeof(lip_trace_{kernel})));\n}}\n"
            f'extern "C" int lip_trace_{kernel}_clear() {{\n'
            f"  long long zero[{N_PHASES}] = {{}};\n"
            f"  return static_cast<int>(cudaMemcpyToSymbol(lip_trace_{kernel}, zero, "
            f"sizeof(zero)));\n}}\n")
    return out, design


SOURCES = {"k10": "lip_linearize", "ev": "lip_rollout"}


def main():
    import torch

    import chip_smoke as c
    from srbd_horizon_tpu_torch.kernels import build

    out_dir = build.BUILD_DIR / "lip_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees, procs = [Path(t).resolve() for t in sys.argv[1:]], []
    for i, tree in enumerate(trees):
        csrc = tree / "srbd_horizon_tpu_torch" / "csrc"
        built = {}
        for kernel, name in SOURCES.items():
            text, design = instrumented(kernel, (csrc / f"{name}.cu").read_text())
            src = out_dir / f"{name}_trace{i}.cu"
            src.write_text(text)
            log = open(out_dir / f"{name}_nvcc{i}.log", "w")
            built[kernel] = (design, log, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS,
                 *build.SOURCE_FLAGS.get(name, ()), "-I", str(csrc), "-o",
                 str(out_dir / f"lib{name}_trace{i}.so"), str(src)],
                stdout=log, stderr=subprocess.STDOUT))
        procs.append(built)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    p = c.k13_point("lip", dev, c.SEED + 230)
    s, ns, dt = p["s"], p["ocp"].ns, p["ocp"].dt
    f32 = torch.float32
    for i, (tree, built) in enumerate(zip(trees, procs)):
        libs = {}
        for kernel, (design, log, proc) in built.items():
            proc.wait()
            log.close()
            name = SOURCES[kernel]
            if proc.returncode != 0:
                raise SystemExit((out_dir / f"{name}_nvcc{i}.log").read_text())
            libs[kernel] = ctypes.CDLL(str(out_dir / f"lib{name}_trace{i}.so"))
        k10 = c.other_wrapper(tree, "lip_linearize",
                              {"lip_linearize": libs["k10"]})
        ev = c.other_wrapper(tree, "lip_rollout", {"lip_rollout": libs["ev"]})
        label = str(tree.relative_to(HERE) if tree.is_relative_to(HERE) else tree)
        for Bw in (1, c.B_MAIN, c.B_LARGE):
            X = c.modes_sub(p["X"], Bw).to(f32)
            U = c.modes_sub(p["U"], Bw).to(f32)
            prm = {k: c.modes_sub(v, Bw).to(f32) for k, v in p["params"].items()}
            x0 = c.modes_sub(p["x0"], Bw).to(f32)
            w = s._wc(f32)
            cases = {
                "k10": ("k10", lambda: k10.lip_linearize(
                    X, U, prm, s.terms, s.rows, dt, w)),
                "lip_evaluate": ("ev", lambda: ev.lip_evaluate(
                    X, U, prm, s.terms, dt, w)),
                "lip_evaluate_pinned": ("ev", lambda: ev.lip_evaluate(
                    X, U, prm, s.terms, dt, w, x0=x0)),
            }
            for case, (kernel, fn) in cases.items():
                lib = libs[kernel]
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                if getattr(lib, f"lip_trace_{kernel}_clear")() != 0:
                    raise SystemExit("clearing the trace failed")
                fn()
                torch.cuda.synchronize()
                read = getattr(lib, f"lip_trace_{kernel}_read")
                read.argtypes = [ctypes.c_void_p]
                read.restype = ctypes.c_int
                marks = (ctypes.c_longlong * N_PHASES)()
                if read(marks) != 0:
                    raise SystemExit("reading the trace failed")
                design = built[kernel][0]
                names = DESIGNS[kernel, design][0]
                phases = dict(zip(names, list(marks)))
                c.emit("lip_trace", tree=label, design=design, card=smi,
                       dtype="float32", case=case, B=Bw, cycles=phases,
                       total=sum(phases.values()),
                       ms=c.cuda_ms(fn, reps=50))


if __name__ == "__main__":
    main()
