#!/usr/bin/env python3
"""A cycle split of K8a (`isrbd_al_shift`) and K8b (`isrbd_al_params`), in
either of their two designs: the block that copies each run in a strided
loop whose iteration loads and then stores (the port before its redesign),
or the block whose threads load every value they store, of every run, in
one round before any store (since).

    python3 tools/torch_k8_trace.py TREE [TREE ...]

Each TREE holds a kernel source and wrapper (`.` for this checkout, or an
unpacked archive of another commit, e.g. `git archive c590eb2
srbd_horizon_tpu_torch chip_smoke.py | tar -x -C TREE` for the first
design). For each tree the script copies
`srbd_horizon_tpu_torch/csrc/isrbd_al.cu` with `clock64()` marks added
between the kernels' passes (thread 0 and lane 0 of the last warp of the
grid's middle block, B/2; one store a mark into a device array), builds
the copies with nvcc in parallel, runs each through its tree's own wrapper
at the Kangaroo's AL shape at B = 1, 256 and 4096 (float32; K8a with no
and with the full prior, K8b with the static bounds; `chip_smoke.k7_point`)
and prints one JSON line a case: the cycles of each pass on those threads
and the traced call's ms. A load's wait shows where its value is first
used: in the first design each run's stores, in the second the first
store. The marks cost a few cycles each; the copies are not kernels of the
port. Needs a CUDA card and nvcc.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

N_MARKS = 8
# (kernel, design): (text, mark placed right after it; "<": before it)
ANCHORS = {
    ("shift", "loop"): (
        ("<  roll<T, nx>(P.out[S_X] + b * ns1 * nx", 0),
        ("  roll<T, nu>(P.out[S_MUULB] + b * ns * nu, P.in[S_MUULB] + b * ns * nu, ns, tid);\n", 1),
        ("  const bool seed_T = P.seen_T[row];\n", 2),
        ("    roll<T, n_eq>(lam_out, lam, ns, tid);\n", 4),
        ("<  if (tid < n_eq_T) {\n    const T* tabT", 3),
        ("        seed_T ? tabT[tid] : P.in[S_LAMT][b * n_eq_T + tid];\n  }\n", 4),
    ),
    ("shift", "one_round"): (
        ("<  const long long raw = kPrior == kNone ? 0 : phase_value(phase, phase_bytes, b);\n", 0),
        ("<    if (kPrior != kNone) {\n      // the terminal write's phase", 1),
        ("<    // then the stores\n#pragma unroll\n    for (int r = 0; r < S_LAMT; ++r) {", 2),
        ("<    if (kPrior != kNone && base == 0 && tid < n_eq_T)\n", 3),
        ("      P.out[S_LAMT][b * n_eq_T + tid] = seed_T ? tabT : lamT;\n", 4),
    ),
    ("params", "loop"): (
        ("<  pad_node<T, n_eq>(P.out[A_LAM]", 0),
        ("    pad_node<T, nu>(P.out[A_UUB] + b * ns1 * nu, P.in[A_UUB] + b * ns * nu, ns, inf, tid);\n", 1),
        ("  for (int i = tid; i < ns1 * n_eq_T; i += kThreads) tiled[i] = lamT[i % n_eq_T];\n", 2),
        ("  if (tid < ns1) P.out[A_RHO][b * ns1 + tid] = P.in[A_RHO][b];\n", 3),
    ),
    ("params", "one_round"): (
        ("<  const T rho = P.in[A_RHO][b];\n", 0),
        ("<    // then the stores: each run over ns + 1 nodes", 1),
        ("                 : r == A_LAMT || i < ns * dim ? v[r][s] : params_pad<T>(r);\n      }\n    }\n", 2),
    ),
}
PASSES = {
    ("shift", "loop"): ("rolls", "phase_chain", "lam", "lam_T"),
    ("shift", "one_round"): ("plan_loads", "prior_loads", "stores", "lam_T"),
    ("params", "loop"): ("pads", "lam_T_tiling", "rho"),
    ("params", "one_round"): ("loads", "stores"),
}


def instrumented(src: str):
    """The source with its marks, and its design."""
    design = "one_round" if "constexpr int kShiftSlots" in src else "loop"
    out = src
    for kernel in ("shift", "params"):
        for text, i in ANCHORS[kernel, design]:
            before = text.startswith("<")
            text = text.lstrip("<")
            if out.count(text) != 1:
                raise SystemExit(f"anchor not found once in the source: {text!r}")
            mark = ("  if (blockIdx.x == gridDim.x / 2 && (threadIdx.x == 0 || threadIdx.x == blockDim.x - 32)) "
                    f"k8_{kernel}_trace[(threadIdx.x != 0) * {N_MARKS} + {i}] = clock64();\n")
            out = out.replace(text, mark + text if before else text + mark)
    arrays = "".join(f"__device__ long long k8_{k}_trace[{2 * N_MARKS}];\n"
                     for k in ("shift", "params"))
    out = out.replace("namespace {\n", arrays + "namespace {\n", 1)
    for k in ("shift", "params"):
        out += (f'\nextern "C" int k8_{k}_trace_read(long long* marks) {{\n'
                f"  return static_cast<int>(cudaMemcpyFromSymbol(marks, k8_{k}_trace, "
                f"sizeof(k8_{k}_trace)));\n}}\n"
                f'extern "C" int k8_{k}_trace_clear() {{\n'
                f"  long long zero[{2 * N_MARKS}] = {{}};\n"
                f"  return static_cast<int>(cudaMemcpyToSymbol(k8_{k}_trace, zero, "
                f"sizeof(zero)));\n}}\n")
    return out, design


def split(marks, names):
    """Cycles of each pass on thread 0 and on lane 0 of the last warp (None
    for a pass whose marks the case did not reach: the first design's K8a
    without a prior returns after its λ roll, its last mark then the
    end)."""
    out = {}
    for who, m in (("thread0", marks[:N_MARKS]), ("last_warp", marks[N_MARKS:])):
        passes = {n: (m[i + 1] - m[i] if m[i] and m[i + 1] else None)
                  for i, n in enumerate(names)}
        end = max(m[:len(names) + 1])
        out[who] = dict(passes, total=end - m[0])
    return out


def main():
    import torch

    import chip_smoke as c
    from srbd_horizon_tpu_torch.kernels import build

    out_dir = build.BUILD_DIR / "k8_trace"
    out_dir.mkdir(parents=True, exist_ok=True)
    trees, procs = [Path(t).resolve() for t in sys.argv[1:]], []
    for i, tree in enumerate(trees):
        csrc = tree / "srbd_horizon_tpu_torch" / "csrc"
        text, design = instrumented((csrc / "isrbd_al.cu").read_text())
        src = out_dir / f"isrbd_al_trace{i}.cu"
        src.write_text(text)
        log = open(out_dir / f"nvcc{i}.log", "w")
        procs.append((design, log, subprocess.Popen(
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
    f32 = torch.float32
    al = p["al"][f32]
    st = c.cast_tree(p["st"], f32)
    Bsz, ns = st.rho.shape[0], al.ocp.ns
    n_eq, n_eq_T, _ = al._sizes
    g = torch.Generator(device="cpu").manual_seed(c.SEED + 220)
    full = al.init_full_phase_prior(20, Bsz)._replace(
        lam_eq=torch.randn(Bsz, 20, ns, n_eq, generator=g).to(dev, f32),
        lam_eq_T=torch.randn(Bsz, 20, n_eq_T, generator=g).to(dev, f32),
        seen=(torch.rand(Bsz, 20, generator=g) < 0.5).to(dev))
    phase = torch.arange(Bsz, dtype=torch.int32, device=dev) % 20
    static = c.cast_tree(p["static"], f32)
    for i, (tree, (design, log, proc)) in enumerate(zip(trees, procs)):
        proc.wait()
        log.close()
        if proc.returncode != 0:
            raise SystemExit((out_dir / f"nvcc{i}.log").read_text())
        lib = ctypes.CDLL(str(out_dir / f"libisrbd_al_trace{i}.so"))
        wrapper = c.other_wrapper(tree, "isrbd_al", {"isrbd_al": lib})
        for Bw in (1, c.B_CONSTRAINED, c.B_LARGE):
            cases = {
                "k8a_none": ("shift", lambda a: wrapper.isrbd_al_shift(*a),
                             (al, st, None, None)),
                "k8a_full": ("shift", lambda a: wrapper.isrbd_al_shift(*a),
                             (al, st, full, phase)),
                "k8b_static": ("params", lambda a: wrapper.isrbd_al_params(*a),
                               (al, static, st)),
            }
            for case, (kernel, fn, args) in cases.items():
                a = c.resize_members(args, Bsz, Bw)
                for _ in range(2):
                    fn(a)
                torch.cuda.synchronize()
                if getattr(lib, f"k8_{kernel}_trace_clear")() != 0:
                    raise SystemExit("clearing the trace failed")
                fn(a)
                torch.cuda.synchronize()
                read = getattr(lib, f"k8_{kernel}_trace_read")
                read.argtypes = [ctypes.c_void_p]
                read.restype = ctypes.c_int
                marks = (ctypes.c_longlong * (2 * N_MARKS))()
                if read(marks) != 0:
                    raise SystemExit("reading the trace failed")
                c.emit("k8_trace", tree=str(tree.relative_to(HERE)
                                            if tree.is_relative_to(HERE)
                                            else tree),
                       design=design, card=smi, dtype="float32",
                       shape="kangaroo", case=case, B=Bw,
                       **split(list(marks), PASSES[kernel, design]),
                       ms=c.cuda_ms(lambda: fn(a), reps=50))


if __name__ == "__main__":
    main()
