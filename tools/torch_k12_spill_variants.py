"""K12's element-kernel launch bound, by variants: compiles
`srbd_horizon_tpu_torch/csrc/riccati_associative.cu` restricted to a few
instantiations (SrbdShape and PointFeetShape block-Schur, LipShape and
LipRkShape with the Cholesky gains, LipRkShape, LipQuadShape, LipQuadRkShape
and LipPointFeetShape block-Schur) under text substitutions, one `nvcc`
each, all in parallel, and prints ptxas' registers, stack frame and spills
of every kernel.

    python3 tools/torch_k12_spill_variants.py      # on a machine with nvcc

Variants: `source` (the file as it is), `no_bound` (the nx = 30 LIP shapes'
element kernels without a minimum of blocks, as before it was set),
`bound2` (two blocks an SM there), `unroll1` and `split` (no minimum; the
Cholesky right-hand sides' loop not unrolled, or the right-hand sides
gathered before the solves). The sources and ptxas' reports go to
build/k12_variants/.
"""

import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "srbd_horizon_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k12_variants"
NVCC = "/usr/local/cuda/bin/nvcc"
KEEP = (0, 3, 8, 16, 17, 18, 20, 22)   # with_instance cases compiled
BOUNDS = ("constexpr int kElemMinBlocks<LipRkShape> = 4;",
          "constexpr int kElemMinBlocks<LipQuadShape> = 4;",
          "constexpr int kElemMinBlocks<LipQuadRkShape> = 4;")


def bounded(src, blocks):
    for b in BOUNDS:
        if b not in src:
            sys.exit(f"the anchor {b!r} is not in the source")
        src = src.replace(b, b.replace("= 4;", f"= {blocks};"))
    return src

LOOP = ("    for (int c = tid; c < W; c += kThreads) {\n"
        "      for (int u = 0; u < nu; ++u) sol[u * W + c] = rhs(u, c);")


def restricted(src):
    """The source with `with_instance` holding only the cases in KEEP."""
    sw = re.search(r"(  switch \(inst\) \{\n)(.*?)(    default: return "
                   r"kUnknownShape;)", src, re.S)
    keep = "".join(line + "\n" for line in sw.group(2).splitlines()
                   if re.match(r"\s*case (\d+):", line)
                   and int(re.match(r"\s*case (\d+):", line).group(1)) in KEEP)
    return src[:sw.start(2)] + keep + src[sw.end(2):]


def variants(src):
    free = bounded(src, 0)
    out = {
        "source": src,
        "no_bound": free,
        "bound2": bounded(src, 2),
        "unroll1": free.replace(LOOP, "#pragma unroll 1\n" + LOOP),
        "split": free.replace(
            LOOP + "\n      cholesky_solve<nu>(F, sol + c, W);\n    }",
            "    for (int c = tid; c < W; c += kThreads)\n"
            "      for (int u = 0; u < nu; ++u) sol[u * W + c] = rhs(u, c);\n"
            "    for (int c = tid; c < W; c += kThreads) {\n"
            "      cholesky_solve<nu>(F, sol + c, W);\n    }"),
    }
    for name, text in out.items():
        if name not in ("source", "no_bound") and text == free:
            sys.exit(f"variant {name}: its anchor is not in the source")
    return out


def main():
    src = restricted((CSRC / "riccati_associative.cu").read_text())
    procs, t0 = {}, time.time()
    for name, text in variants(src).items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "riccati_associative.cu").write_text(text)
        for h in ("riccati_common.cuh", "dmma.cuh"):
            (d / h).write_text((CSRC / h).read_text())
        log = open(d / "ptxas.log", "w")
        procs[name] = subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o",
             str(d / "lib.so"), str(d / "riccati_associative.cu")],
            stdout=log, stderr=subprocess.STDOUT)
    for name, p in procs.items():
        p.wait()
        fn, seen = None, {}
        for line in (OUT / name / "ptxas.log").read_text().splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = re.sub(r"^_ZN\w+?_cu_\w+?\d\d(element|gain|combine)",
                            r"\1", m.group(1))[:48]
                seen[fn] = ["?", "?"]
            m = re.search(r"(\d+) bytes stack frame, .*", line)
            if m and fn in seen:
                seen[fn][1] = m.group(0)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn in seen:
                seen[fn][0] = m.group(1)
        for f, (regs, stack) in seen.items():
            print(f"{name:9s} rc {p.returncode} {f:48s} {regs:>4s} registers, "
                  f"{stack}")
    print(f"seconds {time.time() - t0:.1f}")


if __name__ == "__main__":
    main()
