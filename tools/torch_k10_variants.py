#!/usr/bin/env python3
"""K10 (`csrc/lip_linearize.cu`) built in variants of its group, block size
and launch bound, timed side by side on one card.

    python3 tools/torch_k10_variants.py [NAME ...]

Each variant is this checkout's source with some of `kGroupUnits` (a
fleet's group: kGroupUnits 16-byte units of member-nodes), `kSlotThreads`
and `kMinBlocks` replaced (VARIANTS; "kept" is the source as it is; the
grid takes at most kMinBlocks blocks an SM, so the bound sets the grid too);
without arguments every variant. The script builds them with nvcc in
parallel, runs each through this checkout's wrapper (a module of its own
a variant, `chip_smoke.other_wrapper`), holds each to the kept source's
outputs bit for bit (float32 and float64, B = 512, the LIP at a drawn
iterate, `chip_smoke.k13_point`), then times every variant in float32 at
B = 1, 512 and 4096 in turns (the variants in order, then in reverse),
and prints one JSON line a variant: its ms, blocks an SM and registers
with 16-byte groups, and ptxas' registers and spills. The variants are
not kernels of the port; the "diag" ones leave work out to show what it
costs, and their outputs differ. Needs a CUDA card and nvcc.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

VARIANTS = {
    "kept": {},
    "t256_b3": dict(kSlotThreads=256, kMinBlocks=3),
    "t256_b4": dict(kSlotThreads=256, kMinBlocks=4),
    "t512_b1": dict(kMinBlocks=1),
    "u2_t512_b2": dict(kGroupUnits=2),
    "u4_t512_b1": dict(kGroupUnits=4, kMinBlocks=1),
    # diagnostics, not the kernel's outputs: the ρ and d rows, or the Jxp
    # scales, left out
    "diag_no_rows": dict(replace={
        "lip::stage_rho_row<S>(g_, r + Z::rX, r + Z::rU, r + Z::rP, k)":
            "r[Z::rX + g_ % Z::nx]",
        "lip::step_row<S>(j, r + Z::rX, r + Z::rU, k) -\n"
        "                    r[Z::rXn + j]": "r[Z::rX + j]"}),
    "diag_no_scale": dict(replace={
        "x.v[j] = (sid == 0 || t.v[j] == T(0)) ? t.v[j] : t.v[j] * f;":
            "x.v[j] = t.v[j] + T(0) * f;"}),
}


def variant_source(src, values):
    """The source with each `constexpr int NAME = …;` of `values` set, and
    each text of `values["replace"]` replaced."""
    values = dict(values)
    for old, new in values.pop("replace", {}).items():
        if src.count(old) != 1:
            raise SystemExit(f"{old!r} not found once in the source")
        src = src.replace(old, new)
    for name, v in values.items():
        src, n = re.subn(r"(constexpr int %s = )[^;]*;" % name,
                         lambda m: f"{m[1]}{v};", src)
        if n != 1:
            raise SystemExit(f"{name} not found once in the source")
    return src


def main():
    import torch

    import chip_smoke as c
    from srbd_horizon_tpu_torch.kernels import build

    variants = {k: VARIANTS[k] for k in (sys.argv[1:] or VARIANTS)}
    csrc = HERE / "srbd_horizon_tpu_torch" / "csrc"
    out_dir = build.BUILD_DIR / "k10_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (csrc / "lip_linearize.cu").read_text()
    procs = {}
    for name, values in variants.items():
        path = out_dir / f"lip_linearize_{name}.cu"
        path.write_text(variant_source(src, values))
        log = open(out_dir / f"{name}.log", "w")
        procs[name] = (log, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
             str(out_dir / f"lib{name}.so"), str(path)],
            stdout=log, stderr=subprocess.STDOUT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    p = c.k13_point("lip", dev, c.SEED + 240)
    s, dt = p["s"], p["ocp"].dt

    def call(mod, Bw, dtype):
        X = c.modes_sub(p["X"], Bw).to(dtype)
        U = c.modes_sub(p["U"], Bw).to(dtype)
        prm = {k: c.modes_sub(v, Bw).to(dtype) for k, v in p["params"].items()}
        w = s._wc(dtype)
        return lambda: tuple(mod.lip_linearize(X, U, prm, s.terms, s.rows, dt,
                                               w).values())
    mods, rows = {}, {}
    for name, (log, proc) in procs.items():
        proc.wait()
        log.close()
        text = (out_dir / f"{name}.log").read_text()
        if proc.returncode != 0:
            raise SystemExit(text)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        mods[name] = m = c.other_wrapper(HERE, "lip_linearize",
                                         {"lip_linearize": lib})
        rows[name] = dict(variant=name, card=smi, values=variants[name],
                          ptxas=c.ptxas_entries(text, "lip_linearize_kernel"),
                          diagnostic=name.startswith("diag"),
                          occupancy=m.occupancy(torch.float32), bit_equal={},
                          ms={})
    first = next(iter(mods))
    for dtype in (torch.float32, torch.float64):
        ref = call(mods[first], c.B_MAIN, dtype)()
        for name, m in mods.items():
            got = call(m, c.B_MAIN, dtype)()
            torch.cuda.synchronize()
            rows[name]["bit_equal"][str(dtype)[6:]] = all(
                c.bits_equal(a, b) for a, b in zip(ref, got))
    names = list(mods)
    for Bw in (1, c.B_MAIN, c.B_LARGE):
        fns = {n: call(mods[n], Bw, torch.float32) for n in names}
        for n in names + names[::-1]:
            rows[n]["ms"].setdefault(str(Bw), []).append(
                c.cuda_ms(fns[n], reps=50 if Bw < c.B_LARGE else 20))
        del fns
    for r in rows.values():
        c.emit("k10_variant", **r)


if __name__ == "__main__":
    main()
