#!/usr/bin/env python3
"""K8a and K8b (`csrc/isrbd_al.cu`) built in variants of their block
size, elements a thread and launch bound, timed side by side on one card.

    python3 tools/torch_k8_variants.py [NAME ...]

Each variant is this checkout's source with some of `kShiftThreads`,
`kShiftSlots`, `kShiftMinBlocks`, `kParamsThreads`, `kParamsSlots` and
`kParamsMinBlocks` replaced (VARIANTS; "kept" is the source as it is; a
round, threads·slots, must hold a member's widest run at ns = 20: 777
elements); without arguments every variant. The script builds them with
nvcc in parallel, runs each through this checkout's wrapper (a module of
its own a variant, `chip_smoke.other_wrapper`), holds each to the twins
bit for bit (K8a with no, the tail and the full prior, K8b with the
static bounds, float32 and float64, B = 256, `chip_smoke.k7_point` at the
Kangaroo's AL shape), then times every variant in float32 at B = 1, 256
and 4096 in turns (the variants in order, then in reverse), and prints
one JSON line a variant: its ms, float32 blocks an SM and registers, and
ptxas' registers and spills. The variants are not kernels of the port.
Needs a CUDA card and nvcc.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

F32_F64 = "sizeof(T) == 4 ? {} : {}"
VARIANTS = {
    "kept": {},
    "shift_t256_s4_b4": dict(kShiftThreads=256, kShiftSlots=4,
                             kShiftMinBlocks=F32_F64.format(4, 2)),
    "shift_t512_s2_b2": dict(kShiftThreads=512, kShiftSlots=2,
                             kShiftMinBlocks=F32_F64.format(2, 1)),
    "shift_t1024_s1_b1": dict(kShiftMinBlocks=1),
    "params_t256_s4_b1": dict(kParamsMinBlocks=1),
    "params_t512_s2_b2": dict(kParamsThreads=512, kParamsSlots=2,
                              kParamsMinBlocks=F32_F64.format(2, 1)),
    "params_t1024_s1_b2": dict(kParamsThreads=1024, kParamsSlots=1,
                               kParamsMinBlocks=F32_F64.format(2, 1)),
}


def variant_source(src, values):
    """The source with each `constexpr int NAME = …;` of `values` set."""
    for name, v in values.items():
        src, n = re.subn(r"(constexpr int %s = )[^;]*;" % name,
                         lambda m: f"{m[1]}{v};", src)
        if n != 1:
            raise SystemExit(f"{name} not found once in the source")
    return src


def occupancy(lib, entry, *args):
    """A variant's occupancy query `entry` (csrc/isrbd_al.cu) on the card."""
    from srbd_horizon_tpu_torch.kernels.build import EVALUATE_OCCUPANCY_FIELDS

    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(EVALUATE_OCCUPANCY_FIELDS))()
    if fn(*args, out) != 0:
        raise SystemExit(f"{entry} failed")
    return dict(zip(EVALUATE_OCCUPANCY_FIELDS, out))


def main():
    import torch

    import chip_smoke as c
    from srbd_horizon_tpu_torch.kernels import build
    from srbd_horizon_tpu_torch.kernels import isrbd_al as k78

    variants = {k: VARIANTS[k] for k in (sys.argv[1:] or VARIANTS)}
    csrc = HERE / "srbd_horizon_tpu_torch" / "csrc"
    out_dir = build.BUILD_DIR / "k8_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (csrc / "isrbd_al.cu").read_text()
    procs = {}
    for name, values in variants.items():
        path = out_dir / f"isrbd_al_{name}.cu"
        path.write_text(variant_source(src, values))
        log = open(out_dir / f"{name}.log", "w")
        procs[name] = (log, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS,
             *build.SOURCE_FLAGS["isrbd_al"], "-I", str(csrc), "-o",
             str(out_dir / f"lib{name}.so"), str(path)],
            stdout=log, stderr=subprocess.STDOUT))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    p = c.k7_point("kangaroo", dev, c.SEED + 200)
    Bsz, ns = p["X"].shape[0], p["X"].shape[1] - 1
    al64 = p["al"][torch.float64]
    n_eq, n_eq_T, _ = al64._sizes
    g = torch.Generator(device="cpu").manual_seed(c.SEED + 230)
    seen = lambda: (torch.rand(Bsz, 20, generator=g) < 0.5).to(dev)
    rnd = lambda *s: torch.randn(*s, generator=g, dtype=torch.float64).to(dev)
    full = al64.init_full_phase_prior(20, Bsz)._replace(
        lam_eq=rnd(Bsz, 20, ns, n_eq), lam_eq_T=rnd(Bsz, 20, n_eq_T),
        seen=seen())
    tail = al64.init_phase_prior(20, Bsz)._replace(
        lam_tail=rnd(Bsz, 20, n_eq), lam_T=rnd(Bsz, 20, n_eq_T),
        seen_tail=seen(), seen_T=seen())
    phase = torch.arange(Bsz, dtype=torch.int32, device=dev) % 20

    def cases(dtype, Bw):
        tree = c.resize_members((p["st"], tail, full, p["static"], phase), Bsz,
                                Bw)
        st, ta, fu, static, ph = (c.cast_tree(t, dtype) for t in tree)
        al = p["al"][dtype]
        return {"k8a_none": ("isrbd_al_shift", (al, st, None, None)),
                "k8a_tail": ("isrbd_al_shift", (al, st, ta, ph)),
                "k8a_full": ("isrbd_al_shift", (al, st, fu, ph)),
                "k8b_static": ("isrbd_al_params", (al, static, st))}
    mods, rows = {}, {}
    for name, (log, proc) in procs.items():
        proc.wait()
        log.close()
        text = (out_dir / f"{name}.log").read_text()
        if proc.returncode != 0:
            raise SystemExit(text)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        mods[name] = m = c.other_wrapper(HERE, "isrbd_al", {"isrbd_al": lib})
        rows[name] = dict(variant=name, card=smi,
                          constants=variants[name], ms={},
                          bit_equal=True, occupancy={}, ptxas={
                              k: v for k, v in c.ptxas_entries(text, "isrbd_al")
                              .items() if "shift" in k or "params" in k})
        for dtype in (torch.float32, torch.float64):
            for key, (entry, a) in cases(dtype, c.B_CONSTRAINED).items():
                got = c.outputs(getattr(m, entry)(*a))
                ref = c.outputs(getattr(k78, entry + "_plain")(*a))
                torch.cuda.synchronize()
                rows[name]["bit_equal"] &= all(
                    c.bits_equal(x, y) for (_, x), (_, y) in zip(got, ref))
        for kind, pn in enumerate(k78.PRIORS):
            rows[name]["occupancy"][f"k8a_{pn}"] = occupancy(
                lib, "isrbd_al_shift_occupancy", 0, kind, 0)
        rows[name]["occupancy"]["k8b"] = occupancy(
            lib, "isrbd_al_params_occupancy", 0, 0)
    order = list(variants)
    for Bw in (1, c.B_CONSTRAINED, c.B_LARGE):
        for key, (entry, a) in cases(torch.float32, Bw).items():
            for name in order + order[::-1]:
                fn = getattr(mods[name], entry)
                rows[name]["ms"].setdefault(key, {}).setdefault(
                    str(Bw), []).append(c.cuda_ms(lambda: fn(*a), reps=20))
    for r in rows.values():
        print("k8_variant: " + json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
