#!/usr/bin/env python3
"""The box kernels of the visibility prep (`csrc/cull_boxes.cu`) on one
CUDA card: what their machine code does per face and how long they take,
on the full-width model's own posed meshes.

    python3 scripts/torch_cull_readings.py [--sass DIR] [--machine-code-only]

Prints:

  * `-Xptxas -v` of `csrc/cull_boxes.cu` compiled alone (registers,
    spills), and the blocks of 256 threads an SM holds at that register
    count;
  * per kernel of that source, its SASS instructions (`cuobjdump -sass`)
    by class — float64 arithmetic and compares, the float64 reciprocal
    seed (`MUFU.RCP64H`), conversions from and to 64-bit types (and
    rounding to an integral float64, `FRND`), global loads and stores,
    shuffles, shared-memory accesses — on the main path and in the
    subroutines that it `CALL`s (the slow paths of division and
    reciprocal, taken on rare operands); and the same counts for probe
    kernels that do one `__ddiv_rn`, one `__drcp_rn` and one `__dmul_rn`;
  * for the recon's posed meshes (`chip_smoke.recon_scene`) and the
    training forward's (`chip_smoke.train_pose_scene`), both launches of
    the cull kernel — the face boxes alone (`rc.cull`) and variant 6's
    face and unit boxes (`rc.cull_units`) — held to their plain versions
    bit for bit and timed by `chip_smoke.cull_entry` (a single call, and
    20 calls in a CUDA graph: the device's time alone) beside their bound;
    and the host's time per call over 1,000 calls without a synchronise
    (`host_ms`).

`--sass DIR` writes each cubin's full `cuobjdump -sass` there, and
`--machine-code-only` stops after the compiler's readings.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROBE = r"""
extern "C" __global__ void probe_ddiv(const double* a, const double* b,
                                      double* o) {
  o[threadIdx.x] = __ddiv_rn(a[threadIdx.x], b[threadIdx.x]);
}
extern "C" __global__ void probe_drcp(const double* a, double* o) {
  o[threadIdx.x] = __drcp_rn(a[threadIdx.x]);
}
extern "C" __global__ void probe_dmul(const double* a, const double* b,
                                      double* o) {
  o[threadIdx.x] = __dmul_rn(a[threadIdx.x], b[threadIdx.x]);
}
"""

F64 = {"DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"}
CONV = {"F2F", "F2I", "I2F", "I2I", "FRND"}
CLASSES = ("f64", "rcp64_seed", "conv64", "ldg", "stg", "shfl", "shared",
           "total")


def klass(op):
    base, _dot, mods = op.partition(".")
    if base in F64:
        return "f64"
    if op.startswith("MUFU.RCP64H"):
        return "rcp64_seed"
    if base in CONV and "64" in mods:
        return "conv64"
    if base == "LDG":
        return "ldg"
    if base == "STG":
        return "stg"
    if base == "SHFL":
        return "shfl"
    if base in ("LDS", "STS"):
        return "shared"
    return None


def sass_mix(text):
    """{function: (main-path counts, subroutine counts)} by class, from the
    text of `cuobjdump -sass`. The subroutines (the slow paths that the
    main path reaches by `CALL`) run from the lowest call target to the
    function's closing self-branch; the main path is what precedes them."""
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)"
                     r"([^;]*);", line)
        if name is not None and m:
            funcs[name].append((int(m.group(1), 16), m.group(3), m.group(4)))
    out = {}
    for name, code in funcs.items():
        calls = [int(t, 16) for _a, op, rest in code if op.startswith("CALL")
                 for t in re.findall(r"0x([0-9a-f]+)", rest)]
        first_sub = min(calls, default=None)
        counts = ({k: 0 for k in CLASSES}, {k: 0 for k in CLASSES})
        for addr, op, rest in code:
            target = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and target \
                    and int(target.group(1), 16) == addr:
                break                       # the closing self-branch
            if op == "NOP":
                continue
            part = counts[1 if first_sub is not None and addr >= first_sub
                          else 0]
            part["total"] += 1
            k = klass(op)
            if k:
                part[k] += 1
        out[name] = counts
    return out


def occupancy(regs, threads=256):
    """Blocks of `threads` an H100 SM holds at `regs` registers a thread
    (65,536 registers, allocated per warp in units of 256; 2,048 threads)."""
    per_warp = -(-regs * 32 // 256) * 256
    warps = threads // 32
    return min(65536 // (per_warp * warps), 2048 // threads, 32)


def compile_cubin(kernels, src, out):
    """nvcc of one source into a cubin with the library's flags; prints
    ptxas's registers and spills."""
    flags = [f for f in kernels.NVCC_FLAGS if f != "-shared"]
    proc = subprocess.run([kernels._nvcc(), "-cubin", *flags, "-o", out,
                           src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line or "registers" in line \
                or "spill" in line:
            print("ptxas: " + line.strip())
        m = re.search(r"Used (\d+) registers", line)
        if m and src.endswith("cull_boxes.cu"):
            regs = int(m.group(1))
            print(f"ptxas: at {regs} registers an SM holds "
                  f"{occupancy(regs)} blocks of 256 threads "
                  f"({occupancy(regs) * 8} of 64 warps)")


def machine_code(kernels, tmp, sass_dir):
    """`-Xptxas -v` and the SASS mix of `csrc/cull_boxes.cu` and of the
    probes, compiled alone into `tmp`."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    probe = os.path.join(tmp, "probe.cu")
    with open(probe, "w") as f:
        f.write(PROBE)
    source = os.path.join(REPO, "animals3d_tpu_torch", "csrc",
                          "cull_boxes.cu")
    for i, src in enumerate((source, probe)):
        cubin = os.path.join(tmp, f"{i}.cubin")
        compile_cubin(kernels, src, cubin)
        text = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
        tag = os.path.basename(src)
        if sass_dir:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, tag + ".sass"), "w") as f:
                f.write(text)
        for fn, (main, subs) in sass_mix(text).items():
            print(f"sass[{tag}: {fn}]: main path " + ", ".join(
                f"{k} {v}" for k, v in main.items()) + "; subroutines "
                + ", ".join(f"{k} {v}" for k, v in subs.items()))


def host_ms(fn, n=1000):
    """Host time per call of `fn` over n calls with no synchronise between
    them: the wrapper's enqueue cost while the card keeps up (once the
    launch queue fills, the card's pace)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def timings(chip_smoke, rc, name, scene, card):
    res = scene[4]
    p3, _peak = chip_smoke.prepare_peak(scene, 3)
    p6, _peak = chip_smoke.prepare_peak(scene, 6)
    sub = p6["table"].shape[-1] // p6["nsub"]
    chip_smoke.cull_entry(p3, res, scene=name)
    chip_smoke.cull_entry(p6, res, units=True, scene=name)
    for label, fn in (
            ("cull", lambda: rc.cull(p3["table"], res)),
            ("cull_units", lambda: rc.cull_units(p6["table"], res, sub))):
        print(f"{name}: {label}: host {host_ms(fn):.4f} ms a call over "
              f"1000 calls; card {card}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sass", default="",
                    help="directory for the full SASS listings")
    ap.add_argument("--machine-code-only", action="store_true",
                    help="print the compiler's readings and stop")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from animals3d_tpu_torch.data.synth import fake_batch
    from animals3d_tpu_torch.ops import kernels
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    card = chip_smoke.card_line()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        machine_code(kernels, tmp, args.sass)
    if args.machine_code_only:
        return 0
    kernels.build()
    model, images, it, B, _H = chip_smoke.slice_phase()
    scenes = {"recon": chip_smoke.recon_scene(model, images, it),
              "train": chip_smoke.train_pose_scene(
                  model, fake_batch(model, B, chip_smoke.SEED))}
    with torch.no_grad():
        for name, scene in scenes.items():
            timings(chip_smoke, rc, name, scene, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
