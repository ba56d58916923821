#!/usr/bin/env python3
"""Shapes of K3's bf16 mode (``count_inliers_bf16_kernel``) on one CUDA
card: instructions per pair from the SASS, registers, and device time.

  python3 tools/tune_k3_bf16.py [--variants 128x2,128x4,256x2] \
      [--chunks 0,128,256,512] [--scaling] [--old OLD/count_inliers.cu] \
      [--out pvnet_tpu_torch/build/k3_bf16_tune.json]

Each variant THREADSxR (threads per block x packed hypothesis pairs per
thread) is built from ``pvnet_tpu_torch/csrc/count_inliers.cu`` with
``-DK3_BF16_THREADS``/``-DK3_BF16_R`` and the port's nvcc flags, one nvcc
per variant, all started together. For each it prints what ptxas reports
(registers, spills) and the kernel's innermost pair loop from
``cuobjdump -sass``: its instructions by opcode, the pairs one pass
covers (the loop's bf16x2 arithmetic over the 12 instructions that two
pairs need: 11 operations and |dot|), instructions per pair, and whether any
conversion (F2F, F2FP, I2F, F2I) sits in it. Then, at the main path's
[b=16, tn=512, vn=9] with hn=512 and the covariance pass's hn=1024, each
variant at each forced pixel chunk (0: the C entry's own choice) is
checked against ``voting.count_inliers_plain_bf16`` (exact equality) and
timed warm (``chip_smoke.cuda_ms``). ``--old`` names an earlier source
of the same file (a C entry without the chunk argument, one float per
rounding): its pair loop is counted and it is timed beside them, in the
same process, on the same card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SOURCE = os.path.join(REPO, "pvnet_tpu_torch", "csrc", "count_inliers.cu")
KERNEL = "count_inliers_bf16_kernel"
CONVERSIONS = ("F2F", "F2FP", "I2F", "F2I", "I2FP", "F2IP")
# float32 multiplies, adds and subtracts of one pair in the old kernel: dx,
# dy, dx*nx, dy*ny, dot, dx^2, dy^2, d2, dot^2, t2*d2, *n2; bf16x2
# instructions of two pairs in the new one: the same 11 and |dot|
ARITH_PER_PAIR = {False: 11, True: 12}
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_.]*)([^;]*);")


def build(src: str, defines, out_dir: str, tag: str):
    """Start nvcc on src into out_dir/lib<tag>.so; returns (path, proc)."""
    from pvnet_tpu_torch.ops import kernel_lib
    path = os.path.join(out_dir, f"lib{tag}.so")
    cmd = [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, "-Xptxas", "-v",
           *[f"-D{d}" for d in defines], "-shared", "-o", path, src]
    return path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)


def ptxas_usage(log: str) -> str:
    """ptxas's registers / spill line for the bf16 kernel."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and KERNEL in line:
            keep = [x.split("ptxas info    :")[-1].strip()
                    for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            return "; ".join(keep)
    return "not found"


def sass_function(lib: str, dump: str) -> list:
    """[(address, opcode, operands)] of the bf16 kernel in lib's SASS;
    its text is written to ``dump``."""
    from pvnet_tpu_torch.ops import kernel_lib
    cuobjdump = os.path.join(os.path.dirname(kernel_lib._nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, lines, inside = [], [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = KERNEL in line
        if inside:
            lines.append(line)
        m = _LINE.search(line) if inside else None
        if m:
            out.append((int(m.group(1), 16), m.group(2), m.group(3)))
    with open(dump, "w") as f:
        f.write("\n".join(lines) + "\n")
    if not out:
        raise RuntimeError(f"{KERNEL} not found in {lib}'s SASS")
    return out


def is_arith(op: str, packed: bool) -> bool:
    base = op.split(".")[0]
    if packed:
        return base in ("HADD2", "HMUL2", "HFMA2") and "BF16" in op
    return base in ("FADD", "FMUL")


def pair_loop(sass, packed: bool) -> dict:
    """The innermost loop holding the pair arithmetic: instructions by
    opcode, pairs a pass covers, instructions per pair, conversions."""
    addr = [a for a, _, _ in sass]
    loops = []
    for a, op, rest in sass:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= a:
            loops.append((int(m.group(1), 16), a))
    best = None
    for lo, hi in loops:
        inner = any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                    for l2, h2 in loops)
        body = [op for a, op, _ in sass if lo <= a <= hi]
        n = sum(is_arith(op, packed) for op in body)
        if not inner and n and (best is None or n > best[0]):
            best = (n, lo, hi, body)
    if best is None:
        raise RuntimeError("no loop with pair arithmetic found")
    n, lo, hi, body = best
    pairs = n / ARITH_PER_PAIR[packed] * (2 if packed else 1)
    ops = Counter(op for op in body)
    return {"range": [hex(lo), hex(hi)], "instructions": len(body),
            "pairs": pairs, "per_pair": len(body) / pairs,
            "conversions": sorted(o for o in ops
                                  if o.split(".")[0] in CONVERSIONS),
            "opcodes": dict(ops.most_common()),
            "kernel_instructions": len(addr)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default="128x2,128x4,256x2,64x2,64x4")
    p.add_argument("--chunks", default="0,128,256,512")
    p.add_argument("--scaling", action="store_true",
                   help="also time the first variant at tn = 512, 1024, "
                        "2048, 4096 (hn=512), a zero fill of the counts "
                        "and an empty kernel")
    p.add_argument("--old", default=None,
                   help="an earlier count_inliers.cu to count and time")
    p.add_argument("--out", default=os.path.join(
        REPO, "pvnet_tpu_torch", "build", "k3_bf16_tune.json"),
        help="the report; each shape's SASS goes beside it")
    args = p.parse_args(argv)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pvnet_tpu_torch.ops import kernel_lib, voting

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    variants = [tuple(int(x) for x in v.split("x"))
                for v in args.variants.split(",")]
    chunks = [int(c) for c in args.chunks.split(",")]
    os.makedirs(kernel_lib.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=kernel_lib.BUILD_DIR, prefix="k3_bf16_tune_")
    jobs = {f"{t}x{r}": build(SOURCE, [f"K3_BF16_THREADS={t}",
                                       f"K3_BF16_R={r}"], tmp, f"{t}x{r}")
            for t, r in variants}
    if args.old:
        jobs["old"] = build(args.old, [], tmp, "old")
    report = {"device": smi, "variants": {}}
    libs = {}
    for tag, (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {tag} failed:\n{log}")
        sass = sass_function(path, os.path.join(
            os.path.dirname(args.out), f"k3_bf16_{tag}.sass"))
        try:
            loop = pair_loop(sass, packed=tag != "old")
            said = (f"pair loop {loop['instructions']} instructions for "
                    f"{loop['pairs']:g} pairs = {loop['per_pair']:.2f} a "
                    f"pair; conversions in it: "
                    f"{loop['conversions'] or 'none'}; {loop['opcodes']}")
        except RuntimeError as e:        # the dumped SASS still tells
            loop, said = {"error": str(e)}, f"pair loop: {e}"
        report["variants"][tag] = {"ptxas": ptxas_usage(log), "loop": loop}
        print(f"{tag}: ptxas {ptxas_usage(log)}; {said}", flush=True)
        lib = ctypes.CDLL(path)
        fn = lib.pvnet_count_inliers_bf16
        fn.argtypes = kernel_lib._SIGNATURES["pvnet_count_inliers_bf16"]
        if tag == "old":                              # no chunk argument
            fn.argtypes = fn.argtypes[:12] + fn.argtypes[13:]
        fn.restype = ctypes.c_int
        libs[tag] = fn

    g = torch.Generator(device=dev).manual_seed(0)
    b, tn, vn = cs.BATCH, 512, cs.VN
    fg = cs.random_sample(dev, g, b, tn, vn)
    ctr = voting._centroid(fg.coords, fg.valid)
    t2, eps2 = (float(c) for c in voting._bf16_constants(0.99, "cpu"))
    stream = torch.cuda.current_stream().cuda_stream
    times = {}
    for hn in (512, 1024):
        hyps = torch.rand((b, hn, vn, 2), generator=g, device=dev) * 140 - 20
        want = voting.count_inliers_plain_bf16(fg, hyps, 0.99)
        counts = torch.empty_like(want)

        def launch(fn, chunk):
            extra = () if chunk is None else (chunk,)
            err = fn(fg.coords.data_ptr(), fg.dirs.data_ptr(),
                     fg.valid.data_ptr(), hyps.data_ptr(), ctr.data_ptr(),
                     counts.data_ptr(), b, vn, tn, hn, t2, eps2, *extra,
                     stream)
            kernel_lib.check(err, "pvnet_count_inliers_bf16")
        for tag, fn in libs.items():
            for chunk in ([None] if tag == "old" else chunks):
                counts.fill_(-1)
                launch(fn, chunk)
                torch.cuda.synchronize()
                key = f"{tag} hn={hn} chunk={chunk}"
                wrong = int((counts != want).sum())
                if wrong:
                    report.setdefault("unequal", {})[key] = wrong
                    print(f"{key}: {wrong} counts differ from the plain "
                          f"version's", flush=True)
                    continue
                times[key] = cs.cuda_ms(lambda: launch(fn, chunk))
                print(f"{key}: {times[key]:.4f} ms (equal to plain)",
                      flush=True)
    if args.scaling:
        fn, first = libs[next(iter(libs))], next(iter(libs))
        hn = 512
        for tn in (512, 1024, 2048, 4096):
            fg = cs.random_sample(dev, g, b, tn, vn)
            ctr = voting._centroid(fg.coords, fg.valid)
            hyps = torch.rand((b, hn, vn, 2), generator=g,
                              device=dev) * 140 - 20
            counts = torch.empty((b, hn, vn), dtype=torch.int32,
                                 device=dev)

            def run(chunk):
                kernel_lib.check(fn(
                    fg.coords.data_ptr(), fg.dirs.data_ptr(),
                    fg.valid.data_ptr(), hyps.data_ptr(), ctr.data_ptr(),
                    counts.data_ptr(), b, vn, tn, hn, t2, eps2, chunk,
                    stream), "pvnet_count_inliers_bf16")
            key = f"{first} hn={hn} tn={tn} chunk=0"
            times[key] = cs.cuda_ms(lambda: run(0))
            print(f"{key}: {times[key]:.4f} ms", flush=True)
        times["zero fill of the counts"] = cs.cuda_ms(counts.zero_)
        times["empty kernel"] = cs.cuda_ms(lambda: torch.cuda._sleep(0))
        for key in ("zero fill of the counts", "empty kernel"):
            print(f"{key}: {times[key]:.4f} ms", flush=True)
    report["ms"] = times
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {args.out}")
    return 1 if report.get("unequal") else 0


if __name__ == "__main__":
    sys.exit(main())
