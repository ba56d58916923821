#!/usr/bin/env python3
"""The JPEG pixel kernel (``jpeg_pixels_kernel`` of
``pvnet_tpu_torch/csrc/jpeg_decode.cu``) beside an earlier version of the
same source, on one CUDA card.

  python3 tools/bench_torch_jpeg.py [--old OLD/jpeg_decode.cu] \
      [--parent_smoke OLD_CHECKOUT] [--phases] \
      [--out pvnet_tpu_torch/build/jpeg_bench.json]

Each source is built alone into a shared library (the port's nvcc flags
and ``-Xptxas -v``, one nvcc per source, started together); for each it
prints what ptxas reports for its kernels (registers, shared memory,
spills) and the 4:2:0 kernel's SASS instructions by class
(``cuobjdump -sass``: static counts, each instruction once). Both C
entries (``pvnet_jpeg_pixels``, one signature) are then called on the 24
frames of assets/linemod_mini (480x640 4:2:0, coefficients from the C
entropy decoder) and at smaller geometries, each output held equal to
``jpeg_pixels_plain``, and timed in turns (old, new, new, old) at b=1, 8
and 24: warm (the mean of 50 launches on the same inputs behind a ~50 ms
sleep kernel, chip_smoke.cuda_ms) and cold (the inputs rotated over copies
past the 50 MB L2, chip_smoke.cold_ms), beside the bound of
chip_smoke.decode_bound_ms. ``--parent_smoke`` also runs the (m1)-(m3)
checks of another checkout's chip_smoke.py (e.g. the parent commit
unpacked with ``git archive`` into the gitignored ``_archive/``) in a
process of its own, on the same card, and prints their lines.
``--phases`` builds a copy of the new source in which thread 0 of each
block reads the card's nanosecond clock (%globaltimer) between the
kernel's phases, and prints each phase's mean over the blocks of one
launch at b=1 and b=24 (the 32 ns clock makes the short phases coarse).
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
SOURCE = os.path.join(REPO, "pvnet_tpu_torch", "csrc", "jpeg_decode.cu")
MINI = os.path.join(REPO, "assets", "linemod_mini")
KERNEL = "jpeg_pixels_kernel"
# geometries held exact besides the frames: (h, w, h factors, v factors)
GEOMETRIES = [(37, 53, (2, 1, 1), (2, 1, 1)), (61, 83, (1,), (1,)),
              (37, 53, (2, 1, 1), (1, 1, 1)), (17, 3, (2, 1, 1), (2, 1, 1)),
              (481, 647, (2, 1, 1), (2, 1, 1))]
# SASS opcode (before the first dot) -> class
CLASSES = {
    "integer": ("IMAD", "IADD3", "IADD", "LOP3", "SHF", "SHL", "SHR", "LEA",
                "IMNMX", "VIMNMX", "ISETP", "SEL", "PRMT", "IABS", "BMSK",
                "SGXT", "IMUL", "FLO", "POPC", "BREV", "I2I", "IDP"),
    "shared memory": ("LDS", "STS", "LDSM", "ATOMS"),
    "device memory": ("LDG", "STG", "LDGSTS", "LD", "ST", "RED", "ATOMG"),
    "control": ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "WARPSYNC", "CALL",
                "RET", "YIELD", "NOP", "SHFL", "VOTE", "DEPBAR", "BPT",
                "MEMBAR", "ERRBAR", "WARPGROUP"),
    "uniform": ("UMOV", "UIADD3", "ULDC", "ULOP3", "USHF", "UIMAD", "ULEA",
                "UISETP", "USEL", "UPRMT", "S2UR", "R2UR", "UFLO", "UPOPC",
                "UBMSK", "USGXT", "UBREV", "UIMNMX"),
    "moves": ("MOV", "S2R", "CS2R", "P2R", "R2P", "PLOP3"),
}
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                   r"([A-Z][A-Z0-9_]*)[.A-Z0-9_]*([^;]*);")


def build(src: str, out_dir: str, tag: str):
    """Start nvcc on src into out_dir/lib<tag>.so; returns (path, proc)."""
    from pvnet_tpu_torch.ops import kernel_lib
    path = os.path.join(out_dir, f"lib{tag}.so")
    cmd = [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, "-Xptxas", "-v",
           "-shared", "-o", path, src]
    return path, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)


def ptxas_usage(log: str) -> list:
    """ptxas's lines for each pixel kernel: [(function, usage)]."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and KERNEL in line:
            name = line.split("'")[1] if "'" in line else line
            keep = [x.split("ptxas info    :")[-1].strip()
                    for x in lines[i + 1:i + 5]
                    if "Used" in x or "spill" in x]
            out.append((name, "; ".join(keep)))
    return out


def sass_classes(lib: str, dump: str) -> dict:
    """{function: {class: count}} of the pixel kernels in lib's SASS; the
    text goes to ``dump``."""
    from pvnet_tpu_torch.ops import kernel_lib
    cuobjdump = os.path.join(os.path.dirname(kernel_lib._nvcc()),
                             "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    with open(dump, "w") as f:
        f.write(text)
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            cur = name if KERNEL in name else None
            if cur:
                funcs[cur] = Counter()
            continue
        m = _LINE.search(line)
        if cur and m:
            op = m.group(2)
            cls = next((k for k, ops in CLASSES.items() if op in ops),
                       "other " + op)
            funcs[cur][cls] += 1
    return {k: dict(v.most_common()) for k, v in funcs.items()}


def load(path: str):
    from pvnet_tpu_torch.ops import kernel_lib
    lib = ctypes.CDLL(path)
    fn = lib.pvnet_jpeg_pixels
    fn.argtypes = kernel_lib._SIGNATURES["pvnet_jpeg_pixels"]
    fn.restype = ctypes.c_int
    return fn


def call(fn, coef, qt, geo, out):
    import torch
    h = list(geo.h) + [1] * (3 - geo.nc)
    v = list(geo.v) + [1] * (3 - geo.nc)
    err = fn(coef.data_ptr(), qt.data_ptr(), out.data_ptr(), coef.shape[0],
             geo.height, geo.width, geo.nc, h[0], v[0], h[1], v[1], h[2],
             v[2], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"pvnet_jpeg_pixels: cudaError_t {err}")


def frames(dev):
    """The 24 frames' coefficients and tables on the card, and geometry."""
    import numpy as np
    import torch
    from pvnet_tpu_torch.data import image_io as IO
    d = os.path.join(MINI, "LINEMOD", "duck", "JPEGImages")
    cs = [IO.jpeg_coefficients_native(open(os.path.join(d, f), "rb").read())
          for f in sorted(os.listdir(d))]
    geo = cs[0].geometry
    assert all(c.geometry == geo for c in cs)
    coef = torch.from_numpy(np.stack([c.coef for c in cs])).to(dev)
    qt = torch.from_numpy(np.stack([c.qt for c in cs])).to(dev)
    return coef, qt, geo


def random_coefficients(geo, b, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    n = geo.total_blocks()
    coef = (torch.randn(b, n, 64, generator=g)
            * torch.linspace(300, 5, 64)).round()
    coef[..., 0] = torch.randint(-1024, 1024, (b, n), generator=g)
    qt = torch.randint(1, 100, (b, geo.nc, 64), generator=g)
    return coef.to(torch.int16), qt.to(torch.int32)


# --phases: where an instrumented copy of the source has thread 0 of each
# block read %globaltimer (ns), after (+) or before (-) each text
PHASE_MARKS = [
    ("+", "  extern __shared__ __align__(16) uint8_t sm[];\n"),
    ("-", "  // then the halo blocks, once the groups say which"),
    ("+", "  const int ns = gr.ns;\n"),
    ("-", '  asm volatile("cp.async.wait_all;'),
    ("-", "\n  // The transforms, each warp"),
    ("-", "  // Edge replication"),
    ("+", "  if (fixed) __syncthreads();\n"),
    ("-", "  // The RGB rows to device memory"),
    ("+", "        for (int b = head + 16 * body; b < nbytes; b++) "
          "gd[b] = sr[b];\n      }\n    }\n  }\n"),
]
PHASES = ["own copies issued", "slot groups", "halo copies issued",
          "copies in", "transforms", "edge replication", "pixels",
          "copy out"]


def instrumented(src: str) -> str:
    """The source with a timestamp at each of PHASE_MARKS, into
    pvnet_phase_t[block][mark], and a C entry that reads them."""
    n = len(PHASE_MARKS)
    for k, (side, text) in enumerate(PHASE_MARKS):
        assert src.count(text) == 1, text
        stamp = ("  if (threadIdx.x == 0) { unsigned long long t_; "
                 "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
                 "pvnet_phase_t[((blockIdx.z * gridDim.y + blockIdx.y) * "
                 f"gridDim.x + blockIdx.x) * {n} + {k}] = t_; }}\n")
        src = src.replace(text, text + stamp if side == "+" else stamp + text)
    src = src.replace("struct Geo {", "__device__ unsigned long long "
                      f"pvnet_phase_t[{n} * (1 << 16)];\nstruct Geo {{", 1)
    return src + ('\nextern "C" int pvnet_jpeg_phases(void* host, size_t n) '
                  "{ return (int)cudaMemcpyFromSymbol(host, pvnet_phase_t, "
                  "n); }\n")


def phase_times(path: str, coef, qt, geo, batches) -> dict:
    """{b: {phase: mean us over the launch's blocks}, with the blocks'
    mean life and the launch's span} from the instrumented library."""
    import numpy as np
    import torch
    lib = ctypes.CDLL(path)
    fn = load(path)
    n = len(PHASE_MARKS)
    res = {}
    for b in batches:
        c, q = coef[:b].contiguous(), qt[:b].contiguous()
        out = torch.empty((b, geo.height, geo.width, 3), dtype=torch.uint8,
                          device=c.device)
        for _ in range(3):
            call(fn, c, q, geo, out)
        torch.cuda.synchronize()
        buf = np.zeros(n << 16, np.uint64)
        assert lib.pvnet_jpeg_phases(ctypes.c_void_p(buf.ctypes.data),
                                     ctypes.c_size_t(buf.nbytes)) == 0
        t = buf.reshape(-1, n).astype(np.int64)
        t = t[t[:, 0] > 0]            # the launch's blocks
        d = np.diff(t, axis=1).mean(0) / 1e3
        res[b] = dict(zip(PHASES, d.round(3).tolist()))
        res[b]["block life"] = float(((t[:, -1] - t[:, 0]).mean() / 1e3)
                                     .round(3))
        res[b]["span"] = float(((t[:, -1].max() - t[:, 0].min()) / 1e3)
                               .round(3))
        res[b]["blocks"] = len(t)
    return res


def parent_smoke(checkout: str) -> str:
    """Another checkout's chip_smoke.check_decoder ((m1)-(m3)) on
    assets/linemod_mini, in a process of its own; its output."""
    code = (
        "import json, os, subprocess, sys\n"
        f"sys.path.insert(0, {os.path.abspath(checkout)!r})\n"
        "import torch, chip_smoke as m\n"
        "m.SMI = subprocess.run(['nvidia-smi', '--query-gpu=name,power."
        "limit', '--format=csv,noheader'], capture_output=True, text=True"
        ").stdout.strip()\n"
        f"root = {MINI!r}\n"
        "man = json.load(open(os.path.join(root, 'manifest.json')))\n"
        "k = m.check_decoder(torch.device('cuda', 0), root, man)\n"
        "print(json.dumps(k))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=checkout, timeout=600)
    if r.returncode:
        raise RuntimeError(f"parent smoke failed:\n{r.stdout}\n{r.stderr}")
    return r.stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="an earlier jpeg_decode.cu to build and time")
    ap.add_argument("--parent_smoke", default=None,
                    help="a checkout whose chip_smoke (m1)-(m3) to run")
    ap.add_argument("--phases", action="store_true",
                    help="time the new kernel's phases at b=1 and 24")
    ap.add_argument("--out", default=os.path.join(
        REPO, "pvnet_tpu_torch", "build", "jpeg_bench.json"))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_jpeg: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from pvnet_tpu_torch.data import image_io as IO
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    report = {"device": smi, "versions": {}}
    if args.parent_smoke:
        text = parent_smoke(args.parent_smoke)
        print("parent chip_smoke (m1)-(m3):\n" + text, flush=True)
        report["parent_smoke"] = json.loads(text.strip().splitlines()[-1])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    dev = torch.device("cuda", 0)
    srcs = {"new": SOURCE}
    if args.old:
        srcs["old"] = os.path.abspath(args.old)
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        if args.phases:
            srcs["phases"] = os.path.join(tmp, "phases.cu")
            with open(SOURCE) as f, open(srcs["phases"], "w") as g:
                g.write(instrumented(f.read()))
        procs = {tag: build(src, tmp, tag) for tag, src in srcs.items()}
        for tag, (path, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise RuntimeError(f"nvcc {tag} failed:\n{log}")
            if tag == "phases":
                continue
            dump = os.path.splitext(args.out)[0] + f"_{tag}.sass"
            usage = ptxas_usage(log)
            sass = sass_classes(path, dump)
            report["versions"][tag] = {"ptxas": usage, "sass": sass}
            for name, u in usage:
                print(f"{tag} ptxas {name}: {u}", flush=True)
            for name, cls in sass.items():
                if tag == "old" or "ILi3ELi2ELi2E" in name:
                    print(f"{tag} SASS {name} (static, by class): {cls}",
                          flush=True)
            fns[tag] = load(path)

        coef, qt, geo = frames(dev)
        if args.phases:
            report["phases_us"] = phase_times(procs["phases"][0], coef, qt,
                                              geo, (1, 24))
            for b, ph in report["phases_us"].items():
                print(f"phases b={b} (us, means over the blocks): {ph}",
                      flush=True)
        want = IO.jpeg_pixels_plain(coef, qt, geo)
        for tag, fn in fns.items():
            out = torch.empty_like(want)
            call(fn, coef, qt, geo, out)
            torch.cuda.synchronize()
            assert torch.equal(out, want), f"{tag} != plain on the frames"
            for i, (h, w, hs, vs) in enumerate(GEOMETRIES):
                g = IO.JpegGeometry(h, w, hs, vs)
                c, q = random_coefficients(g, 3, i)
                res = torch.empty((3, h, w, 3), dtype=torch.uint8,
                                  device=dev)
                call(fn, c.to(dev), q.to(dev), g, res)
                assert torch.equal(res.cpu(), IO.jpeg_pixels_plain(c, q, g)), \
                    f"{tag} != plain at {g}"
        print(f"exact against jpeg_pixels_plain on the {len(coef)} frames "
              f"and {len(GEOMETRIES)} geometries: {sorted(fns)}", flush=True)

        order = ["old", "new", "new", "old"] if "old" in fns else ["new"]
        times = {tag: {} for tag in fns}
        for b in (1, 8, 24):
            c, q = coef[:b].contiguous(), qt[:b].contiguous()
            out = torch.empty((b, geo.height, geo.width, 3),
                              dtype=torch.uint8, device=dev)
            copies = [(c.clone(), q.clone())
                      for _ in range(CS.L2_BYTES // CS._nbytes((c, q)) + 1)]
            bound, by = CS.decode_bound_ms(geo, b)
            for tag in order:
                fn = fns[tag]
                warm = CS.cuda_ms(lambda: call(fn, c, q, geo, out), iters=50)
                cold = CS.cold_ms(lambda x: call(fn, x[0], x[1], geo, out),
                                  copies)
                times[tag].setdefault(b, []).append((warm, cold))
                print(f"{tag} b={b}: warm {warm:.4f} ms ({bound / warm:.1%} "
                      f"of the {bound:.4f} ms bound, {by}), cold "
                      f"{cold:.4f} ms ({bound / cold:.1%})", flush=True)
            del copies
        report["times"] = {tag: {str(b): v for b, v in t.items()}
                           for tag, t in times.items()}
        report["bound_ms"] = {str(b): CS.decode_bound_ms(geo, b)[0]
                              for b in (1, 8, 24)}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"times": report["times"],
                      "bound_ms": report["bound_ms"], "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
