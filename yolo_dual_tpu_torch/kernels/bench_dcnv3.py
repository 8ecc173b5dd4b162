"""Inspect and time the DCNv3 kernels (csrc/dcnv3.cu, csrc/dcnv3_bwd.cu) on one
NVIDIA GPU. Run from the repository's root, as it times with chip_smoke.py's
helpers:

    python -m yolo_dual_tpu_torch.kernels.bench_dcnv3 sass
    python -m yolo_dual_tpu_torch.kernels.bench_dcnv3 plans [--out FILE]

`sass` compiles both sources with nvcc -Xptxas -v (registers, spills, shared
memory of each kernel) and counts, in the compiled code (cuobjdump -sass), the
atomic instructions by kind: ATOMS (shared memory), RED/ATOMG (device memory)
and any compare-and-swap loop. `plans` times each kernel at the three DCNv3
shapes of yolov5s-seg-dcnv3 at 640 px, at bs 16 (forward and backward) and at
batch 1 and bs 32 (forward), under the chosen plan and a grid of others (tile,
window margin, channels a chunk; at batch 1 tiles and chunks, each chunk in a
block of its own): CUDA events over 20 launches on inputs cycled past the 50 MB
L2, each plan's result held against the plain version first (1e-5; the
backward 1e-5 of each gradient's largest magnitude), with the share of samples
that leave the window, and at batch 1 the kernel's own device time
(torch.profiler). Inputs are seeded: x N(0, 1), offsets N(0, 1.5 px), a
softmaxed mask. chip_smoke.py times the chosen plans through the public
wrappers.
"""

from __future__ import annotations

import argparse
import itertools
import json
import re
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

import torch

SHAPES = ((80, 80, 64), (40, 40, 128), (20, 20, 256))
ARGS = (3, 1, 1, 1, 1)  # kernel, stride, pad, dilation, group


def sass() -> dict:
    from yolo_dual_tpu_torch.kernels import build
    out = {}
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        for name in ("dcnv3", "dcnv3_bwd"):
            so = Path(tmp) / f"{name}.so"
            proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                                   str(so), str(build.CSRC / f"{name}.cu")],
                                  capture_output=True, text=True, check=True)
            ptxas = [ln.strip() for ln in proc.stderr.splitlines()
                     if "registers" in ln or "spill" in ln or "smem" in ln]
            code = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True,
                                  text=True, check=True).stdout
            ops = Counter(m.group(1) for m in
                          re.finditer(r"\b((?:ATOMS|ATOMG|ATOM|RED|CAS|ATOMS\.CAS)[.\w]*)", code))
            out[name] = {"ptxas": ptxas, "atomic_ops": dict(ops)}
            print(f"sass {name}: {json.dumps(out[name])}", flush=True)
    return out


def make_plan(b, h, w, c, th, tw, margin, cc, backward, split=False):
    """The DCNv3Plan of the given tile, margin and chunk, or None where it does
    not fit; with `split` (forward only) each chunk in a block of its own."""
    from yolo_dual_tpu_torch.kernels.dcn_sampling import (
        CHUNK, SHARED_BYTES, DCNv3Plan, dcnv3_shared_bytes, dcnv3_window)
    k, s, p, d, g = ARGS
    win_off, wh, ww = dcnv3_window(th, tw, k, s, p, d, 1.0, margin)
    shared = dcnv3_shared_bytes(th, tw, k * k, cc, wh, ww, backward)
    if shared > SHARED_BYTES or cc > min(c, CHUNK[backward]):
        return None
    n_chunks = -(-c // cc)
    blocks = b * g * -(-h // th) * -(-w // tw) * (n_chunks if split else 1)
    return DCNv3Plan(th, tw, cc, 1 if split else n_chunks, win_off, wh, ww, shared, blocks)


def inputs(gen, b, h, w, c):
    x = torch.randn(b, h, w, c, device="cuda", generator=gen)
    offset = torch.randn(b, h, w, 18, device="cuda", generator=gen) * 1.5
    mask = torch.randn(b, h, w, 9, device="cuda", generator=gen).softmax(-1)
    gout = torch.randn(b, h, w, c, device="cuda", generator=gen)
    return x, offset, mask, gout


def run(x, offset, mask, gout, c, plan, backward):
    from yolo_dual_tpu_torch.kernels.dcn_sampling import _backward, _launch
    if backward:
        return _backward(x, offset, mask, gout, (*ARGS, c, 1.0), plan=plan)
    out = torch.empty_like(x)
    _launch("dcnv3_sampling_launch", (x, offset, mask, out), x, offset, *ARGS, c, 1.0, plan=plan)
    return (out,)


def input_sets(gen, b, h, w, c, total=96 * 2**20):
    """Seeded input sets, as many as it takes to pass `total` bytes (the L2)."""
    sets = [inputs(gen, b, h, w, c)]
    per = sum(t.numel() * 4 for t in sets[0])
    return sets + [inputs(gen, b, h, w, c) for _ in range(max(0, -(-total // per) - 1))]


def plans() -> list:
    from chip_smoke import cuda_ms, profiled_kernel_ms
    from yolo_dual_tpu_torch.kernels.dcn_sampling import (
        dcnv3_core, dcnv3_core_bwd, dcnv3_plan, dcnv3_window_escapes)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []
    cases = [(16, True), (16, False), (1, False), (32, False)]
    grid = list(itertools.product(((8, 8), (4, 8), (4, 4), (2, 4)), (1, 2), (32, 64, 128)))
    for (b, backward), (h, w, c) in itertools.product(cases, SHAPES):
        sets = input_sets(gen, b, h, w, c)
        x, offset, mask, gout = sets[0]
        if backward:
            want = dcnv3_core_bwd(x, offset, mask, gout, *ARGS, c, 1.0)
        else:
            want = (dcnv3_core(x, offset, mask, *ARGS, c, 1.0),)
        variants = [("chosen", dcnv3_plan(b, h, w, 1, c, *ARGS[:4], 1.0, backward))]
        if b == 16:  # the grid at the training batch
            variants += [(f"tile{th}x{tw} margin{m} cc{cc}",
                          make_plan(b, h, w, c, th, tw, m, cc, backward))
                         for (th, tw), m, cc in grid]
        if b == 1:  # and at batch 1 (forward), each chunk in a block of its own
            variants += [(f"tile{th}x{tw} margin1 cc{cc} split",
                          make_plan(b, h, w, c, th, tw, 1, cc, backward, split=True))
                         for (th, tw), cc in itertools.product(
                             ((8, 8), (4, 8), (4, 4), (2, 4), (2, 2), (1, 2)), (32, 64, 128))]
        for label, plan in variants:
            if plan is None:
                continue
            got = run(x, offset, mask, gout, c, plan, backward)
            torch.cuda.synchronize()
            errs = [((a - r).abs().max() / max(1.0, r.abs().max().item())).item()
                    for a, r in zip(got, want)]
            it = iter(itertools.cycle(sets))
            ms = cuda_ms(lambda: run(*next(it), c, plan, backward), 20)
            row = {"kernel": "K3" if backward else "K2", "shape": [b, h, w, c], "plan": label,
                   **plan._asdict(), "ms": ms, "rel_err": max(errs),
                   "escapes": dcnv3_window_escapes(offset, h, w, *ARGS[:4], 1, 1.0, plan)}
            if b == 1:  # the host's wrapper is most of `ms` here: the kernel's own time too
                row["device_ms"] = profiled_kernel_ms(
                    lambda: run(*next(it), c, plan, backward),
                    "dcnv3_backward_kernel" if backward else "dcnv3_sampling_kernel", 50)
            rows.append(row)
            print("plan " + json.dumps(row), flush=True)
            if max(errs) > 1e-5:
                raise AssertionError(f"{label} at {b}x{h}x{w}x{c}: error {max(errs)}")
        del sets, want
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("sass", "plans"))
    ap.add_argument("--out", help="also write the results as JSON here")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available() and a.what != "sass":
        print("bench_dcnv3: needs a CUDA device", file=sys.stderr)
        return 1
    res = {"sass": sass, "plans": plans}[a.what]()
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
