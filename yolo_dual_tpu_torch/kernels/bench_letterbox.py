"""Inspect and time the letterbox kernel (csrc/letterbox.cu) on one NVIDIA GPU.
Run from the repository's root, as it takes its cases and timing helpers from
chip_smoke.py:

    python -m yolo_dual_tpu_torch.kernels.bench_letterbox sass
    python -m yolo_dual_tpu_torch.kernels.bench_letterbox plans [--out FILE]

`sass` compiles the source with nvcc -Xptxas -v and prints each kernel's
registers, spills and stack. `plans` runs every case of chip_smoke.py's
LETTERBOX_CASES under a grid of launches of the kernel (thread rows a block,
output columns a thread, with and without its branches on taps of weight 0),
the wrapper's own among them: each launch's result is held against the plain
version first (1e-5), then its own device time per launch is read from
torch.profiler over launches on seeded frames cycled past the 50 MB L2.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

GRID = [(both, rows, cols) for both in (0, 1) for rows in (4, 8) for cols in (1, 2, 4)]


def sass() -> list:
    from yolo_dual_tpu_torch.kernels import build
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                               str(Path(tmp) / "letterbox.so"), str(build.CSRC / "letterbox.cu")],
                              capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print("sass letterbox: " + json.dumps(lines), flush=True)
    return lines


def plans() -> list:
    from chip_smoke import LETTERBOX_CASES, frame_cycle, profiled_kernel_ms
    from yolo_dual_tpu_torch.kernels.preprocess import (
        LaunchParams, _launch, letterbox_launch_record, letterbox_normalize_reference)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows_out = []
    for name, ((b, h, w), s, fill, scaleup) in LETTERBOX_CASES.items():
        x = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, device="cuda", generator=gen)
        want = letterbox_normalize_reference(x, s, fill, scaleup)
        nxt = frame_cycle(gen, x)
        rec = letterbox_launch_record(h, w, s, fill, scaleup, "cuda")
        chosen = (rec.params.both, rec.params.rows, rec.params.cols)
        for plan in GRID:
            params = LaunchParams.from_buffer_copy(rec.params)
            params.both, params.rows, params.cols = plan
            out = torch.empty((b, 3, s, s), device="cuda")
            _launch(x, out, params)
            torch.cuda.synchronize()
            err = (out - want).abs().max().item()
            if not err <= 1e-5:
                raise AssertionError(f"letterbox {name} plan {plan}: max abs error {err}")

            def run(params=params):
                _launch(nxt(), torch.empty((b, 3, s, s), device="cuda"), params)
            row = {"case": name, "chosen": plan == chosen,
                   **dict(zip(("both", "rows", "cols"), plan)), "err": err,
                   "device_ms": profiled_kernel_ms(run, "letterbox", 20 if b > 1 else 200)}
            rows_out.append(row)
            print("plan " + json.dumps(row), flush=True)
        del x, want, nxt
        torch.cuda.empty_cache()
    return rows_out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("sass", "plans"))
    ap.add_argument("--out", help="also write the results as JSON to this file")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path.cwd()))
    result = sass() if args.mode == "sass" else plans()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
