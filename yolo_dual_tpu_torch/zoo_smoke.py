"""Model-zoo smoke CLI (port of tools/zoo_smoke.py): build every config under
yolo_dual_tpu_torch/configs/** and report each config's exception, the
reference's `python models/yolo.py --test` (models/yolo.py:409-414). By
default each config's graph is built and run at `--imgsz` on the meta device
(shapes only, no weights, no device: JAX's free `jax.eval_shape` probe);
`--profile` builds the model on `--device` instead and times one real
forward after a first one, synchronised on CUDA. The exit code is 1 when any
config failed.

Usage:
    python -m yolo_dual_tpu_torch.zoo_smoke [--glob 'segment/*'] [--imgsz 64] [--profile]
        [--device cuda|cpu] [-v]

The package's configs are JSON copies of JAX's YAML files: a glob that names
`.yaml` files matches their `.json` copies.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback
from pathlib import Path

import torch

CONFIGS = Path(__file__).resolve().parent / "configs"


def zoo_configs(glob: str = "**/*") -> list:
    """The model configs under CONFIGS matching `glob` (hyperparameter and
    data files left out), sorted."""
    return sorted(p for p in CONFIGS.glob(glob.replace(".yaml", ".json"))
                  if p.suffix == ".json" and p.parent.name not in ("hyps", "data"))


def shape_probe(cfg, imgsz: int):
    """Compile `cfg`, build its graph on the meta device and run it on a
    (1, ch, imgsz, imgsz) input: shapes only, as JAX's eval_shape of init and
    apply."""
    from yolo_dual_tpu_torch.models.compiler import parse_config
    from yolo_dual_tpu_torch.models.model import GraphModel, _probe_strides
    from yolo_dual_tpu_torch.utils.general import load_config
    spec = _probe_strides(parse_config(load_config(cfg)))
    with torch.device("meta"), torch.no_grad():
        GraphModel(spec).eval()(torch.empty(1, spec.ch_in, imgsz, imgsz))


def timed_forward(cfg, imgsz: int, dev: torch.device) -> tuple:
    """(seconds to build `cfg` on `dev` and run a first forward, ms of a
    second forward) on a zero batch at imgsz."""
    from yolo_dual_tpu_torch.models.model import build_model

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev).eval()
    x = torch.zeros(1, model.spec.ch_in, imgsz, imgsz, device=dev)
    with torch.inference_mode():
        model(x)
        sync()
        t1 = time.perf_counter()
        model(x)
        sync()
    return t1 - t0, (time.perf_counter() - t1) * 1e3


def main(glob: str = "**/*", imgsz: int = 64, profile: bool = False, device="cuda",
         verbose: bool = False) -> int:
    if profile:
        from yolo_dual_tpu_torch.utils.general import select_device
        dev = select_device(device)
    cfgs = zoo_configs(glob)
    failures = []
    for cfg in cfgs:
        rel = cfg.relative_to(CONFIGS)
        try:
            if profile:
                build_s, fwd_ms = timed_forward(cfg, imgsz, dev)
                print(f"OK   {rel}  build+first forward {build_s:.1f}s  fwd {fwd_ms:.1f}ms",
                      flush=True)
            else:
                shape_probe(cfg, imgsz)
                print(f"OK   {rel}", flush=True)
        except Exception as e:  # noqa: BLE001 -- a report for each config, as the reference's
            failures.append(rel)
            print(f"FAIL {rel}: {type(e).__name__}: {e}", flush=True)
            if verbose:
                traceback.print_exc()
    print(f"\n{len(cfgs) - len(failures)}/{len(cfgs)} configs OK"
          + (f"; failures: {[str(f) for f in failures]}" if failures else ""), flush=True)
    return 1 if failures else 0


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--glob", default="**/*", help="configs under configs/ to build")
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=64)
    p.add_argument("--profile", action="store_true",
                   help="build each model on --device and time a real forward")
    p.add_argument("--device", default="cuda", help="the device of --profile")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="full traceback of each config that fails")
    return p.parse_args(argv)


if __name__ == "__main__":
    a = parse_opt()
    sys.exit(main(a.glob, a.imgsz, a.profile, a.device, a.verbose))
