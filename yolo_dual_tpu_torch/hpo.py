"""Hyperparameter search CLI (port of tools/hpo.py; reference
utils/loggers/wandb/sweep.py, utils/loggers/clearml/hpo.py,
utils/loggers/comet/hpo.py): one command, four backends. A trial is one short
segment.train run; its fitness is that run's best 0.1 · mAP50 + 0.9 · mAP
(box and mask, metrics/seg.py:fitness_seg).

    # local random search, 20 short trainings
    python -m yolo_dual_tpu_torch.hpo --data DIR --cfg yolov5n-seg.yaml --epochs 3 --trials 20

    # GA refinement from the best so far (resumes hpo.csv)
    python -m yolo_dual_tpu_torch.hpo ... --strategy evolve

    # provider-managed sweeps (need the package and its credentials)
    python -m yolo_dual_tpu_torch.hpo ... --backend wandb --trials 10
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path


def make_objective(opt):
    """hyp -> the fitness of one segment.train run with it (0 when the run fails)."""
    from yolo_dual_tpu_torch.segment import train as seg_train

    def objective(hyp: dict) -> float:
        with tempfile.TemporaryDirectory() as td:
            hyp_file = Path(td) / "hyp.json"
            hyp_file.write_text(json.dumps({k: float(v) for k, v in hyp.items()}))
            topt = seg_train.parse_opt([
                "--cfg", opt.cfg, "--data", opt.data, "--hyp", str(hyp_file),
                "--epochs", str(opt.epochs), "--batch-size", str(opt.batch_size),
                "--imgsz", str(opt.imgsz), "--project", td, "--name", "trial",
                "--exist-ok", "--device", opt.device, "--noplots"])
            try:
                return float(seg_train.train(topt))
            except Exception as e:  # a diverging trial is fitness 0, not a crash
                print(f"HPO trial failed: {e}", file=sys.stderr)
                return 0.0

    return objective


def main(opt):
    from yolo_dual_tpu_torch.utils.hpo import (HyperparameterSearch, run_clearml_hpo,
                                               run_comet_hpo, run_wandb_sweep)
    if opt.backend == "local":
        search = HyperparameterSearch(make_objective(opt), strategy=opt.strategy,
                                      trials=opt.trials, save_dir=opt.save_dir, seed=opt.seed)
        fitness, hyp = search.run()
        print(f"best fitness {fitness:.4g}")
        out = Path(opt.save_dir) / "hyp_best.json"
        out.write_text(json.dumps(hyp, indent=2))
        print(f"best hyp saved to {out}")
        return fitness, hyp
    if opt.backend == "wandb":
        return run_wandb_sweep(make_objective(opt), count=opt.trials, data=opt.data,
                               epochs=opt.epochs, batch_size=opt.batch_size)
    if opt.backend == "clearml":
        if not opt.base_task_id:
            raise SystemExit("--base-task-id is required for clearml")
        return run_clearml_hpo(opt.base_task_id, max_trials=opt.trials)
    return run_comet_hpo(make_objective(opt), max_trials=opt.trials)


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Hyperparameter search (PyTorch port)")
    p.add_argument("--data", default="coco128-seg.yaml")
    p.add_argument("--cfg", default="yolov5n-seg.yaml")
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--backend", default="local", choices=["local", "wandb", "clearml", "comet"])
    p.add_argument("--strategy", default="random", choices=["random", "evolve"])
    p.add_argument("--save-dir", default="runs/hpo")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--base-task-id", default="", help="clearml template task")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    main(parse_opt())
