"""Hyperparameter optimisation (port of yolo_dual_tpu/utils/hpo.py; reference
utils/loggers/wandb/sweep.py + sweep.yaml, utils/loggers/clearml/hpo.py,
utils/loggers/comet/hpo.py + optimizer_config.json): one search core with
thin provider bridges.

  - `HYP_SPACE`: the search space (the reference's sweep.yaml / ClearML
    UniformParameterRange table).
  - `HyperparameterSearch`: a local engine needing no service. Strategies
    "random" (the W&B sweep default) and "evolve" (the GA of utils/evolve.py
    seeded from the best so far). Trials go to hpo.csv, so a search resumes.
  - `wandb_sweep_config()` / `run_wandb_sweep()`, `run_clearml_hpo()`,
    `run_comet_hpo()`: the provider bridges, each needing its package.

CLI: python -m yolo_dual_tpu_torch.hpo.
"""

from __future__ import annotations

import csv
import random
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

from yolo_dual_tpu_torch.utils.general import LOGGER

# key -> (min, max). Mirrors reference utils/loggers/wandb/sweep.yaml:31-130 /
# utils/loggers/clearml/hpo.py:23-51 (the two tables are identical upstream).
HYP_SPACE: Dict[str, Tuple[float, float]] = {
    "lr0": (1e-5, 1e-1),
    "lrf": (0.01, 1.0),
    "momentum": (0.6, 0.98),
    "weight_decay": (0.0, 0.001),
    "warmup_epochs": (0.0, 5.0),
    "warmup_momentum": (0.0, 0.95),
    "warmup_bias_lr": (0.0, 0.2),
    "box": (0.02, 0.2),
    "cls": (0.2, 4.0),
    "cls_pw": (0.5, 2.0),
    "obj": (0.2, 4.0),
    "obj_pw": (0.5, 2.0),
    "iou_t": (0.1, 0.7),
    "anchor_t": (2.0, 8.0),
    "fl_gamma": (0.0, 4.0),
    "hsv_h": (0.0, 0.1),
    "hsv_s": (0.0, 0.9),
    "hsv_v": (0.0, 0.9),
    "degrees": (0.0, 45.0),
    "translate": (0.0, 0.9),
    "scale": (0.0, 0.9),
    "shear": (0.0, 10.0),
    "perspective": (0.0, 0.001),
    "flipud": (0.0, 1.0),
    "fliplr": (0.0, 1.0),
    "mosaic": (0.0, 1.0),
    "mixup": (0.0, 1.0),
    "copy_paste": (0.0, 1.0),
}


def sample_hyp(space: Dict[str, Tuple[float, float]], rng: random.Random,
               base: Optional[dict] = None) -> dict:
    """Uniform sample of every space key; non-space keys of `base` pass through."""
    hyp = dict(base or {})
    for k, (lo, hi) in space.items():
        hyp[k] = rng.uniform(lo, hi)
    return hyp


def clip_to_space(hyp: dict, space: Dict[str, Tuple[float, float]]) -> dict:
    out = dict(hyp)
    for k, (lo, hi) in space.items():
        if k in out:
            out[k] = min(max(float(out[k]), lo), hi)
    return out


class HyperparameterSearch:
    """Local HPO engine: maximize `objective(hyp) -> fitness`.

    strategy="random": i.i.d. uniform trials (reference wandb sweep `method:
    random`). strategy="evolve": after `warmup` random trials, mutate the
    best-so-far with utils/evolve.py's GA kernel and clip into the space
    (reference train.py --evolve loop, utils/general.py print_mutation).

    Every trial appends a row to `save_dir/hpo.csv` (fitness first, then the
    space keys, like the reference's evolve.csv) so searches resume: existing
    rows count toward `trials` and seed the best."""

    def __init__(self, objective: Callable[[dict], float],
                 space: Optional[Dict[str, Tuple[float, float]]] = None,
                 strategy: str = "random", trials: int = 30,
                 base_hyp: Optional[dict] = None, save_dir=".",
                 seed: int = 0, warmup: int = 3):
        assert strategy in ("random", "evolve"), strategy
        self.objective = objective
        self.space = dict(space if space is not None else HYP_SPACE)
        self.strategy = strategy
        self.trials = trials
        self.base_hyp = dict(base_hyp or {})
        self.save_dir = Path(save_dir)
        self.rng = random.Random(seed)
        self.warmup = warmup
        self.keys = list(self.space.keys())
        self.csv = self.save_dir / "hpo.csv"
        self.history = []  # (fitness, hyp)
        self._load_history()

    def _load_history(self):
        if not self.csv.exists():
            return
        with open(self.csv) as f:
            for row in csv.DictReader(f):
                hyp = {k: float(v) for k, v in row.items() if k != "fitness"}
                self.history.append((float(row["fitness"]), hyp))
        if self.history:
            LOGGER.info(f"HPO: resumed {len(self.history)} trials from {self.csv}")

    def _record(self, fitness: float, hyp: dict):
        self.history.append((fitness, {k: hyp[k] for k in self.keys}))
        new = not self.csv.exists()
        self.save_dir.mkdir(parents=True, exist_ok=True)
        with open(self.csv, "a", newline="") as f:
            w = csv.writer(f)
            if new:
                w.writerow(["fitness"] + self.keys)
            w.writerow([f"{fitness:.6g}"] + [f"{hyp[k]:.6g}" for k in self.keys])

    @property
    def best(self) -> Tuple[float, dict]:
        if not self.history:
            return float("-inf"), dict(self.base_hyp)
        return max(self.history, key=lambda t: t[0])

    def _propose(self) -> dict:
        n_done = len(self.history)
        if self.strategy == "random" or n_done < self.warmup:
            return sample_hyp(self.space, self.rng, self.base_hyp)
        from yolo_dual_tpu_torch.utils.evolve import mutate
        _, best_hyp = self.best
        parent = {**self.base_hyp, **best_hyp}
        child = mutate(parent, self.csv, seed=self.rng.randrange(2 ** 31))
        return clip_to_space(child, self.space)

    def run(self) -> Tuple[float, dict]:
        while len(self.history) < self.trials:
            hyp = self._propose()
            fitness = float(self.objective(hyp))
            self._record(fitness, hyp)
            LOGGER.info(f"HPO trial {len(self.history)}/{self.trials}: "
                        f"fitness={fitness:.4g} (best={self.best[0]:.4g})")
        try:  # hpo.csv shares the evolve.csv schema (fitness first)
            from yolo_dual_tpu_torch.utils.plots import plot_evolve
            plot_evolve(self.csv)
        except Exception as e:  # plotting must never fail the search
            LOGGER.warning(f"hpo plot failed: {e}")
        return self.best


# --- provider bridges --------------------------------------------------------

def wandb_sweep_config(data: str = "coco128-seg.yaml", epochs: int = 10,
                       batch_size: int = 64,
                       metric: str = "metrics/mAP_0.5",
                       space: Optional[dict] = None) -> dict:
    """The reference sweep.yaml as a dict (program field omitted — pass a
    function to wandb.agent instead, the modern API)."""
    params = {
        "data": {"value": data},
        "batch_size": {"values": [batch_size]},
        "epochs": {"values": [epochs]},
    }
    for k, (lo, hi) in (space or HYP_SPACE).items():
        params[k] = {"distribution": "uniform", "min": lo, "max": hi}
    return {
        "method": "random",
        "metric": {"name": metric, "goal": "maximize"},
        "parameters": params,
    }


def run_wandb_sweep(train_fn: Callable[[dict], float], count: int = 10,
                    project: str = "yolo_dual_tpu", **cfg_kw):
    """Register + drive a W&B sweep (reference utils/loggers/wandb/sweep.py).
    `train_fn(hyp)` trains once and returns/logs fitness. Requires wandb."""
    import wandb  # gated: raises ImportError when absent

    sweep_cfg = wandb_sweep_config(**cfg_kw)
    objective_name = sweep_cfg["metric"]["name"]

    def agent_fn():
        with wandb.init() as run:
            hyp = dict(run.config)
            hyp.pop("data", None), hyp.pop("epochs", None), hyp.pop("batch_size", None)
            fitness = train_fn(hyp)
            # log under the sweep's configured objective name (so wandb's
            # best-run ranking / bayes method see it), plus plain "fitness"
            run.log({objective_name: fitness, "fitness": fitness})

    sweep_id = wandb.sweep(sweep_cfg, project=project)
    wandb.agent(sweep_id, function=agent_fn, count=count)
    return sweep_id


def run_clearml_hpo(base_task_id: str, max_trials: int = 10,
                    metric=("metrics", "mAP_0.5")):
    """ClearML HyperParameterOptimizer over HYP_SPACE (reference
    utils/loggers/clearml/hpo.py). Requires clearml (+ optuna for the
    OptimizerOptuna strategy; falls back to RandomSearch without it)."""
    from clearml import Task
    from clearml.automation import HyperParameterOptimizer, UniformParameterRange
    try:
        from clearml.automation.optuna import OptimizerOptuna as Strategy
    except ImportError:
        from clearml.automation import RandomSearch as Strategy

    Task.init(project_name="yolo_dual_tpu HPO", task_name="hpo",
              task_type=Task.TaskTypes.optimizer, reuse_last_task_id=False)
    ranges = [UniformParameterRange(f"Hyperparameters/{k}", min_value=lo, max_value=hi)
              for k, (lo, hi) in HYP_SPACE.items()]
    opt = HyperParameterOptimizer(
        base_task_id=base_task_id, hyper_parameters=ranges,
        objective_metric_title=metric[0], objective_metric_series=metric[1],
        objective_metric_sign="max", optimizer_class=Strategy,
        max_number_of_concurrent_tasks=1, total_max_jobs=max_trials)
    opt.start_locally()
    opt.wait()
    top = opt.get_top_experiments(top_k=1)
    opt.stop()
    return top


def run_comet_hpo(train_fn: Callable[[dict], float], max_trials: int = 10,
                  project: str = "yolo_dual_tpu"):
    """Comet Optimizer sweep (reference utils/loggers/comet/hpo.py +
    optimizer_config.json). Requires comet_ml."""
    import comet_ml

    config = {
        "algorithm": "random",
        "spec": {"maxCombo": max_trials, "objective": "maximize",
                 "metric": "fitness"},
        "parameters": {k: {"type": "float", "min": lo, "max": hi,
                           "scalingType": "uniform"}
                       for k, (lo, hi) in HYP_SPACE.items()},
    }
    optimizer = comet_ml.Optimizer(config)
    for experiment in optimizer.get_experiments(project_name=project):
        hyp = {k: experiment.get_parameter(k) for k in HYP_SPACE}
        fitness = train_fn(hyp)
        experiment.log_metric("fitness", fitness)
        experiment.end()
    return optimizer
