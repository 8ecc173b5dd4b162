"""Remote experiment-tracking adapters: W&B, ClearML, Comet (port of
yolo_dual_tpu/utils/remote_loggers.py; reference
utils/loggers/wandb/wandb_utils.py: init, metric logging, dataset and model
artifacts; utils/loggers/clearml/clearml_utils.py: Task.init, scalar and
image reports, checkpoint upload; utils/loggers/comet/__init__.py:
Experiment, metrics and images, checkpoints).

Each adapter is an inert no-op when its package is missing: constructing one
never raises (the reference gates the same way on ImportError). All share one
surface:

    .active            -> bool
    .log_metrics(dict, step)
    .log_image(tag, hwc_uint8, step)
    .log_artifact(path, type='model'|'dataset', name=...)
    .log_model(path, epoch, best)   (checkpoint upload)
    .finish()
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

from yolo_dual_tpu_torch.utils.general import LOGGER


class _NoOp:
    active = False

    def log_metrics(self, metrics: Dict, step: int):  # pragma: no cover - trivial
        pass

    def log_image(self, tag, img, step: int):
        pass

    def log_artifact(self, path, type: str = "model", name: Optional[str] = None):
        pass

    def log_model(self, path, epoch: int = 0, best: bool = False):
        pass

    def finish(self):
        pass


class WandbLogger(_NoOp):
    """reference utils/loggers/wandb/wandb_utils.py:1-589 (runs, artifacts)."""

    def __init__(self, project: str = "yolo_dual_tpu", run_name: Optional[str] = None,
                 config: Optional[dict] = None, save_dir: str = "."):
        try:
            import wandb
        except ImportError:
            LOGGER.info("wandb not installed; wandb logging disabled")
            return
        try:
            self.wandb = wandb
            self.run = wandb.init(project=project, name=run_name, config=config or {},
                                  dir=str(save_dir), resume="allow")
            self.active = True
        except Exception as e:  # offline/unauthenticated etc.
            LOGGER.info(f"wandb init failed ({e}); disabled")

    def log_metrics(self, metrics, step):
        if self.active:
            self.run.log(metrics, step=step)

    def log_image(self, tag, img, step):
        if self.active:
            self.run.log({tag: self.wandb.Image(img)}, step=step)

    def log_artifact(self, path, type="model", name=None):
        """Dataset/model artifact upload (reference wandb_utils.py
        log_dataset_artifact / log_model)."""
        if self.active:
            art = self.wandb.Artifact(name or Path(str(path)).stem, type=type)
            p = Path(str(path))
            if p.is_dir():
                art.add_dir(str(p))
            else:
                art.add_file(str(p))
            self.run.log_artifact(art)

    def log_model(self, path, epoch=0, best=False):
        if self.active:
            art = self.wandb.Artifact(f"run_{self.run.id}_model", type="model",
                                      metadata={"epoch": epoch, "best": best})
            p = Path(str(path))
            if p.is_dir():
                art.add_dir(str(p))
            else:
                art.add_file(str(p))
            aliases = ["latest", "best"] if best else ["latest"]
            self.run.log_artifact(art, aliases=aliases)

    def finish(self):
        if self.active:
            self.run.finish()


class ClearMLLogger(_NoOp):
    """reference utils/loggers/clearml/clearml_utils.py (Task + reporting)."""

    def __init__(self, project: str = "yolo_dual_tpu", task_name: str = "train",
                 config: Optional[dict] = None, **_):
        try:
            import clearml
        except ImportError:
            LOGGER.info("clearml not installed; clearml logging disabled")
            return
        try:
            self.task = clearml.Task.init(project_name=project, task_name=task_name,
                                          auto_connect_frameworks=False)
            if config:
                self.task.connect(dict(config))
            self.logger = self.task.get_logger()
            self.active = True
        except Exception as e:
            LOGGER.info(f"clearml init failed ({e}); disabled")

    def log_metrics(self, metrics, step):
        if self.active:
            for k, v in metrics.items():
                title, _, series = k.partition("/")
                self.logger.report_scalar(title, series or title, float(v), int(step))

    def log_image(self, tag, img, step):
        if self.active:
            self.logger.report_image(tag, tag, iteration=int(step), image=img)

    def log_artifact(self, path, type="model", name=None):
        if self.active:
            self.task.upload_artifact(name or Path(str(path)).stem, artifact_object=str(path))

    def log_model(self, path, epoch=0, best=False):
        if self.active:
            self.task.update_output_model(model_path=str(path),
                                          model_name=f"epoch{epoch}{'_best' if best else ''}")

    def finish(self):
        if self.active:
            self.task.close()


class CometLogger(_NoOp):
    """reference utils/loggers/comet/__init__.py (Experiment + reporting)."""

    def __init__(self, project: str = "yolo_dual_tpu", run_name: Optional[str] = None,
                 config: Optional[dict] = None, **_):
        try:
            import comet_ml
        except ImportError:
            LOGGER.info("comet_ml not installed; comet logging disabled")
            return
        try:
            self.exp = comet_ml.Experiment(project_name=project)
            if run_name:
                self.exp.set_name(run_name)
            if config:
                self.exp.log_parameters(dict(config))
            self.active = True
        except Exception as e:
            LOGGER.info(f"comet init failed ({e}); disabled")

    def log_metrics(self, metrics, step):
        if self.active:
            self.exp.log_metrics({k: float(v) for k, v in metrics.items()}, step=int(step))

    def log_image(self, tag, img, step):
        if self.active:
            self.exp.log_image(img, name=tag, step=int(step))

    def log_artifact(self, path, type="model", name=None):
        if self.active:
            self.exp.log_asset(str(path), file_name=name)

    def log_model(self, path, epoch=0, best=False):
        if self.active:
            self.exp.log_model("yolo_dual_tpu", str(path))

    def finish(self):
        if self.active:
            self.exp.end()


ADAPTERS = {"wandb": WandbLogger, "clearml": ClearMLLogger, "comet": CometLogger}


def build_remote_loggers(include, project="yolo_dual_tpu", run_name=None,
                         config=None, save_dir="."):
    """Instantiate the requested adapters; inactive ones are returned too
    (no-ops) so callers never branch."""
    out = []
    for name in include:
        cls = ADAPTERS.get(name)
        if cls is not None:
            out.append(cls(project=project, run_name=run_name, config=config,
                           save_dir=save_dir))
    return out
