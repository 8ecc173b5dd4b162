"""Semantic-segmentation training CLI (port of semantic/train.py): one trainer
for every semantic config, the loss chosen with --loss {dice, jaccard, ce}.

    python -m yolo_dual_tpu_torch.semantic.train --cfg resnet50.json --img-dir DIR \
        --json-dir DIR --device-preprocess --epochs 100

The images directory holds RGB uint8 `.npy` frames (image files where cv2 is
installed), the JSON directory one `{stem}.json` dense mask a frame
(data/json_dataset.py); --mask-dir converts class-id masks into missing JSON
records first. Each epoch: the shuffled training batches, on the host route
(the default) augmented on the host (`_augment_pair`) and resized and padded
there, with --device-preprocess shipped at their native size and fitted,
flipped and shaded on the device (kernels/preprocess.py:semantic_preprocess,
K1 on the card, one launch a batch); the train step (train/trainer.py, the
loss's gradient accumulated to --nbs, EMA); the mIoU and val loss of a
conv+BN-folded copy of the EMA model (of the model under --no-ema) on the
host-route val set (engine/validator.py:evaluate_semantic); a row of
`results.csv`; `last.pt` and, when the mIoU is the best so far, `best.pt`
(train/checkpoint.py); early stopping; `best.pt` stripped to its EMA weights
at the end. The run's settings are saved as `opt.json` and `hyp.json`;
`--resume` continues the newest run with a `last.pt` (or the given
checkpoint) with them, flags typed on the command line winning.

The model starts from the JAX package's initial weights (`model.init()`,
flax's initializers under PRNGKey(0), drawn again by
models/flax_init.py:flax_init_), as JAX's trainer does, and --weights then
replaces the entries whose names and shapes match. The device defaults to
cuda; pass --device cpu to run on the CPU.

TensorBoard (utils/loggers.py, where the tensorboard package is installed)
gets the loss items and the learning rate every 10 steps and an
[input | GT | prediction | diff] panel of the live model every 100, as
JAX's CLI logs them; results.png is drawn at the end where matplotlib is
installed. --data-parallel under `python -m torch.distributed.run
--nproc-per-node N -m yolo_dual_tpu_torch.semantic.train ...` trains one
rank a process as segment.train does (parallel/mesh.py): --batch-size is
the global batch, BatchNorm and the CE + Dice / Jaccard normalisers span it,
and rank 0 alone writes the run directory.
"""

from __future__ import annotations

import argparse
import copy
import csv
import sys
import time
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.data.json_dataset import (batch_convert_masks_to_json,
                                                   create_json_segment_dataloader,
                                                   verify_json_masks)
from yolo_dual_tpu_torch.data.loader import to_device
from yolo_dual_tpu_torch.engine.validator import evaluate_semantic
from yolo_dual_tpu_torch.kernels.preprocess import semantic_preprocess
from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss, parse_class_weights
from yolo_dual_tpu_torch.models.flax_init import flax_init_
from yolo_dual_tpu_torch.models.model import SemanticSegModel
from yolo_dual_tpu_torch.parallel.mesh import (data_parallel, from_rank0, gather_batches, is_main,
                                               rank0_first, shard_loader, sync_hosts)
from yolo_dual_tpu_torch.train.checkpoint import (load_checkpoint, partial_load, resume_run,
                                                  save_checkpoint, strip_optimizer)
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import build_lr_schedule, freeze_layers, smart_optimizer
from yolo_dual_tpu_torch.train.trainer import EarlyStopping, Trainer
from yolo_dual_tpu_torch.utils.general import (LOGGER, find_cfg, increment_path, init_seeds,
                                               json_save, load_config, select_device)
from yolo_dual_tpu_torch.utils.loggers import Loggers

ROOT = Path(__file__).resolve().parents[2]
CLASS_NAMES = ["sky", "building", "pole", "road", "pavement", "tree", "signsymbol",
               "fence", "car", "pedestrian", "bicyclist", "unlabelled"]
# JAX's hyperparameters where no --hyp is given (semantic/train.py:114-116)
DEFAULT_HYP = dict(lr0=0.01, lrf=0.01, momentum=0.937, weight_decay=5e-4, warmup_epochs=3.0,
                   warmup_momentum=0.8, warmup_bias_lr=0.1)


def _log_train_panel(loggers, model, image, mask, step):
    """The [input | GT | prediction | diff] row of the batch's first frame under
    the live model in eval mode (JAX semantic/train.py:_log_train_panels;
    reference seg_diceloss_Resnet50.py:1114-1138). image: the model's NCHW
    input in [0, 1]; mask: (bs, h, w) class ids. A failure is logged, never
    raised."""
    try:
        from yolo_dual_tpu_torch.utils.plots import colorize_semantic
        x = image[:1].float()
        img = (x[0].permute(1, 2, 0).cpu().numpy() * 255).astype(np.uint8)
        gt = mask[0].cpu().numpy().astype(np.int64)
        was_training = model.training
        with torch.no_grad():
            pred = model.eval()(x).argmax(1)[0].cpu().numpy().astype(np.int64)
        model.train(was_training)
        diff = np.where(pred != gt, 255, 0).astype(np.uint8)
        loggers.log_images("Train/input_gt_pred_diff", np.concatenate(
            [img, colorize_semantic(gt), colorize_semantic(pred), np.stack([diff] * 3, -1)],
            axis=1), step)
    except Exception as e:  # panels never end a training run
        LOGGER.info(f"train panel logging skipped: {e}")


def train(opt):
    """Train as JAX semantic/train.py:train does; returns the best mIoU."""
    mesh = data_parallel(opt.device) if opt.data_parallel else None
    rank0 = is_main(mesh)
    dev = select_device(opt.device)
    init_seeds(opt.seed)
    resume_ckpt = None
    if opt.resume:
        save_dir, resume_ckpt, hyp = resume_run(opt)
        hyp = hyp or load_config(find_cfg(opt.hyp))
    else:
        save_dir = from_rank0(lambda: increment_path(Path(opt.project) / opt.name,
                                                     exist_ok=opt.exist_ok, mkdir=True), mesh)
        hyp = load_config(find_cfg(opt.hyp)) if opt.hyp else dict(DEFAULT_HYP)
    if rank0:
        json_save(save_dir / "hyp.json", hyp)
        json_save(save_dir / "opt.json", vars(opt))

    if not opt.img_dir or not opt.json_dir:
        raise SystemExit("--img-dir/--json-dir are required (or restorable via --resume)")
    with rank0_first(mesh):  # masks converted and parsed masks cached once
        ok, missing = verify_json_masks(opt.img_dir, opt.json_dir)
        if not ok and opt.mask_dir:
            LOGGER.info(f"{len(missing)} JSON masks missing; converting from {opt.mask_dir}")
            batch_convert_masks_to_json(opt.mask_dir, opt.json_dir, CLASS_NAMES)
        train_loader, dataset = create_json_segment_dataloader(
            opt.img_dir, opt.json_dir, opt.imgsz, opt.batch_size, augment=opt.augment,
            num_classes=opt.nc, seed=opt.seed, device_preprocess=opt.device_preprocess)
        val_loader, _ = create_json_segment_dataloader(
            opt.val_img_dir or opt.img_dir, opt.val_json_dir or opt.json_dir, opt.imgsz,
            opt.batch_size, augment=False, num_classes=opt.nc, drop_last=False)
    shard_loader(train_loader, mesh)
    shard_loader(val_loader, mesh)
    model = flax_init_(SemanticSegModel(opt.cfg, nc=opt.nc, device=dev))
    if opt.weights and resume_ckpt is None:
        partial_load(model, opt.weights)  # shape-matching entries (reference intersect_dicts)


    if opt.class_weights:
        cw = parse_class_weights(opt.class_weights, opt.nc, CLASS_NAMES)
    elif opt.auto_weights:
        cw = dataset.class_weights()
        LOGGER.info(f"data-driven class weights: {np.round(cw, 3)}")
    else:
        cw = None
    loss_fn = SemanticSegLoss(opt.nc, label_smoothing=opt.label_smoothing, class_weights=cw,
                              flavor=opt.loss)

    nb = len(train_loader)
    accumulate = max(round(opt.nbs / opt.batch_size), 1)
    optimizer = smart_optimizer(model, opt.optimizer, hyp, epochs=opt.epochs, steps_per_epoch=nb,
                                cos_lr=opt.cos_lr, accumulate=accumulate,
                                total_batch_size=opt.batch_size)
    if opt.freeze and (len(opt.freeze) > 1 or opt.freeze[0] > 0):
        freeze_layers(optimizer, opt.freeze)
    ema = ModelEMA(model, decay=hyp.get("ema_decay", 0.9999), tau=hyp.get("ema_tau", 2000.0)) \
        if opt.ema else None
    trainer = Trainer(model, loss_fn, optimizer, ema, task="semantic", mesh=mesh)
    state = trainer.init_state()
    start_epoch, best_fitness = 0, -1.0
    if resume_ckpt is not None:
        ckpt = load_checkpoint(resume_ckpt)
        model.load_state_dict(ckpt["model"])
        if ema is not None and ckpt.get("ema") is not None:
            ema.load_state_dict({"model": ckpt["ema"], "updates": ckpt["updates"]})
        if ckpt.get("optimizer") is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        rng_states = ckpt.get("data_rng_ranks") or [ckpt.get("data_rng")]
        rng = rng_states[mesh.rank if mesh and len(rng_states) == mesh.size else 0]
        if rng is not None:
            dataset.rng.setstate(rng)
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        best_fitness = float(ckpt.get("best_fitness", -1.0))
        LOGGER.info(f"resumed from epoch {start_epoch} (best mIoU {best_fitness:.4f})")
    stopper = EarlyStopping(patience=opt.patience)
    stopper.best_fitness = max(best_fitness, 0.0)

    csv_path = save_dir / "results.csv"
    if rank0 and (resume_ckpt is None or not csv_path.exists()):
        with open(csv_path, "w", newline="") as f:
            csv.writer(f).writerow(["epoch", "total_loss", "ce_loss", f"{opt.loss}_loss",
                                    "mIoU", "val_loss", "fitness"])
    # TensorBoard: scalars every 10 steps and panels every 100 (JAX semantic/train.py:205-212),
    # read from the device only where a writer takes them
    loggers = Loggers(save_dir, opt=vars(opt), hyp=hyp, include=("tb",)) if rank0 else None
    tb = loggers is not None and loggers.tb.writer is not None
    lr_fn = build_lr_schedule(hyp, opt.epochs, nb, opt.cos_lr, "g0", accumulate)
    LOGGER.info(f"Training {opt.cfg} on {opt.img_dir} for {opt.epochs} epochs (batch "
                f"{opt.batch_size}, imgsz {opt.imgsz}, accumulate {accumulate}, "
                f"{'device' if opt.device_preprocess else 'host'} preprocessing, {dev})...")
    t0 = time.time()
    pin = dev.type == "cuda"
    for epoch in range(start_epoch, opt.epochs):
        t_epoch = time.perf_counter()
        train_loader.set_epoch(epoch)
        mloss = torch.zeros(3, dtype=torch.float64, device=dev)
        for i, batch in enumerate(train_loader):
            if opt.device_preprocess:
                image, mask = semantic_preprocess(
                    to_device(batch["image_raw"], dev, pin), to_device(batch["mask_raw"], dev, pin),
                    out_size=opt.imgsz, flip=to_device(batch["flip"], dev, pin),
                    bright=to_device(batch["bright"], dev, pin),
                    contr=to_device(batch["contr"], dev, pin))
                b = {"image": image, "mask": mask}
            else:
                b = {k: to_device(batch[k], dev, pin) for k in ("image", "mask")}
            state, metrics = trainer.train_step(state, b)
            mloss = (mloss * i + metrics["items"].double()) / (i + 1)
            gstep = epoch * nb + i
            if tb and gstep % 10 == 0:
                items = metrics["items"].cpu().numpy()
                loggers.log_metrics({
                    "Train/Total_Loss": float(items[0]), "Train/CE_Loss": float(items[1]),
                    f"Train/{opt.loss.capitalize()}_Loss": float(items[2]),
                    "Train/Learning_Rate": float(lr_fn(gstep))}, gstep)
            if tb and gstep % 100 == 0:
                _log_train_panel(loggers, model, trainer.model_input(b["image"]), b["mask"], gstep)
        mloss = mloss.cpu().numpy()  # waits for the epoch's last step
        t_val = time.perf_counter()
        # a folded copy: evaluate_semantic folds conv+BN in place, and the EMA
        # (the model under --no-ema) trains on with its BatchNorms
        (miou, vloss, _, _), _, _ = evaluate_semantic(
            copy.deepcopy(ema.ema if ema is not None else model), val_loader, opt.nc,
            ignore_index=opt.ignore_index, loss_fn=loss_fn, names=dict(enumerate(CLASS_NAMES)),
            mesh=mesh, device=dev)
        # mIoU is the fitness (JAX's knowing fix of the reference, semantic/train.py:253-256)
        fi = float(miou)
        t_save = time.perf_counter()
        rng_states = gather_batches([[dataset.rng.getstate()]], mesh)
        if rank0:
            with open(csv_path, "a", newline="") as f:
                csv.writer(f).writerow([epoch, *mloss, miou, vloss, fi])
        ckpt = {"model": model.state_dict(),
                "ema": ema.ema.state_dict() if ema is not None else None,
                "updates": ema.updates if ema is not None else None,
                "optimizer": optimizer.state_dict(), "epoch": epoch,
                "best_fitness": float(max(fi, best_fitness)),
                "data_rng": rng_states[0]}
        if mesh is not None:  # each rank's augmentation generator, for --resume
            ckpt["data_rng_ranks"] = rng_states
        if rank0:
            save_checkpoint(save_dir / "last.pt", ckpt)
        if fi >= best_fitness:
            best_fitness = fi
            if rank0:
                save_checkpoint(save_dir / "best.pt", ckpt)
        # the epoch's wall clock by part, on the record as `epoch_times` too
        times = {"epoch": epoch, "train_s": t_val - t_epoch, "val_s": t_save - t_val,
                 "save_s": time.perf_counter() - t_save}
        LOGGER.info(f"epoch {epoch}: train {mloss.round(4)} mIoU {miou:.4f} "
                    f"(train {times['train_s']:.1f}s, val {times['val_s']:.1f}s, "
                    f"save {times['save_s']:.1f}s; "
                    f"{(time.time() - t0) / (epoch + 1 - start_epoch):.1f}s/epoch)",
                    extra={"epoch_times": times})
        if stopper(epoch, fi):
            break
    sync_hosts("saved")
    if not rank0:
        return best_fitness
    if (save_dir / "best.pt").exists():
        strip_optimizer(save_dir / "best.pt")
    try:
        from yolo_dual_tpu_torch.utils.plots import plot_results
        plot_results(csv_path, save_dir)
    except Exception as e:
        LOGGER.info(f"results plot skipped: {e}")
    loggers.close()
    LOGGER.info(f"Done; best mIoU {best_fitness:.4f}; results in {save_dir}")
    return best_fitness


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Semantic-segmentation training (PyTorch port)")
    p.add_argument("--weights", type=str, default="",
                   help="pretrained weights (partial, shape-matched load): a .pt state_dict "
                        "(e.g. the JAX package's export_torch_state_dict), a checkpoint, or an "
                        "orbax checkpoint directory of the JAX package (its EMA first)")
    p.add_argument("--resume", nargs="?", const=True, default="",
                   help="resume from last checkpoint (optionally a path)")
    p.add_argument("--freeze", nargs="+", type=int, default=[0],
                   help="freeze layers: single N = layers 0..N-1, list = indices")
    p.add_argument("--cfg", type=str, default="resnet50.yaml",
                   help="semantic model config (resnet18/34/50, resnet18/34_unet, vgg16)")
    p.add_argument("--img-dir", type=str, default="", help="required unless --resume")
    p.add_argument("--json-dir", type=str, default="", help="required unless --resume")
    p.add_argument("--mask-dir", type=str, default="",
                   help="class-id masks (PNG with cv2, or .npy) to convert to missing JSON")
    p.add_argument("--val-img-dir", type=str, default="")
    p.add_argument("--val-json-dir", type=str, default="")
    p.add_argument("--hyp", type=str, default="hyp.scratch-seg.yaml")
    p.add_argument("--loss", choices=["dice", "jaccard", "ce"], default="dice")
    p.add_argument("--nc", type=int, default=12)
    p.add_argument("--ignore-index", type=int, default=11)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--imgsz", "--img-size", type=int, default=640)
    p.add_argument("--optimizer", choices=["SGD", "Adam", "AdamW"], default="SGD")
    p.add_argument("--cos-lr", action="store_true")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--class-weights", type=str, default="",
                   help="weight file ({name: w} or a list; JSON, YAML with PyYAML) or CSV string")
    p.add_argument("--auto-weights", action="store_true", help="data-driven class weights")
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--project", default=str(ROOT / "runs" / "train-semantic"))
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank a process under torch.distributed.run; --batch-size is global")
    p.add_argument("--no-fused-bn", dest="fused_bn", action="store_false",
                   help="accepted; a TPU VJP choice of the same math: autograd's BatchNorm "
                        "and ReLU are this function already")
    p.add_argument("--no-augment", dest="augment", action="store_false",
                   help="disable train-time augmentation")
    p.add_argument("--no-ema", dest="ema", action="store_false",
                   help="train and evaluate raw weights (no EMA shadow)")
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch size for gradient accumulation "
                        "(accumulate = round(nbs / batch size))")
    p.add_argument("--device-preprocess", action="store_true",
                   help="ship raw frames; resize-pad, flip, brightness and contrast run on the "
                        "device (kernels/preprocess.py:semantic_preprocess, K1 on the card)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--workers", type=int, default=0,
                   help="accepted for parity (one prefetch thread reads the samples)")
    args = p.parse_args(argv)
    # the flags typed on the command line: on --resume the others come from the run's opt.json
    tokens = {t.split("=", 1)[0] for t in (argv if argv is not None else sys.argv[1:])}
    args.explicit = sorted(a.dest for a in p._actions
                           if any(s in tokens for s in a.option_strings))
    return args


def main(argv=None):
    return train(parse_opt(argv))


if __name__ == "__main__":
    main()
