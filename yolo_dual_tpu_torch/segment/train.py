"""Instance-segmentation training CLI (port of segment/train.py).

    python -m yolo_dual_tpu_torch.segment.train --cfg yolov5s-seg-dcnv3.json --data DIR_OR_JSON \
        --hyp hyp.scratch-low.json --epochs 100 --batch-size 16 --imgsz 640

`--data` is a directory (`images/{train,val}/*.npy` with `labels/{train,val}/*.txt`,
or one `images/` set used for both splits) or a JSON data file `{path, train,
val, nc, names}` (utils/general.py:check_dataset). Each epoch: the mosaic
samples of data/dataset.py, composed, warped, HSV-jittered and flipped on the
device (kernels/augment.py:mosaic_warp_hsv), or with --no-device-aug, or a
hyp the device route cannot run (mosaic < 1, mixup, copy_paste: scratch-med,
scratch-high, VOC), on the host (data/augment.py), the train step
(train/trainer.py; --remat recomputes the forward in the backward), box +
mask mAP of the EMA model on the val set
(engine/validator.py:evaluate_segment, host letterbox), a row of
`results.csv`, `last.pt` and, when the fitness is the best so far, `best.pt`
(train/checkpoint.py); early stopping; `best.pt` stripped to its EMA weights
at the end. The run's settings are saved as `opt.json` and `hyp.json`;
`--resume` continues the newest run with a `last.pt` (or the given
checkpoint) with them, flags typed on the command line winning.
--image-weights draws each epoch's images in proportion to the weights of
their classes, class_weights · (1 - per-class mAP)² / nc. --cache ram keeps
the read frames in memory; --cache disk reads the `.npy` frames, which are
already the decoded cache JAX's disk cache writes. --rect is ignored, as the
mosaic is square (logged).

Without --weights the model has random weights drawn from a generator seeded
with 0. A `.pt` --weights fills the entries whose names and shapes match; an
orbax checkpoint directory of the JAX package gives its `variables` whole,
not its EMA, as JAX's segment/train.py:120-125 takes them. The device defaults to cuda; pass --device cpu to run on the CPU.

Data-parallel: `python -m torch.distributed.run --nproc-per-node N -m
yolo_dual_tpu_torch.segment.train --data-parallel ...` trains one rank a
process (parallel/mesh.py; gloo where ranks share a card, NCCL where each
has its own): --batch-size is the global batch, each rank loads its
batch-size / N rows of it, BatchNorm takes its statistics over the global
batch (so --sync-bn is what --data-parallel does anyway, as in JAX), the
validation is sharded too, and rank 0 alone writes the run directory. With
one process the flag changes nothing. --loggers adds the remote sinks
(wandb, clearml, comet; no-ops without their packages) to TensorBoard
(utils/loggers.py); --evolve N runs N generations of hyperparameter
evolution (utils/evolve.py) into {project}/{name}-evolve/evolve.csv. The
label statistics and results.png are drawn where matplotlib is installed;
without it the skip is logged, as JAX's CLI does.
"""

from __future__ import annotations

import argparse
import copy
import csv
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.data.dataset import create_dataloader
from yolo_dual_tpu_torch.data.loader import to_device
from yolo_dual_tpu_torch.engine.validator import evaluate_segment
from yolo_dual_tpu_torch.io.weights import load_state_dict_file, state_dict_from_orbax
from yolo_dual_tpu_torch.kernels.augment import mosaic_warp_hsv
from yolo_dual_tpu_torch.losses.segment import ComputeSegmentLoss
from yolo_dual_tpu_torch.metrics.seg import fitness_seg
from yolo_dual_tpu_torch.models.model import SegmentationModel
from yolo_dual_tpu_torch.parallel.mesh import (data_parallel, from_rank0, gather_batches, is_main,
                                               rank0_first, shard_loader, sync_hosts)
from yolo_dual_tpu_torch.train.checkpoint import (load_checkpoint, load_weights, resume_run,
                                                  save_checkpoint, strip_optimizer)
from yolo_dual_tpu_torch.train.ema import ModelEMA
from yolo_dual_tpu_torch.train.optim import freeze_layers, smart_optimizer
from yolo_dual_tpu_torch.train.trainer import EarlyStopping, Trainer
from yolo_dual_tpu_torch.utils.evolve import mutate, print_mutation
from yolo_dual_tpu_torch.utils.loggers import Loggers
from yolo_dual_tpu_torch.utils.general import (LOGGER, check_dataset, check_img_size, find_cfg,
                                               increment_path, init_seeds, json_save,
                                               labels_to_class_weights, labels_to_image_weights,
                                               load_config, select_device)

ROOT = Path(__file__).resolve().parents[2]
CSV_HEADER = ["epoch", "box_loss", "seg_loss", "obj_loss", "cls_loss",
              "mAP50_B", "mAP_B", "mAP50_M", "mAP_M", "fitness"]


def np_rng_state(rng: np.random.RandomState):
    """A RandomState's state as plain Python values, which torch.load reads
    with weights_only."""
    name, keys, pos, has_gauss, cached = rng.get_state()
    return name, keys.tolist(), int(pos), int(has_gauss), float(cached)


def train(opt):
    """Train as JAX segment/train.py:train does; returns the best fitness."""
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
        hyp = load_config(find_cfg(opt.hyp))
    data = check_dataset(opt.data)
    if rank0:
        json_save(save_dir / "hyp.json", hyp)
        json_save(save_dir / "opt.json", vars(opt))
    imgsz = check_img_size(opt.imgsz, 32)
    amp_dtype = {"bf16": torch.bfloat16, "f32": None}[opt.dtype]

    nc = 1 if opt.single_cls else data["nc"]
    model = SegmentationModel(opt.cfg, nc=nc, device=dev,
                              generator=torch.Generator().manual_seed(0))
    nc = model.nc
    if opt.weights and str(opt.weights).endswith(".pt"):
        load_weights(model, load_state_dict_file(opt.weights))
    elif opt.weights:  # an orbax checkpoint: its trained variables, not its EMA (as JAX)
        model.load_state_dict(state_dict_from_orbax(opt.weights, prefer_ema=False), strict=True)
    names = data.get("names") or {i: str(i) for i in range(nc)}
    if opt.label_smoothing:
        hyp["label_smoothing"] = opt.label_smoothing

    with rank0_first(mesh):  # the label cache is written once
        train_loader, dataset = create_dataloader(
            data["train"], imgsz, opt.batch_size, hyp=hyp, augment=True, shuffle=True,
            mask_downsample_ratio=opt.mask_ratio, overlap_mask=not opt.no_overlap,
            seed=opt.seed, prefix="train: ", single_cls=opt.single_cls, rect=opt.rect,
            cache_images=opt.cache, device_aug=opt.device_aug)
    shard_loader(train_loader, mesh)
    if not opt.noplots and rank0:
        try:  # label-distribution panels (reference on_pretrain_routine_end)
            from yolo_dual_tpu_torch.utils.plots import plot_labels
            all_lbl = [lb for lb in dataset.labels if len(lb)]
            if all_lbl:
                plot_labels(np.concatenate(all_lbl), data.get("names", {}), save_dir)
        except Exception as e:
            LOGGER.info(f"labels plot skipped: {e}")
    if opt.quad:
        LOGGER.info("--quad: quad collate is detection-only (matches the reference's broken "
                    "seg quad path); ignored for segment")
    if opt.sync_bn:
        LOGGER.info("--sync-bn: BatchNorm statistics span every rank's rows" if mesh else
                    "--sync-bn: one process trains on the whole batch; nothing to synchronise")
    with rank0_first(mesh):
        val_loader, _ = create_dataloader(
            data["val"], imgsz, opt.batch_size, hyp=hyp, augment=False,
            mask_downsample_ratio=opt.mask_ratio, overlap_mask=not opt.no_overlap,
            prefix="val: ", single_cls=opt.single_cls)
    shard_loader(val_loader, mesh)

    nb = len(train_loader)
    accumulate = max(round(opt.nbs / opt.batch_size), 1)
    head = model.model[-1]
    nm = head.nm
    loss_fn = ComputeSegmentLoss(head.anchors, head.strides, nc, nm, hyp,
                                 overlap=not opt.no_overlap)
    optimizer = smart_optimizer(model, opt.optimizer, hyp, epochs=opt.epochs, steps_per_epoch=nb,
                                cos_lr=opt.cos_lr, accumulate=accumulate,
                                total_batch_size=opt.batch_size)
    if opt.freeze and (len(opt.freeze) > 1 or opt.freeze[0] > 0):
        freeze_layers(optimizer, opt.freeze)
    ema = ModelEMA(model, decay=hyp.get("ema_decay", 0.9999), tau=hyp.get("ema_tau", 2000.0))
    trainer = Trainer(model, loss_fn, optimizer, ema, task="segment", amp_dtype=amp_dtype,
                      remat=opt.remat, mesh=mesh)
    state = trainer.init_state()
    start_epoch, best_fitness = 0, 0.0
    if resume_ckpt is not None:
        ckpt = load_checkpoint(resume_ckpt)
        model.load_state_dict(ckpt["model"])
        if ckpt.get("ema") is not None:
            ema.load_state_dict({"model": ckpt["ema"], "updates": ckpt["updates"]})
        if ckpt.get("optimizer") is not None:  # absent after --nosave-optimizer
            optimizer.load_state_dict(ckpt["optimizer"])
        rng_states = ckpt.get("data_rng_ranks") or [(ckpt.get("data_rng"), ckpt.get("data_np_rng"))]
        rng, np_rng = rng_states[mesh.rank if mesh and len(rng_states) == mesh.size else 0]
        if rng is not None:
            dataset.rng.setstate(rng)
        if np_rng is not None:
            name, keys, *rest = np_rng
            dataset.np_rng.set_state((name, np.asarray(keys, np.uint32), *rest))
        start_epoch = int(ckpt.get("epoch", -1)) + 1
        best_fitness = float(ckpt.get("best_fitness", 0.0))
        LOGGER.info(f"resumed from epoch {start_epoch} (best fitness {best_fitness:.4f})")
    stopper = EarlyStopping(patience=opt.patience)
    stopper.best_fitness = best_fitness

    csv_path = save_dir / "results.csv"
    if rank0 and (resume_ckpt is None or not csv_path.exists()):
        # header on fresh runs only: a resumed run appends
        with open(csv_path, "w", newline="") as f:
            csv.writer(f).writerow(CSV_HEADER)
    # TensorBoard and the remote sinks; results.csv stays the trainer's (its resume rule)
    loggers = Loggers(save_dir, opt=vars(opt), hyp=hyp, run_name=opt.name,
                      include=("tb",) + tuple(s for s in opt.loggers or () if s != "csv")) \
        if rank0 else None
    LOGGER.info(f"Training {opt.cfg} on {data['train']} for {opt.epochs} epochs "
                f"(batch {opt.batch_size}, imgsz {imgsz}, accumulate {accumulate}, {dev})...")
    t0 = time.time()
    if opt.image_weights:
        class_weights = labels_to_class_weights(dataset.labels, nc)
    mean, maps = np.zeros(8), np.zeros(nc)
    pin = dev.type == "cuda"
    for epoch in range(start_epoch, opt.epochs):
        t_epoch = time.perf_counter()
        final_epoch = epoch == opt.epochs - 1
        if opt.image_weights:  # rare and poorly detected classes drawn more often
            cw = class_weights * (1 - maps) ** 2 / nc
            train_loader.sample_weights = labels_to_image_weights(dataset.labels, nc, cw)
        train_loader.set_epoch(epoch)
        mloss = torch.zeros(4, dtype=torch.float64, device=dev)
        for i, batch in enumerate(train_loader):
            if "aug_tiles" in batch:  # the device route
                image = mosaic_warp_hsv(*(to_device(batch[k], dev, pin) for k in (
                    "aug_tiles", "aug_dst", "aug_off", "aug_invm", "aug_hsv", "aug_flips")),
                    out_size=imgsz)
            else:  # the host route: augmented uint8 frames
                image = to_device(batch["image"], dev, pin)
            b = {"image": image, **{k: to_device(batch[k], dev, pin)
                                    for k in ("targets", "tmask", "masks")}}
            state, metrics = trainer.train_step(state, b)
            mloss = (mloss * i + metrics["items"].double()) / (i + 1)
        mloss = mloss.cpu().numpy()  # waits for the epoch's last step
        t_val = time.perf_counter()
        if not opt.noval or final_epoch:  # --noval: validate the final epoch only
            mean, maps, _ = evaluate_segment(copy.deepcopy(ema.ema), val_loader, nc, nm=nm,
                                          names=names, device=dev, amp_dtype=amp_dtype,
                                          mesh=mesh)
        fi = fitness_seg(np.asarray(mean))
        t_save = time.perf_counter()
        rng_states = gather_batches([[(dataset.rng.getstate(), np_rng_state(dataset.np_rng))]],
                                    mesh)
        if rank0:
            with open(csv_path, "a", newline="") as f:
                csv.writer(f).writerow([epoch, *mloss, mean[2], mean[3], mean[6], mean[7], fi])
            loggers.log_metrics({
                "train/box_loss": mloss[0], "train/seg_loss": mloss[1],
                "train/obj_loss": mloss[2], "train/cls_loss": mloss[3],
                "metrics/precision(B)": mean[0], "metrics/recall(B)": mean[1],
                "metrics/mAP_0.5(B)": mean[2], "metrics/mAP_0.5:0.95(B)": mean[3],
                "metrics/precision(M)": mean[4], "metrics/recall(M)": mean[5],
                "metrics/mAP_0.5(M)": mean[6], "metrics/mAP_0.5:0.95(M)": mean[7],
                "fitness": fi}, epoch)
        if rank0 and (not opt.nosave or final_epoch):  # --nosave: checkpoint the final epoch only
            ckpt = {"model": model.state_dict(), "ema": ema.ema.state_dict(),
                    "updates": ema.updates,
                    "optimizer": None if opt.nosave_optimizer else optimizer.state_dict(),
                    "epoch": epoch, "best_fitness": float(max(fi, best_fitness)),
                    "data_rng": rng_states[0][0], "data_np_rng": rng_states[0][1]}
            if mesh is not None:  # each rank's augmentation generators, for --resume
                ckpt["data_rng_ranks"] = rng_states
            save_checkpoint(save_dir / "last.pt", ckpt)
            loggers.on_model_save(save_dir / "last.pt", epoch, best_fitness, fi)
            if fi >= best_fitness:
                save_checkpoint(save_dir / "best.pt", ckpt)
        # the epoch's wall clock by part: its batches (loading included), the val
        # pass, results.csv and the checkpoints; on the record as `epoch_times` too
        times = {"epoch": epoch, "train_s": t_val - t_epoch, "val_s": t_save - t_val,
                 "save_s": time.perf_counter() - t_save}
        LOGGER.info(f"epoch {epoch}: loss {mloss.round(4)} fitness {fi:.4f} "
                    f"(train {times['train_s']:.1f}s, val {times['val_s']:.1f}s, "
                    f"save {times['save_s']:.1f}s; "
                    f"{(time.time() - t0) / (epoch + 1 - start_epoch):.1f}s/epoch)",
                    extra={"epoch_times": times})
        best_fitness = max(best_fitness, fi)
        if stopper(epoch, fi):
            break
    sync_hosts("saved")
    if not rank0:
        return best_fitness
    if (save_dir / "best.pt").exists():
        strip_optimizer(save_dir / "best.pt")
    if not opt.noplots:
        try:
            from yolo_dual_tpu_torch.utils.plots import plot_results
            plot_results(csv_path, save_dir)
        except Exception as e:
            LOGGER.info(f"results plot skipped: {e}")
    loggers.on_train_end(save_dir / "results.png")
    LOGGER.info(f"Done in {(time.time() - t0) / 3600:.2f}h; results in {save_dir}")
    return best_fitness


def parse_opt(argv=None):
    p = argparse.ArgumentParser(description="Instance-segmentation training (PyTorch port)")
    p.add_argument("--weights", type=str, default="",
                   help="initial weights: a .pt state_dict (reference-style names, e.g. the "
                        "JAX package's export_torch_state_dict), a checkpoint of this CLI, or "
                        "an orbax checkpoint directory of the JAX package (its variables)")
    p.add_argument("--resume", nargs="?", const=True, default="",
                   help="resume the newest run with a last.pt (or the given checkpoint)")
    p.add_argument("--cfg", type=str, default="yolov5n-seg.yaml", help="model config")
    p.add_argument("--data", type=str, default="coco128-seg.yaml",
                   help="dataset directory (images/*.npy, labels/*.txt) or .json data file")
    p.add_argument("--hyp", type=str, default="hyp.scratch-low.yaml", help="hyperparameters")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    p.add_argument("--rect", action="store_true",
                   help="accepted; the mosaic is square, so training ignores it")
    p.add_argument("--cache", type=str, default=False, nargs="?", const="ram",
                   help="image cache: ram, or disk (the .npy frames are the decoded cache)")
    p.add_argument("--quad", action="store_true", help="accepted and ignored for segment")
    p.add_argument("--image-weights", action="store_true",
                   help="weighted image resampling by class rarity x (1-mAP)^2")
    p.add_argument("--freeze", nargs="+", type=int, default=[0],
                   help="freeze layers: single N = layers 0..N-1, list = those indices")
    p.add_argument("--label-smoothing", type=float, default=0.0)
    p.add_argument("--sync-bn", action="store_true",
                   help="BatchNorm statistics over every rank's rows (always under --data-parallel)")
    p.add_argument("--noval", action="store_true", help="validate final epoch only")
    p.add_argument("--nosave", action="store_true", help="checkpoint final epoch only")
    p.add_argument("--noplots", action="store_true", help="skip the labels and results plots")
    p.add_argument("--optimizer", choices=["SGD", "Adam", "AdamW"], default="SGD")
    p.add_argument("--cos-lr", action="store_true")
    p.add_argument("--single-cls", action="store_true")
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--mask-ratio", type=int, default=4)
    p.add_argument("--no-overlap", action="store_true")
    p.add_argument("--project", default=str(ROOT / "runs" / "train-seg"))
    p.add_argument("--name", default="exp")
    p.add_argument("--exist-ok", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank a process under torch.distributed.run; --batch-size is global")
    p.add_argument("--nosave-optimizer", action="store_true")
    p.add_argument("--evolve", type=int, default=0, help="generations of hyperparameter evolution")
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward (saves device memory)")
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16",
                   help="compute dtype: bf16 runs the forward and loss under torch.autocast "
                        "(parameters, BatchNorm statistics and the DCNv3 sampling stay float32)")
    p.add_argument("--no-blocked-stem", action="store_true",
                   help="accepted; a TPU layout choice of the same math: no change on the torch path")
    p.add_argument("--loggers", nargs="*", default=[],
                   help="extra sinks: wandb clearml comet (no-ops if not installed)")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    p.add_argument("--workers", type=int, default=0,
                   help="accepted for parity (one prefetch thread reads the samples)")
    p.add_argument("--no-download", action="store_true",
                   help="accepted: nothing is ever downloaded")
    p.add_argument("--nbs", type=int, default=64,
                   help="nominal batch size for gradient accumulation")
    p.add_argument("--no-fused-bn-act", dest="fused_bn_act", action="store_false",
                   help="accepted; a TPU VJP choice of the same math: no change on the torch path")
    p.add_argument("--no-fused-bn", dest="fused_bn", action="store_false",
                   help="accepted; a TPU VJP choice of the same math: no change on the torch path")
    p.add_argument("--device-aug", dest="device_aug", action="store_true", default=True,
                   help="mosaic composite + warp + HSV + flips on the device (the default)")
    p.add_argument("--no-device-aug", dest="device_aug", action="store_false",
                   help="the host-side mosaic/copy-paste/warp/mixup/HSV/flip pipeline")
    args = p.parse_args(argv)
    # the flags typed on the command line: on --resume the others come from the run's opt.json
    tokens = {t.split("=", 1)[0] for t in (argv if argv is not None else sys.argv[1:])}
    args.explicit = sorted(a.dest for a in p._actions
                           if any(s in tokens for s in a.option_strings))
    return args


def evolve(opt):
    """Hyperparameter evolution (JAX segment/train.py:383-411; reference --evolve):
    each generation mutates the base hyp from the fitness log (utils/evolve.py),
    trains one run with it and appends its fitness to
    {project}/{name}-evolve/evolve.csv; then evolve.png where matplotlib is
    installed. Returns the CSV's path."""
    mesh = data_parallel(opt.device) if opt.data_parallel else None
    base_hyp = load_config(find_cfg(opt.hyp))
    save_dir = from_rank0(lambda: increment_path(Path(opt.project) / f"{opt.name}-evolve",
                                                 mkdir=True), mesh)
    evolve_csv = save_dir / "evolve.csv"
    for gen in range(opt.evolve):
        hyp = mutate(base_hyp, evolve_csv, seed=gen)
        hyp_file = save_dir / f"hyp_gen{gen}.json"
        if is_main(mesh):
            hyp_file.write_text(json.dumps(hyp, indent=2))
        sync_hosts("hyp")
        o = argparse.Namespace(**{**vars(opt), "hyp": str(hyp_file),
                                  "name": f"{opt.name}-gen{gen}", "evolve": 0})
        fi = train(o)
        if is_main(mesh):
            print_mutation([], [], hyp, save_dir, float(fi))
        sync_hosts("evolve.csv")  # every rank mutates from the same rows
    if is_main(mesh):
        try:
            from yolo_dual_tpu_torch.utils.plots import plot_evolve
            plot_evolve(evolve_csv)
        except Exception as e:  # plotting never fails the evolution run
            LOGGER.warning(f"plot_evolve failed: {e}")
    LOGGER.info(f"evolution complete; log at {evolve_csv}")
    return evolve_csv


def main(argv=None):
    opt = parse_opt(argv)
    return evolve(opt) if opt.evolve else train(opt)


if __name__ == "__main__":
    main()
