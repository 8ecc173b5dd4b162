"""Semantic-segmentation validation CLI: confusion-matrix mIoU with an ignored
class, the val loss, and optional 4-panel visualisations (port of
semantic/val.py; reference unet-lite/*/val_diceloss.py:148-293).

Usage:
    python -m yolo_dual_tpu_torch.semantic.val --img-dir DIR --json-dir DIR --device-preprocess
    python -m yolo_dual_tpu_torch.semantic.val --weights best.pt --cfg resnet50.json \
        --img-dir DIR --json-dir DIR --device cpu

The images directory holds RGB uint8 `.npy` frames (image files where cv2 is
installed), the JSON directory one `{stem}.json` dense mask a frame
(data/json_dataset.py). Without --weights the model has random weights drawn
from a generator seeded with 0. With --device-preprocess the native frames
(all of one shape) and masks are letterboxed on the device
(kernels/preprocess.py:semantic_preprocess, K1 on the card); without it, on
the host (data/json_dataset.py:resize_and_pad). --data-parallel under
`python -m torch.distributed.run --nproc-per-node N -m
yolo_dual_tpu_torch.semantic.val ...` evaluates each rank's rows of every
batch (the batch size rounded up to a multiple of N, as JAX's) and sums the
confusion matrices; --visualize then draws rank 0's first rows.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from yolo_dual_tpu_torch.data.json_dataset import create_json_segment_dataloader
from yolo_dual_tpu_torch.data.loader import normalize_image
from yolo_dual_tpu_torch.engine.validator import evaluate_semantic
from yolo_dual_tpu_torch.io.weights import resolve_state_dict
from yolo_dual_tpu_torch.kernels.preprocess import semantic_preprocess
from yolo_dual_tpu_torch.losses.semantic import SemanticSegLoss
from yolo_dual_tpu_torch.models.model import SemanticSegModel
from yolo_dual_tpu_torch.parallel.mesh import data_parallel as join_data_parallel
from yolo_dual_tpu_torch.parallel.mesh import from_rank0, is_main, rank0_first, shard_loader
from yolo_dual_tpu_torch.utils.general import LOGGER, increment_path, select_device

CLASS_NAMES = ["sky", "building", "pole", "road", "pavement", "tree", "signsymbol",
               "fence", "car", "pedestrian", "bicyclist", "unlabelled"]


def save_image(path: Path, rgb: np.ndarray) -> Path:
    """Write an RGB uint8 image as PNG where cv2 is installed, else as `.npy`."""
    try:
        import cv2
    except ImportError:
        np.save(path.with_suffix(".npy"), rgb)
        return path.with_suffix(".npy")
    cv2.imwrite(str(path.with_suffix(".png")), np.ascontiguousarray(rgb[..., ::-1]))
    return path.with_suffix(".png")


def run(weights="", cfg="resnet50.json", img_dir="", json_dir="", imgsz=640, batch_size=16,
        nc=12, ignore_index=11, loss="dice", visualize=False, project="runs/val-semantic",
        name="exp", device="cuda", data_parallel=False, device_preprocess=False):
    """Evaluate `weights` (or the seeded random model) on the JSON set.
    Returns evaluate_semantic's ((mIoU, val loss, 0, 0), per-class IoU, (ms an image,))."""
    mesh = join_data_parallel(device) if data_parallel else None
    if mesh is not None and batch_size % mesh.size:
        batch_size = -(-batch_size // mesh.size) * mesh.size
        LOGGER.info(f"--data-parallel: batch size rounded up to {batch_size} ({mesh.size} ranks)")
    dev = select_device(device)
    model = SemanticSegModel(cfg, nc=nc, device=dev, generator=torch.Generator().manual_seed(0))
    if weights:
        model.load_state_dict(resolve_state_dict(weights), strict=True)
    with rank0_first(mesh):  # the parsed masks are cached once
        loader, _ = create_json_segment_dataloader(img_dir, json_dir, imgsz, batch_size,
                                                   augment=False, num_classes=nc,
                                                   drop_last=False,
                                                   device_preprocess=device_preprocess)
    shard_loader(loader, mesh)
    result = evaluate_semantic(model, loader, nc, ignore_index=ignore_index,
                               loss_fn=SemanticSegLoss(nc, flavor=loss), verbose=True,
                               names=dict(enumerate(CLASS_NAMES)), mesh=mesh, device=dev)
    if visualize:
        from yolo_dual_tpu_torch.utils.plots import semantic_panel
        save_dir = from_rank0(lambda: increment_path(Path(project) / name, mkdir=True), mesh)
    if visualize and is_main(mesh):
        batch = next(iter(loader))
        with torch.inference_mode():
            if "image_raw" in batch:
                image, mask = semantic_preprocess(
                    torch.as_tensor(batch["image_raw"]).to(dev).contiguous(),
                    torch.as_tensor(batch["mask_raw"]).to(dev), out_size=imgsz)
                images = (image.permute(0, 2, 3, 1).cpu().numpy() * 255).astype(np.uint8)
                masks = mask.cpu().numpy()
            else:
                images, masks = batch["image"], batch["mask"]
                image = normalize_image(torch.as_tensor(images).to(dev).permute(0, 3, 1, 2))
            pred = model(image.contiguous()).argmax(1).cpu().numpy()
        for i in range(min(4, len(pred))):
            save_image(save_dir / f"panel_{i}",
                       semantic_panel(images[i], masks[i], pred[i], names=CLASS_NAMES[:nc]))
        LOGGER.info(f"panels saved to {save_dir}")
    return result


def parse_opt(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--weights", type=str, default="", help="a .pt state_dict or an orbax checkpoint directory of the JAX package")
    p.add_argument("--cfg", type=str, default="resnet50.json")
    p.add_argument("--img-dir", type=str, required=True)
    p.add_argument("--json-dir", type=str, required=True)
    p.add_argument("--imgsz", "--img-size", type=int, default=640)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--nc", type=int, default=12)
    p.add_argument("--ignore-index", type=int, default=11)
    p.add_argument("--loss", choices=["dice", "jaccard", "ce"], default="dice")
    p.add_argument("--visualize", action="store_true",
                   help="save 4 [input | GT | pred | diff] panels (PNG with cv2, else .npy)")
    p.add_argument("--device-preprocess", action="store_true",
                   help="resize-pad on the device (kernels/preprocess.py:semantic_preprocess)")
    p.add_argument("--project", default="runs/val-semantic")
    p.add_argument("--name", default="exp")
    p.add_argument("--data-parallel", action="store_true",
                   help="one rank a process under torch.distributed.run, batches split over them")
    p.add_argument("--device", default="cuda", help="cuda or cpu")
    return p.parse_args(argv)


if __name__ == "__main__":
    run(**vars(parse_opt()))
