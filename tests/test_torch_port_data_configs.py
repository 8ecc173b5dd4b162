"""The data configs and their lookup against the JAX package, on the CPU:

- the port's JSON copies of JAX's data yamls, key for key;
- `find_cfg(name, "data")` against the root CLIs' find_cfg: every bare data
  name found in configs/data/ alone, a model name refused there;
- `check_dataset` against JAX's on a set of data files, each written in its
  own working directory: with and without `path:`, list val, no `val:` key
  and `val: ""`, names as a list, a dict and absent, `bash` and inline
  Python download hooks, autodownload off, require_splits off; where JAX
  raises, the same exception type. A URL hook runs through the port alone
  (JAX's branch downloads): it is refused by name and opens no connection;
- `seg_labels_to_class_weights` skipping a file that fails, as JAX's does;
- segment.val with no `--data` in a directory that holds only
  datasets/coco128-seg, against JAX's root segment/val.py run() on the same
  frames and weights (1e-4), then a data file whose download hook copies that
  set into place (refused with --no-download, equal without it); and
  segment.train with its default `--data` for one epoch at 64 px.
"""

import importlib.util
import json
import socket
import sys

import numpy as np
import pytest
import torch
import yaml

from torch_port_common import IMGSZ, ROOT, TINY_NM, TINY_SEG, random_variables, write_yolo_split
from yolo_dual_tpu.losses.semantic import seg_labels_to_class_weights as jax_class_weights
from yolo_dual_tpu.train.checkpoint import export_torch_state_dict
from yolo_dual_tpu.utils.general import check_dataset as jax_check_dataset
from yolo_dual_tpu_torch.kernels.preprocess import letterbox_normalize
from yolo_dual_tpu_torch.losses.semantic import seg_labels_to_class_weights
from yolo_dual_tpu_torch.ops.nms import nms_from_raw
from yolo_dual_tpu_torch.segment import train as port_train
from yolo_dual_tpu_torch.segment import val as port_val
from yolo_dual_tpu_torch.utils.general import CONFIGS, check_dataset, find_cfg

JAX_DATA = ROOT / "yolo_dual_tpu" / "configs" / "data"
DATA_NAMES = ("coco128-seg", "coco128", "coco", "VOC", "camvid")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _int_keys(d):
    return {**d, "names": {int(k): v for k, v in d["names"].items()}}


@pytest.mark.parametrize("name", DATA_NAMES)
def test_data_json_equals_the_yaml(name):
    want = yaml.safe_load((JAX_DATA / f"{name}.yaml").read_text())
    got = json.loads((CONFIGS / "data" / f"{name}.json").read_text())
    assert list(got) == list(want)
    assert _int_keys(got) == want


def test_find_cfg_looks_data_names_up_in_data_alone(tmp_path, monkeypatch):
    jax_val = _load("seg_val_find_cfg_vs_port", ROOT / "segment" / "val.py")
    monkeypatch.chdir(tmp_path)
    for name in DATA_NAMES:
        want = jax_val.find_cfg(f"{name}.yaml", "data")
        for spelling in (f"{name}.yaml", f"{name}.json", f"data/{name}.yaml"):
            got = find_cfg(spelling, "data") if "/" not in spelling else find_cfg(spelling)
            assert got == CONFIGS / "data" / f"{name}.json" and got.stem == want.stem
        assert find_cfg(f"{name}.yaml") == CONFIGS / "data" / f"{name}.json"  # no folders given
    for model in ("yolov5s-seg.yaml", "hyp.scratch-low.yaml"):
        with pytest.raises(FileNotFoundError):
            jax_val.find_cfg(model, "data")
        with pytest.raises(FileNotFoundError):
            find_cfg(model, "data")
        assert find_cfg(model).exists()  # still found where no folder is named
    (tmp_path / "mine.json").write_text("{}")
    assert find_cfg("mine.json", "data").resolve() == tmp_path / "mine.json"  # a path wins


# name: (data file, folders to make, check_dataset keywords, sub-directory of the file)
CASES = {
    "path": (dict(path="ds", train="images/train", val="images/val", names=["a", "b"]),
             ["ds/images/train", "ds/images/val"], {}, ""),
    "no_path": (dict(train="images/train", val="images/val", nc=2, names={0: "a", 1: "b"}),
                ["images/val"], {}, ""),
    "no_path_in_a_subfolder": (dict(val="images/val", names=["a"]),
                               ["images/val", "sub/images/val"], {}, "sub"),
    "list_val": (dict(path="ds", val=["v1", "v2"], names=["a", "b", "c"]),
                 ["ds/v1", "ds/v2"], {}, ""),
    "no_val_key": (dict(path="ds", train="images/train", names=["a"]), [], {}, ""),
    "empty_val": (dict(path="ds", train="t", val="", nc=3), [], {}, ""),
    "names_absent": (dict(path="ds", val="v"), ["ds/v"], {}, ""),
    "test_null": (dict(path="ds", val="v", test=None, names={0: "x"}), ["ds/v"], {}, ""),
    "bash_hook": (dict(path="ds", val="images/v3", names=["a"],
                       download="bash -c 'mkdir -p ds/images/v3'"), [], {}, ""),
    "python_hook": (dict(path="ds", val=["a", "b"], names=["a"],
                         download="for v in yaml['val']: Path(v).mkdir(parents=True)"), [], {}, ""),
    "hook_leaves_val_missing": (dict(path="ds", val="v", download="bash -c 'mkdir -p other'"),
                                [], {}, ""),
    "no_hook": (dict(path="ds", val="missing", names=["a"]), [], {}, ""),
    "autodownload_off": (dict(path="ds", val="images/v3", download="bash -c 'mkdir -p ds/images/v3'"),
                         [], {"autodownload": False}, ""),
    "require_splits_off": (dict(path="ds", val="missing", download="bash -c 'exit 3'"), [],
                           {"require_splits": False}, ""),
}


def _run(fn, root, case, suffix, dump, monkeypatch):
    data, dirs, kw, sub = CASES[case]
    root.mkdir()
    for d in dirs:
        (root / d).mkdir(parents=True)
    (root / (sub or ".")).mkdir(exist_ok=True)
    f = (root / sub / f"data{suffix}") if sub else root / f"data{suffix}"
    f.write_text(dump(data))
    monkeypatch.chdir(root)
    try:
        return fn(str(f.relative_to(root)), **kw), sorted(p.relative_to(root).as_posix()
                                                          for p in root.rglob("*") if p.is_dir())
    except Exception as e:  # noqa: BLE001 -- the type is what is compared
        return type(e), None


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_dataset_returns_jax_dict(case, tmp_path, monkeypatch):
    want, want_tree = _run(jax_check_dataset, tmp_path / "jax", case, ".yaml",
                           yaml.safe_dump, monkeypatch)
    got, got_tree = _run(check_dataset, tmp_path / "port", case, ".json",
                         json.dumps, monkeypatch)
    assert got == want and got_tree == want_tree, (got, want)
    expect_raise = case in ("hook_leaves_val_missing", "no_hook", "autodownload_off")
    assert (want is FileNotFoundError) is expect_raise, want


def test_check_dataset_refuses_a_url_hook_without_a_connection(tmp_path, monkeypatch):
    def no_network(*a, **k):
        raise AssertionError("a connection was opened")
    monkeypatch.setattr(socket.socket, "connect", no_network)
    monkeypatch.setattr(socket, "create_connection", no_network)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "d.json").write_text(json.dumps(dict(path="ds", val="v",
                                                     download="https://example.com/ds.zip")))
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        check_dataset("d.json")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["d.json"]
    with pytest.raises(FileNotFoundError, match="autodownload disabled"):
        check_dataset("d.json", autodownload=False)


def test_check_dataset_keeps_the_directory_form(tmp_path):
    for split in ("train", "val"):
        (tmp_path / "images" / split).mkdir(parents=True)
    assert check_dataset(str(tmp_path)) == {"train": str(tmp_path / "images" / "train"),
                                            "val": str(tmp_path / "images" / "val"),
                                            "nc": None, "names": None}


def test_seg_labels_to_class_weights_skips_what_jax_skips(tmp_path):
    good = tmp_path / "good.json"
    good.write_text(json.dumps({"mask_data": [0, 1, 2, 1]}))
    negative = tmp_path / "negative.json"
    negative.write_text(json.dumps({"mask_data": [0, -1, 2]}))
    top_list = tmp_path / "list.json"
    top_list.write_text(json.dumps([[0, 1]]))
    files = [str(good), str(negative), str(top_list), str(tmp_path / "absent.json")]
    want = jax_class_weights(files, 3)
    np.testing.assert_array_equal(seg_labels_to_class_weights(files, 3), want)
    np.testing.assert_allclose(want, [4 / 3, 2 / 3, 4 / 3], rtol=1e-6)


# ---------------------------------------------------------------------------
# The segment CLIs in a directory that holds only datasets/coco128-seg

COCO_NC = 80


@pytest.fixture(scope="module")
def coco128_seg(tmp_path_factory):
    """TINY_SEG at nc 80 with seeded weights (objectness and coefficient
    biases raised so masks are solid), in `.pt` form for both packages; 6
    frames under {jax,port}/datasets/coco128-seg/{images,labels}/train2017
    (PNG and `.npy`), labelled with the model's own boxes so both metric
    halves are non-zero."""
    from yolo_dual_tpu.models.model import SegmentationModel as JaxSegmentationModel
    from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
    from yolo_dual_tpu_torch.models.model import SegmentationModel
    root = tmp_path_factory.mktemp("coco128_seg")
    cfg = dict(TINY_SEG, nc=COCO_NC)
    jm = JaxSegmentationModel(cfg)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=11)
    hp = v["params"][f"model_{jm.spec.layers[-1].i}"]
    for li in range(len(cfg["anchors"])):
        b = hp["detect"][f"m_{li}"]["bias"].reshape(3, -1)
        b[:, 4] += 3.0
        b[:, 5:8] += 1.0
        b[:, 5 + COCO_NC:] += 2.0
    hp["proto"]["cv3"]["bn"]["bias"] += 2.0
    model = SegmentationModel(cfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(v), strict=True)
    model.eval()
    head = model.model[-1]
    shapes = ((48, 64), (64, 64), (64, 40))
    write_yolo_split(root / "split", "train2017", 6, shapes, seed=5)
    for side in ("jax", "port"):
        (root / side / "datasets").mkdir(parents=True)
        (root / "split" / side).rename(root / side / "datasets" / "coco128-seg")
    for f in sorted((root / "port" / "datasets" / "coco128-seg" / "images" / "train2017").glob("*")):
        im = np.load(f)
        h0, w0 = im.shape[:2]
        x = letterbox_normalize(torch.from_numpy(im)[None], IMGSZ, scaleup=True)
        r = IMGSZ / max(h0, w0)
        top, left = (IMGSZ - round(h0 * r)) / 2, (IMGSZ - round(w0 * r)) / 2
        with torch.no_grad():
            levels, _ = model(x, decode=False)
            out, nv = nms_from_raw(levels, head.anchors, head.strides, conf_thres=1e-4,
                                   iou_thres=0.6, max_det=20, nm=TINY_NM)
        lines = []
        for d in out[0, :int(nv[0])].numpy()[:4]:
            x1, x2 = np.clip((d[[0, 2]] - left) / (r * w0), 0, 1)
            y1, y2 = np.clip((d[[1, 3]] - top) / (r * h0), 0, 1)
            if x2 - x1 > 0.05 and y2 - y1 > 0.05:
                lines.append(f"{int(d[5])} {x1} {y1} {x2} {y1} {x2} {y2} {x1} {y2}")
        for side in ("jax", "port"):
            (root / side / "datasets" / "coco128-seg" / "labels" / "train2017" /
             f"{f.stem}.txt").write_text("\n".join(lines))
    (root / "tiny.yaml").write_text(yaml.safe_dump(cfg))
    (root / "tiny.json").write_text(json.dumps(cfg))
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in export_torch_state_dict(v, jm.spec).items()},
               root / "tiny.pt")
    return root


def test_val_cli_default_data_matches_jax_and_runs_download_hooks(coco128_seg, monkeypatch):
    root = coco128_seg
    monkeypatch.chdir(root / "jax")
    jax_val = _load("seg_val_default_data_vs_port", ROOT / "segment" / "val.py")
    want, want_maps, _ = jax_val.run(weights=str(root / "tiny.pt"), cfg=str(root / "tiny.yaml"),
                                     batch_size=2, imgsz=IMGSZ)
    monkeypatch.chdir(root / "port")
    args = ["--weights", str(root / "tiny.pt"), "--cfg", str(root / "tiny.json"), "--batch-size",
            "2", "--imgsz", str(IMGSZ), "--device", "cpu"]
    opt = port_val.parse_opt(args)
    assert opt.data == "coco128-seg.yaml"
    got, got_maps, _ = port_val.main(opt)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_maps, want_maps, rtol=0, atol=1e-4)
    assert got[2] > 0.05 and got[6] > 0.05, got
    # a data file whose val set is missing and whose hook copies the set into place
    hook = dict(path="datasets/copy", val="images/train2017", names=json.loads(
        (CONFIGS / "data" / "coco128-seg.json").read_text())["names"],
        download='bash -c "cp -r datasets/coco128-seg datasets/copy"')
    (root / "port" / "hook.json").write_text(json.dumps(hook))
    with pytest.raises(FileNotFoundError, match="autodownload disabled"):
        port_val.main(port_val.parse_opt(args + ["--data", "hook.json", "--no-download"]))
    assert not (root / "port" / "datasets" / "copy").exists()
    again, again_maps, _ = port_val.main(port_val.parse_opt(args + ["--data", "hook.json"]))
    assert (root / "port" / "datasets" / "copy" / "images" / "train2017").is_dir()
    np.testing.assert_array_equal(np.asarray(again), np.asarray(got))
    np.testing.assert_array_equal(again_maps, got_maps)


def test_train_cli_default_data_trains_an_epoch(coco128_seg, tmp_path, monkeypatch):
    monkeypatch.chdir(coco128_seg / "port")
    opt = port_train.parse_opt([])
    assert opt.data == "coco128-seg.yaml"
    best = port_train.main(["--cfg", str(coco128_seg / "tiny.json"), "--epochs", "1",
                            "--batch-size", "4", "--imgsz", str(IMGSZ), "--nbs", "8",
                            "--device", "cpu", "--project", str(tmp_path), "--name", "exp",
                            "--noplots"])
    assert np.isfinite(best)
    rows = (tmp_path / "exp" / "results.csv").read_text().splitlines()
    assert len(rows) == 2
