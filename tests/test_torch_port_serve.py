"""The model server and its client against the JAX package's, on the CPU.

- The port's PNG codec (utils/png.py), the server's and client's stand-in
  for cv2's: round trips of grey, grey + alpha, BGR and BGRA at odd shapes
  under each row filter, read back by cv2 too; the PNGs cv2 writes at
  compression 0-9 (libpng picks Sub, Up, Average and Paeth rows) decoded
  exactly; a 16-bit PNG as cv2 decodes it; the refusals (a header that
  does not fit its data, damaged files). A 16-bit, an interlaced and a
  palette PNG get JAX's server's detections (tests/test_torch_port_png.py
  holds the decoder against cv2 on every kind).
- JAX's root serve.py and the port's serve.py (--device cpu), each on port 0
  in a daemon thread, answer the same requests with the same status codes:
  PNG and JPEG bodies, an empty body, garbage, /health and other paths.
  Detection (the primed TINY_SEG at 64 px, conf 0.25): the same rows, boxes
  within 1e-3 px, confidences within 1e-5. Semantic (a narrow resnet50 with
  BatchNorm calibrated on the frames): `shape` equal, the decoded class maps
  and `class_pixels` equal except at counted near ties of JAX's scores.
  Each client talks to the other's server.
- Every server is shut down and closed in a `finally`; every request has a
  timeout.
"""

import base64
import contextlib
import importlib.util
import json
import struct
import sys
import threading
import urllib.error
import urllib.request
import zlib

import jax
import numpy as np
import pytest
import torch
import yaml

from detection_matching import pair_detections
from torch_port_common import (IMGSZ, ROOT, TINY_NC, TINY_SEG, calibrated_semantic,
                               narrow_semantic, primed_tiny, random_variables)
from yolo_dual_tpu.io.remote import RemoteModel as JaxRemoteModel
from yolo_dual_tpu_torch import serve as port_serve
from yolo_dual_tpu_torch.io.remote import RemoteModel
from yolo_dual_tpu_torch.io.weights import state_dict_from_flax
from yolo_dual_tpu_torch.utils import png

cv2 = pytest.importorskip("cv2")

TIMEOUT = 60
SCORE_GAP = 2e-3  # port and JAX float32 scores of a calibrated narrow ResNet50 (semantic tests)
NEAR_TIE = 2 * SCORE_GAP
FRAME_SHAPES = ((48, 64), (80, 60), (37, 53))


def frames(seed=0):
    """Seeded BGR frames: smooth blobs plus noise, so libpng picks several row filters."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (h, w) in enumerate(FRAME_SHAPES):
        yy, xx = np.mgrid[0:h, 0:w]
        base = 127 + 100 * np.sin(xx / (3 + i) + rng.uniform(0, 6)) * np.cos(yy / (4 + i))
        out.append(np.clip(base[..., None] + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


# ---------------------------------------------------------------------------
# the PNG codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [None, 1, 2, 3, 4])
@pytest.mark.parametrize("filter_type", list(png.FILTERS))
def test_png_round_trip(channels, filter_type):
    rng = np.random.default_rng(channels or 0)
    for h, w in ((1, 1), (7, 5), (13, 17)):
        x = rng.integers(0, 256, (h, w) if channels is None else (h, w, channels), np.uint8)
        buf = png.encode(x, filter_type=filter_type)
        want = x[..., 0] if channels == 1 else x
        np.testing.assert_array_equal(png.decode(buf), want)
        if channels != 2:  # cv2 reads grey + alpha as BGRA
            np.testing.assert_array_equal(
                cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_UNCHANGED), want)
        np.testing.assert_array_equal(png.decode(buf, color=True),
                                      cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR))


@pytest.mark.parametrize("channels", [None, 3, 4])
def test_png_decodes_what_cv2_writes(channels):
    """cv2's PNGs at every compression level, with Average or Paeth rows among them."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:97, 0:131]
    base = ((np.sin(yy / 7) * 60 + xx * 0.9 + rng.integers(0, 20, yy.shape)) % 256).astype(np.uint8)
    img = base if channels is None else np.stack(
        [base, 255 - base, base // 2, (base.astype(int) * 3 % 256).astype(np.uint8)][:channels], -1)
    kinds = set()
    for level in range(10):
        ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert ok
        np.testing.assert_array_equal(png.decode(buf.tobytes()), img)
        np.testing.assert_array_equal(png.decode(buf.tobytes(), color=True),
                                      cv2.imdecode(buf, cv2.IMREAD_COLOR))
        kinds |= set(_row_filters(buf.tobytes()))
    assert len(kinds) >= 3 and kinds & {3, 4}, kinds  # Average or Paeth: the diagonal decoder


def _row_filters(buf: bytes):
    pos, idat = 8, b""
    while pos < len(buf):
        n, kind = struct.unpack(">I4s", buf[pos:pos + 8])
        if kind == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", buf[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat += buf[pos + 8:pos + 8 + n]
        pos += 12 + n
    stride = w * {0: 1, 2: 3, 6: 4}[ctype] + 1
    return zlib.decompress(idat)[::stride][:h]


def _with_ihdr(buf: bytes, **fields) -> bytes:
    """`buf` with IHDR fields replaced (bit depth, colour type, interlace), CRC fixed."""
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB", buf[16:29])
    vals = {**dict(depth=depth, ctype=ctype, interlace=interlace), **fields}
    data = struct.pack(">IIBBBBB", w, h, vals["depth"], vals["ctype"], comp, filt,
                       vals["interlace"])
    return buf[:16] + data + struct.pack(">I", zlib.crc32(b"IHDR" + data)) + buf[33:]


def test_png_refusals():
    x = frames(2)[1]
    buf = png.encode(x)
    ok, b16 = cv2.imencode(".png", x.astype(np.uint16) * 257)
    assert ok  # a 16-bit PNG decodes as cv2 decodes it (tests/test_torch_port_png.py)
    np.testing.assert_array_equal(png.decode(b16.tobytes(), color=True),
                                  cv2.imdecode(b16, cv2.IMREAD_COLOR))
    for bad, match in ((_with_ihdr(buf, interlace=2), "interlace method"),
                       (_with_ihdr(buf, interlace=1), "too short|filter type"),
                       (_with_ihdr(buf, ctype=3), "PLTE"), (b"\xff\xd8\xff" + buf, "not a PNG"),
                       (buf[:40], "truncated|short|CRC|without"),
                       (buf[:33] + buf[33:37] + b"JUNK" + buf[41:], "CRC")):
        with pytest.raises(ValueError, match=match):
            png.decode(bad)
    with pytest.raises(ValueError, match="8-bit"):
        png.encode(x.astype(np.uint16))
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR), x)
    assert png.imdecode_color(b"") is None
    assert png.imdecode_color(b"garbage, not an image") is None   # cv2's answer


# ---------------------------------------------------------------------------
# the servers
# ---------------------------------------------------------------------------

def jax_serve_module():
    """JAX's root serve.py under a name of its own; its build_server imports
    segment/val.py as `val`, which the test puts in sys.modules for the call."""
    key = "jax_serve_vs_port"
    if key not in sys.modules:
        for name, path in ((key, ROOT / "serve.py"), ("jax_segment_val_vs_port",
                                                       ROOT / "segment" / "val.py")):
            spec = importlib.util.spec_from_file_location(name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
    return sys.modules[key]


def _zero_init(self, rng=None, imgsz=640, bias_prior=True):
    """JAX's BaseModel.init with zeros of the variables' shapes (eval_shape,
    nothing compiled): the server then fills every leaf from --weights, so
    the values are never used, and JAX's eager init of the 64 px graph takes
    ~20 s on the CPU."""
    from yolo_dual_tpu.models import model as jax_model
    shapes = jax.eval_shape(lambda r, x: self.module.init(r, x, train=True), jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, imgsz, imgsz, self.spec.ch_in), np.float32))
    zeros = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes)
    return jax_model._to_mutable(zeros)


def jax_server(argv):
    from yolo_dual_tpu.models import model as jax_model
    serve = jax_serve_module()
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "val", sys.modules["jax_segment_val_vs_port"])
        mp.setattr(jax_model.BaseModel, "init", _zero_init)
        return serve.build_server(serve.parse_opt(argv))


@contextlib.contextmanager
def serving(*servers):
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in servers]
    for t in threads:
        t.start()
    try:
        yield [f"http://127.0.0.1:{s.server_address[1]}" for s in servers]
    finally:
        for s, t in zip(servers, threads):
            s.shutdown()
            s.server_close()
            t.join(TIMEOUT)


def request(url, path, body=None, method=None):
    """(status, body bytes, reason) of one request."""
    req = urllib.request.Request(url + path, data=body, method=method or ("GET" if body is None
                                                                          else "POST"))
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read(), r.reason
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.reason


def bodies(seed):
    """Named request bodies: cv2's PNG, the port's PNG and cv2's JPEG of each frame."""
    out = {}
    for i, f in enumerate(frames(seed)):
        out[f"cv2_png{i}"] = cv2.imencode(".png", f)[1].tobytes()
        out[f"port_png{i}"] = png.encode(f)
        out[f"jpeg{i}"] = cv2.imencode(".jpg", f)[1].tobytes()
    return out


@pytest.fixture(scope="module")
def detect_servers(tmp_path_factory):
    """JAX's and the port's server of the primed TINY_SEG, the same weights
    (a .pt state_dict, which JAX's server imports)."""
    root = tmp_path_factory.mktemp("serve_detect")
    _, v = primed_tiny()
    (root / "tiny.yaml").write_text(yaml.safe_dump(TINY_SEG))
    (root / "tiny.json").write_text(json.dumps(TINY_SEG))
    torch.save(state_dict_from_flax(v), root / "tiny.pt")
    common = ["--nc", str(TINY_NC), "--imgsz", str(IMGSZ), "--port", "0"]
    jax_srv = jax_server(["--cfg", str(root / "tiny.yaml"), "--weights", str(root / "tiny.pt")]
                         + common)
    port_srv = port_serve.build_server(port_serve.parse_opt(
        ["--cfg", str(root / "tiny.json"), "--weights", str(root / "tiny.pt"), "--device", "cpu"]
        + common))
    with serving(jax_srv, port_srv) as urls:
        yield urls, port_srv


def test_status_codes_equal(detect_servers):
    (jax_url, port_url), _ = detect_servers
    cases = [("/predict", bodies(3)["cv2_png0"], None), ("/predict", bodies(3)["jpeg1"], None),
             ("/predict", b"", "POST"), ("/predict", b"\x00garbage, not an image" * 9, None),
             ("/health", None, None), ("/nope", None, None), ("/nope", b"x", None),
             ("/predict", None, None)]
    for path, body, method in cases:
        want, got = request(jax_url, path, body, method), request(port_url, path, body, method)
        assert got[0] == want[0], (path, body[:8] if body else body, got[:1], want[:1])
    assert request(port_url, "/health")[:2] == (200, b"ok")
    assert request(port_url, "/predict", b"", "POST")[0] == 400


def test_detections_equal_jax(detect_servers):
    (jax_url, port_url), port_srv = detect_servers
    port_srv.timings.clear()
    n_rows = 0
    for name, body in bodies(4).items():
        want = json.loads(request(jax_url, "/predict", body)[1])["detections"]
        got = json.loads(request(port_url, "/predict", body)[1])["detections"]
        assert list(json.loads(json.dumps(got[0])) if got else []) == ["box", "conf", "cls"]
        w = np.array([[*d["box"], d["conf"], d["cls"]] for d in want], np.float64).reshape(-1, 6)
        g = np.array([[*d["box"], d["conf"], d["cls"]] for d in got], np.float64).reshape(-1, 6)
        pairs, ties, left_w, left_g = pair_detections(w, g, conf_thres=0.25, box_tol=1e-3,
                                                      conf_tol=1e-5)
        assert len(g) == len(w) and not len(left_w) and not len(left_g), (name, ties)
        n_rows += len(w)
    assert n_rows > 20  # conf 0.25 on the primed heads keeps real work for NMS
    assert len(port_srv.timings) == len(bodies(4))
    assert set(port_srv.timings[0]) == {"read", "decode", "letterbox", "device", "json"}


def test_clients_cross_servers(detect_servers):
    """The port's client against JAX's server, JAX's client against the
    port's: each pair gives what the server's own client gets, for arrays
    (sent as PNG) and encoded bytes."""
    (jax_url, port_url), _ = detect_servers
    clients = {k: (cls(u, timeout=TIMEOUT)) for k, (cls, u) in {
        "port>jax": (RemoteModel, jax_url), "jax>jax": (JaxRemoteModel, jax_url),
        "jax>port": (JaxRemoteModel, port_url), "port>port": (RemoteModel, port_url)}.items()}
    for c in clients.values():
        assert c.warmup((IMGSZ, IMGSZ, 3)).health()
    for f in frames(5) + [cv2.imencode(".jpg", frames(5)[0])[1].tobytes()]:
        out = {k: c(f) for k, c in clients.items()}
        assert all(o.dtype == np.float32 and o.ndim == 2 and o.shape[1] == 6 for o in out.values())
        np.testing.assert_array_equal(out["port>jax"], out["jax>jax"])
        np.testing.assert_array_equal(out["jax>port"], out["port>port"])
        assert len(out["port>port"]) == len(out["jax>jax"]) > 0
    with pytest.raises(ConnectionError):
        RemoteModel("http://127.0.0.1:1", timeout=0.5)


def test_refusals_name_what_is_missing(detect_servers, monkeypatch):
    from test_torch_port_png import write_png
    (jax_url, port_url), _ = detect_servers
    x = frames(6)[0]
    # what JAX's cv2 reads the port's codec reads too: a 16-bit, an interlaced and a palette
    # PNG of the frame get JAX's server's detections
    rng = np.random.default_rng(6)
    colours, index = np.unique((x // 32 * 32 + 16).reshape(-1, 3), axis=0, return_inverse=True)
    for body in (cv2.imencode(".png", x.astype(np.uint16) * 257)[1].tobytes(),
                 write_png(x[..., ::-1], 2, 8, True, rng),
                 write_png(index.reshape(*x.shape[:2], 1), 3, 8, False, rng,
                           plte=colours[:, ::-1])):
        status, got, _ = request(port_url, "/predict", body)
        assert status == 200
        want = json.loads(request(jax_url, "/predict", body)[1])["detections"]
        got = json.loads(got)["detections"]
        w = np.array([[*d["box"], d["conf"], d["cls"]] for d in want], np.float64).reshape(-1, 6)
        g = np.array([[*d["box"], d["conf"], d["cls"]] for d in got], np.float64).reshape(-1, 6)
        _, ties, left_w, left_g = pair_detections(w, g, conf_thres=0.25, box_tol=1e-3,
                                                  conf_tol=1e-5)
        assert len(g) == len(w) > 0 and not len(left_w) and not len(left_g), ties
    monkeypatch.setitem(sys.modules, "cv2", None)       # a machine without cv2
    status, _, reason = request(port_url, "/predict", bodies(6)["jpeg0"])
    assert status == 400 and "cv2" in reason
    assert request(port_url, "/predict", png.encode(x))[0] == 200
    with pytest.raises(SystemExit, match="nc<=256"):
        port_serve.build_server(port_serve.parse_opt(["--cfg", "resnet50.json", "--nc", "300",
                                                      "--device", "cpu"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            port_serve.build_server(port_serve.parse_opt(["--cfg", "resnet50.json"]))


@pytest.fixture(scope="module")
def semantic_servers(tmp_path_factory):
    """JAX's and the port's server of the narrow resnet50 (widths / 16), its
    BatchNorm calibrated on the letterboxed frames; and JAX's jitted scores
    of a letterboxed frame, for the near ties."""
    from yolo_dual_tpu.models.model import SemanticSegModel as JaxSemanticSegModel
    from yolo_dual_tpu_torch.data.augment import letterbox
    root = tmp_path_factory.mktemp("serve_semantic")
    d = narrow_semantic("resnet50", 16)
    jm = JaxSemanticSegModel(d)
    v = random_variables(lambda k, x: jm.module.init(k, x, train=False), (1, IMGSZ, IMGSZ, 3),
                         seed=21)
    boxed = np.stack([letterbox(f[..., ::-1].copy(), IMGSZ)[0] for f in frames(7)])
    v = calibrated_semantic(jm, v, d, torch.from_numpy(boxed).permute(0, 3, 1, 2).float() / 255)
    (root / "sem.yaml").write_text(yaml.safe_dump(d))
    (root / "sem.json").write_text(json.dumps(d))
    torch.save(state_dict_from_flax(v), root / "sem.pt")
    common = ["--imgsz", str(IMGSZ), "--port", "0"]
    jax_srv = jax_server(["--cfg", str(root / "sem.yaml"), "--weights", str(root / "sem.pt")]
                         + common)
    port_srv = port_serve.build_server(port_serve.parse_opt(
        ["--cfg", str(root / "sem.json"), "--weights", str(root / "sem.pt"), "--device", "cpu"]
        + common))
    scores = jax.jit(lambda x: jm.apply(v, x / 255.0, train=False))
    with serving(jax_srv, port_srv) as urls:
        yield urls, scores


def test_semantic_class_maps_equal_jax(semantic_servers):
    from yolo_dual_tpu_torch.data.augment import letterbox
    from yolo_dual_tpu_torch.data.json_dataset import resize_nearest_u8
    (jax_url, port_url), scores = semantic_servers
    flips = near = 0
    for f in frames(7) + frames(8):
        body = png.encode(f)
        want = json.loads(request(jax_url, "/predict", body)[1])
        got = json.loads(request(port_url, "/predict", body)[1])
        assert list(got) == ["shape", "class_pixels", "mask_png_b64"]
        assert got["shape"] == want["shape"] == list(f.shape[:2])
        wmap = cv2.imdecode(np.frombuffer(base64.b64decode(want["mask_png_b64"]), np.uint8),
                            cv2.IMREAD_UNCHANGED)
        gmap = png.decode(base64.b64decode(got["mask_png_b64"]))
        # JAX's near ties, carried through the server's crop and resize to the frame
        im, ratio, pad = letterbox(f[..., ::-1].copy(), IMGSZ)
        top2 = np.sort(np.asarray(scores(im[None].astype(np.float32)))[0], -1)[..., -2:]
        tie = (top2[..., 1] - top2[..., 0] < NEAR_TIE).astype(np.uint8)
        h0, w0 = f.shape[:2]
        bw, bh = int(round(w0 * ratio[0])), int(round(h0 * ratio[1]))
        top, left = int(round(pad[1] - 0.1)), int(round(pad[0] - 0.1))
        tie = resize_nearest_u8(tie[top:top + bh, left:left + bw], h0, w0).astype(bool)
        diff = gmap != wmap
        assert not (diff & ~tie).any(), int((diff & ~tie).sum())
        flips += int(diff.sum())
        near += int(tie.sum())
        hist = np.bincount(gmap.ravel(), minlength=256)
        assert got["class_pixels"] == {str(k): int(c) for k, c in enumerate(hist) if c}
        wc = {int(k): c for k, c in want["class_pixels"].items()}
        assert sum(abs(int(hist[k]) - wc.get(k, 0)) for k in range(256)) <= 2 * int(diff.sum())
        assert len(got["class_pixels"]) > 1
    assert flips <= near


def test_semantic_png_is_grey_uint8(semantic_servers):
    (_, port_url), _ = semantic_servers
    f = frames(9)[2]
    got = json.loads(request(port_url, "/predict", cv2.imencode(".jpg", f)[1].tobytes())[1])
    m = cv2.imdecode(np.frombuffer(base64.b64decode(got["mask_png_b64"]), np.uint8),
                     cv2.IMREAD_UNCHANGED)
    assert m.dtype == np.uint8 and m.shape == f.shape[:2] and m.max() < 12
