"""RetinaFace-ResNet50 face detector (counterpart of
supir_tpu/models/retinaface.py; the reference's facexlib
`retinaface_resnet50`, biubug6/Pytorch_Retinaface), NCHW.

The modules hold facexlib's state-dict keys (`body.layer1.0.conv1.weight`,
`fpn.output1.0.weight`, `ssh1.conv3X3.1.running_mean`,
`ClassHead.0.conv1x1.bias`, ...), so a facexlib checkpoint loads with
`strict=True` (`utils/face_ckpt.py`). The arithmetic is the JAX module's:
a ResNet-50 trunk (C3/C4/C5), an FPN of 256 channels merged top-down
through jax.image's nearest resize (`ops/resize.py:nearest_resize`), three
SSH context modules, per-level class/box/landmark heads at 2 anchors a
position; BatchNorm is inference-only on the running statistics, eps 1e-5.

`RetinaFaceDetector.detect_faces` runs the network on the model's device
on a fixed letterboxed canvas (640, the reference demo's setting) after
jax.image's antialiased linear resize (`ops/resize.py:bilinear_resize`),
then decodes anchors and runs NMS on the host in numpy, as the JAX
detector does: [N, 15] rows of [x1, y1, x2, y2, score, 5 landmarks (x, y)]
in input image coordinates.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from supir_tpu_torch.models.layers import FrozenBatchNorm, init_conv_random
from supir_tpu_torch.ops.resize import bilinear_resize, nearest_resize
from supir_tpu_torch.utils.device import resolve_device

# Anchor configuration (cfg_re50 in biubug6/Pytorch_Retinaface and facexlib)
MIN_SIZES = ((16, 32), (64, 128), (256, 512))
STEPS = (8, 16, 32)
VARIANCES = (0.1, 0.2)
# preprocessing mean, BGR order (detect_faces subtracts (104, 117, 123))
BGR_MEANS = (104.0, 117.0, 123.0)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=bias)


class ConvBN(nn.Sequential):
    """Conv (no bias) + inference BatchNorm (+ ReLU): facexlib's
    `conv_bn`/`conv_bn1X1` Sequentials, keys `.0` and `.1`."""

    def __init__(self, cin: int, cout: int, k: int = 3, stride: int = 1, relu: bool = True):
        super().__init__(_conv(cin, cout, k, stride), FrozenBatchNorm(cout))
        self.relu = relu

    def forward(self, x):
        x = super().forward(x)
        return F.relu(x) if self.relu else x


class Bottleneck(nn.Module):
    """torchvision's ResNet bottleneck (1x1 -> 3x3 with the stride -> 1x1,
    expansion 4) under its keys conv1/bn1 ... downsample.0/.1."""

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, features, 1), FrozenBatchNorm(features)
        self.conv2, self.bn2 = _conv(features, features, 3, stride), FrozenBatchNorm(features)
        self.conv3, self.bn3 = _conv(features, features * 4, 1), FrozenBatchNorm(features * 4)
        self.downsample = (nn.Sequential(_conv(cin, features * 4, 1, stride), FrozenBatchNorm(features * 4))
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


class ResNet50Trunk(nn.Module):
    """ResNet-50 through layer4 under torchvision's keys; returns (C3, C4,
    C5), the outputs of layer2/3/4 (cfg_re50's return_layers)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        cin = 64
        for li, (blocks, feats, stride) in enumerate([(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]):
            layer = []
            for bi in range(blocks):
                layer.append(Bottleneck(cin, feats, stride if bi == 0 else 1, downsample=bi == 0))
                cin = feats * 4
            setattr(self, f"layer{li + 1}", nn.Sequential(*layer))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer1(x)
        c3 = self.layer2(x)
        c4 = self.layer3(c3)
        return c3, c4, self.layer4(c4)


class SSH(nn.Module):
    """SSH context module: 3x3, 5x5 (two 3x3) and 7x7 (three 3x3) branches
    concatenated, then ReLU (facexlib's mixed-case key names kept)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        f2, f4 = features // 2, features // 4
        self.conv3X3 = ConvBN(cin, f2, relu=False)
        self.conv5X5_1 = ConvBN(cin, f4)
        self.conv5X5_2 = ConvBN(f4, f4, relu=False)
        self.conv7X7_2 = ConvBN(f4, f4)
        self.conv7x7_3 = ConvBN(f4, f4, relu=False)

    def forward(self, x):
        c5_1 = self.conv5X5_1(x)
        b7 = self.conv7x7_3(self.conv7X7_2(c5_1))
        return F.relu(torch.cat([self.conv3X3(x), self.conv5X5_2(c5_1), b7], dim=1))


class _Head(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1x1 = nn.Conv2d(cin, cout, 1)

    def forward(self, x, per_anchor: int):
        b = x.shape[0]
        return self.conv1x1(x).permute(0, 2, 3, 1).reshape(b, -1, per_anchor)


class RetinaFace(nn.Module):
    """The detector network: x [B, 3, H, W] float, BGR means subtracted ->
    (loc [B, A, 4], conf [B, A, 2] softmaxed, landms [B, A, 10]), fp32,
    A the anchors over the three strides."""

    def __init__(self, fpn_features: int = 256, num_anchors: int = 2, device=None):
        super().__init__()
        f = fpn_features
        self.body = ResNet50Trunk()
        self.fpn = nn.Module()
        for i, cin in enumerate((512, 1024, 2048), start=1):
            setattr(self.fpn, f"output{i}", ConvBN(cin, f, 1))
        self.fpn.merge1 = ConvBN(f, f)
        self.fpn.merge2 = ConvBN(f, f)
        for i in (1, 2, 3):
            setattr(self, f"ssh{i}", SSH(f, f))
        self.num_anchors = num_anchors
        self.ClassHead = nn.ModuleList(_Head(f, num_anchors * 2) for _ in range(3))
        self.BboxHead = nn.ModuleList(_Head(f, num_anchors * 4) for _ in range(3))
        self.LandmarkHead = nn.ModuleList(_Head(f, num_anchors * 10) for _ in range(3))
        if device is not None:
            self.to(device)

    def forward(self, x):
        c3, c4, c5 = self.body(x)
        p3, p4, p5 = self.fpn.output1(c3), self.fpn.output2(c4), self.fpn.output3(c5)
        p4 = self.fpn.merge2(p4 + nearest_resize(p5, p4.shape[2:]))
        p3 = self.fpn.merge1(p3 + nearest_resize(p4, p3.shape[2:]))
        feats = [self.ssh1(p3), self.ssh2(p4), self.ssh3(p5)]
        loc = torch.cat([h(f, 4) for h, f in zip(self.BboxHead, feats)], dim=1)
        conf = torch.cat([h(f, 2) for h, f in zip(self.ClassHead, feats)], dim=1)
        ldm = torch.cat([h(f, 10) for h, f in zip(self.LandmarkHead, feats)], dim=1)
        return loc.float(), torch.softmax(conf.float(), dim=-1), ldm.float()


# ------------------------------------------------------------------ priors
# host-side numpy, copies of supir_tpu/models/retinaface.py:208-263


def prior_boxes(image_size) -> np.ndarray:
    """Anchor centers/sizes [A, 4] (cx, cy, w, h), normalized to [0, 1]
    (Pytorch_Retinaface prior_box.py semantics, clip=False)."""
    h, w = image_size
    anchors = []
    for k, step in enumerate(STEPS):
        fh = -(-h // step)  # ceil
        fw = -(-w // step)
        for i in range(fh):
            for j in range(fw):
                for ms in MIN_SIZES[k]:
                    anchors.append([(j + 0.5) * step / w, (i + 0.5) * step / h, ms / w, ms / h])
    return np.asarray(anchors, np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """SSD-style box decode (box_utils.decode)."""
    v0, v1 = VARIANCES
    xy = priors[:, :2] + loc[:, :2] * v0 * priors[:, 2:]
    wh = priors[:, 2:] * np.exp(loc[:, 2:] * v1)
    return np.concatenate([xy - wh / 2, xy + wh / 2], axis=1)


def decode_landmarks(ldm: np.ndarray, priors: np.ndarray) -> np.ndarray:
    """[A, 10] landmark decode (box_utils.decode_landm)."""
    v0 = VARIANCES[0]
    pts = [priors[:, :2] + ldm[:, 2 * i:2 * i + 2] * v0 * priors[:, 2:] for i in range(5)]
    return np.concatenate(pts, axis=1)


def nms(dets: np.ndarray, thresh: float) -> list:
    """Plain IoU NMS over [N, 5] (x1, y1, x2, y2, score)."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thresh]
    return keep


class RetinaFaceDetector:
    """detect_faces over a RetinaFace on its device, at one square canvas
    (default 640, gradio_demo_face.py:103), so every image runs the same
    shapes."""

    def __init__(self, model: RetinaFace, canvas: int = 640):
        self.model = model.eval()
        self.canvas = canvas
        self.device = next(model.parameters()).device
        self.priors = prior_boxes((canvas, canvas))

    @classmethod
    def create(cls, seed: int = 0, canvas: int = 640, device="cuda"):
        """Random weights from `seed` (tests, smoke runs); facexlib weights
        load through `utils/face_ckpt.py:load_retinaface`."""
        return cls(init_conv_random(RetinaFace(device=resolve_device(device)), seed), canvas)

    @classmethod
    def from_state_dict(cls, state_dict, canvas: int = 640, device="cuda"):
        model = RetinaFace(device=resolve_device(device))
        model.load_state_dict(state_dict, strict=True)
        return cls(model, canvas)

    @torch.no_grad()
    def forward_canvas(self, image) -> tuple:
        """image HWC BGR (uint8 or float, numpy or a tensor) -> the network's
        (loc, conf, ldm) on its letterboxed canvas, and the resize scale."""
        img = torch.as_tensor(image if torch.is_tensor(image) else np.ascontiguousarray(image, np.float32),
                              dtype=torch.float32).to(self.device)
        h, w = img.shape[:2]
        scale = self.canvas / max(h, w)
        nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
        resized = bilinear_resize(img.permute(2, 0, 1)[None], (nh, nw), antialias=True)
        canvas = torch.zeros(1, 3, self.canvas, self.canvas, device=self.device)
        canvas[:, :, :nh, :nw] = resized
        canvas -= torch.tensor(BGR_MEANS, device=self.device).view(1, 3, 1, 1)
        return self.model(canvas), scale

    def detect_faces(self, image, conf_threshold: float = 0.8, nms_threshold: float = 0.4) -> np.ndarray:
        """image: HWC uint8/float BGR (the reference helper's convention).
        Returns [N, 15] (bbox, score, 5 landmarks) in image coordinates."""
        (loc, conf, ldm), scale = self.forward_canvas(image)
        loc, conf, ldm = (t.cpu().numpy() for t in (loc, conf, ldm))
        boxes = decode_boxes(loc[0], self.priors) * self.canvas / scale
        landms = decode_landmarks(ldm[0], self.priors) * self.canvas / scale
        scores = conf[0, :, 1]

        keep = scores > conf_threshold
        boxes, landms, scores = boxes[keep], landms[keep], scores[keep]
        if boxes.shape[0] == 0:
            return np.zeros((0, 15), np.float32)
        order = scores.argsort()[::-1][:5000]
        boxes, landms, scores = boxes[order], landms[order], scores[order]
        dets = np.concatenate([boxes, scores[:, None]], axis=1).astype(np.float32)
        keep_idx = nms(dets, nms_threshold)
        return np.concatenate([dets[keep_idx][:750], landms[keep_idx][:750]], axis=1)
