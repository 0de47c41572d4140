"""Plain PyTorch Faster R-CNN: the reference that decides `correct`.

Written for the benchmark from the published model (Ren et al. 2015, with
the trzy/FasterRCNN defaults; ResNet C4 as in He et al. 2015, Appendix A).
It imports nothing of the program under test and takes nothing it made: it
reads the configuration's JSON, the weights the harness drew from the seed
and the images and boxes the harness generated.

Every function works on a configuration dict (`configs/<name>.json`'s
"model" object) and a flat `{name: tensor}` parameter dict whose names and
shapes `param_shapes` gives. Computation is in float32, with TF32 off on a
card (`strict_float32`), unless a `precision` other than "float32" is
given: "bfloat16" or "float8" round the inputs and weights of every conv
and dense layer to that type first (float8: e4m3 with one scale a tensor,
its absolute maximum mapped to 448), with an identity gradient. float8 is
the control of a bfloat16 configuration, the precision below it.

Geometry, scores, NMS and losses are float32 throughout, as the model
states. NMS is the exact greedy one (IoU > threshold suppresses, ties in
score order go to the lower index).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-7
NEG_INF = -1e30
CROP = 14
POOL = 7
VGG_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))
RESNET_BLOCKS = {"resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3), "resnet152": (3, 8, 36, 3)}
# Preprocessing of each backbone family: channel order, scale, means, stds.
CAFFE_BGR = (True, 1.0, (103.939, 116.779, 123.680), (1.0, 1.0, 1.0))
TORCHVISION_RGB = (False, 1.0 / 255.0, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


@contextlib.contextmanager
def strict_float32():
    """TF32 off for cuBLAS and cuDNN inside the context."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def is_vgg(cfg: dict) -> bool:
    return cfg["backbone"] == "vgg16"


def feature_channels(cfg: dict) -> int:
    return 512 if is_vgg(cfg) else 1024


def vector_size(cfg: dict) -> int:
    return 4096 if is_vgg(cfg) else 2048


def _bottleneck_shapes(prefix: str, cin: int, mid: int, project: bool) -> List[Tuple[str, tuple]]:
    out = [(f"{prefix}.conv1.weight", (mid, cin, 1, 1)), (f"{prefix}.bn1.scale", (mid,)), (f"{prefix}.bn1.bias", (mid,)),
           (f"{prefix}.conv2.weight", (mid, mid, 3, 3)), (f"{prefix}.bn2.scale", (mid,)), (f"{prefix}.bn2.bias", (mid,)),
           (f"{prefix}.conv3.weight", (4 * mid, mid, 1, 1)), (f"{prefix}.bn3.scale", (4 * mid,)),
           (f"{prefix}.bn3.bias", (4 * mid,))]
    if project:
        out += [(f"{prefix}.downsample_conv.weight", (4 * mid, cin, 1, 1)),
                (f"{prefix}.downsample_bn.scale", (4 * mid,)), (f"{prefix}.downsample_bn.bias", (4 * mid,))]
    return out


def _stage_shapes(prefix: str, n: int, cin: int, mid: int) -> List[Tuple[str, tuple]]:
    out = []
    for i in range(n):
        out += _bottleneck_shapes(f"{prefix}.block{i}", cin, mid, i == 0)
        cin = 4 * mid
    return out


def param_shapes(cfg: dict) -> List[Tuple[str, tuple]]:
    """Every parameter of the model, in a fixed order: (name, shape)."""
    c, a, k = feature_channels(cfg), num_anchors(cfg), cfg["num_classes"]
    shapes: List[Tuple[str, tuple]] = []
    if is_vgg(cfg):
        cin = 3
        for b, (n, ch) in enumerate(VGG_BLOCKS):
            for i in range(n):
                shapes += [(f"feature_extractor.block{b + 1}_conv{i + 1}.weight", (ch, cin, 3, 3)),
                           (f"feature_extractor.block{b + 1}_conv{i + 1}.bias", (ch,))]
                cin = ch
    else:
        blocks = RESNET_BLOCKS[cfg["backbone"]]
        shapes += [("feature_extractor.conv1.weight", (64, 3, 7, 7)), ("feature_extractor.bn1.scale", (64,)),
                   ("feature_extractor.bn1.bias", (64,))]
        shapes += _stage_shapes("feature_extractor.layer1", blocks[0], 64, 64)
        shapes += _stage_shapes("feature_extractor.layer2", blocks[1], 256, 128)
        shapes += _stage_shapes("feature_extractor.layer3", blocks[2], 512, 256)
    shapes += [("rpn_head.conv.weight", (c, c, 3, 3)), ("rpn_head.conv.bias", (c,)),
               ("rpn_head.objectness.weight", (a, c, 1, 1)), ("rpn_head.objectness.bias", (a,)),
               ("rpn_head.deltas.weight", (4 * a, c, 1, 1)), ("rpn_head.deltas.bias", (4 * a,))]
    if is_vgg(cfg):
        shapes += [("roi_head.fc1.weight", (4096, POOL * POOL * 512)), ("roi_head.fc1.bias", (4096,)),
                   ("roi_head.fc2.weight", (4096, 4096)), ("roi_head.fc2.bias", (4096,))]
    else:
        shapes += _stage_shapes("roi_head.layer4", RESNET_BLOCKS[cfg["backbone"]][3], 1024, 512)
    f = vector_size(cfg)
    shapes += [("detector_heads.classifier.weight", (k, f)), ("detector_heads.classifier.bias", (k,)),
               ("detector_heads.regressor.weight", (4 * (k - 1), f)), ("detector_heads.regressor.bias", (4 * (k - 1),))]
    return shapes


def frozen(cfg: dict, name: str) -> bool:
    """Whether training leaves this parameter as it is (the published recipe:
    VGG-16's conv1-conv2 blocks; ResNet's conv1, layer1 and every frozen BN)."""
    if cfg.get("train_all", False):
        return False
    if is_vgg(cfg):
        return ".block1_" in name or ".block2_" in name
    return (name.startswith(("feature_extractor.conv1", "feature_extractor.bn1", "feature_extractor.layer1."))
            or "_bn." in name or ".bn1." in name or ".bn2." in name or ".bn3." in name)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class _RoundTo(torch.autograd.Function):
    """Round to a lower precision and back to float32; identity gradient."""

    @staticmethod
    def forward(ctx, x, precision):
        if precision == "bfloat16":
            return x.to(torch.bfloat16).float()
        amax = x.detach().abs().amax().clamp(min=1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    return x if precision == "float32" else _RoundTo.apply(x, precision)


def conv(x, p, name, precision, stride=1, padding=0, bias=True):
    b = p.get(f"{name}.bias") if bias else None
    return F.conv2d(_q(x, precision), _q(p[f"{name}.weight"], precision), b, stride, padding)


def dense(x, p, name, precision):
    return F.linear(_q(x, precision), _q(p[f"{name}.weight"], precision), p[f"{name}.bias"])


def affine(x, p, name):
    return x * p[f"{name}.scale"].view(-1, 1, 1) + p[f"{name}.bias"].view(-1, 1, 1)


def bottleneck(x, p, name, stride, precision):
    y = F.relu(affine(conv(x, p, f"{name}.conv1", precision, bias=False), p, f"{name}.bn1"))
    y = F.relu(affine(conv(y, p, f"{name}.conv2", precision, stride, 1, bias=False), p, f"{name}.bn2"))
    y = affine(conv(y, p, f"{name}.conv3", precision, bias=False), p, f"{name}.bn3")
    if f"{name}.downsample_conv.weight" in p:
        x = affine(conv(x, p, f"{name}.downsample_conv", precision, stride, bias=False), p, f"{name}.downsample_bn")
    return F.relu(y + x)


def stage(x, p, name, n, stride, precision):
    for i in range(n):
        x = bottleneck(x, p, f"{name}.block{i}", stride if i == 0 else 1, precision)
    return x


def normalize(cfg: dict, images_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB -> (B, 3, H, W) float32, the backbone's
    published preprocessing."""
    bgr, scale, means, stds = CAFFE_BGR if is_vgg(cfg) else TORCHVISION_RGB
    x = images_u8.float()
    if bgr:
        x = x.flip(-1)
    x = x * scale
    x = (x - torch.tensor(means, device=x.device)) / torch.tensor(stds, device=x.device)
    return x.permute(0, 3, 1, 2)


def backbone(cfg: dict, p, images_u8: torch.Tensor, precision: str, train: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, C, H/16, W/16) feature map."""
    x = normalize(cfg, images_u8)
    if is_vgg(cfg):
        for b, (n, _) in enumerate(VGG_BLOCKS):
            for i in range(n):
                x = F.relu(conv(x, p, f"feature_extractor.block{b + 1}_conv{i + 1}", precision, padding=1))
            if b < 4:
                x = F.max_pool2d(x, 2, 2)
            if b == 1 and train and not cfg.get("train_all", False):
                x = x.detach()
        return x
    blocks = RESNET_BLOCKS[cfg["backbone"]]
    x = F.relu(affine(conv(x, p, "feature_extractor.conv1", precision, 2, 3, bias=False), p, "feature_extractor.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    x = stage(x, p, "feature_extractor.layer1", blocks[0], 1, precision)
    if train and not cfg.get("train_all", False):
        x = x.detach()
    x = stage(x, p, "feature_extractor.layer2", blocks[1], 2, precision)
    return stage(x, p, "feature_extractor.layer3", blocks[2], 2, precision)


def rpn_head(p, fm: torch.Tensor, precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, h, w) -> logits (B, h*w*A) and deltas (B, h*w*A, 4), flattened
    in (y, x, anchor) order."""
    x = F.relu(conv(fm, p, "rpn_head.conv", precision, padding=1))
    logits = conv(x, p, "rpn_head.objectness", precision).permute(0, 2, 3, 1)
    deltas = conv(x, p, "rpn_head.deltas", precision).permute(0, 2, 3, 1)
    b = fm.shape[0]
    return logits.reshape(b, -1), deltas.reshape(b, -1, 4)


def roi_head(cfg: dict, p, pooled: torch.Tensor, precision: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 7, 7, C) pooled RoIs -> class logits (N, K) and deltas (N, 4(K-1))."""
    if is_vgg(cfg):
        x = pooled.reshape(pooled.shape[0], -1)  # HWC order
        x = F.relu(dense(x, p, "roi_head.fc1", precision))
        x = F.relu(dense(x, p, "roi_head.fc2", precision))
    else:
        x = stage(pooled.permute(0, 3, 1, 2), p, "roi_head.layer4", RESNET_BLOCKS[cfg["backbone"]][3], 2, precision)
        x = x.mean(dim=(2, 3))
    return dense(x, p, "detector_heads.classifier", precision), dense(x, p, "detector_heads.regressor", precision)


# ---------------------------------------------------------------------------
# Anchors and boxes
# ---------------------------------------------------------------------------


def num_anchors(cfg: dict) -> int:
    a = cfg["anchors"]
    return len(a["areas"]) * len(a["aspect_ratios"])


def feature_size(cfg: dict, h, w):
    """Feature-grid extent of an (h, w) image: floor for VGG, ceil for ResNet."""
    s = cfg["anchors"]["feature_pixels"]
    if is_vgg(cfg):
        return h // s, w // s
    return -(-h // s), -(-w // s)


def anchor_grid(cfg: dict, fm_h: int, fm_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(centers (A, 4) cy, cx, h, w; corners (A, 4)), float32, in (y, x,
    anchor) order. Each cell's center ((i + 0.5) * stride) is rounded to
    float32 before the float64 size template is added; the sum is then
    rounded to float32."""
    a = cfg["anchors"]
    sizes = []
    for area in a["areas"]:
        for r in a["aspect_ratios"]:
            w = math.sqrt(area / r)
            sizes.append((r * w, w))
    half = 0.5 * np.array(sizes, np.float64)
    s = float(a["feature_pixels"])
    cy, cx = np.meshgrid((np.arange(fm_h) + 0.5) * s, (np.arange(fm_w) + 0.5) * s, indexing="ij")
    c = np.stack([cy, cx], -1).astype(np.float32).astype(np.float64)[:, :, None, :]
    corners = np.concatenate([c - half, c + half], -1).reshape(-1, 4)
    centers = np.concatenate([0.5 * (corners[:, :2] + corners[:, 2:]), corners[:, 2:] - corners[:, :2]], -1)
    return centers.astype(np.float32), corners.astype(np.float32)


def iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) corner boxes -> (..., N, M) IoU; a
    zero-area intersection is no overlap; the union is padded by 1e-7."""
    tl = torch.maximum(b1[..., :, None, :2], b2[..., None, :, :2])
    br = torch.minimum(b1[..., :, None, 2:], b2[..., None, :, 2:])
    inter = (tl < br).all(-1) * (br - tl).prod(-1)
    a1 = (b1[..., 2:] - b1[..., :2]).prod(-1)
    a2 = (b2[..., 2:] - b2[..., :2]).prod(-1)
    return inter / (a1[..., :, None] + a2[..., None, :] - inter + EPS)


def to_centers(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([0.5 * (b[..., :2] + b[..., 2:]), b[..., 2:] - b[..., :2]], -1)


def decode(deltas, anchors_ctr, stds=(1.0, 1.0, 1.0, 1.0)):
    d = deltas * torch.tensor(stds, device=deltas.device)
    center = anchors_ctr[..., 2:] * d[..., :2] + anchors_ctr[..., :2]
    size = anchors_ctr[..., 2:] * torch.exp(d[..., 2:])
    return torch.cat([center - 0.5 * size, center + 0.5 * size], -1)


def encode(gt_ctr, anchors_ctr):
    return torch.cat([(gt_ctr[..., :2] - anchors_ctr[..., :2]) / anchors_ctr[..., 2:],
                      torch.log(gt_ctr[..., 2:] / anchors_ctr[..., 2:])], -1)


def clip(boxes, h, w):
    """Clamp corners into [0, h] x [0, w]; h and w broadcast against boxes[..., 0]."""
    y = torch.minimum(boxes[..., 0::2].clamp(min=0.0), h[..., None])
    x = torch.minimum(boxes[..., 1::2].clamp(min=0.0), w[..., None])
    return torch.stack([y[..., 0], x[..., 0], y[..., 1], x[..., 1]], -1)


def greedy_nms(boxes: torch.Tensor, valid: torch.Tensor, threshold: float, max_keep: int) -> torch.Tensor:
    """(N, K, 4) boxes in descending score order, (N, K) bool -> (N, K) bool
    keep mask of greedy NMS, cut to the first max_keep kept."""
    keep = valid.clone()
    k = boxes.shape[1]
    for start in range(0, k, 512):
        stop = min(start + 512, k)
        sup = (iou(boxes[:, start:stop], boxes) > threshold)  # (N, b, K)
        later = torch.arange(k, device=boxes.device)[None, :] > torch.arange(start, stop, device=boxes.device)[:, None]
        sup &= later[None]
        for i in range(stop - start):
            row = keep[:, start + i:start + i + 1]
            keep &= ~(sup[:, i] & row)
    return keep & (keep.cumsum(1) <= max_keep)


def gather_kept(boxes, scores, keep, max_out):
    """The first max_out kept entries of each row, in order, padded: boxes,
    scores, valid."""
    n, k = keep.shape
    order = torch.sort(keep.to(torch.int8), dim=1, descending=True, stable=True).indices[:, :max_out]
    v = torch.gather(keep, 1, order)
    if order.shape[1] < max_out:
        pad = max_out - order.shape[1]
        order = torch.cat([order, order.new_zeros(n, pad)], 1)
        v = torch.cat([v, v.new_zeros(n, pad)], 1)
    b = torch.gather(boxes, 1, order[..., None].expand(n, max_out, 4))
    s = torch.gather(scores, 1, order)
    return torch.where(v[..., None], b, 0.0), torch.where(v, s, 0.0), v


class Proposals(NamedTuple):
    boxes: torch.Tensor  # (B, K_post, 4)
    valid: torch.Tensor  # (B, K_post) bool


def proposals(cfg: dict, logits, deltas, image_hw, canvas_fm, train: bool) -> Proposals:
    """Top K_pre anchors by logit among those over the real feature grid,
    decoded, clipped to the image, at least min_side a side, greedy NMS,
    the first K_post kept."""
    rpn = cfg["rpn"]
    k_pre = rpn["pre_nms_train"] if train else rpn["pre_nms_infer"]
    k_post = rpn["post_nms_train"] if train else rpn["post_nms_infer"]
    dev = logits.device
    fm_h, fm_w = canvas_fm
    centers, corners = (torch.as_tensor(t, device=dev) for t in anchor_grid(cfg, fm_h, fm_w))
    hw = image_hw.float()
    mask = proposal_mask(cfg, fm_h, fm_w, hw, corners)
    scores = torch.where(mask, logits.float(), NEG_INF)
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    top, idx = top[:, :k_pre], idx[:, :k_pre]
    boxes = decode(torch.gather(deltas.float(), 1, idx[..., None].expand(-1, -1, 4)), centers[idx])
    boxes = clip(boxes, hw[:, 0:1], hw[:, 1:2])
    m = rpn["min_proposal_side"]
    valid = (top > NEG_INF) & (boxes[..., 2] - boxes[..., 0] >= m) & (boxes[..., 3] - boxes[..., 1] >= m)
    keep = greedy_nms(boxes, valid, rpn["nms_iou_threshold"], k_post)
    b, _, v = gather_kept(boxes, top, keep, k_post)
    return Proposals(b, v)


def anchors_exist(cfg: dict, fm_h: int, fm_w: int, hw: torch.Tensor) -> torch.Tensor:
    """(B, A) bool: the anchor's cell lies inside the real feature grid."""
    a = num_anchors(cfg)
    idx = torch.arange(fm_h * fm_w * a, device=hw.device)
    cy, cx = idx // (fm_w * a), (idx // a) % fm_w
    fh, fw = feature_size(cfg, hw[:, 0].long(), hw[:, 1].long())
    return (cy[None] < fh[:, None]) & (cx[None] < fw[:, None])


def inside_image(corners: torch.Tensor, hw: torch.Tensor) -> torch.Tensor:
    return ((corners[None, :, 0] >= 0) & (corners[None, :, 1] >= 0)
            & (corners[None, :, 2] <= hw[:, 0:1]) & (corners[None, :, 3] <= hw[:, 1:2]))


def proposal_mask(cfg, fm_h, fm_w, hw, corners):
    exists = anchors_exist(cfg, fm_h, fm_w, hw)
    return exists if cfg.get("allow_edge_proposals", True) else exists & inside_image(corners, hw)


# ---------------------------------------------------------------------------
# RoI crop and pool
# ---------------------------------------------------------------------------


def roi_pool(cfg: dict, fm: torch.Tensor, rois: torch.Tensor, image_hw: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) map, (B, P, 4) pixel corners -> (B, P, 7, 7, C).

    Each RoI is scaled onto the image's real feature grid by ((fh - 1) / h,
    (fw - 1) / w) and sampled bilinearly at 14 x 14 evenly spaced points
    (corners included); a sample whose row or column lies outside the
    canvas map contributes 0. Then a 2 x 2 max pool."""
    b, c, h, w = fm.shape
    hw = image_hw.float()
    fh, fw = feature_size(cfg, hw[:, 0].long(), hw[:, 1].long())
    norm = torch.stack([(fh.float() - 1) / hw[:, 0], (fw.float() - 1) / hw[:, 1]], 1)
    steps = torch.tensor([s / (CROP - 1) for s in range(CROP)], device=fm.device)
    r = rois.float() * norm[:, (0, 1, 0, 1)][:, None, :]
    ys = r[..., 0:1] + (r[..., 2:3] - r[..., 0:1]) * steps  # (B, P, 14)
    xs = r[..., 1:2] + (r[..., 3:4] - r[..., 1:2]) * steps
    out = []
    for i in range(b):
        out.append(_crop_one(fm[i].permute(1, 2, 0), ys[i], xs[i]))
    crops = torch.stack(out)  # (B, P, 14, 14, C)
    p = rois.shape[1]
    return crops.reshape(b, p, POOL, 2, POOL, 2, c).amax(dim=(3, 5))


def _taps(coords: torch.Tensor, size: int):
    lo = torch.floor(coords)
    frac = coords - lo
    inside = (coords >= 0) & (coords <= size - 1)
    i0 = lo.long().clamp(0, size - 1)
    i1 = (lo.long() + 1).clamp(0, size - 1)
    w0 = torch.where(inside, 1.0 - frac, 0.0)
    w1 = torch.where(inside & (lo + 1 <= size - 1), frac, 0.0)
    return i0, i1, w0, w1


def _crop_one(fm: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """(H, W, C) map, (P, 14) y and x positions -> (P, 14, 14, C)."""
    h, w, _ = fm.shape
    y0, y1, wy0, wy1 = _taps(ys, h)
    x0, x1, wx0, wx1 = _taps(xs, w)
    rows = (wy0[..., None, None] * fm[y0] + wy1[..., None, None] * fm[y1])  # (P, 14, W, C)
    p = ys.shape[0]
    ar = torch.arange(p, device=fm.device)[:, None, None]
    ay = torch.arange(CROP, device=fm.device)[None, :, None]
    c0 = rows[ar, ay, x0[:, None, :]]  # (P, 14, 14, C)
    c1 = rows[ar, ay, x1[:, None, :]]
    return wx0[:, None, :, None] * c0 + wx1[:, None, :, None] * c1


# ---------------------------------------------------------------------------
# Predict
# ---------------------------------------------------------------------------


class Detections(NamedTuple):
    boxes: torch.Tensor  # (B, K-1, D, 4)
    scores: torch.Tensor  # (B, K-1, D)
    valid: torch.Tensor  # (B, K-1, D) bool


@torch.no_grad()
def predict(cfg: dict, p, images_u8: torch.Tensor, image_hw: torch.Tensor, score_threshold: float,
            precision: str = "float32", chunk: int = 8) -> Detections:
    """Detections of a padded canvas batch: proposals with the predict caps,
    the RoI head on them, per-class decode (stds .1 .1 .2 .2) clipped to
    [0, side - 1], scores above the threshold, per-class greedy NMS."""
    outs = [_predict_chunk(cfg, p, images_u8[i:i + chunk], image_hw[i:i + chunk], score_threshold, precision)
            for i in range(0, images_u8.shape[0], chunk)]
    return Detections(*(torch.cat(t) for t in zip(*outs)))


def _predict_chunk(cfg, p, images_u8, image_hw, score_threshold, precision):
    fm = backbone(cfg, p, images_u8, precision)
    logits, deltas = rpn_head(p, fm, precision)
    hw = image_hw.float()
    props = proposals(cfg, logits, deltas, hw, fm.shape[2:], train=False)
    b, s = props.valid.shape
    pooled = roi_pool(cfg, fm, props.boxes, hw).reshape(b * s, POOL, POOL, -1)
    parts = [roi_head(cfg, p, pooled[i:i + 2400], precision) for i in range(0, b * s, 2400)]
    cls_logits, box_deltas = (torch.cat(t) for t in zip(*parts))
    k = cfg["num_classes"]
    probs = torch.softmax(cls_logits, -1).reshape(b, s, k)
    det = cfg["detector"]
    dec = decode(box_deltas.reshape(b, s, k - 1, 4), to_centers(props.boxes)[:, :, None, :], det["delta_stds"])
    dec = clip(dec, (hw[:, 0] - 1)[:, None, None], (hw[:, 1] - 1)[:, None, None])
    boxes = dec.permute(0, 2, 1, 3).reshape(b * (k - 1), s, 4)
    scores = probs[..., 1:].permute(0, 2, 1).reshape(b * (k - 1), s)
    valid = (scores > score_threshold) & props.valid[:, None, :].expand(b, k - 1, s).reshape(b * (k - 1), s)
    scores = torch.where(valid, scores, NEG_INF)
    scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    boxes = torch.gather(boxes, 1, order[..., None].expand_as(boxes))
    valid = torch.gather(valid, 1, order)
    max_det = det.get("max_detections_per_class", 0) or cfg["rpn"]["post_nms_infer"]
    keep = greedy_nms(boxes, valid, det["test_nms_iou_threshold"], max_det)
    bx, sc, v = gather_kept(boxes, scores, keep, max_det)
    return bx.reshape(b, k - 1, max_det, 4), sc.reshape(b, k - 1, max_det), v.reshape(b, k - 1, max_det)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def draw_uniforms(cfg: dict, batch: int, anchors: int, generator: torch.Generator, device):
    """The four uniform tensors a train step's sampling consumes, in the
    order the step draws them: RPN positive and negative ranks (B, A), then
    detector positive and negative ranks (B, K_post_train + G)."""
    shapes = ((batch, anchors),) * 2 + ((batch, cfg["rpn"]["post_nms_train"] + cfg["max_gt_boxes"]),) * 2
    return [torch.rand(s, generator=generator, device=device) for s in shapes]


def masked_rank(u: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Rank of each element of a row within its masked subset by its
    uniform (stable); outside the mask ranks come after."""
    order = torch.argsort(torch.where(mask, u, 2.0), dim=-1, stable=True)
    pos = torch.arange(mask.shape[-1], device=mask.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, pos)


def rpn_targets(cfg, centers, corners, valid, gt, gt_mask):
    """Labels (trainable, objectness) and regression targets of every
    anchor: IoU < 0.3 background, >= 0.7 object, and for each real gt box
    every valid anchor at its best IoU is an object."""
    rpn = cfg["rpn"]
    real = gt_mask > 0
    ious = iou(corners[None], gt)
    ious = torch.where(valid[:, :, None], ious, -1.0)
    ious = torch.where(real[:, None, :], ious, -2.0)
    best = ious.amax(2)
    best_gt = ious.argmax(2)
    forced = ((ious == ious.amax(1, keepdim=True)) & real[:, None, :]).any(2) & valid
    label = torch.full_like(best_gt, -1)
    label = torch.where(best < rpn["background_iou_threshold"], 0, label)
    label = torch.where(best >= rpn["object_iou_threshold"], 1, label)
    label = torch.where(forced, 1, label)
    assigned = torch.gather(gt, 1, best_gt[..., None].expand(-1, -1, 4))
    deltas = encode(to_centers(assigned), centers[None])
    deltas = torch.where(torch.isfinite(deltas), deltas, 0.0)
    return (valid & (label >= 0)).float(), (label == 1).float(), deltas


def rpn_minibatch(cfg, trainable, objectness, u_pos, u_neg):
    rpn = cfg["rpn"]
    pos = (trainable > 0) & (objectness > 0)
    neg = (trainable > 0) & (objectness == 0)
    n_pos = pos.sum(-1, keepdim=True).clamp(max=int(rpn["minibatch_size"] * rpn["max_positive_fraction"]))
    n_neg = torch.minimum(rpn["minibatch_size"] - n_pos, neg.sum(-1, keepdim=True))
    return ((pos & (masked_rank(u_pos, pos) < n_pos)) | (neg & (masked_rank(u_neg, neg) < n_neg))).float()


def sample_proposals(cfg, props: Proposals, gt, gt_cls, gt_mask, u_pos, u_neg):
    """The detector's minibatch: gt boxes join the proposals; best-IoU gt
    gives the class (IoU < 0.5: background); min(128, N) samples, at most a
    quarter positive (rounded half to even); none if a side is empty.
    Returns boxes (B, S, 4), classes (B, S), targets (B, S, 4), weights
    (B, S), count (B,)."""
    det = cfg["detector"]
    s_max = det["proposal_batch_size"]
    real = gt_mask > 0
    boxes = torch.cat([props.boxes, gt], 1)
    valid = torch.cat([props.valid, real], 1)
    ious = torch.where(real[:, None, :], iou(boxes, gt), -1.0)
    best, best_gt = ious.amax(2), ious.argmax(2)
    valid = valid & (best >= det["min_background_iou"])
    label = torch.where(best >= det["min_object_iou"], torch.gather(gt_cls.long(), 1, best_gt), 0)
    label = torch.where(valid, label, 0)
    pos, neg = valid & (label > 0), valid & (label == 0)
    n = valid.sum(-1, keepdim=True).clamp(max=s_max)
    n_pos = torch.minimum(torch.round(n.float() * det["positive_fraction"]).long(), pos.sum(-1, keepdim=True))
    n_neg = torch.minimum(n - n_pos, neg.sum(-1, keepdim=True))
    empty = (n_pos <= 0) | (n_neg <= 0)
    sel = ((pos & (masked_rank(u_pos, pos) < n_pos)) | (neg & (masked_rank(u_neg, neg) < n_neg))) & ~empty
    slots = torch.sort(sel.to(torch.int8), dim=1, descending=True, stable=True).indices[:, :s_max]
    live = torch.gather(sel, 1, slots)
    sboxes = torch.gather(boxes, 1, slots[..., None].expand(-1, -1, 4))
    classes = torch.where(live, torch.gather(label, 1, slots), 0)
    assigned = torch.gather(gt, 1, torch.gather(best_gt, 1, slots)[..., None].expand(-1, -1, 4))
    targets = encode(to_centers(assigned), to_centers(sboxes)) / torch.tensor(det["delta_stds"], device=gt.device)
    targets = torch.where(torch.isfinite(targets), targets, 0.0)
    count = ((n_pos + n_neg) * (~empty).long()).squeeze(1)
    return torch.where(live[..., None], sboxes, 0.0), classes, targets, live.float(), count


def smooth_l1(x, sigma):
    s2 = sigma * sigma
    return torch.where(x.abs() < 1.0 / s2, 0.5 * x * x * s2, x.abs() - 0.5 / s2)


def losses(cfg: dict, p, batch: dict, draws, precision: str = "float32") -> torch.Tensor:
    """The four losses (rpn class, rpn regression, detector class, detector
    regression) of a padded batch, each a sample-weighted mean over images:
    a (4,) tensor, differentiable with respect to `p`. `batch` holds images
    (B, H, W, 3) uint8, image_hw (B, 2), gt_boxes (B, G, 4), gt_classes
    (B, G), gt_mask (B, G) and sample_weight (B,) on the device."""
    rpn, det = cfg["rpn"], cfg["detector"]
    hw = batch["image_hw"].float()
    fm = backbone(cfg, p, batch["images"], precision, train=True)
    logits, deltas = rpn_head(p, fm, precision)
    fm_h, fm_w = fm.shape[2:]
    centers, corners = (torch.as_tensor(t, device=fm.device) for t in anchor_grid(cfg, fm_h, fm_w))
    props = proposals(cfg, logits.detach(), deltas.detach(), hw, (fm_h, fm_w), train=True)
    valid = anchors_exist(cfg, fm_h, fm_w, hw) & inside_image(corners, hw)
    gt = batch["gt_boxes"].float()
    trainable, objectness, targets = rpn_targets(cfg, centers, corners, valid, gt, batch["gt_mask"])
    mb = rpn_minibatch(cfg, trainable, objectness, draws[0], draws[1])
    sboxes, classes, dtargets, weights, count = sample_proposals(
        cfg, props, gt, batch["gt_classes"], batch["gt_mask"], draws[2], draws[3])
    b, s = classes.shape
    pooled = roi_pool(cfg, fm, sboxes, hw).reshape(b * s, POOL, POOL, -1)
    cls_logits, box_deltas = roi_head(cfg, p, pooled, precision)
    cls_logits, box_deltas = cls_logits.reshape(b, s, -1), box_deltas.reshape(b, s, -1, 4)

    n_cls = mb.sum(-1) + EPS
    z = logits
    rpn_cls = ((z.clamp(min=0) - z * objectness + torch.log1p(torch.exp(-z.abs()))) * mb).sum(-1) / n_cls
    rpn_reg = (smooth_l1(targets - deltas, rpn["regression_sigma"]) * (mb * objectness)[..., None]).sum((-2, -1)) / n_cls
    logp = torch.log_softmax(cls_logits, -1)
    det_cls = -(torch.gather(logp, -1, classes[..., None])[..., 0] * weights).sum(-1) / (count + EPS)
    slot = (classes - 1).clamp(min=0)[..., None, None].expand(b, s, 1, 4)
    picked = torch.gather(box_deltas, 2, slot)[:, :, 0]
    positive = (classes > 0).float() * weights
    det_reg = (smooth_l1(dtargets - picked, det["regression_sigma"]) * positive[..., None]).sum((-2, -1)) / (count + EPS)
    w = batch["sample_weight"].float()
    denom = w.sum() + EPS
    return torch.stack([(v * w).sum() / denom for v in (rpn_cls, rpn_reg, det_cls, det_reg)])


def sgd_step(cfg: dict, train: dict, p: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
             trace: Dict[str, torch.Tensor]) -> None:
    """SGD with momentum and decoupled-as-added weight decay, in place:
    trace = momentum * trace + (g + wd * p) (wd on weights and scales
    only), p -= lr * trace."""
    for name, g in grads.items():
        wd = train["weight_decay"] if name.endswith(("weight", "scale")) else 0.0
        d = g + wd * p[name] if wd else g
        trace[name] = train["momentum"] * trace[name] + d if name in trace else d.clone()
        p[name] = p[name] - train["learning_rate"] * trace[name]
