"""paddle.vision.ops for the port (counterpart of paddle_tpu/vision/ops.py):
the detection ops, over torch tensors on the input's device.

The reference writes them as plain JAX (no Pallas kernel), so their port
is plain PyTorch: gathers for the RoI ops, corner gathers and one
`einsum` for `deform_conv2d`, as the reference does. The differentiable
ones (`roi_align`, `roi_pool`, `psroi_pool`, `deform_conv2d`,
`yolo_loss`) take their gradients from torch autograd. `nms` sweeps the
sorted IoU matrix on the device, one box a step with no host sync, and
reads the kept count once; `matrix_nms`, `distribute_fpn_proposals` and
`generate_proposals` return data-dependent sizes and finish on the host,
as the reference's do.

Reference facts kept for parity (ROADMAP): `roi_align` with
`sampling_ratio <= 0` takes 2 samples a bin side, where Paddle adapts the
count to the box; `roi_pool` is the max over a 2 x 2 sample grid a bin.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import nn
from ..core.tensor import Tensor

__all__ = ["nms", "box_area", "box_iou", "roi_align", "RoIAlign",
           "roi_pool", "RoIPool", "psroi_pool", "PSRoIPool",
           "deform_conv2d", "DeformConv2D", "yolo_box", "prior_box",
           "box_coder", "matrix_nms", "distribute_fpn_proposals",
           "generate_proposals", "yolo_loss"]


def _t(x, like=None) -> torch.Tensor:
    """The torch tensor of a Tensor, torch tensor or array (on `like`'s
    device for an array)."""
    if isinstance(x, Tensor):
        return x._t
    if isinstance(x, torch.Tensor):
        return x
    t = torch.as_tensor(np.asarray(x))
    return t if like is None else t.to(like.device)


def _wrap(t: torch.Tensor) -> Tensor:
    return Tensor._wrap(t)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def box_area(boxes):
    b = _t(boxes)
    return _wrap((b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1]))


def _iou_matrix(boxes1, boxes2):
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / torch.clamp(union, min=1e-10)


def box_iou(boxes1, boxes2):
    b1 = _t(boxes1)
    return _wrap(_iou_matrix(b1, _t(boxes2, b1)))


def _keep_mask(iou, threshold):
    """Greedy suppression over the score-sorted IoU matrix: box i is kept
    unless it overlaps an earlier kept box above `threshold`. One device
    step a box, no host sync."""
    n = iou.shape[0]
    over = iou > threshold
    keep = torch.ones(n, dtype=torch.bool, device=iou.device)
    for i in range(1, n):
        keep[i] = ~torch.any(over[i, :i] & keep[:i])
    return keep


def nms(boxes, iou_threshold=0.3, scores=None, category_idxs=None,
        categories=None, top_k=None):
    """Greedy NMS; the kept indices by descending score (boxes of
    different `category_idxs` never suppress each other)."""
    b = _t(boxes).float()
    n = b.shape[0]
    s = (_t(scores, b).float() if scores is not None
         else torch.arange(n, 0, -1, dtype=torch.float32, device=b.device))
    if category_idxs is not None:
        cat = _t(category_idxs, b).float()
        b = b + (cat * (b.max() + 1.0))[:, None]
    order = torch.argsort(-s, stable=True)
    b_sorted = b[order]
    keep = _keep_mask(_iou_matrix(b_sorted, b_sorted), iou_threshold)
    kept = order[torch.nonzero(keep).reshape(-1)]
    if top_k is not None:
        kept = kept[:top_k]
    return _wrap(kept)


def _batch_index(n, boxes_num, k, device):
    bn = _t(boxes_num).to(device=device, dtype=torch.long).reshape(-1)
    idx = torch.repeat_interleave(torch.arange(n, device=device), bn)
    if idx.numel() != k:
        raise ValueError(f"boxes_num sums to {idx.numel()}, there are {k} "
                         f"boxes")
    return idx


def roi_align(x, boxes, boxes_num, output_size, spatial_scale=1.0,
              sampling_ratio=-1, aligned=True, name=None):
    """RoIAlign with bilinear sampling (NCHW input, boxes [K, 4] x1 y1 x2
    y2); `sampling_ratio <= 0` takes 2 samples a bin side."""
    xd = _t(x).float()
    bx = _t(boxes, xd).float()
    oh, ow = _pair(output_size)
    N, C, H, W = xd.shape
    K = bx.shape[0]
    bidx = _batch_index(N, boxes_num, K, xd.device)
    offset = 0.5 if aligned else 0.0
    sr = sampling_ratio if sampling_ratio > 0 else 2
    x1, y1, x2, y2 = (bx * spatial_scale - offset).unbind(1)
    floor_wh = 1.0 if not aligned else 1e-6
    rw = torch.clamp(x2 - x1, min=floor_wh)
    rh = torch.clamp(y2 - y1, min=floor_wh)
    bin_h = rh / oh
    bin_w = rw / ow
    gy = torch.arange(oh * sr, device=xd.device) + 0.5
    gx = torch.arange(ow * sr, device=xd.device) + 0.5
    ys = y1[:, None] + gy[None] * bin_h[:, None] / sr     # (K, oh*sr)
    xs = x1[:, None] + gx[None] * bin_w[:, None] / sr
    y0 = torch.clamp(torch.floor(ys), 0, H - 1).long()
    x0 = torch.clamp(torch.floor(xs), 0, W - 1).long()
    y1i = torch.clamp(y0 + 1, 0, H - 1)
    x1i = torch.clamp(x0 + 1, 0, W - 1)
    wy = torch.clamp(ys - y0, 0, 1)[:, None, :, None]
    wx = torch.clamp(xs - x0, 0, 1)[:, None, None, :]
    b = bidx[:, None, None]

    def at(yi, xi):     # (K, C, oh*sr, ow*sr)
        return xd[b, :, yi[:, :, None], xi[:, None, :]].permute(0, 3, 1, 2)

    v = (at(y0, x0) * (1 - wy) * (1 - wx)
         + at(y1i, x0) * wy * (1 - wx)
         + at(y0, x1i) * (1 - wy) * wx
         + at(y1i, x1i) * wy * wx)
    return _wrap(v.reshape(K, C, oh, sr, ow, sr).mean(dim=(3, 5)))


class RoIAlign:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_align(x, boxes, boxes_num, self.output_size,
                         self.spatial_scale)


def _grid_samples(bx, n_bins, sr, size, start, extent):
    """Integer sample positions (K, n_bins * sr): `sr` a bin side, at the
    bin's cell centres over [start, start + extent), clipped to the map."""
    g = torch.arange(n_bins * sr, device=bx.device) + 0.5
    pos = start[:, None] + g[None] * extent[:, None] / (n_bins * sr)
    return torch.clamp(pos, 0, size - 1).long()


def roi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0, name=None):
    """RoIPool as the reference: the max over a 2 x 2 sample grid a bin of
    the rounded box."""
    xd = _t(x).float()
    bx = _t(boxes, xd).float()
    oh, ow = _pair(output_size)
    N, C, H, W = xd.shape
    K = bx.shape[0]
    bidx = _batch_index(N, boxes_num, K, xd.device)
    sr = 2
    x1, y1, x2, y2 = torch.round(bx * spatial_scale).unbind(1)
    rw = torch.clamp(x2 - x1 + 1, min=1.0)
    rh = torch.clamp(y2 - y1 + 1, min=1.0)
    yi = _grid_samples(bx, oh, sr, H, y1, rh)
    xi = _grid_samples(bx, ow, sr, W, x1, rw)
    v = xd[bidx[:, None, None], :, yi[:, :, None], xi[:, None, :]]
    v = v.permute(0, 3, 1, 2).reshape(K, C, oh, sr, ow, sr)
    return _wrap(v.amax(dim=(3, 5)))


class RoIPool:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return roi_pool(x, boxes, boxes_num, self.output_size,
                        self.spatial_scale)


def psroi_pool(x, boxes, boxes_num, output_size, spatial_scale=1.0,
               name=None):
    """Position-sensitive RoI pooling (R-FCN): the input's channels factor
    as out_channels x oh x ow, and bin (i, j) averages its own channel
    group over a 2 x 2 sample grid of its region."""
    xd = _t(x).float()
    bx = _t(boxes, xd).float()
    oh, ow = _pair(output_size)
    N, C, H, W = xd.shape
    if C % (oh * ow):
        raise ValueError(f"psroi_pool: channels {C} not divisible by "
                         f"{oh}x{ow} bins")
    oc = C // (oh * ow)
    K = bx.shape[0]
    bidx = _batch_index(N, boxes_num, K, xd.device)
    sr = 2
    x1, y1, x2, y2 = (bx * spatial_scale).unbind(1)
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    yy = _grid_samples(bx, oh, sr, H, y1, rh).reshape(K, oh, sr)
    xx = _grid_samples(bx, ow, sr, W, x1, rw).reshape(K, ow, sr)
    dev = xd.device
    ch = (torch.arange(oc, device=dev)[:, None, None] * (oh * ow)
          + torch.arange(oh, device=dev)[None, :, None] * ow
          + torch.arange(ow, device=dev)[None, None, :])    # (oc, oh, ow)
    v = xd[bidx[:, None, None, None, None, None],
           ch[None, :, :, :, None, None],
           yy[:, None, :, None, :, None],
           xx[:, None, None, :, None, :]]           # (K, oc, oh, ow, sr, sr)
    return _wrap(v.mean(dim=(-1, -2)))


class PSRoIPool:
    def __init__(self, output_size, spatial_scale=1.0):
        self.output_size = output_size
        self.spatial_scale = spatial_scale

    def __call__(self, x, boxes, boxes_num):
        return psroi_pool(x, boxes, boxes_num, self.output_size,
                          self.spatial_scale)


def deform_conv2d(x, offset, weight, bias=None, stride=1, padding=0,
                  dilation=1, deformable_groups=1, groups=1, mask=None,
                  name=None):
    """Deformable convolution v1 (`mask=None`) and v2, as the reference:
    the sampled patches built by four bilinear corner gathers, contracted
    with the weight by one einsum (accumulated in fp32).

    Shapes (NCHW): x (N, C, H, W); offset (N, 2 * dg * kh * kw, Ho, Wo),
    (y, x) a kernel tap; mask (N, dg * kh * kw, Ho, Wo); weight (Cout,
    C // groups, kh, kw).
    """
    xd = _t(x)
    od = _t(offset, xd)
    wd = _t(weight, xd)
    md = None if mask is None else _t(mask, xd)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    N, C, H, W = xd.shape
    Cout, _, kh, kw = wd.shape
    K = kh * kw
    dg = deformable_groups
    Ho = (H + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    Wo = (W + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    Cper = C // dg
    dev = xd.device

    ky, kx = torch.meshgrid(torch.arange(kh, device=dev),
                            torch.arange(kw, device=dev), indexing="ij")
    base_y = (torch.arange(Ho, device=dev) * sh - ph)[None, :, None] + \
        (ky.reshape(-1) * dh)[:, None, None]
    base_x = (torch.arange(Wo, device=dev) * sw - pw)[None, None, :] + \
        (kx.reshape(-1) * dw)[:, None, None]
    off = od.reshape(N, dg, K, 2, Ho, Wo)
    py = base_y[None, None] + off[:, :, :, 0]          # (N, dg, K, Ho, Wo)
    px = base_x[None, None] + off[:, :, :, 1]
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = py - y0
    wx = px - x0
    flat = xd.reshape(N, C, H * W)

    def corner(yc, xc):
        inside = (yc >= 0) & (yc <= H - 1) & (xc >= 0) & (xc <= W - 1)
        yi = torch.clamp(yc, 0, H - 1).long()
        xi = torch.clamp(xc, 0, W - 1).long()
        idx = (yi * W + xi).reshape(N, dg, 1, K * Ho * Wo)
        idx = idx.expand(N, dg, Cper, K * Ho * Wo).reshape(N, C, K * Ho * Wo)
        v = torch.gather(flat, 2, idx).reshape(N, dg, Cper, K, Ho, Wo)
        return v * inside[:, :, None].to(xd.dtype)

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    wy = wy[:, :, None].to(xd.dtype)
    wx = wx[:, :, None].to(xd.dtype)
    vals = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
            + v10 * wy * (1 - wx) + v11 * wy * wx)     # (N, dg, Cper, K, ..)
    if md is not None:
        vals = vals * md.reshape(N, dg, 1, K, Ho, Wo).to(xd.dtype)
    vals = vals.reshape(N, groups, C // groups, K, Ho, Wo)
    wg = wd.reshape(groups, Cout // groups, C // groups, K)
    out = torch.einsum("ngckhw,gock->ngohw", vals.float(), wg.float())
    out = out.reshape(N, Cout, Ho, Wo).to(xd.dtype)
    if bias is not None:
        out = out + _t(bias, xd).reshape(1, -1, 1, 1)
    return _wrap(out)


class DeformConv2D(nn.Layer):
    """nn.Layer over deform_conv2d: the weight and bias live in an inner
    Conv2D (`_conv`), as the reference's, so state dicts cross by name."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self._conv = nn.Conv2D(in_channels, out_channels,
                               _pair(kernel_size), stride=stride,
                               padding=padding, dilation=dilation,
                               groups=groups, weight_attr=weight_attr,
                               bias_attr=bias_attr)
        self.stride = stride
        self.padding = padding
        self.dilation = dilation
        self.deformable_groups = deformable_groups
        self.groups = groups

    @property
    def weight(self):
        return self._conv.weight

    @property
    def bias(self):
        return getattr(self._conv, "bias", None)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(x, offset, self.weight, self.bias, self.stride,
                             self.padding, self.dilation,
                             self.deformable_groups, self.groups, mask)


def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio, clip_bbox=True, scale_x_y=1.0, iou_aware=False,
             iou_aware_factor=0.5, name=None):
    """YOLOv3's head decoded into (boxes (N, an * H * W, 4) x1 y1 x2 y2,
    scores (N, an * H * W, class_num)); boxes and scores under
    `conf_thresh` are zeros. x: (N, an * (5 + class_num), H, W), img_size
    (N, 2) as (h, w)."""
    xd = _t(x)
    imgs = _t(img_size, xd)
    an = len(anchors) // 2
    N, _, H, W = xd.shape
    if iou_aware:
        ioup = torch.sigmoid(xd[:, :an])
        xd = xd[:, an:]
    feat = xd.reshape(N, an, 5 + class_num, H, W)
    tx, ty, tw, th, tobj = (feat[:, :, i] for i in range(5))
    grid_x = torch.arange(W, device=xd.device)[None, None, None, :]
    grid_y = torch.arange(H, device=xd.device)[None, None, :, None]
    bx = (torch.sigmoid(tx) * scale_x_y - (scale_x_y - 1) / 2 + grid_x) / W
    by = (torch.sigmoid(ty) * scale_x_y - (scale_x_y - 1) / 2 + grid_y) / H
    aw = torch.tensor(anchors[0::2], dtype=xd.dtype,
                      device=xd.device).reshape(1, an, 1, 1)
    ah = torch.tensor(anchors[1::2], dtype=xd.dtype,
                      device=xd.device).reshape(1, an, 1, 1)
    bw = torch.exp(tw) * aw / (downsample_ratio * W)
    bh = torch.exp(th) * ah / (downsample_ratio * H)
    conf = torch.sigmoid(tobj)
    if iou_aware:
        conf = conf ** (1 - iou_aware_factor) * ioup ** iou_aware_factor
    probs = torch.sigmoid(feat[:, :, 5:]) * conf[:, :, None]
    keep = (conf > conf_thresh).to(xd.dtype)          # (N, an, H, W)
    img_h = imgs[:, 0].reshape(N, 1, 1, 1).to(xd.dtype)
    img_w = imgs[:, 1].reshape(N, 1, 1, 1).to(xd.dtype)
    x1 = (bx - bw / 2) * img_w
    y1 = (by - bh / 2) * img_h
    x2 = (bx + bw / 2) * img_w
    y2 = (by + bh / 2) * img_h
    if clip_bbox:
        x1 = torch.clamp(x1, min=0)
        y1 = torch.clamp(y1, min=0)
        x2 = torch.minimum(x2, img_w - 1)
        y2 = torch.minimum(y2, img_h - 1)
    boxes = torch.stack([x1, y1, x2, y2], dim=-1) * keep[..., None]
    probs = probs * keep[:, :, None]
    scores = probs.permute(0, 1, 3, 4, 2).reshape(N, an * H * W, class_num)
    return _wrap(boxes.reshape(N, an * H * W, 4)), _wrap(scores)


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5, min_max_aspect_ratios_order=False,
              name=None):
    """SSD prior boxes for one feature map: (boxes (H, W, P, 4), variances
    (H, W, P, 4)), normalized to [0, 1]."""
    feat = _t(input)
    img = _t(image)
    H, W = feat.shape[2], feat.shape[3]
    ih, iw = float(img.shape[2]), float(img.shape[3])
    step_h = steps[1] if steps[1] > 0 else ih / H
    step_w = steps[0] if steps[0] > 0 else iw / W
    ars = [1.0]
    for ar in aspect_ratios:
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    whs = []    # (w, h) a prior, in pixels
    for ms in min_sizes:
        mx = max_sizes[min_sizes.index(ms)] if max_sizes else None
        square = [((ms * mx) ** 0.5, (ms * mx) ** 0.5)] if mx else []
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            whs += square
            whs += [(ms * ar ** 0.5, ms / ar ** 0.5) for ar in ars
                    if abs(ar - 1.0) >= 1e-6]
        else:
            whs += [(ms * ar ** 0.5, ms / ar ** 0.5) for ar in ars]
            whs += square
    P = len(whs)
    dev = feat.device
    wh = torch.tensor(whs, dtype=torch.float32, device=dev)
    cx = (torch.arange(W, device=dev) + offset) * step_w
    cy = (torch.arange(H, device=dev) + offset) * step_h
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")        # (H, W)
    c = torch.stack([cxg, cyg], -1)[:, :, None, :].float()  # (H, W, 1, 2)
    half = wh[None, None] / 2.0
    scale = torch.tensor([iw, ih], dtype=torch.float32, device=dev)
    boxes = torch.cat([(c - half) / scale, (c + half) / scale], dim=-1)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    var = torch.tensor(variance, dtype=torch.float32,
                       device=dev).expand(H, W, P, 4).contiguous()
    return _wrap(boxes), _wrap(var)


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, name=None):
    """Boxes encoded against or decoded from priors (the R-CNN box
    transform)."""
    pb = _t(prior_box).float()
    tb = _t(target_box, pb).float()
    pbv = None if prior_box_var is None else \
        _t(prior_box_var, pb).float().to(pb.device)
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw / 2
    pcy = pb[:, 1] + ph / 2
    if code_type == "encode_center_size":
        # tb: (M, 4) boxes; out (M, N, 4) against the N priors
        tw = (tb[:, 2] - tb[:, 0] + norm)[:, None]
        th = (tb[:, 3] - tb[:, 1] + norm)[:, None]
        tcx = (tb[:, 0] + (tb[:, 2] - tb[:, 0] + norm) / 2)[:, None]
        tcy = (tb[:, 1] + (tb[:, 3] - tb[:, 1] + norm) / 2)[:, None]
        dx = (tcx - pcx[None]) / pw[None]
        dy = (tcy - pcy[None]) / ph[None]
        dw = torch.log(torch.abs(tw / pw[None]))
        dh = torch.log(torch.abs(th / ph[None]))
        out = torch.stack([dx, dy, dw, dh], dim=-1)
        if pbv is not None:
            out = out / (pbv if pbv.dim() == 1 else pbv[None])
        return _wrap(out)
    if code_type == "decode_center_size":
        # tb: (N, M, 4) deltas; `axis` picks the dim the priors run along
        if pbv is not None:
            v = pbv if pbv.dim() == 1 else (pbv[:, None, :] if axis == 0
                                             else pbv[None])
            tb = tb * v
        shape = (-1, 1) if axis == 0 else (1, -1)
        pw_, ph_ = pw.reshape(shape), ph.reshape(shape)
        pcx_, pcy_ = pcx.reshape(shape), pcy.reshape(shape)
        ocx = tb[..., 0] * pw_ + pcx_
        ocy = tb[..., 1] * ph_ + pcy_
        ow = torch.exp(tb[..., 2]) * pw_
        oh = torch.exp(tb[..., 3]) * ph_
        return _wrap(torch.stack([ocx - ow / 2, ocy - oh / 2,
                                  ocx + ow / 2 - norm, ocy + oh / 2 - norm],
                                 dim=-1))
    raise ValueError(f"unknown code_type {code_type!r}")


def _top_k(x, k):
    """The k largest values and their indices, ties in index order (as
    jax.lax.top_k)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def matrix_nms(bboxes, scores, score_threshold, post_threshold, nms_top_k,
               keep_top_k, use_gaussian=False, gaussian_sigma=2.0,
               background_label=0, normalized=True, return_index=False,
               return_rois_num=True, name=None):
    """Matrix NMS (SOLOv2): each candidate's score decayed by its IoU with
    the higher-scored boxes of its class, all at once. (N, M, 4) boxes,
    (N, C, M) scores; rows [class, score, x1, y1, x2, y2] of the kept
    boxes, image by image (the count is data dependent: the last
    selection runs on the host)."""
    b = _t(bboxes)
    s = _t(scores, b).to(b.device)
    N, C, M = s.shape
    dev = b.device
    outs, idxs, nums = [], [], []
    classes = [c for c in range(C) if c != background_label]
    for n in range(N):
        if not classes:     # every class was the background label
            outs.append(np.zeros((0, 6), np.float32))
            idxs.append(np.zeros((0,), np.int64))
            nums.append(0)
            continue
        sc = s[n, classes]                                  # (C', M)
        cls_ids = torch.tensor(classes, device=dev).repeat_interleave(M)
        cand_scores = torch.where(sc > score_threshold, sc,
                                  torch.zeros_like(sc)).reshape(-1)
        cand_idx = torch.arange(M, device=dev).repeat(len(classes))
        total = cand_scores.shape[0]
        k = min(nms_top_k if nms_top_k > 0 else total, total)
        top_s, top_i = _top_k(cand_scores, k)
        top_cls = cls_ids[top_i]
        top_box = b[n][cand_idx[top_i]]
        iou = _iou_matrix(top_box, top_box)
        same = (top_cls[:, None] == top_cls[None, :]).to(iou.dtype)
        # decay only by higher-scored boxes of the same class: rows i < j
        upper = torch.triu(torch.ones_like(iou), diagonal=1) * same
        ious = iou * upper
        comp = ious.max(dim=0).values   # how far suppressor i was decayed
        one = torch.ones_like(ious)
        if use_gaussian:
            decay = torch.where(
                upper > 0,
                torch.exp((comp[:, None] ** 2 - ious ** 2) * gaussian_sigma),
                one).min(dim=0).values
        else:
            # a suppressor that duplicates a higher box (comp == 1) decays
            # nothing, unless the candidate duplicates it too
            denom = 1.0 - comp[:, None]
            linear = torch.where(
                denom > 1e-10, (1 - ious) / torch.clamp(denom, min=1e-10),
                torch.where(ious >= 1.0 - 1e-10, torch.zeros_like(ious),
                            one))
            decay = torch.where(upper > 0, linear, one).min(dim=0).values
        dec_s = top_s * decay
        keep = dec_s >= post_threshold
        kk = min(keep_top_k if keep_top_k > 0 else k, k)
        fin_s, fin_i = _top_k(torch.where(keep, dec_s,
                                          torch.full_like(dec_s, -1.0)), kk)
        valid = (fin_s > 0).cpu().numpy()
        rows = torch.cat([top_cls[fin_i, None].to(b.dtype),
                          fin_s[:, None].to(b.dtype), top_box[fin_i]],
                         dim=1).cpu().numpy()[valid]
        outs.append(rows)
        idxs.append(cand_idx[top_i][fin_i].cpu().numpy()[valid])
        nums.append(int(valid.sum()))
    out = _wrap(torch.as_tensor(np.concatenate(outs, axis=0)).to(dev))
    res = [out]
    if return_index:
        res.append(_wrap(torch.as_tensor(np.concatenate(idxs)).to(dev)))
    if return_rois_num:
        res.append(_wrap(torch.as_tensor(np.asarray(nums, np.int32)).to(
            dev)))
    return tuple(res) if len(res) > 1 else out


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, pixel_offset=False,
                             rois_num=None, name=None):
    """Each RoI assigned to its FPN level, floor(refer_level + log2(
    sqrt(area) / refer_scale)) clipped to [min_level, max_level]: (the
    RoIs of each level, each level's count or None, the index that
    restores the input order from the levels' concatenation). Sizes are
    data dependent: computed on the host."""
    t = _t(fpn_rois)
    rois = t.detach().cpu().numpy()
    off = 1.0 if pixel_offset else 0.0
    w = rois[:, 2] - rois[:, 0] + off
    h = rois[:, 3] - rois[:, 1] + off
    scale = np.sqrt(np.maximum(w * h, 1e-12))
    lvl = np.floor(refer_level + np.log2(scale / refer_scale + 1e-9))
    lvl = np.clip(lvl, min_level, max_level).astype(np.int64)
    multi_rois, level_ids = [], []
    for level in range(min_level, max_level + 1):
        keep = np.nonzero(lvl == level)[0]
        multi_rois.append(_wrap(torch.as_tensor(rois[keep]).to(t.device)))
        level_ids.append(keep)
    order = np.concatenate(level_ids)
    restore = np.empty_like(order)
    restore[order] = np.arange(len(order))
    nums = None
    if rois_num is not None:
        nums = [_wrap(torch.tensor([len(i)], dtype=torch.int32,
                                   device=t.device)) for i in level_ids]
    return multi_rois, nums, _wrap(torch.as_tensor(restore).to(t.device))


def generate_proposals(scores, bbox_deltas, img_size, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0,
                       pixel_offset=False, return_rois_num=False,
                       name=None):
    """RPN proposals: anchor deltas decoded, clipped to the image, boxes
    under `min_size` dropped, the `pre_nms_top_n` best by score kept, NMS,
    then `post_nms_top_n` kept. Single-image (C, H, W) and batched (N, C,
    H, W) scores. Sizes are data dependent: decoded on the host, the NMS
    on the input's device."""
    st = _t(scores)
    dev = st.device

    def host(v):
        return _t(v).detach().cpu().numpy()

    sc, dl = host(st), host(bbox_deltas)
    an = host(anchors).reshape(-1, 4)
    va = host(variances).reshape(-1, 4)
    im = host(img_size)
    if sc.ndim != 4:
        sc, dl, im = sc[None], dl[None], im[None]
    all_rois, all_scores, all_nums = [], [], []
    off = 1.0 if pixel_offset else 0.0
    for b in range(sc.shape[0]):
        s = sc[b].transpose(1, 2, 0).reshape(-1)
        d = dl[b].transpose(1, 2, 0).reshape(-1, 4)
        aw = an[:, 2] - an[:, 0] + off
        ah = an[:, 3] - an[:, 1] + off
        acx = an[:, 0] + aw * 0.5
        acy = an[:, 1] + ah * 0.5
        cx = va[:, 0] * d[:, 0] * aw + acx
        cy = va[:, 1] * d[:, 1] * ah + acy
        bw = np.exp(np.minimum(va[:, 2] * d[:, 2], 10.0)) * aw
        bh = np.exp(np.minimum(va[:, 3] * d[:, 3], 10.0)) * ah
        boxes = np.stack([cx - bw * 0.5, cy - bh * 0.5,
                          cx + bw * 0.5 - off, cy + bh * 0.5 - off], -1)
        hmax, wmax = im[b][0], im[b][1]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, wmax - off)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, hmax - off)
        keep = ((boxes[:, 2] - boxes[:, 0] >= min_size)
                & (boxes[:, 3] - boxes[:, 1] >= min_size))
        boxes, s = boxes[keep], s[keep]
        order = np.argsort(-s, kind="stable")[:pre_nms_top_n]
        boxes, s = boxes[order], s[order]
        kept = nms(torch.as_tensor(boxes).to(dev), nms_thresh,
                   torch.as_tensor(s).to(dev))._t.cpu().numpy()
        kept = kept[:post_nms_top_n]
        all_rois.append(boxes[kept])
        all_scores.append(s[kept])
        all_nums.append(len(kept))
    rois = _wrap(torch.as_tensor(np.concatenate(all_rois)).to(dev))
    rscores = _wrap(torch.as_tensor(np.concatenate(all_scores)).to(dev))
    if return_rois_num:
        return rois, rscores, _wrap(torch.as_tensor(
            np.asarray(all_nums, np.int32)).to(dev))
    return rois, rscores


def _bce(logit, target):
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3's loss for one head, a value per image [N]: BCE on the
    sigmoid xy offsets and L1 on the wh logs (both weighted by 2 - w * h
    and the gt score), objectness BCE where predictions overlapping a gt
    above `ignore_thresh` are not counted as background, and class BCE.
    gt boxes are (cx, cy, w, h) normalized to [0, 1]."""
    xd = _t(x).float()
    dev = xd.device
    gb = _t(gt_box, xd).float()
    gl = _t(gt_label, xd).long()
    n, _, h, w = xd.shape
    a = len(anchor_mask)
    an_all = torch.tensor(anchors, dtype=torch.float32,
                          device=dev).reshape(-1, 2)
    an_mask = an_all[torch.tensor(list(anchor_mask), device=dev)]
    in_h, in_w = h * downsample_ratio, w * downsample_ratio

    pred = xd.reshape(n, a, 5 + class_num, h, w)
    tx, ty = pred[:, :, 0], pred[:, :, 1]
    tw, th = pred[:, :, 2], pred[:, :, 3]
    tobj = pred[:, :, 4]
    tcls = pred[:, :, 5:]
    grid_x = torch.arange(w, device=dev)[None, None, None, :]
    grid_y = torch.arange(h, device=dev)[None, None, :, None]
    with torch.no_grad():       # the ignore mask carries no gradient
        px = (torch.sigmoid(tx) + grid_x) / w
        py = (torch.sigmoid(ty) + grid_y) / h
        pw = torch.exp(tw) * an_mask[None, :, 0, None, None] / in_w
        ph = torch.exp(th) * an_mask[None, :, 1, None, None] / in_h

    bsz = gb.shape[1]
    valid = (gb[..., 2] > 0) & (gb[..., 3] > 0)          # [N, B]
    # each gt's best anchor by shape IoU against every anchor
    gw = gb[..., 2] * in_w
    gh = gb[..., 3] * in_h
    inter = (torch.minimum(gw[..., None], an_all[None, None, :, 0])
             * torch.minimum(gh[..., None], an_all[None, None, :, 1]))
    union = (gw[..., None] * gh[..., None]
             + an_all[None, None, :, 0] * an_all[None, None, :, 1] - inter)
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=-1)

    gi = torch.clamp((gb[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gb[..., 1] * h).to(torch.int32), 0, h - 1).long()
    amap = torch.tensor([list(anchor_mask).index(i) if i in anchor_mask
                         else -1 for i in range(an_all.shape[0])],
                        device=dev)
    la = amap[best]                                      # local anchor or -1
    on = valid & (la >= 0)
    sc = (_t(gt_score, xd).float() if gt_score is not None
          else torch.ones(n, bsz, device=dev))
    bidx = torch.arange(n, device=dev)[:, None].expand(n, bsz)
    # the targets, written where a gt sits (cells of no gt stay zero)
    cell = (bidx[on], la[on], gj[on], gi[on])
    zeros = torch.zeros(n, a, h, w, device=dev)
    mask_pos, t_x, t_y, t_w, t_h, box_scale = (zeros.clone()
                                               for _ in range(6))
    mask_pos[cell] = 1.0
    t_x[cell] = (gb[..., 0] * w - gi)[on]
    t_y[cell] = (gb[..., 1] * h - gj)[on]
    t_w[cell] = torch.log(torch.clamp(gw, min=1e-9) / an_all[best][..., 0])[on]
    t_h[cell] = torch.log(torch.clamp(gh, min=1e-9) / an_all[best][..., 1])[on]
    box_scale[cell] = ((2.0 - gb[..., 2] * gb[..., 3]) * sc)[on]
    onehot = torch.nn.functional.one_hot(
        torch.clamp(gl, 0, class_num - 1), class_num).float()
    if use_label_smooth:
        delta = 1.0 / max(class_num, 1)
        onehot = onehot * (1.0 - delta) + delta * 1.0 / class_num
    t_cls = torch.zeros(n, a, h, w, class_num, device=dev)
    t_cls[cell] = onehot[on]

    # the ignore mask: predictions above ignore_thresh IoU with any gt
    with torch.no_grad():
        px1, py1 = px - pw / 2, py - ph / 2
        px2, py2 = px + pw / 2, py + ph / 2
        g4 = gb[:, None, None, None]                     # (N, 1, 1, 1, B, 4)
        gx1 = g4[..., 0] - g4[..., 2] / 2
        gy1 = g4[..., 1] - g4[..., 3] / 2
        gx2 = g4[..., 0] + g4[..., 2] / 2
        gy2 = g4[..., 1] + g4[..., 3] / 2
        iw = torch.clamp(torch.minimum(px2[..., None], gx2)
                         - torch.maximum(px1[..., None], gx1), min=0)
        ih = torch.clamp(torch.minimum(py2[..., None], gy2)
                         - torch.maximum(py1[..., None], gy1), min=0)
        inter2 = iw * ih
        uni2 = (pw * ph)[..., None] + g4[..., 2] * g4[..., 3] - inter2
        iou = inter2 / torch.clamp(uni2, min=1e-9)
        iou = torch.where(valid[:, None, None, None], iou,
                          torch.zeros_like(iou))
        counted = ~((iou.amax(dim=-1) > ignore_thresh) & (mask_pos < 0.5))

    loss_xy = (_bce(tx, t_x) + _bce(ty, t_y)) * mask_pos * box_scale
    loss_wh = (torch.abs(tw - t_w) + torch.abs(th - t_h)) * mask_pos \
        * box_scale
    loss_obj = _bce(tobj, mask_pos) * counted.float()
    loss_cls = _bce(tcls.permute(0, 1, 3, 4, 2), t_cls) * mask_pos[..., None]
    per_img = (loss_xy.sum((1, 2, 3)) + loss_wh.sum((1, 2, 3))
               + loss_obj.sum((1, 2, 3)) + loss_cls.sum((1, 2, 3, 4)))
    return _wrap(per_img)
