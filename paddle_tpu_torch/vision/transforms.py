"""paddle.vision.transforms for the port (counterpart of
paddle_tpu/vision/transforms.py, host numpy code carried over): images
are HWC uint8 / float numpy arrays (the 'cv2' backend's shape);
`ToTensor` makes a CHW float32 Paddle Tensor scaled to [0, 1] on the
CPU, and the DataLoader moves the collated batch to the device, as a
PyTorch input pipeline does.
"""
from __future__ import annotations

import numbers
import random
from typing import Sequence

import numpy as np

from ..core.tensor import Tensor

__all__ = [
    "Compose", "BaseTransform", "ToTensor", "Normalize", "Resize",
    "CenterCrop", "RandomCrop", "RandomHorizontalFlip", "RandomVerticalFlip",
    "RandomResizedCrop", "Pad", "Transpose", "Grayscale",
    "BrightnessTransform", "ContrastTransform", "SaturationTransform",
    "HueTransform", "ColorJitter", "RandomRotation", "RandomErasing",
    "normalize", "to_tensor", "resize", "hflip", "vflip", "crop",
    "center_crop", "pad", "to_grayscale", "adjust_brightness",
    "adjust_contrast", "adjust_hue", "rotate", "erase",
    "affine", "perspective", "RandomAffine", "RandomPerspective",
]


def _as_hwc(img):
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def _pair(x):
    if isinstance(x, numbers.Number):
        return int(x), int(x)
    return int(x[0]), int(x[1])


# ------------------------------------------------------------------ functional
def to_tensor(pic, data_format="CHW"):
    img = _as_hwc(pic)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    else:
        img = img.astype(np.float32)
    if data_format == "CHW":
        img = np.transpose(img, (2, 0, 1))
    return Tensor(img, place="cpu")


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    is_tensor = isinstance(img, Tensor)
    arr = img.numpy() if is_tensor else np.asarray(img, dtype=np.float32)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    if data_format == "CHW":
        arr = (arr - mean.reshape(-1, 1, 1)) / std.reshape(-1, 1, 1)
    else:
        arr = (arr - mean.reshape(1, 1, -1)) / std.reshape(1, 1, -1)
    return Tensor(arr, place=img.place) if is_tensor else arr


def resize(img, size, interpolation="bilinear"):
    """Resize HWC image with numpy (bilinear or nearest)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    if isinstance(size, int):
        # shorter side -> size, keep aspect
        if h < w:
            oh, ow = size, max(1, int(round(w * size / h)))
        else:
            oh, ow = max(1, int(round(h * size / w))), size
    else:
        oh, ow = _pair(size)
    if (oh, ow) == (h, w):
        return img
    dtype = img.dtype
    imgf = img.astype(np.float32)
    if interpolation == "nearest":
        ys = np.clip((np.arange(oh) * h / oh).astype(np.int64), 0, h - 1)
        xs = np.clip((np.arange(ow) * w / ow).astype(np.int64), 0, w - 1)
        out = imgf[ys[:, None], xs[None, :]]
    else:  # bilinear, align_corners=False convention
        ys = (np.arange(oh) + 0.5) * h / oh - 0.5
        xs = (np.arange(ow) + 0.5) * w / ow - 0.5
        y0 = np.clip(np.floor(ys).astype(np.int64), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int64), 0, w - 1)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0.0, 1.0)[:, None, None]
        wx = np.clip(xs - x0, 0.0, 1.0)[None, :, None]
        out = (
            imgf[y0[:, None], x0[None, :]] * (1 - wy) * (1 - wx)
            + imgf[y1[:, None], x0[None, :]] * wy * (1 - wx)
            + imgf[y0[:, None], x1[None, :]] * (1 - wy) * wx
            + imgf[y1[:, None], x1[None, :]] * wy * wx
        )
    if dtype == np.uint8:
        out = np.clip(np.round(out), 0, 255).astype(np.uint8)
    else:
        out = out.astype(dtype)
    return out


def hflip(img):
    return _as_hwc(img)[:, ::-1].copy()


def vflip(img):
    return _as_hwc(img)[::-1].copy()


def crop(img, top, left, height, width):
    img = _as_hwc(img)
    return img[top : top + height, left : left + width].copy()


def center_crop(img, output_size):
    img = _as_hwc(img)
    th, tw = _pair(output_size)
    h, w = img.shape[:2]
    top = max(0, (h - th) // 2)
    left = max(0, (w - tw) // 2)
    return crop(img, top, left, th, tw)


def pad(img, padding, fill=0, padding_mode="constant"):
    img = _as_hwc(img)
    if isinstance(padding, numbers.Number):
        pl = pr = pt = pb = int(padding)
    elif len(padding) == 2:
        pl = pr = int(padding[0])
        pt = pb = int(padding[1])
    else:
        pl, pt, pr, pb = (int(p) for p in padding)
    mode = {"constant": "constant", "edge": "edge", "reflect": "reflect",
            "symmetric": "symmetric"}[padding_mode]
    kwargs = {"constant_values": fill} if mode == "constant" else {}
    return np.pad(img, ((pt, pb), (pl, pr), (0, 0)), mode=mode, **kwargs)


def to_grayscale(img, num_output_channels=1):
    img = _as_hwc(img).astype(np.float32)
    if img.shape[2] >= 3:
        gray = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    else:
        gray = img[..., 0]
    gray = gray[:, :, None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=2)
    return gray.astype(np.uint8) if _as_hwc(img).dtype == np.uint8 else gray


def adjust_brightness(img, factor):
    arr = _as_hwc(img)
    out = arr.astype(np.float32) * factor
    return _clip_like(out, arr)


def adjust_contrast(img, factor):
    arr = _as_hwc(img)
    mean = arr.astype(np.float32).mean()
    out = (arr.astype(np.float32) - mean) * factor + mean
    return _clip_like(out, arr)


def adjust_hue(img, factor):
    # approximate hue rotation via channel roll mix; exact HSV omitted
    arr = _as_hwc(img).astype(np.float32)
    if arr.shape[2] < 3 or factor == 0:
        return _clip_like(arr, _as_hwc(img))
    rolled = np.roll(arr[..., :3], 1, axis=2)
    out = arr.copy()
    out[..., :3] = arr[..., :3] * (1 - abs(factor)) + rolled * abs(factor)
    return _clip_like(out, _as_hwc(img))


def _inverse_map(img, xin, yin, fill):
    """Nearest-neighbour sample img at float input coords (h, w grids)."""
    h, w = img.shape[:2]
    xi = np.round(xin).astype(np.int64)
    yi = np.round(yin).astype(np.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(img, fill)
    out[valid] = img[yi[valid], xi[valid]]
    return out


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="nearest", fill=0, center=None):
    """Affine transform (paddle.vision.transforms.affine contract):
    rotation + translation + isotropic scale + shear, about the center."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else (
        center[1], center[0])
    if isinstance(shear, numbers.Number):
        shear = (float(shear), 0.0)
    rad = np.deg2rad(angle)
    sx, sy = np.deg2rad(shear[0]), np.deg2rad(shear[1])
    # forward matrix M = T(center) R S Shear T(-center) + translate;
    # build it then invert for output->input mapping
    # torchvision/paddle matrix convention: rot - sy (y-shear direction)
    a = scale * np.cos(rad - sy) / np.cos(sy)
    b = scale * (-np.cos(rad - sy) * np.tan(sx) / np.cos(sy)
                 - np.sin(rad))
    c = scale * np.sin(rad - sy) / np.cos(sy)
    d = scale * (-np.sin(rad - sy) * np.tan(sx) / np.cos(sy)
                 + np.cos(rad))
    M = np.array([[a, b], [c, d]])
    Minv = np.linalg.inv(M)
    tx, ty = translate
    ys, xs = np.mgrid[0:h, 0:w]
    dx = xs - cx - tx
    dy = ys - cy - ty
    xin = Minv[0, 0] * dx + Minv[0, 1] * dy + cx
    yin = Minv[1, 0] * dx + Minv[1, 1] * dy + cy
    return _inverse_map(img, xin, yin, fill)


def _homography(src, dst):
    """8-dof homography mapping src points -> dst points (4 pairs)."""
    A, bv = [], []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        bv.append(u)
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        bv.append(v)
    hcoef = np.linalg.solve(np.asarray(A, np.float64),
                            np.asarray(bv, np.float64))
    return np.append(hcoef, 1.0).reshape(3, 3)


def perspective(img, startpoints, endpoints, interpolation="nearest",
                fill=0):
    """4-point perspective warp: startpoints (in the input) map to
    endpoints (in the output)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    # inverse mapping: output coords -> input coords
    Hinv = _homography(endpoints, startpoints)
    ys, xs = np.mgrid[0:h, 0:w]
    denom = Hinv[2, 0] * xs + Hinv[2, 1] * ys + Hinv[2, 2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    xin = (Hinv[0, 0] * xs + Hinv[0, 1] * ys + Hinv[0, 2]) / denom
    yin = (Hinv[1, 0] * xs + Hinv[1, 1] * ys + Hinv[1, 2]) / denom
    return _inverse_map(img, xin, yin, fill)


def rotate(img, angle, interpolation="nearest", expand=False, center=None,
           fill=0):
    """Rotate by angle degrees (nearest-neighbour inverse mapping)."""
    img = _as_hwc(img)
    h, w = img.shape[:2]
    cy, cx = ((h - 1) / 2.0, (w - 1) / 2.0) if center is None else (
        center[1], center[0])
    rad = np.deg2rad(angle)
    cos, sin = np.cos(rad), np.sin(rad)
    ys, xs = np.mgrid[0:h, 0:w]
    # inverse rotation: output coord -> input coord
    xin = cos * (xs - cx) + sin * (ys - cy) + cx
    yin = -sin * (xs - cx) + cos * (ys - cy) + cy
    return _inverse_map(img, xin, yin, fill)


def erase(img, i, j, h, w, v, inplace=False):
    is_tensor = isinstance(img, Tensor)
    arr = img.numpy() if is_tensor else np.array(img, copy=not inplace)
    if arr.ndim == 3 and is_tensor:  # CHW
        arr[:, i : i + h, j : j + w] = v
    else:
        arr[i : i + h, j : j + w] = v
    return Tensor(arr, place=img.place) if is_tensor else arr


def _clip_like(out, ref):
    if ref.dtype == np.uint8:
        return np.clip(out, 0, 255).astype(np.uint8)
    return out.astype(ref.dtype)


# ------------------------------------------------------------------- classes
class BaseTransform:
    """Transform base: _apply_image hook, keys plumbing kept minimal."""

    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return to_tensor(img, self.data_format)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean, self.std = mean, std
        self.data_format = data_format

    def _apply_image(self, img):
        return normalize(img, self.mean, self.std, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return resize(img, self.size, self.interpolation)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = _pair(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        img = _as_hwc(img)
        if self.padding is not None:
            img = pad(img, self.padding, self.fill, self.padding_mode)
        th, tw = self.size
        h, w = img.shape[:2]
        if self.pad_if_needed and (h < th or w < tw):
            img = pad(img, (0, 0, max(0, tw - w), max(0, th - h)), self.fill,
                      self.padding_mode)
            h, w = img.shape[:2]
        top = random.randint(0, h - th) if h > th else 0
        left = random.randint(0, w - tw) if w > tw else 0
        return crop(img, top, left, th, tw)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return hflip(img) if random.random() < self.prob else _as_hwc(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        return vflip(img) if random.random() < self.prob else _as_hwc(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = _pair(size)
        self.scale = scale
        self.ratio = ratio
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = _as_hwc(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            aspect = np.exp(random.uniform(np.log(self.ratio[0]),
                                           np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if 0 < cw <= w and 0 < ch <= h:
                top = random.randint(0, h - ch)
                left = random.randint(0, w - cw)
                patch = crop(img, top, left, ch, cw)
                return resize(patch, self.size, self.interpolation)
        return resize(center_crop(img, (min(h, w), min(h, w))), self.size,
                      self.interpolation)


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        self.padding, self.fill, self.padding_mode = padding, fill, padding_mode

    def _apply_image(self, img):
        return pad(img, self.padding, self.fill, self.padding_mode)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        return np.transpose(_as_hwc(img), self.order)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.num_output_channels)


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_brightness(img, f)


class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return adjust_contrast(img, f)


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        arr = _as_hwc(img)
        gray = to_grayscale(arr, 3).astype(np.float32)
        f = random.uniform(max(0, 1 - self.value), 1 + self.value)
        return _clip_like(arr.astype(np.float32) * f + gray * (1 - f), arr)


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, random.uniform(-self.value, self.value))


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self.ts = [
            BrightnessTransform(brightness), ContrastTransform(contrast),
            SaturationTransform(saturation), HueTransform(hue),
        ]

    def _apply_image(self, img):
        order = list(range(4))
        random.shuffle(order)
        for i in order:
            img = self.ts[i](img)
        return img


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.kwargs = dict(interpolation=interpolation, expand=expand,
                           center=center, fill=fill)

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        return rotate(img, angle, **self.kwargs)


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.kwargs = dict(interpolation=interpolation, fill=fill,
                           center=center)

    def _apply_image(self, img):
        angle = random.uniform(*self.degrees)
        h, w = _as_hwc(img).shape[:2]
        tx = ty = 0
        if self.translate is not None:
            tx = random.uniform(-self.translate[0], self.translate[0]) * w
            ty = random.uniform(-self.translate[1], self.translate[1]) * h
        sc = random.uniform(*self.scale) if self.scale is not None else 1.0
        sh = (0.0, 0.0)
        if self.shear is not None:
            shear = self.shear
            if isinstance(shear, numbers.Number):
                shear = (-shear, shear)
            if len(shear) == 2:
                sh = (random.uniform(shear[0], shear[1]), 0.0)
            else:
                sh = (random.uniform(shear[0], shear[1]),
                      random.uniform(shear[2], shear[3]))
        return affine(img, angle=angle, translate=(tx, ty), scale=sc,
                      shear=sh, **self.kwargs)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.distortion_scale = distortion_scale
        self.kwargs = dict(interpolation=interpolation, fill=fill)

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        h, w = _as_hwc(img).shape[:2]
        d = self.distortion_scale
        half_h, half_w = int(d * h / 2), int(d * w / 2)
        def jitter(x, y, dx, dy):
            return (x + random.randint(0, max(dx, 1) - 1) * (1 if x == 0 else -1),
                    y + random.randint(0, max(dy, 1) - 1) * (1 if y == 0 else -1))
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [jitter(x, y, half_w, half_h) for x, y in start]
        return perspective(img, start, end, **self.kwargs)


class RandomErasing(BaseTransform):
    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        if random.random() >= self.prob:
            return img
        is_tensor = isinstance(img, Tensor)
        shape = img.shape
        h, w = (shape[1], shape[2]) if is_tensor else shape[:2]
        area = h * w
        for _ in range(10):
            target = area * random.uniform(*self.scale)
            aspect = np.exp(random.uniform(np.log(self.ratio[0]),
                                           np.log(self.ratio[1])))
            eh = int(round(np.sqrt(target * aspect)))
            ew = int(round(np.sqrt(target / aspect)))
            if eh < h and ew < w:
                i = random.randint(0, h - eh)
                j = random.randint(0, w - ew)
                return erase(img, i, j, eh, ew, self.value, self.inplace)
        return img
