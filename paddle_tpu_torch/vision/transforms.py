"""Image transforms of the port (counterpart of
`paddle_tpu/vision/transforms.py`): numpy on the host, HWC or CHW, the
random ones drawing from Python's `random` as the reference's do, so one
`random.seed` gives both packages the same crops and flips.  `ToTensor`
returns a float32 CPU `torch.Tensor`."""

from __future__ import annotations

import numbers
import random

import numpy as np
import torch


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, data):
        return self._apply_image(data)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    """HWC (or HW) array to a float32 tensor, CHW by default; uint8 scaled
    by 1 / 255."""

    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32))


class Normalize(BaseTransform):
    """(img - mean) / std per channel, in float32; a tensor in, a tensor
    out."""

    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False, keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        is_tensor = isinstance(img, torch.Tensor)
        arr = img.numpy() if is_tensor else np.asarray(img, np.float32)
        if self.data_format == "CHW":
            m = self.mean[: arr.shape[0]].reshape(-1, 1, 1)
            s = self.std[: arr.shape[0]].reshape(-1, 1, 1)
        else:
            m = self.mean[: arr.shape[-1]]
            s = self.std[: arr.shape[-1]]
        out = ((arr - m) / s).astype(np.float32)
        return torch.from_numpy(out) if is_tensor else out


def _linear_weights(n_in, n_out):
    """[n_in, n_out] float32 weights of a linear resize with an antialiasing
    triangle when shrinking (the reference's `jax.image.resize(...,
    "linear")`: half-pixel centres, the kernel widened by in / out, each
    column normalised)."""
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / max(inv, f32(1.0))
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class Resize(BaseTransform):
    """Linear resize to `size` (an int: square), HWC or HW (or CHW when
    the last dim is not a channel count of at most 4); float32 out."""

    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img, np.float32)
        hwc = arr.ndim == 3 and arr.shape[-1] <= 4
        if arr.ndim == 2:
            arr = arr[:, :, None]
            hwc = True
        if not hwc:
            arr = arr.transpose(1, 2, 0)
        out = arr
        for axis, n in enumerate(self.size):
            if out.shape[axis] != n:
                w = _linear_weights(out.shape[axis], n)
                out = np.moveaxis(np.tensordot(out, w, axes=([axis], [0])), -1, axis)
        out = out.astype(np.float32)
        return out.transpose(2, 0, 1) if not hwc else out


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i: i + th, j: j + tw]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding
            arr = np.pad(arr, [(p, p), (p, p)] + [(0, 0)] * (arr.ndim - 2))
        h, w = arr.shape[:2]
        th, tw = self.size
        i = random.randint(0, max(h - th, 0))
        j = random.randint(0, max(w - tw, 0))
        return arr[i: i + th, j: j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class RandomResizedCrop(BaseTransform):
    """A crop of a random area fraction in `scale` and aspect ratio in
    `ratio` (ten tries, then the centre square), resized to `size`."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4, 4.0 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = area * random.uniform(*self.scale)
            ar = random.uniform(*self.ratio)
            tw = int(round((target_area * ar) ** 0.5))
            th = int(round((target_area / ar) ** 0.5))
            if 0 < tw <= w and 0 < th <= h:
                i = random.randint(0, h - th)
                j = random.randint(0, w - tw)
                return Resize(self.size)._apply_image(arr[i: i + th, j: j + tw])
        return Resize(self.size)._apply_image(CenterCrop(min(h, w))._apply_image(arr))


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return arr.transpose(self.order)


def to_tensor(pic, data_format="CHW"):
    return ToTensor(data_format)(pic)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


__all__ = ["BaseTransform", "CenterCrop", "Compose", "Normalize", "RandomCrop",
           "RandomHorizontalFlip", "RandomResizedCrop", "RandomVerticalFlip", "Resize",
           "ToTensor", "Transpose", "hflip", "normalize", "resize", "to_tensor", "vflip"]
