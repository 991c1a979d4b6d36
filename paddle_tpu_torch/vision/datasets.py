"""Image datasets of the port (counterpart of
`paddle_tpu/vision/datasets.py`), datasets of the port's `io`.

Nothing is downloaded: `MNIST` and `FashionMNIST` read gz IDX files when
given them, and otherwise, as `Cifar10`, `Cifar100` and `FakeImageNet`
always do, make seeded synthetic data of the real shapes and dtypes (the
same arrays as the reference's, from the same `np.random.RandomState`
draws).  `DatasetFolder` reads `root/<class>/<file>.npy`."""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ..io import Dataset


class MNIST(Dataset):
    """28x28 uint8 images and int64 labels; an item is a float32 [1, 28,
    28] image in [0, 1] (through `transform`, if any) and a [1] label."""

    def __init__(self, image_path=None, label_path=None, mode="train", transform=None,
                 download=True, backend=None):
        self.mode = mode
        self.transform = transform
        self.images, self.labels = self._load(image_path, label_path)

    def _load(self, image_path, label_path):
        if image_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                _, n, rows, cols = struct.unpack(">IIII", f.read(16))
                images = np.frombuffer(f.read(), np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                labels = np.frombuffer(f.read(), np.uint8).astype(np.int64)
            return images, labels
        # class templates plus noise, so a model can learn them
        n = 60000 if self.mode == "train" else 10000
        rng = np.random.RandomState(0 if self.mode == "train" else 1)
        labels = rng.randint(0, 10, n).astype(np.int64)
        templates = rng.rand(10, 28, 28).astype(np.float32)
        images = (templates[labels] * 200 + rng.rand(n, 28, 28) * 55).astype(np.uint8)
        return images, labels

    def __getitem__(self, idx):
        img = self.images[idx].astype(np.float32)[None, :, :] / 255.0
        label = np.asarray([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        return img, label

    def __len__(self):
        return len(self.labels)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    """Synthetic 32x32x3 uint8 images; an item is a float32 CHW image in
    [0, 1] (or `transform` of the HWC uint8 image) and a [1] label."""

    def __init__(self, data_file=None, mode="train", transform=None, download=True,
                 backend=None):
        self.mode = mode
        self.transform = transform
        n = 50000 if mode == "train" else 10000
        rng = np.random.RandomState(2 if mode == "train" else 3)
        self.labels = rng.randint(0, self.num_classes(), n).astype(np.int64)
        templates = rng.rand(self.num_classes(), 32, 32, 3).astype(np.float32)
        self.images = (templates[self.labels] * 200
                       + rng.rand(n, 32, 32, 3) * 55).astype(np.uint8)

    def num_classes(self):
        return 10

    def __getitem__(self, idx):
        img = self.images[idx]
        label = np.asarray([self.labels[idx]], np.int64)
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, label

    def __len__(self):
        return len(self.labels)


class Cifar100(Cifar10):
    def num_classes(self):
        return 100


class FakeImageNet(Dataset):
    """ImageNet-shaped synthetic data (3 x image_size x image_size float32
    in [0, 1], `num_classes` classes): image i from RandomState(i)."""

    def __init__(self, n=1281, transform=None, image_size=224, num_classes=1000, seed=0):
        self.n = n
        self.transform = transform
        self.image_size = image_size
        self.num_classes = num_classes
        self.rng = np.random.RandomState(seed)
        self.labels = self.rng.randint(0, num_classes, n).astype(np.int64)

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx)
        img = rng.rand(3, self.image_size, self.image_size).astype(np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray([self.labels[idx]], np.int64)

    def __len__(self):
        return self.n


class DatasetFolder(Dataset):
    """Samples `root/<class>/<file>` with the classes' sorted order as
    labels; `loader` reads a path (default: `.npy` files)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.samples = []
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                self.samples.append((os.path.join(cdir, fn), self.class_to_idx[c]))
        self.loader = loader or self._default_loader

    @staticmethod
    def _default_loader(path):
        if path.endswith(".npy"):
            return np.load(path)
        raise RuntimeError("No image decoding library is bundled; store samples as "
                           ".npy or pass a custom loader.")

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


ImageFolder = DatasetFolder

__all__ = ["Cifar10", "Cifar100", "DatasetFolder", "FakeImageNet", "FashionMNIST",
           "ImageFolder", "MNIST"]
