"""The port's vision transforms and datasets against the JAX package's.

Deterministic transforms give equal arrays (Resize within 2e-6: the same
float32 weights, contracted by numpy where the reference's einsum goes
through XLA); random ones give the same results after the same
`random.seed`, since both draw from Python's `random`.  The datasets'
synthetic fallbacks give the reference's arrays exactly, and a gz IDX file
reads the same in both.
"""

import gzip
import random
import struct

import numpy as np
import pytest
import torch

from paddle_tpu.vision import datasets as jdata
from paddle_tpu.vision import transforms as jT
from paddle_tpu_torch.io import DataLoader
from paddle_tpu_torch.vision import datasets as tdata
from paddle_tpu_torch.vision import transforms as tT


def _np(v):
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


def _image(shape, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("name,args,img", [
    ("ToTensor", (), _image((7, 5, 3), 1)),
    ("ToTensor", ("HWC",), _image((7, 5), 2)),
    ("Normalize", ([0.5, 0.4, 0.3], [0.2, 0.3, 0.4]), _image((3, 6, 4), 3, np.float32)),
    ("Normalize", (0.5, 0.25, "HWC"), _image((6, 4, 3), 4, np.float32)),
    ("CenterCrop", (4,), _image((9, 7, 3), 5)),
    ("CenterCrop", ((3, 5),), _image((6, 8), 6)),
    ("Transpose", (), _image((5, 4, 3), 7)),
    ("Transpose", ((1, 0, 2),), _image((5, 4), 8)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_deterministic_transforms_match_reference(name, args, img):
    got, want = getattr(tT, name)(*args)(img), getattr(jT, name)(*args)(img)
    assert _np(got).dtype == _np(want).dtype
    np.testing.assert_array_equal(_np(got), _np(want))


def test_normalize_keeps_a_tensor_a_tensor():
    t = tT.ToTensor()(_image((5, 4, 3), 9))
    out = tT.Normalize(0.5, 0.5)(t)
    assert isinstance(out, torch.Tensor)
    np.testing.assert_array_equal(out.numpy(), _np(jT.Normalize(0.5, 0.5)(
        jT.ToTensor()(_image((5, 4, 3), 9)))))


@pytest.mark.parametrize("size,shape", [(4, (9, 7, 3)), ((12, 10), (6, 5, 3)),
                                        ((5, 9), (8, 8)), (3, (3, 10, 12)),
                                        ((7, 7), (7, 7, 1))], ids=str)
def test_resize_matches_reference(size, shape):
    """Shrinking (antialiased), growing, HW, HWC and CHW."""
    img = _image(shape, 10, np.float32) * 255
    got, want = tT.Resize(size)(img), jT.Resize(size)(img)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6 * 255)
    np.testing.assert_array_equal(tT.hflip(img), jT.hflip(img))
    np.testing.assert_array_equal(tT.vflip(img), jT.vflip(img))


@pytest.mark.parametrize("name,args", [
    ("RandomCrop", (5,)), ("RandomCrop", ((4, 6), 2)),
    ("RandomHorizontalFlip", ()), ("RandomVerticalFlip", (0.7,)),
    ("RandomResizedCrop", (6,)), ("RandomResizedCrop", ((5, 4), (0.5, 1.0))),
], ids=lambda v: v if isinstance(v, str) else None)
def test_random_transforms_match_reference_under_a_shared_seed(name, args):
    img = _image((12, 10, 3), 11)
    got, want = [], []
    for seed in range(6):
        random.seed(seed)
        got.append(_np(getattr(tT, name)(*args)(img)))
        random.seed(seed)
        want.append(_np(getattr(jT, name)(*args)(img)))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   rtol=2e-6, atol=2e-6 * 255)
    assert any(not np.array_equal(got[0], g) for g in got[1:])


def test_compose_matches_reference():
    img = _image((16, 14, 3), 12)
    mk = lambda T: T.Compose([T.RandomCrop(12, padding=1), T.RandomHorizontalFlip(),
                              T.Resize(8), T.ToTensor("HWC"), T.Normalize(0.5, 0.5, "HWC")])
    random.seed(3)
    got = _np(mk(tT)(img))
    random.seed(3)
    np.testing.assert_allclose(got, _np(mk(jT)(img)), rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("mode", ["train", "test"])
def test_mnist_synthetic_matches_reference(mode):
    got, want = tdata.MNIST(mode=mode), jdata.MNIST(mode=mode)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got) == len(want) == (60000 if mode == "train" else 10000)
    for i in (0, 17, len(got) - 1):
        (gi, gl), (wi, wl) = got[i], want[i]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert isinstance(tdata.FashionMNIST(mode="test"), tdata.MNIST)


def test_mnist_reads_idx_gz_like_reference(tmp_path):
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.integers(0, 10, 5).astype(np.uint8)
    ipath, lpath = tmp_path / "images.gz", tmp_path / "labels.gz"
    with gzip.open(ipath, "wb") as f:
        f.write(struct.pack(">IIII", 2051, 5, 28, 28) + images.tobytes())
    with gzip.open(lpath, "wb") as f:
        f.write(struct.pack(">II", 2049, 5) + labels.tobytes())
    got = tdata.MNIST(str(ipath), str(lpath), transform=tT.Normalize(0.5, 0.5))
    want = jdata.MNIST(str(ipath), str(lpath), transform=jT.Normalize(0.5, 0.5))
    np.testing.assert_array_equal(got.images, images)
    np.testing.assert_array_equal(got.labels, labels.astype(np.int64))
    for i in range(5):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        np.testing.assert_array_equal(got[i][1], want[i][1])


def test_cifar_and_fake_imagenet_match_reference():
    for cls in ("Cifar10", "Cifar100"):
        got, want = getattr(tdata, cls)(mode="test"), getattr(jdata, cls)(mode="test")
        assert got.num_classes() == want.num_classes()
        np.testing.assert_array_equal(got.images, want.images)
        for i in (0, 9999):
            np.testing.assert_array_equal(got[i][0], want[i][0])
            np.testing.assert_array_equal(got[i][1], want[i][1])
    got = tdata.FakeImageNet(n=8, image_size=32, num_classes=10, seed=3)
    want = jdata.FakeImageNet(n=8, image_size=32, num_classes=10, seed=3)
    for i in range(8):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        np.testing.assert_array_equal(got[i][1], want[i][1])
    batch = next(iter(DataLoader(got, batch_size=4)))
    assert tuple(batch[0].shape) == (4, 3, 32, 32) and batch[0].dtype == torch.float32


def test_dataset_folder_matches_reference(tmp_path):
    rng = np.random.default_rng(14)
    for cls, n in (("cat", 2), ("ant", 3)):
        (tmp_path / cls).mkdir()
        for i in range(n):
            np.save(tmp_path / cls / f"{i}.npy", rng.random((4, 4, 3), dtype=np.float32))
    (tmp_path / "notes.txt").write_text("not a class")
    got, want = tdata.DatasetFolder(str(tmp_path)), jdata.DatasetFolder(str(tmp_path))
    assert got.class_to_idx == want.class_to_idx == {"ant": 0, "cat": 1}
    assert len(got) == len(want) == 5
    for i in range(5):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]
    assert tdata.ImageFolder is tdata.DatasetFolder
