"""paddle.vision.datasets for the port (counterpart of
paddle_tpu/vision/datasets.py, host numpy code carried over): MNIST,
FashionMNIST, Cifar10 / 100, Flowers, VOC2012, DatasetFolder and
ImageFolder.

Nothing is downloaded: each dataset reads the standard files (IDX, the
CIFAR pickles) when they are on disk, and otherwise makes the
reference's deterministic synthetic samples (class-separable images,
seeded per dataset and mode), so the same arrays come out of both
packages.
"""
from __future__ import annotations

import gzip
import zlib
import os
import pickle
import struct
import tarfile
import warnings

import numpy as np

from ..io import Dataset

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "Flowers",
           "DatasetFolder", "ImageFolder", "VOC2012"]

_HOME = os.path.expanduser(os.environ.get("PADDLE_TPU_HOME",
                                          "~/.cache/paddle_tpu"))


def _dseed(*parts):
    """Stable cross-process seed (hash() is salted per interpreter)."""
    return zlib.crc32("/".join(str(p) for p in parts).encode()) % (2 ** 31)


def _synth_images(n, h, w, c, num_classes, seed, proto_seed=None):
    """Deterministic class-separable synthetic images: each class gets a
    distinct mean pattern so accuracy metrics actually move during training.
    `proto_seed` keys the class prototypes — train/test splits of one dataset
    share it, so a model trained on the synthetic train split generalizes to
    the synthetic test split."""
    rng = np.random.RandomState(seed)
    protos = np.random.RandomState(
        seed if proto_seed is None else proto_seed).uniform(
        0, 255, size=(num_classes, h, w, c))
    labels = rng.randint(0, num_classes, size=n).astype(np.int64)
    noise = rng.uniform(-40, 40, size=(n, h, w, c))
    imgs = np.clip(protos[labels] + noise, 0, 255).astype(np.uint8)
    return imgs, labels


class _ArrayDataset(Dataset):
    """Images (N,H,W,C) uint8 + labels, with paddle's transform/backend knobs."""

    def __init__(self, images, labels, transform=None, backend="numpy"):
        self.images = images
        self.labels = labels
        self.transform = transform
        self.backend = backend

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(label, dtype=np.int64)


class MNIST(_ArrayDataset):
    """MNIST: parses IDX files under `image_path`/`label_path` or data_home;
    synthesizes 28x28x1 digits when absent (no network in this environment)."""

    NAME = "mnist"
    NUM_CLASSES = 10
    SHAPE = (28, 28, 1)

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend="numpy"):
        assert mode in ("train", "test")
        self.mode = mode
        images, labels = self._load(image_path, label_path, mode)
        super().__init__(images, labels, transform, backend)

    def _load(self, image_path, label_path, mode):
        tag = "train" if mode == "train" else "t10k"
        base = os.path.join(_HOME, "datasets", self.NAME)
        image_path = image_path or os.path.join(
            base, f"{tag}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(
            base, f"{tag}-labels-idx1-ubyte.gz")
        if os.path.exists(image_path) and os.path.exists(label_path):
            return (self._parse_idx(image_path, 3),
                    self._parse_idx(label_path, 1).astype(np.int64))
        warnings.warn(
            f"{type(self).__name__}: data files not found and no network "
            "access; using deterministic synthetic samples.")
        n = 8192 if mode == "train" else 1024
        h, w, c = self.SHAPE
        imgs, labels = _synth_images(
            n, h, w, c, self.NUM_CLASSES,
            seed=_dseed(self.NAME, mode), proto_seed=_dseed(self.NAME))
        return imgs if c > 1 else imgs[..., :1], labels

    @staticmethod
    def _parse_idx(path, ndim):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            magic = struct.unpack(">I", f.read(4))[0]
            dims = [struct.unpack(">I", f.read(4))[0]
                    for _ in range(magic & 0xFF)]
            data = np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)
        if ndim == 3 and data.ndim == 3:
            data = data[..., None]
        return data


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"


class Cifar10(_ArrayDataset):
    """CIFAR-10: parses the python-pickle tarball when present."""

    NAME = "cifar10"
    NUM_CLASSES = 10
    ARCHIVE = "cifar-10-python.tar.gz"
    PREFIX = "cifar-10-batches-py"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy"):
        assert mode in ("train", "test")
        self.mode = mode
        images, labels = self._load(data_file, mode)
        super().__init__(images, labels, transform, backend)

    def _member_names(self, mode):
        if mode == "train":
            return [f"{self.PREFIX}/data_batch_{i}" for i in range(1, 6)]
        return [f"{self.PREFIX}/test_batch"]

    def _label_key(self):
        return b"labels"

    def _load(self, data_file, mode):
        data_file = data_file or os.path.join(
            _HOME, "datasets", self.NAME, self.ARCHIVE)
        if os.path.exists(data_file):
            imgs, labels = [], []
            with tarfile.open(data_file) as tf:
                for name in self._member_names(mode):
                    d = pickle.load(tf.extractfile(name), encoding="bytes")
                    imgs.append(d[b"data"].reshape(-1, 3, 32, 32)
                                .transpose(0, 2, 3, 1))
                    labels.extend(d[self._label_key()])
            return (np.concatenate(imgs).astype(np.uint8),
                    np.asarray(labels, dtype=np.int64))
        warnings.warn(
            f"{type(self).__name__}: data file not found and no network "
            "access; using deterministic synthetic samples.")
        n = 8192 if mode == "train" else 1024
        return _synth_images(n, 32, 32, 3, self.NUM_CLASSES,
                             seed=_dseed(self.NAME, mode),
                             proto_seed=_dseed(self.NAME))


class Cifar100(Cifar10):
    NAME = "cifar100"
    NUM_CLASSES = 100
    ARCHIVE = "cifar-100-python.tar.gz"
    PREFIX = "cifar-100-python"

    def _member_names(self, mode):
        return [f"{self.PREFIX}/{'train' if mode == 'train' else 'test'}"]

    def _label_key(self):
        return b"fine_labels"


class Flowers(_ArrayDataset):
    """Flowers-102; synthetic fallback at 64x64 to keep memory bounded."""

    NAME = "flowers"
    NUM_CLASSES = 102

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend="numpy"):
        assert mode in ("train", "valid", "test")
        warnings.warn("Flowers: no network access; using deterministic "
                      "synthetic samples.")
        n = {"train": 1020, "valid": 1020, "test": 2048}[mode]
        imgs, labels = _synth_images(
            n, 64, 64, 3, self.NUM_CLASSES,
            seed=_dseed(self.NAME, mode), proto_seed=_dseed(self.NAME))
        super().__init__(imgs, labels, transform, backend)


def _default_loader(path):
    """Load an image file to an HWC uint8 array. Supports .npy natively; PNG/
    JPEG require pillow if available."""
    if path.endswith(".npy"):
        return np.load(path)
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"))
    except ImportError as e:
        raise RuntimeError(
            f"loading {path} requires pillow, which is unavailable; use .npy "
            "images or pass a custom loader") from e


IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".npy")


class DatasetFolder(Dataset):
    """class-per-subdirectory image tree (ref: python/paddle/vision/datasets/
    folder.py, upstream layout, unverified)."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(
            d for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for dirpath, _, files in sorted(os.walk(cdir)):
                for fname in sorted(files):
                    path = os.path.join(dirpath, fname)
                    ok = (is_valid_file(path) if is_valid_file
                          else fname.lower().endswith(extensions))
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        img = self.loader(path)
        if self.transform is not None:
            img = self.transform(img)
        return img, np.asarray(target, dtype=np.int64)


class ImageFolder(Dataset):
    """Flat/recursive folder of images, no labels."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.loader = loader or _default_loader
        self.transform = transform
        extensions = extensions or IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, files in sorted(os.walk(root)):
            for fname in sorted(files):
                path = os.path.join(dirpath, fname)
                ok = (is_valid_file(path) if is_valid_file
                      else fname.lower().endswith(extensions))
                if ok:
                    self.samples.append(path)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        img = self.loader(self.samples[idx])
        if self.transform is not None:
            img = self.transform(img)
        return [img]


class VOC2012(_ArrayDataset):
    """Segmentation dataset; synthetic fallback (image, mask) pairs."""

    NUM_CLASSES = 21

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="numpy"):
        warnings.warn("VOC2012: no network access; using deterministic "
                      "synthetic samples.")
        n = 512 if mode == "train" else 128
        rng = np.random.RandomState(_dseed("voc", mode))
        imgs = rng.randint(0, 256, size=(n, 64, 64, 3), dtype=np.uint8)
        masks = rng.randint(0, self.NUM_CLASSES, size=(n, 64, 64)).astype(np.int64)
        super().__init__(imgs, masks, transform)

    def __getitem__(self, idx):
        img = self.images[idx]
        mask = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, mask
