"""Dataset fetchers/iterators: MNIST, EMNIST, CIFAR-10, LFW, SVHN, Iris.

Equivalent of deeplearning4j-core base/MnistFetcher.java, EmnistFetcher.java,
datasets/fetchers/MnistDataFetcher.java, datasets/iterator/impl/
{Mnist,Emnist,Cifar,LFW,Iris}DataSetIterator, base/LFWDataFetcher.java and
the datasets/mnist/ IDX readers.

The reference downloads archives at construction time; this environment is
zero-egress, so fetchers read from a local data directory
(``data_dir`` arg or ``$DL4J_TPU_DATA_DIR``, default ``~/.dl4jtpu/data``).
Binary decode and scaling run through ``datasets/host_io.py`` (numpy,
bit for bit the JAX package's C++ IO runtime). ``synthetic=True`` generates a
deterministic stand-in dataset with the real shapes for pipeline testing
without the files.
"""

from __future__ import annotations

import gzip
import os
import shutil
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import one_hot as _one_hot
from deeplearning4j_tpu_torch.datasets.host_io import (
    read_csv, read_idx, u8_to_f32)
from deeplearning4j_tpu_torch.datasets.iterators import ArrayDataSetIterator
from deeplearning4j_tpu_torch.resilience.retry import (
    RetryPolicy, retry_call)

DEFAULT_DATA_DIR = os.environ.get(
    "DL4J_TPU_DATA_DIR", os.path.expanduser("~/.dl4jtpu/data"))

#: dataset acquisition IO (decompress/read off a possibly-remote mount)
#: retries transient OS errors with bounded backoff — the zero-egress
#: stand-in for the reference fetchers' download retry
_IO_RETRY = RetryPolicy(max_attempts=3, base_delay=0.1, max_delay=1.0,
                        retry_on=(OSError,))

MNIST_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _decompress(gz: str, path: str) -> None:
    # decompress to a temp name then rename: an interrupted extraction
    # must not leave a truncated file at the final path
    tmp = path + f".tmp.{os.getpid()}"
    try:
        with gzip.open(gz, "rb") as fin, open(tmp, "wb") as fout:
            shutil.copyfileobj(fin, fout)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _resolve(data_dir: Optional[str], name: str) -> str:
    """Find ``name`` (or name.gz, decompressing next to it) under data_dir."""
    base = data_dir or DEFAULT_DATA_DIR
    path = os.path.join(base, name)
    if os.path.exists(path):
        return path
    gz = path + ".gz"
    if os.path.exists(gz):
        # transient IO (slow NFS mount, a concurrent extractor racing the
        # rename) retries with backoff; a genuinely bad archive still
        # raises after the bounded attempts
        retry_call(_decompress, gz, path, policy=_IO_RETRY,
                   op="dataset-decompress")
        return path
    raise FileNotFoundError(
        f"dataset file {name!r} not found under {base!r}. This build is "
        f"zero-egress: place the file there manually (or pass "
        f"synthetic=True for a deterministic stand-in).")


def _synthetic_images(n: int, shape: Tuple[int, ...], classes: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-dependent image-like data (NOT real data)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    imgs = rng.integers(0, 256, (n,) + shape, np.uint8)
    # plant a class-dependent mean shift so models can actually learn
    imgs = np.clip(imgs.astype(np.int32) +
                   (labels * (128 // classes))[:, None, None]
                   .reshape((n,) + (1,) * len(shape)), 0, 255)
    return imgs.astype(np.uint8), labels


class MnistDataSetIterator(ArrayDataSetIterator):
    """MNIST minibatches, features scaled to [0,1], labels one-hot
    (ref: MnistDataSetIterator + MnistDataFetcher semantics).

    Features are [N, 784] row vectors like the reference (use
    ``FeedForwardToCnnPreProcessor``/reshape for CNNs).
    """

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True,
                 data_dir: Optional[str] = None, shuffle: Optional[bool] = None,
                 seed: int = 123, synthetic: bool = False,
                 num_examples: Optional[int] = None, flatten: bool = True,
                 _files: Optional[Tuple[str, str]] = None,
                 _label_offset: int = 0):
        if synthetic:
            imgs, labels = _synthetic_images(
                num_examples or (6000 if train else 1000), (28, 28),
                self.NUM_CLASSES, seed)
        else:
            img_f, lbl_f = _files or MNIST_FILES[train]
            imgs = read_idx(_resolve(data_dir, img_f))
            labels = read_idx(_resolve(data_dir, lbl_f)) - _label_offset
            if num_examples:
                imgs, labels = imgs[:num_examples], labels[:num_examples]
        x = u8_to_f32(imgs)  # [0,1] scaling
        x = x.reshape(x.shape[0], -1) if flatten \
            else x.reshape(x.shape[0], 1, *imgs.shape[1:])
        y = _one_hot(labels, self.NUM_CLASSES)
        super().__init__(x, y, batch_size=batch_size,
                         shuffle=(train if shuffle is None else shuffle),
                         seed=seed)


class EmnistDataSetIterator(MnistDataSetIterator):
    """EMNIST (ref: EmnistDataSetIterator.java). Same IDX format; split
    selects the file set and class count."""

    SPLITS = {"balanced": 47, "byclass": 62, "bymerge": 47, "digits": 10,
              "letters": 26, "mnist": 10}

    def __init__(self, batch_size: int, split: str = "balanced",
                 train: bool = True, data_dir: Optional[str] = None,
                 shuffle: Optional[bool] = None, seed: int = 123,
                 synthetic: bool = False,
                 num_examples: Optional[int] = None, flatten: bool = True):
        if split not in self.SPLITS:
            raise ValueError(f"unknown EMNIST split {split!r}; "
                             f"one of {sorted(self.SPLITS)}")
        self.NUM_CLASSES = self.SPLITS[split]
        part = "train" if train else "test"
        files = (f"emnist-{split}-{part}-images-idx3-ubyte",
                 f"emnist-{split}-{part}-labels-idx1-ubyte")
        super().__init__(
            batch_size, train=train, data_dir=data_dir, shuffle=shuffle,
            seed=seed, synthetic=synthetic, num_examples=num_examples,
            flatten=flatten, _files=files,
            _label_offset=1 if split == "letters" else 0)  # letters: 1-based


class CifarDataSetIterator(ArrayDataSetIterator):
    """CIFAR-10 from the python/bin binary batches
    (ref: CifarDataSetIterator.java). Features [N,3,32,32] in [0,1]."""

    NUM_CLASSES = 10
    TRAIN_FILES = [f"data_batch_{i}.bin" for i in range(1, 6)]
    TEST_FILES = ["test_batch.bin"]

    def __init__(self, batch_size: int, train: bool = True,
                 data_dir: Optional[str] = None, seed: int = 123,
                 synthetic: bool = False,
                 num_examples: Optional[int] = None):
        if synthetic:
            imgs, labels = _synthetic_images(
                num_examples or 2000, (3, 32, 32), self.NUM_CLASSES, seed)
        else:
            parts = []
            for name in (self.TRAIN_FILES if train else self.TEST_FILES):
                raw = np.fromfile(_resolve(data_dir, name), np.uint8)
                parts.append(raw.reshape(-1, 3073))  # [label + 3072 pixels]
            recs = np.concatenate(parts)
            if num_examples:
                recs = recs[:num_examples]
            labels = recs[:, 0]
            imgs = recs[:, 1:].reshape(-1, 3, 32, 32)
        x = u8_to_f32(np.ascontiguousarray(imgs)).reshape(-1, 3, 32, 32)
        y = _one_hot(labels, self.NUM_CLASSES)
        super().__init__(x, y, batch_size=batch_size, shuffle=train,
                         seed=seed)


class LFWDataSetIterator(ArrayDataSetIterator):
    """Labeled Faces in the Wild (ref: datasets/iterator/impl/
    LFWDataSetIterator.java + fetchers/LFWDataFetcher.java).

    Reads the standard extracted layout ``<data_dir>/lfw/<person>/<img>``
    (one directory per identity, jpg/png inside), decodes + resizes on the
    host, labels = identity index sorted by name. ``num_labels`` keeps the
    N most-frequent identities like the reference's subset mode.
    Features [N, C, H, W] scaled to [0,1]. ``synthetic=True`` generates a
    deterministic stand-in with the real shapes (zero-egress testing).
    """

    def __init__(self, batch_size: int, image_shape: Tuple[int, int, int] = (250, 250, 3),
                 num_examples: Optional[int] = None,
                 num_labels: Optional[int] = None, train: bool = True,
                 split_train_test: float = 1.0,
                 data_dir: Optional[str] = None, seed: int = 123,
                 synthetic: bool = False):
        h, w, c = image_shape
        if synthetic:
            n = num_examples or 200
            classes = num_labels or 10
            imgs, labels = _synthetic_images(n, (c, h, w), classes, seed)
            x = u8_to_f32(np.ascontiguousarray(imgs)).reshape(-1, c, h, w)
            self.num_classes = classes
            self.label_names = [f"person_{i}" for i in range(classes)]
        else:
            from PIL import Image
            base = os.path.join(data_dir or DEFAULT_DATA_DIR, "lfw")
            if not os.path.isdir(base):
                raise FileNotFoundError(
                    f"LFW directory {base!r} not found. This build is "
                    "zero-egress: extract lfw.tgz there manually (or pass "
                    "synthetic=True).")
            exts = (".jpg", ".jpeg", ".png")
            people = sorted(d for d in os.listdir(base)
                            if os.path.isdir(os.path.join(base, d)))
            counts = {p: sum(1 for f in os.listdir(os.path.join(base, p))
                             if f.lower().endswith(exts))
                      for p in people}
            if num_labels:
                people = sorted(sorted(people, key=lambda p: -counts[p])
                                [:num_labels])
            self.label_names = people
            self.num_classes = len(people)
            xs, ys = [], []
            for li, person in enumerate(people):
                pdir = os.path.join(base, person)
                for fn in sorted(os.listdir(pdir)):
                    if not fn.lower().endswith(exts):
                        continue
                    img = Image.open(os.path.join(pdir, fn))
                    img = img.convert("RGB" if c == 3 else "L")
                    img = img.resize((w, h))
                    a = np.asarray(img, np.uint8)
                    if c == 1:
                        a = a[:, :, None]
                    xs.append(a.transpose(2, 0, 1))  # HWC -> CHW
                    ys.append(li)
                    if num_examples and len(xs) >= num_examples:
                        break
                if num_examples and len(xs) >= num_examples:
                    break
            imgs = np.stack(xs)
            labels = np.asarray(ys)
            x = u8_to_f32(np.ascontiguousarray(imgs)).reshape(imgs.shape)
        if split_train_test < 1.0:
            cut = int(len(x) * split_train_test)
            rng = np.random.default_rng(seed)
            order = rng.permutation(len(x))
            keep = order[:cut] if train else order[cut:]
            x, labels = x[keep], labels[keep]
        y = _one_hot(labels, self.num_classes)
        super().__init__(x, y, batch_size=batch_size, shuffle=train,
                         seed=seed)


class SvhnDataSetIterator(ArrayDataSetIterator):
    """Street View House Numbers, cropped-digits format (ref: the
    SVHN fetcher family in later DL4J; 0.9.x lists SVHN in its dataset
    roster). Reads the stanford ``train_32x32.mat``/``test_32x32.mat``
    (matlab v5 via scipy.io) from the data dir. Features [N,3,32,32] in
    [0,1]; label "10" (zero digit) remapped to class 0 like the usual
    SVHN convention."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True,
                 data_dir: Optional[str] = None, seed: int = 123,
                 synthetic: bool = False,
                 num_examples: Optional[int] = None):
        if synthetic:
            imgs, labels = _synthetic_images(
                num_examples or 2000, (3, 32, 32), self.NUM_CLASSES, seed)
            x = u8_to_f32(np.ascontiguousarray(imgs)).reshape(-1, 3, 32, 32)
        else:
            from scipy.io import loadmat
            name = "train_32x32.mat" if train else "test_32x32.mat"
            mat = loadmat(_resolve(data_dir, name))
            imgs = mat["X"]            # [32, 32, 3, N]
            labels = mat["y"].ravel().astype(np.int64)
            labels[labels == 10] = 0   # '0' digit stored as 10
            imgs = np.ascontiguousarray(imgs.transpose(3, 2, 0, 1))  # NCHW
            if num_examples:
                imgs, labels = imgs[:num_examples], labels[:num_examples]
            x = u8_to_f32(imgs).reshape(imgs.shape)
        y = _one_hot(labels, self.NUM_CLASSES)
        super().__init__(x, y, batch_size=batch_size, shuffle=train,
                         seed=seed)


class IrisDataSetIterator(ArrayDataSetIterator):
    """Iris (ref: IrisDataSetIterator.java). Reads ``iris.csv``
    (4 features + integer label per row) from the data dir; without the
    file, generates a deterministic 3-class Gaussian stand-in with the
    iris shape (150x4) — synthetic, clearly not Fisher's measurements."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150,
                 data_dir: Optional[str] = None, seed: int = 6):
        try:
            data = read_csv(_resolve(data_dir, "iris.csv"))
            x, labels = data[:, :4], data[:, 4].astype(np.int64)
        except FileNotFoundError:
            rng = np.random.default_rng(seed)
            centers = np.array([[5.0, 3.4, 1.5, 0.2],
                                [5.9, 2.8, 4.3, 1.3],
                                [6.6, 3.0, 5.6, 2.0]], np.float32)
            labels = np.repeat(np.arange(3), 50)
            x = (centers[labels] +
                 rng.normal(0, 0.3, (150, 4))).astype(np.float32)
        x, labels = x[:num_examples], labels[:num_examples]
        super().__init__(x.astype(np.float32), _one_hot(labels, 3),
                         batch_size=batch_size, shuffle=False, seed=seed)
