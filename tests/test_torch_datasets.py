"""The port's datasets (deeplearning4j_tpu_torch/datasets/: normalizers,
records, formatter, fetchers, host_io, the DataSet helpers) against the
JAX package's, on the CPU: all numpy on both sides, so every comparison
is exact (bitwise arrays, equal JSON strings, equal file trees).

- Normalizers: NormalizerStandardize, NormalizerMinMaxScaler (with
  labels), ImagePreProcessingScaler (uint8 NHWC decode order and float
  NCHW), VGG16ImagePreProcessor: fit statistics, transforms, reverts and
  ``to_json``; each package's JSON restores in the other.
- The record readers (CSV, collection, sequence) and the three
  record-reader iterators, labels one-hot and regression, both sequence
  alignments with their masks, the multi-input builder.
- The formatter's train / test split of a directory tree, both labeling
  modes, the same seed.
- Synthetic MNIST, EMNIST, CIFAR-10, SVHN, LFW and Iris arrays; MNIST
  from IDX files written here, plain and gzipped; a missing file raises
  as in the JAX package (no download).
- ``host_io``'s four decoders on bytes written here against the JAX
  package's ``native`` readers (its C++ runtime when built, else numpy).
- ``one_hot`` and ``MultiDataSet``.
"""

import gzip
import json
import os

import numpy as np
import pytest

from deeplearning4j_tpu import native as jnative
from deeplearning4j_tpu.datasets import dataset as jds
from deeplearning4j_tpu.datasets import fetchers as jf
from deeplearning4j_tpu.datasets import formatter as jfmt
from deeplearning4j_tpu.datasets import normalizers as jn
from deeplearning4j_tpu.datasets import records as jr
from deeplearning4j_tpu.native import image as jimage
from deeplearning4j_tpu_torch.datasets import dataset as tds
from deeplearning4j_tpu_torch.datasets import fetchers as tf
from deeplearning4j_tpu_torch.datasets import formatter as tfmt
from deeplearning4j_tpu_torch.datasets import host_io
from deeplearning4j_tpu_torch.datasets import normalizers as tn
from deeplearning4j_tpu_torch.datasets import records as tr
from torch_threads import one_thread  # noqa: F401 (autouse)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _ds_same(a, b):
    for k in ("features", "labels", "features_mask", "labels_mask"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            _same(x, y)


# ---------------------------------------------------------------------
# normalizers
# ---------------------------------------------------------------------
def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((20, 3, 4, 5)).astype(np.float32) * 3 + 1,
            rng.standard_normal((20, 2)).astype(np.float32))


@pytest.mark.parametrize("name,args", [
    ("NormalizerStandardize", ()), ("NormalizerMinMaxScaler", ()),
    ("NormalizerMinMaxScaler", (-1.0, 2.0))],
    ids=["standardize", "minmax", "minmax_-1_2"])
def test_fitted_normalizers_equal_jax(name, args):
    x, y = _data()
    jnorm = getattr(jn, name)(*args)
    tnorm = getattr(tn, name)(*args)
    for n in (jnorm, tnorm):
        n.fit_label(True)
    # fitted over an iterator of DataSets, labels included
    jnorm.fit([jds.DataSet(x[:12], y[:12]), jds.DataSet(x[12:], y[12:])])
    tnorm.fit([tds.DataSet(x[:12], y[:12]), tds.DataSet(x[12:], y[12:])])
    assert tnorm.to_json() == jnorm.to_json()
    jd, td = jds.DataSet(x.copy(), y.copy()), tds.DataSet(x.copy(), y.copy())
    jnorm.transform(jd)
    tnorm.transform(td)
    _ds_same(td, jd)
    _same(tnorm.revert_features(td.features),
          jnorm.revert_features(jd.features))
    _same(tnorm.revert_labels(td.labels), jnorm.revert_labels(jd.labels))
    _same(tnorm.transform(x), jnorm.transform(x))
    # each package's JSON restores in the other
    back = tn.normalizer_from_dict(json.loads(jnorm.to_json()))
    _same(back.transform(x), jnorm.transform(x))
    jback = jn.normalizer_from_dict(json.loads(tnorm.to_json()))
    _same(jback.transform(x), tnorm.transform(x))


def test_image_preprocessors_equal_jax():
    rng = np.random.default_rng(1)
    nhwc = rng.integers(0, 256, (4, 6, 5, 3), np.uint8)
    nchw = rng.random((4, 3, 6, 5)).astype(np.float32) * 255
    for args in ((), (-1.0, 1.0)):
        jnorm = jn.ImagePreProcessingScaler(*args)
        tnorm = tn.ImagePreProcessingScaler(*args)
        for x in (nhwc, nchw):
            _same(tnorm.transform(x), jnorm.transform(x))
        _same(tnorm.revert_features(tnorm.transform(nchw)),
              jnorm.revert_features(jnorm.transform(nchw)))
        assert tnorm.to_json() == jnorm.to_json()
    jvgg, tvgg = jn.VGG16ImagePreProcessor(), tn.VGG16ImagePreProcessor()
    for x in (nhwc, nchw, nchw[0]):
        _same(tvgg.transform(x), jvgg.transform(x))
    _same(tvgg.revert_features(nchw), jvgg.revert_features(nchw))
    assert tvgg.to_json() == jvgg.to_json()
    with pytest.raises(ValueError, match="3 RGB channels"):
        tvgg.transform(nchw[:, :2])
    with pytest.raises(RuntimeError, match="not fitted"):
        tn.NormalizerStandardize().transform(nchw)


# ---------------------------------------------------------------------
# host decoders
# ---------------------------------------------------------------------
def _idx_bytes(arr, code):
    head = bytes([0, 0, code, arr.ndim]) + b"".join(
        int(d).to_bytes(4, "big") for d in arr.shape)
    return head + arr.astype(arr.dtype.newbyteorder(">")).tobytes()


@pytest.mark.parametrize("code,dtype", [(0x08, np.uint8), (0x09, np.int8),
                                        (0x0B, np.int16), (0x0C, np.int32),
                                        (0x0D, np.float32),
                                        (0x0E, np.float64)])
def test_read_idx_equals_the_jax_packages(tmp_path, code, dtype):
    rng = np.random.default_rng(code)
    arr = (rng.standard_normal((3, 4, 5)) * 100).astype(dtype)
    path = tmp_path / "a.idx"
    path.write_bytes(_idx_bytes(arr, code))
    got = host_io.read_idx(str(path))
    _same(got, jnative.read_idx(str(path)))
    _same(got, arr)
    path.write_bytes(_idx_bytes(arr, code)[:-1])
    with pytest.raises(IOError):
        host_io.read_idx(str(path))


def test_the_host_decoders_equal_the_jax_packages(tmp_path):
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, (5, 7, 6, 3), np.uint8)
    for scale in (1.0 / 255.0, 0.5, 3.0):
        _same(host_io.u8_to_f32(u8, scale), jnative.u8_to_f32(u8, scale))
    mean = np.array([0.4, 0.5, 0.6], np.float32)
    std = np.array([0.2, 0.0, 0.3], np.float32)
    for kw in ({}, {"mean": mean}, {"mean": mean, "std": std},
               {"scale": 1.0, "mean": np.float32([123.68, 116.779,
                                                  103.939])}):
        _same(host_io.u8hwc_to_f32chw(u8, **kw),
              jimage.u8hwc_to_f32chw(u8, **kw))
    vals = rng.standard_normal((6, 4)) * 10.0 ** rng.integers(-3, 4, (6, 4))
    lines = ["h1,h2,h3,h4", ""] + [",".join(f"{v:.7g}" for v in row)
                                    for row in vals] + [" "]
    path = tmp_path / "a.csv"
    path.write_text("\n".join(lines) + "\n")
    got = host_io.read_csv(str(path), skip_header=True)
    _same(got, jnative.read_csv(str(path), skip_header=True))
    assert got.shape == (6, 4)
    (tmp_path / "b.csv").write_text("1 2 3\n4 5\n")
    with pytest.raises(IOError):
        host_io.read_csv(str(tmp_path / "b.csv"))


# ---------------------------------------------------------------------
# record readers and their iterators
# ---------------------------------------------------------------------
@pytest.fixture
def csv_file(tmp_path):
    rng = np.random.default_rng(4)
    rows = np.concatenate([rng.random((11, 4)).round(3),
                           rng.integers(0, 3, (11, 1))], axis=1)
    path = tmp_path / "rows.csv"
    path.write_text("a,b,c,d,label\n" + "\n".join(
        ",".join(f"{v:g}" for v in r) for r in rows) + "\n")
    return str(path), rows


def _batches(it):
    return list(iter(it))


def test_record_reader_iterators_equal_jax(csv_file):
    path, rows = csv_file
    for kw in (dict(label_index=4, num_classes=3),
               dict(label_index=2, regression=True, label_index_to=3),
               dict()):
        want = _batches(jr.RecordReaderDataSetIterator(
            jr.CSVRecordReader(path, skip_lines=1), 4, **kw))
        got = _batches(tr.RecordReaderDataSetIterator(
            tr.CSVRecordReader(path, skip_lines=1), 4, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _ds_same(g, w)
        coll = _batches(tr.RecordReaderDataSetIterator(
            tr.CollectionRecordReader(rows.astype(np.float32)), 4, **kw))
        for g, w in zip(coll, want):
            _ds_same(g, w)
    build = [(m.RecordReaderMultiDataSetIterator.Builder(3)
              .add_reader("csv", m.CSVRecordReader(path, skip_lines=1))
              .add_reader("mem", m.CollectionRecordReader(rows))
              .add_input("csv", 0, 2).add_input("mem", 3)
              .add_output_one_hot("csv", 4, 3).add_output("mem", 0, 1)
              .build()) for m in (jr, tr)]
    want, got = _batches(build[0]), _batches(build[1])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g.features + g.labels, w.features + w.labels):
            _same(a, b)


@pytest.mark.parametrize("align", ["ALIGN_START", "ALIGN_END"])
def test_sequence_iterators_equal_jax(tmp_path, align):
    rng = np.random.default_rng(5)
    seqs = [np.concatenate([rng.random((t, 2)).round(3),
                            rng.integers(0, 4, (t, 1))], axis=1)
            for t in (3, 5, 2, 4, 6)]
    paths = []
    for i, s in enumerate(seqs):
        p = tmp_path / f"s{i}.csv"
        p.write_text("\n".join(",".join(f"{v:g}" for v in r) for r in s))
        paths.append(str(p))
    labels = [rng.random((t, 1)).astype(np.float32) for t in (2, 5, 1, 4, 3)]
    cases = [
        (lambda m: m.CSVSequenceRecordReader(paths), None,
         dict(num_classes=4)),
        (lambda m: m.CollectionSequenceRecordReader([s[:, :2] for s in seqs]),
         lambda m: m.CollectionSequenceRecordReader(labels),
         dict(regression=True))]
    for reader, label_reader, kw in cases:
        its = [m.SequenceRecordReaderDataSetIterator(
            reader(m), 2, label_reader=label_reader and label_reader(m),
            alignment=getattr(m.AlignmentMode, align), **kw)
            for m in (jr, tr)]
        want, got = _batches(its[0]), _batches(its[1])
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _ds_same(g, w)


# ---------------------------------------------------------------------
# the formatter
# ---------------------------------------------------------------------
def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


@pytest.mark.parametrize("labeling", ["directory", "name"])
def test_the_formatter_splits_as_jax(tmp_path, labeling):
    src = tmp_path / "src"
    for label in ("cat", "dog"):
        for i in range(5):
            d = src / label
            d.mkdir(parents=True, exist_ok=True)
            (d / f"img{i}-{label}.txt").write_text(f"{label}{i}")
    outs = []
    for m, name in ((jfmt, "jax"), (tfmt, "torch")):
        f = m.LocalUnstructuredDataFormatter(str(tmp_path / name), str(src),
                                             labeling_type=labeling,
                                             percent_train=0.7, seed=11)
        f.rearrange()
        outs.append((_tree(tmp_path / name), f.get_num_examples_total(),
                     f.get_num_examples_to_train_on(),
                     f.get_num_test_examples()))
    assert outs[0] == outs[1] and outs[1][1:] == (10, 7, 3)
    with pytest.raises(RuntimeError, match="already exists"):
        tfmt.LocalUnstructuredDataFormatter(str(tmp_path / "torch"),
                                            str(src))


# ---------------------------------------------------------------------
# fetchers
# ---------------------------------------------------------------------
def _arrays(it):
    return it.features, it.labels


@pytest.mark.parametrize("name,kw", [
    ("MnistDataSetIterator", dict(batch_size=16, num_examples=64)),
    ("MnistDataSetIterator", dict(batch_size=16, num_examples=32,
                                  train=False, flatten=False)),
    ("EmnistDataSetIterator", dict(batch_size=8, split="letters",
                                   num_examples=24)),
    ("CifarDataSetIterator", dict(batch_size=8, num_examples=24)),
    ("SvhnDataSetIterator", dict(batch_size=8, num_examples=24)),
    ("LFWDataSetIterator", dict(batch_size=4, image_shape=(12, 10, 3),
                                num_examples=20, num_labels=4,
                                split_train_test=0.5))],
    ids=["mnist", "mnist_cnn", "emnist", "cifar", "svhn", "lfw"])
def test_synthetic_sets_are_bitwise_the_jax_packages(name, kw):
    want = getattr(jf, name)(synthetic=True, **kw)
    got = getattr(tf, name)(synthetic=True, **kw)
    for a, b in zip(_arrays(got), _arrays(want)):
        _same(a, b)
    for g, w in zip(iter(got), iter(want)):
        _ds_same(g, w)


def test_iris_is_bitwise_the_jax_packages(tmp_path):
    for kw in ({"data_dir": str(tmp_path)},
               {"data_dir": str(tmp_path), "num_examples": 60, "seed": 2}):
        _same(tf.IrisDataSetIterator(**kw).features,
              jf.IrisDataSetIterator(**kw).features)
    rows = np.random.default_rng(6).random((9, 4)).round(2)
    (tmp_path / "iris.csv").write_text("\n".join(
        ",".join(f"{v:g}" for v in r) + f",{i % 3}"
        for i, r in enumerate(rows)))
    got = tf.IrisDataSetIterator(data_dir=str(tmp_path), num_examples=9)
    want = jf.IrisDataSetIterator(data_dir=str(tmp_path), num_examples=9)
    for a, b in zip(_arrays(got), _arrays(want)):
        _same(a, b)


@pytest.mark.parametrize("gz", [False, True], ids=["idx", "idx_gz"])
def test_mnist_reads_local_files_as_jax(tmp_path, gz):
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (10, 28, 28), np.uint8)
    labels = rng.integers(0, 10, 10).astype(np.uint8)
    for name, arr, code in (("t10k-images-idx3-ubyte", imgs, 0x08),
                            ("t10k-labels-idx1-ubyte", labels, 0x08)):
        data = _idx_bytes(arr, code)
        if gz:
            (tmp_path / (name + ".gz")).write_bytes(gzip.compress(data))
        else:
            (tmp_path / name).write_bytes(data)
    got = tf.MnistDataSetIterator(5, train=False, data_dir=str(tmp_path))
    # (the JAX package reads the files the port decompressed, too)
    want = jf.MnistDataSetIterator(5, train=False, data_dir=str(tmp_path))
    for a, b in zip(_arrays(got), _arrays(want)):
        _same(a, b)
    _same(np.rint(got.features.reshape(10, 28, 28) * 255).astype(np.uint8),
          imgs)
    with pytest.raises(FileNotFoundError, match="zero-egress"):
        tf.MnistDataSetIterator(5, data_dir=str(tmp_path))  # no train set
    with pytest.raises(FileNotFoundError, match="zero-egress"):
        jf.MnistDataSetIterator(5, data_dir=str(tmp_path))


# ---------------------------------------------------------------------
# DataSet helpers
# ---------------------------------------------------------------------
def test_dataset_helpers_equal_jax():
    x, y = _data(8)
    _same(tds.one_hot([2, 0, 1], 4), jds.one_hot([2, 0, 1], 4))
    with pytest.raises(ValueError, match="outside"):
        tds.one_hot([4], 4)
    m = tds.MultiDataSet([x, x[:, :1]], [y])
    assert m.num_examples() == 20
