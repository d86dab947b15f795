"""Record readers + record→DataSet adapters.

Counterpart of ``deeplearning4j_tpu/datasets/records.py`` (the same
numpy code): the DataVec layer the reference consumes plus its adapters
in deeplearning4j-core:
- RecordReader SPI (DataVec CSVRecordReader / CSVSequenceRecordReader /
  CollectionRecordReader) — here host-side readers, CSV decode through
  ``datasets/host_io.py``.
- datasets/datavec/RecordReaderDataSetIterator.java:441 (label column →
  one-hot or regression targets),
- SequenceRecordReaderDataSetIterator.java:467 (paired feature/label
  sequence readers, ALIGN_START/ALIGN_END padding + masks),
- RecordReaderMultiDataSetIterator.java:898 (named inputs/outputs built
  from column subsets).
"""

from __future__ import annotations

import itertools
from enum import Enum
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import (
    DataSet, MultiDataSet, one_hot)
from deeplearning4j_tpu_torch.datasets.host_io import read_csv
from deeplearning4j_tpu_torch.datasets.iterators import DataSetIterator


# ---------------------------------------------------------------------------
# Record readers (DataVec-equivalent SPI)
# ---------------------------------------------------------------------------

class RecordReader:
    """One record per example: a 1-D float vector (ref: DataVec
    RecordReader)."""

    def records(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    def reset(self) -> None:
        pass


class CollectionRecordReader(RecordReader):
    """In-memory records (ref: CollectionRecordReader)."""

    def __init__(self, rows: Sequence[Sequence[float]]):
        self._rows = [np.asarray(r, np.float32) for r in rows]

    def records(self):
        return iter(self._rows)


class CSVRecordReader(RecordReader):
    """CSV rows as records, parsed by ``datasets/host_io.read_csv``
    (ref: DataVec CSVRecordReader)."""

    def __init__(self, path: str, skip_lines: int = 0,
                 delimiter: str = ","):
        self.path = path
        self.skip_lines = skip_lines
        self.delimiter = delimiter
        self._data: Optional[np.ndarray] = None

    def _load(self) -> np.ndarray:
        if self._data is None:
            self._data = read_csv(self.path, skip_header=self.skip_lines,
                                  delimiter=self.delimiter)
        return self._data

    def records(self):
        return iter(self._load())


class CSVSequenceRecordReader:
    """One CSV file per sequence: [T, C] arrays
    (ref: DataVec CSVSequenceRecordReader)."""

    def __init__(self, paths: Sequence[str], skip_lines: int = 0,
                 delimiter: str = ","):
        self.paths = list(paths)
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def sequences(self) -> Iterator[np.ndarray]:
        for p in self.paths:
            yield read_csv(p, skip_header=self.skip_lines,
                           delimiter=self.delimiter)


class CollectionSequenceRecordReader:
    """In-memory sequences: list of [T, C] arrays."""

    def __init__(self, seqs: Sequence[np.ndarray]):
        self._seqs = [np.asarray(s, np.float32) for s in seqs]

    def sequences(self):
        return iter(self._seqs)


# ---------------------------------------------------------------------------
# Record → DataSet iterators
# ---------------------------------------------------------------------------

class RecordReaderDataSetIterator(DataSetIterator):
    """Minibatches from a RecordReader (ref:
    RecordReaderDataSetIterator.java:441).

    label_index: column holding the class index (one-hot encoded with
    num_classes) — or, with regression=True, label_index..label_index_to
    inclusive are continuous targets. label_index=None yields
    unlabeled features.
    """

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None,
                 num_classes: Optional[int] = None,
                 regression: bool = False,
                 label_index_to: Optional[int] = None):
        if label_index is not None and not regression and num_classes is None:
            raise ValueError("classification needs num_classes")
        self.reader = reader
        self.batch_size = batch_size
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression
        self.label_index_to = label_index_to if label_index_to is not None \
            else label_index

    def __iter__(self):
        feats, labels = [], []
        for rec in self.reader.records():
            rec = np.asarray(rec, np.float32)
            if self.label_index is None:
                feats.append(rec)
            else:
                li, lj = self.label_index, self.label_index_to
                lab = rec[li:lj + 1]
                feat = np.concatenate([rec[:li], rec[lj + 1:]])
                feats.append(feat)
                if self.regression:
                    labels.append(lab)
                else:
                    labels.append(one_hot(lab[:1], self.num_classes)[0])
            if len(feats) == self.batch_size:
                yield self._emit(feats, labels)
                feats, labels = [], []
        if feats:
            yield self._emit(feats, labels)
        self.reader.reset()

    @staticmethod
    def _emit(feats, labels):
        return DataSet(np.stack(feats),
                       np.stack(labels) if labels else None)


class AlignmentMode(Enum):
    """Sequence alignment for paired feature/label readers
    (ref: SequenceRecordReaderDataSetIterator.AlignmentMode)."""
    EQUAL_LENGTH = "equal_length"
    ALIGN_START = "align_start"
    ALIGN_END = "align_end"


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence minibatches with masking (ref:
    SequenceRecordReaderDataSetIterator.java:467).

    Features come from ``reader``; labels either from the trailing
    column(s) of the same sequences (label_reader=None: last column is the
    class index) or from a separate label reader. Output layout is DL4J's
    [N, C, T] with [N, T] masks.
    """

    def __init__(self, reader, batch_size: int,
                 num_classes: Optional[int] = None,
                 label_reader=None, regression: bool = False,
                 alignment: AlignmentMode = AlignmentMode.ALIGN_START):
        self.reader = reader
        self.label_reader = label_reader
        self.batch_size = batch_size
        self.num_classes = num_classes
        self.regression = regression
        self.alignment = alignment

    def _pairs(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.label_reader is None:
            for seq in self.reader.sequences():
                feat = seq[:, :-1]
                lab = seq[:, -1:]
                yield feat, self._encode(lab)
        else:
            sentinel = object()  # ref throws on count mismatch; stay lazy
            for feat, lab in itertools.zip_longest(
                    self.reader.sequences(), self.label_reader.sequences(),
                    fillvalue=sentinel):
                if feat is sentinel or lab is sentinel:
                    raise ValueError("feature and label readers yield "
                                     "different sequence counts")
                yield np.asarray(feat, np.float32), self._encode(lab)

    def _encode(self, lab: np.ndarray) -> np.ndarray:
        lab = np.asarray(lab, np.float32)
        if self.regression:
            return lab
        if self.num_classes is None:
            raise ValueError("classification needs num_classes")
        return one_hot(lab[:, 0], self.num_classes)

    def __iter__(self):
        batch: List[Tuple[np.ndarray, np.ndarray]] = []
        for pair in self._pairs():
            batch.append(pair)
            if len(batch) == self.batch_size:
                yield self._emit(batch)
                batch = []
        if batch:
            yield self._emit(batch)

    def _emit(self, batch) -> DataSet:
        n = len(batch)
        tf = max(f.shape[0] for f, _ in batch)
        tl = max(l.shape[0] for _, l in batch)
        if self.alignment is AlignmentMode.EQUAL_LENGTH:
            if any(f.shape[0] != l.shape[0] for f, l in batch):
                raise ValueError("EQUAL_LENGTH needs feature length == "
                                 "label length per sequence")
        t = max(tf, tl)
        cf = batch[0][0].shape[1]
        cl = batch[0][1].shape[1]
        x = np.zeros((n, cf, t), np.float32)
        y = np.zeros((n, cl, t), np.float32)
        xm = np.zeros((n, t), np.float32)
        ym = np.zeros((n, t), np.float32)
        for i, (f, l) in enumerate(batch):
            if self.alignment is AlignmentMode.ALIGN_END:
                fo, lo = t - f.shape[0], t - l.shape[0]
            else:
                fo, lo = 0, 0
            x[i, :, fo:fo + f.shape[0]] = f.T
            xm[i, fo:fo + f.shape[0]] = 1.0
            y[i, :, lo:lo + l.shape[0]] = l.T
            ym[i, lo:lo + l.shape[0]] = 1.0
        return DataSet(x, y, xm, ym)


class RecordReaderMultiDataSetIterator(DataSetIterator):
    """Named multi-input/multi-output minibatches from column subsets
    (ref: RecordReaderMultiDataSetIterator.java:898 Builder —
    addReader/addInput/addOutput/addOutputOneHot).

    Usage::

        it = (RecordReaderMultiDataSetIterator.Builder(batch_size=32)
              .add_reader("csv", reader)
              .add_input("csv", 0, 3)            # columns 0..3
              .add_output_one_hot("csv", 4, 10)  # column 4 as 10 classes
              .build())
    """

    class Builder:
        def __init__(self, batch_size: int):
            self.batch_size = batch_size
            self.readers: Dict[str, RecordReader] = {}
            self.inputs: List[Tuple[str, Optional[int], Optional[int]]] = []
            self.outputs: List[Tuple[str, int, int, Optional[int]]] = []

        def add_reader(self, name: str, reader: RecordReader):
            self.readers[name] = reader
            return self

        def add_input(self, name: str, col_from: Optional[int] = None,
                      col_to: Optional[int] = None):
            if col_from is not None and col_to is None:
                col_to = col_from  # single column
            self.inputs.append((name, col_from, col_to))
            return self

        def add_output(self, name: str, col_from: int, col_to: int):
            self.outputs.append((name, col_from, col_to, None))
            return self

        def add_output_one_hot(self, name: str, column: int,
                               num_classes: int):
            self.outputs.append((name, column, column, num_classes))
            return self

        def build(self) -> "RecordReaderMultiDataSetIterator":
            return RecordReaderMultiDataSetIterator(self)

    def __init__(self, builder: "RecordReaderMultiDataSetIterator.Builder"):
        if not builder.readers:
            raise ValueError("no readers added")
        self._b = builder

    def __iter__(self):
        streams = {name: list(r.records())
                   for name, r in self._b.readers.items()}
        counts = {name: len(v) for name, v in streams.items()}
        if len(set(counts.values())) > 1:  # ref throws on count mismatch
            raise ValueError(f"readers disagree on record count: {counts}")
        n_total = next(iter(counts.values()))
        bs = self._b.batch_size
        for s in range(0, n_total, bs):
            ins, outs = [], []
            for name, cf, ct in self._b.inputs:
                rows = streams[name][s:s + bs]
                arr = np.stack([r if cf is None else r[cf:ct + 1]
                                for r in rows]).astype(np.float32)
                ins.append(arr)
            for name, cf, ct, ncls in self._b.outputs:
                rows = streams[name][s:s + bs]
                if ncls is None:
                    outs.append(np.stack([r[cf:ct + 1] for r in rows])
                                .astype(np.float32))
                else:
                    outs.append(one_hot(
                        np.array([r[cf] for r in rows]), ncls))
            yield MultiDataSet(ins, outs)
