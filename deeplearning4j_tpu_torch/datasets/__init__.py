"""Data pipeline: the DataSet container and the iterators (the
fetchers, normalizers and record readers are ROADMAP.md A11)."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet  # noqa: F401
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    ArrayDataSetIterator, AsyncDataSetIterator, BenchmarkDataSetIterator,
    DataSetIterator, EarlyTerminationDataSetIterator, ExistingDataSetIterator,
    FileSplitParallelDataSetIterator, JointParallelDataSetIterator,
    MultipleEpochsIterator, SamplingDataSetIterator)
