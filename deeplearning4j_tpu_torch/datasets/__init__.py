"""Data pipeline: the DataSet container, the iterators, the normalizers,
the record readers, the unstructured-directory formatter and the dataset
fetchers (local files and synthetic stand-ins; no download)."""

from deeplearning4j_tpu_torch.datasets.dataset import (  # noqa: F401
    DataSet, MultiDataSet, one_hot)
from deeplearning4j_tpu_torch.datasets.fetchers import (  # noqa: F401
    CifarDataSetIterator, EmnistDataSetIterator, IrisDataSetIterator,
    LFWDataSetIterator, MnistDataSetIterator, SvhnDataSetIterator)
from deeplearning4j_tpu_torch.datasets.formatter import (  # noqa: F401
    LocalUnstructuredDataFormatter)
from deeplearning4j_tpu_torch.datasets.iterators import (  # noqa: F401
    ArrayDataSetIterator, AsyncDataSetIterator, BenchmarkDataSetIterator,
    DataSetIterator, EarlyTerminationDataSetIterator, ExistingDataSetIterator,
    FileSplitParallelDataSetIterator, JointParallelDataSetIterator,
    MultipleEpochsIterator, SamplingDataSetIterator)
from deeplearning4j_tpu_torch.datasets.normalizers import (  # noqa: F401
    ImagePreProcessingScaler, NormalizerMinMaxScaler, NormalizerStandardize,
    VGG16ImagePreProcessor, normalizer_from_dict)
