"""data of the PyTorch port (port of ``data/``; reference
``deeplearning4j-core/.../datasets/`` +
``deeplearning4j-nn/.../datasets/iterator/``).

Re-exports what the JAX package's ``data`` exports, except
``ShapePolicy`` and ``default_shape_policy`` (``data/shapes.py``), which
wait for ROADMAP item 2's graph capture, which is what they feed.
``TextCorpusVectorizer`` imports ``nlp`` (and with it torch) only when it
vectorizes.

Importing the package loads numpy only (torch is imported inside the
calls that place batches on a device), so the spawned ETL workers of
``pipeline`` never load torch.
"""
from .dataset import (AsyncDataSetIterator, BenchmarkDataSetIterator, DataSet,
                      DataSetIterator, EarlyTerminationDataSetIterator,
                      ExistingDataSetIterator, INDArrayDataSetIterator,
                      MovingWindowDataSetIterator, MultipleEpochsIterator,
                      SamplingDataSetIterator)
from .dataset import MultiDataSet
from .records import RecordReaderMultiDataSetIterator
from .dataset import AsyncMultiDataSetIterator
from .dataset import (DataSetCallback, FileSplitDataSetIterator,
                      export_dataset_batches, load_dataset, save_dataset)
from .dataset import (AsyncShieldDataSetIterator,
                      AsyncShieldMultiDataSetIterator, CombinedPreProcessor,
                      DataSetPreProcessor, DoublesDataSetIterator,
                      DummyPreProcessor, FileSplitParallelDataSetIterator,
                      FloatsDataSetIterator, IteratorDataSetIterator,
                      JointParallelDataSetIterator,
                      MultiDataSetWrapperIterator,
                      PreProcessedDataSetIterator,
                      ReconstructionDataSetIterator)
from .pipeline import (DevicePrefetchIterator, MultiprocessETLIterator,
                       build_input_pipeline)
from .transforms import (ComposeTransform, CutoutTransform,
                         ImageTransform, RandomCropTransform,
                         RandomFlipTransform, TransformingDataSetIterator)
from .normalization import (ImagePreProcessingScaler,
                            NormalizerMinMaxScaler, NormalizerStandardize,
                            load_normalizer)
from .interop import TorchDataSetIterator, as_torch_dataset, from_torch
from .formatter import LocalUnstructuredDataFormatter
from .fetchers import (CifarDataSetIterator, EmnistDataSetIterator,
                       LFWDataSetIterator, TinyImageNetDataSetIterator)
from .mnist import IrisDataSetIterator, MnistDataSetIterator
from .vectorizer import CallableVectorizer, TextCorpusVectorizer, Vectorizer

__all__ = [
    "AsyncDataSetIterator", "AsyncMultiDataSetIterator", "BenchmarkDataSetIterator", "DataSet",
    "DataSetIterator", "EarlyTerminationDataSetIterator",
    "ExistingDataSetIterator", "INDArrayDataSetIterator",
    "IrisDataSetIterator", "MnistDataSetIterator", "MovingWindowDataSetIterator",
    "MultipleEpochsIterator", "SamplingDataSetIterator",
    "CifarDataSetIterator", "EmnistDataSetIterator", "LFWDataSetIterator",
    "TinyImageNetDataSetIterator", "LocalUnstructuredDataFormatter", "DataSetCallback",
    "FileSplitDataSetIterator", "export_dataset_batches", "load_dataset",
    "save_dataset", "TorchDataSetIterator", "as_torch_dataset",
    "from_torch", "MultiDataSet", "RecordReaderMultiDataSetIterator",
    "NormalizerStandardize", "NormalizerMinMaxScaler",
    "ImagePreProcessingScaler", "load_normalizer", "ImageTransform", "RandomFlipTransform",
    "RandomCropTransform", "CutoutTransform", "ComposeTransform",
    "TransformingDataSetIterator", "AsyncShieldDataSetIterator",
    "AsyncShieldMultiDataSetIterator", "CombinedPreProcessor",
    "DataSetPreProcessor", "DoublesDataSetIterator", "DummyPreProcessor",
    "FileSplitParallelDataSetIterator", "FloatsDataSetIterator",
    "IteratorDataSetIterator", "JointParallelDataSetIterator",
    "MultiDataSetWrapperIterator", "PreProcessedDataSetIterator",
    "ReconstructionDataSetIterator", "DevicePrefetchIterator",
    "MultiprocessETLIterator", "build_input_pipeline",
    "Vectorizer", "CallableVectorizer", "TextCorpusVectorizer",
]
