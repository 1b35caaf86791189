"""Model import (port of ``modelimport/``; reference
``deeplearning4j-modelimport``): pure-Python HDF5 reading and writing,
and Keras model import and export onto the port's networks."""
from .hdf5 import Hdf5Dataset, Hdf5File, Hdf5FormatError, Hdf5Group
from .hdf5_writer import Hdf5Writer, write_hdf5
from .trainedmodels import ImageNetLabels, TrainedModels, VGG16Helper
from .keras_export import export_keras_model, export_keras_sequential
from .keras import (KerasImportError, KerasModelImport, import_keras_model,
                    import_keras_sequential_model)

__all__ = ["Hdf5File", "Hdf5Group", "Hdf5Dataset", "Hdf5FormatError",
           "Hdf5Writer", "write_hdf5", "KerasModelImport",
           "KerasImportError", "import_keras_sequential_model",
           "import_keras_model", "ImageNetLabels", "TrainedModels",
           "VGG16Helper", "export_keras_sequential", "export_keras_model"]
