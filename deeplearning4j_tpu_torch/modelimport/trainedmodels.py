"""Pretrained-model helpers: VGG16 preprocessing and ImageNet decoding
(port of ``modelimport/trainedmodels.py``; reference
``deeplearning4j-modelimport/.../trainedmodels/TrainedModels.java``).

Weights come from a local Keras HDF5 file through the importer, labels
from the file ``IMAGENET_LABELS`` names (one label per line, 1000 lines)
or the positional names ``class_<i>``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["TrainedModels", "VGG16Helper", "ImageNetLabels"]

# the caffe-style channel means the VGG family was trained with (RGB)
VGG_MEAN_RGB = (123.68, 116.779, 103.939)


class ImageNetLabels:
    """The 1000-class label table: the ``IMAGENET_LABELS`` file, or
    positional names."""

    def __init__(self, path: Optional[str] = None):
        path = path or os.environ.get("IMAGENET_LABELS")
        self._labels: List[str]
        if path and Path(path).expanduser().exists():
            lines = Path(path).expanduser().read_text(
                encoding="utf-8").splitlines()
            self._labels = [l.strip() for l in lines if l.strip()]
        else:
            self._labels = [f"class_{i}" for i in range(1000)]

    def get_label(self, idx: int) -> str:
        return self._labels[idx]

    def __len__(self) -> int:
        return len(self._labels)

    def decode_predictions(self, probs, top: int = 5
                           ) -> List[List[Tuple[str, float]]]:
        """``[b, 1000]`` probabilities (array or tensor) -> per example the
        top-k ``[(label, prob)]`` (reference
        ``TrainedModels.VGG16.decodePredictions``)."""
        if hasattr(probs, "detach"):
            probs = probs.detach().cpu().numpy()
        p = np.asarray(probs)
        if p.ndim == 1:
            p = p[None]
        out = []
        for row in p:
            idx = np.argsort(-row)[:top]
            out.append([(self.get_label(int(i)), float(row[i]))
                        for i in idx])
        return out


class VGG16Helper:
    """Preprocess, predict and decode for VGG16 (reference
    ``TrainedModels.VGG16``)."""

    input_shape = (224, 224, 3)

    def __init__(self, labels: Optional[ImageNetLabels] = None):
        self.labels = labels or ImageNetLabels()

    @staticmethod
    def preprocess(images) -> np.ndarray:
        """NHWC RGB uint8/float in [0, 255] (or [0, 1]) -> mean-subtracted
        float32 (the caffe-style preprocessing VGG16 was trained with)."""
        x = np.asarray(images, np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.max() <= 1.0 + 1e-6:
            x = x * 255.0
        return x - np.asarray(VGG_MEAN_RGB, np.float32)

    def build_network(self, weights_path: Optional[str] = None,
                      device="cuda"):
        """A fresh zoo VGG16 on ``device``, or the network a Keras HDF5
        file holds, through the importer."""
        if weights_path:
            from .keras import import_keras_model
            return import_keras_model(weights_path, device=device)
        from ..models.zoo import VGG16
        return VGG16().init(device=device)

    def predict_and_decode(self, net, images, top: int = 5):
        probs = net.output(self.preprocess(images))
        if isinstance(probs, (list, tuple)):
            probs = probs[0]
        return self.labels.decode_predictions(probs, top=top)


class TrainedModels:
    """Enum-style access (reference ``TrainedModels.java``)."""
    VGG16 = VGG16Helper()
