"""Zoo models at ``tests/test_zoo.py``'s miniature sizes, written by the
JAX package and read by the port: output, step-0 loss and gradients
with dropout on, three fit steps (``tests/helpers/torch_zoo_parity.py``
states the tolerances and their reasons)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_zoo_parity import check_zoo_model  # noqa: E402


def test_lenet_matches_jax(tmp_path):
    """Flat 28x28x1 input through the automatic cnnflat -> cnn
    preprocessor, CNN -> dense flattened in (h, w, c) order; Nesterovs."""
    check_zoo_model("LeNet", dict(num_classes=10, input_shape=(28, 28, 1)),
                    tmp_path)


def test_vgg16_matches_jax(tmp_path):
    """13 convolutions, dense dropout 0.5 twice; Nesterovs."""
    check_zoo_model("VGG16", dict(num_classes=3, input_shape=(32, 32, 3)),
                    tmp_path)


def test_vgg19_matches_jax(tmp_path):
    """16 convolutions, dense dropout 0.5 twice; Nesterovs."""
    check_zoo_model("VGG19", dict(num_classes=3, input_shape=(32, 32, 3)),
                    tmp_path)
