"""Zoo models at ``tests/test_zoo.py``'s miniature sizes, written by the
JAX package and read by the port: output, step-0 loss and gradients
with dropout on, three fit steps (``tests/helpers/torch_zoo_parity.py``
states the tolerances and their reasons)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_zoo_parity import check_zoo_model  # noqa: E402


def test_simplecnn_matches_jax(tmp_path):
    """BatchNormalization and a DropoutLayer(0.5); Adam."""
    check_zoo_model("SimpleCNN", dict(num_classes=4,
                                      input_shape=(16, 16, 3)), tmp_path)


def test_alexnet_matches_jax(tmp_path):
    """The 11x11/4 'same' convolution (explicit asymmetric pads), LRN,
    dense dropout 0.5 twice, l2 5e-4; Nesterovs."""
    check_zoo_model("AlexNet", dict(num_classes=7, input_shape=(64, 64, 3)),
                    tmp_path)
