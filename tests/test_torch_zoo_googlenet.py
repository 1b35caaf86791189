"""Zoo models at ``tests/test_zoo.py``'s miniature sizes, written by the
JAX package and read by the port: output, step-0 loss and gradients
with dropout on, three fit steps (``tests/helpers/torch_zoo_parity.py``
states the tolerances and their reasons)."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_zoo_parity import check_zoo_model  # noqa: E402


def test_googlenet_matches_jax(tmp_path):
    """Nine inception modules (MergeVertex on the channel axis, the 3x3/1
    max pool padded with -inf), DropoutLayer(0.4); Adam."""
    check_zoo_model("GoogLeNet", dict(num_classes=6,
                                      input_shape=(32, 32, 3)), tmp_path)
