"""Zoo models at ``tests/test_zoo.py``'s miniature sizes, written by the
JAX package and read by the port: output, step-0 loss and gradients
with dropout on, three fit steps (``tests/helpers/torch_zoo_parity.py``
states the tolerances and their reasons)."""
import os
import sys

from deeplearning4j_tpu.nn.conf.updaters import Nesterovs as JNesterovs

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "helpers"))
from torch_zoo_parity import check_zoo_model  # noqa: E402


def test_inceptionresnetv1_matches_jax(tmp_path):
    """1x7/7x1 'same' convolutions, ScaleVertex, L2NormalizeVertex;
    trained under a Nesterovs override on both sides so params compare."""
    check_zoo_model("InceptionResNetV1",
                    dict(num_classes=5, input_shape=(64, 64, 3), blocks_a=1,
                         blocks_b=1, blocks_c=1), tmp_path,
                    updater=JNesterovs(learning_rate=1e-2, momentum=0.9))


def test_facenetnn4small2_matches_jax(tmp_path):
    """Inception trunk, L2NormalizeVertex, CenterLossOutputLayer (centers
    move, value-neutral); Adam."""
    check_zoo_model("FaceNetNN4Small2",
                    dict(num_classes=5, input_shape=(32, 32, 3)), tmp_path)
