"""deeplearning4j_tpu_torch: the PyTorch/CUDA port of deeplearning4j_tpu.

Each module mirrors its counterpart in the JAX package by path.  The
port imports torch and numpy only; it never imports jax or the JAX
package.  Entry points take ``device=`` and default to ``"cuda"``.
"""
