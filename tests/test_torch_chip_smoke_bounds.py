"""The least-time bounds ``chip_smoke.py`` sets beside each kernel's time,
pinned at the shapes of the main paths.

Work shaped as matrix products is bounded at the f32 rate of three TF32
tensor-core passes (165 TFLOP/s on an H100 SXM), elementwise work at the
67 TFLOP/s of the CUDA cores, bytes at 3.35 TB/s.  ``chip_smoke`` imports
only the standard library at its top level, so it imports here.
"""
import pytest

import chip_smoke

# [128, 512, 64] causal f32: the TransformerLM's attention at batch 16
ATTN = (128, 512, 64, True, "float32")


@pytest.mark.parametrize("kernel,ms", [("fwd", 0.026081), ("bwd_dq", 0.039121),
                                       ("bwd_dkv", 0.052162)])
def test_attention_bounds_at_the_training_shape(kernel, ms):
    bound, by = chip_smoke.attention_bound_ms(kernel, *ATTN)
    assert bound == pytest.approx(ms, abs=1e-6)
    assert by == "operations"


def test_forward_bytes_and_operations():
    # 4.30 GFLOP at 165 TFLOP/s against 67.4 MB at 3.35 TB/s
    bh, t, d = 128, 512, 64
    ops = 4 * d * bh * t * (t + 1) // 2
    nbytes = 4 * bh * t * d * 4 + bh * t * 4
    assert ops == 4_303_355_904 and nbytes == 67_371_008
    assert chip_smoke.PEAK_OPS_PER_S["float32_products"] == 165e12
    assert nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        0.020111, abs=1e-6)


def test_bf16_attention_is_bytes_bound():
    bound, by = chip_smoke.attention_bound_ms("fwd", 128, 512, 64, True,
                                              "bfloat16")
    assert by == "bytes"
    assert bound == pytest.approx((4 * 128 * 512 * 64 * 2 + 128 * 512 * 4)
                                  / 3.35e12 * 1e3)


def test_lstm_bound_at_the_char_lstm_shape():
    bound, by = chip_smoke.lstm_bound_ms(64, 128, 256)
    assert bound == pytest.approx(0.026195, abs=1e-6)
    assert by == "operations"


@pytest.mark.parametrize("m,c", [(802816, 64), (200704, 256), (6272, 2048)])
def test_bn_apply_stays_bytes_bound_at_the_cuda_core_rate(m, c):
    bound, by = chip_smoke.bn_bound_ms(m, c, "float32")
    assert by == "bytes"
    assert bound == pytest.approx((2 * m * c * 4 + 2 * c * 4)
                                  / 3.35e12 * 1e3)
    # its operations, at the CUDA cores' 67 TFLOP/s, stay well below
    assert 2 * m * c / 67e12 * 1e3 < bound / 5


def test_ptxas_report_names_each_kernel_instance():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_119flash"
        "_bwd_dq_kernelIfLi64EEEvPKT_S3_S3_S3_PKfS5_PS1_iiiiif' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_119flash",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 231 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN44_INTERNAL_ff398355_"
        "17_flash_attn_bwd_cu_dc3b2a6520flash_bwd_dkv_kernelI13__nv_bfloat16"
        "Li256EEEvPKT_' for 'sm_90a'",
        "ptxas info    : Used 200 registers, used 1 barriers"])
    assert chip_smoke.ptxas_report(log) == [
        "flash_bwd_dq_kernel<fLi64E>: Used 231 registers, used 1 barriers",
        "flash_bwd_dkv_kernel<13__nv_bfloat16Li256E>: Used 200 registers, "
        "used 1 barriers"]


def test_decode_bound_at_the_generation_shape():
    # the full-width TransformerLM's decode step, 16 slots at position 300:
    # 134.5 MB of params + 157.8 MB of K/V (16 x 301 written positions, 8
    # layers, K and V, 8 heads x 64, f32) + the [16, 8192] f32 log-probs
    params = 33_615_872 * 4
    kv = 16 * 301 * 8 * 2 * 8 * 64 * 4
    assert kv == 157_810_688
    ms = chip_smoke.decode_bound_ms(params, 16 * 301, 8, 8, 64, 16, 8192)
    assert ms == pytest.approx(
        (params + kv + 16 * 8192 * 4) / 3.35e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.087402, abs=1e-6)
    # no written position: the params and the log-probs alone
    assert chip_smoke.decode_bound_ms(params, 0, 8, 8, 64, 16, 8192) == \
        pytest.approx((params + 16 * 8192 * 4) / 3.35e12 * 1e3, rel=1e-12)
