// Host-side gradient codec of the training masters: threshold and bitmap
// encoding of a flat f32 update, with the residual the encoding leaves.
//
// The port's own copy of the JAX package's native codec (the same four
// functions and C interface).  It is not a device kernel: the training
// masters' EncodingHandler runs it on the host, right before a message
// leaves the process (utils/native.py builds it with g++ at first use).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libdl4j_torch_codec.so \
//            host_codec.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// Sparsify: |g[i]| >= t transmitted as its sign; the residual keeps the
// rest.  If more than max_k qualify, keep the max_k largest magnitudes.
// Returns the number of encoded elements (<= max_k).
int64_t dl4j_threshold_encode(const float* grad, int64_t n, float threshold,
                              int64_t max_k, int32_t* idx_out,
                              int8_t* sign_out, float* residual_out) {
    std::vector<int64_t> over;
    over.reserve(static_cast<size_t>(std::min(n, max_k * 2)));
    for (int64_t i = 0; i < n; ++i) {
        residual_out[i] = grad[i];
        if (std::fabs(grad[i]) >= threshold) over.push_back(i);
    }
    if ((int64_t)over.size() > max_k) {
        // partial-select the max_k largest |g|
        std::nth_element(over.begin(), over.begin() + max_k, over.end(),
                         [&](int64_t a, int64_t b) {
                             return std::fabs(grad[a]) > std::fabs(grad[b]);
                         });
        over.resize(static_cast<size_t>(max_k));
        std::sort(over.begin(), over.end());
    }
    int64_t count = 0;
    for (int64_t i : over) {
        int8_t s = grad[i] >= 0.f ? 1 : -1;
        idx_out[count] = (int32_t)i;
        sign_out[count] = s;
        residual_out[i] = grad[i] - s * threshold;
        ++count;
    }
    return count;
}

void dl4j_threshold_decode(const int32_t* idx, const int8_t* sign,
                           int64_t count, float threshold, float* out,
                           int64_t n) {
    std::memset(out, 0, sizeof(float) * (size_t)n);
    for (int64_t j = 0; j < count; ++j)
        out[idx[j]] = sign[j] * threshold;
}

// 2-bit codes (0 none, 1 +t, 2 -t), 4 per byte; returns packed byte count.
int64_t dl4j_bitmap_encode(const float* grad, int64_t n, float threshold,
                           uint8_t* packed_out, float* residual_out) {
    int64_t n_bytes = (n + 3) / 4;
    std::memset(packed_out, 0, (size_t)n_bytes);
    for (int64_t i = 0; i < n; ++i) {
        uint8_t code = 0;
        float r = grad[i];
        if (grad[i] >= threshold)       { code = 1; r -= threshold; }
        else if (grad[i] <= -threshold) { code = 2; r += threshold; }
        residual_out[i] = r;
        packed_out[i >> 2] |= (uint8_t)(code << ((i & 3) * 2));
    }
    return n_bytes;
}

void dl4j_bitmap_decode(const uint8_t* packed, int64_t n, float threshold,
                        float* out) {
    for (int64_t i = 0; i < n; ++i) {
        uint8_t code = (packed[i >> 2] >> ((i & 3) * 2)) & 0x3;
        out[i] = code == 1 ? threshold : (code == 2 ? -threshold : 0.f);
    }
}

}  // extern "C"
