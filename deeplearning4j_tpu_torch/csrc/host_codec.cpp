// Host-side codecs of the port: the training masters' gradient codec
// (threshold and bitmap encoding of a flat f32 update, with the residual
// the encoding leaves) and the data readers' decodes (u8 pixels to f32,
// CIFAR-10 binary records to NHWC floats, strict float CSV).
//
// The port's own copy of the JAX package's native library (the same
// functions and C interface, less the corpus indexer, which serves
// nlp).  None of it is a device kernel: the masters' EncodingHandler
// runs the codec on the host right before a message leaves the process,
// and the data fetchers decode on the host before a batch exists
// (utils/native.py builds the library with g++ at first use).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libdl4j_torch_codec.so \
//            host_codec.cpp

#include <cstdint>
#include <cstdlib>
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

// ------------------------------------------------------------ image decode
// u8 [n] -> f32 [n] times scale (IDX/CIFAR pixel normalization).
void dl4j_u8_to_f32(const uint8_t* in, int64_t n, float scale, float* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = in[i] * scale;
}

// CIFAR binary records [n_rec x (1 + 3*32*32)], CHW -> labels + NHWC floats.
void dl4j_decode_cifar(const uint8_t* raw, int64_t n_rec, float scale,
                       int32_t* labels_out, float* nhwc_out) {
    const int64_t C = 3, H = 32, W = 32, REC = 1 + C * H * W;
    for (int64_t r = 0; r < n_rec; ++r) {
        const uint8_t* rec = raw + r * REC;
        labels_out[r] = rec[0];
        const uint8_t* px = rec + 1;
        float* dst = nhwc_out + r * C * H * W;
        for (int64_t c = 0; c < C; ++c)
            for (int64_t h = 0; h < H; ++h)
                for (int64_t w = 0; w < W; ++w)
                    dst[(h * W + w) * C + c] = px[c * H * W + h * W + w] * scale;
    }
}

// -------------------------------------------------------------- CSV parse
// ASCII float CSV (rows separated by \n, fields by `delim`) under a STRICT
// grammar that the NumPy twin's float() shares: exactly one value between
// delimiters, no empty field, no stray separator, every row as wide as the
// first.  Returns the number of values written, or -1 on malformed input;
// *n_cols_out receives the column count.
int64_t dl4j_parse_csv(const char* buf, int64_t len, char delim,
                       float* out, int64_t max_out, int64_t* n_cols_out) {
    int64_t n_vals = 0, cols = 0, row_cols = -1;
    const char* p = buf;
    const char* end = buf + len;
    auto end_row = [&]() -> bool {
        if (cols == 0) return true;  // blank line
        if (row_cols < 0) row_cols = cols;
        else if (cols != row_cols) return false;
        cols = 0;
        return true;
    };
    // in-row whitespace, which float() tolerates around a value
    auto skip_ws = [&]() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    };
    while (p < end) {
        skip_ws();
        if (p >= end) break;
        if (*p == '\n') {
            if (!end_row()) return -1;
            ++p;
            continue;
        }
        char* next = nullptr;
        float v = strtof(p, &next);
        if (next == p) return -1;  // empty field or not a number
        if (n_vals >= max_out) return -1;
        out[n_vals++] = v;
        ++cols;
        p = next;
        skip_ws();
        if (p >= end) break;
        if (*p == delim) {
            ++p;
            skip_ws();
            // a delimiter must be followed by another value on this row
            if (p >= end || *p == '\n' || *p == delim) return -1;
        } else if (*p == '\n') {
            if (!end_row()) return -1;
            ++p;
        } else {
            return -1;  // stray character
        }
    }
    if (cols > 0 && !end_row()) return -1;
    *n_cols_out = row_cols < 0 ? 0 : row_cols;
    return n_vals;
}

}  // extern "C"
