// Host-side codecs of the port: the training masters' gradient codec
// (threshold and bitmap encoding of a flat f32 update, with the residual
// the encoding leaves) and the data readers' decodes (u8 pixels to f32,
// CIFAR-10 binary records to NHWC floats, strict float CSV) and the
// embedding trainers' corpus indexer (tokenize + vocab-index a sentence
// corpus in one pass).
//
// The port's own copy of the JAX package's native library (the same
// functions and C interface).  None of it is a device kernel: the
// masters' EncodingHandler runs the codec on the host right before a
// message leaves the process, the data fetchers decode on the host
// before a batch exists, and the corpus indexer turns text into the
// index arrays the embedding trainers ship to the card (utils/native.py
// builds the library with g++ at first use).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libdl4j_torch_codec.so \
//            host_codec.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <string>
#include <string_view>
#include <unordered_map>
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


// ------------------------------------------------------------ corpus index
// Tokenize + vocab-index a sentence corpus in one pass — the native
// data-loader role the reference delegates to DataVec/libnd4j.  The bulk
// embedding paths (SequenceVectors) are bound by host emission; this
// replaces the per-sentence Python split + dict.get loop.
//
// Token semantics mirror Python str.split(): tokens are maximal runs of
// non-whitespace.  Only ASCII whitespace is handled natively; if any
// Unicode whitespace codepoint appears (which str.split would also treat
// as a separator) the function returns -2 and the caller falls back to
// the Python path — the two paths must tokenize identically or not at all.
//
// text:        concatenated UTF-8 sentences (no separators needed).
// sent_offsets int64[n_sent+1] byte offsets delimiting each sentence.
// vocab_blob:  vocabulary words joined by '\n', in index order 0..V-1
//              (words cannot contain whitespace by construction).
// out_idx:     int32 buffer of capacity out_cap.
// out_counts:  int64[n_sent] — IN-VOCAB tokens per sentence (OOV skipped,
//              matching the Python path's arr[arr >= 0] filter).
// Returns total in-vocab tokens written, -2 on unicode-whitespace bail,
// -3 when out_cap would overflow (caller falls back — never writes past).
int64_t dl4j_index_corpus(const char* text, const int64_t* sent_offsets,
                          int64_t n_sent, const char* vocab_blob,
                          int64_t vocab_len, int32_t* out_idx,
                          int64_t out_cap, int64_t* out_counts) {
    std::unordered_map<std::string_view, int32_t> vocab;
    {
        int32_t idx = 0;
        const char* p = vocab_blob;
        const char* end = vocab_blob + vocab_len;
        while (p < end) {
            const char* nl = static_cast<const char*>(
                memchr(p, '\n', static_cast<size_t>(end - p)));
            const char* stop = nl ? nl : end;
            vocab.emplace(std::string_view(p, static_cast<size_t>(stop - p)),
                          idx++);
            p = nl ? nl + 1 : end;
        }
    }
    // str.split's ASCII whitespace set: space, \t-\r, AND the information
    // separators 0x1C-0x1F (FS/GS/RS/US — Python treats them as whitespace)
    auto is_ws = [](unsigned char c) {
        return c == ' ' || (c >= '\t' && c <= '\r')
            || (c >= 0x1C && c <= 0x1F);
    };
    // UTF-8 sequences of the Unicode whitespace str.split also strips:
    // U+0085 U+00A0 U+1680 U+2000-200A U+2028 U+2029 U+202F U+205F U+3000
    auto unicode_ws_at = [](const unsigned char* p, const unsigned char* end) {
        if (p + 1 < end && p[0] == 0xC2 && (p[1] == 0x85 || p[1] == 0xA0))
            return true;
        if (p + 2 < end) {
            if (p[0] == 0xE1 && p[1] == 0x9A && p[2] == 0x80) return true;
            if (p[0] == 0xE2 && p[1] == 0x80 &&
                ((p[2] >= 0x80 && p[2] <= 0x8A) || p[2] == 0xA8 ||
                 p[2] == 0xA9 || p[2] == 0xAF)) return true;
            if (p[0] == 0xE2 && p[1] == 0x81 && p[2] == 0x9F) return true;
            if (p[0] == 0xE3 && p[1] == 0x80 && p[2] == 0x80) return true;
        }
        return false;
    };
    int64_t total = 0;
    for (int64_t s = 0; s < n_sent; ++s) {
        const unsigned char* p = reinterpret_cast<const unsigned char*>(
            text + sent_offsets[s]);
        const unsigned char* end = reinterpret_cast<const unsigned char*>(
            text + sent_offsets[s + 1]);
        int64_t count = 0;
        while (p < end) {
            while (p < end && is_ws(*p)) ++p;
            if (p >= end) break;
            if (unicode_ws_at(p, end)) return -2;
            const unsigned char* start = p;
            while (p < end && !is_ws(*p)) {
                if (*p >= 0x80 && unicode_ws_at(p, end)) return -2;
                ++p;
            }
            auto it = vocab.find(std::string_view(
                reinterpret_cast<const char*>(start),
                static_cast<size_t>(p - start)));
            if (it != vocab.end()) {
                if (total >= out_cap) return -3;  // never write past the buf
                out_idx[total++] = it->second;
                ++count;
            }
        }
        out_counts[s] = count;
    }
    return total;
}

}  // extern "C"
