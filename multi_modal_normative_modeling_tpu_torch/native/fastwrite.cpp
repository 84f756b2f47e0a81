// fastwrite — multithreaded CSV writer for the deviation emitters.
//
// The test stage emits ~200 wide CSVs per experiment; pandas' to_csv
// stringifies every float through Python objects on one core and dominates
// large-cohort runs (RESULTS.md). This writer formats float64/float32 with
// std::to_chars (shortest round-trip — the same representation Python's
// repr/pandas produce for these dtypes) across a thread pool and writes one
// buffer per chunk.
//
// C ABI (ctypes):
//   fw_write_csv(path, header, n_rows, n_cols, col_types, col_data,
//                str_blobs, n_threads) -> 0 ok / <0 error
//     col_types[i]: 0 = float64 (col_data[i] -> double*)
//                   1 = float32 (col_data[i] -> float*)
//                   2 = int64   (col_data[i] -> int64_t*)
//                   3 = string  (str_blobs[i] -> '\n'-joined bytes)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread fastwrite.cpp -o libfastwrite.so

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <vector>

namespace {

struct Column {
    int32_t type;
    const void* data;
    std::vector<std::string_view> strings;  // for type 3
};

// Render shortest-round-trip digits with the notation policy pandas emits:
//  * float64 (python_policy=true): CPython repr (pystrtod.c 'r') — fixed
//    when -4 < decimal_point <= 16, else scientific.
//  * float32 (python_policy=false): numpy scalar str — fixed when
//    decimal_point in (0, 16]; for decimal_point <= 0 scientific only when
//    STRICTLY shorter than positional (so 0.00025 stays fixed but 0.0001
//    becomes 1e-04).
// Both use a sign and >=2 exponent digits; integral fixed values get ".0".
template <bool python_policy, typename T>
inline void append_repr(std::string& out, T v) {
    if (std::isnan(v)) return;  // pandas writes empty for NaN
    if (std::isinf(v)) {
        out.append(v < 0 ? "-inf" : "inf");
        return;
    }
    if (v == 0) {
        if (std::signbit(v)) out.push_back('-');
        out.append("0.0");
        return;
    }
    char buf[48];
    auto res = std::to_chars(buf, buf + sizeof(buf), v,
                             std::chars_format::scientific);
    // parse "[-]d[.ddd]e±xx" into digits + exp10
    const char* p = buf;
    if (*p == '-') { out.push_back('-'); ++p; }
    char digits[32];
    int n_digits = 0;
    int exp10 = 0;
    for (; p < res.ptr; ++p) {
        if (*p == '.') continue;
        if (*p == 'e') {
            // bounded parse: to_chars output is NOT null-terminated
            const char* ep = p + 1;
            if (*ep == '+') ++ep;  // from_chars rejects leading '+'
            std::from_chars(ep, res.ptr, exp10);
            break;
        }
        digits[n_digits++] = *p;
    }
    int decimal_point = exp10 + 1;
    // lengths (excluding sign): positional vs scientific
    int exp_abs = exp10 < 0 ? -exp10 : exp10;
    int exp_len = exp_abs >= 100 ? 3 : 2;
    int sci_len = n_digits + (n_digits > 1 ? 1 : 0) + 2 + exp_len;
    bool fixed;
    if (python_policy) {
        fixed = (-4 < decimal_point && decimal_point <= 16);
    } else if (decimal_point > 0) {
        fixed = decimal_point <= 16;
    } else {
        int pos_len = 2 - decimal_point + n_digits;  // "0." + zeros + digits
        fixed = sci_len >= pos_len;
    }
    if (fixed) {
        if (decimal_point <= 0) {
            out.append("0.");
            out.append(-decimal_point, '0');
            out.append(digits, n_digits);
        } else if (decimal_point >= n_digits) {
            out.append(digits, n_digits);
            out.append(decimal_point - n_digits, '0');
            out.append(".0");
        } else {
            out.append(digits, decimal_point);
            out.push_back('.');
            out.append(digits + decimal_point, n_digits - decimal_point);
        }
    } else {
        out.push_back(digits[0]);
        if (n_digits > 1) {
            out.push_back('.');
            out.append(digits + 1, n_digits - 1);
        }
        out.push_back('e');
        out.push_back(exp10 < 0 ? '-' : '+');
        char ebuf[8];
        auto eres = std::to_chars(ebuf, ebuf + sizeof(ebuf), exp_abs);
        if (eres.ptr - ebuf < 2) out.push_back('0');
        out.append(ebuf, eres.ptr);
    }
}

inline void append_double(std::string& out, double v) {
    append_repr<true>(out, v);
}

inline void append_float(std::string& out, float v) {
    append_repr<false>(out, v);
}

inline void append_int(std::string& out, int64_t v) {
    char buf[24];
    auto res = std::to_chars(buf, buf + sizeof(buf), v);
    out.append(buf, res.ptr);
}

}  // namespace

extern "C" {

int32_t fw_write_csv(const char* path, const char* header, int64_t n_rows,
                     int32_t n_cols, const int32_t* col_types,
                     const void* const* col_data,
                     const char* const* str_blobs, int32_t n_threads) {
    std::vector<Column> columns(n_cols);
    for (int32_t c = 0; c < n_cols; ++c) {
        columns[c].type = col_types[c];
        columns[c].data = col_data[c];
        if (col_types[c] == 3) {
            std::string_view blob(str_blobs[c]);
            columns[c].strings.reserve(n_rows);
            size_t start = 0;
            for (int64_t r = 0; r < n_rows; ++r) {
                size_t nl = blob.find('\n', start);
                columns[c].strings.push_back(
                    blob.substr(start, nl == std::string_view::npos
                                           ? std::string_view::npos
                                           : nl - start));
                start = (nl == std::string_view::npos) ? blob.size() : nl + 1;
            }
        }
    }

    if (n_threads <= 0) n_threads = 16;
    int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    if (chunk < 256) { n_threads = 1; chunk = n_rows; }
    std::vector<std::string> buffers(n_threads);
    std::vector<char> worker_failed(n_threads, 0);

    auto worker = [&](int32_t t) {
        int64_t begin = t * chunk;
        int64_t end = std::min<int64_t>(n_rows, begin + chunk);
        if (begin >= end) return;
        std::string& out = buffers[t];
        out.reserve(static_cast<size_t>(end - begin) * n_cols * 20);
        for (int64_t r = begin; r < end; ++r) {
            for (int32_t c = 0; c < n_cols; ++c) {
                if (c) out.push_back(',');
                const Column& col = columns[c];
                switch (col.type) {
                    case 0:
                        append_double(out,
                                      static_cast<const double*>(col.data)[r]);
                        break;
                    case 1:
                        append_float(out,
                                     static_cast<const float*>(col.data)[r]);
                        break;
                    case 2:
                        append_int(out,
                                   static_cast<const int64_t*>(col.data)[r]);
                        break;
                    case 3: {
                        std::string_view s = col.strings[r];
                        out.append(s.data(), s.size());
                        break;
                    }
                    default:
                        // unknown type: flag it — nothing may be written
                        worker_failed[t] = 1;
                        return;
                }
            }
            out.push_back('\n');
        }
    };

    if (n_threads == 1) {
        worker(0);
    } else {
        std::vector<std::thread> pool;
        for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker, t);
        for (auto& th : pool) th.join();
    }

    for (char failed : worker_failed)
        if (failed) return -3;  // refuse to write truncated buffers

    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fwrite(header, 1, std::strlen(header), f);
    std::fwrite("\n", 1, 1, f);
    for (auto& buf : buffers)
        if (!buf.empty() && std::fwrite(buf.data(), 1, buf.size(), f)
                                != buf.size()) {
            std::fclose(f);
            return -2;
        }
    std::fclose(f);
    return 0;
}

}  // extern "C"
