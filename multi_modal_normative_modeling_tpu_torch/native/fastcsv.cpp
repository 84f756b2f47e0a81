// fastcsv — multithreaded numeric CSV loader for the data plane.
//
// The reference's data layer funnels every modality table through
// pandas.read_csv on one core (utils.py:112-122); PPMI frames are
// 3485-column. This loader memory-maps the file, indexes row boundaries,
// and parses the requested feature columns with std::from_chars across a
// thread pool, filling a caller-provided row-major double buffer.
//
// C ABI (consumed from Python via ctypes — no pybind11 in this image):
//   fc_open(path)                  -> handle (parses header, indexes rows)
//   fc_num_rows / fc_num_cols      -> dimensions (rows exclude the header)
//   fc_col_index(handle, name)     -> column position or -1
//   fc_fill(handle, cols, n, out, n_threads) -> 0 ok / <0 error; out is
//       [rows x n] row-major doubles; unparsable cells become NaN
//   fc_read_strings(handle, col, buf, cap) -> '\n'-joined cell values;
//       returns required byte count (call twice to size the buffer)
//   fc_close(handle)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread fastcsv.cpp -o libfastcsv.so

#include <cctype>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <string_view>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct File {
    char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    std::vector<std::string> header;
    // byte offset of the start of each data row (header excluded)
    std::vector<size_t> row_starts;

    ~File() {
        if (data && data != MAP_FAILED) munmap(data, size);
        if (fd >= 0) close(fd);
    }
};

// Split one CSV record into string_views. RFC4180 quoted fields are fully
// supported: commas inside quotes, doubled "" escapes, and embedded newlines
// (the row index is quote-aware, see scan_unquoted_newlines / fc_open).
// Returned views keep their surrounding quotes; see unquote()/parse_cell.
void split_line(std::string_view line, std::vector<std::string_view>& out) {
    out.clear();
    size_t start = 0;
    const size_t n = line.size();
    while (true) {
        size_t pos = start;
        if (pos < n && line[pos] == '"') {
            ++pos;
            while (pos < n) {
                if (line[pos] == '"') {
                    if (pos + 1 < n && line[pos + 1] == '"') pos += 2;
                    else { ++pos; break; }
                } else {
                    ++pos;
                }
            }
        }
        size_t comma = line.find(',', pos);
        if (comma == std::string_view::npos) {
            out.push_back(line.substr(start));
            return;
        }
        out.push_back(line.substr(start, comma - start));
        start = comma + 1;
    }
}

// Strip surrounding quotes and collapse doubled "" escapes.
std::string unquote(std::string_view cell) {
    if (cell.size() < 2 || cell.front() != '"' || cell.back() != '"')
        return std::string(cell);
    cell = cell.substr(1, cell.size() - 2);
    std::string out;
    out.reserve(cell.size());
    for (size_t i = 0; i < cell.size(); ++i) {
        out.push_back(cell[i]);
        if (cell[i] == '"' && i + 1 < cell.size() && cell[i + 1] == '"') ++i;
    }
    return out;
}

// Walk [begin, end) with pandas-compatible CSV quoting semantics: a '"'
// opens a quoted field ONLY at field start (after ',' / record start); a
// stray quote inside an unquoted field is literal (pandas QUOTE_MINIMAL
// reads it verbatim); inside quotes, '""' is an escaped quote and a lone
// '"' closes the field. Newlines outside quotes end records.
// If stop_at_first: returns the offset of the first record-ending newline
// (or end). Otherwise appends every record-ending newline offset to *out
// and returns end.
size_t scan_unquoted_newlines(const char* data, size_t begin, size_t end,
                              bool stop_at_first,
                              std::vector<size_t>* out) {
    bool in_quote = false;
    bool at_field_start = true;
    for (size_t i = begin; i < end; ++i) {
        char c = data[i];
        if (in_quote) {
            if (c == '"') {
                if (i + 1 < end && data[i + 1] == '"') ++i;  // "" escape
                else { in_quote = false; at_field_start = false; }
            }
        } else if (c == '"' && at_field_start) {
            in_quote = true;
        } else if (c == ',') {
            at_field_start = true;
        } else if (c == '\n') {
            if (stop_at_first) return i;
            if (out) out->push_back(i);
            at_field_start = true;
        } else if (c != '\r') {
            at_field_start = false;
        }
    }
    return end;
}

std::string_view row_view(const File& f, size_t row) {
    size_t begin = f.row_starts[row];
    size_t end = (row + 1 < f.row_starts.size()) ? f.row_starts[row + 1]
                                                 : f.size;
    // trim trailing newline / carriage return
    while (end > begin && (f.data[end - 1] == '\n' || f.data[end - 1] == '\r'))
        --end;
    return std::string_view(f.data + begin, end - begin);
}

double parse_cell(std::string_view cell) {
    auto trim = [](std::string_view& c) {
        while (!c.empty() && std::isspace(static_cast<unsigned char>(c.front())))
            c.remove_prefix(1);
        while (!c.empty() && std::isspace(static_cast<unsigned char>(c.back())))
            c.remove_suffix(1);
    };
    trim(cell);
    // quoted numeric cell: strip the quotes (numbers never embed ""), then
    // trim again — '" 1.5 "' must parse like pandas does
    if (cell.size() >= 2 && cell.front() == '"' && cell.back() == '"') {
        cell = cell.substr(1, cell.size() - 2);
        trim(cell);
    }
    // from_chars rejects a leading '+' that pandas accepts
    if (!cell.empty() && cell.front() == '+') cell.remove_prefix(1);
    double value;
    auto result = std::from_chars(cell.data(), cell.data() + cell.size(), value);
    if (result.ec != std::errc() || result.ptr != cell.data() + cell.size())
        return std::nan("");
    return value;
}

}  // namespace

extern "C" {

void* fc_open(const char* path) {
    auto f = new File();
    f->fd = open(path, O_RDONLY);
    if (f->fd < 0) { delete f; return nullptr; }
    struct stat st;
    if (fstat(f->fd, &st) != 0 || st.st_size == 0) { delete f; return nullptr; }
    f->size = static_cast<size_t>(st.st_size);
    f->data = static_cast<char*>(
        mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0));
    if (f->data == MAP_FAILED) { delete f; return nullptr; }

    // header (a file may be header-only with no trailing newline: pandas
    // yields an empty 0-row frame for it, so must we). The scan is
    // quote-aware: a quoted header cell may embed a newline.
    size_t header_len = scan_unquoted_newlines(
        f->data, 0, f->size, /*stop_at_first=*/true, nullptr);
    bool have_rows = header_len < f->size;
    std::string_view header_line(f->data,
                                 header_len > 0 && f->data[header_len - 1] == '\r'
                                     ? header_len - 1 : header_len);
    std::vector<std::string_view> cells;
    split_line(header_line, cells);
    for (auto c : cells) f->header.push_back(unquote(c));
    if (!have_rows) return f;  // header-only: zero data rows

    // Index data-row starts, quote-aware so RFC4180 fields may embed
    // newlines. Quote-free files (the overwhelmingly common case for
    // numeric feature tables) take a chunk-parallel newline scan; any file
    // containing a '"' takes one serial pass of the pandas-semantics state
    // machine instead — quote state is inherently sequential once stray
    // unquoted quotes (which pandas reads as literals) are allowed, and
    // correctness beats the rare quoted file's index time (~0.2 s / 200 MB;
    // the threaded fc_fill still dominates).
    size_t begin = header_len + 1;
    size_t span = f->size > begin ? f->size - begin : 0;
    unsigned n_threads = span > (4u << 20) ? 16 : 1;
    std::vector<std::vector<size_t>> newlines(n_threads);
    std::vector<size_t> quote_count(n_threads, 0);
    size_t chunk = span / n_threads + 1;
    {
        std::vector<std::thread> pool;
        for (unsigned t = 0; t < n_threads; ++t) {
            pool.emplace_back([&, t] {
                size_t lo = begin + t * chunk;
                size_t hi = std::min(f->size, lo + chunk);
                for (size_t i = lo; i < hi; ++i) {
                    char c = f->data[i];
                    if (c == '\n') newlines[t].push_back(i);
                    else if (c == '"') ++quote_count[t];
                }
            });
        }
        for (auto& th : pool) th.join();
    }
    size_t total_quotes = 0;
    for (size_t q : quote_count) total_quotes += q;
    if (total_quotes > 0) {
        newlines.assign(1, {});
        scan_unquoted_newlines(f->data, begin, f->size,
                               /*stop_at_first=*/false, &newlines[0]);
    }
    f->row_starts.push_back(begin);
    for (auto& part : newlines)
        for (size_t nl_pos : part)
            if (nl_pos + 1 < f->size) f->row_starts.push_back(nl_pos + 1);
    // skip blank lines anywhere, like pandas' skip_blank_lines=True (a
    // kept row's view may then span the dropped line's bytes, but
    // row_view trims every trailing '\n'/'\r')
    {
        std::vector<size_t> kept;
        kept.reserve(f->row_starts.size());
        for (size_t r = 0; r < f->row_starts.size(); ++r)
            if (!row_view(*f, r).empty()) kept.push_back(f->row_starts[r]);
        f->row_starts = std::move(kept);
    }
    return f;
}

int64_t fc_num_rows(void* handle) {
    return static_cast<File*>(handle)->row_starts.size();
}

int64_t fc_num_cols(void* handle) {
    return static_cast<File*>(handle)->header.size();
}

int32_t fc_col_index(void* handle, const char* name) {
    auto* f = static_cast<File*>(handle);
    for (size_t i = 0; i < f->header.size(); ++i)
        if (f->header[i] == name) return static_cast<int32_t>(i);
    return -1;
}

int32_t fc_fill(void* handle, const int32_t* col_indices, int32_t n_cols,
                double* out, int32_t n_threads) {
    auto* f = static_cast<File*>(handle);
    const size_t rows = f->row_starts.size();
    const size_t total_cols = f->header.size();
    for (int32_t j = 0; j < n_cols; ++j)
        if (col_indices[j] < 0 ||
            static_cast<size_t>(col_indices[j]) >= total_cols)
            return -1;
    if (n_threads <= 0)
        n_threads = static_cast<int32_t>(
            std::min<size_t>(std::thread::hardware_concurrency(), 16));
    n_threads = std::max(1, n_threads);

    auto worker = [&](size_t begin, size_t end) {
        std::vector<std::string_view> cells;
        cells.reserve(total_cols);
        for (size_t r = begin; r < end; ++r) {
            split_line(row_view(*f, r), cells);
            double* dst = out + r * static_cast<size_t>(n_cols);
            for (int32_t j = 0; j < n_cols; ++j) {
                size_t ci = static_cast<size_t>(col_indices[j]);
                dst[j] = ci < cells.size() ? parse_cell(cells[ci])
                                           : std::nan("");
            }
        }
    };

    if (n_threads == 1 || rows < 1024) {
        worker(0, rows);
        return 0;
    }
    std::vector<std::thread> pool;
    size_t chunk = (rows + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        size_t begin = t * chunk;
        if (begin >= rows) break;
        pool.emplace_back(worker, begin, std::min(rows, begin + chunk));
    }
    for (auto& th : pool) th.join();
    return 0;
}

// Extract only the n-th comma-separated field of a line (no full split;
// quote-aware like split_line).
static std::string_view nth_field(std::string_view line, int32_t n) {
    size_t start = 0;
    for (int32_t i = 0;; ++i) {
        size_t pos = start;
        if (pos < line.size() && line[pos] == '"') {
            ++pos;
            while (pos < line.size()) {
                if (line[pos] == '"') {
                    if (pos + 1 < line.size() && line[pos + 1] == '"') pos += 2;
                    else { ++pos; break; }
                } else {
                    ++pos;
                }
            }
        }
        size_t comma = line.find(',', pos);
        if (i == n)
            return line.substr(start, comma == std::string_view::npos
                                          ? std::string_view::npos
                                          : comma - start);
        if (comma == std::string_view::npos) return {};
        start = comma + 1;
    }
}

int64_t fc_read_strings(void* handle, int32_t col, char* buf, int64_t cap) {
    auto* f = static_cast<File*>(handle);
    if (col < 0 || static_cast<size_t>(col) >= f->header.size()) return -1;
    int64_t needed = 0;
    for (size_t r = 0; r < f->row_starts.size(); ++r) {
        std::string cell = unquote(nth_field(row_view(*f, r), col));
        if (buf && needed + static_cast<int64_t>(cell.size()) + 1 <= cap) {
            memcpy(buf + needed, cell.data(), cell.size());
            buf[needed + cell.size()] = '\n';
        }
        needed += cell.size() + 1;
    }
    return needed;
}

void fc_close(void* handle) {
    delete static_cast<File*>(handle);
}

}  // extern "C"
