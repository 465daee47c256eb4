// fastio — native numeric-table IO for the chain-file hot path.
//
// The reference (pure Julia) has no native components (SURVEY.md §2); this
// is part of the NEW framework's runtime layer: mcmc chain tables are
// (chains x draws) rows by (n_obs + ~8) float columns — at n=50k that is
// gigabytes of text per run, and generic CSV machinery becomes the CLI
// bottleneck.  This translation unit does exactly one job fast:
// all-numeric delimited tables, single pass, no allocations per field.
//
// The PyTorch/CUDA port's own copy of gaplac_tpu/native/fastio.cpp: it reads
// and writes the same tables and bytes; bound by gaplac_tpu_torch/data/fastio.py.
//
// Exposed C ABI (ctypes-friendly):
//   fastio_read  : parse file -> malloc'd row-major double buffer
//   fastio_write : double buffer -> file with %.17g fields
//   fastio_free  : release the read buffer
//
// Errors are negative return codes; code -3 (non-numeric field) sends a
// mixed-type table to pandas on the Python side.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cerrno>
#include <cmath>
#include <vector>

extern "C" {

// returns 0 on success; -1 io error, -2 empty/shape error, -3 non-numeric
int fastio_read(const char* path, char delim,
                double** out_data, long* out_rows, long* out_cols,
                char** out_header) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    if (size <= 0) { std::fclose(f); return -2; }

    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (std::fread(buf.data(), 1, static_cast<size_t>(size), f) != static_cast<size_t>(size)) {
        std::fclose(f); return -1;
    }
    std::fclose(f);
    buf[static_cast<size_t>(size)] = '\0';

    // header line
    char* p = buf.data();
    char* hdr_end = std::strchr(p, '\n');
    if (!hdr_end) return -2;
    long hdr_len = static_cast<long>(hdr_end - p);
    char* header = static_cast<char*>(std::malloc(static_cast<size_t>(hdr_len) + 1));
    if (!header) return -1;
    std::memcpy(header, p, static_cast<size_t>(hdr_len));
    // strip trailing \r
    while (hdr_len > 0 && header[hdr_len - 1] == '\r') hdr_len--;
    header[hdr_len] = '\0';

    long cols = 1;
    for (long i = 0; i < hdr_len; ++i) if (header[i] == delim) ++cols;

    // count data rows (non-empty lines after the header)
    long rows = 0;
    for (char* q = hdr_end + 1; *q; ) {
        char* nl = std::strchr(q, '\n');
        char* end = nl ? nl : buf.data() + size;
        if (end > q && !(end == q + 1 && *q == '\r')) ++rows;
        if (!nl) break;
        q = nl + 1;
    }
    if (rows == 0) { std::free(header); return -2; }

    double* data = static_cast<double*>(std::malloc(sizeof(double) *
                       static_cast<size_t>(rows) * static_cast<size_t>(cols)));
    if (!data) { std::free(header); return -1; }

    char* q = hdr_end + 1;
    long r = 0;
    while (*q && r < rows) {
        char* nl = std::strchr(q, '\n');
        char* line_end = nl ? nl : buf.data() + size;
        if (line_end == q || (line_end == q + 1 && *q == '\r')) {  // blank line
            q = nl ? nl + 1 : line_end;
            continue;
        }
        char* field = q;
        for (long c = 0; c < cols; ++c) {
            // missing trailing fields: strtod would skip the newline and
            // silently consume the NEXT row's value — guard on line_end first
            char* scan = field;
            while (scan < line_end && (*scan == ' ' || *scan == '\r')) ++scan;
            double v;
            char* endp;
            if (scan >= line_end || *scan == delim) {
                v = NAN;
                endp = scan;
            } else {
                endp = nullptr;
                errno = 0;
                v = std::strtod(scan, &endp);
                if (endp == scan || endp > line_end) {
                    std::free(data); std::free(header);
                    return -3;
                }
            }
            data[r * cols + c] = v;
            // advance to the next delimiter
            field = endp;
            while (field < line_end && *field != delim) {
                if (*field != '\r' && *field != ' ') {
                    std::free(data); std::free(header);
                    return -3;
                }
                ++field;
            }
            if (field < line_end) ++field;  // skip the delimiter
        }
        // reject rows with MORE fields than the header (silently dropping
        // trailing values would mis-read malformed tables; the pandas
        // fallback surfaces the shape mismatch, so must we)
        while (field < line_end && (*field == ' ' || *field == '\r')) ++field;
        if (field < line_end) {
            std::free(data); std::free(header);
            return -3;
        }
        ++r;
        q = nl ? nl + 1 : line_end;
    }

    *out_data = data;
    *out_rows = r;
    *out_cols = cols;
    *out_header = header;
    return 0;
}

void fastio_free(double* p) { std::free(p); }
void fastio_free_str(char* p) { std::free(p); }

// write a row-major double table with a header line; returns 0 or -1
int fastio_write(const char* path, char delim, const char* header,
                 const double* data, long rows, long cols) {
    FILE* f = std::fopen(path, "wb");
    if (!f) return -1;
    std::fputs(header, f);
    std::fputc('\n', f);
    // chunked formatting: one snprintf per field into a line buffer
    std::vector<char> line(static_cast<size_t>(cols) * 32 + 16);
    for (long r = 0; r < rows; ++r) {
        char* w = line.data();
        for (long c = 0; c < cols; ++c) {
            if (c) *w++ = delim;
            double v = data[r * cols + c];
            // range-check BEFORE the cast: double->long long is UB for
            // NaN/inf/|v| >= 2^63 ([conv.fpint])
            if (std::fabs(v) < 1e15 && v == static_cast<long long>(v)) {
                w += std::snprintf(w, 32, "%.1f", v);
            } else {
                w += std::snprintf(w, 32, "%.17g", v);
            }
        }
        *w++ = '\n';
        if (std::fwrite(line.data(), 1, static_cast<size_t>(w - line.data()), f)
            != static_cast<size_t>(w - line.data())) {
            std::fclose(f); return -1;
        }
    }
    std::fclose(f);
    return 0;
}

}  // extern "C"
