// Fast whitespace-separated float table parser for .xyz LiDAR files.
//
// The port's copy of the JAX package's parser (the same C ABI, the same
// rules).  The reference ingests with np.loadtxt (datasets/building3d.py:99),
// a Python-level line loop; this parser is a single pass of strtod over a
// read-once buffer.  The JAX package claims ~40x over np.loadtxt; the
// port's measured ratio is in PERF.md (chip_smoke.py's parser phase).
//
// C ABI (consumed via ctypes from wireframe_tpu_torch.io.native):
//   parse_xyz(path, &data, &rows, &cols) -> 0 on success
//     data: malloc'd row-major double buffer of rows*cols — caller frees
//           via free_xyz_buffer.
//   Column count is inferred from the first non-empty line; any line
//   with a different field count aborts with a nonzero code (caller
//   falls back to np.loadtxt).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cctype>

extern "C" {

int parse_xyz(const char* path, double** out_data, long* out_rows,
              long* out_cols) {
    *out_data = nullptr;
    *out_rows = 0;
    *out_cols = 0;

    FILE* f = std::fopen(path, "rb");
    if (!f) return 1;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return 2; }
    if (std::fread(buf, 1, size, f) != static_cast<size_t>(size)) {
        std::free(buf);
        std::fclose(f);
        return 3;
    }
    std::fclose(f);
    buf[size] = '\0';

    // Infer column count from the first non-empty line.
    long cols = 0;
    {
        const char* p = buf;
        while (*p == '\n' || *p == '\r') ++p;
        const char* line_end = std::strchr(p, '\n');
        if (!line_end) line_end = buf + size;
        bool in_field = false;
        for (const char* q = p; q < line_end; ++q) {
            bool ws = (*q == ' ' || *q == '\t' || *q == '\r');
            if (!ws && !in_field) { ++cols; in_field = true; }
            else if (ws) in_field = false;
        }
    }
    if (cols == 0) { std::free(buf); return 4; }

    // Count newlines for an upper bound on rows, then parse.
    long max_rows = 1;
    for (long i = 0; i < size; ++i)
        if (buf[i] == '\n') ++max_rows;

    double* data = static_cast<double*>(
        std::malloc(sizeof(double) * max_rows * cols));
    if (!data) { std::free(buf); return 2; }

    // Single strtod pass.  Line boundaries are tracked explicitly (strtod
    // would otherwise eat newlines as leading whitespace): any non-empty
    // line whose field count differs from the inferred `cols` aborts —
    // compensating ragged rows (7 then 9 fields) must NOT silently shift
    // values into the wrong row/column.
    char* p = buf;
    char* end = buf + size;
    long n = 0;            // total values parsed
    long line_fields = 0;  // fields on the current line
    while (p < end) {
        char c = *p;
        if (c == '\n') {
            if (line_fields != 0 && line_fields != cols) {
                std::free(buf);
                std::free(data);
                return 7;
            }
            line_fields = 0;
            ++p;
            continue;
        }
        if (c == ' ' || c == '\t' || c == '\r') {
            ++p;
            continue;
        }
        char* next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) {  // junk token: skip one char
            ++p;
            continue;
        }
        if (n >= max_rows * cols) { std::free(buf); std::free(data); return 5; }
        data[n++] = v;
        ++line_fields;
        p = next;
    }
    std::free(buf);
    if (line_fields != 0 && line_fields != cols) {  // last line, no '\n'
        std::free(data);
        return 7;
    }

    if (n == 0 || n % cols != 0) { std::free(data); return 6; }
    *out_data = data;
    *out_rows = n / cols;
    *out_cols = cols;
    return 0;
}

void free_xyz_buffer(double* data) { std::free(data); }

}  // extern "C"
