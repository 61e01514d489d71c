// Native host-side data engine: parallel .npy feature reader + Entry packer.
//
// The reference's training loop spends its host time in per-frame
// np.load(dets.npy/feat.npy) calls and python packing loops
// (lib/assign_pseudo_label.py:27-45, 1226-1295). This library replaces that
// hot path with:
//   * a minimal .npy (v1/v2) parser for float32 C-contiguous 2-D arrays,
//   * a std::thread pool that reads a whole video's frame features in
//     parallel straight into one caller-owned padded buffer,
//   * a row packer that pads/truncates into bucket shapes without
//     intermediate copies.
//
// Exposed as a C ABI for ctypes (no Python headers needed to build).
// The port's copy of nl_vsgg_tpu/native/io.cpp.
// Build: see nl_vsgg_tpu_torch/utils/native_io.py (g++ -O3 -shared -fPIC).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Parse a .npy header for a float32, C-order, 2-D array.
// Returns true on success; fills rows/cols and the data offset.
bool parse_npy_header(FILE* f, int64_t* rows, int64_t* cols, long* data_off) {
    unsigned char magic[8];
    if (fread(magic, 1, 8, f) != 8) return false;
    if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
    int major = magic[6];
    uint32_t header_len = 0;
    if (major == 1) {
        unsigned char b[2];
        if (fread(b, 1, 2, f) != 2) return false;
        header_len = b[0] | (b[1] << 8);
        *data_off = 10 + header_len;
    } else {
        unsigned char b[4];
        if (fread(b, 1, 4, f) != 4) return false;
        header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
        *data_off = 12 + header_len;
    }
    std::string header(header_len, '\0');
    if (fread(header.data(), 1, header_len, f) != header_len) return false;
    if (header.find("'<f4'") == std::string::npos &&
        header.find("'float32'") == std::string::npos)
        return false;
    if (header.find("'fortran_order': False") == std::string::npos)
        return false;
    auto sp = header.find("'shape':");
    if (sp == std::string::npos) return false;
    auto lp = header.find('(', sp);
    auto rp = header.find(')', lp);
    if (lp == std::string::npos || rp == std::string::npos) return false;
    std::string shape = header.substr(lp + 1, rp - lp - 1);
    long long r = 0, c = 1;
    if (sscanf(shape.c_str(), "%lld, %lld", &r, &c) < 1) return false;
    // 1-D arrays parse as (r,) -> cols 1
    *rows = r;
    *cols = c == 0 ? 1 : c;
    return true;
}

// Read one float32 .npy into out (capacity max_rows*cols floats).
// Returns the file's TRUE row count (reading at most max_rows rows), or -1
// on failure — a return value > max_rows signals truncation, which the
// Python wrapper must surface (silent loss would be undetectable).
int64_t read_npy_f32(const char* path, float* out, int64_t max_rows,
                     int64_t expect_cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    int64_t rows, cols;
    long off;
    if (!parse_npy_header(f, &rows, &cols, &off) || cols != expect_cols) {
        fclose(f);
        return -1;
    }
    int64_t n = rows < max_rows ? rows : max_rows;
    if (fseek(f, off, SEEK_SET) != 0) { fclose(f); return -1; }
    size_t want = (size_t)(n * cols);
    size_t got = fread(out, sizeof(float), want, f);
    fclose(f);
    return got == want ? rows : -1;
}

}  // namespace

extern "C" {

// Read n_files float32 2-D .npy files (each rows_i x cols) in parallel into
// one contiguous output buffer laid out as consecutive row blocks at
// offsets[i] (row units). counts[i] <- rows read (or -1 on error).
// paths: concatenated NUL-separated strings.
void read_npy_batch_f32(const char* paths, int n_files, int64_t cols,
                        float* out, const int64_t* offsets,
                        const int64_t* max_rows, int64_t* counts,
                        int n_threads) {
    std::vector<const char*> ptrs(n_files);
    const char* p = paths;
    for (int i = 0; i < n_files; ++i) {
        ptrs[i] = p;
        p += strlen(p) + 1;
    }
    std::atomic<int> next(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n_files) return;
            counts[i] = read_npy_f32(ptrs[i], out + offsets[i] * cols,
                                     max_rows[i], cols);
        }
    };
    int nt = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
    if (nt > n_files) nt = n_files;
    if (nt < 1) nt = 1;
    std::vector<std::thread> threads;
    threads.reserve(nt);
    for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
    for (auto& t : threads) t.join();
}

// Pack ragged rows into a padded bucket: src is (total_rows, cols) dense,
// row_counts gives each segment's length; each segment lands at
// dst + seg_index*bucket_rows*cols, zero-padded to bucket_rows.
void pack_padded_f32(const float* src, const int64_t* row_counts,
                     int n_segments, int64_t cols, int64_t bucket_rows,
                     float* dst) {
    int64_t src_off = 0;
    for (int s = 0; s < n_segments; ++s) {
        int64_t n = row_counts[s];
        int64_t keep = n < bucket_rows ? n : bucket_rows;
        float* d = dst + (int64_t)s * bucket_rows * cols;
        memcpy(d, src + src_off * cols, (size_t)(keep * cols) * sizeof(float));
        if (keep < bucket_rows)
            memset(d + keep * cols, 0,
                   (size_t)((bucket_rows - keep) * cols) * sizeof(float));
        src_off += n;
    }
}

}  // extern "C"
