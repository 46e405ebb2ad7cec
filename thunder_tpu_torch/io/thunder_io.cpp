// thunder_io: the port's host data-loading runtime, as thunder_tpu's
// native IO library (the same functions, results and error codes).
//
// The reference's data layer is C++ (src/Database.cpp .thu parsing,
// src/Image/ImageFile.cpp MRC reads with the MESH_* ifftshift remap,
// include/Image/ImageFile.h:383).  This library gives the two host-side
// paths that every run reads its particles through:
//
//   * thu_count / thu_parse: 27-column .thu table -> numeric block
//     (strtod, no per-field Python work)
//   * mrc_open / mrc_read_slices: header-checked, multithreaded slice
//     reads from MRC2014 stacks with an optional ifftshift remap into the
//     framework's internal FFT layout (float32 out, modes 0/1/2/6)
//
// C ABI only, bound with ctypes by io/native.py, which builds it at first
// use with the host's C++ compiler.  No CUDA: the reads are bound by the
// disk and host memory.
//
// Threads: a plain std::thread fan-out per call; particle stacks are read
// once a run, so a pool is not worth keeping.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- .thu

// Count data lines in a .thu file.  Lines whose first non-space char is
// '#' are comments: the reference writes them as column headers in saved
// Meta_Round_xxx.thu files and strips them on read (Database.cpp:66-85).
// Returns -1 when the file cannot be opened.
long thu_count(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    long n = 0;
    int c;
    bool line_has_content = false;
    bool is_comment = false;
    while ((c = fgetc(f)) != EOF) {
        if (c == '\n') {
            if (line_has_content && !is_comment) n++;
            line_has_content = false;
            is_comment = false;
        } else if (c != ' ' && c != '\t' && c != '\r') {
            if (!line_has_content && c == '#') is_comment = true;
            line_has_content = true;
        }
    }
    if (line_has_content && !is_comment) n++;
    fclose(f);
    return n;
}

// Parse a .thu file: the 25 numeric columns (0-6 and 9-26) into `numeric`
// (rows x 25 doubles, row-major, in file order without the two path
// columns), and the two path columns 7 and 8 into `paths` (2 * rows
// C-strings packed back to back, each NUL-terminated: particle path, then
// micrograph path, a row).  `paths_cap` is the byte capacity of `paths`;
// `numeric` holds thu_count(path) rows.  A line is read whole (getline),
// as thu_count counts it, so a parse never yields more rows than the
// count.  Returns the rows parsed, or -1 on an error (no file, a row
// without 27 columns, paths past `paths_cap`).
long thu_parse(const char* path, double* numeric, char* paths,
               long paths_cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    char* line = nullptr;
    size_t line_cap = 0;
    long row = 0;
    long pofs = 0;
    bool bad = false;
    while (!bad && getline(&line, &line_cap, f) != -1) {
        char* s = line;
        while (*s == ' ' || *s == '\t' || *s == '\r') s++;
        if (*s == '#') continue;         // comment line (see thu_count)
        int col = 0;
        int ncol = 0;
        double* out = numeric + row * 25;
        while (*s) {
            while (*s == ' ' || *s == '\t' || *s == '\r' || *s == '\n') s++;
            if (!*s) break;
            char* tok = s;
            while (*s && *s != ' ' && *s != '\t' && *s != '\r' && *s != '\n') s++;
            long len = s - tok;
            if (col == 7 || col == 8) {
                if (pofs + len + 1 > paths_cap) { bad = true; break; }
                memcpy(paths + pofs, tok, len);
                paths[pofs + len] = 0;
                pofs += len + 1;
            } else if (col < 27) {
                char saved = *s;
                *s = 0;
                out[ncol++] = strtod(tok, nullptr);
                *s = saved;
            }
            col++;
        }
        if (bad || col == 0) continue;   // an error, or a blank line
        if (col != 27) bad = true;
        else row++;
    }
    free(line);
    fclose(f);
    return bad ? -1 : row;
}

// ---------------------------------------------------------------- MRC

struct MrcInfo {
    int32_t nx, ny, nz, mode;
    int32_t mx, my, mz;
    float cella_x, cella_y, cella_z;
    int32_t nsymbt;
};

// Read and validate an MRC header.  Returns 0 on success, -1 when the
// file cannot be opened, -2 when it is shorter than a header, -3 on a
// non-positive size, -4 on a mode other than 0, 1, 2 or 6.
int mrc_open(const char* path, MrcInfo* info) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    unsigned char hdr[1024];
    if (fread(hdr, 1, 1024, f) != 1024) { fclose(f); return -2; }
    fclose(f);
    memcpy(&info->nx, hdr + 0, 4);
    memcpy(&info->ny, hdr + 4, 4);
    memcpy(&info->nz, hdr + 8, 4);
    memcpy(&info->mode, hdr + 12, 4);
    memcpy(&info->mx, hdr + 28, 4);
    memcpy(&info->my, hdr + 32, 4);
    memcpy(&info->mz, hdr + 36, 4);
    memcpy(&info->cella_x, hdr + 40, 4);
    memcpy(&info->cella_y, hdr + 44, 4);
    memcpy(&info->cella_z, hdr + 48, 4);
    memcpy(&info->nsymbt, hdr + 92, 4);
    if (info->nx <= 0 || info->ny <= 0 || info->nz < 0) return -3;
    if (info->mode != 0 && info->mode != 1 && info->mode != 2 &&
        info->mode != 6)
        return -4;
    return 0;
}

}  // extern "C" (reopened below; templates need C++ linkage)

static size_t mode_bytes(int mode) {
    switch (mode) {
        case 0: return 1;
        case 1: case 6: return 2;
        default: return 4;
    }
}

template <typename T>
static void cast_remap(const unsigned char* raw, float* dst, int ny, int nx,
                       int shift) {
    const T* src = reinterpret_cast<const T*>(raw);
    if (!shift) {
        for (long i = 0; i < (long)ny * nx; i++) dst[i] = (float)src[i];
        return;
    }
    // ifftshift: internal pixel (x, y) <- file pixel ((x + cx) % nx,
    // (y + cy) % ny) with cx = nx / 2, as numpy's ifftshift at odd sizes
    // too; the reference's MESH_IMAGE_INDEX load remap
    int cx = nx / 2, cy = ny / 2;
    for (int y = 0; y < ny; y++) {
        int yy = (y + cy) % ny;
        const T* s = src + (size_t)yy * nx;
        float* d = dst + (size_t)y * nx;
        for (int x = 0; x < nx; x++) d[x] = (float)s[(x + cx) % nx];
    }
}

extern "C" {

// Read `count` slices (0-based indices in `idx`, any order, repeats
// allowed) from an MRC stack into `out` (count * ny * nx float32).
// shift != 0 applies the ifftshift remap into internal FFT layout.
// Mode 0 is signed int8, mode 6 unsigned int16.  Slices are dealt to
// n_threads threads (1-16), each with its own FILE.  Returns 0 on
// success, mrc_open's code, -1 when a thread cannot open the file, -5
// on an index outside [0, nz), -6 on a failed seek or short read.
int mrc_read_slices(const char* path, const long* idx, long count,
                    float* out, int shift, int n_threads) {
    MrcInfo info;
    int rc = mrc_open(path, &info);
    if (rc != 0) return rc;
    const size_t px = (size_t)info.ny * info.nx;
    const size_t sb = px * mode_bytes(info.mode);
    const long base = 1024 + info.nsymbt;

    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    std::vector<std::thread> threads;
    std::vector<int> errs(n_threads, 0);

    auto work = [&](int tid) {
        FILE* f = fopen(path, "rb");
        if (!f) { errs[tid] = -1; return; }
        std::vector<unsigned char> buf(sb);
        for (long i = tid; i < count; i += n_threads) {
            long s = idx[i];
            if (s < 0 || s >= info.nz) { errs[tid] = -5; break; }
            // long is 64 bits on the LP64 hosts this builds on: offsets
            // past 2 GiB seek exactly
            if (fseek(f, base + (long)(s * (long long)sb), SEEK_SET) != 0 ||
                fread(buf.data(), 1, sb, f) != sb) {
                errs[tid] = -6;
                break;
            }
            float* dst = out + (size_t)i * px;
            switch (info.mode) {
                case 0: cast_remap<int8_t>(buf.data(), dst, info.ny, info.nx, shift); break;
                case 1: cast_remap<int16_t>(buf.data(), dst, info.ny, info.nx, shift); break;
                case 2: cast_remap<float>(buf.data(), dst, info.ny, info.nx, shift); break;
                case 6: cast_remap<uint16_t>(buf.data(), dst, info.ny, info.nx, shift); break;
            }
        }
        fclose(f);
    };
    for (int t = 0; t < n_threads; t++) threads.emplace_back(work, t);
    for (auto& t : threads) t.join();
    for (int e : errs)
        if (e != 0) return e;
    return 0;
}

}  // extern "C"
