// CTM mesh exporter — the ss_utils/depth_scripts/ctm_exporter equivalent.
//
// The reference bundles a pybind11+OpenCTM module (ctm_exporter.cpp:10-60)
// that writes offset-centred CTM meshes for the Cyclomedia depth-render
// pipeline.  This implementation writes the OpenCTM v5 container with the
// RAW (uncompressed, lossless) body directly — no OpenCTM library
// dependency — and exposes a plain C ABI consumed through ctypes
// (street_sparse_3dgs_tpu/native/__init__.py).
//
// OpenCTM v5 layout (RAW method):
//   "OCTM" | int32 version=5 | fourcc "RAW\0" | int32 nVerts |
//   int32 nTris | int32 nUVMaps=0 | int32 nAttrMaps=0 | int32 flags=0 |
//   int32 commentLen | comment bytes |
//   "INDX" | uint32 indices[3*nTris] | "VERT" | float32 verts[3*nVerts]
//
// Build: g++ -O2 -shared -fPIC ctm_exporter.cpp -o libctm_exporter.so

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

bool write_u32(std::FILE* f, uint32_t v) {
    unsigned char b[4] = {
        static_cast<unsigned char>(v & 0xff),
        static_cast<unsigned char>((v >> 8) & 0xff),
        static_cast<unsigned char>((v >> 16) & 0xff),
        static_cast<unsigned char>((v >> 24) & 0xff)};
    return std::fwrite(b, 1, 4, f) == 4;
}

bool write_f32(std::FILE* f, float v) {
    uint32_t bits;
    std::memcpy(&bits, &v, 4);
    return write_u32(f, bits);
}

bool write_fourcc(std::FILE* f, const char* cc) {
    return std::fwrite(cc, 1, 4, f) == 4;
}

}  // namespace

extern "C" {

// Returns 0 on success, nonzero on error.
// vertices: [n_vertices * 3] float32 (x, y, z interleaved)
// triangles: [n_triangles * 3] int32 vertex indices
// offset: [3] float64 subtracted from every vertex (the reference's
//         user_offset recentring, ctm_exporter.cpp:26-38).
int save_ctm(const char* filename,
             const float* vertices, int64_t n_vertices,
             const int32_t* triangles, int64_t n_triangles,
             const double* offset) {
    if (!filename || !vertices || !triangles || n_vertices <= 0 ||
        n_triangles < 0) {
        return 1;
    }
    std::FILE* f = std::fopen(filename, "wb");
    if (!f) return 2;

    const char comment[] = "street_sparse_3dgs_tpu ctm_exporter";
    bool ok = write_fourcc(f, "OCTM") && write_u32(f, 5) &&
              write_fourcc(f, "RAW\0") &&
              write_u32(f, static_cast<uint32_t>(n_vertices)) &&
              write_u32(f, static_cast<uint32_t>(n_triangles)) &&
              write_u32(f, 0) &&  // UV maps
              write_u32(f, 0) &&  // attribute maps
              write_u32(f, 0) &&  // flags (no normals)
              write_u32(f, static_cast<uint32_t>(sizeof(comment) - 1)) &&
              std::fwrite(comment, 1, sizeof(comment) - 1, f) ==
                  sizeof(comment) - 1;

    ok = ok && write_fourcc(f, "INDX");
    for (int64_t i = 0; ok && i < n_triangles * 3; ++i) {
        ok = write_u32(f, static_cast<uint32_t>(triangles[i]));
    }
    ok = ok && write_fourcc(f, "VERT");
    const double ox = offset ? offset[0] : 0.0;
    const double oy = offset ? offset[1] : 0.0;
    const double oz = offset ? offset[2] : 0.0;
    for (int64_t i = 0; ok && i < n_vertices; ++i) {
        ok = write_f32(f, static_cast<float>(vertices[3 * i] - ox)) &&
             write_f32(f, static_cast<float>(vertices[3 * i + 1] - oy)) &&
             write_f32(f, static_cast<float>(vertices[3 * i + 2] - oz));
    }

    std::fclose(f);
    return ok ? 0 : 3;
}

}  // extern "C"
