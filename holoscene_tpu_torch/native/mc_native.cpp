// Native marching tetrahedra (single-pass, cache-friendly): the port's copy
// of holoscene_tpu/native/mc_native.cpp, the same code.
//
// C++ counterpart of holoscene_tpu_torch/utils/mc.py::marching_tetrahedra:
// the host-side isosurface extraction is the hot host loop of mesh
// extraction (512^3 plot-cadence grids), so it gets a native
// implementation. Same 6-tetrahedra cube decomposition and vertex welding by
// global edge id; tests/test_torch_extract.py holds it against the numpy
// path and against the JAX package's extractor.
//
// Built on first use by holoscene_tpu_torch/native/__init__.py:
// g++ -O3 -shared -fPIC -std=c++17 mc_native.cpp -> build/libmc_native.so

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <cmath>

namespace {

struct V3 {
    double x, y, z;
};

// 6-tet decomposition of the unit cube; corner k at bits (x=k&1, y=k>>1&1,
// z=k>>2&1); all tets share the 0-7 diagonal (must match utils/mc.py _TETS)
static const int TETS[6][4] = {
    {0, 5, 1, 7}, {0, 1, 3, 7}, {0, 3, 2, 7},
    {0, 2, 6, 7}, {0, 6, 4, 7}, {0, 4, 5, 7},
};

static const int CORNER_OFF[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

struct Builder {
    const float* sdf;
    int64_t nx, ny, nz;
    double level;
    std::unordered_map<uint64_t, int64_t> edge_to_vert;
    std::vector<double> verts;   // xyz triples (grid coords)
    std::vector<int64_t> faces;  // index triples

    inline double val(int64_t p) const {
        return (double)sdf[p] - level;
    }

    inline int64_t pid(int64_t ix, int64_t iy, int64_t iz) const {
        return (ix * ny + iy) * nz + iz;
    }

    int64_t edge_vertex(int64_t a, int64_t b) {
        if (a > b) std::swap(a, b);
        uint64_t key = (uint64_t)a * (uint64_t)(nx * ny * nz) + (uint64_t)b;
        auto it = edge_to_vert.find(key);
        if (it != edge_to_vert.end()) return it->second;
        double va = val(a), vb = val(b);
        double t = va / (va - vb);
        if (!std::isfinite(t)) t = 0.5;
        t = t < 0.0 ? 0.0 : (t > 1.0 ? 1.0 : t);
        // unpack grid coords
        int64_t az = a % nz, ay = (a / nz) % ny, ax = a / (ny * nz);
        int64_t bz = b % nz, by = (b / nz) % ny, bx = b / (ny * nz);
        int64_t vid = (int64_t)(verts.size() / 3);
        verts.push_back(ax + t * (bx - ax));
        verts.push_back(ay + t * (by - ay));
        verts.push_back(az + t * (bz - az));
        edge_to_vert.emplace(key, vid);
        return vid;
    }

    inline void emit(int64_t e0a, int64_t e0b, int64_t e1a, int64_t e1b,
                     int64_t e2a, int64_t e2b) {
        int64_t v0 = edge_vertex(e0a, e0b);
        int64_t v1 = edge_vertex(e1a, e1b);
        int64_t v2 = edge_vertex(e2a, e2b);
        if (v0 == v1 || v1 == v2 || v0 == v2) return;
        faces.push_back(v0);
        faces.push_back(v1);
        faces.push_back(v2);
    }

    void tet(const int64_t p[4], const double v[4]) {
        int inside_mask = 0, count = 0;
        for (int i = 0; i < 4; i++) {
            if (v[i] < 0) { inside_mask |= 1 << i; count++; }
        }
        if (count == 0 || count == 4) return;

        if (count == 1 || count == 3) {
            bool flip3 = (count == 3);
            int apex = -1;
            for (int i = 0; i < 4; i++) {
                bool in = (inside_mask >> i) & 1;
                if (in != flip3) { apex = i; break; }
            }
            int others[3], m = 0;
            for (int i = 0; i < 4; i++) if (i != apex) others[m++] = i;
            // orientation parity matches the numpy implementation
            bool parity = ((apex + (flip3 ? 1 : 0)) % 2) == 1;
            if (!parity) {
                emit(p[apex], p[others[0]], p[apex], p[others[1]],
                     p[apex], p[others[2]]);
            } else {
                emit(p[apex], p[others[2]], p[apex], p[others[1]],
                     p[apex], p[others[0]]);
            }
        } else {  // count == 2: quad split into two triangles
            int ins[2], outs[2], mi = 0, mo = 0;
            for (int i = 0; i < 4; i++) {
                if ((inside_mask >> i) & 1) ins[mi++] = i; else outs[mo++] = i;
            }
            int64_t i0 = p[ins[0]], i1 = p[ins[1]];
            int64_t o0 = p[outs[0]], o1 = p[outs[1]];
            bool swap = ((ins[0] + ins[1]) % 2) == 0;
            if (!swap) {
                emit(i0, o0, i0, o1, i1, o1);
                emit(i0, o0, i1, o1, i1, o0);
            } else {
                emit(i1, o1, i0, o1, i0, o0);
                emit(i1, o0, i1, o1, i0, o0);
            }
        }
    }

    void run() {
        int64_t corner_pid[8];
        double corner_val[8];
        for (int64_t x = 0; x + 1 < nx; x++) {
            for (int64_t y = 0; y + 1 < ny; y++) {
                for (int64_t z = 0; z + 1 < nz; z++) {
                    bool neg = false, pos = false;
                    for (int k = 0; k < 8; k++) {
                        corner_pid[k] = pid(x + CORNER_OFF[k][0],
                                            y + CORNER_OFF[k][1],
                                            z + CORNER_OFF[k][2]);
                        corner_val[k] = val(corner_pid[k]);
                        if (corner_val[k] < 0) neg = true; else pos = true;
                    }
                    if (!neg || !pos) continue;
                    for (int t = 0; t < 6; t++) {
                        int64_t tp[4];
                        double tv[4];
                        for (int i = 0; i < 4; i++) {
                            tp[i] = corner_pid[TETS[t][i]];
                            tv[i] = corner_val[TETS[t][i]];
                        }
                        tet(tp, tv);
                    }
                }
            }
        }
    }
};

Builder* g_last = nullptr;

}  // namespace

extern "C" {

// Runs extraction; returns counts. Data retrieved via mc_copy + mc_free.
int64_t mc_run(const float* sdf, int64_t nx, int64_t ny, int64_t nz,
               double level, int64_t* n_verts, int64_t* n_faces) {
    delete g_last;
    g_last = new Builder{sdf, nx, ny, nz, level, {}, {}, {}};
    g_last->run();
    *n_verts = (int64_t)(g_last->verts.size() / 3);
    *n_faces = (int64_t)(g_last->faces.size() / 3);
    return 0;
}

void mc_copy(double* verts_out, int64_t* faces_out) {
    if (!g_last) return;
    std::memcpy(verts_out, g_last->verts.data(),
                g_last->verts.size() * sizeof(double));
    std::memcpy(faces_out, g_last->faces.data(),
                g_last->faces.size() * sizeof(int64_t));
}

void mc_free() {
    delete g_last;
    g_last = nullptr;
}

}  // extern "C"
