// Native geometry module of plant3dvision_tpu_torch: the port's own copy of
// plant3dvision_tpu/native/geometry.cpp (the same code, built by native/mc.py
// with the same flags, so both builds give the same triangles on one machine).
//
// Role of the reference's romicgal (C++/CGAL bindings used for Poisson
// meshing + skeletonization, reference proc3d.py:82,156): here the surface
// extraction runs on the signed-distance volume via marching tetrahedra
// (table-free, watertight by construction), with global vertex dedup.
//
// C API (ctypes-friendly):
//   int p3d_marching_tetrahedra(const float* vol, int nx, int ny, int nz,
//                               float level,
//                               float** out_verts, long long* n_verts,
//                               int** out_tris, long long* n_tris);
//   void p3d_free(void* ptr);
//
// Triangles are oriented so the right-hand normal points toward
// vol > level (outside, for a signed distance that is positive inside —
// callers flip as needed).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

// The 6-tetrahedra decomposition of a cube around the main diagonal 0-7
// (every tet contains edge 0-7). This decomposition is CONFORMING: the
// diagonal induced on each cube face matches the neighboring cube's, which
// makes the extracted surface watertight. Corners indexed 0..7 as
// (dx, dy, dz) bits: corner = dx + 2*dy + 4*dz.
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

static const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

struct MeshBuilder {
    std::vector<float> verts;
    std::vector<int32_t> tris;
    // edge key = packed pair of global lattice ids
    std::unordered_map<uint64_t, int32_t> edge_vertex;

    int nx, ny, nz;
    const float* vol;
    float level;

    inline float val(int64_t gid) const { return vol[gid]; }

    inline int64_t gid(int x, int y, int z) const {
        return (int64_t)(x) * ny * nz + (int64_t)(y) * nz + z;
    }

    inline V3 pos(int64_t g) const {
        int z = (int)(g % nz);
        int y = (int)((g / nz) % ny);
        int x = (int)(g / ((int64_t)ny * nz));
        return V3{(float)x, (float)y, (float)z};
    }

    // Interpolated vertex on edge (a, b); memoized globally.
    int32_t edge_point(int64_t a, int64_t b) {
        if (a > b) std::swap(a, b);
        // unique pack: lattice ids are < 2^31 for any grid we handle
        uint64_t key = ((uint64_t)a << 32) | (uint64_t)b;
        auto it = edge_vertex.find(key);
        if (it != edge_vertex.end()) return it->second;
        float va = val(a), vb = val(b);
        float t = (level - va) / (vb - va);
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        V3 pa = pos(a), pb = pos(b);
        verts.push_back(pa.x + t * (pb.x - pa.x));
        verts.push_back(pa.y + t * (pb.y - pa.y));
        verts.push_back(pa.z + t * (pb.z - pa.z));
        int32_t idx = (int32_t)(verts.size() / 3 - 1);
        edge_vertex.emplace(key, idx);
        return idx;
    }

    void emit(int32_t a, int32_t b, int32_t c) {
        if (a == b || b == c || a == c) return;  // degenerate
        tris.push_back(a);
        tris.push_back(b);
        tris.push_back(c);
    }

    // Marching tetrahedron: corners p[4] (global ids). Inside = val > level.
    void do_tet(const int64_t p[4]) {
        bool in[4];
        int n_in = 0;
        for (int i = 0; i < 4; i++) {
            in[i] = val(p[i]) > level;
            n_in += in[i];
        }
        if (n_in == 0 || n_in == 4) return;

        int ins[4], outs[4];
        int ni = 0, no = 0;
        for (int i = 0; i < 4; i++) {
            if (in[i]) ins[ni++] = i;
            else outs[no++] = i;
        }
        // orientation: use the tet's signed volume to keep normals consistent
        if (n_in == 1) {
            int i0 = ins[0];
            int32_t e0 = edge_point(p[i0], p[outs[0]]);
            int32_t e1 = edge_point(p[i0], p[outs[1]]);
            int32_t e2 = edge_point(p[i0], p[outs[2]]);
            // order outs so the triangle normal points away from the inside
            if (orient(p[i0], p[outs[0]], p[outs[1]], p[outs[2]]) > 0)
                emit(e0, e1, e2);
            else
                emit(e0, e2, e1);
        } else if (n_in == 3) {
            int o0 = outs[0];
            int32_t e0 = edge_point(p[o0], p[ins[0]]);
            int32_t e1 = edge_point(p[o0], p[ins[1]]);
            int32_t e2 = edge_point(p[o0], p[ins[2]]);
            if (orient(p[o0], p[ins[0]], p[ins[1]], p[ins[2]]) > 0)
                emit(e0, e2, e1);
            else
                emit(e0, e1, e2);
        } else {  // 2-2: quad -> two triangles
            int i0 = ins[0], i1 = ins[1], o0 = outs[0], o1 = outs[1];
            int32_t a = edge_point(p[i0], p[o0]);
            int32_t b = edge_point(p[i0], p[o1]);
            int32_t c = edge_point(p[i1], p[o1]);
            int32_t d = edge_point(p[i1], p[o0]);
            if (orient(p[i0], p[i1], p[o0], p[o1]) > 0) {
                emit(a, b, c);
                emit(a, c, d);
            } else {
                emit(a, c, b);
                emit(a, d, c);
            }
        }
    }

    // signed orientation of tet (a, b, c, d) in lattice coords
    float orient(int64_t a, int64_t b, int64_t c, int64_t d) {
        V3 pa = pos(a), pb = pos(b), pc = pos(c), pd = pos(d);
        float ux = pb.x - pa.x, uy = pb.y - pa.y, uz = pb.z - pa.z;
        float vx = pc.x - pa.x, vy = pc.y - pa.y, vz = pc.z - pa.z;
        float wx = pd.x - pa.x, wy = pd.y - pa.y, wz = pd.z - pa.z;
        return ux * (vy * wz - vz * wy) - uy * (vx * wz - vz * wx) +
               uz * (vx * wy - vy * wx);
    }

    void run() {
        for (int x = 0; x + 1 < nx; x++) {
            for (int y = 0; y + 1 < ny; y++) {
                // quick reject: scan the z-column pairwise
                for (int z = 0; z + 1 < nz; z++) {
                    // cube corner values; skip if all same side
                    bool any_in = false, any_out = false;
                    int64_t g[8];
                    for (int c = 0; c < 8; c++) {
                        g[c] = gid(x + kCorner[c][0], y + kCorner[c][1],
                                   z + kCorner[c][2]);
                        if (val(g[c]) > level) any_in = true;
                        else any_out = true;
                    }
                    if (!any_in || !any_out) continue;
                    for (int t = 0; t < 6; t++) {
                        int64_t p[4] = {g[kTets[t][0]], g[kTets[t][1]],
                                        g[kTets[t][2]], g[kTets[t][3]]};
                        do_tet(p);
                    }
                }
            }
        }
    }
};

}  // namespace

// ---------------------------------------------------------------------------
// Mean-curvature-flow mesh contraction (skeletonization front end).
//
// Role of the reference's romicgal `skeletonize_mesh` = CGAL
// Mean_curvature_flow_skeletonization (reference proc3d.py:156). The
// contraction follows Au et al. 2008 ("Skeleton Extraction by Mesh
// Contraction"), the same family CGAL implements: repeatedly solve
//
//     [ WL * L      ]        [ 0            ]
//     [ diag(WH_i)  ] V' =   [ WH_i * V_i   ]
//
// in least squares, where L is the cotangent Laplacian of the CURRENT
// mesh, WL grows each iteration and WH_i = WH0 * sqrt(A0_i / A_i)
// anchors vertices whose one-ring has already collapsed. The normal
// equations (WL^2 L^T L + diag(WH_i^2)) V' = diag(WH_i^2) V are SPD and
// solved with Jacobi-preconditioned conjugate gradients (no external
// sparse solver needed). The 1D curve collapse runs in Python on the
// contracted vertices (native/mcf.py) — graphs there are tiny.

namespace {

struct Mcf {
    int64_t nv, nt;
    std::vector<float> v;         // 3*nv, current positions
    const int32_t* tris;
    // CSR cotangent Laplacian (rebuilt each iteration)
    std::vector<int64_t> rowptr;
    std::vector<int32_t> colidx;
    std::vector<double> w;        // off-diagonal weights (cot sums)
    std::vector<double> diag;     // row sums
    std::vector<double> ring_area;

    void build_laplacian() {
        // adjacency map per vertex: accumulate cot weights
        std::vector<std::unordered_map<int32_t, double>> adj(nv);
        ring_area.assign(nv, 0.0);
        for (int64_t t = 0; t < nt; t++) {
            const int32_t* tv = tris + 3 * t;
            double area2;
            for (int e = 0; e < 3; e++) {
                int32_t a = tv[e], b = tv[(e + 1) % 3], c = tv[(e + 2) % 3];
                // cot at c for edge (a, b)
                double ux = v[3 * a] - v[3 * c], uy = v[3 * a + 1] - v[3 * c + 1],
                       uz = v[3 * a + 2] - v[3 * c + 2];
                double wx = v[3 * b] - v[3 * c], wy = v[3 * b + 1] - v[3 * c + 1],
                       wz = v[3 * b + 2] - v[3 * c + 2];
                double dot = ux * wx + uy * wy + uz * wz;
                double cx = uy * wz - uz * wy, cy = uz * wx - ux * wz,
                       cz = ux * wy - uy * wx;
                double cr = std::sqrt(cx * cx + cy * cy + cz * cz);
                area2 = cr;
                double cot = dot / (cr > 1e-12 ? cr : 1e-12);
                // clamp degenerate-triangle cotangents (|cot 1deg| ~ 57)
                if (cot > 57.0) cot = 57.0;
                if (cot < -57.0) cot = -57.0;
                adj[a][b] += 0.5 * cot;
                adj[b][a] += 0.5 * cot;
            }
            double fa = 0.5 * area2;
            for (int e = 0; e < 3; e++) ring_area[tv[e]] += fa / 3.0;
        }
        rowptr.assign(nv + 1, 0);
        colidx.clear();
        w.clear();
        diag.assign(nv, 0.0);
        for (int64_t i = 0; i < nv; i++) {
            for (auto& kv : adj[i]) {
                colidx.push_back(kv.first);
                w.push_back(kv.second);
                diag[i] += kv.second;
            }
            rowptr[i + 1] = (int64_t)colidx.size();
        }
    }

    // y = L x  (L = diag - W, the graph Laplacian with cot weights)
    void lap_mv(const std::vector<double>& x, std::vector<double>& y) const {
        for (int64_t i = 0; i < nv; i++) {
            double s = diag[i] * x[i];
            for (int64_t k = rowptr[i]; k < rowptr[i + 1]; k++)
                s -= w[k] * x[colidx[k]];
            y[i] = s;
        }
    }

    // y = (wl^2 L^T L + diag(wh2)) x ; L symmetric here so L^T L = L L
    void amv(double wl2, const std::vector<double>& wh2,
             const std::vector<double>& x, std::vector<double>& y,
             std::vector<double>& tmp) const {
        lap_mv(x, tmp);
        lap_mv(tmp, y);
        for (int64_t i = 0; i < nv; i++) y[i] = wl2 * y[i] + wh2[i] * x[i];
    }

    // Jacobi-preconditioned CG for one coordinate column.
    void cg(double wl2, const std::vector<double>& wh2,
            const std::vector<double>& b, std::vector<double>& x,
            int max_iter) const {
        std::vector<double> r(nv), z(nv), p(nv), ap(nv), tmp(nv), prec(nv);
        // diag of A ~ wl2 * (diag(L)^2 + sum_j w_ij^2) + wh2
        for (int64_t i = 0; i < nv; i++) {
            double s = diag[i] * diag[i];
            for (int64_t k = rowptr[i]; k < rowptr[i + 1]; k++)
                s += w[k] * w[k];
            prec[i] = 1.0 / (wl2 * s + wh2[i] + 1e-30);
        }
        amv(wl2, wh2, x, ap, tmp);
        double bb = 0;
        for (int64_t i = 0; i < nv; i++) {
            r[i] = b[i] - ap[i];
            bb += b[i] * b[i];
        }
        double tol2 = 1e-14 * (bb > 0 ? bb : 1.0);
        double rz = 0;
        for (int64_t i = 0; i < nv; i++) {
            z[i] = prec[i] * r[i];
            p[i] = z[i];
            rz += r[i] * z[i];
        }
        for (int it = 0; it < max_iter; it++) {
            double rr = 0;
            for (int64_t i = 0; i < nv; i++) rr += r[i] * r[i];
            if (rr < tol2) break;
            amv(wl2, wh2, p, ap, tmp);
            double pap = 0;
            for (int64_t i = 0; i < nv; i++) pap += p[i] * ap[i];
            if (pap <= 0) break;
            double alpha = rz / pap;
            for (int64_t i = 0; i < nv; i++) {
                x[i] += alpha * p[i];
                r[i] -= alpha * ap[i];
            }
            double rz2 = 0;
            for (int64_t i = 0; i < nv; i++) {
                z[i] = prec[i] * r[i];
                rz2 += r[i] * z[i];
            }
            double beta = rz2 / (rz + 1e-300);
            rz = rz2;
            for (int64_t i = 0; i < nv; i++) p[i] = z[i] + beta * p[i];
        }
    }

    void contract(int iterations, double wl_factor, double wh0,
                  int cg_iters) {
        build_laplacian();
        std::vector<double> a0 = ring_area;
        double mean_face = 0;
        for (int64_t i = 0; i < nv; i++) mean_face += ring_area[i];
        mean_face = mean_face / std::max<int64_t>(nv, 1);
        double wl = 1e-3 * std::sqrt(mean_face > 0 ? mean_face : 1.0) * 1e3;
        // (the 1e-3*sqrt(A) of the paper is in units where A is the mean
        // face area; starting 1e3x higher converges in fewer rounds and
        // the WH anchor still preserves already-collapsed regions)
        double total0 = 0;
        for (int64_t i = 0; i < nv; i++) total0 += ring_area[i];
        std::vector<double> wh2(nv), b(nv), x(nv);
        for (int it = 0; it < iterations; it++) {
            if (it > 0) build_laplacian();
            double total = 0;
            for (int64_t i = 0; i < nv; i++) total += ring_area[i];
            // contracted enough: the collapse stage takes it from here
            if (total < 5e-3 * total0) break;
            for (int64_t i = 0; i < nv; i++) {
                double ratio = a0[i] / (ring_area[i] > 1e-12 ? ring_area[i] : 1e-12);
                double whi = wh0 * std::sqrt(ratio);
                if (whi > 1e4) whi = 1e4;
                wh2[i] = whi * whi;
            }
            double wl2 = wl * wl;
            for (int c = 0; c < 3; c++) {
                for (int64_t i = 0; i < nv; i++) {
                    x[i] = v[3 * i + c];
                    b[i] = wh2[i] * x[i];
                }
                cg(wl2, wh2, b, x, cg_iters);
                for (int64_t i = 0; i < nv; i++) v[3 * i + c] = (float)x[i];
            }
            wl *= wl_factor;
        }
    }
};

}  // namespace

extern "C" {

// Contract a triangle mesh toward its curve skeleton (MCF/Au-2008).
// verts: 3*n_verts floats (modified copy returned via out_verts,
// caller-allocated, 3*n_verts floats). Returns 0 on success.
int p3d_mcf_contract(const float* verts, long long n_verts,
                     const int* tris, long long n_tris, int iterations,
                     float wl_factor, float wh0, int cg_iters,
                     float* out_verts) {
    if (n_verts <= 0 || n_tris <= 0) return -1;
    Mcf m;
    m.nv = n_verts;
    m.nt = n_tris;
    m.v.assign(verts, verts + 3 * n_verts);
    m.tris = tris;
    m.contract(iterations, wl_factor, wh0, cg_iters);
    std::memcpy(out_verts, m.v.data(), 3 * n_verts * sizeof(float));
    return 0;
}

}  // extern "C"

extern "C" {

int p3d_marching_tetrahedra(const float* vol, int nx, int ny, int nz,
                            float level, float** out_verts,
                            long long* n_verts, int** out_tris,
                            long long* n_tris) {
    MeshBuilder mb;
    mb.nx = nx;
    mb.ny = ny;
    mb.nz = nz;
    mb.vol = vol;
    mb.level = level;
    mb.run();

    *n_verts = (long long)(mb.verts.size() / 3);
    *n_tris = (long long)(mb.tris.size() / 3);
    *out_verts = (float*)std::malloc(mb.verts.size() * sizeof(float));
    *out_tris = (int*)std::malloc(mb.tris.size() * sizeof(int));
    if (!*out_verts || !*out_tris) return -1;
    std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
    std::memcpy(*out_tris, mb.tris.data(), mb.tris.size() * sizeof(int));
    return 0;
}

void p3d_free(void* ptr) { std::free(ptr); }

}  // extern "C"
