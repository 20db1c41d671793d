// Native host-side components of atray_tpu_torch: binned-SAH BVH builder +
// OBJ parser.
//
// The port's own copy of the JAX package's atray_tpu/native/atray_native.cpp
// (the port reads nothing of that package). The reference implements its
// hot host paths in C++ (the octree builder, kd_tree.cpp:67-288, and the
// multithreaded OBJ parser, OBJ_loader.cpp); this file is their counterpart
// on the host side. What belongs in native code here is exactly what ran
// native in the reference: asset parsing and acceleration-structure
// construction, which are python-slow at Dragon scale.
//
// The builder mirrors atray_tpu_torch/accel/bvh.py::build_bvh EXACTLY
// (binned SAH on the widest centroid axis, median fallback, DFS preorder
// with skip links, leaf-padded triangle arrays) so the python builder
// doubles as its correctness oracle; the tests hold the tables it builds
// bit-equal to the JAX package's.
//
// C ABI only (ctypes binding, no pybind11): the library allocates output
// buffers with malloc and the caller frees them via atray_free.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
    double x, y, z;
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
static inline double axis(const Vec3 &v, int a) {
    return a == 0 ? v.x : (a == 1 ? v.y : v.z);
}
static inline double surface(const Vec3 &lo, const Vec3 &hi) {
    double dx = std::max(hi.x - lo.x, 0.0);
    double dy = std::max(hi.y - lo.y, 0.0);
    double dz = std::max(hi.z - lo.z, 0.0);
    return dx * dy + dy * dz + dz * dx;
}

struct BuildNode {
    Vec3 lo, hi;
    int left = -1, right = -1;       // interior
    int64_t first = -1, count = 0;   // leaf: range in the index order
};

struct Builder {
    const float *verts;
    const int32_t *faces;
    int64_t nfaces;
    int leaf_size, sah_bins, max_depth;

    std::vector<Vec3> tmin, tmax, cent;
    std::vector<int64_t> order;       // triangle ids, permuted in place
    std::vector<BuildNode> nodes;

    Vec3 vertex(int64_t vi) const {
        return {verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
    }

    void prepare() {
        tmin.resize(nfaces);
        tmax.resize(nfaces);
        cent.resize(nfaces);
        order.resize(nfaces);
        for (int64_t i = 0; i < nfaces; ++i) {
            Vec3 a = vertex(faces[3 * i]);
            Vec3 b = vertex(faces[3 * i + 1]);
            Vec3 c = vertex(faces[3 * i + 2]);
            tmin[i] = vmin(a, vmin(b, c));
            tmax[i] = vmax(a, vmax(b, c));
            cent[i] = {(a.x + b.x + c.x) / 3.0, (a.y + b.y + c.y) / 3.0,
                       (a.z + b.z + c.z) / 3.0};
            order[i] = i;
        }
    }

    // Binned SAH over [first, first+count) of `order`; returns split axis
    // and position or false for "no useful split" (degenerate centroids).
    bool sah_split(int64_t first, int64_t count, int &out_axis, double &out_pos) {
        Vec3 clo = cent[order[first]], chi = clo;
        for (int64_t i = first + 1; i < first + count; ++i) {
            clo = vmin(clo, cent[order[i]]);
            chi = vmax(chi, cent[order[i]]);
        }
        Vec3 ext = {chi.x - clo.x, chi.y - clo.y, chi.z - clo.z};
        int ax = 0;
        if (ext.y > axis(ext, ax)) ax = 1;
        if (ext.z > axis(ext, ax)) ax = 2;
        double extent = axis(ext, ax);
        if (extent <= 0.0) return false;
        double lo = axis(clo, ax);
        int bins = sah_bins;
        double scale = bins / extent;

        std::vector<int64_t> counts(bins, 0);
        std::vector<Vec3> bmin(bins, {DBL_MAX, DBL_MAX, DBL_MAX});
        std::vector<Vec3> bmax(bins, {-DBL_MAX, -DBL_MAX, -DBL_MAX});
        for (int64_t i = first; i < first + count; ++i) {
            int64_t t = order[i];
            int b = (int)std::min((double)(bins - 1),
                                  (axis(cent[t], ax) - lo) * scale);
            counts[b]++;
            bmin[b] = vmin(bmin[b], tmin[t]);
            bmax[b] = vmax(bmax[b], tmax[t]);
        }
        // prefix/suffix sweeps
        std::vector<double> lcost(bins), rcost(bins);
        std::vector<int64_t> lcnt(bins), rcnt(bins);
        Vec3 mlo = {DBL_MAX, DBL_MAX, DBL_MAX}, mhi = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
        int64_t n = 0;
        for (int b = 0; b < bins; ++b) {
            if (counts[b]) { mlo = vmin(mlo, bmin[b]); mhi = vmax(mhi, bmax[b]); }
            n += counts[b];
            lcnt[b] = n;
            lcost[b] = n ? surface(mlo, mhi) * n : 0.0;
        }
        mlo = {DBL_MAX, DBL_MAX, DBL_MAX}; mhi = {-DBL_MAX, -DBL_MAX, -DBL_MAX};
        n = 0;
        for (int b = bins - 1; b >= 0; --b) {
            if (counts[b]) { mlo = vmin(mlo, bmin[b]); mhi = vmax(mhi, bmax[b]); }
            n += counts[b];
            rcnt[b] = n;
            rcost[b] = n ? surface(mlo, mhi) * n : 0.0;
        }
        double best = DBL_MAX;
        int bestk = -1;
        for (int k = 0; k < bins - 1; ++k) {
            if (lcnt[k] == 0 || rcnt[k + 1] == 0) continue;
            double c = lcost[k] + rcost[k + 1];
            if (c < best) { best = c; bestk = k; }
        }
        if (bestk < 0) return false;
        out_axis = ax;
        out_pos = lo + (bestk + 1) / scale;
        return true;
    }

    int rec(int64_t first, int64_t count, int depth) {
        int me = (int)nodes.size();
        nodes.push_back({});
        Vec3 lo = tmin[order[first]], hi = tmax[order[first]];
        for (int64_t i = first + 1; i < first + count; ++i) {
            lo = vmin(lo, tmin[order[i]]);
            hi = vmax(hi, tmax[order[i]]);
        }
        nodes[me].lo = lo;
        nodes[me].hi = hi;
        if (count <= leaf_size || depth >= max_depth) {
            nodes[me].first = first;
            nodes[me].count = count;
            return me;
        }
        int ax;
        double pos;
        int64_t mid;
        if (sah_split(first, count, ax, pos)) {
            auto it = std::partition(
                order.begin() + first, order.begin() + first + count,
                [&](int64_t t) { return axis(cent[t], ax) < pos; });
            mid = it - order.begin();
        } else {
            mid = first;  // force the median path below
        }
        if (mid == first || mid == first + count) {
            // degenerate: median split on the widest node axis (stable,
            // matching the numpy builder's argsort(kind='stable'))
            Vec3 ext = {hi.x - lo.x, hi.y - lo.y, hi.z - lo.z};
            int wax = 0;
            if (ext.y > axis(ext, wax)) wax = 1;
            if (ext.z > axis(ext, wax)) wax = 2;
            std::stable_sort(order.begin() + first,
                             order.begin() + first + count,
                             [&](int64_t a, int64_t b) {
                                 return axis(cent[a], wax) < axis(cent[b], wax);
                             });
            mid = first + count / 2;
        }
        int l = rec(first, mid - first, depth + 1);
        int r = rec(mid, first + count - mid, depth + 1);
        nodes[me].left = l;
        nodes[me].right = r;
        return me;
    }
};

}  // namespace

extern "C" {

struct AtrayBvhOut {
    // flattened skip-link arrays, layout of accel/bvh.py::BVH
    float *node_min;      // (K, 3)
    float *node_max;      // (K, 3)
    int32_t *node_miss;   // (K,)
    int32_t *leaf_start;  // (K,)
    float *tri_p0;        // (L, 3)  L = num_leaves * leaf_size
    float *tri_e1;        // (L, 3)
    float *tri_e2;        // (L, 3)
    int32_t *tri_id;      // (L,)
    int64_t num_nodes;
    int64_t num_slots;
};

void atray_free(void *p) { free(p); }

// Returns 0 on success.
int atray_build_bvh(const float *vertices, int64_t nverts,
                    const int32_t *faces, int64_t nfaces, int leaf_size,
                    int sah_bins, int max_depth, AtrayBvhOut *out) {
    (void)nverts;
    if (nfaces <= 0 || leaf_size <= 0 || sah_bins < 2) return 1;
    Builder b{vertices, faces, nfaces, leaf_size, sah_bins, max_depth};
    b.prepare();
    b.rec(0, nfaces, 0);

    int64_t k = (int64_t)b.nodes.size();
    // DFS preorder == construction order already (rec pushes preorder),
    // compute subtree sizes for skip links.
    std::vector<int64_t> size(k, 1);
    for (int64_t i = k - 1; i >= 0; --i) {
        const BuildNode &nd = b.nodes[i];
        if (nd.left >= 0) size[i] = 1 + size[nd.left] + size[nd.right];
    }
    out->num_nodes = k;
    out->node_min = (float *)malloc(sizeof(float) * 3 * k);
    out->node_max = (float *)malloc(sizeof(float) * 3 * k);
    out->node_miss = (int32_t *)malloc(sizeof(int32_t) * k);
    out->leaf_start = (int32_t *)malloc(sizeof(int32_t) * k);

    int64_t num_leaves = 0;
    for (int64_t i = 0; i < k; ++i)
        if (b.nodes[i].left < 0) num_leaves++;
    int64_t slots = num_leaves * leaf_size;
    out->num_slots = slots;
    out->tri_p0 = (float *)malloc(sizeof(float) * 3 * slots);
    out->tri_e1 = (float *)malloc(sizeof(float) * 3 * slots);
    out->tri_e2 = (float *)malloc(sizeof(float) * 3 * slots);
    out->tri_id = (int32_t *)malloc(sizeof(int32_t) * slots);
    for (int64_t s = 0; s < slots; ++s) {
        out->tri_p0[3 * s] = out->tri_p0[3 * s + 1] = out->tri_p0[3 * s + 2] = 1.0e30f;
        out->tri_e1[3 * s] = out->tri_e1[3 * s + 1] = out->tri_e1[3 * s + 2] = 0.0f;
        out->tri_e2[3 * s] = out->tri_e2[3 * s + 1] = out->tri_e2[3 * s + 2] = 0.0f;
        out->tri_id[s] = -1;
    }

    int64_t cursor = 0;
    for (int64_t i = 0; i < k; ++i) {
        const BuildNode &nd = b.nodes[i];
        out->node_min[3 * i] = (float)nd.lo.x;
        out->node_min[3 * i + 1] = (float)nd.lo.y;
        out->node_min[3 * i + 2] = (float)nd.lo.z;
        out->node_max[3 * i] = (float)nd.hi.x;
        out->node_max[3 * i + 1] = (float)nd.hi.y;
        out->node_max[3 * i + 2] = (float)nd.hi.z;
        int64_t after = i + size[i];
        out->node_miss[i] = after < k ? (int32_t)after : -1;
        if (nd.left >= 0) {
            out->leaf_start[i] = -1;
        } else {
            out->leaf_start[i] = (int32_t)cursor;
            for (int64_t j = 0; j < nd.count; ++j) {
                int64_t t = b.order[nd.first + j];
                int64_t s = cursor + j;
                Vec3 a = b.vertex(faces[3 * t]);
                Vec3 bb = b.vertex(faces[3 * t + 1]);
                Vec3 c = b.vertex(faces[3 * t + 2]);
                out->tri_p0[3 * s] = (float)a.x;
                out->tri_p0[3 * s + 1] = (float)a.y;
                out->tri_p0[3 * s + 2] = (float)a.z;
                out->tri_e1[3 * s] = (float)(bb.x - a.x);
                out->tri_e1[3 * s + 1] = (float)(bb.y - a.y);
                out->tri_e1[3 * s + 2] = (float)(bb.z - a.z);
                out->tri_e2[3 * s] = (float)(c.x - a.x);
                out->tri_e2[3 * s + 1] = (float)(c.y - a.y);
                out->tri_e2[3 * s + 2] = (float)(c.z - a.z);
                out->tri_id[s] = (int32_t)t;
            }
            cursor += leaf_size;
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// OBJ parser (reference tools/OBJ_loader.cpp capability): v/vt/vn records,
// all face-vertex forms, negative indices, n-gon fan triangulation.
// ---------------------------------------------------------------------------

struct AtrayObjOut {
    float *verts;     // (V, 3)
    float *norms;     // (N, 3)
    float *texs;      // (C, 2)
    int32_t *faces;   // (T, 3)
    int32_t *fnidx;   // (T, 3)  -1 = none
    int32_t *ftidx;   // (T, 3)
    int64_t nverts, nnorms, ntexs, nfaces;
};

static inline int32_t fix_index(long idx, int64_t count) {
    return idx > 0 ? (int32_t)(idx - 1) : (int32_t)(count + idx);
}

int atray_parse_obj(const char *path, AtrayObjOut *out) {
    FILE *fh = fopen(path, "rb");
    if (!fh) return 1;
    fseek(fh, 0, SEEK_END);
    long fsize = ftell(fh);
    fseek(fh, 0, SEEK_SET);
    std::vector<char> buf(fsize + 1);
    if (fread(buf.data(), 1, fsize, fh) != (size_t)fsize) {
        fclose(fh);
        return 1;
    }
    fclose(fh);
    buf[fsize] = 0;

    std::vector<float> verts, norms, texs;
    std::vector<int32_t> faces, fnidx, ftidx;

    char *p = buf.data();
    char *end = p + fsize;
    while (p < end) {
        // token at line start
        while (p < end && (*p == ' ' || *p == '\t')) ++p;
        char *line_end = (char *)memchr(p, '\n', end - p);
        if (!line_end) line_end = end;
        if (p + 1 < line_end && p[0] == 'v' &&
            (p[1] == ' ' || p[1] == '\t')) {
            char *q = p + 2;
            for (int i = 0; i < 3; ++i) verts.push_back(strtof(q, &q));
        } else if (p + 2 < line_end && p[0] == 'v' && p[1] == 'n') {
            char *q = p + 3;
            for (int i = 0; i < 3; ++i) norms.push_back(strtof(q, &q));
        } else if (p + 2 < line_end && p[0] == 'v' && p[1] == 't') {
            char *q = p + 3;
            texs.push_back(strtof(q, &q));
            float t2 = 0.0f;
            if (q < line_end) t2 = strtof(q, &q);
            texs.push_back(t2);
        } else if (p < line_end && p[0] == 'f' &&
                   (p + 1 >= line_end || p[1] == ' ' || p[1] == '\t')) {
            // parse corners: v[/vt][/vn]
            int32_t cv[64], ct[64], cn[64];
            int ncorner = 0;
            char *q = p + 1;
            while (q < line_end && ncorner < 64) {
                while (q < line_end && (*q == ' ' || *q == '\t')) ++q;
                if (q >= line_end) break;
                char *r;
                long vi = strtol(q, &r, 10);
                if (r == q) break;
                q = r;
                long ti = 0, ni = 0;
                bool has_t = false, has_n = false;
                if (q < line_end && *q == '/') {
                    ++q;
                    if (q < line_end && *q != '/') {
                        ti = strtol(q, &r, 10);
                        q = r;
                        has_t = true;
                    }
                    if (q < line_end && *q == '/') {
                        ++q;
                        ni = strtol(q, &r, 10);
                        q = r;
                        has_n = true;
                    }
                }
                cv[ncorner] = fix_index(vi, (int64_t)verts.size() / 3);
                ct[ncorner] = has_t ? fix_index(ti, (int64_t)texs.size() / 2) : -1;
                cn[ncorner] = has_n ? fix_index(ni, (int64_t)norms.size() / 3) : -1;
                ++ncorner;
            }
            for (int kk = 1; kk + 1 < ncorner; ++kk) {
                faces.push_back(cv[0]);
                faces.push_back(cv[kk]);
                faces.push_back(cv[kk + 1]);
                ftidx.push_back(ct[0]);
                ftidx.push_back(ct[kk]);
                ftidx.push_back(ct[kk + 1]);
                fnidx.push_back(cn[0]);
                fnidx.push_back(cn[kk]);
                fnidx.push_back(cn[kk + 1]);
            }
        }
        p = line_end + 1;
    }

    auto copy_out = [](const auto &v) -> void * {
        using T = typename std::remove_reference_t<decltype(v)>::value_type;
        void *m = malloc(sizeof(T) * std::max<size_t>(v.size(), 1));
        memcpy(m, v.data(), sizeof(T) * v.size());
        return m;
    };
    out->verts = (float *)copy_out(verts);
    out->norms = (float *)copy_out(norms);
    out->texs = (float *)copy_out(texs);
    out->faces = (int32_t *)copy_out(faces);
    out->fnidx = (int32_t *)copy_out(fnidx);
    out->ftidx = (int32_t *)copy_out(ftidx);
    out->nverts = (int64_t)verts.size() / 3;
    out->nnorms = (int64_t)norms.size() / 3;
    out->ntexs = (int64_t)texs.size() / 2;
    out->nfaces = (int64_t)faces.size() / 3;
    return 0;
}

}  // extern "C"
