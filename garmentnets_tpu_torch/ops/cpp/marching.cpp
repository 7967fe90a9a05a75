// Host-side isosurface extraction over a regular grid.
//
// TPU-native replacement for skimage.measure.marching_cubes (Cython Lewiner)
// used by the reference at predict.py:172-177 (SURVEY.md §2.3 #8). Two
// methods share the vertex-welding infrastructure:
//
// - method 0 (default, "cubes"): procedural marching cubes — vertices only
//   on crossing CUBE edges (same density as Lewiner, ~1 vert/active cube).
//   Per cube: marching-squares contours on each face (face-ambiguous cases
//   resolved by the face-center average, which both adjacent cubes compute
//   identically -> crack-free), contour segments chained into closed loops
//   (every crossing cube edge lies on exactly 2 faces so the segment graph
//   has degree 2), each loop fan-triangulated. No case tables to get wrong.
// - method 1 ("tetrahedra"): 6-tet cube split around the main diagonal;
//   ~3x more vertices (face/body-diagonal crossings) but simplicial-exact.
// - method 2 ("trilinear"): the trilinear-topology variant — the topology
//   class skimage's Lewiner tables encode (reference predict.py:172-177).
//   Same vertex set as method 0 (crossing edges depend only on corner
//   signs); differs in AMBIGUITY RESOLUTION: face-ambiguous cases use the
//   asymptotic decider (sign of the bilinear saddle value, identical on
//   both sides of the face -> still crack-free), and cubes whose contour
//   chains into >= 2 loops run an interior connectivity test on the
//   trilinear interpolant (sampled on an 8^3 sub-lattice) — loops whose
//   inside-corner sets join through the cube interior are stitched into a
//   tunnel band instead of two caps. Used to MEASURE the procedural
//   method's deviation bound (docs/PARITY.md); method 0 stays the default.
//
// Vertices are interpolated on grid-vertex pairs and welded via an
// open-addressing hash map so the output is an indexed (verts, faces) mesh
// like skimage's. Variable-size output keeps this off-device; the predict
// harness overlaps it with the next batch's TPU work.
//
// Build: g++ -O3 -shared -fPIC -o libmarching.so marching.cpp

#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Mesh {
    std::vector<float> verts;   // 3 * nv
    std::vector<int32_t> faces; // 3 * nf
    std::vector<int32_t> ranks; // nv (brick mode w/ ranks: canonical
                                //     crossing-edge rank of each vertex)
    std::vector<float> values;  // nv (want_values: max of the vertex's
                                //     crossing-edge endpoint values — the
                                //     skimage `values` local-max measure)
    std::vector<float> normals; // 3 * nv (want_normals: unit volume-
                                //     gradient normals, skimage-semantics:
                                //     central differences of the field at
                                //     the edge endpoints, lerped at the
                                //     vertex — reference stores skimage's
                                //     gradient normals, predict.py:172-197)
};

// open-addressing hash map: 64-bit edge key -> vertex index; grows at 50%
// load (a fixed capacity would loop forever on noisy volumes whose crossing
// count exceeds the initial estimate)
struct EdgeMap {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    size_t mask;
    size_t count = 0;
    explicit EdgeMap(size_t expected) {
        size_t cap = 64;
        while (cap < expected * 2) cap <<= 1;
        keys.assign(cap, UINT64_MAX);
        vals.assign(cap, -1);
        mask = cap - 1;
    }
    void grow() {
        std::vector<uint64_t> old_keys;
        std::vector<int32_t> old_vals;
        old_keys.swap(keys);
        old_vals.swap(vals);
        size_t cap = (mask + 1) * 2;
        keys.assign(cap, UINT64_MAX);
        vals.assign(cap, -1);
        mask = cap - 1;
        for (size_t i = 0; i <= (old_keys.size() - 1); ++i) {
            if (old_keys[i] == UINT64_MAX) continue;
            size_t h = (old_keys[i] * 0x9E3779B97F4A7C15ULL) & mask;
            while (keys[h] != UINT64_MAX) h = (h + 1) & mask;
            keys[h] = old_keys[i];
            vals[h] = old_vals[i];
        }
    }
    int32_t* slot(uint64_t key) {
        if (count * 2 >= mask + 1) grow();
        size_t h = (key * 0x9E3779B97F4A7C15ULL) & mask;
        while (keys[h] != UINT64_MAX && keys[h] != key) h = (h + 1) & mask;
        if (keys[h] == UINT64_MAX) ++count;
        keys[h] = key;
        return &vals[h];
    }
};

struct Extractor {
    const float* vol;          // full volume, or null in sparse modes
    int64_t nx, ny, nz;
    float level;
    float sx, sy, sz;
    bool ascent;
    Mesh mesh;
    EdgeMap edge_map;
    // active-list mode: per-cube corner values keyed by global vertex id
    EdgeMap val_map;           // reused as id->slot map (key = global id)
    std::vector<float> sparse_vals;
    // brick mode: quantized 4^3 int8 bricks + dense block-grid row map
    const int8_t* bricks = nullptr;       // [n_bricks * 64], local C-order
    const int32_t* brick_row = nullptr;   // [nbx*nby*nbz] -> row or -1
    const uint8_t* cube_masks = nullptr;  // [n_bricks * 8] straddle bits
                                          //   (LE; bit loc = local cube)
    int64_t nbx = 0, nby = 0, nbz = 0;
    float qscale = 0.f;                   // dequant: q / qscale + level
    // brick-mode edge welding: every grid edge is canonically owned by the
    // brick containing its origin voxel (dir * 64 + local voxel id -> 192
    // slots per brick). Direct indexing replaces the open-addressing hash
    // (~1M probes/batch over a >L2-sized table was the dominant MC cost);
    // lookups from adjacent cubes hit the same cache-hot brick row.
    std::vector<int32_t> brick_edges;     // [n_bricks * 192], -1 = empty
    // crossing-edge ranking (brick mode, want_ranks): per-brick 192-bit
    // crossing bitmaps + exclusive prefix counts reproduce the DEVICE's
    // canonical crossing-edge enumeration (ops/isosurface
    // extract_crossing_edges), so every vertex can be tagged with the index
    // of its edge in the device's on-device warp-query output.
    bool want_ranks = false;
    bool want_values = false;             // emit per-vertex Mesh::values
    bool want_normals = false;            // emit per-vertex Mesh::normals
    std::vector<uint64_t> cross_bits;     // [n_bricks * 3] (64 bits/dir)
    std::vector<int64_t> cross_prefix;    // [n_bricks] exclusive

    // power-of-two grid decode: production volumes are 128/256 per axis,
    // so the per-vertex id->coords decodes on the gradient/weld hot paths
    // (~30 per emitted vertex) become shifts instead of int64 divisions
    int lz2 = -1, ly2 = -1;               // log2(nz), log2(ny) or -1
    // brick dequantization LUT: q -> (float)q / qscale + level, each entry
    // computed with the same f32 division as the scalar path, so lookups
    // are bit-identical to it (and to the numpy host dequant) while the
    // hot loops drop one int->float convert + divide per voxel touched
    float dq_lut[256];
    inline float dq(int8_t q) const { return dq_lut[(uint8_t)q]; }
    void build_dq_lut() {
        for (int i = 0; i < 256; ++i)
            dq_lut[i] = (float)(int8_t)(uint8_t)i / qscale + level;
    }

    Extractor(const float* v, int64_t nx_, int64_t ny_, int64_t nz_,
              float level_, float sx_, float sy_, float sz_, bool ascent_,
              size_t expected_active = 0)
        : vol(v), nx(nx_), ny(ny_), nz(nz_), level(level_),
          sx(sx_), sy(sy_), sz(sz_), ascent(ascent_),
          edge_map(v ? (size_t)(nx_ * ny_ * nz_ / 4 + 64)
                     : expected_active * 4 + 64),
          val_map(v ? 1 : expected_active * 8 + 64) {
        if (nz_ > 0 && (nz_ & (nz_ - 1)) == 0
                && ny_ > 0 && (ny_ & (ny_ - 1)) == 0) {
            lz2 = __builtin_ctzll((uint64_t)nz_);
            ly2 = __builtin_ctzll((uint64_t)ny_);
        }
    }

    inline void coords(int64_t g, int64_t& x, int64_t& y, int64_t& z)
        const {
        if (lz2 >= 0) {
            z = g & (nz - 1);
            y = (g >> lz2) & (ny - 1);
            x = g >> (lz2 + ly2);
        } else {
            z = g % nz; y = (g / nz) % ny; x = g / (nz * ny);
        }
    }

    inline float val(int64_t g) const {
        if (vol) return vol[g];
        if (bricks) {
            // brick mode: direct computed lookup, no hashing. Dequantization
            // is float32 division to bit-match the numpy host path
            // (q.astype(f32) / VAL_QUANT_SCALE + level).
            int64_t x, y, z; coords(g, x, y, z);
            int64_t row = brick_row[((x >> 2) * nby + (y >> 2)) * nbz
                                    + (z >> 2)];
            return dq(bricks[row * 64 + (((x & 3) << 4) | ((y & 3) << 2)
                                         | (z & 3))]);
        }
        // active mode: lookup in sparse store (key always present —
        // every queried id was registered by note_corner)
        int32_t* slot = const_cast<EdgeMap&>(val_map).slot((uint64_t)g);
        return sparse_vals[*slot];
    }

    // availability check + value fetch in ONE coordinate decode: grad()
    // previously paid has(x,y,z) followed by val(g) — two full decodes
    // plus two brick-row lookups — per available neighbor
    inline bool try_val(int64_t x, int64_t y, int64_t z, float* out)
        const {
        if (x < 0 || y < 0 || z < 0 || x >= nx || y >= ny || z >= nz)
            return false;
        if (vol) {
            *out = vol[(x * ny + y) * nz + z];
            return true;
        }
        if (bricks) {
            int64_t row = brick_row[((x >> 2) * nby + (y >> 2)) * nbz
                                    + (z >> 2)];
            if (row < 0) return false;
            *out = dq(bricks[row * 64 + (((x & 3) << 4) | ((y & 3) << 2)
                                         | (z & 3))]);
            return true;
        }
        int32_t* slot = const_cast<EdgeMap&>(val_map).slot(
            (uint64_t)((x * ny + y) * nz + z));
        if (*slot < 0) return false;
        *out = sparse_vals[*slot];
        return true;
    }

    // value availability (drives one-sided fallbacks in grad()): full-
    // volume mode has everything in bounds; brick mode only the shipped
    // bricks; active mode only the noted corners
    inline bool has(int64_t x, int64_t y, int64_t z) const {
        if (x < 0 || y < 0 || z < 0 || x >= nx || y >= ny || z >= nz)
            return false;
        if (vol) return true;
        if (bricks)
            return brick_row[((x >> 2) * nby + (y >> 2)) * nbz
                             + (z >> 2)] >= 0;
        int32_t* slot = const_cast<EdgeMap&>(val_map).slot(
            (uint64_t)((x * ny + y) * nz + z));
        return *slot >= 0;
    }

    // volume gradient at a grid vertex: np.gradient semantics (interior
    // central difference, one-sided where the neighbor is unavailable —
    // at the volume boundary exactly like numpy; in the sparse modes also
    // at un-shipped bricks, a documented approximation 1+ voxels off the
    // surface). Physical units (divided by spacing).
    inline void grad(int64_t g, float out[3]) const {
        int64_t x, y, z;
        coords(g, x, y, z);
        grad_xyz(x, y, z, out);
    }

    inline void grad_xyz(int64_t x, int64_t y, int64_t z,
                         float out[3]) const {
        int64_t g = (x * ny + y) * nz + z;
        const float sp[3] = {sx, sy, sz};
        float vc = 0.f;
        bool vc_known = false;
        for (int a = 0; a < 3; ++a) {
            int64_t p[3] = {x, y, z};
            float vp, vm;
            p[a] += 1;
            bool hp = try_val(p[0], p[1], p[2], &vp);
            p[a] -= 2;
            bool hm = try_val(p[0], p[1], p[2], &vm);
            if (hp && hm) {
                out[a] = (vp - vm) / (2.f * sp[a]);
            } else if (hp || hm) {
                // one-sided difference needs the center value once
                if (!vc_known) { vc = val(g); vc_known = true; }
                out[a] = hp ? (vp - vc) / sp[a] : (vc - vm) / sp[a];
            } else {
                out[a] = 0.f;
            }
        }
    }

    inline void note_corner(int64_t g, float v) {
        int32_t* slot = val_map.slot((uint64_t)g);
        if (*slot < 0) {
            *slot = (int32_t)sparse_vals.size();
            sparse_vals.push_back(v);
        }
    }

    inline int32_t edge_vertex(int64_t ga, int64_t gb) {
        return edge_vertex_v(ga, gb, val(ga), val(gb));
    }

    // value-carrying variant: callers that already hold the corner values
    // (the MC cube processor, the brick mode) skip the val() lookups
    inline int32_t edge_vertex_v(int64_t ga, int64_t gb, float va, float vb) {
        if (ga > gb) {
            int64_t t = ga; ga = gb; gb = t;
            float tv = va; va = vb; vb = tv;
        }
        int32_t* v;
        int64_t d = gb - ga;
        int32_t rank = -1;
        if (!brick_edges.empty()
                && (d == 1 || d == nz || d == ny * nz)) {
            // canonical owner slot: axis-aligned edge with origin ga (the
            // smaller id), so (owner brick, local voxel, direction) indexes
            // the dense per-brick table. Non-axis edges (tetrahedra-mode
            // diagonals) fall through to the hash.
            int dir = (d == 1) ? 2 : (d == nz ? 1 : 0);
            int64_t x, y, z; coords(ga, x, y, z);
            int64_t row = brick_row[((x >> 2) * nby + (y >> 2)) * nbz
                                    + (z >> 2)];
            int loc = ((int)(x & 3) << 4) | ((int)(y & 3) << 2)
                      | (int)(z & 3);
            v = &brick_edges[row * 192 + dir * 64 + loc];
            if (*v < 0 && want_ranks) {
                uint64_t bits = cross_bits[row * 3 + dir];
                uint64_t below = (loc == 0) ? 0 : (bits << (64 - loc));
                int64_t r = cross_prefix[row];
                for (int dd = 0; dd < dir; ++dd)
                    r += __builtin_popcountll(cross_bits[row * 3 + dd]);
                r += __builtin_popcountll(below);
                rank = (int32_t)r;
            }
        } else {
            uint64_t key = ((uint64_t)ga << 32) | (uint64_t)gb;
            v = edge_map.slot(key);
        }
        if (*v >= 0) return *v;
        float t = (vb != va) ? (level - va) / (vb - va) : 0.5f;
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        // decode grid coords (C-order: x major)
        int64_t ax, ay, az, bx, by, bz;
        coords(ga, ax, ay, az);
        coords(gb, bx, by, bz);
        float px = ((float)ax + t * (float)(bx - ax)) * sx;
        float py = ((float)ay + t * (float)(by - ay)) * sy;
        float pz = ((float)az + t * (float)(bz - az)) * sz;
        int32_t idx = (int32_t)(mesh.verts.size() / 3);
        mesh.verts.push_back(px);
        mesh.verts.push_back(py);
        mesh.verts.push_back(pz);
        if (want_ranks) mesh.ranks.push_back(rank);
        if (want_values) mesh.values.push_back(va > vb ? va : vb);
        if (want_normals) {
            // skimage-semantics gradient normal: the vertex lies ON the
            // ga-gb edge, so trilinear interpolation of the grid-vertex
            // gradients reduces to a lerp of the two endpoint gradients.
            // Sign matches this kernel's face orientation (emit(): normals
            // point away from the inside region): inside is v > level
            // under 'ascent', so outward is -grad; +grad under 'descent'.
            float gA[3], gB[3];
            grad(ga, gA);
            grad(gb, gB);
            float n0 = gA[0] + t * (gB[0] - gA[0]);
            float n1 = gA[1] + t * (gB[1] - gA[1]);
            float n2 = gA[2] + t * (gB[2] - gA[2]);
            float len = std::sqrt(n0 * n0 + n1 * n1 + n2 * n2);
            float s = (ascent ? -1.f : 1.f) / (len > 0.f ? len : 1.f);
            mesh.normals.push_back(n0 * s);
            mesh.normals.push_back(n1 * s);
            mesh.normals.push_back(n2 * s);
        }
        *v = idx;
        return idx;
    }

    // brick-context weld (run_bricks hot path). The caller already holds
    // the 2x2x2 neighbor-brick rows and the cube's local coords, so the
    // edge's canonical owner slot becomes ONE indexed load — no global-id
    // decode and no scattered brick_row gather per lookup. Those two made
    // the generic weld ~75 ns/call at ~4 calls per active cube, the
    // largest single cost in the kernel (measured /tmp stage splits,
    // 2026-08-20: weld lookups ~10 of 19.5 ms at 128^3 cloth).
    struct BrickCtx {
        const int64_t* rows;   // [8] brick rows, index (dx<<2)|(dy<<1)|dz
        int lx, ly, lz;        // cube origin, local in [0,3]
        int64_t bx, by, bz;    // brick origin in voxels
    };
    static const int CDX[8], CDY[8], CDZ[8];        // corner offsets
    static const int EDGE_DIR[12];                  // cube edge -> axis
    static const int EDGE_ORIG[12];                 // -> origin corner
    static const bool EDGE_SWAPPED[12];             // origin == EDGE_C[1]

    int32_t edge_vertex_brick(const BrickCtx& c, int e, float va, float vb) {
        const int o = EDGE_ORIG[e], dir = EDGE_DIR[e];
        const int ox = c.lx + CDX[o], oy = c.ly + CDY[o],
                  oz = c.lz + CDZ[o];                     // in [0,4]
        // the origin corner is one of the processed cube's corners, so its
        // brick is present (run_bricks skips cubes with missing corners)
        const int64_t row = c.rows[((ox >> 2) << 2) | ((oy >> 2) << 1)
                                   | (oz >> 2)];
        const int loc = ((ox & 3) << 4) | ((oy & 3) << 2) | (oz & 3);
        int32_t* v = &brick_edges[row * 192 + dir * 64 + loc];
        if (*v >= 0) return *v;
        if (EDGE_SWAPPED[e]) { float tv = va; va = vb; vb = tv; }
        int32_t rank = -1;
        if (want_ranks) {
            uint64_t bits = cross_bits[row * 3 + dir];
            uint64_t below = (loc == 0) ? 0 : (bits << (64 - loc));
            int64_t r = cross_prefix[row];
            for (int dd = 0; dd < dir; ++dd)
                r += __builtin_popcountll(cross_bits[row * 3 + dd]);
            r += __builtin_popcountll(below);
            rank = (int32_t)r;
        }
        float t = (vb != va) ? (level - va) / (vb - va) : 0.5f;
        if (t < 0.f) t = 0.f;
        if (t > 1.f) t = 1.f;
        const int64_t gx = c.bx + ox, gy = c.by + oy, gz = c.bz + oz;
        float px = ((float)gx + (dir == 0 ? t : 0.f)) * sx;
        float py = ((float)gy + (dir == 1 ? t : 0.f)) * sy;
        float pz = ((float)gz + (dir == 2 ? t : 0.f)) * sz;
        int32_t idx = (int32_t)(mesh.verts.size() / 3);
        mesh.verts.push_back(px);
        mesh.verts.push_back(py);
        mesh.verts.push_back(pz);
        if (want_ranks) mesh.ranks.push_back(rank);
        if (want_values) mesh.values.push_back(va > vb ? va : vb);
        if (want_normals) {
            float gA[3], gB[3];
            grad_xyz(gx, gy, gz, gA);
            grad_xyz(gx + (dir == 0), gy + (dir == 1), gz + (dir == 2), gB);
            float n0 = gA[0] + t * (gB[0] - gA[0]);
            float n1 = gA[1] + t * (gB[1] - gA[1]);
            float n2 = gA[2] + t * (gB[2] - gA[2]);
            float len = std::sqrt(n0 * n0 + n1 * n1 + n2 * n2);
            float s = (ascent ? -1.f : 1.f) / (len > 0.f ? len : 1.f);
            mesh.normals.push_back(n0 * s);
            mesh.normals.push_back(n1 * s);
            mesh.normals.push_back(n2 * s);
        }
        *v = idx;
        return idx;
    }

    inline void emit(int32_t a, int32_t b, int32_t c,
                     const float* inside_pt) {
        // orient the triangle so its normal points away from the inside
        // region (outward for 'ascent'); chamfer/eval are orientation
        // agnostic, this keeps normals meaningful.
        const float* pa = &mesh.verts[3 * a];
        const float* pb = &mesh.verts[3 * b];
        const float* pc = &mesh.verts[3 * c];
        float e1[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
        float e2[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
        float n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                      e1[2] * e2[0] - e1[0] * e2[2],
                      e1[0] * e2[1] - e1[1] * e2[0]};
        float cx = (pa[0] + pb[0] + pc[0]) / 3.f - inside_pt[0];
        float cy = (pa[1] + pb[1] + pc[1]) / 3.f - inside_pt[1];
        float cz = (pa[2] + pb[2] + pc[2]) / 3.f - inside_pt[2];
        bool flip = (n[0] * cx + n[1] * cy + n[2] * cz) < 0.f;
        mesh.faces.push_back(a);
        if (flip) { mesh.faces.push_back(c); mesh.faces.push_back(b); }
        else      { mesh.faces.push_back(b); mesh.faces.push_back(c); }
    }

    inline void vert_pos(int64_t g, float* p) const {
        int64_t x, y, z; coords(g, x, y, z);
        p[0] = (float)x * sx; p[1] = (float)y * sy; p[2] = (float)z * sz;
    }

    void tet(int64_t g0, int64_t g1, int64_t g2, int64_t g3) {
        int64_t g[4] = {g0, g1, g2, g3};
        bool in[4];
        int code = 0, n_in = 0;
        for (int i = 0; i < 4; ++i) {
            float v = val(g[i]);
            in[i] = ascent ? (v > level) : (v < level);
            if (in[i]) { code |= (1 << i); ++n_in; }
        }
        if (n_in == 0 || n_in == 4) return;
        if (n_in == 1 || n_in == 3) {
            // one corner separated: single triangle around it
            int apex = -1;
            for (int i = 0; i < 4; ++i)
                if (in[i] == (n_in == 1)) apex = i;
            int32_t tri[3];
            int k = 0;
            for (int i = 0; i < 4; ++i)
                if (i != apex) tri[k++] = edge_vertex(g[apex], g[i]);
            // reference point inside the surface
            float ref[3];
            if (n_in == 1) {
                vert_pos(g[apex], ref);
            } else {
                float acc[3] = {0, 0, 0}, p[3];
                for (int i = 0; i < 4; ++i) {
                    if (i == apex) continue;
                    vert_pos(g[i], p);
                    acc[0] += p[0]; acc[1] += p[1]; acc[2] += p[2];
                }
                ref[0] = acc[0] / 3.f; ref[1] = acc[1] / 3.f;
                ref[2] = acc[2] / 3.f;
            }
            emit(tri[0], tri[1], tri[2], ref);
        } else {
            // 2 in / 2 out: quad split into two triangles
            int ins[2], outs[2];
            int ki = 0, ko = 0;
            for (int i = 0; i < 4; ++i)
                (in[i] ? ins[ki++] : outs[ko++]) = i;
            int32_t q00 = edge_vertex(g[ins[0]], g[outs[0]]);
            int32_t q01 = edge_vertex(g[ins[0]], g[outs[1]]);
            int32_t q11 = edge_vertex(g[ins[1]], g[outs[1]]);
            int32_t q10 = edge_vertex(g[ins[1]], g[outs[0]]);
            float p0[3], p1[3], ref[3];
            vert_pos(g[ins[0]], p0);
            vert_pos(g[ins[1]], p1);
            ref[0] = (p0[0] + p1[0]) * .5f;
            ref[1] = (p0[1] + p1[1]) * .5f;
            ref[2] = (p0[2] + p1[2]) * .5f;
            emit(q00, q01, q11, ref);
            emit(q00, q11, q10, ref);
        }
    }

    // 6-tet decomposition around main diagonal c0-c6
    // corner offsets (dx,dy,dz):
    // 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
    // 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
    static const int TETS[6][4];
    static const int EDGE_C[12][2];   // cube edge -> corner pair
    static const int FACE_C[6][4];    // face -> cyclic corner quad
    static const int FACE_E[6][4];    // face -> edge between corner k, k+1

    // marching-cubes mode: marching squares per face -> loops -> fans.
    // vin (optional) carries pre-fetched corner values (brick mode);
    // ctx (optional) enables the direct brick-context weld + vert_pos.
    inline void process_cube_mc(int64_t base, const int64_t* off,
                                const float* vin = nullptr,
                                const BrickCtx* ctx = nullptr) {
        float v[8];
        bool in[8];
        int n_in = 0;
        for (int c = 0; c < 8; ++c) {
            v[c] = vin ? vin[c] : val(base + off[c]);
            in[c] = ascent ? (v[c] > level) : (v[c] < level);
            n_in += in[c];
        }
        if (n_in == 0 || n_in == 8) return;

        int partner[12][2];
        int pcount[12] = {0};
        auto add_seg = [&](int ea, int eb) {
            partner[ea][pcount[ea]++] = eb;
            partner[eb][pcount[eb]++] = ea;
        };
        for (int f = 0; f < 6; ++f) {
            const int* fc = FACE_C[f];
            const int* fe = FACE_E[f];
            int m = (in[fc[0]] ? 1 : 0) | (in[fc[1]] ? 2 : 0)
                  | (in[fc[2]] ? 4 : 0) | (in[fc[3]] ? 8 : 0);
            if (m == 0 || m == 15) continue;
            if (m == 5 || m == 10) {
                // diagonal (ambiguous): both adjacent cubes see the same 4
                // values, so any corner-value-only decision keeps the two
                // triangulations consistent (no cracks).
                //   method 0: face-center average;
                //   method 2: asymptotic decider — the exact bilinear
                //   saddle value (Nielson-Hamann; what Lewiner's face
                //   tests encode)
                float center;
                if (method == 2) {
                    float a = v[fc[0]] - level, b = v[fc[1]] - level,
                          c = v[fc[2]] - level, d = v[fc[3]] - level;
                    float den = a + c - b - d;
                    center = (den != 0.f)
                                 ? (a * c - b * d) / den + level
                                 : (v[fc[0]] + v[fc[1]] + v[fc[2]]
                                    + v[fc[3]]) * 0.25f;
                } else {
                    center = (v[fc[0]] + v[fc[1]] + v[fc[2]] + v[fc[3]])
                             * 0.25f;
                }
                bool cin = ascent ? (center > level) : (center < level);
                // center joined to the inside diagonal -> contour isolates
                // each OUTSIDE corner; otherwise isolates each inside corner
                int j0 = (m == 5) == cin ? 1 : 0;
                add_seg(fe[(j0 + 3) & 3], fe[j0]);
                add_seg(fe[(j0 + 1) & 3], fe[j0 + 2 & 3]);
                continue;
            }
            // count inside corners on this face
            int cnt = (m & 1) + ((m >> 1) & 1) + ((m >> 2) & 1)
                    + ((m >> 3) & 1);
            if (cnt == 1 || cnt == 3) {
                int k = 0;  // the isolated corner
                int want = (cnt == 1);
                for (int i = 0; i < 4; ++i)
                    if (((m >> i) & 1) == want) k = i;
                add_seg(fe[(k + 3) & 3], fe[k]);
            } else {  // adjacent pair
                int k = 0;
                for (int i = 0; i < 4; ++i) {
                    int j = (i + 1) & 3;
                    if (((m >> i) & 1) && ((m >> j) & 1)) k = i;
                }
                add_seg(fe[(k + 3) & 3], fe[(k + 1) & 3]);
            }
        }

        // orientation reference: centroid of inside corners
        float ref[3] = {0.f, 0.f, 0.f};
        if (ctx) {
            for (int c = 0; c < 8; ++c) {
                if (!in[c]) continue;
                ref[0] += (float)(ctx->bx + ctx->lx + CDX[c]) * sx;
                ref[1] += (float)(ctx->by + ctx->ly + CDY[c]) * sy;
                ref[2] += (float)(ctx->bz + ctx->lz + CDZ[c]) * sz;
            }
            ref[0] /= n_in; ref[1] /= n_in; ref[2] /= n_in;
        } else {
            float p[3];
            for (int c = 0; c < 8; ++c) {
                if (!in[c]) continue;
                vert_pos(base + off[c], p);
                ref[0] += p[0]; ref[1] += p[1]; ref[2] += p[2];
            }
            ref[0] /= n_in; ref[1] /= n_in; ref[2] /= n_in;
        }

        // chain contour segments into closed loops (collected first:
        // method 2 may stitch two loops into a tunnel band)
        int loops[4][12];
        int loop_n[4] = {0, 0, 0, 0};
        int n_loops = 0;
        bool used[12] = {false};
        for (int e0 = 0; e0 < 12 && n_loops < 4; ++e0) {
            if (pcount[e0] == 0 || used[e0]) continue;
            int* loop = loops[n_loops];
            int n = 0;
            int prev = -1, cur = e0;
            do {
                loop[n++] = cur;
                used[cur] = true;
                int nxt = (partner[cur][0] == prev) ? partner[cur][1]
                                                    : partner[cur][0];
                prev = cur;
                cur = nxt;
            } while (cur != e0 && n < 12);
            if (n < 3) continue;
            loop_n[n_loops++] = n;
        }

        int32_t vids[4][12];
        for (int li = 0; li < n_loops; ++li)
            for (int i = 0; i < loop_n[li]; ++i) {
                const int e = loops[li][i];
                vids[li][i] = ctx
                    ? edge_vertex_brick(*ctx, e, v[EDGE_C[e][0]],
                                        v[EDGE_C[e][1]])
                    : edge_vertex_v(base + off[EDGE_C[e][0]],
                                    base + off[EDGE_C[e][1]],
                                    v[EDGE_C[e][0]], v[EDGE_C[e][1]]);
            }

        // method 2 interior test: loops whose inside-corner sets connect
        // through the trilinear interior form a tunnel (one annulus), not
        // two caps (what Lewiner's interior tests t4/t6/.../t13 decide)
        int group_of[4] = {0, 1, 2, 3};
        if (method == 2 && n_loops >= 2) {
            uint8_t in_mask[4] = {0, 0, 0, 0};
            for (int li = 0; li < n_loops; ++li)
                for (int i = 0; i < loop_n[li]; ++i) {
                    int ca = EDGE_C[loops[li][i]][0];
                    int cb = EDGE_C[loops[li][i]][1];
                    in_mask[li] |= (uint8_t)(1 << (in[ca] ? ca : cb));
                }
            int comp[8];
            interior_components(v, comp);
            for (int a = 0; a < n_loops; ++a)
                for (int b = a + 1; b < n_loops; ++b) {
                    bool joined = false;
                    for (int ca = 0; ca < 8 && !joined; ++ca) {
                        if (!(in_mask[a] >> ca & 1) || comp[ca] < 0)
                            continue;
                        for (int cb = 0; cb < 8; ++cb)
                            if ((in_mask[b] >> cb & 1)
                                    && comp[cb] == comp[ca]) {
                                joined = true;
                                break;
                            }
                    }
                    if (joined) {
                        int ga = group_of[a], gb = group_of[b];
                        for (int k = 0; k < n_loops; ++k)
                            if (group_of[k] == gb) group_of[k] = ga;
                    }
                }
        }

        bool done[4] = {false, false, false, false};
        for (int a = 0; a < n_loops; ++a) {
            if (done[a]) continue;
            int partner_loop = -1;
            for (int b = a + 1; b < n_loops; ++b)
                if (!done[b] && group_of[b] == group_of[a]) {
                    partner_loop = (partner_loop < 0) ? b : -2;
                }
            if (partner_loop >= 0) {
                // tunnel: stitch the two loops into a band
                stitch_band(vids[a], loop_n[a], vids[partner_loop],
                            loop_n[partner_loop], ref);
                done[a] = done[partner_loop] = true;
                continue;
            }
            // cap (or >2 joined loops — not representable as one band;
            // fall back to caps, the method-0 behavior)
            done[a] = true;
            int n = loop_n[a];
            const int32_t* vid = vids[a];
            for (int i = 1; i + 1 < n; ++i) {
                if (vid[0] == vid[i] || vid[i] == vid[i + 1]
                        || vid[0] == vid[i + 1])
                    continue;  // degenerate (crossing at a shared corner)
                emit(vid[0], vid[i], vid[i + 1], ref);
            }
        }
    }

    // connected components of {trilinear F inside} sampled on a (K+1)^3
    // sub-lattice of the cube; returns per-corner component label (-1 for
    // outside corners). K=8 resolves every tunnel geometry a trilinear
    // interpolant can form at well over the f32 noise floor.
    void interior_components(const float* v, int comp[8]) const {
        static const int K = 8;
        static const int NS = (K + 1) * (K + 1) * (K + 1);
        int lbl[NS];
        // corner order: 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
        //               4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
        for (int ix = 0; ix <= K; ++ix) {
            float x = (float)ix / K;
            for (int iy = 0; iy <= K; ++iy) {
                float y = (float)iy / K;
                for (int iz = 0; iz <= K; ++iz) {
                    float z = (float)iz / K;
                    float f =
                        v[0] * (1 - x) * (1 - y) * (1 - z)
                        + v[1] * x * (1 - y) * (1 - z)
                        + v[2] * x * y * (1 - z)
                        + v[3] * (1 - x) * y * (1 - z)
                        + v[4] * (1 - x) * (1 - y) * z
                        + v[5] * x * (1 - y) * z
                        + v[6] * x * y * z
                        + v[7] * (1 - x) * y * z;
                    bool ins = ascent ? (f > level) : (f < level);
                    int id = (ix * (K + 1) + iy) * (K + 1) + iz;
                    lbl[id] = ins ? id : -1;
                }
            }
        }
        // label propagation to fixpoint (tiny lattice; ~K iterations)
        bool changed = true;
        while (changed) {
            changed = false;
            for (int ix = 0; ix <= K; ++ix)
                for (int iy = 0; iy <= K; ++iy)
                    for (int iz = 0; iz <= K; ++iz) {
                        int id = (ix * (K + 1) + iy) * (K + 1) + iz;
                        if (lbl[id] < 0) continue;
                        const int nb[6] = {
                            ix > 0 ? id - (K + 1) * (K + 1) : -1,
                            ix < K ? id + (K + 1) * (K + 1) : -1,
                            iy > 0 ? id - (K + 1) : -1,
                            iy < K ? id + (K + 1) : -1,
                            iz > 0 ? id - 1 : -1,
                            iz < K ? id + 1 : -1};
                        for (int k = 0; k < 6; ++k)
                            if (nb[k] >= 0 && lbl[nb[k]] >= 0
                                    && lbl[nb[k]] < lbl[id]) {
                                lbl[id] = lbl[nb[k]];
                                changed = true;
                            }
                    }
        }
        static const int CX[8] = {0, 1, 1, 0, 0, 1, 1, 0};
        static const int CY[8] = {0, 0, 1, 1, 0, 0, 1, 1};
        static const int CZ[8] = {0, 0, 0, 0, 1, 1, 1, 1};
        for (int c = 0; c < 8; ++c)
            comp[c] = lbl[(CX[c] * K * (K + 1) + CY[c] * K) * (K + 1)
                          + CZ[c] * K];
    }

    // stitch two closed loops of welded vertex ids into a triangle band
    // (annulus). Direction/offset of the second loop chosen to minimize
    // total bridge length; triangles oriented by emit() against `ref`.
    void stitch_band(const int32_t* a, int na, const int32_t* b, int nb,
                     const float* ref) {
        const float* V = mesh.verts.data();
        auto dist2 = [&](int32_t p, int32_t q) {
            float dx = V[3 * p] - V[3 * q];
            float dy = V[3 * p + 1] - V[3 * q + 1];
            float dz = V[3 * p + 2] - V[3 * q + 2];
            return dx * dx + dy * dy + dz * dz;
        };
        int best_off = 0, best_dir = 1;
        float best_cost = 1e30f;
        for (int dir = -1; dir <= 1; dir += 2) {
            for (int off = 0; off < nb; ++off) {
                // cost proxy: bridge lengths of the aligned pairing
                float cost = 0.f;
                for (int i = 0; i < na; ++i) {
                    int j = (off + dir * (i * nb / na)) % nb;
                    if (j < 0) j += nb;
                    cost += dist2(a[i], b[j]);
                }
                if (cost < best_cost) {
                    best_cost = cost;
                    best_off = off;
                    best_dir = dir;
                }
            }
        }
        int32_t bb[12];
        for (int j = 0; j < nb; ++j) {
            int k = (best_off + best_dir * j) % nb;
            if (k < 0) k += nb;
            bb[j] = b[k];
        }
        // zip the two rings by fractional progress
        int i = 0, j = 0;
        while (i < na || j < nb) {
            bool adv_a = (i < na)
                && (j >= nb
                    || (float)(i + 1) * nb <= (float)(j + 1) * na);
            int32_t t0, t1, t2;
            if (adv_a) {
                t0 = a[i % na]; t1 = a[(i + 1) % na]; t2 = bb[j % nb];
                ++i;
            } else {
                t0 = a[i % na]; t1 = bb[(j + 1) % nb]; t2 = bb[j % nb];
                ++j;
            }
            if (t0 == t1 || t1 == t2 || t0 == t2) continue;
            emit(t0, t1, t2, ref);
        }
    }

    inline void corner_offsets(int64_t* off) const {
        const int64_t sxv = ny * nz, syv = nz, szv = 1;
        off[0] = 0; off[1] = sxv; off[2] = sxv + syv; off[3] = syv;
        off[4] = szv; off[5] = sxv + szv; off[6] = sxv + syv + szv;
        off[7] = syv + szv;
    }

    // 0 = marching cubes (procedural), 1 = marching tetrahedra,
    // 2 = trilinear-topology marching cubes (asymptotic decider + interior
    //     tunnel test; shares process_cube_mc)
    int method = 0;

    inline void process_cube(int64_t base, const int64_t* corner_off,
                             const float* vin = nullptr,
                             const BrickCtx* ctx = nullptr) {
        if (method != 1) {
            process_cube_mc(base, corner_off, vin, ctx);
            return;
        }
        for (int t = 0; t < 6; ++t)
            tet(base + corner_off[TETS[t][0]],
                base + corner_off[TETS[t][1]],
                base + corner_off[TETS[t][2]],
                base + corner_off[TETS[t][3]]);
    }

    void run() {
        int64_t corner_off[8];
        corner_offsets(corner_off);
        const int64_t sxv = ny * nz, syv = nz;
        for (int64_t x = 0; x + 1 < nx; ++x) {
            for (int64_t y = 0; y + 1 < ny; ++y) {
                int64_t base_row = x * sxv + y * syv;
                for (int64_t z = 0; z + 1 < nz; ++z) {
                    int64_t base = base_row + z;
                    // fast reject: all corners same side
                    bool any_in = false, any_out = false;
                    for (int c = 0; c < 8 && !(any_in && any_out); ++c) {
                        float v = vol[base + corner_off[c]];
                        bool i = ascent ? (v > level) : (v < level);
                        any_in |= i;
                        any_out |= !i;
                    }
                    if (!(any_in && any_out)) continue;
                    process_cube(base, corner_off);
                }
            }
        }
    }

    // active-list mode: cube base ids + per-cube corner values (order
    // matches the corner offsets above)
    void run_active(const int32_t* cube_idx, const float* corner_vals,
                    int64_t n_active) {
        int64_t corner_off[8];
        corner_offsets(corner_off);
        for (int64_t i = 0; i < n_active; ++i) {
            int64_t base = (int64_t)cube_idx[i];
            if (base < 0) continue;  // padding
            for (int c = 0; c < 8; ++c)
                note_corner(base + corner_off[c], corner_vals[i * 8 + c]);
        }
        for (int64_t i = 0; i < n_active; ++i) {
            int64_t base = (int64_t)cube_idx[i];
            if (base < 0) continue;
            process_cube(base, corner_off);
        }
    }

    // crossing bitmaps + prefix: reproduces the device's canonical
    // crossing-edge enumeration (brick list order, slot = dir*64 + local
    // origin). Sides are tested on the RAW int8 (q >= 1 <=> v > level,
    // side-preserving quantization), matching the device's float test.
    void build_cross_ranks(const int32_t* brick_idx, int64_t n_bricks) {
        cross_bits.assign((size_t)n_bricks * 3, 0);
        cross_prefix.assign((size_t)n_bricks, 0);
        static const int DX[3] = {1, 0, 0};
        static const int DY[3] = {0, 1, 0};
        static const int DZ[3] = {0, 0, 1};
        int64_t total = 0;
        for (int64_t i = 0; i < n_bricks; ++i) {
            cross_prefix[i] = total;
            int64_t b = (int64_t)brick_idx[i];
            if (b < 0) continue;
            int64_t bzi = b % nbz, byi = (b / nbz) % nby,
                    bxi = b / (nbz * nby);
            for (int dir = 0; dir < 3; ++dir) {
                uint64_t bits = 0;
                for (int loc = 0; loc < 64; ++loc) {
                    int64_t gx = bxi * 4 + (loc >> 4);
                    int64_t gy = byi * 4 + ((loc >> 2) & 3);
                    int64_t gz = bzi * 4 + (loc & 3);
                    int64_t ex = gx + DX[dir], ey = gy + DY[dir],
                            ez = gz + DZ[dir];
                    if (ex > nx - 1 || ey > ny - 1 || ez > nz - 1) continue;
                    int64_t row2 = brick_row[
                        ((ex >> 2) * nby + (ey >> 2)) * nbz + (ez >> 2)];
                    if (row2 < 0) continue;
                    bool sa = bricks[i * 64 + loc] >= 1;
                    bool sb = bricks[row2 * 64
                        + (((ex & 3) << 4) | ((ey & 3) << 2)
                           | (ez & 3))] >= 1;
                    if (sa != sb) bits |= (1ULL << loc);
                }
                cross_bits[i * 3 + dir] = bits;
                total += __builtin_popcountll(bits);
            }
        }
    }

    // brick mode: discovers the straddling cubes itself. For every local
    // voxel of every shipped brick that is a valid cube origin, gathers the
    // 8 corners from (up to 8) bricks; a cube with a missing corner brick
    // cannot straddle (its origin block would be support-active and all its
    // neighbors shipped), so it is skipped. Emits exactly the cube set of
    // the device's extract_active_cubes on the dequantized field.
    void run_bricks(const int32_t* brick_idx, int64_t n_bricks) {
        build_dq_lut();
        int64_t corner_off[8];
        corner_offsets(corner_off);
        // phase attribution (GARMENTNETS_MC_PROFILE=1): support fill vs
        // cube-rejection scan vs surface emission, to aim future work at
        // the measured phase (e.g. a device-computed straddle mask only
        // pays if 'scan' dominates). ~12 chrono reads/brick, flag-gated.
        const bool prof = getenv("GARMENTNETS_MC_PROFILE") != nullptr;
        double t_fill = 0.0, t_proc = 0.0;
        int64_t n_emit = 0, n_scanned = 0;
        auto now = [] {
            return std::chrono::duration<double>(
                std::chrono::steady_clock::now().time_since_epoch())
                .count();
        };
        double t_all0 = prof ? now() : 0.0;
        // per-cube support index of each corner within the 5^3 cache
        int sup_idx[4][4][4][8];
        for (int lx = 0; lx < 4; ++lx)
            for (int ly = 0; ly < 4; ++ly)
                for (int lz = 0; lz < 4; ++lz)
                    for (int c = 0; c < 8; ++c)
                        sup_idx[lx][ly][lz][c] =
                            ((lx + CDX[c]) * 5 + (ly + CDY[c])) * 5
                            + (lz + CDZ[c]);
        float sup[125];
        bool okv[125];
        for (int64_t i = 0; i < n_bricks; ++i) {
            int64_t b = (int64_t)brick_idx[i];
            if (b < 0) continue;  // padding
            int64_t bzi = b % nbz, byi = (b / nbz) % nby,
                    bxi = b / (nbz * nby);
            int64_t bx = bxi * 4, by = byi * 4, bz = bzi * 4;
            // rows of the 8 bricks covering the 5^3 support (self + the
            // positive-face neighbors); -1 = absent or out of grid
            int64_t rows[8];
            for (int d = 0; d < 8; ++d) {
                int64_t qx = bxi + ((d >> 2) & 1), qy = byi + ((d >> 1) & 1),
                        qz = bzi + (d & 1);
                rows[d] = (qx < nbx && qy < nby && qz < nbz)
                              ? brick_row[(qx * nby + qy) * nbz + qz] : -1;
            }
            uint64_t mask_bits = 0;
            if (cube_masks) {
                for (int bbyte = 7; bbyte >= 0; --bbyte)
                    mask_bits = (mask_bits << 8) | cube_masks[i * 8 + bbyte];
                if (mask_bits == 0) continue;   // no straddle: skip fill too
            }
            // dequantize the 5^3 support once per brick (the division
            // bit-matches the numpy host path)
            double t0 = prof ? now() : 0.0;
            for (int a = 0; a < 5; ++a) {
                int da = a >> 2;
                for (int c = 0; c < 5; ++c) {
                    int dc = c >> 2;
                    for (int e = 0; e < 5; ++e) {
                        int idx = (a * 5 + c) * 5 + e;
                        int64_t row = rows[(da << 2) | (dc << 1) | (e >> 2)];
                        if (row < 0) { okv[idx] = false; continue; }
                        sup[idx] = dq(bricks[row * 64
                            + (((a & 3) << 4) | ((c & 3) << 2) | (e & 3))]);
                        okv[idx] = true;
                    }
                }
            }
            if (prof) t_fill += now() - t0;
            if (cube_masks) {
                // device-computed straddle mask (bit loc = cube at local
                // voxel loc straddles; side-preserving quantization makes
                // it identical to the corner test below): iterate set bits
                // only — the 64-cube rejection scan and the all-empty
                // bricks' support fills are skipped entirely.
                uint64_t m = mask_bits;
                while (m) {
                    int loc = __builtin_ctzll(m);
                    m &= m - 1;
                    int lx = loc >> 4, ly = (loc >> 2) & 3, lz = loc & 3;
                    int64_t gx = bx + lx, gy = by + ly, gz = bz + lz;
                    if (gx + 1 >= nx || gy + 1 >= ny || gz + 1 >= nz)
                        continue;
                    const int* si = sup_idx[lx][ly][lz];
                    float v8[8];
                    bool ok = true;
                    for (int c8 = 0; c8 < 8; ++c8) {
                        int idx = si[c8];
                        if (!okv[idx]) { ok = false; break; }
                        v8[c8] = sup[idx];
                    }
                    ++n_scanned;
                    if (!ok) continue;  // unreachable for true straddles
                    ++n_emit;
                    double tp = prof ? now() : 0.0;
                    BrickCtx ctx{rows, lx, ly, lz, bx, by, bz};
                    process_cube((gx * ny + gy) * nz + gz, corner_off, v8,
                                 method != 1 ? &ctx : nullptr);
                    if (prof) t_proc += now() - tp;
                }
                continue;
            }
            for (int lx = 0; lx < 4; ++lx) {
                int64_t gx = bx + lx;
                if (gx + 1 >= nx) break;
                for (int ly = 0; ly < 4; ++ly) {
                    int64_t gy = by + ly;
                    if (gy + 1 >= ny) break;
                    int64_t base_row = (gx * ny + gy) * nz + bz;
                    for (int lz = 0; lz < 4; ++lz) {
                        int64_t gz = bz + lz;
                        if (gz + 1 >= nz) break;
                        const int* si = sup_idx[lx][ly][lz];
                        float v8[8];
                        bool ok = true, any_in = false, any_out = false;
                        for (int c = 0; c < 8; ++c) {
                            int idx = si[c];
                            if (!okv[idx]) { ok = false; break; }
                            v8[c] = sup[idx];
                            // cube-discovery rule is the direction-
                            // INDEPENDENT (v > level) straddle of
                            // extract_active_cubes / bricks_to_cube_list
                            // (== q >= 1, side-preserving quantization);
                            // process_cube applies the ascent/descent
                            // in-test itself
                            bool in = v8[c] > level;
                            any_in |= in;
                            any_out |= !in;
                        }
                        ++n_scanned;
                        if (!ok || !any_in || !any_out) continue;
                        ++n_emit;
                        double tp = prof ? now() : 0.0;
                        BrickCtx ctx{rows, lx, ly, lz, bx, by, bz};
                        process_cube(base_row + lz, corner_off, v8,
                                     method != 1 ? &ctx : nullptr);
                        if (prof) t_proc += now() - tp;
                    }
                }
            }
        }
        if (prof) {
            double t_all = now() - t_all0;
            fprintf(stderr,
                    "[mc-profile] bricks=%lld scanned=%lld emitted=%lld "
                    "fill=%.1fms scan=%.1fms proc=%.1fms total=%.1fms\n",
                    (long long)n_bricks, (long long)n_scanned,
                    (long long)n_emit, t_fill * 1e3,
                    (t_all - t_fill - t_proc) * 1e3, t_proc * 1e3,
                    t_all * 1e3);
        }
    }
};

const int Extractor::CDX[8] = {0, 1, 1, 0, 0, 1, 1, 0};
const int Extractor::CDY[8] = {0, 0, 1, 1, 0, 0, 1, 1};
const int Extractor::CDZ[8] = {0, 0, 0, 0, 1, 1, 1, 1};

// derived from EDGE_C + the corner offsets: per edge, its axis (the weld
// table's dir slot), the endpoint with the smaller coordinate (== smaller
// flat id, the canonical weld origin), and whether that endpoint is
// EDGE_C[e][1] (the passed va/vb must swap to keep t measured from it)
const int Extractor::EDGE_DIR[12] = {0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2};
const int Extractor::EDGE_ORIG[12] = {0, 1, 3, 0, 4, 5, 7, 4, 0, 1, 2, 3};
const bool Extractor::EDGE_SWAPPED[12] = {
    false, false, true, true, false, false, true, true,
    false, false, false, false};

const int Extractor::TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};

const int Extractor::EDGE_C[12][2] = {
    {0, 1}, {1, 2}, {2, 3}, {3, 0},          // bottom ring (z=0)
    {4, 5}, {5, 6}, {6, 7}, {7, 4},          // top ring (z=1)
    {0, 4}, {1, 5}, {2, 6}, {3, 7}};         // verticals

const int Extractor::FACE_C[6][4] = {
    {0, 1, 2, 3}, {4, 5, 6, 7},              // z = 0, 1
    {0, 1, 5, 4}, {3, 2, 6, 7},              // y = 0, 1
    {0, 3, 7, 4}, {1, 2, 6, 5}};             // x = 0, 1

const int Extractor::FACE_E[6][4] = {
    {0, 1, 2, 3}, {4, 5, 6, 7},
    {0, 9, 4, 8}, {2, 10, 6, 11},
    {3, 11, 7, 8}, {1, 10, 5, 9}};

}  // namespace

extern "C" {

// Shared output marshalling: verts/faces always; values when requested.
static void copy_mesh_out(const Mesh& mesh,
                          float** verts_out, int64_t* nv_out,
                          int32_t** faces_out, int64_t* nf_out,
                          float** values_out, float** normals_out) {
    int64_t nv = (int64_t)(mesh.verts.size() / 3);
    int64_t nf = (int64_t)(mesh.faces.size() / 3);
    *nv_out = nv;
    *nf_out = nf;
    *verts_out = (float*)malloc(sizeof(float) * 3 * (nv ? nv : 1));
    *faces_out = (int32_t*)malloc(sizeof(int32_t) * 3 * (nf ? nf : 1));
    if (nv) memcpy(*verts_out, mesh.verts.data(), sizeof(float) * 3 * nv);
    if (nf) memcpy(*faces_out, mesh.faces.data(), sizeof(int32_t) * 3 * nf);
    if (values_out) {
        *values_out = (float*)malloc(sizeof(float) * (nv ? nv : 1));
        if (nv) memcpy(*values_out, mesh.values.data(), sizeof(float) * nv);
    }
    if (normals_out) {
        *normals_out = (float*)malloc(sizeof(float) * 3 * (nv ? nv : 1));
        if (nv) memcpy(*normals_out, mesh.normals.data(),
                       sizeof(float) * 3 * nv);
    }
}

// Returns 0 on success. Caller frees *verts_out / *faces_out (and, when
// non-NULL, *values_out) with mt_free. values_out (optional): per-vertex
// max of the vertex's edge endpoint values — the skimage marching_cubes
// `values` output ("a measure for the maximum value of the data in the
// local region near each vertex"; reference stores it, predict.py:195-197).
// method: 0 = marching cubes (default), 1 = marching tetrahedra.
int extract_isosurface(
        const float* vol, int64_t nx, int64_t ny, int64_t nz,
        float level, float sx, float sy, float sz, int ascent, int method,
        float** verts_out, int64_t* nv_out,
        int32_t** faces_out, int64_t* nf_out,
        float** values_out, float** normals_out) {
    Extractor ex(vol, nx, ny, nz, level, sx, sy, sz, ascent != 0);
    ex.method = method;
    ex.want_values = values_out != nullptr;
    ex.want_normals = normals_out != nullptr;
    ex.run();
    copy_mesh_out(ex.mesh, verts_out, nv_out, faces_out, nf_out, values_out,
                  normals_out);
    return 0;
}

// Active-list variant: cube base ids (flat vertex index of each cube's
// origin corner; -1 entries are padding) + per-cube corner values in the
// corner order documented in Extractor. Used by the TPU predict path, which
// extracts active cubes on device to avoid shipping full volumes to host.
int extract_isosurface_active(
        const int32_t* cube_idx, const float* corner_vals, int64_t n_active,
        int64_t nx, int64_t ny, int64_t nz,
        float level, float sx, float sy, float sz, int ascent, int method,
        float** verts_out, int64_t* nv_out,
        int32_t** faces_out, int64_t* nf_out,
        float** values_out, float** normals_out) {
    Extractor ex(nullptr, nx, ny, nz, level, sx, sy, sz, ascent != 0,
                 (size_t)n_active);
    ex.method = method;
    ex.want_values = values_out != nullptr;
    ex.want_normals = normals_out != nullptr;
    ex.run_active(cube_idx, corner_vals, n_active);
    copy_mesh_out(ex.mesh, verts_out, nv_out, faces_out, nf_out, values_out,
                  normals_out);
    return 0;
}

// Brick variant: non-overlapping 4^3 int8 bricks (the TPU predict engine's
// production wire format — see ops/isosurface.extract_active_bricks).
// brick_idx holds flat indices into the (nx/4, ny/4, nz/4) block grid
// (-1 entries are padding); brick_vals holds 64 side-preserving quantized
// values per brick (local C-order); dequantization is q / qscale + level.
// Discovers the straddling cubes internally (run_bricks), replacing the
// former host-python block expansion step.
// ranks_out (optional, may be NULL): per-vertex canonical crossing-edge
// rank — the index of the vertex's edge in the device's crossing-edge
// enumeration (ops/isosurface.extract_crossing_edges), used to look up
// on-device warp-query results without shipping vertices back to the
// device. -1 for vertices not on an axis edge (tetrahedra diagonals).
static int extract_bricks_impl(
        const int32_t* brick_idx, const int8_t* brick_vals,
        const uint8_t* cube_masks, int64_t n_bricks,
        int64_t nx, int64_t ny, int64_t nz,
        float level, float qscale, float sx, float sy, float sz,
        int ascent, int method,
        float** verts_out, int64_t* nv_out,
        int32_t** faces_out, int64_t* nf_out,
        int32_t** ranks_out, float** values_out, float** normals_out) {
    Extractor ex(nullptr, nx, ny, nz, level, sx, sy, sz, ascent != 0,
                 (size_t)n_bricks * 8);
    ex.cube_masks = cube_masks;
    ex.method = method;
    ex.want_values = values_out != nullptr;
    ex.want_normals = normals_out != nullptr;
    ex.bricks = brick_vals;
    ex.qscale = qscale;
    ex.nbx = nx / 4; ex.nby = ny / 4; ex.nbz = nz / 4;
    ex.brick_edges.assign((size_t)n_bricks * 192, -1);
    std::vector<int32_t> row(ex.nbx * ex.nby * ex.nbz, -1);
    for (int64_t i = 0; i < n_bricks; ++i)
        if (brick_idx[i] >= 0) row[brick_idx[i]] = (int32_t)i;
    ex.brick_row = row.data();
    if (ranks_out) {
        ex.want_ranks = true;
        ex.build_cross_ranks(brick_idx, n_bricks);
    }
    ex.run_bricks(brick_idx, n_bricks);
    copy_mesh_out(ex.mesh, verts_out, nv_out, faces_out, nf_out, values_out,
                  normals_out);
    if (ranks_out) {
        int64_t nv = *nv_out;
        *ranks_out = (int32_t*)malloc(sizeof(int32_t) * (nv ? nv : 1));
        if (nv) memcpy(*ranks_out, ex.mesh.ranks.data(),
                       sizeof(int32_t) * nv);
    }
    return 0;
}

int extract_isosurface_bricks(
        const int32_t* brick_idx, const int8_t* brick_vals, int64_t n_bricks,
        int64_t nx, int64_t ny, int64_t nz,
        float level, float qscale, float sx, float sy, float sz,
        int ascent, int method,
        float** verts_out, int64_t* nv_out,
        int32_t** faces_out, int64_t* nf_out,
        int32_t** ranks_out, float** values_out, float** normals_out) {
    return extract_bricks_impl(
        brick_idx, brick_vals, nullptr, n_bricks, nx, ny, nz, level, qscale,
        sx, sy, sz, ascent, method, verts_out, nv_out, faces_out, nf_out,
        ranks_out, values_out, normals_out);
}

// Masked brick variant: cube_masks carries the device-computed per-brick
// 64-bit cube-straddle masks (ops/isosurface.extract_active_bricks
// with_masks=True; bit loc = cube at local voxel loc straddles). The
// kernel then skips the 64-cube rejection scan and the support fills of
// all-empty bricks — the straddle set is bit-identical to the internal
// corner test by the side-preserving quantization guarantee.
int extract_isosurface_bricks_masked(
        const int32_t* brick_idx, const int8_t* brick_vals,
        const uint8_t* cube_masks, int64_t n_bricks,
        int64_t nx, int64_t ny, int64_t nz,
        float level, float qscale, float sx, float sy, float sz,
        int ascent, int method,
        float** verts_out, int64_t* nv_out,
        int32_t** faces_out, int64_t* nf_out,
        int32_t** ranks_out, float** values_out, float** normals_out) {
    return extract_bricks_impl(
        brick_idx, brick_vals, cube_masks, n_bricks, nx, ny, nz, level,
        qscale, sx, sy, sz, ascent, method, verts_out, nv_out, faces_out,
        nf_out, ranks_out, values_out, normals_out);
}

void mt_free(void* p) { free(p); }

}  // extern "C"
