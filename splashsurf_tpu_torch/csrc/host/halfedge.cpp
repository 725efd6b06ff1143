// Native half-edge collapse engine for mesh post-processing.
//
// The topological edits (Moore/Warren MC cleanup, barnacle decimation) are
// inherently sequential; running them over multi-million-triangle meshes in
// Python is prohibitive. This implements the same semantics as
// splashsurf_tpu_torch/halfedge.py (legality = link condition; see reference
// halfedge_mesh.rs:57-407) with flat adjacency arrays, exposed through a
// plain C ABI for ctypes.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 halfedge.cpp -o libhalfedge.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

struct Mesh {
    int64_t nv;
    int64_t nt;
    std::vector<double> verts;          // 3 * nv
    std::vector<int64_t> tris;          // 3 * nt
    std::vector<uint8_t> tri_valid;
    std::vector<uint8_t> vert_valid;
    std::vector<std::vector<int64_t>> adj;     // vertex -> adjacent vertices
    std::vector<std::vector<int64_t>> v_tris;  // vertex -> incident triangles
    std::vector<int64_t> merged_into;          // original vertex -> current owner

    bool is_valid_vertex(int64_t v) const {
        return vert_valid[v] && !adj[v].empty();
    }
};

bool contains(const std::vector<int64_t>& xs, int64_t x) {
    return std::find(xs.begin(), xs.end(), x) != xs.end();
}

void remove_value(std::vector<int64_t>& xs, int64_t x) {
    xs.erase(std::remove(xs.begin(), xs.end(), x), xs.end());
}

// 0 = ok; 1 = invalid vertex; 2 = missing edge; 3 = boundary/non-manifold;
// 4 = one-ring intersection; 5 = tetrahedron
int is_collapse_ok(const Mesh& m, int64_t v_from, int64_t v_to) {
    if (!m.is_valid_vertex(v_from) || !m.is_valid_vertex(v_to)) return 1;
    if (!contains(m.adj[v_from], v_to)) return 2;

    // shared triangles
    int64_t shared[4];
    int n_shared = 0;
    for (int64_t t : m.v_tris[v_from]) {
        if (contains(m.v_tris[v_to], t)) {
            if (n_shared < 4) shared[n_shared] = t;
            n_shared++;
        }
    }
    if (n_shared != 2) return 3;

    // opposite vertices of the shared faces
    int64_t opp[2];
    int n_opp = 0;
    for (int s = 0; s < 2; s++) {
        for (int k = 0; k < 3; k++) {
            int64_t v = m.tris[3 * shared[s] + k];
            if (v != v_from && v != v_to) opp[n_opp++] = v;
        }
    }
    if (n_opp != 2) return 3;

    // link condition: common neighbors must be exactly the opposite verts
    int n_common = 0;
    for (int64_t u : m.adj[v_from]) {
        if (contains(m.adj[v_to], u)) {
            if (u != opp[0] && u != opp[1]) return 4;
            n_common++;
        }
    }
    if (n_common != 2) return 4;
    if (m.adj[v_from].size() <= 3 && m.adj[v_to].size() <= 3) return 5;
    return 0;
}

void do_collapse(Mesh& m, int64_t v_from, int64_t v_to) {
    // remove shared triangles
    std::vector<int64_t> shared;
    for (int64_t t : m.v_tris[v_from])
        if (contains(m.v_tris[v_to], t)) shared.push_back(t);
    for (int64_t t : shared) {
        m.tri_valid[t] = 0;
        for (int k = 0; k < 3; k++) remove_value(m.v_tris[m.tris[3 * t + k]], t);
    }
    // rewire remaining triangles of v_from
    for (int64_t t : m.v_tris[v_from]) {
        for (int k = 0; k < 3; k++)
            if (m.tris[3 * t + k] == v_from) m.tris[3 * t + k] = v_to;
        m.v_tris[v_to].push_back(t);
    }
    m.v_tris[v_from].clear();
    // adjacency rewiring
    for (int64_t u : m.adj[v_from]) {
        remove_value(m.adj[u], v_from);
        if (u != v_to) {
            if (!contains(m.adj[u], v_to)) m.adj[u].push_back(v_to);
            if (!contains(m.adj[v_to], u)) m.adj[v_to].push_back(u);
        }
    }
    remove_value(m.adj[v_to], v_to);
    m.adj[v_from].clear();
    m.vert_valid[v_from] = 0;
    m.merged_into[v_from] = v_to;
}

Mesh build(const double* verts, int64_t nv, const int64_t* tris, int64_t nt) {
    Mesh m;
    m.nv = nv;
    m.nt = nt;
    m.verts.assign(verts, verts + 3 * nv);
    m.tris.assign(tris, tris + 3 * nt);
    m.tri_valid.assign(nt, 1);
    m.vert_valid.assign(nv, 1);
    m.adj.resize(nv);
    m.v_tris.resize(nv);
    m.merged_into.assign(nv, -1);
    for (int64_t t = 0; t < nt; t++) {
        int64_t a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
        if (!contains(m.adj[a], b)) m.adj[a].push_back(b);
        if (!contains(m.adj[a], c)) m.adj[a].push_back(c);
        if (!contains(m.adj[b], a)) m.adj[b].push_back(a);
        if (!contains(m.adj[b], c)) m.adj[b].push_back(c);
        if (!contains(m.adj[c], a)) m.adj[c].push_back(a);
        if (!contains(m.adj[c], b)) m.adj[c].push_back(b);
        m.v_tris[a].push_back(t);
        m.v_tris[b].push_back(t);
        m.v_tris[c].push_back(t);
    }
    return m;
}

int64_t resolve(Mesh& m, int64_t v) {
    while (m.merged_into[v] >= 0) v = m.merged_into[v];
    return v;
}

}  // namespace

extern "C" {

// Moore/Warren MC cleanup (postprocessing.rs:99-242 semantics):
// iteratively collapse neighbors sharing the same nearest grid point,
// position-averaging. Returns number of collapses. Outputs are written in
// place: verts (3*nv), tris (3*nt), tri_valid (nt), vert_owner (nv; -1 if
// the vertex survives, else the vertex it was merged into).
int64_t mc_cleanup(
    double* verts, int64_t nv,
    int64_t* tris, int64_t nt,
    const int64_t* nearest_grid_point,      // nv
    const double* grid_coords,              // 3 * nv (nearest point coords)
    double max_snap_distance_sq,            // < 0 => unlimited
    int64_t max_iter,
    uint8_t* tri_valid_out,                 // nt
    int64_t* vert_owner_out                 // nv
) {
    Mesh m = build(verts, nv, tris, nt);
    std::vector<int64_t> sum_count(nv, 1);
    int64_t total = 0;

    auto near_enough = [&](int64_t v) {
        if (max_snap_distance_sq < 0) return true;
        double dx = m.verts[3 * v] - grid_coords[3 * v];
        double dy = m.verts[3 * v + 1] - grid_coords[3 * v + 1];
        double dz = m.verts[3 * v + 2] - grid_coords[3 * v + 2];
        return dx * dx + dy * dy + dz * dz <= max_snap_distance_sq;
    };

    for (int64_t it = 0; it < max_iter; it++) {
        int64_t collapses = 0;
        for (int64_t v0 = 0; v0 < nv; v0++) {
            if (!m.is_valid_vertex(v0)) continue;
            if (!near_enough(v0)) continue;
            // copy: adjacency mutates during collapses
            std::vector<int64_t> ring = m.adj[v0];
            for (int64_t v1 : ring) {
                if (nearest_grid_point[v0] != nearest_grid_point[v1]) continue;
                if (!m.is_valid_vertex(v1)) continue;
                if (!near_enough(v1)) continue;
                if (is_collapse_ok(m, v1, v0) != 0) continue;
                do_collapse(m, v1, v0);
                collapses++;
                double n0 = (double)sum_count[v0], n1 = (double)sum_count[v1];
                for (int d = 0; d < 3; d++)
                    m.verts[3 * v0 + d] =
                        (m.verts[3 * v0 + d] * n0 + m.verts[3 * v1 + d] * n1) /
                        (n0 + n1);
                sum_count[v0] += sum_count[v1];
            }
        }
        total += collapses;
        if (collapses == 0) break;
    }

    std::memcpy(verts, m.verts.data(), sizeof(double) * 3 * nv);
    std::memcpy(tris, m.tris.data(), sizeof(int64_t) * 3 * nt);
    std::memcpy(tri_valid_out, m.tri_valid.data(), nt);
    for (int64_t v = 0; v < nv; v++)
        vert_owner_out[v] = m.merged_into[v] >= 0 ? resolve(m, v) : -1;
    return total;
}

// Generic collapse queue (barnacle decimation): try each (from, to) pair,
// re-trying one-ring failures up to 5 passes (postprocessing.rs:396-443).
int64_t process_collapses(
    double* verts, int64_t nv,
    int64_t* tris, int64_t nt,
    const int64_t* pairs, int64_t n_pairs,   // 2 * n_pairs (from, to)
    uint8_t* tri_valid_out,
    int64_t* vert_owner_out
) {
    Mesh m = build(verts, nv, tris, nt);
    std::vector<std::pair<int64_t, int64_t>> queue;
    queue.reserve(n_pairs);
    for (int64_t i = 0; i < n_pairs; i++)
        queue.emplace_back(pairs[2 * i], pairs[2 * i + 1]);

    int64_t done = 0;
    for (int pass = 0; pass < 5 && !queue.empty(); pass++) {
        std::vector<std::pair<int64_t, int64_t>> remaining;
        for (auto [from, to] : queue) {
            int64_t f = from, t = to;
            if (!m.is_valid_vertex(f) || !m.is_valid_vertex(t)) continue;
            if (!contains(m.adj[f], t)) continue;
            int rc = is_collapse_ok(m, f, t);
            if (rc == 0) {
                do_collapse(m, f, t);
                done++;
            } else if (rc == 4) {
                remaining.emplace_back(f, t);
            }
        }
        queue.swap(remaining);
    }

    std::memcpy(tris, m.tris.data(), sizeof(int64_t) * 3 * nt);
    std::memcpy(tri_valid_out, m.tri_valid.data(), nt);
    for (int64_t v = 0; v < nv; v++)
        vert_owner_out[v] = m.merged_into[v] >= 0 ? resolve(m, v) : -1;
    return done;
}

// One-ring sizes for all vertices (barnacle candidate detection input).
void vertex_ring_sizes(
    const int64_t* tris, int64_t nt, int64_t nv, int64_t* out  // nv
) {
    std::vector<std::vector<int64_t>> adj(nv);
    for (int64_t t = 0; t < nt; t++) {
        int64_t a = tris[3 * t], b = tris[3 * t + 1], c = tris[3 * t + 2];
        if (!contains(adj[a], b)) adj[a].push_back(b);
        if (!contains(adj[a], c)) adj[a].push_back(c);
        if (!contains(adj[b], a)) adj[b].push_back(a);
        if (!contains(adj[b], c)) adj[b].push_back(c);
        if (!contains(adj[c], a)) adj[c].push_back(a);
        if (!contains(adj[c], b)) adj[c].push_back(b);
    }
    for (int64_t v = 0; v < nv; v++) out[v] = (int64_t)adj[v].size();
}

}  // extern "C"
