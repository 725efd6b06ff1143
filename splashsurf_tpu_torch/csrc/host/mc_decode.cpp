// Host decoder for the encoded marching-cubes streams.
//
// The device ships only (t, packed point words, per-block counts) for the
// point-list marching cubes (ops/global_sweep.py: mc_global_cells(encode=
// True)), or the owned-point runs of the subdomain route
// (subdomains.chunk_mc_encode); these functions rebuild the mesh the
// unencoded path gives: vertex positions in f32 arithmetic (mn + ijk * cs,
// then + t * cs; the device may fuse the first into one multiply-add),
// triangle vertex indices through per-point rank merges (the active-point
// list ascends, so each of the 7 neighbour offsets is one two-pointer
// merge, with no hashing and no binary search per lookup).
//
// A word packs the cell case in bits 0-7 and the three origin-edge
// activity bits (+x/+y/+z) in bits 8-10; points are ascending flat grid
// point ids with strides (PY*PZ, PZ, 1).
//
// Point ids are int64, so a grid of more than 2^31 points decodes. Ranks
// into the active-point list and vertex indices are int32, as in the
// reference's decoder (half the memory traffic of int64); the callers
// check that the active points and the vertices number fewer than 2^31.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 mc_decode.cpp -o libmc_decode.so

#include <algorithm>
#include <cstdint>
#include <utility>
#include <vector>

extern "C" {

// Returns the number of triangles written, or -1 on inconsistency (a
// referenced owner point missing from the active list, or counts that
// disagree with the totals).
int64_t mc_decode(
    const float* t, int64_t total_v, int64_t total_t,
    const int64_t* points, const uint16_t* words, int64_t total_c,
    int64_t PY, int64_t PZ,
    double mnx, double mny, double mnz, double cell_size,
    const int8_t* tri_table, int64_t n_slots,
    const uint8_t* tri_count,
    const int8_t* edge_axis, const int8_t* edge_base,
    float* verts_out, int32_t* tris_out) {
  const float mnf[3] = {(float)mnx, (float)mny, (float)mnz};
  const float csf = (float)cell_size;
  const int64_t pzy = PY * PZ;

  // --- per-point per-axis exclusive vertex prefix -----------------------
  std::vector<int32_t> vidx(3 * total_c);
  int64_t counts_axis[3] = {0, 0, 0};
  for (int a = 0; a < 3; ++a) {
    const int bit = 8 + a;
    int32_t run = 0;
    int32_t* va = vidx.data() + a * total_c;
    for (int64_t i = 0; i < total_c; ++i) {
      va[i] = run;  // exclusive prefix: valid only where the edge is active
      run += (words[i] >> bit) & 1;
    }
    counts_axis[a] = run;
  }
  const int64_t base1 = counts_axis[0];
  const int64_t base2 = base1 + counts_axis[1];
  if (base2 + counts_axis[2] != total_v) return -1;

  // --- vertices, axis-major ---------------------------------------------
  {
    int64_t vo = 0;
    for (int a = 0; a < 3; ++a) {
      const int bit = 8 + a;
      for (int64_t i = 0; i < total_c; ++i) {
        if ((words[i] >> bit) & 1) {
          const int64_t p = points[i];
          const int64_t ci = p / pzy;
          const int64_t rem = p - ci * pzy;
          const int64_t cj = rem / PZ;
          const int64_t ck = rem - cj * PZ;
          const float tv = t[vo];
          float pos[3] = {mnf[0] + (float)ci * csf, mnf[1] + (float)cj * csf,
                          mnf[2] + (float)ck * csf};
          pos[a] += tv * csf;
          verts_out[vo * 3 + 0] = pos[0];
          verts_out[vo * 3 + 1] = pos[1];
          verts_out[vo * 3 + 2] = pos[2];
          ++vo;
        }
      }
    }
  }

  // --- neighbour ranks: 7 two-pointer merges -----------------------------
  // offset index = di*4 + dj*2 + dk over (di,dj,dk) in {0,1}^3 (0 = self)
  std::vector<int32_t> rank7(8 * total_c);
  for (int off = 0; off < 8; ++off) {
    const int64_t di = (off >> 2) & 1, dj = (off >> 1) & 1, dk = off & 1;
    const int64_t delta = di * pzy + dj * PZ + dk;
    int32_t* r = rank7.data() + (int64_t)off * total_c;
    if (off == 0) {
      for (int64_t i = 0; i < total_c; ++i) r[i] = (int32_t)i;
      continue;
    }
    int64_t j = 0;
    for (int64_t i = 0; i < total_c; ++i) {
      const int64_t target = points[i] + delta;
      while (j < total_c && points[j] < target) ++j;
      r[i] = (j < total_c && points[j] == target) ? (int32_t)j : -1;
    }
  }

  // --- triangles ----------------------------------------------------------
  int64_t to = 0;
  for (int64_t i = 0; i < total_c; ++i) {
    const int c = words[i] & 0xFF;
    const int cnt = tri_count[c];
    if (to + cnt > total_t) return -1;  // capacity guard before any write
    for (int s = 0; s < cnt; ++s) {
      for (int corner = 0; corner < 3; ++corner) {
        const int local = tri_table[((int64_t)c * n_slots + s) * 3 + corner];
        const int a = edge_axis[local];
        const int di = edge_base[local * 3 + 0];
        const int dj = edge_base[local * 3 + 1];
        const int dk = edge_base[local * 3 + 2];
        const int32_t rank = rank7[(int64_t)(di * 4 + dj * 2 + dk) * total_c + i];
        if (rank < 0) return -1;
        const int64_t base = (a == 0) ? 0 : (a == 1) ? base1 : base2;
        tris_out[to * 3 + corner] = (int32_t)(base + vidx[(int64_t)a * total_c + rank]);
      }
      ++to;
    }
  }
  return to;
}

// Subdomain-route variant: decode the owned-point encoded streams
// (subdomains.chunk_mc_encode). The stream is ordered (run, local point),
// one run per subdomain; each slot packs local_id << 11 | case(8b) | edge
// bits(3b). Global point ids come from the per-run counts and base
// coordinates; a cell's far-face edges belong to neighbour subdomains'
// points, found through one sort of the global ids and 7 two-pointer
// merges (the host counterpart of the reference's stitching hash map,
// dense_subdomains.rs:1603-1749). Ownership makes every vertex unique, so
// nothing is merged. Vertices are point-major (each point's active edges
// in x, y, z order).
//
// Returns the number of triangles written, or -1 on inconsistency.
int64_t mc_decode_sub(
    const float* t, int64_t total_v, int64_t total_t,
    const uint32_t* packed, int64_t total_c,
    const int32_t* run_counts, const int32_t* run_base, int64_t n_runs,
    int64_t ns,
    int64_t NPY, int64_t NPZ,
    double mnx, double mny, double mnz, double cell_size,
    const int8_t* tri_table, int64_t n_slots,
    const uint8_t* tri_count,
    const int8_t* edge_axis, const int8_t* edge_base,
    float* verts_out, int32_t* tris_out) {
  const float mnf[3] = {(float)mnx, (float)mny, (float)mnz};
  const float csf = (float)cell_size;
  const int64_t pzy = NPY * NPZ;
  const int64_t ns2 = ns * ns;

  // --- pass 1: global ids, vertex prefix, vertex positions ---------------
  std::vector<int64_t> gflat(total_c);
  std::vector<uint16_t> words(total_c);
  std::vector<int32_t> pbase(total_c);
  {
    int64_t slot = 0, vo = 0;
    for (int64_t r = 0; r < n_runs; ++r) {
      const int64_t cnt = run_counts[r];
      const int64_t bi = run_base[r * 3 + 0];
      const int64_t bj = run_base[r * 3 + 1];
      const int64_t bk = run_base[r * 3 + 2];
      for (int64_t s = 0; s < cnt; ++s, ++slot) {
        if (slot >= total_c) return -1;
        const uint32_t pk = packed[slot];
        const uint16_t w = (uint16_t)(pk & 0x7FF);
        const int64_t local = pk >> 11;
        const int64_t gi = bi + local / ns2;
        const int64_t gj = bj + (local / ns) % ns;
        const int64_t gk = bk + local % ns;
        gflat[slot] = (gi * NPY + gj) * NPZ + gk;
        words[slot] = w;
        pbase[slot] = (int32_t)vo;
        for (int a = 0; a < 3; ++a) {
          if ((w >> (8 + a)) & 1) {
            if (vo >= total_v) return -1;  // capacity guard before any write
            const float tv = t[vo];
            float pos[3] = {mnf[0] + (float)gi * csf, mnf[1] + (float)gj * csf,
                            mnf[2] + (float)gk * csf};
            pos[a] += tv * csf;
            verts_out[vo * 3 + 0] = pos[0];
            verts_out[vo * 3 + 1] = pos[1];
            verts_out[vo * 3 + 2] = pos[2];
            ++vo;
          }
        }
      }
    }
    if (slot != total_c || vo != total_v) return -1;
  }

  // --- pass 2: sort (gflat, slot) ----------------------------------------
  std::vector<std::pair<int64_t, int32_t>> order(total_c);
  for (int64_t i = 0; i < total_c; ++i) order[i] = {gflat[i], (int32_t)i};
  std::sort(order.begin(), order.end());

  // --- pass 3: neighbour slots via 7 two-pointer merges -------------------
  std::vector<int32_t> nbr(7 * total_c);
  for (int off = 1; off < 8; ++off) {
    const int64_t di = (off >> 2) & 1, dj = (off >> 1) & 1, dk = off & 1;
    const int64_t delta = di * pzy + dj * NPZ + dk;
    int32_t* nb = nbr.data() + (int64_t)(off - 1) * total_c;
    int64_t j = 0;
    for (int64_t i = 0; i < total_c; ++i) {
      const int64_t target = order[i].first + delta;
      while (j < total_c && order[j].first < target) ++j;
      nb[order[i].second] =
          (j < total_c && order[j].first == target) ? order[j].second : -1;
    }
  }

  // --- pass 4: triangles in stream order ----------------------------------
  int64_t to = 0;
  for (int64_t i = 0; i < total_c; ++i) {
    const int c = words[i] & 0xFF;
    const int cnt = tri_count[c];
    if (to + cnt > total_t) return -1;  // capacity guard before any write
    for (int s = 0; s < cnt; ++s) {
      for (int corner = 0; corner < 3; ++corner) {
        const int local = tri_table[((int64_t)c * n_slots + s) * 3 + corner];
        const int a = edge_axis[local];
        const int di = edge_base[local * 3 + 0];
        const int dj = edge_base[local * 3 + 1];
        const int dk = edge_base[local * 3 + 2];
        const int off = di * 4 + dj * 2 + dk;
        const int64_t nslot = off == 0 ? i : nbr[(int64_t)(off - 1) * total_c + i];
        if (nslot < 0) return -1;
        const uint16_t w = words[nslot];
        if (((w >> (8 + a)) & 1) == 0) return -1;
        int below = 0;
        for (int b = 0; b < a; ++b) below += (w >> (8 + b)) & 1;
        tris_out[to * 3 + corner] = pbase[nslot] + below;
      }
      ++to;
    }
  }
  return to;
}

// Host inverse of the packed point compaction (ops/global_sweep.py
// _unpack_compact): packed u16 slots hold (local << 11 | word), local the
// point's offset in its 32-wide block; bsum holds the per-block active
// counts. Writes ascending int64 flat point ids (plus a constant offset,
// the slab route's global merge) and 11-bit words in one linear pass.
// Returns 0, or -1 when the block counts disagree with total_c.
int64_t unpack_compact(
    const uint16_t* packed, int64_t total_c,
    const uint8_t* bsum, int64_t n_blocks,
    int64_t point_offset,
    int64_t* points_out, uint16_t* words_out) {
  int64_t slot = 0;
  for (int64_t b = 0; b < n_blocks; ++b) {
    const int64_t cnt = bsum[b];
    if (slot + cnt > total_c) return -1;
    const int64_t base = b * 32 + point_offset;
    for (int64_t k = 0; k < cnt; ++k, ++slot) {
      const uint16_t pk = packed[slot];
      points_out[slot] = base + (pk >> 11);
      words_out[slot] = (uint16_t)(pk & 0x7FF);
    }
  }
  return slot == total_c ? 0 : -1;
}

}  // extern "C"
