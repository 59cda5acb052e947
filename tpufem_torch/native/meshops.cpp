// Native host engine for the packed plan build of tpufem_torch.
//
// A copy of the entry points of tpufem/native/meshops.cpp that the packed
// plan build (tpufem_torch.ops.packed.PackedPlan.build), the c3d10 box mesh
// generator (tpufem_torch.utils.meshgen), the topology tools
// (tpufem_torch.topology.faces, .edges) and the partitioner
// (tpufem_torch.parallel.partition) call: radix sorts, first-touch
// numbering, per-cluster slot lists, window tables, the byte-packed
// incidence fills, face and edge hashing, BFS distances and multi-source
// region growing.  Plain C ABI for ctypes; every output is deterministic
// and equal to the numpy fallback its caller keeps beside the call.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct FaceKey {
  int32_t n[4];  // sorted node ids, n[3] = -1 for triangles
  bool operator==(const FaceKey& o) const {
    return n[0] == o.n[0] && n[1] == o.n[1] && n[2] == o.n[2] && n[3] == o.n[3];
  }
};

inline uint64_t hash_key(const FaceKey& k) {
  uint64_t h = 1469598103934665603ull;
  for (int i = 0; i < 4; ++i) {
    h ^= static_cast<uint64_t>(static_cast<uint32_t>(k.n[i]));
    h *= 1099511628211ull;
  }
  return h;
}

inline void sort_small(int32_t* v, int n) {
  for (int i = 1; i < n; ++i) {
    int32_t x = v[i];
    int j = i - 1;
    while (j >= 0 && v[j] > x) {
      v[j + 1] = v[j];
      --j;
    }
    v[j + 1] = x;
  }
}

// Open-addressing table: slot -> first (elem, face) occurrence + count.
struct FaceTable {
  std::vector<FaceKey> keys;
  std::vector<int64_t> first;   // encoded elem*16+face of first occurrence
  std::vector<int64_t> second;  // second occurrence (or -1)
  std::vector<uint8_t> count;   // saturating at 3
  uint64_t mask;

  explicit FaceTable(size_t n_faces) {
    size_t cap = 1;
    while (cap < n_faces * 2) cap <<= 1;
    keys.resize(cap);
    first.assign(cap, -1);
    second.assign(cap, -1);
    count.assign(cap, 0);
    mask = cap - 1;
  }

  size_t insert(const FaceKey& k, int64_t enc) {
    uint64_t h = hash_key(k) & mask;
    while (true) {
      if (count[h] == 0) {
        keys[h] = k;
        first[h] = enc;
        count[h] = 1;
        return h;
      }
      if (keys[h] == k) {
        if (count[h] == 1) second[h] = enc;
        if (count[h] < 3) ++count[h];
        return h;
      }
      h = (h + 1) & mask;
    }
  }
};

}  // namespace

extern "C" {

// Generic face extraction.
//   conn:        [M, k] element connectivity
//   face_table:  [n_faces_per_elem, face_width] local node ids (-1 pad)
// Outputs (caller-allocated to max size, returns actual counts):
//   boundary_out [<= M*f, face_width+1]: face nodes (original order) + elem id
//   shared_out   [<= M*f/2, 4]: elem1, face1, elem2, face2
// Returns 0 on success.
int32_t extract_faces(const int32_t* conn, int64_t M, int32_t k,
                      const int32_t* face_table, int32_t n_faces,
                      int32_t face_width, int32_t* boundary_out,
                      int64_t* n_boundary, int32_t* boundary_opposite,
                      const int32_t* opposite_table, int32_t* shared_out,
                      int64_t* n_shared) {
  FaceTable table(static_cast<size_t>(M) * n_faces);
  std::vector<size_t> slots(static_cast<size_t>(M) * n_faces);
  for (int64_t m = 0; m < M; ++m) {
    for (int32_t f = 0; f < n_faces; ++f) {
      FaceKey key;
      int w = 0;
      for (int32_t j = 0; j < face_width; ++j) {
        int32_t local = face_table[f * face_width + j];
        if (local >= 0) key.n[w++] = conn[m * k + local];
      }
      for (int j = w; j < 4; ++j) key.n[j] = -1;
      sort_small(key.n, w);
      slots[m * n_faces + f] = table.insert(key, m * 16 + f);
    }
  }
  int64_t nb = 0, ns = 0;
  // Deterministic order: iterate elements/faces in order, emit on first visit.
  std::vector<uint8_t> emitted(table.keys.size(), 0);
  for (int64_t m = 0; m < M; ++m) {
    for (int32_t f = 0; f < n_faces; ++f) {
      size_t s = slots[m * n_faces + f];
      if (emitted[s]) continue;
      emitted[s] = 1;
      if (table.count[s] == 1) {
        int64_t enc = table.first[s];
        int64_t e = enc / 16;
        int32_t lf = static_cast<int32_t>(enc % 16);
        for (int32_t j = 0; j < face_width; ++j) {
          int32_t local = face_table[lf * face_width + j];
          boundary_out[nb * face_width + j] =
              (local >= 0) ? conn[e * k + local] : -1;
        }
        if (boundary_opposite && opposite_table)
          boundary_opposite[nb] = conn[e * k + opposite_table[lf]];
        ++nb;
      } else if (table.count[s] == 2) {
        int64_t e1 = table.first[s], e2 = table.second[s];
        shared_out[ns * 4 + 0] = static_cast<int32_t>(e1 / 16);
        shared_out[ns * 4 + 1] = static_cast<int32_t>(e1 % 16);
        shared_out[ns * 4 + 2] = static_cast<int32_t>(e2 / 16);
        shared_out[ns * 4 + 3] = static_cast<int32_t>(e2 % 16);
        ++ns;
      }
    }
  }
  *n_boundary = nb;
  *n_shared = ns;
  return 0;
}

// Multi-source BFS region growing on a CSR dual graph (deterministic:
// lowest part id wins contested elements, matching the Python fallback).
int32_t region_grow(const int64_t* indptr, const int32_t* indices, int64_t n,
                    const int32_t* seeds, int32_t n_parts, int64_t* labels) {
  for (int64_t i = 0; i < n; ++i) labels[i] = -1;
  std::vector<std::vector<int32_t>> frontier(n_parts), next(n_parts);
  for (int32_t p = 0; p < n_parts; ++p) {
    labels[seeds[p]] = p;
    frontier[p].push_back(seeds[p]);
  }
  std::vector<int32_t> claim(n, -1);
  int64_t remaining = n - n_parts;
  while (remaining > 0) {
    bool any = false;
    // claim pass: lowest part id wins (iterate parts in order)
    for (int32_t p = 0; p < n_parts; ++p) {
      next[p].clear();
      for (int32_t u : frontier[p]) {
        for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
          int32_t v = indices[e];
          if (labels[v] == -1 && claim[v] == -1) {
            claim[v] = p;
            next[p].push_back(v);
            any = true;
          }
        }
      }
    }
    if (!any) {
      // disconnected leftovers -> smallest part
      std::vector<int64_t> sizes(n_parts, 0);
      for (int64_t i = 0; i < n; ++i)
        if (labels[i] >= 0) ++sizes[labels[i]];
      int32_t smallest = 0;
      for (int32_t p = 1; p < n_parts; ++p)
        if (sizes[p] < sizes[smallest]) smallest = p;
      for (int64_t i = 0; i < n; ++i)
        if (labels[i] == -1) {
          labels[i] = smallest;
          --remaining;
        }
      break;
    }
    for (int32_t p = 0; p < n_parts; ++p) {
      for (int32_t v : next[p]) {
        labels[v] = p;
        claim[v] = -1;
        --remaining;
      }
      frontier[p].swap(next[p]);
    }
  }
  return 0;
}

// BFS distances from a source set (for distant-seed selection).
int32_t bfs_distances(const int64_t* indptr, const int32_t* indices, int64_t n,
                      const int32_t* sources, int64_t n_sources,
                      int64_t* dist) {
  for (int64_t i = 0; i < n; ++i) dist[i] = -1;
  std::vector<int32_t> frontier, next;
  for (int64_t i = 0; i < n_sources; ++i) {
    if (dist[sources[i]] == -1) {
      dist[sources[i]] = 0;
      frontier.push_back(sources[i]);
    }
  }
  int64_t d = 0;
  while (!frontier.empty()) {
    ++d;
    next.clear();
    for (int32_t u : frontier) {
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int32_t v = indices[e];
        if (dist[v] == -1) {
          dist[v] = d;
          next.push_back(v);
        }
      }
    }
    frontier.swap(next);
  }
  return 0;
}

// Unique sorted edges from an element edge table; returns count.
int64_t unique_edges(const int32_t* conn, int64_t M, int32_t k,
                     const int32_t* edge_table, int32_t n_edges,
                     int32_t* edges_out /* [<= M*n_edges, 2] */) {
  FaceTable table(static_cast<size_t>(M) * n_edges);
  std::vector<size_t> slots;
  slots.reserve(static_cast<size_t>(M) * n_edges);
  for (int64_t m = 0; m < M; ++m) {
    for (int32_t e = 0; e < n_edges; ++e) {
      int32_t a = conn[m * k + edge_table[e * 2]];
      int32_t b = conn[m * k + edge_table[e * 2 + 1]];
      FaceKey key{{a < b ? a : b, a < b ? b : a, -1, -1}};
      slots.push_back(table.insert(key, m * 16 + e));
    }
  }
  std::vector<uint8_t> emitted(table.keys.size(), 0);
  int64_t ne = 0;
  for (size_t s : slots) {
    if (emitted[s]) continue;
    emitted[s] = 1;
    edges_out[ne * 2] = table.keys[s].n[0];
    edges_out[ne * 2 + 1] = table.keys[s].n[1];
    ++ne;
  }
  return ne;
}

// Stable LSD radix argsort of int32 keys (non-negative), for scatter plans.
int32_t radix_argsort_i32(const int32_t* keys, int64_t n, int32_t* perm_out) {
  std::vector<int32_t> perm(n), tmp(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = static_cast<int32_t>(i);
  const int B = 16;  // two 16-bit passes
  std::vector<int64_t> count(1 << B);
  for (int pass = 0; pass < 2; ++pass) {
    int shift = pass * B;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[(static_cast<uint32_t>(keys[perm[i]]) >> shift) & 0xFFFF];
    int64_t acc = 0;
    for (int64_t c = 0; c < (1 << B); ++c) {
      int64_t t = count[c];
      count[c] = acc;
      acc += t;
    }
    for (int64_t i = 0; i < n; ++i) {
      uint32_t bucket = (static_cast<uint32_t>(keys[perm[i]]) >> shift) & 0xFFFF;
      tmp[count[bucket]++] = perm[i];
    }
    perm.swap(tmp);
  }
  std::memcpy(perm_out, perm.data(), n * sizeof(int32_t));
  return 0;
}

// Sorted unique + inverse of non-negative int64 keys (LSD radix over the
// populated bit range).  Replaces numpy's sort-based np.unique(return_inverse)
// on the multi-million-edge key streams of second-order mesh promotion:
// uniq_out gets the ascending unique keys, inv_out[i] the position of keys[i]
// in uniq_out.  Returns the unique count.
int64_t sort_unique_inverse_i64(const int64_t* keys, int64_t n,
                                int64_t* uniq_out, int64_t* inv_out) {
  if (n == 0) return 0;
  int64_t mx = 0;
  for (int64_t i = 0; i < n; ++i)
    if (keys[i] > mx) mx = keys[i];
  int top_bit = 1;
  while ((mx >> top_bit) != 0) ++top_bit;
  const int B = 16;
  int passes = (top_bit + B - 1) / B;
  std::vector<int64_t> perm(n), tmp(n);
  for (int64_t i = 0; i < n; ++i) perm[i] = i;
  std::vector<int64_t> count(static_cast<size_t>(1) << B);
  for (int pass = 0; pass < passes; ++pass) {
    int shift = pass * B;
    std::fill(count.begin(), count.end(), 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[(static_cast<uint64_t>(keys[perm[i]]) >> shift) & 0xFFFF];
    int64_t acc = 0;
    for (int64_t c = 0; c < (1 << B); ++c) {
      int64_t t = count[c];
      count[c] = acc;
      acc += t;
    }
    for (int64_t i = 0; i < n; ++i) {
      uint64_t bucket = (static_cast<uint64_t>(keys[perm[i]]) >> shift) & 0xFFFF;
      tmp[count[bucket]++] = perm[i];
    }
    perm.swap(tmp);
  }
  int64_t nu = -1;
  int64_t prev = -1;
  for (int64_t i = 0; i < n; ++i) {
    int64_t k = keys[perm[i]];
    if (k != prev) {
      ++nu;
      uniq_out[nu] = k;
      prev = k;
    }
    inv_out[perm[i]] = nu;
  }
  return nu + 1;
}

// First-touch node numbering: new_from_old[node] = order of first appearance
// of `node` in `flat` (entries < 0 skipped); untouched nodes stay -1.
// Returns the number of referenced nodes.  Replaces the packed-plan
// unique(return_index) + argsort pair with one O(n) pass.
int64_t first_touch_i32(const int32_t* flat, int64_t n, int64_t n_nodes,
                        int32_t* new_from_old_out) {
  for (int64_t i = 0; i < n_nodes; ++i) new_from_old_out[i] = -1;
  int32_t next = 0;
  for (int64_t i = 0; i < n; ++i) {
    int32_t v = flat[i];
    if (v < 0 || v >= n_nodes) continue;
    if (new_from_old_out[v] < 0) new_from_old_out[v] = next++;
  }
  return next;
}

// Per-(cluster, lane-chunk) compress-incidence widths for the packed plan:
// wid_out[b, g] = max over slots s of #{lanes r in chunk g of cluster b with
// lconn[b, r] == s and element r % E_c real}.  One O(B * k * E_c) pass —
// replaces a 13M+-entry key sort + run reduce in numpy (ops/packed.py).
void cinc_widths(const int32_t* lconn, const uint8_t* ev, int64_t B,
                 int32_t k, int32_t E_c, int32_t Rp, int32_t Gch,
                 int32_t* wid_out) {
  const int kEc = k * E_c;
  std::vector<int32_t> cnt(static_cast<size_t>(Gch) * 128);
  for (int64_t b = 0; b < B; ++b) {
    std::fill(cnt.begin(), cnt.end(), 0);
    const int32_t* lc = lconn + b * Rp;
    const uint8_t* e = ev + b * E_c;
    for (int r = 0; r < kEc; ++r) {
      if (!e[r % E_c]) continue;
      ++cnt[(r >> 7) * 128 + lc[r]];
    }
    for (int g = 0; g < Gch; ++g) {
      int32_t w = 0;
      for (int s = 0; s < 128; ++s)
        if (cnt[g * 128 + s] > w) w = cnt[g * 128 + s];
      wid_out[b * Gch + g] = w;
    }
  }
}

// Per-cluster slot construction for the packed plan: slots are the sorted
// unique valid node ids of the cluster.  Writes l2g [B, 128] (-1 pad) and
// slot_of_entry [B, kEc] (pad entries share the slot the -1s landed on: 0).
// Replaces a [B, kEc] row sort + stable argsort + put_along_axis in numpy.
// Returns the max slot count (caller checks the 128 budget).
int32_t cluster_slots(const int32_t* gconn, int64_t B, int32_t kEc,
                      int32_t* l2g_out, int32_t* slot_out) {
  int32_t max_slots = 0;
  std::vector<int32_t> buf(kEc);
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* row = gconn + b * kEc;
    std::memcpy(buf.data(), row, sizeof(int32_t) * kEc);
    std::sort(buf.begin(), buf.end());
    int32_t* l2g = l2g_out + b * 128;
    int ns = 0;
    int32_t prev = -1;
    for (int i = 0; i < kEc; ++i) {
      if (buf[i] < 0 || buf[i] == prev) continue;
      prev = buf[i];
      if (ns < 128) l2g[ns] = buf[i];
      ++ns;
    }
    if (ns > max_slots) max_slots = ns;
    for (int i = ns < 128 ? ns : 128; i < 128; ++i) l2g[i] = -1;
    if (ns > 128) continue;  // overflow reported via return value
    int32_t* so = slot_out + b * kEc;
    for (int i = 0; i < kEc; ++i) {
      if (row[i] < 0) {
        so[i] = 0;
        continue;
      }
      // binary search in the sorted slot list
      int lo = 0, hi = ns - 1;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (l2g[mid] < row[i]) lo = mid + 1; else hi = mid;
      }
      so[i] = lo;
    }
  }
  return max_slots;
}

// Cluster-side window tables from l2g: for each cluster, the sorted unique
// node-block list (win_full, padded with `nb`), its length (wn_cnt), and
// per-slot source coordinates (wslot = index into the window list, pad Wcap;
// jslot = lane within the block row).  l2g slots are sorted by node id, so
// blocks appear contiguously; one linear pass per cluster.
void cluster_windows(const int32_t* l2g, int64_t B, int32_t nb,
                     int32_t wcap, int32_t* win_full, int32_t* wn_cnt,
                     int32_t* wslot, int32_t* jslot) {
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* g = l2g + b * 128;
    int32_t* wf = win_full + b * wcap;
    int32_t* ws = wslot + b * 128;
    int32_t* js = jslot + b * 128;
    int nw = 0;
    int32_t cur = -1;
    for (int s = 0; s < 128; ++s) {
      if (g[s] < 0) {
        ws[s] = wcap;
        js[s] = 0;
        continue;
      }
      int32_t blk = g[s] >> 7;
      if (blk != cur) {
        cur = blk;
        wf[nw++] = blk;
      }
      ws[s] = nw - 1;
      js[s] = g[s] & 127;
    }
    for (int w = nw; w < wcap; ++w) wf[w] = nb;
    wn_cnt[b] = nw;
  }
}

// Block-side window tables: pass 1 counts clusters per node block
// (wc_cnt [nb]); pass 2 (wc = max count known) fills winc [nb, wc] (pad B)
// and slotidx [nb, wc, 128] (pad -1), clusters in ascending order per block
// — the deterministic combine pull order.
void block_windows_count(const int32_t* l2g, int64_t B, int64_t nb,
                         int32_t* wc_cnt) {
  for (int64_t i = 0; i < nb; ++i) wc_cnt[i] = 0;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* g = l2g + b * 128;
    int32_t cur = -1;
    for (int s = 0; s < 128; ++s) {
      if (g[s] < 0) continue;
      int32_t blk = g[s] >> 7;
      if (blk != cur) {
        cur = blk;
        ++wc_cnt[blk];
      }
    }
  }
}

// Bucketed + byte-packed block-window fill: one pass writing winc rows in
// the bucket permutation (row = bpos[blk], values = cpos[cluster]) and the
// byte-packed slotidx words directly (4 windows per int32, byte = slot+1,
// 0 = absent) — the layout ops/packed.py previously produced by
// materializing the unpacked [nb, wc, 128] table (1.3 GB at 5M elements)
// and re-packing it through a chunked numpy loop (25 s of the 77 s plan
// build).  Entry order per block stays ascending OLD cluster id — the
// same deterministic combine pull order as block_windows_fill.
void block_windows_fill_packed(const int32_t* l2g, int64_t B, int64_t nb,
                               int32_t wc, int32_t wcp4,
                               const int32_t* bpos, const int32_t* cpos,
                               int32_t* cursor /* [nb] zeroed */,
                               int32_t* winc_out /* [nb, wc] */,
                               int32_t* packed_out /* [nb, wcp4, 128] 0 */) {
  for (int64_t i = 0; i < nb * (int64_t)wc; ++i) winc_out[i] = (int32_t)B;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* g = l2g + b * 128;
    int32_t cur = -1;
    int64_t row = -1, pos = -1;
    int32_t* pw = nullptr;
    int shift = 0;
    for (int s = 0; s < 128; ++s) {
      if (g[s] < 0) continue;
      int32_t blk = g[s] >> 7;
      if (blk != cur) {
        cur = blk;
        row = bpos[blk];
        pos = cursor[blk]++;
        winc_out[row * (int64_t)wc + pos] = cpos[b];
        pw = packed_out + (row * (int64_t)wcp4 + (pos >> 2)) * 128;
        shift = 8 * (int)(pos & 3);
      }
      pw[g[s] & 127] |= (int32_t)(s + 1) << shift;
    }
  }
}

// Unpacked block-window fill (wc = max count known): winc [nb, wc] (pad
// B) and slotidx [nb, wc, 128] (pad -1), clusters ascending per block.
void block_windows_fill(const int32_t* l2g, int64_t B, int64_t nb,
                        int32_t wc, int32_t* cursor /* [nb] zeroed */,
                        int32_t* winc_out, int32_t* slotidx_out) {
  for (int64_t i = 0; i < nb * (int64_t)wc; ++i) winc_out[i] = (int32_t)B;
  for (int64_t i = 0; i < nb * (int64_t)wc * 128; ++i) slotidx_out[i] = -1;
  for (int64_t b = 0; b < B; ++b) {
    const int32_t* g = l2g + b * 128;
    int32_t cur = -1;
    int64_t pos = -1;
    for (int s = 0; s < 128; ++s) {
      if (g[s] < 0) continue;
      int32_t blk = g[s] >> 7;
      if (blk != cur) {
        cur = blk;
        pos = cursor[blk]++;
        winc_out[blk * (int64_t)wc + pos] = (int32_t)b;
      }
      slotidx_out[(blk * (int64_t)wc + pos) * 128 + (g[s] & 127)] =
          (int32_t)s;
    }
  }
}

// Byte-packed incidence fill for one bucket of clusters: for every lane r
// (ascending — deterministic within-slot order) of cluster cluster_ids[ci]
// whose element is real, append lane%128 + 1 into the slot's list at
// byte position v = voff[r >> 7] + (count so far), packed 4 per int32:
//   out[ci, v/4, s] |= (r%128 + 1) << 8*(v%4)
// `out` must be zero-initialized [ng, Wp, 128] int32.
void cinc_fill_packed(const int32_t* lconn, const uint8_t* ev,
                      const int64_t* cluster_ids, int64_t ng,
                      int32_t k, int32_t E_c, int32_t Rp, int32_t Gch,
                      const int64_t* voff, int32_t Wp, int32_t* out) {
  const int kEc = k * E_c;
  std::vector<int32_t> cnt(static_cast<size_t>(Gch) * 128);
  for (int64_t ci = 0; ci < ng; ++ci) {
    const int64_t b = cluster_ids[ci];
    std::fill(cnt.begin(), cnt.end(), 0);
    const int32_t* lc = lconn + b * Rp;
    const uint8_t* e = ev + b * E_c;
    int32_t* o = out + ci * static_cast<int64_t>(Wp) * 128;
    for (int r = 0; r < kEc; ++r) {
      if (!e[r % E_c]) continue;
      const int g = r >> 7;
      const int s = lc[r];
      const int64_t v = voff[g] + cnt[g * 128 + s]++;
      o[(v >> 2) * 128 + s] |=
          static_cast<int32_t>((r & 127) + 1) << (8 * (v & 3));
    }
  }
}

}  // extern "C"
