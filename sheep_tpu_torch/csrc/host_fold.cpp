// host_fold.cpp: the exact sequential union-find fold of the hybrid build's
// tail, the port's own copy of the plain single-thread path of
// sheep_tpu/native/src/sheep_native.cpp (uf_find, adopt_group,
// plain_group_adopt, sheep_build_forest).
//
// Links (lo -> hi) are grouped by hi with a counting sort and folded in
// ascending hi: for each hi-group, every distinct component root r of a lo
// (r != hi) is adopted, parent[r] = hi, and the unions are deferred to the
// end of the group (the reference's adoptKids).  The union-find's
// representative is the max-position element of its component.
//
// Plain C interface over caller-allocated buffers, loaded with ctypes.
// Build: g++ -O3 -std=c++17 -shared -fPIC -o libsheep_host_fold.so host_fold.cpp

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

// Find with full path compression; roots are never rewritten, so the
// result does not depend on the compression flavour.
inline uint32_t uf_find(uint32_t* uf, uint32_t x) {
  uint32_t r = x;
  while (uf[r] != r) r = uf[r];
  while (uf[x] != r) {
    uint32_t nx = uf[x];
    uf[x] = r;
    x = nx;
  }
  return r;
}

// One hi-group's adoption scan (lib/jtree.cpp:34-55 in the reference).
inline void adopt_group(const uint32_t* grp, int64_t len, uint32_t h,
                        uint32_t* uf, uint32_t* parent,
                        std::vector<uint32_t>& adopted) {
  adopted.clear();
  for (int64_t i = 0; i < len; ++i) {
    uint32_t r = uf_find(uf, grp[i]);
    if (r != h && parent[r] == kInvalid) {
      parent[r] = h;  // adopt: lib/jnode.h:158-162
      adopted.push_back(r);
    }
  }
  for (uint32_t r : adopted) uf[r] = h;  // deferred re-root
}
}  // namespace

// sheep_build_forest: elimination forest from m links over n positions.
//   lo, hi     [m] uint32; lo < n required, hi >= n marks a pst-only link
//              (counts toward pst, never forms a tree edge)
//   pst_in     [n] uint32 or NULL; NULL counts one per link at pst[lo]
//   parent_out [n] uint32, kInvalid for roots
//   pst_out    [n] uint32
// Returns 0, -1 on bad sizes, -3 on a malformed link (lo >= n).
extern "C" int sheep_build_forest(const uint32_t* lo, const uint32_t* hi,
                                  int64_t m, int64_t n,
                                  const uint32_t* pst_in,
                                  uint32_t* parent_out, uint32_t* pst_out) {
  if (n < 0 || m < 0) return -1;
  for (int64_t i = 0; i < m; ++i)
    if (lo[i] >= (uint64_t)n) return -3;
  if (pst_in) {
    std::memcpy(pst_out, pst_in, sizeof(uint32_t) * (size_t)n);
  } else {
    std::memset(pst_out, 0, sizeof(uint32_t) * (size_t)n);
    for (int64_t i = 0; i < m; ++i) ++pst_out[lo[i]];
  }
  for (int64_t v = 0; v < n; ++v) parent_out[v] = kInvalid;
  std::vector<uint32_t> uf((size_t)n);
  for (int64_t v = 0; v < n; ++v) uf[(size_t)v] = (uint32_t)v;

  // counting sort of the linked records by hi
  std::vector<int64_t> offs((size_t)n + 1, 0);
  for (int64_t i = 0; i < m; ++i)
    if (hi[i] < (uint64_t)n) ++offs[hi[i] + 1];
  for (int64_t h = 0; h < n; ++h) offs[h + 1] += offs[h];
  std::vector<uint32_t> lo_by_hi((size_t)offs[n]);
  {
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t i = 0; i < m; ++i)
      if (hi[i] < (uint64_t)n) lo_by_hi[(size_t)cur[hi[i]]++] = lo[i];
  }
  std::vector<uint32_t> adopted;
  for (int64_t h = 0; h < n; ++h)
    adopt_group(lo_by_hi.data() + offs[h], offs[h + 1] - offs[h],
                (uint32_t)h, uf.data(), parent_out, adopted);
  return 0;
}
