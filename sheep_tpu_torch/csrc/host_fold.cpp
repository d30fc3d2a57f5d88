// host_fold.cpp: the exact sequential union-find fold of the hybrid build's
// tail, the port's own copy of the plain single-thread path of
// sheep_tpu/native/src/sheep_native.cpp (uf_find, adopt_group,
// plain_group_adopt, fold_links_block, sheep_build_forest and the resumable
// sheep_build_forest_links_begin/_block/_finish).
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

// One block of the resumable fold (the reference's fold_links_block on its
// plain single-thread path).  Blocks arrive in ascending-hi order: every
// linked record (hi < n) satisfies hi >= lo_bound, the previous block's
// return value (0 for the first).  An equal-hi group may split across
// adjacent blocks: within one group distinct component roots each adopt
// once and repeats are no-ops, and a root the first half adopted is found AS
// h by the second half's find, so a boundary inside a group is exact.
// accumulate_pst adds 1 to pst[lo] per record (hi >= n included), exact only
// when the blocks together carry the ORIGINAL link multiset.  Validates the
// whole block before touching any state.  Returns the new bound (max linked
// hi seen), -3 on a malformed link (lo >= n), -7 on an out-of-order block.
static int64_t fold_links_block(const uint32_t* lo, const uint32_t* hi,
                                int64_t m, int64_t n, int64_t lo_bound,
                                bool accumulate_pst, uint32_t* uf,
                                uint32_t* parent, uint32_t* pst) {
  int64_t mx = lo_bound;
  for (int64_t i = 0; i < m; ++i) {
    if (lo[i] >= (uint64_t)n) return -3;
    if (hi[i] < (uint64_t)n) {
      if ((int64_t)hi[i] < lo_bound) return -7;
      if ((int64_t)hi[i] > mx) mx = (int64_t)hi[i];
    }
  }
  if (accumulate_pst)
    for (int64_t i = 0; i < m; ++i) ++pst[lo[i]];
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
                (uint32_t)h, uf, parent, adopted);
  return mx;
}
}  // namespace

// Resumable link fold: the exact forest build split at block boundaries, so
// the streamed handoff folds window k while window k+1 is still in flight.
// All state is caller-owned [n] buffers (parent, pst, uf).
//
// begin: pst_in NULL => blocks accumulate pst from their own records;
// non-NULL => pst_in is copied and blocks leave pst alone.  Returns 0, or
// -1 on a bad size.
extern "C" int sheep_build_forest_links_begin(int64_t n, const uint32_t* pst_in,
                                              uint32_t* parent_out,
                                              uint32_t* pst_out, uint32_t* uf) {
  if (n < 0) return -1;
  if (pst_in)
    std::memcpy(pst_out, pst_in, sizeof(uint32_t) * (size_t)n);
  else
    std::memset(pst_out, 0, sizeof(uint32_t) * (size_t)n);
  for (int64_t v = 0; v < n; ++v) {
    parent_out[v] = kInvalid;
    uf[v] = (uint32_t)v;
  }
  return 0;
}

// block: fold one ascending-hi window; returns the new bound (>= 0), -1 on
// bad sizes, -3 or -7 as fold_links_block.
extern "C" int64_t sheep_build_forest_links_block(
    const uint32_t* lo, const uint32_t* hi, int64_t m, int64_t n,
    int64_t lo_bound, int32_t accumulate_pst, uint32_t* parent_out,
    uint32_t* pst_out, uint32_t* uf) {
  if (n < 0 || m < 0 || lo_bound < 0) return -1;
  return fold_links_block(lo, hi, m, n, lo_bound, accumulate_pst != 0, uf,
                          parent_out, pst_out);
}

// finish: seal the fold.  The ascending-hi discipline leaves no deferred
// work, so parent/pst are final after the last block.  Returns 0.
extern "C" int sheep_build_forest_links_finish(int64_t n, uint32_t* parent_out,
                                               uint32_t* uf) {
  (void)parent_out;
  (void)uf;
  return n < 0 ? -1 : 0;
}

// sheep_build_forest: elimination forest from m links over n positions, as
// ONE block of the resumable fold, so the monolithic build and the streamed
// handoff share every semantic.
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
  std::vector<uint32_t> uf((size_t)n);
  sheep_build_forest_links_begin(n, pst_in, parent_out, pst_out, uf.data());
  const int64_t rc = fold_links_block(lo, hi, m, n, 0, pst_in == nullptr,
                                      uf.data(), parent_out, pst_out);
  if (rc < 0) return (int)rc;
  return sheep_build_forest_links_finish(n, parent_out, uf.data());
}
