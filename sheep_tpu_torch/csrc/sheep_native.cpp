// sheep_native.cpp: the port's native host runtime, its own copy of the
// reference's C++ host runtime (sheep_tpu/native/src/sheep_native.cpp).
// One library holds the fold (plain, cache-blocked, threaded), the fused
// degree sort, the edge-to-link map, the unpack of the 6-byte link
// handoff, the treewidth mode's parameterized insert (sheep_jxn_build),
// the forward tree partition, FENNEL and the streamed evaluator's block.
//
// The reference implements these in C++ (lib/jtree.cpp insert loop,
// lib/unionfind.h find/unify, lib/jnode.cpp merge, lib/partition.cpp
// forwardPartition): the inherently sequential pointer-chasing passes run
// here on the host, vectorized over dense arrays instead of the
// reference's per-object structures, while batched work runs on the card
// (sheep_tpu_torch.ops).  The threaded and blocked paths read
// SHEEP_NATIVE_THREADS, SHEEP_NATIVE_OVERSUB, SHEEP_NATIVE_THREAD_FLOOR
// and SHEEP_NATIVE_BLOCKED at every call.  Timings quoted in the comments
// below were taken on CPU hosts for the reference library.
//
// API style: plain C functions over caller-allocated numpy buffers
// (loaded with ctypes).  All functions return 0 on success, negative on
// error.
// Build: g++ -O3 -std=c++17 -fPIC [-fopenmp] -Wall -Wextra -shared
//        -o libsheep_torch_native.so sheep_native.cpp
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <memory>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {
constexpr uint32_t kInvalid = 0xFFFFFFFFu;

// ---------------------------------------------------------------------------
// Threading.  SHEEP_NATIVE_THREADS (resolved by the governor
// from SHEEP_LEG_CORES/affinity, resources/governor.py) arms an OpenMP
// path in the hot kernels; unset/1, a build without OpenMP, or an input
// below the engagement floor all take the unchanged serial code.  The
// parallel decomposition is the SAME associative primitive the whole
// repo leans on: every thread folds a contiguous slice of the input
// into a PRIVATE partial forest / histogram, and the partials merge
// deterministically — histogram adds commute, and partial forests over
// one sequence merge through the existing grouping+adoption to the
// unique forest of the union (lib/jnode.cpp:174-201; the tournament
// bracket's exactness argument).  Outputs are therefore BIT-IDENTICAL
// to the single-thread build for every thread count — the merge is not
// a heuristic, it is the same fold.
// ---------------------------------------------------------------------------

constexpr int kMaxThreads = 64;
//: links/records below which the per-thread O(n) partial tables cost
//: more than the slice saves (SHEEP_NATIVE_THREAD_FLOOR overrides —
//: tests force 0 to engage the threaded path on small inputs)
constexpr int64_t kThreadFloor = int64_t{1} << 15;

static inline int affinity_cores() {
#ifdef _OPENMP
  // affinity-aware available-processor count: forcing more compute
  // threads than granted cores buys nothing and costs real work (the
  // partial merges are not free), so the resolver clamps to it unless
  // SHEEP_NATIVE_OVERSUB=1 explicitly opts into oversubscription (the
  // determinism tests and the informational bench arm use that to
  // exercise the parallel code path on a 1-core host)
  return omp_get_num_procs();
#else
  return 1;
#endif
}

static inline int resolve_threads() {
#ifdef _OPENMP
  const char* v = std::getenv("SHEEP_NATIVE_THREADS");
  if (!v || !v[0]) return 1;
  int t = std::atoi(v);
  if (t <= 1) return 1;
  const char* over = std::getenv("SHEEP_NATIVE_OVERSUB");
  if (!(over && over[0] == '1')) {
    const int cores = affinity_cores();
    if (t > cores) t = cores;
  }
  return t > kMaxThreads ? kMaxThreads : (t < 1 ? 1 : t);
#else
  return 1;  // compiled without OpenMP: always serial, report so
#endif
}

static inline int64_t thread_floor() {
  const char* v = std::getenv("SHEEP_NATIVE_THREAD_FLOOR");
  if (v && v[0]) {
    long long f = std::atoll(v);
    if (f >= 0) return (int64_t)f;
  }
  return kThreadFloor;
}

// Threads the NEXT kernel call over m records will actually use: the
// resolved count, gated by the engagement floor and capped so every
// slice still carries real work.
static inline int threads_for_work(int64_t m) {
  int t = resolve_threads();
  if (t <= 1 || m < thread_floor()) return 1;
  while (t > 1 && m / t < 256) --t;
  return t;
}

// Per-call thread telemetry, read by the Python bindings right after a
// kernel returns (sheep_last_thread_stats) and annotated onto the
// native.* flight-recorder spans.  thread_local on the CALLING thread,
// so concurrent Python-level callers never smear each other; OpenMP
// workers write distinct slots through the captured pointer.
struct ThreadStats {
  int used = 1;
  double busy[kMaxThreads] = {};
};
static thread_local ThreadStats g_tstats;

// Per-caller-thread slab arena for the per-thread partial tables (8n+8
// bytes per OpenMP thread: a union-find + parent pair, or an int64
// histogram partial — exactly the 8n-per-extra-thread the governor
// prices as RESIDENT).  Persistent across kernel calls on purpose: the
// streaming folds call the kernel once per block, and re-faulting ~8n
// of freshly mmap'd pages per thread per block was measured to be most
// of the forced-thread overhead on the 1-core host.  Grows, never
// shrinks; freed when the calling thread dies.
struct ThreadArena {
  int64_t units = 0;  // uint32 units per slab
  int slots = 0;
  std::unique_ptr<uint32_t[]> buf;
  uint32_t* ensure(int64_t n, int T) {
    const int64_t need = 2 * n + 2;
    if (units < need || slots < T) {
      buf.reset(new uint32_t[(size_t)(need * T)]);
      units = need;
      slots = T;
    }
    return buf.get();
  }
  uint32_t* slab(int t) { return buf.get() + (size_t)t * (size_t)units; }
};
static thread_local ThreadArena g_arena;

// Per-thread (h, kid) capture lists of the bucket-run fold — same
// persistence story as the arena: capacity survives across calls so
// the per-block folds stop re-faulting fresh pages every block.
static thread_local std::vector<std::vector<uint64_t>> g_caps;

static inline void tstats_reset() {
  g_tstats.used = 1;
  std::memset(g_tstats.busy, 0, sizeof(g_tstats.busy));
}

static inline double mono_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// SHEEP_NATIVE_TIME=1: per-phase stderr timings for the hot kernels
// (dev observability; costs two getenv + clock reads per call when off).
static inline bool time_enabled() {
  const char* v = std::getenv("SHEEP_NATIVE_TIME");
  return v && v[0] == '1';
}

struct PhaseTimer {
  bool on;
  std::chrono::steady_clock::time_point t;
  const char* tag;
  explicit PhaseTimer(const char* tag) : on(time_enabled()), tag(tag) {
    if (on) t = std::chrono::steady_clock::now();
  }
  void mark(const char* phase) {
    if (!on) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "native %s.%s %.3fs\n", tag, phase,
                 std::chrono::duration<double>(now - t).count());
    t = now;
  }
};

// Find over a flat uint32 union-find array whose representative is the
// *max-position* element of each component (the later-in-sequence vertex
// survives, mirroring lib/unionfind.h:82-102 unify(lesser, greater)).
// Two-phase: a read-only walk to the root, then full path compression —
// the write-free <=1-hop fast path matters on the latency-bound bench
// host, where path-halving's unconditional store dirtied a cache line
// (RFO traffic) even for chains it could not shorten.  Returns the same
// root as any compression flavor (roots are never rewritten), so
// outputs are unchanged.
static inline uint32_t uf_find(uint32_t* uf, uint32_t x) {
  uint32_t r = uf[x];
  if (r == x) return x;
  uint32_t rr = uf[r];
  if (rr == r) return r;  // 2 reads, 0 writes — the overwhelming cases
  do {
    r = rr;
    rr = uf[r];
  } while (rr != r);
  while (uf[x] != r) {  // full compression of the (rare) long chain
    uint32_t nx = uf[x];
    uf[x] = r;
    x = nx;
  }
  return r;
}

// ---------------------------------------------------------------------------
// Cache-blocked kernels.
//
// Measured on the 1-core bench host, the forest build decays 43M -> 13.3M
// edges/s from 2^16 to 2^23 (CPUBENCH23_r05).  Phase timers
// (SHEEP_NATIVE_TIME=1) put the loss in two places at 2^23: the
// counting-sort group fill (1.07s -- a random cursor RMW over a 67MB
// offs table plus a random 4-byte store into the 268MB lo_by_hi array,
// which outlives the LLC) and the adoption loop (1.0s -- the union-find
// chase plus a random parent_out read per link).  Plain independent
// random loads on this host cost a flat ~7.8ns (260MB L3; prefetch and
// hugepages were measured to change nothing), so the wins come from
// REMOVING random touches and passes, not from streaming:
//
//   * the group fill becomes a two-phase split: links partition into
//     K = 128 EQUAL-COUNT buckets (quantiles of the per-h prefix
//     table) as packed (h << 32 | lo) records — each bucket's stream
//     write is sequential and the cursor table lives in L1 — and each
//     bucket then scatters against its own small slice of the prefix
//     table into a reused ~linked/K-sized group buffer, with the
//     adoption scan fused right behind while the bucket's lo values
//     are still warm;
//   * every loop stays a TIGHT single-purpose pass: fusing several
//     random-access streams into one loop body was measured up to 2x
//     slower (it starves the out-of-order window's memory-level
//     parallelism), and more than ~128 concurrent write streams
//     measured up to 3x slower per record — both shaped this design;
//   * the adoption loop drops its random parent_out read: a root
//     returned by find has parent set iff it was adopted in the
//     CURRENT group (uf chains are strictly increasing, so a root
//     adopted in an earlier group can never be found again), and the
//     current group's few adoptions sit in a hot vector a linear scan
//     checks faster than one L3 miss (large hub groups fall back to
//     the parent check to stay O(len)).
//
// Everything is order-stable, so outputs are bit-identical to the
// unblocked path (kept for small inputs and the SHEEP_NATIVE_BLOCKED=0
// A/B escape hatch).
// ---------------------------------------------------------------------------

constexpr int kMaxBuckets = 128;  // write-stream cap (measured knee)

static inline bool blocked_enabled() {
  const char* v = std::getenv("SHEEP_NATIVE_BLOCKED");
  return !(v && v[0] == '0' && v[1] == '\0');
}

static inline bool use_blocked(int64_t m, int64_t n) {
  // below one bucket of vertices (or trivially few records) the plain
  // counting sort is already cache-resident and the extra pass is waste
  // m < 2^31: the blocked kernel's int32 prefix table must fit the
  // link count (larger inputs take the int64 unblocked path)
  return blocked_enabled() && n > (int64_t{1} << 16) &&
         m > (int64_t{1} << 16) && m < (int64_t{1} << 31) - 2;
}

// One hi-group's adoption scan (the reference's per-vertex edge scan,
// lib/jtree.cpp:34-55): shared verbatim by the blocked and unblocked
// paths so their semantics cannot drift.  Unions are deferred to the end
// of the group (adoptKids, lib/jnode.h:184-188).  The already-adopted
// check scans the group's own adoption list while it is small: a found
// root r has uf[r] == r, uf chains are strictly increasing and adoption
// at an earlier group set uf[r] to that group's (larger) vertex forever,
// so parent_out[r] != kInvalid can ONLY mean "adopted earlier in this
// group" -- which the hot list answers without a ~7.8ns random read.
template <bool kPre>
static inline void adopt_group_impl(const uint32_t* grp, int64_t len,
                                    uint32_t hh, uint32_t* uf,
                                    uint32_t* parent_out, uint32_t* pre_out,
                                    std::vector<uint32_t>& adopted,
                                    std::vector<uint64_t>* cap) {
  adopted.clear();
  for (int64_t i = 0; i < len; ++i) {
    if (i + 8 < len) __builtin_prefetch(&uf[grp[i + 8]]);
    uint32_t r = uf_find(uf, grp[i]);
    if (kPre) ++pre_out[r];
    if (r == hh) continue;
    bool seen;
    if (adopted.size() <= 48) {
      seen = false;
      for (uint32_t a : adopted)
        if (a == r) { seen = true; break; }
    } else {  // hub group: the list outgrew one cache miss's worth
      seen = parent_out[r] != kInvalid;
    }
    if (!seen) {
      parent_out[r] = hh;  // adopt: lib/jnode.h:158-162
      adopted.push_back(r);
    }
  }
  for (uint32_t r : adopted) uf[r] = hh;
  if (cap)  // the threaded arm's (h, kid) capture — already h-ascending
    for (uint32_t r : adopted)
      cap->push_back(((uint64_t)hh << 32) | r);
}

static inline void adopt_group(const uint32_t* grp, int64_t len, uint32_t hh,
                               uint32_t* uf, uint32_t* parent_out,
                               uint32_t* pre_out,
                               std::vector<uint32_t>& adopted,
                               std::vector<uint64_t>* cap = nullptr) {
  if (pre_out)
    adopt_group_impl<true>(grp, len, hh, uf, parent_out, pre_out, adopted,
                           cap);
  else
    adopt_group_impl<false>(grp, len, hh, uf, parent_out, pre_out, adopted,
                            cap);
}

static inline uint32_t rec_lo(uint64_t r) { return (uint32_t)r; }
static inline int64_t rec_h(uint64_t r) { return (int64_t)(r >> 32); }

static void blocked_group_adopt(const uint32_t* lo, const uint32_t* hi,
                                int64_t m, int64_t n, uint32_t* pst_out,
                                uint32_t* uf, uint32_t* parent_out,
                                uint32_t* pre_out, PhaseTimer& pt);

// Serial grouping+adoption dispatch (the one place the blocked/plain
// choice lives for a given slice of links).
static inline void group_adopt_dispatch(const uint32_t* lo, const uint32_t* hi,
                                        int64_t m, int64_t n,
                                        uint32_t* pst_out, uint32_t* uf,
                                        uint32_t* parent_out,
                                        uint32_t* pre_out, PhaseTimer& pt);

static void threaded_group_adopt(const uint32_t* lo, const uint32_t* hi,
                                 int64_t m, int64_t n, uint32_t* pst_out,
                                 uint32_t* uf, uint32_t* parent_out, int T,
                                 PhaseTimer& pt);

// Unblocked grouping + adoption (counting sort by hi, then the shared
// adopt_group): the small-input path of sheep_build_forest, factored so
// the resumable block fold below reuses it verbatim.
static void plain_group_adopt(const uint32_t* lo, const uint32_t* hi,
                              int64_t m, int64_t n, uint32_t* pst_out,
                              uint32_t* uf, uint32_t* parent_out,
                              uint32_t* pre_out, PhaseTimer& pt) {
  if (pst_out)
    for (int64_t i = 0; i < m; ++i) ++pst_out[lo[i]];
  pt.mark("pst");
  std::vector<int64_t> offs((size_t)n + 1, 0);
  for (int64_t i = 0; i < m; ++i)
    if (hi[i] < (uint64_t)n) ++offs[hi[i] + 1];
  pt.mark("count");
  for (int64_t h = 0; h < n; ++h) offs[h + 1] += offs[h];
  int64_t linked = offs[n];
  std::vector<uint32_t> lo_by_hi((size_t)linked);
  {
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t i = 0; i < m; ++i)
      if (hi[i] < (uint64_t)n) lo_by_hi[(size_t)cur[hi[i]]++] = lo[i];
  }
  pt.mark("scatter");
  std::vector<uint32_t> adopted;
  for (int64_t h = 0; h < n; ++h)
    adopt_group(lo_by_hi.data() + offs[h], offs[h + 1] - offs[h],
                (uint32_t)h, uf, parent_out, pre_out, adopted);
  pt.mark("adopt");
}

// One block of the resumable link fold — sheep_build_forest's loop split
// at the block boundary (the streaming windowed handoff).
// Blocks must arrive in ascending-hi order: every linked record (hi < n)
// must satisfy hi >= lo_bound, where lo_bound is the previous block's
// return value (0 for the first).  An equal-hi group MAY split across
// adjacent blocks: within one hi-group the adoption order cannot change
// parent (distinct component roots each adopt exactly once, repeats are
// no-ops, and a root adopted by the first half is found AS h by the
// second half's uf chase — the same no-op), so a boundary landing inside
// a group is exact.  ``accumulate_pst`` adds 1 to pst_out[lo] per record
// (pst-only links hi >= n included) — exact only when the blocks
// together carry the ORIGINAL link multiset; chunk-rewritten callers
// pass their prep-time pst at begin instead.  Returns the new bound
// (max linked hi seen), -3 on a malformed lo, -7 on an out-of-order
// block (which would silently build a different forest).
static int64_t fold_links_block(const uint32_t* lo, const uint32_t* hi,
                                int64_t m, int64_t n, int64_t lo_bound,
                                bool accumulate_pst, uint32_t* uf,
                                uint32_t* parent_out, uint32_t* pst_out,
                                uint32_t* pre_out, PhaseTimer& pt) {
  // pre accounting is inherently order-within-the-whole-build (the root
  // BEFORE adoption), so the threaded partial decomposition keeps off it
  const int T = pre_out ? 1 : threads_for_work(m);
  int64_t mx = lo_bound;
  bool bad_lo = false, bad_order = false;
#ifdef _OPENMP
  if (T > 1) {
#pragma omp parallel for num_threads(T) schedule(static) \
    reduction(max : mx) reduction(|| : bad_lo, bad_order)
    for (int64_t i = 0; i < m; ++i) {
      if (lo[i] >= (uint64_t)n) bad_lo = true;
      if (hi[i] < (uint64_t)n) {
        if ((int64_t)hi[i] < lo_bound) bad_order = true;
        if ((int64_t)hi[i] > mx) mx = (int64_t)hi[i];
      }
    }
  } else
#endif
  {
    for (int64_t i = 0; i < m; ++i) {
      if (lo[i] >= (uint64_t)n) return -3;  // malformed link
      if (hi[i] < (uint64_t)n) {
        if ((int64_t)hi[i] < lo_bound) return -7;  // out-of-order block
        if ((int64_t)hi[i] > mx) mx = (int64_t)hi[i];
      }
    }
  }
  if (bad_lo) return -3;
  if (bad_order) return -7;
  pt.mark("validate");
  if (T > 1) {
    threaded_group_adopt(lo, hi, m, n,
                         accumulate_pst ? pst_out : nullptr, uf,
                         parent_out, T, pt);
  } else {
    group_adopt_dispatch(lo, hi, m, n,
                         accumulate_pst ? pst_out : nullptr, uf,
                         parent_out, pre_out, pt);
  }
  return mx;
}

// Grouping + adoption of (lo, hi<n) links, shared by sheep_build_forest
// and the fused sheep_build_forest_edges.  One global per-h count
// builds the prefix table; EQUAL-COUNT bucket boundaries come from its
// quantiles -- equal-SPAN buckets were measured useless on power-law
// inputs, where ONE 2^16-position window held 79% of all links at 2^23
// and its scatter degenerated back to the cache-hostile global fill.
// With ~linked/128 links per bucket, a hub bucket's position span is
// tiny (its slice of the prefix table and its group buffer are L2-
// resident) while a sparse bucket's wide span carries few links.  The
// per-link bucket lookup is O(1): a 32KB block table (h >> 10) gives
// the starting bucket and a short forward walk crosses any remaining
// boundaries.  ``pst_out`` non-null also accumulates the tree-link pst
// histogram inside the partition pass's read loop (its own tight pass
// upstream would reread the full link arrays).
static void blocked_group_adopt(const uint32_t* lo, const uint32_t* hi,
                                int64_t m, int64_t n, uint32_t* pst_out,
                                uint32_t* uf, uint32_t* parent_out,
                                uint32_t* pre_out, PhaseTimer& pt) {
  // int32 prefix table: the count pass's random increments measured
  // ~27% cheaper on 4-byte counters than 8-byte (narrower line
  // footprint); use_blocked guarantees m < 2^31 so the prefix fits
  std::vector<int32_t> offs((size_t)n + 1, 0);
  for (int64_t i = 0; i < m; ++i)
    if (hi[i] < (uint64_t)n) ++offs[hi[i] + 1];
  if (pst_out)
    for (int64_t i = 0; i < m; ++i) ++pst_out[lo[i]];
  pt.mark("count+pst");
  for (int64_t h = 0; h < n; ++h) offs[h + 1] += offs[h];
  const int64_t linked = offs[n];
  // equal-count boundaries (a single h never splits: a bucket is just
  // allowed to run over when one group alone exceeds the target)
  const int64_t K = kMaxBuckets;
  std::vector<int64_t> bound((size_t)K + 1);
  bound[0] = 0;
  bound[(size_t)K] = n;
  for (int64_t b = 1; b < K; ++b)
    bound[(size_t)b] = std::lower_bound(offs.begin(), offs.begin() + n + 1,
                                        (int32_t)(b * linked / K)) -
                       offs.begin();
  // per-h bucket-id table (uint8; K <= 128): one sequential O(n) build,
  // then the per-link lookup is a single gather that hub-heavy inputs
  // keep L1/L2-hot (a boundary-walk lookup was measured 4x slower —
  // boundaries CLUSTER inside the hub windows, exactly where most
  // links land, so walks there crossed dozens of boundaries per link)
  std::vector<uint8_t> bucket_of((size_t)n);
  for (int64_t b = 0; b < K; ++b)
    std::memset(bucket_of.data() + bound[(size_t)b], (int)b,
                (size_t)(bound[(size_t)b + 1] - bound[(size_t)b]));
  std::vector<int64_t> bstart((size_t)K + 1);
  for (int64_t b = 0; b <= K; ++b) bstart[(size_t)b] = offs[bound[(size_t)b]];
  std::unique_ptr<uint64_t[]> recs(new uint64_t[(size_t)linked]);
  {
    std::vector<int64_t> bcur(bstart.begin(), bstart.end() - 1);
    for (int64_t i = 0; i < m; ++i) {
      const uint32_t h = hi[i];
      if (h >= (uint64_t)n) continue;
      recs[(size_t)bcur[bucket_of[h]]++] = ((uint64_t)h << 32) | lo[i];
    }
  }
  pt.mark("partition");
  std::vector<uint32_t> grouped, adopted;
  double scat_s = 0, adopt_s = 0;
  const bool timed = time_enabled();
  for (int64_t b = 0; b < K; ++b) {
    const int64_t s = bstart[(size_t)b], t = bstart[(size_t)b + 1];
    if (s == t) continue;
    auto t0 = timed ? std::chrono::steady_clock::now()
                    : std::chrono::steady_clock::time_point();
    if ((int64_t)grouped.size() < t - s) grouped.resize((size_t)(t - s));
    // offs[h] is the global start of group h; mutate it as the scatter
    // cursor, leaving offs[h] == end of group h for the boundary walk
    for (int64_t i = s; i < t; ++i)
      grouped[(size_t)(offs[rec_h(recs[(size_t)i])]++ - s)] =
          rec_lo(recs[(size_t)i]);
    auto t1 = timed ? std::chrono::steady_clock::now()
                    : std::chrono::steady_clock::time_point();
    int64_t prev = s;
    for (int64_t h = bound[(size_t)b]; h < bound[(size_t)b + 1]; ++h) {
      const int64_t end = offs[h];
      if (end > prev)
        adopt_group(grouped.data() + (prev - s), end - prev, (uint32_t)h,
                    uf, parent_out, pre_out, adopted);
      prev = end;
    }
    if (timed) {
      auto t2 = std::chrono::steady_clock::now();
      scat_s += std::chrono::duration<double>(t1 - t0).count();
      adopt_s += std::chrono::duration<double>(t2 - t1).count();
    }
  }
  if (timed)
    std::fprintf(stderr, "native buckets.scatter %.3fs .adopt %.3fs\n",
                 scat_s, adopt_s);
  pt.mark("buckets");
}

static inline void group_adopt_dispatch(const uint32_t* lo, const uint32_t* hi,
                                        int64_t m, int64_t n,
                                        uint32_t* pst_out, uint32_t* uf,
                                        uint32_t* parent_out,
                                        uint32_t* pre_out, PhaseTimer& pt) {
  if (use_blocked(m, n))
    blocked_group_adopt(lo, hi, m, n, pst_out, uf, parent_out, pre_out, pt);
  else
    plain_group_adopt(lo, hi, m, n, pst_out, uf, parent_out, pre_out, pt);
}

// The threaded fold: T contiguous record slices, each folded
// by one thread into a PRIVATE partial forest (its own identity
// union-find + kInvalid parent over the full [n] position space — the
// 8n-per-extra-thread the governor prices), then ONE deterministic
// merge replaying every partial's (kid -> parent) links into the real
// carried state through the same grouping+adoption.
//
// Exactness is the associative-merge theorem the tournament and every
// streaming fold already stand on: forest(A ∪ B) == forest(links(
// forest(A)) ∪ links(forest(B))), so the merged result is the unique
// forest of the whole multiset — independent of T, of where the slices
// cut (an equal-hi group MAY span slices: the same group-split argument
// as resumable block boundaries), and of the merge bracket (k-way
// concat here == any pairwise tree, proven by the bracket-independence
// test).  pst partials are int-add commutative, summed in fixed thread
// order.  Slices are cut on raw record positions, not on hi-group
// boundaries: the input is not hi-sorted at this layer (each slice's
// own counting sort / quantile bucketing does that privately), so
// aligning cuts would cost a full partition pass before any thread
// could start — and exactness needs no alignment.
#ifdef _OPENMP
// One thread's half of the decomposition: fold already-mapped slice
// links into a PRIVATE partial forest (identity union-find + kInvalid
// parent over the full [n] space) and emit the partial's (kid ->
// parent) links for the merge.  pst_l non-null accumulates this slice's
// pst contribution (all links, pst-only included).
static void slice_partial_fold(const uint32_t* lo, const uint32_t* hi,
                               int64_t m, int64_t n, uint32_t* pst_l,
                               std::vector<uint32_t>& out_lo,
                               std::vector<uint32_t>& out_hi) {
  std::vector<uint32_t> uf_l((size_t)n), parent_l((size_t)n);
  for (int64_t v = 0; v < n; ++v) {
    uf_l[(size_t)v] = (uint32_t)v;
    parent_l[(size_t)v] = kInvalid;
  }
  PhaseTimer ptl("thread_slice");
  ptl.on = false;  // per-thread phase prints would interleave
  group_adopt_dispatch(lo, hi, m, n, pst_l, uf_l.data(), parent_l.data(),
                       nullptr, ptl);
  for (int64_t v = 0; v < n; ++v)
    if (parent_l[(size_t)v] != kInvalid) {
      out_lo.push_back((uint32_t)v);
      out_hi.push_back(parent_l[(size_t)v]);
    }
}

// The deterministic merge: per-thread pst partials sum in fixed
// ascending thread order (uint32 adds commute — the sum is the serial
// count bit for bit), and every partial forest's links replay into the
// real carried state through the same grouping+adoption.  The k-way
// concat here equals ANY pairwise merge bracket by associativity
// (proven by the bracket-independence test in tests/test_native_threads.py).
static void merge_partials(std::vector<std::vector<uint32_t>>& mlo,
                           std::vector<std::vector<uint32_t>>& mhi,
                           std::vector<std::vector<uint32_t>>& psts,
                           uint32_t* pst_out, int64_t n, int T, uint32_t* uf,
                           uint32_t* parent_out, PhaseTimer& pt) {
  if (pst_out) {
#pragma omp parallel for num_threads(T) schedule(static)
    for (int64_t v = 0; v < n; ++v) {
      uint32_t s = 0;
      for (int tt = 0; tt < T; ++tt) s += psts[(size_t)tt][(size_t)v];
      pst_out[v] += s;
    }
  }
  size_t total = 0;
  for (auto& v2 : mlo) total += v2.size();
  std::vector<uint32_t> alo, ahi;
  alo.reserve(total);
  ahi.reserve(total);
  for (int tt = 0; tt < T; ++tt) {
    alo.insert(alo.end(), mlo[(size_t)tt].begin(), mlo[(size_t)tt].end());
    ahi.insert(ahi.end(), mhi[(size_t)tt].begin(), mhi[(size_t)tt].end());
  }
  // partial links never count pst (they are tree edges, not records)
  group_adopt_dispatch(alo.data(), ahi.data(), (int64_t)alo.size(), n,
                       nullptr, uf, parent_out, nullptr, pt);
  pt.mark("merge");
}
#endif

#ifdef _OPENMP
// The threaded BLOCKED kernel: the cache-
// blocked kernel's quantile buckets are the parallel decomposition.
// One shared count + bucket partition (threaded over contiguous record
// slices with per-thread partial counts / cursor matrices — adds
// commute, cursor segments are disjoint), then the K equal-count
// buckets split into T contiguous RUNS cut on bucket boundaries, so no
// bucket — and therefore no hi-group — ever spans two threads.  Each
// thread adopts its run into a PRIVATE partial forest (identity uf +
// kInvalid parent over the full [n] space: the 8n-per-extra-thread the
// governor prices), capturing its (h, kid) adoptions; runs own
// DISJOINT ASCENDING h-ranges, so the captures concatenated in thread
// order are one globally h-ascending stream, and the merge is a single
// scaffold-free linear fold of that stream into the real carried state
// through the same adopt_group (no counting sort, no bucket tables —
// the merge reuses the exact serial group semantics).
//
// Exactness is the associative-merge theorem the tournament and every
// streaming fold already stand on: the merged result is the unique
// forest of the whole multiset, independent of T, of where the runs
// cut, and of the merge bracket (proven by the bracket-independence
// test in tests/test_native_threads.py) — parent and pst are bit-identical
// to the single-thread build for every thread count.
static void blocked_group_adopt_mt(const uint32_t* lo, const uint32_t* hi,
                                   int64_t m, int64_t n, uint32_t* pst_out,
                                   uint32_t* uf, uint32_t* parent_out,
                                   int T, PhaseTimer& pt) {
  ThreadStats* ts = &g_tstats;
  ts->used = T;
  // the arena's T slabs back BOTH per-thread table phases (count+pst
  // partials here, union-find+parent partials in phase 4) — 8n+8 bytes
  // per thread, warm across calls (struct comment)
  ThreadArena* arena = &g_arena;
  arena->ensure(n, T);
  // phase 1: per-h counts (+ pst) — per-thread partials over contiguous
  // record slices, summed in fixed thread order (int adds commute)
  std::vector<int32_t> offs((size_t)n + 1, 0);
#pragma omp parallel num_threads(T)
  {
    const int t = omp_get_thread_num();
    const double t0 = mono_s();
    const int64_t a = m * t / T, b = m * (t + 1) / T;
    int32_t* c = (int32_t*)arena->slab(t);  // [n+1]
    uint32_t* p = arena->slab(t) + n + 1;   // [n]
    std::memset(c, 0, sizeof(int32_t) * (size_t)(n + 1));
    for (int64_t i = a; i < b; ++i)
      if (hi[i] < (uint64_t)n) ++c[hi[i] + 1];
    if (pst_out) {
      std::memset(p, 0, sizeof(uint32_t) * (size_t)n);
      for (int64_t i = a; i < b; ++i) ++p[lo[i]];
    }
    if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
  }
#pragma omp parallel for num_threads(T) schedule(static)
  for (int64_t h = 0; h <= n; ++h) {
    int32_t s = 0;
    for (int tt = 0; tt < T; ++tt) s += ((int32_t*)arena->slab(tt))[h];
    offs[(size_t)h] = s;
  }
  if (pst_out) {
    // one region, fixed ascending tt order per v — adds commute
#pragma omp parallel for num_threads(T) schedule(static)
    for (int64_t v = 0; v < n; ++v) {
      uint32_t s = 0;
      for (int tt = 0; tt < T; ++tt) s += (arena->slab(tt) + n + 1)[v];
      pst_out[v] += s;
    }
  }
  pt.mark("count+pst");
  // phase 2: prefix + the SAME quantile bucket rule as the serial
  // kernel (equal-count boundaries over the per-h prefix)
  for (int64_t h = 0; h < n; ++h) offs[h + 1] += offs[h];
  const int64_t linked = offs[n];
  const int64_t K = kMaxBuckets;
  std::vector<int64_t> bound((size_t)K + 1);
  bound[0] = 0;
  bound[(size_t)K] = n;
  for (int64_t b = 1; b < K; ++b)
    bound[(size_t)b] = std::lower_bound(offs.begin(), offs.begin() + n + 1,
                                        (int32_t)(b * linked / K)) -
                       offs.begin();
  std::vector<uint8_t> bucket_of((size_t)n);
  for (int64_t b = 0; b < K; ++b)
    std::memset(bucket_of.data() + bound[(size_t)b], (int)b,
                (size_t)(bound[(size_t)b + 1] - bound[(size_t)b]));
  std::vector<int64_t> bstart((size_t)K + 1);
  for (int64_t b = 0; b <= K; ++b) bstart[(size_t)b] = offs[bound[(size_t)b]];
  // phase 3: threaded partition — per-(thread, bucket) counts give each
  // thread disjoint write segments (thread-major inside a bucket; group
  // adoption is order-free within a group, so outputs are unchanged).
  // The counts come FREE from phase 1's per-h slabs (a sequential O(n)
  // sum per thread) instead of a second O(m) pass over the records.
  std::unique_ptr<uint64_t[]> recs(new uint64_t[(size_t)linked]);
  {
    std::vector<std::vector<int64_t>> bcnt((size_t)T);
#pragma omp parallel num_threads(T)
    {
      const int t = omp_get_thread_num();
      const double t0 = mono_s();
      const int64_t a = m * t / T, b = m * (t + 1) / T;
      const int32_t* c = (const int32_t*)arena->slab(t);  // phase-1 counts
      std::vector<int64_t>& bc = bcnt[(size_t)t];
      bc.assign((size_t)K, 0);
      for (int64_t b2 = 0; b2 < K; ++b2) {
        int64_t s = 0;
        for (int64_t h = bound[(size_t)b2]; h < bound[(size_t)b2 + 1]; ++h)
          s += c[h + 1];
        bc[(size_t)b2] = s;
      }
#pragma omp barrier
      std::vector<int64_t> curl((size_t)K);
      for (int64_t b2 = 0; b2 < K; ++b2) {
        int64_t at = bstart[(size_t)b2];
        for (int tt = 0; tt < t; ++tt) at += bcnt[(size_t)tt][(size_t)b2];
        curl[(size_t)b2] = at;
      }
      for (int64_t i = a; i < b; ++i) {
        const uint32_t h = hi[i];
        if (h >= (uint64_t)n) continue;
        recs[(size_t)curl[bucket_of[h]]++] = ((uint64_t)h << 32) | lo[i];
      }
      if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
    }
  }
  pt.mark("partition");
  // phase 4: bucket RUNS — T contiguous runs cut on bucket boundaries
  // balanced by link count; each thread adopts its run into a private
  // partial forest, capturing (h, kid) pairs in ascending-h order
  std::vector<int64_t> rb((size_t)T + 1);
  rb[0] = 0;
  rb[(size_t)T] = K;
  for (int64_t t = 1; t < T; ++t) {
    int64_t cut = std::lower_bound(bstart.begin(), bstart.begin() + K + 1,
                                   t * linked / T) -
                  bstart.begin();
    rb[(size_t)t] = std::max(rb[(size_t)t - 1], std::min(cut, (int64_t)K));
  }
  std::vector<std::vector<uint64_t>>& caps = g_caps;
  if ((int)caps.size() < T) caps.resize((size_t)T);
  for (int t = 0; t < T; ++t) caps[(size_t)t].clear();  // capacity kept
#pragma omp parallel num_threads(T)
  {
    const int t = omp_get_thread_num();
    const double t0 = mono_s();
    uint32_t* uf_l = arena->slab(t);          // [n] — phase 1 is done
    uint32_t* parent_l = arena->slab(t) + n;  // [n] with these slabs
    for (int64_t v = 0; v < n; ++v) {
      uf_l[(size_t)v] = (uint32_t)v;
      parent_l[(size_t)v] = kInvalid;
    }
    std::vector<uint32_t> grouped, adopted;
    std::vector<uint64_t>* cap = &caps[(size_t)t];
    for (int64_t b2 = rb[(size_t)t]; b2 < rb[(size_t)t + 1]; ++b2) {
      const int64_t s = bstart[(size_t)b2], e = bstart[(size_t)b2 + 1];
      if (s == e) continue;
      if ((int64_t)grouped.size() < e - s) grouped.resize((size_t)(e - s));
      // offs[h] mutates as the scatter cursor exactly like the serial
      // bucket loop — every h lives in exactly one bucket, every bucket
      // in exactly one run, so the mutation is thread-exclusive
      for (int64_t i = s; i < e; ++i)
        grouped[(size_t)(offs[rec_h(recs[(size_t)i])]++ - s)] =
            rec_lo(recs[(size_t)i]);
      int64_t prev = s;
      for (int64_t h = bound[(size_t)b2]; h < bound[(size_t)b2 + 1]; ++h) {
        const int64_t end = offs[h];
        if (end > prev)
          adopt_group(grouped.data() + (prev - s), end - prev, (uint32_t)h,
                      uf_l, parent_l, nullptr, adopted, cap);
        prev = end;
      }
    }
    if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
  }
  pt.mark("slices");
  // phase 5: the linear merge — thread captures concatenate into one
  // globally h-ascending stream (runs own disjoint ascending h-ranges;
  // an equal-h group can never span runs because runs cut on bucket
  // boundaries), replayed into the real carried state group by group
  // through the exact serial adoption
  std::vector<uint32_t> run, adopted;
  for (int64_t t = 0; t < T; ++t) {
    const std::vector<uint64_t>& cp = caps[(size_t)t];
    size_t i = 0;
    while (i < cp.size()) {
      const uint32_t h = (uint32_t)(cp[i] >> 32);
      run.clear();
      while (i < cp.size() && (uint32_t)(cp[i] >> 32) == h)
        run.push_back((uint32_t)cp[i++]);
      adopt_group(run.data(), (int64_t)run.size(), h, uf, parent_out,
                  nullptr, adopted);
    }
  }
  pt.mark("merge");
}
#endif

static void threaded_group_adopt(const uint32_t* lo, const uint32_t* hi,
                                 int64_t m, int64_t n, uint32_t* pst_out,
                                 uint32_t* uf, uint32_t* parent_out, int T,
                                 PhaseTimer& pt) {
#ifdef _OPENMP
  if (use_blocked(m, n)) {
    // the main threaded path: shared count/partition, bucket-run slices
    blocked_group_adopt_mt(lo, hi, m, n, pst_out, uf, parent_out, T, pt);
    return;
  }
  // plain-path inputs (below the blocked floor, or past the int32
  // prefix limit): per-thread partial forests over contiguous record
  // slices, merged through the same grouping+adoption
  std::vector<std::vector<uint32_t>> mlo((size_t)T), mhi((size_t)T);
  std::vector<std::vector<uint32_t>> psts(pst_out ? (size_t)T : 0);
  ThreadStats* ts = &g_tstats;
  ts->used = T;
#pragma omp parallel num_threads(T)
  {
    const int t = omp_get_thread_num();
    const double t0 = mono_s();
    const int64_t a = m * t / T, b = m * (t + 1) / T;
    uint32_t* pst_l = nullptr;
    if (pst_out) {
      psts[(size_t)t].assign((size_t)n, 0);
      pst_l = psts[(size_t)t].data();
    }
    slice_partial_fold(lo + a, hi + a, b - a, n, pst_l, mlo[(size_t)t],
                       mhi[(size_t)t]);
    if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
  }
  pt.mark("slices");
  merge_partials(mlo, mhi, psts, pst_out, n, T, uf, parent_out, pt);
#else
  (void)T;
  group_adopt_dispatch(lo, hi, m, n, pst_out, uf, parent_out, nullptr, pt);
#endif
}
}  // namespace

extern "C" {

// Build the elimination forest from links (lo -> hi), lo < hi elementwise,
// in ascending-hi order — the exact sequential semantics of the reference's
// streaming insert (lib/jtree.cpp:34-55: each earlier root is adopted by the
// later endpoint).  Links are grouped by hi with a counting sort, so the
// cost is O(m + n) plus near-O(1) amortized finds.
//
//   lo, hi     [m]  uint32 sequence positions; lo must be < n; hi >= n marks
//              a "pst-only" link (edge to a vertex absent from the sequence,
//              which counts toward pst but never forms a tree edge — the
//              reference's forever-uninserted neighbor, jtree.cpp:47-49)
//   pst_in     [n]  uint32 or NULL; when NULL each link adds 1 to pst[lo]
//   parent_out [n]  uint32, kInvalid for roots
//   pst_out    [n]  uint32
//   pre_out    [n]  uint32 or NULL; when given, filled with the reference's
//              USE_PRE_WEIGHT accounting (lib/jnode.h:174-176 meetKid): each
//              tree link (lo -> h) adds 1 to pre[r] where r is lo's
//              component root *before* h's adoptions — the number of graph
//              edges between parent(r) and r's subtree.  Unions are deferred
//              to the end of each h-group to match the reference, which
//              unifies only in adoptKids after the whole edge scan
//              (lib/jnode.h:184-188, jtree.cpp:102).
//   scratch: internally allocates ~ (m + 2n) * 4 bytes.
int sheep_build_forest(const uint32_t* lo, const uint32_t* hi, int64_t m,
                       int64_t n, const uint32_t* pst_in,
                       uint32_t* parent_out, uint32_t* pst_out,
                       uint32_t* pre_out) {
  if (n < 0 || m < 0) return -1;
  tstats_reset();
  PhaseTimer pt("build_forest");
  const bool blocked = use_blocked(m, n);
  if (pst_in) {
    std::memcpy(pst_out, pst_in, sizeof(uint32_t) * (size_t)n);
  } else {
    std::memset(pst_out, 0, sizeof(uint32_t) * (size_t)n);
  }
  for (int64_t v = 0; v < n; ++v) parent_out[v] = kInvalid;
  if (pre_out) std::memset(pre_out, 0, sizeof(uint32_t) * (size_t)n);
  std::vector<uint32_t> uf((size_t)n);
  for (int64_t v = 0; v < n; ++v) uf[(size_t)v] = (uint32_t)v;
  (void)blocked;  // dispatch lives in fold_links_block (use_blocked)

  // The whole input as ONE block of the resumable fold — the monolithic
  // build and the streaming windowed handoff share every semantic by
  // construction.  Outputs are undefined on error, so a partially
  // filled pst at the -3 return is fine.
  int64_t rc = fold_links_block(lo, hi, m, n, 0, !pst_in, uf.data(),
                                parent_out, pst_out, pre_out, pt);
  return rc < 0 ? (int)rc : 0;
}

// ---------------------------------------------------------------------------
// Resumable link fold (streaming windowed handoff): the exact
// sheep_build_forest split at block boundaries so a host fold can consume
// device link windows AS THEY ARRIVE (fetch of window k+1 overlapping the
// fold of window k) without ever materializing the full link table.  All
// state is caller-owned ([n] buffers: parent/pst plus the union-find
// array), so the Python side can keep it across an arbitrary number of
// blocks and recover it after a failed stream.
// ---------------------------------------------------------------------------

// Initialize the fold state.  pst_in NULL => blocks accumulate pst from
// their own records (see fold_links_block's exactness note); non-NULL =>
// the precomputed prep-time pst is copied and blocks leave it alone.
int sheep_build_forest_links_begin(int64_t n, const uint32_t* pst_in,
                                   uint32_t* parent_out, uint32_t* pst_out,
                                   uint32_t* uf) {
  if (n < 0) return -1;
  if (pst_in) {
    std::memcpy(pst_out, pst_in, sizeof(uint32_t) * (size_t)n);
  } else {
    std::memset(pst_out, 0, sizeof(uint32_t) * (size_t)n);
  }
  for (int64_t v = 0; v < n; ++v) {
    parent_out[v] = kInvalid;
    uf[(size_t)v] = (uint32_t)v;
  }
  return 0;
}

// Fold one ascending-hi window; see fold_links_block for the ordering
// contract and return values (new bound >= 0, or -3/-7).
int64_t sheep_build_forest_links_block(const uint32_t* lo, const uint32_t* hi,
                                       int64_t m, int64_t n, int64_t lo_bound,
                                       int32_t accumulate_pst,
                                       uint32_t* parent_out,
                                       uint32_t* pst_out, uint32_t* uf) {
  if (n < 0 || m < 0 || lo_bound < 0) return -1;
  tstats_reset();
  PhaseTimer pt("links_block");
  return fold_links_block(lo, hi, m, n, lo_bound, accumulate_pst != 0, uf,
                          parent_out, pst_out, nullptr, pt);
}

// Seal the fold.  The ascending-hi discipline leaves no deferred work —
// parent/pst are already final after the last block; this exists so the
// ABI brackets the stream (begin/block/finish) and a future deferred
// pass has a home.  Returns 0.
int sheep_build_forest_links_finish(int64_t n, uint32_t* parent_out,
                                    uint32_t* uf) {
  (void)parent_out;
  (void)uf;
  return n < 0 ? -1 : 0;
}

// Map raw edge records to links through a vid->position table.  A vid
// beyond the table or mapped to kInvalid is absent from the sequence:
// self-loops and both-absent edges are dropped; a one-absent edge becomes a
// pst-only link (lo = present position, hi = kInvalid) so its pst count
// survives, matching the reference's forever-uninserted neighbors.
// Returns the number of links written (<= m).
int64_t sheep_edges_to_links(const uint32_t* tail, const uint32_t* head,
                             int64_t m, const uint32_t* pos, int64_t pos_len,
                             uint32_t* lo_out, uint32_t* hi_out) {
  int64_t k = 0;
  for (int64_t i = 0; i < m; ++i) {
    uint32_t pt = tail[i] < (uint64_t)pos_len ? pos[tail[i]] : kInvalid;
    uint32_t ph = head[i] < (uint64_t)pos_len ? pos[head[i]] : kInvalid;
    if (pt == ph) continue;  // self-loop or both absent
    lo_out[k] = pt < ph ? pt : ph;
    hi_out[k] = pt < ph ? ph : pt;
    ++k;
  }
  return k;
}

// Decode the 6-byte packed handoff (ops.forest.pack_links_6b: lo then hi,
// each 24-bit little-endian) of nbufs host slices, slices[j] holding
// counts[j] links, into lo_out/hi_out in order, keeping only links with
// lo < n: the dead sentinel slots (lo == n) drop in the same pass, so the
// fold takes the output as it is.  The outputs hold sum(counts) entries.
// Returns the number of links kept, or -1 on a negative size.
int64_t sheep_unpack_links_6b(const uint8_t* const* slices,
                              const int64_t* counts, int64_t nbufs,
                              int64_t n, uint32_t* lo_out,
                              uint32_t* hi_out) {
  static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
                "the 8-byte load reads the packed bytes little-endian");
  if (n < 0 || nbufs < 0) return -1;
  const uint64_t bound = (uint64_t)n;
  int64_t k = 0;
  for (int64_t j = 0; j < nbufs; ++j) {
    const int64_t m = counts[j];
    if (m < 0) return -1;
    const uint8_t* p = slices[j];
    // one unaligned 8-byte load a link while two more bytes follow it in
    // the slice; the last link reads its six bytes one by one
    int64_t i = 0;
    for (; i + 1 < m; ++i, p += 6) {
      uint64_t w;
      std::memcpy(&w, p, sizeof(w));
      const uint32_t lo = (uint32_t)(w & 0xFFFFFFu);
      lo_out[k] = lo;
      hi_out[k] = (uint32_t)((w >> 24) & 0xFFFFFFu);
      k += lo < bound;  // branch-free compaction: a dead slot is overwritten
    }
    for (; i < m; ++i, p += 6) {
      const uint32_t lo = p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
      lo_out[k] = lo;
      hi_out[k] = p[3] | (uint32_t)p[4] << 8 | (uint32_t)p[5] << 16;
      k += lo < bound;
    }
  }
  return k;
}

// forwardPartition (lib/partition.cpp:86-157): ascending pass accumulating
// component_below with first-fit-decreasing bin packing of overweight
// subtrees, then a descending pass inheriting parts from parents and packing
// leftover roots from the most-recent bin backwards.  Kid sorts use a stable
// descending-weight order with ascending-jnid tie break (the reference's
// std::sort is unstable there; see SURVEY.md §7 determinism note).
//
//   parent   [n] uint32 (kInvalid roots)
//   weights  [n] int64 node weights
//   parts_out[n] int32, filled 0..num_parts-1
// Returns number of bins opened, or negative on error (-2: a single node
// outweighs max_component, which would loop forever in the reference; -3: a
// parent entry is neither kInvalid nor < n, e.g. a corrupt .tre file — the
// reference dies on such input via live asserts / .at(), lib/jdata.h:36-40).
int64_t sheep_forward_partition(const uint32_t* parent, const int64_t* weights,
                                int64_t n, int64_t max_component,
                                int32_t* parts_out) {
  constexpr int32_t kNoPart = -1;
  for (int64_t i = 0; i < n; ++i)
    if (parent[i] != kInvalid && parent[i] >= (uint64_t)n) return -3;
  std::vector<int64_t> component_below(weights, weights + n);
  for (int64_t i = 0; i < n; ++i) {
    if (weights[i] > max_component) return -2;
    parts_out[i] = kNoPart;
  }

  // kids grouped by parent in ascending-jnid order (counting sort).
  std::vector<int64_t> koffs((size_t)n + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    if (parent[i] != kInvalid) ++koffs[parent[i] + 1];
  for (int64_t v = 0; v < n; ++v) koffs[v + 1] += koffs[v];
  std::vector<uint32_t> kids((size_t)koffs[n]);
  {
    std::vector<int64_t> cur(koffs.begin(), koffs.end() - 1);
    for (int64_t i = 0; i < n; ++i)
      if (parent[i] != kInvalid) kids[(size_t)cur[parent[i]]++] = (uint32_t)i;
  }

  std::vector<int64_t> part_size;
  std::vector<uint32_t> ks;
  for (int64_t i = 0; i < n; ++i) {
    if (component_below[i] > max_component) {
      ks.assign(kids.begin() + koffs[i], kids.begin() + koffs[i + 1]);
      // descending weight, ascending-jnid ties (stable) — deterministic
      // and identical to the python twin.  The reference uses an UNSTABLE
      // std::sort here (partition.cpp:104-108), so its tie permutation is
      // toolchain-defined; this rule matches 30/31 published rows of
      // data/quality/hep.cost col 2 exactly (24 parts: 2723 vs 2720,
      // +0.1% — no consistent tie direction reproduces that row without
      // breaking others; see scripts/quality_sweep.py)
      std::stable_sort(ks.begin(), ks.end(),
                       [&](uint32_t a, uint32_t b) {
                         return component_below[a] > component_below[b];
                       });
      while (component_below[i] > max_component) {
        for (uint32_t kid : ks) {
          if (component_below[i] <= max_component) break;
          if (parts_out[kid] != kNoPart) continue;
          int64_t cb = component_below[kid];
          for (size_t cur = 0; cur < part_size.size(); ++cur) {
            if (part_size[cur] + cb <= max_component) {
              component_below[i] -= cb;
              part_size[cur] += cb;
              parts_out[kid] = (int32_t)cur;
              break;
            }
          }
        }
        if (component_below[i] > max_component) part_size.push_back(0);
      }
    }
    if (parent[i] != kInvalid) component_below[parent[i]] += component_below[i];
  }

  for (int64_t i = n - 1; i >= 0; --i) {
    if (parts_out[i] == kNoPart && parent[i] != kInvalid)
      parts_out[i] = parts_out[parent[i]];
    while (parts_out[i] == kNoPart) {
      for (int64_t cur = (int64_t)part_size.size() - 1; cur >= 0; --cur) {
        if (part_size[(size_t)cur] + component_below[i] <= max_component) {
          part_size[(size_t)cur] += component_below[i];
          parts_out[i] = (int32_t)cur;
          break;
        }
      }
      if (parts_out[i] == kNoPart) part_size.push_back(0);
    }
  }
  return (int64_t)part_size.size();
}

// Per-vertex degree accumulation for the sequence sort: each record adds 1
// to both endpoints (undirected-doubled semantics, graph_wrapper.h:87-89).
// Returns 0, or -3 when a record names a vid >= n (corrupt input; the
// reference's LLAMA path sizes the table from the real max vid, so an
// out-of-range vid can only come from a malformed file).
int sheep_degree_histogram_acc(const uint32_t* tail, const uint32_t* head,
                               int64_t m, int64_t n, int64_t* deg_io);

int sheep_degree_histogram(const uint32_t* tail, const uint32_t* head,
                           int64_t m, int64_t n, int64_t* deg_out) {
  std::memset(deg_out, 0, sizeof(int64_t) * (size_t)n);
  return sheep_degree_histogram_acc(tail, head, m, n, deg_out);
}

// Accumulating variant for the out-of-core streaming pass: adds
// this block's degree contributions INTO deg_io without zeroing it, so the
// per-block histogram of an edge stream folds into one int64 accumulator
// with no per-block allocation.  Summing blocks is exact (integer adds
// commute), so the accumulated histogram equals sheep_degree_histogram over
// the concatenated records — which is what keeps the streaming degree
// sequence bit-identical to the in-RAM one.  Same -3 contract on a vid
// >= n; a failed block leaves deg_io with a PARTIAL block added (callers
// abort the pass — the accumulator is not salvageable mid-block).
int sheep_degree_histogram_acc(const uint32_t* tail, const uint32_t* head,
                               int64_t m, int64_t n, int64_t* deg_io) {
  tstats_reset();
#ifdef _OPENMP
  // Threaded arm: per-thread int64 partial histograms over
  // contiguous record slices, summed in fixed thread order — integer
  // adds commute, so the sum equals the serial accumulation bit for
  // bit.  Costs 8n per extra thread (the governor's veto term).  On a
  // bad vid NO partial is merged (a stricter contract than the serial
  // loop's partial adds; callers abort the pass either way).
  const int T = threads_for_work(m);
  if (T > 1) {
    bool bad = false;
    ThreadStats* ts = &g_tstats;
    ts->used = T;
    ThreadArena* arena = &g_arena;  // int64[n] partial per slab
    arena->ensure(n, T);
#pragma omp parallel num_threads(T) reduction(|| : bad)
    {
      const int t = omp_get_thread_num();
      const double t0 = mono_s();
      const int64_t a = m * t / T, b = m * (t + 1) / T;
      int64_t* part = (int64_t*)arena->slab(t);
      std::memset(part, 0, sizeof(int64_t) * (size_t)n);
      for (int64_t i = a; i < b; ++i) {
        if (tail[i] >= (uint64_t)n || head[i] >= (uint64_t)n) {
          bad = true;
          break;
        }
        ++part[tail[i]];
        ++part[head[i]];
      }
      if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
    }
    if (bad) return -3;
#pragma omp parallel for num_threads(T) schedule(static)
    for (int64_t v = 0; v < n; ++v) {
      int64_t s = 0;
      for (int tt = 0; tt < T; ++tt)
        s += ((const int64_t*)arena->slab(tt))[v];
      deg_io[v] += s;
    }
    return 0;
  }
#endif
  for (int64_t i = 0; i < m; ++i) {
    if (tail[i] >= (uint64_t)n || head[i] >= (uint64_t)n) return -3;
    ++deg_io[tail[i]];
    ++deg_io[head[i]];
  }
  return 0;
}

// Fused degree sequence straight from edge records: histogram
// + ascending-degree counting sort in one call, with the histogram in
// uint32 — int64 counters measured ~27% slower per random increment on
// the bench host purely from the wider line footprint, and per-vertex
// degrees fit uint32 up to 2^31 records (validated; falls back -5 past
// it, callers use the two-call path).  Semantics identical to
// sheep_degree_histogram + sheep_degree_sequence: nonzero degrees only,
// ascending degree, ascending-vid tie break.  Returns the sequence
// length, -3 on an out-of-range vid, -5 when m is too large for the
// uint32 histogram.
int64_t sheep_degree_sequence_edges(const uint32_t* tail,
                                    const uint32_t* head, int64_t m,
                                    int64_t n, uint32_t* seq_out) {
  if (n < 0 || m < 0 || 2 * m > (int64_t)kInvalid) return -5;
  tstats_reset();
  std::vector<uint32_t> deg((size_t)n, 0);
#ifdef _OPENMP
  // Threaded histogram: uint32 per-thread partials (the same
  // narrow-counter win as the serial kernel) summed in thread order —
  // commutative adds, bit-identical to the serial count.
  const int T = threads_for_work(m);
  if (T > 1) {
    bool bad = false;
    ThreadStats* ts = &g_tstats;
    ts->used = T;
    ThreadArena* arena = &g_arena;  // uint32[n] partial per slab
    arena->ensure(n, T);
#pragma omp parallel num_threads(T) reduction(|| : bad)
    {
      const int t = omp_get_thread_num();
      const double t0 = mono_s();
      const int64_t a = m * t / T, b = m * (t + 1) / T;
      uint32_t* part = arena->slab(t);
      std::memset(part, 0, sizeof(uint32_t) * (size_t)n);
      for (int64_t i = a; i < b; ++i) {
        if (tail[i] >= (uint64_t)n || head[i] >= (uint64_t)n) {
          bad = true;
          break;
        }
        ++part[tail[i]];
        ++part[head[i]];
      }
      if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
    }
    if (bad) return -3;
#pragma omp parallel for num_threads(T) schedule(static)
    for (int64_t v = 0; v < n; ++v) {
      uint32_t s = 0;
      for (int tt = 0; tt < T; ++tt) s += arena->slab(tt)[v];
      deg[(size_t)v] += s;
    }
  } else
#endif
  {
    for (int64_t i = 0; i < m; ++i) {
      if (tail[i] >= (uint64_t)n || head[i] >= (uint64_t)n) return -3;
      ++deg[tail[i]];
      ++deg[head[i]];
    }
  }
  uint32_t max_deg = 0;
  for (int64_t v = 0; v < n; ++v)
    if (deg[v] > max_deg) max_deg = deg[v];
  // same bucket-width guard as the two-call path: a multigraph hub can
  // push max_degree far past n, where counting buckets explode; callers
  // fall back to the comparison sort on -6
  if ((int64_t)max_deg > std::max<int64_t>(4 * n, int64_t{1} << 20))
    return -6;
  std::vector<int64_t> offs((size_t)max_deg + 2, 0);
  for (int64_t v = 0; v < n; ++v)
    if (deg[v] > 0) ++offs[deg[v] + 1];
  for (uint32_t d = 0; d <= max_deg; ++d) offs[d + 1] += offs[d];
  const int64_t total = offs[max_deg + 1];
  for (int64_t v = 0; v < n; ++v)
    if (deg[v] > 0) seq_out[offs[deg[v]]++] = (uint32_t)v;
  return total;
}

// Fused edge->forest build: maps raw records through the vid->position
// table and feeds the blocked grouping DIRECTLY — the lo/hi link arrays
// of the two-call path (sheep_edges_to_links + sheep_build_forest) are
// never materialized, which at 2^23 removes ~0.5GB of stream traffic
// plus the second full-m validation scan.  Exact same semantics: a vid
// beyond the table or mapped to kInvalid is absent; self-loops and
// both-absent records drop; one-absent records count toward pst at the
// present endpoint but never group (the reference's forever-uninserted
// neighbors, jtree.cpp:47-49).  pst_out/parent_out as sheep_build_forest
// (pst always recomputed here — callers with precomputed pst use the
// two-call path).  Returns 0, or -3 when a mapped position lands at or
// beyond n (corrupt pos table).
int sheep_build_forest_edges(const uint32_t* tail, const uint32_t* head,
                             int64_t m, const uint32_t* pos, int64_t pos_len,
                             int64_t n, uint32_t* parent_out,
                             uint32_t* pst_out, uint32_t* pre_out) {
  if (n < 0 || m < 0) return -1;
  tstats_reset();
  PhaseTimer pt("build_forest_edges");
  std::memset(pst_out, 0, sizeof(uint32_t) * (size_t)n);
  for (int64_t v = 0; v < n; ++v) parent_out[v] = kInvalid;
  if (pre_out) std::memset(pre_out, 0, sizeof(uint32_t) * (size_t)n);
  std::vector<uint32_t> uf((size_t)n);
  for (int64_t v = 0; v < n; ++v) uf[(size_t)v] = (uint32_t)v;

#ifdef _OPENMP
  // Threaded arm: the mapping pass parallelizes over record
  // slices with a count-then-write split — pass A counts each slice's
  // kept records (and validates), pass B writes them DIRECTLY into the
  // final arrays at prefix offsets, so the mapped table is byte-
  // identical to the serial pass's with no per-thread staging buffers
  // (staging was measured to double the phase in page faults alone).
  // The shared bucket-run kernel does the rest — pst accumulates inside
  // its threaded count pass exactly like the serial fused path.
  const int T = pre_out ? 1 : threads_for_work(m);
  if (T > 1) {
    bool bad = false;
    std::vector<int64_t> kept((size_t)T, 0);
    ThreadStats* ts = &g_tstats;  // the CALLER's telemetry slot —
    // g_tstats inside the parallel region is each worker's own
#pragma omp parallel num_threads(T) reduction(|| : bad)
    {
      const int t = omp_get_thread_num();
      const double t0 = mono_s();
      const int64_t a = m * t / T, b = m * (t + 1) / T;
      int64_t cnt = 0;
      for (int64_t i = a; i < b; ++i) {
        const uint32_t pt_ =
            tail[i] < (uint64_t)pos_len ? pos[tail[i]] : kInvalid;
        const uint32_t ph_ =
            head[i] < (uint64_t)pos_len ? pos[head[i]] : kInvalid;
        if (pt_ == ph_) continue;  // self-loop or both absent
        if ((pt_ < ph_ ? pt_ : ph_) >= (uint64_t)n) {  // corrupt pos
          bad = true;
          break;
        }
        ++cnt;
      }
      kept[(size_t)t] = cnt;
      if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
    }
    if (bad) return -3;
    int64_t k = 0;
    std::vector<int64_t> starts((size_t)T);
    for (int t = 0; t < T; ++t) {
      starts[(size_t)t] = k;
      k += kept[(size_t)t];
    }
    std::vector<uint32_t> mlo((size_t)k), mhi((size_t)k);
#pragma omp parallel num_threads(T)
    {
      const int t = omp_get_thread_num();
      const double t0 = mono_s();
      const int64_t a = m * t / T, b = m * (t + 1) / T;
      int64_t at = starts[(size_t)t];
      for (int64_t i = a; i < b; ++i) {
        const uint32_t pt_ =
            tail[i] < (uint64_t)pos_len ? pos[tail[i]] : kInvalid;
        const uint32_t ph_ =
            head[i] < (uint64_t)pos_len ? pos[head[i]] : kInvalid;
        if (pt_ == ph_) continue;
        mlo[(size_t)at] = pt_ < ph_ ? pt_ : ph_;
        mhi[(size_t)at] = pt_ < ph_ ? ph_ : pt_;
        ++at;
      }
      if (t < kMaxThreads) ts->busy[t] += mono_s() - t0;
    }
    pt.mark("map");
    threaded_group_adopt(mlo.data(), mhi.data(), k, n, pst_out, uf.data(),
                         parent_out, T, pt);
    return 0;
  }
#endif

  // Tight mapping pass (the only pos-gather pass; pst and the group
  // count live in blocked_group_adopt's own read passes — a fused loop
  // mixing extra random-access streams here was measured to starve the
  // out-of-order window's memory-level parallelism), then the shared
  // quantile-bucketed grouping+adoption.  pst-only links (absent
  // neighbor, hi = kInvalid >= n) stay in the mapped arrays: the pst
  // pass counts every link's lo, the grouping skips hi >= n.
  std::vector<uint32_t> mlo((size_t)m), mhi((size_t)m);
  int64_t k = 0;
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t pt_ = tail[i] < (uint64_t)pos_len ? pos[tail[i]] : kInvalid;
    const uint32_t ph_ = head[i] < (uint64_t)pos_len ? pos[head[i]] : kInvalid;
    if (pt_ == ph_) continue;  // self-loop or both absent
    const uint32_t l = pt_ < ph_ ? pt_ : ph_;
    if (l >= (uint64_t)n) return -3;  // corrupt pos table
    mlo[(size_t)k] = l;
    mhi[(size_t)k] = pt_ < ph_ ? ph_ : pt_;
    ++k;
  }
  pt.mark("map");
  blocked_group_adopt(mlo.data(), mhi.data(), k, n, pst_out, uf.data(),
                      parent_out, pre_out, pt);
  return 0;
}

// Ascending-degree sequence with ascending-vid tie break, nonzero degrees
// only (lib/sequence.h:52-63).  Degrees are small integers, so this is a
// counting sort over degree buckets — iterating vids in ascending order
// within a bucket gives the vid tie break for free; O(n + max_degree)
// versus the reference's comparison sort.  Returns the sequence length.
int64_t sheep_degree_sequence(const int64_t* deg, int64_t n,
                              uint32_t* seq_out) {
  tstats_reset();
  int64_t max_deg = 0;
#ifdef _OPENMP
  int T = threads_for_work(n);
#pragma omp parallel for num_threads(T) schedule(static) \
    reduction(max : max_deg) if (T > 1)
#endif
  for (int64_t v = 0; v < n; ++v)
    if (deg[v] > max_deg) max_deg = deg[v];
#ifdef _OPENMP
  // Threaded counting sort: per-thread degree-bucket counts
  // over contiguous vid slices, exclusive-prefixed into per-thread
  // write cursors — thread t's vids land after threads < t's within
  // every bucket, so the scatter preserves the ascending-vid tie break
  // and the output is bit-identical to the serial sort.  Gated off when
  // the T bucket tables would dwarf the O(n) work they parallelize.
  if (T > 1 && (max_deg + 2) * (int64_t)T * 8 > 16 * n) T = 1;
  if (T > 1) {
    std::vector<std::vector<int64_t>> cnt((size_t)T);
    ThreadStats* ts = &g_tstats;
    ts->used = T;
#pragma omp parallel num_threads(T)
    {
      const int t = omp_get_thread_num();
      const double t0 = mono_s();
      const int64_t a = n * t / T, b = n * (t + 1) / T;
      std::vector<int64_t>& c = cnt[(size_t)t];
      c.assign((size_t)max_deg + 2, 0);
      for (int64_t v = a; v < b; ++v)
        if (deg[v] > 0) ++c[(size_t)deg[v]];
      if (t < kMaxThreads) ts->busy[t] = mono_s() - t0;
    }
    // serial exclusive prefix over (degree, thread): cursor[t][d] =
    // (elements of degree < d anywhere) + (degree-d elements of earlier
    // threads)
    std::vector<int64_t> base((size_t)max_deg + 2, 0);
    int64_t run = 0;
    for (int64_t d = 1; d <= max_deg; ++d) {
      base[(size_t)d] = run;
      for (int tt = 0; tt < T; ++tt) run += cnt[(size_t)tt][(size_t)d];
    }
    const int64_t total = run;
    std::vector<std::vector<int64_t>> cur((size_t)T);
    for (int tt = 0; tt < T; ++tt)
      cur[(size_t)tt].assign((size_t)max_deg + 2, 0);
    for (int64_t d = 1; d <= max_deg; ++d) {
      int64_t at = base[(size_t)d];
      for (int tt = 0; tt < T; ++tt) {
        cur[(size_t)tt][(size_t)d] = at;
        at += cnt[(size_t)tt][(size_t)d];
      }
    }
#pragma omp parallel num_threads(T)
    {
      const int t = omp_get_thread_num();
      const int64_t a = n * t / T, b = n * (t + 1) / T;
      std::vector<int64_t>& c = cur[(size_t)t];
      for (int64_t v = a; v < b; ++v)
        if (deg[v] > 0) seq_out[c[(size_t)deg[v]]++] = (uint32_t)v;
    }
    return total;
  }
#endif
  std::vector<int64_t> offs((size_t)max_deg + 2, 0);
  for (int64_t v = 0; v < n; ++v)
    if (deg[v] > 0) ++offs[deg[v] + 1];
  for (int64_t d = 0; d <= max_deg; ++d) offs[d + 1] += offs[d];
  int64_t total = offs[max_deg + 1];
  for (int64_t v = 0; v < n; ++v)
    if (deg[v] > 0) seq_out[offs[deg[v]]++] = (uint32_t)v;
  return total;
}

// Parameterized jxn/treewidth insert (lib/jtree.cpp:65-231) — the C++ twin
// of core/jxn.py build_jxn_tree, returning the dense outputs the CLI needs
// (parent, pst, effective seq, widths); the python oracle keeps the full
// kids/pst/jxn tables.  Semantics replicated exactly:
//   - per-edge postorder counting with width_limit fail-fast,
//   - jxn = k-way union of kid jxns + unique postorder vids, minus X,
//     failing when it exceeds width_limit (merge.h heuristic merges; here
//     a heap-free repeated two-way merge with early abort),
//   - failed vertices defer to wide_seq; find_max_width bound checks run
//     on failed inserts too (jtree.cpp:130-136),
//   - do_rooting stops when width == remaining; deferred + remaining
//     vertices become the trivial tail chain (jtree.cpp:152-222),
//   - pst/jxn item counts charge 4 bytes each against memory_limit.
// flags bitmask: 1=make_pad 2=make_kids 4=make_pst 8=make_jxn
//                16=find_max_width 32=do_rooting
// Returns n_out (>=0), or -4 when memory_limit is exceeded.
int64_t sheep_jxn_build(const uint32_t* tail, const uint32_t* head, int64_t m,
                        const uint32_t* seq, int64_t seq_len, int64_t n_vid,
                        int64_t width_limit, int64_t memory_limit,
                        int64_t flags, uint32_t* parent_out,
                        uint32_t* pst_out, uint32_t* seq_out,
                        int64_t* widths_out) {
  const bool make_pad = flags & 1;
  const bool make_pst = flags & 4;
  const bool make_jxn = flags & 8;
  const bool find_max_width = flags & 16;
  const bool do_rooting = flags & 32;
  const uint64_t wlimit = width_limit > 0 ? (uint64_t)width_limit
                                          : ~0ull >> 2;

  // CSR (undirected doubled) via counting sort.
  std::vector<int64_t> offs((size_t)n_vid + 1, 0);
  for (int64_t i = 0; i < m; ++i) {
    if (tail[i] >= (uint64_t)n_vid || head[i] >= (uint64_t)n_vid) return -3;
    ++offs[tail[i] + 1];
    ++offs[head[i] + 1];
  }
  for (int64_t v = 0; v < n_vid; ++v) offs[v + 1] += offs[v];
  std::vector<uint32_t> dst((size_t)offs[n_vid]);
  {
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t i = 0; i < m; ++i) {
      dst[(size_t)cur[tail[i]]++] = head[i];
      dst[(size_t)cur[head[i]]++] = tail[i];
    }
  }

  std::vector<uint32_t> index((size_t)n_vid, kInvalid);
  std::vector<uint32_t> uf;
  std::vector<std::vector<uint32_t>> jxn_tbl;  // sorted; empty when !make_jxn
  // stamp keys on a per-ATTEMPT counter, not the jnid: a failed insert
  // leaves n_out unchanged, so jnid-keyed stamps would leak into the next
  // vertex's root dedup.
  std::vector<uint32_t> stamp((size_t)seq_len + 1, 0);
  uint32_t attempt = 0;
  std::vector<uint32_t> ks, pvids, jx, merged;
  std::vector<uint32_t> wide_seq;
  int64_t n_out = 0;
  int64_t mem_used = 0;
  uint64_t current_width = 0;
  int64_t stopped_at = -1;

  auto uf_find_local = [&](uint32_t x) {
    while (uf[x] != x) {
      uf[x] = uf[uf[x]];
      x = uf[x];
    }
    return x;
  };

  for (int64_t si = 0; si < seq_len; ++si) {
    const uint32_t X = seq[si];
    if (X >= (uint64_t)n_vid) return -3;
    if (!make_pad && offs[X + 1] == offs[X]) continue;
    const uint32_t current = (uint32_t)n_out;
    ++attempt;
    uint64_t pw = 0;
    bool fail = false;
    ks.clear();
    pvids.clear();
    for (int64_t j = offs[X]; j < offs[X + 1]; ++j) {
      const uint32_t nbr = dst[(size_t)j];
      const uint32_t nid = index[nbr];
      if (nid != kInvalid) {
        uint32_t r = uf_find_local(nid);
        if (stamp[r] != attempt) {  // met-root dedup (meetKid's check)
          stamp[r] = attempt;
          ks.push_back(r);
        }
      } else if (nbr != X) {
        if (++pw > wlimit) { fail = true; break; }
        pvids.push_back(nbr);
      }
    }
    if (!fail) {
      std::sort(pvids.begin(), pvids.end());
      pvids.erase(std::unique(pvids.begin(), pvids.end()), pvids.end());
      if (make_jxn) {
        // union of kid jxns + pvids, minus X, early abort past wlimit
        jx.assign(pvids.begin(), pvids.end());  // never contains X
        for (uint32_t k : ks) {
          if (jxn_tbl[k].empty()) continue;
          merged.clear();
          merged.reserve(jx.size() + jxn_tbl[k].size());
          size_t a = 0, b = 0;
          const auto& kb = jxn_tbl[k];
          while (a < jx.size() || b < kb.size()) {
            uint32_t v;
            if (b >= kb.size() || (a < jx.size() && jx[a] <= kb[b])) {
              v = jx[a++];
              if (b < kb.size() && kb[b] == v) ++b;
            } else {
              v = kb[b++];
            }
            if (v == X) continue;
            merged.push_back(v);
            if (merged.size() > wlimit) { fail = true; break; }
          }
          if (fail) break;
          jx.swap(merged);
        }
      }
    }
    if (fail) {
      // find_max_width bound check runs on failed inserts too
      if (find_max_width &&
          current_width >= wide_seq.size() + (uint64_t)(seq_len - si))
        return n_out;
      wide_seq.push_back(X);
      continue;
    }

    // Commit
    parent_out[n_out] = kInvalid;
    pst_out[n_out] = (uint32_t)pw;
    seq_out[n_out] = X;
    uf.push_back(current);
    for (uint32_t r : ks) {
      parent_out[r] = current;
      uf[r] = current;
    }
    if (make_pst) {
      mem_used += 4 * (int64_t)pvids.size();
      if (mem_used > memory_limit) return -4;
    }
    if (make_jxn) {
      mem_used += 4 * (int64_t)jx.size();
      if (mem_used > memory_limit) return -4;
      jxn_tbl.emplace_back(jx);
    } else {
      jxn_tbl.emplace_back();
    }
    const uint64_t cur_w = 1 + (make_jxn ? jx.size() : pw);
    widths_out[n_out] = (int64_t)cur_w;
    index[X] = current;
    ++n_out;

    const uint64_t remaining = wide_seq.size() + (uint64_t)(seq_len - si);
    if (find_max_width) {
      if (cur_w > current_width) current_width = cur_w;
      if (current_width >= remaining) return n_out;
    }
    if (do_rooting && cur_w == remaining) {
      stopped_at = si + 1;
      break;
    }
  }

  // Tail phase: deferred + unvisited vertices become a root chain.
  std::vector<uint32_t> rest(wide_seq);
  if (stopped_at >= 0)
    for (int64_t si = stopped_at; si < seq_len; ++si)
      rest.push_back(seq[si]);
  for (size_t ti = 0; ti < rest.size(); ++ti) {
    const uint32_t X = rest[ti];
    const uint32_t current = (uint32_t)n_out;
    parent_out[n_out] = kInvalid;
    seq_out[n_out] = X;
    uf.push_back(current);
    if (ti == 0) {
      for (uint32_t kid = 0; kid < current; ++kid)
        if (parent_out[kid] == kInvalid) {
          parent_out[kid] = current;
          uf[kid] = current;
        }
    } else {
      parent_out[current - 1] = current;
      uf[current - 1] = current;
    }
    uint64_t pw = 0;
    uint64_t upw = 0;  // unique postorder vids (pst table accounting)
    pvids.clear();
    for (int64_t j = offs[X]; j < offs[X + 1]; ++j) {
      const uint32_t nbr = dst[(size_t)j];
      if (index[nbr] == kInvalid && nbr != X) {
        ++pw;
        pvids.push_back(nbr);
      }
    }
    std::sort(pvids.begin(), pvids.end());
    pvids.erase(std::unique(pvids.begin(), pvids.end()), pvids.end());
    upw = pvids.size();
    pst_out[n_out] = (uint32_t)pw;
    if (make_pst) {
      mem_used += 4 * (int64_t)upw;
      if (mem_used > memory_limit) return -4;
    }
    const uint64_t jx_len = rest.size() - ti - 1;
    if (make_jxn) {
      mem_used += 4 * (int64_t)jx_len;
      if (mem_used > memory_limit) return -4;
      widths_out[n_out] = (int64_t)(1 + jx_len);
    } else {
      widths_out[n_out] = (int64_t)(1 + pw);
    }
    index[X] = current;
    ++n_out;
    if (ti == 0 && find_max_width) return n_out;
  }
  return n_out;
}

// Fennel greedy streaming vertex partitioner (lib/partition.cpp:282-329).
// Exact semantics of the python oracle (partition/fennel.py): vertices
// stream in ascending-vid order; score = (neighbors already in part)
// - a*((s+w)^1.5 - s^1.5); parts considered up to the first empty one;
// capacity-violating parts are skipped; fallback part 0.
//
//   tail/head [m] uint32; parts_out [n_vid] int64 (-1 = INVALID_PART)
// Returns 0, or -3 on a vid >= n_vid.
int sheep_fennel_vertex(const uint32_t* tail, const uint32_t* head, int64_t m,
                        int64_t n_vid, int64_t num_parts,
                        double balance_factor, int edge_balanced,
                        int64_t* parts_out) {
  for (int64_t i = 0; i < m; ++i)
    if (tail[i] >= (uint64_t)n_vid || head[i] >= (uint64_t)n_vid) return -3;

  // CSR of the undirected-doubled graph via counting sort.
  std::vector<int64_t> offs((size_t)n_vid + 1, 0);
  for (int64_t i = 0; i < m; ++i) {
    ++offs[tail[i] + 1];
    ++offs[head[i] + 1];
  }
  for (int64_t v = 0; v < n_vid; ++v) offs[v + 1] += offs[v];
  std::vector<uint32_t> dst((size_t)offs[n_vid]);
  {
    std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
    for (int64_t i = 0; i < m; ++i) {
      dst[(size_t)cur[tail[i]]++] = head[i];
      dst[(size_t)cur[head[i]]++] = tail[i];
    }
  }

  int64_t n_active = 0;
  for (int64_t v = 0; v < n_vid; ++v)
    if (offs[v + 1] > offs[v]) ++n_active;
  for (int64_t v = 0; v < n_vid; ++v) parts_out[v] = -1;
  if (m == 0 || n_active == 0) return 0;

  const double y = 1.5;
  const double n = (double)n_active;
  const double md = (double)(2 * m);
  const double k = (double)num_parts;
  const double a = edge_balanced ? n * std::pow(k / md, y)
                                 : md * (std::pow(k, y - 1.0) / std::pow(n, y));
  const int64_t total_weight = edge_balanced ? 2 * m : n_active;
  const double max_component =
      (double)(total_weight / num_parts) * balance_factor;

  std::vector<double> part_size((size_t)num_parts, 0.0);
  std::vector<int64_t> nbr_cnt((size_t)num_parts, 0);
  for (int64_t X = 0; X < n_vid; ++X) {
    if (offs[X + 1] == offs[X]) continue;
    const double w = edge_balanced ? (double)(offs[X + 1] - offs[X]) : 1.0;
    for (int64_t j = offs[X]; j < offs[X + 1]; ++j) {
      int64_t p = parts_out[dst[(size_t)j]];
      if (p >= 0) ++nbr_cnt[(size_t)p];
    }
    int64_t last = num_parts - 1;
    for (int64_t p = 0; p < num_parts; ++p)
      if (part_size[(size_t)p] == 0.0) { last = p; break; }
    int64_t best = -1;
    double best_score = 0.0;
    for (int64_t p = 0; p <= last; ++p) {
      if (part_size[(size_t)p] + w > max_component) continue;
      double s = part_size[(size_t)p];
      double score = (double)nbr_cnt[(size_t)p]
          - a * (std::pow(s + w, y) - std::pow(s, y));
      if (best < 0 || score > best_score) { best = p; best_score = score; }
    }
    if (best < 0) best = 0;  // reference fallback: max_part = 0
    parts_out[X] = best;
    part_size[(size_t)best] += w;
    for (int64_t j = offs[X]; j < offs[X + 1]; ++j) {
      int64_t p = parts_out[dst[(size_t)j]];
      if (p >= 0) --nbr_cnt[(size_t)p];  // cheap reset (only touched slots)
    }
    nbr_cnt[(size_t)best] = 0;  // X itself may appear via self-loops
  }
  return 0;
}

// Fennel streaming edge partitioner (lib/partition.cpp:331-407 prototype,
// slips corrected as in partition/fennel.py).  touches is a per-vertex
// bitset of ceil(k/64) words.  eparts_out [m] int64.
int sheep_fennel_edges(const uint32_t* tail, const uint32_t* head, int64_t m,
                       int64_t n_vid, int64_t num_parts,
                       double balance_factor, int64_t* eparts_out) {
  for (int64_t i = 0; i < m; ++i)
    if (tail[i] >= (uint64_t)n_vid || head[i] >= (uint64_t)n_vid) return -3;
  if (m == 0) return 0;

  std::vector<uint8_t> seen((size_t)n_vid, 0);
  int64_t n_active = 0;
  for (int64_t i = 0; i < m; ++i) {
    if (!seen[tail[i]]) { seen[tail[i]] = 1; ++n_active; }
    if (!seen[head[i]]) { seen[head[i]] = 1; ++n_active; }
  }
  if (n_active == 0) n_active = 1;

  const double y = 1.5;
  const double n = (double)n_active;
  const double md = (double)(2 * m);
  const double k = (double)num_parts;
  const double a = md * (std::pow(k, y - 1.0) / std::pow(n, y));
  const double max_component = (double)(m / num_parts) * balance_factor;

  const int64_t words = (num_parts + 63) / 64;
  std::vector<uint64_t> touch((size_t)(n_vid * words), 0);
  std::vector<double> part_size((size_t)num_parts, 0.0);

  for (int64_t i = 0; i < m; ++i) {
    const uint64_t* tX = &touch[(size_t)(tail[i] * words)];
    const uint64_t* tY = &touch[(size_t)(head[i] * words)];
    int64_t last = num_parts - 1;
    for (int64_t p = 0; p < num_parts; ++p)
      if (part_size[(size_t)p] == 0.0) { last = p; break; }
    int64_t best = -1;
    double best_score = 0.0;
    for (int64_t p = 0; p <= last; ++p) {
      if (part_size[(size_t)p] + 1.0 > max_component) continue;
      double s = part_size[(size_t)p];
      double value = (double)((tX[p / 64] >> (p % 64)) & 1)
                   + (double)((tY[p / 64] >> (p % 64)) & 1);
      double score = value - a * (std::pow(s + 1.0, y) - std::pow(s, y));
      if (best < 0 || score > best_score) { best = p; best_score = score; }
    }
    if (best < 0) best = 0;
    eparts_out[i] = best;
    part_size[(size_t)best] += 1.0;
    touch[(size_t)(tail[i] * words) + best / 64] |= 1ull << (best % 64);
    touch[(size_t)(head[i] * words) + best / 64] |= 1ull << (best % 64);
  }
  return 0;
}

// One edge block of the streamed O(n)-memory partition evaluator
// (partition/evaluate.py evaluate_partition_streamed; reference metric
// definitions at lib/partition.cpp:428-521).  Updates the caller's
// window bitmaps / load counters in place; bit-identical to the python
// block body.  ``pos`` may be null (sequence-free overload: m_down/m_up
// untouched).  Returns the edges_cut increment (first window only,
// else 0), or -1 on an out-of-range vid — the wrapper raises.
int64_t sheep_eval_block(const uint32_t* tail, const uint32_t* head,
                         int64_t e, const int64_t* parts, int64_t n,
                         const uint32_t* pos, int64_t pos_len,
                         int64_t w0, int32_t first_window,
                         uint64_t* m_vcom, uint64_t* m_hash,
                         uint64_t* m_down, uint64_t* m_up,
                         uint8_t* deg_mask, int64_t* hash_loads,
                         int64_t* down_loads, int64_t* up_loads,
                         int64_t num_parts) {
  constexpr uint32_t kMult = 2654435769u;  // floor(0.5*(sqrt(5)-1)*2^32)
  const int64_t w_hi = w0 + 64;
  int64_t edges_cut = 0;
  for (int64_t i = 0; i < e; ++i) {
    const uint32_t t = tail[i], h = head[i];
    if (t >= (uint64_t)n || h >= (uint64_t)n) return -1;
    if (pos && (t >= (uint64_t)pos_len || h >= (uint64_t)pos_len)) return -1;
    const int64_t pt = parts[t], ph = parts[h];
    if (first_window) {
      deg_mask[t] = 1;
      deg_mask[h] = 1;
      edges_cut += pt != ph;
    }
    const uint32_t ht = t * kMult, hh = h * kMult;
    const uint32_t post = pos ? pos[t] : 0, posh = pos ? pos[h] : 0;
    for (int dir = 0; dir < 2; ++dir) {
      const uint32_t X = dir ? h : t;
      const int64_t pX = dir ? ph : pt, pY = dir ? pt : ph;
      const uint32_t hX = dir ? hh : ht, hY = dir ? ht : hh;
      const uint32_t sX = dir ? posh : post, sY = dir ? post : posh;
      if (pY >= w0 && pY < w_hi) m_vcom[X] |= 1ull << (pY - w0);
      const int64_t p_hash = hX < hY ? pX : pY;
      if (p_hash >= w0 && p_hash < w_hi) m_hash[X] |= 1ull << (p_hash - w0);
      if (pos) {
        const int64_t p_down = sX < sY ? pX : pY;
        if (p_down >= w0 && p_down < w_hi) m_down[X] |= 1ull << (p_down - w0);
        const int64_t p_up = sX > sY ? pX : pY;
        if (p_up >= w0 && p_up < w_hi) m_up[X] |= 1ull << (p_up - w0);
      }
    }
    if (first_window) {
      // the caller contract requires parts to cover every streamed vid;
      // an INVALID_PART (-1) here would be heap corruption, and the
      // python body's np.bincount raises on it — error out the same way
      if (t != h) {
        const uint32_t a = t < h ? t : h, b = t < h ? h : t;
        const uint32_t ha = a * kMult, hb = b * kMult;
        const int64_t p = ha < hb ? parts[a] : parts[b];
        if (p < 0 || p >= num_parts) return -1;
        ++hash_loads[p];
      }
      if (pos) {
        if (pt < 0 || pt >= num_parts || ph < 0 || ph >= num_parts)
          return -1;
        if (post < posh) ++down_loads[pt]; else if (post > posh) ++up_loads[pt];
        if (posh < post) ++down_loads[ph]; else if (posh > post) ++up_loads[ph];
      }
    }
  }
  return edges_cut;
}

// ---------------------------------------------------------------------------
// Threading introspection: the Python bindings and the
// governor ask the library — not the environment — what the kernels
// will actually do, so a build compiled without OpenMP reports
// threads=1 honestly no matter what SHEEP_NATIVE_THREADS says.
// ---------------------------------------------------------------------------

// 1 when the library was compiled with OpenMP (the Makefile probes the
// toolchain and drops -fopenmp when absent — kernels then run serial).
int sheep_native_omp(void) {
#ifdef _OPENMP
  return 1;
#else
  return 0;
#endif
}

// The serve store's incremental insert over a batch of links, in order
// (serve/state.py insert_link, statement for statement): each link
// lo -> hi climbs lo to its representative under threshold-hi
// connectivity through the ancestor memo ``skip`` (jumping only through
// entries < hi, compressing the visited path into the memo), attaches,
// and cascades the displaced link upward.  The parent array and the memo
// end exactly as the python loop leaves them.  Returns the number of
// parent pointers rewritten, or -3 when an index is past the end.
int64_t sheep_insert_links(uint32_t* parent, uint32_t* skip, int64_t n,
                           const uint32_t* lo_in, const uint32_t* hi_in,
                           int64_t k) {
  std::vector<uint32_t> path;
  int64_t rewrites = 0;
  for (int64_t i = 0; i < k; ++i) {
    uint32_t lo = lo_in[i], hi = hi_in[i];
    while (true) {
      if ((int64_t)lo >= n) return -3;
      uint32_t r = lo;
      path.clear();
      bool done = false;
      while (true) {
        const uint32_t s = skip[r];
        if (s != kInvalid && s < hi) {
          if ((int64_t)s >= n) return -3;
          r = s;
          continue;
        }
        const uint32_t p = parent[r];
        if (p == kInvalid || p > hi) break;
        if (p == hi) {
          if (r != lo) skip[lo] = r;
          done = true;  // lo's component already hangs off hi
          break;
        }
        if ((int64_t)p >= n) return -3;
        path.push_back(r);
        r = p;
      }
      if (done) break;
      for (const uint32_t x : path) skip[x] = r;  // r is their ancestor
      if (r != lo) skip[lo] = r;
      if (r == hi) break;
      const uint32_t p = parent[r];  // kInvalid or > hi: the displaced link
      parent[r] = hi;
      ++rewrites;
      if (p == kInvalid) break;
      lo = r;
      hi = p;
    }
  }
  return rewrites;
}

// Per-node subtree size and pst total of an elimination forest (the
// serve store's subtree queries): size_out[k] = 1 and wsum_io[k] = pst[k]
// on entry to the pass (wsum_io arrives holding pst), then, in index
// order, each node adds its totals into its parent's.  A forest's parents
// come later than their children, so one pass in index order completes
// every total; the loop is the store's python pass, statement for
// statement.  Returns 0, or -3 when a parent is past the end (nothing is
// defined then).
int sheep_subtree_aggregates(const uint32_t* parent, int64_t n,
                             int64_t* size_out, int64_t* wsum_io) {
  for (int64_t k = 0; k < n; ++k) size_out[k] = 1;
  for (int64_t k = 0; k < n; ++k) {
    const uint32_t p = parent[k];
    if (p == kInvalid) continue;
    if ((int64_t)p >= n) return -3;
    size_out[p] += size_out[k];
    wsum_io[p] += wsum_io[k];
  }
  return 0;
}

// The resolved SHEEP_NATIVE_THREADS (1 without OpenMP; clamped to
// [1, 64]) — what an UNGATED kernel call would use.
int sheep_native_threads(void) { return resolve_threads(); }

// Threads a kernel call over m records/links will actually use (the
// resolved count after the engagement floor and per-slice-work gates).
int sheep_threads_for(int64_t m) { return threads_for_work(m); }

// omp_get_max_threads() of the loaded runtime (1 without OpenMP) — the
// env_capture field bench records embed.
int sheep_omp_max_threads(void) {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Per-thread busy seconds of this caller thread's LAST kernel call
// (filled by the threaded arms, reset to {1, 0.0} at every kernel
// entry).  Returns the thread count used; writes min(used, cap) busy
// values.  The bindings annotate native.* spans with these.
int sheep_last_thread_stats(double* busy_out, int cap) {
  const int u = g_tstats.used;
  for (int i = 0; i < u && i < cap; ++i) busy_out[i] = g_tstats.busy[i];
  return u;
}

}  // extern "C"
