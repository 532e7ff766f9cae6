// Native batch DogStatsD parser + metric-key intern table.
//
// The hot ingest path of the framework: newline-joined packet buffers are
// parsed here in one call (GIL released by ctypes), emitting per-family
// COO sample arrays that the device column store applies as large batches.
// This is the TPU build's equivalent of the reference's compiled-Go hot
// path (reference samplers/parser.go:349-503 ParseMetric + server.go:1004
// ingestMetric keying), built as a host C++ kernel per SURVEY.md §2's
// native-components note.
//
// Parity contract: any line this parser cannot handle bit-exactly the way
// the Python reference parser (veneur_tpu/samplers/parser.py) would —
// events, service checks, unknown keys, malformed values, non-ASCII set
// members — is routed back to Python via the `unknown` list, so observable
// behavior (aggregated state, error counts, error messages) is identical.
//
// Intern model: the table maps the raw "meta key" bytes of a line (name
// chunk + everything from the type pipe onward, i.e. the line minus its
// value chunk) to a (family, row, sample_rate) entry. Rows are assigned by
// the Python column store when it first sees a key via the slow path and
// registered here; after that the line never touches Python again.

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_set>

#include <locale.h>
#include <math.h>
#include <stdlib.h>

#include <errno.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <time.h>

#include <vector>

namespace {

enum Family : int32_t {
  FAM_COUNTER = 0,
  FAM_GAUGE = 1,
  FAM_HISTO = 2,
  FAM_SET = 3,
  FAM_LLHIST = 4,  // "l" wire type: Circllhist log-linear bins
};

struct Entry {
  int32_t family;
  int32_t row;
  float rate;  // sample rate (1.0 if unset); weight for histos is 1/rate
};

// What a caller's lookups cost: added up in locals and handed to the
// engine's totals once a call, never a line.
struct Lookups {
  int64_t lookups = 0;
  int64_t misses = 0;
  int64_t probes = 0;  // slots read, the home slot included
};

// One slot of the intern table: the key's full hash (0 marks an empty
// slot), where its bytes sit in the arena, and what it maps to. Two slots
// share a 64-byte cache line.
struct Slot {
  uint64_t hash;
  uint64_t off;
  uint32_t len;
  Entry ent;
};
static_assert(sizeof(Slot) == 32);

// The intern table: open addressing with linear probing over a
// power-of-two array of slots, the keys' bytes appended to one arena. A
// hit reads the home slot (prefetchable from the hash alone) and the
// key's bytes in the arena; a node-based map reads a bucket, a node and
// a heap string, each on the address the one before held. The load stays
// at most 1/2: the table doubles before an insert would pass it. There is
// no erase: `erase_rows` rebuilds the slots and compacts the arena in one
// sweep, so no tombstone ever lengthens a probe.
class InternTable {
 public:
  static uint64_t hash(std::string_view key) {
    uint64_t h = std::hash<std::string_view>{}(key);
    return h != 0 ? h : 1;
  }

  void prefetch(uint64_t h) const {
    __builtin_prefetch(&slots_[h & (slots_.size() - 1)]);
  }

  const Entry* find(uint64_t h, std::string_view key, Lookups* n) const {
    const size_t mask = slots_.size() - 1;
    n->lookups++;
    for (size_t i = h & mask;; i = (i + 1) & mask) {
      const Slot& s = slots_[i];
      n->probes++;
      if (s.hash == 0) {
        n->misses++;
        return nullptr;
      }
      if (s.hash == h && s.len == key.size() &&
          memcmp(arena_.data() + s.off, key.data(), key.size()) == 0) {
        return &s.ent;
      }
    }
  }

  void insert_or_assign(std::string_view key, Entry ent) {
    const uint64_t h = hash(key);
    const size_t mask = slots_.size() - 1;
    for (size_t i = h & mask; slots_[i].hash != 0; i = (i + 1) & mask) {
      Slot& s = slots_[i];
      if (s.hash == h && s.len == key.size() &&
          memcmp(arena_.data() + s.off, key.data(), key.size()) == 0) {
        s.ent = ent;
        return;
      }
    }
    if (2 * (size_ + 1) > slots_.size()) {
      std::vector<Slot> bigger(2 * slots_.size());
      for (const Slot& s : slots_) {
        if (s.hash != 0) place(bigger, s);
      }
      slots_.swap(bigger);
    }
    place(slots_, Slot{h, arena_.size(), static_cast<uint32_t>(key.size()),
                       ent});
    arena_.insert(arena_.end(), key.begin(), key.end());
    size_++;
  }

  // Drops every key whose (family, row) is in `dead`.
  void erase_rows(const std::unordered_set<int64_t>& dead) {
    std::vector<Slot> kept(slots_.size());
    std::vector<char> arena;
    arena.reserve(arena_.size());
    size_ = 0;
    for (const Slot& s : slots_) {
      if (s.hash == 0 ||
          dead.count((static_cast<int64_t>(s.ent.family) << 32) |
                     static_cast<uint32_t>(s.ent.row))) {
        continue;
      }
      place(kept, Slot{s.hash, arena.size(), s.len, s.ent});
      arena.insert(arena.end(), arena_.begin() + s.off,
                   arena_.begin() + s.off + s.len);
      size_++;
    }
    slots_.swap(kept);
    arena_.swap(arena);
  }

  size_t size() const { return size_; }
  size_t capacity() const { return slots_.size(); }
  size_t arena_bytes() const { return arena_.size(); }

 private:
  static constexpr size_t kInitialSlots = 1024;

  static void place(std::vector<Slot>& slots, const Slot& s) {
    const size_t mask = slots.size() - 1;
    size_t i = s.hash & mask;
    while (slots[i].hash != 0) i = (i + 1) & mask;
    slots[i] = s;
  }

  std::vector<Slot> slots_ = std::vector<Slot>(kInitialSlots);
  std::vector<char> arena_;
  size_t size_ = 0;
};

struct Engine {
  InternTable table;
  mutable std::shared_mutex mu;
  locale_t c_locale;
  // every caller's lookups, added once a call
  std::atomic<int64_t> lookups{0}, misses{0}, probes{0};

  Engine() : c_locale(newlocale(LC_ALL_MASK, "C", nullptr)) {}
  ~Engine() {
    if (c_locale) freelocale(c_locale);
  }

  void count(const Lookups& n) {
    lookups.fetch_add(n.lookups, std::memory_order_relaxed);
    misses.fetch_add(n.misses, std::memory_order_relaxed);
    probes.fetch_add(n.probes, std::memory_order_relaxed);
  }
};

// ---- hashing (parity with veneur_tpu/ops/hll_ref.py) ----------------------

constexpr uint64_t kFnv64Offset = 0xCBF29CE484222325ULL;
constexpr uint64_t kFnv64Prime = 0x100000001B3ULL;
constexpr int kHllP = 14;

inline uint64_t fnv1a64(const uint8_t* data, size_t n) {
  uint64_t h = kFnv64Offset;
  for (size_t i = 0; i < n; i++) {
    h ^= data[i];
    h *= kFnv64Prime;
  }
  return h;
}

inline uint64_t hash_member(const uint8_t* data, size_t n) {
  uint64_t h = fnv1a64(data, n);
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

inline void pos_val(uint64_t h, int32_t* idx, int32_t* rho) {
  *idx = static_cast<int32_t>(h >> (64 - kHllP));
  uint64_t w = (h << kHllP) | (1ULL << (kHllP - 1));
  *rho = __builtin_clzll(w) + 1;
}

// ---- llhist binning (parity with veneur_tpu/ops/llhist_ref.py) ------------

constexpr int kLLExpMin = -9;
constexpr int kLLExpMax = 15;
constexpr int kLLMant = 90;
constexpr int kLLNExp = kLLExpMax - kLLExpMin + 1;  // 25
constexpr int kLLNegOffset = kLLMant * kLLNExp;     // 2250
constexpr double kLLMinMag = 1e-9;   // 10^EXP_MIN
constexpr double kLLMaxMag = 1e16;   // 10^(EXP_MAX+1)

// decimal literals are correctly rounded by the compiler, bit-identical
// to numpy's 10.0**e for this range — the same doubles llhist_ref's
// correction step compares against. Indexed by e - (kLLExpMin - 1).
constexpr double kLLPow10[] = {
    1e-10, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1,
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,
    1e10, 1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17};

inline double ll_p10(int e) { return kLLPow10[e - (kLLExpMin - 1)]; }

// value -> dense bin id, the exact algorithm of llhist_ref.bin_index on
// float64 (parity pinned by tests/test_ingest_batch.py's fuzz corpus):
// 0 = zero bin, positive bins ordered (exponent, mantissa), negatives
// offset by MANT*NEXP. The float-log correction forces
// 10^e <= |v| < 10^(e+1) so a 1-ulp log10 difference can never move a
// value across a bin edge.
inline int32_t llhist_bin_index(double v) {
  double a = fabs(v);
  if (!(a >= kLLMinMag)) return 0;  // zero, tiny magnitudes, NaN
  int e;
  int mant;
  if (a >= kLLMaxMag) {  // includes +/-inf
    e = kLLExpMax;
    mant = 99;
  } else {
    e = static_cast<int>(floor(log10(a)));
    if (a < ll_p10(e)) {
      e -= 1;
    } else if (a >= ll_p10(e + 1)) {
      e += 1;
    }
    if (e < kLLExpMin) e = kLLExpMin;
    if (e > kLLExpMax) e = kLLExpMax;
    double m = floor(a / ll_p10(e - 1));
    mant = m < 10 ? 10 : (m > 99 ? 99 : static_cast<int>(m));
  }
  int32_t idx = 1 + (e - kLLExpMin) * kLLMant + (mant - 10);
  return v < 0 ? idx + kLLNegOffset : idx;
}

inline bool llhist_clamped(double v) {
  double a = fabs(v);
  return (a > 0 && a < kLLMinMag) || a >= kLLMaxMag;
}

// ---- strict float parsing -------------------------------------------------

// Validates the exact decimal-float grammar the Python path accepts
// (float() minus underscores/whitespace/inf/nan, parser.py _strict_float):
//   [+-]? ( D+ (\. D*)? | \. D+ ) ( [eE] [+-]? D+ )?
// Everything else returns false and the line falls back to Python.
inline bool valid_float_grammar(const uint8_t* s, size_t n) {
  size_t i = 0;
  if (n == 0) return false;
  if (s[i] == '+' || s[i] == '-') i++;
  size_t int_digits = 0;
  while (i < n && s[i] >= '0' && s[i] <= '9') {
    i++;
    int_digits++;
  }
  size_t frac_digits = 0;
  if (i < n && s[i] == '.') {
    i++;
    while (i < n && s[i] >= '0' && s[i] <= '9') {
      i++;
      frac_digits++;
    }
  }
  if (int_digits == 0 && frac_digits == 0) return false;
  if (i < n && (s[i] == 'e' || s[i] == 'E')) {
    i++;
    if (i < n && (s[i] == '+' || s[i] == '-')) i++;
    size_t exp_digits = 0;
    while (i < n && s[i] >= '0' && s[i] <= '9') {
      i++;
      exp_digits++;
    }
    if (exp_digits == 0) return false;
  }
  return i == n;
}

inline bool parse_float_slow(const Engine* e, const uint8_t* s, size_t n,
                             double* out) {
  // exponents, long digit strings, and everything the strict grammar
  // must reject
  if (n >= 64 || !valid_float_grammar(s, n)) return false;
  char buf[64];
  memcpy(buf, s, n);
  buf[n] = 0;
  char* end = nullptr;
  double v = strtod_l(buf, &end, e->c_locale);
  if (end != buf + n) return false;
  // overflow to inf is a ParseError in the Python path; underflow to 0 is not
  if (!isfinite(v)) return false;
  *out = v;
  return true;
}

inline bool parse_float(const Engine* e, const uint8_t* s, size_t n,
                        double* out) {
  // Fast path for the overwhelmingly common shape [+-]?D+(.D*)? / .D+
  // with <= 15 significant digits: mantissa/10^frac is exactly
  // representable on both sides of the division, so the result is
  // correctly rounded — bit-identical to strtod (and Python float()).
  // strtod costs ~80ns per value and timers carry 8 values per line,
  // so this is the ingest parse thread's hottest instruction stream.
  static const double kP10[16] = {
      1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11,
      1e12, 1e13, 1e14, 1e15};
  size_t i = 0;
  bool neg = false;
  // > 17 bytes cannot fit the <=15-digit fast shape (sign + dot + 15):
  // constant-time route to the slow path instead of scanning a
  // pathological all-digits max-size token twice
  if (n > 17) return parse_float_slow(e, s, n, out);
  if (n && (s[0] == '+' || s[0] == '-')) {
    neg = s[0] == '-';
    i = 1;
  }
  uint64_t mant = 0;
  int digits = 0;
  int frac = 0;
  while (i < n && s[i] >= '0' && s[i] <= '9') {
    mant = mant * 10 + (s[i] - '0');
    digits++;
    i++;
  }
  if (i < n && s[i] == '.') {
    i++;
    while (i < n && s[i] >= '0' && s[i] <= '9') {
      mant = mant * 10 + (s[i] - '0');
      digits++;
      frac++;
      i++;
    }
  }
  if (i == n && digits > 0 && digits <= 15) {
    double v = static_cast<double>(mant) / kP10[frac];
    *out = neg ? -v : v;
    return true;
  }
  return parse_float_slow(e, s, n, out);
}

struct Out {
  int32_t* c_rows;
  float* c_vals;
  float* c_rates;
  int64_t c_cap, c_n = 0;
  int32_t* g_rows;
  float* g_vals;
  int32_t* g_lines;  // line index per gauge sample: last-write-wins needs
                     // buffer order to survive the slow-path replay merge
  int64_t g_cap, g_n = 0;
  int32_t* h_rows;
  float* h_vals;
  float* h_wts;
  int64_t h_cap, h_n = 0;
  int32_t* s_rows;
  int32_t* s_idx;
  int32_t* s_rho;
  int64_t s_cap, s_n = 0;
  int32_t* l_rows = nullptr;  // llhist: pre-binned register adds
  int32_t* l_bins = nullptr;
  int32_t* l_wts = nullptr;
  int64_t l_cap = 0, l_n = 0;
  int64_t l_clamped = 0;  // weight that fell outside the bin window
  int64_t* unk_off;
  int64_t* unk_len;
  int32_t* unk_line;
  int64_t unk_cap, unk_n = 0;
  int64_t samples = 0;
  int32_t line_no = 0;
};

inline bool push_unknown(Out* o, int64_t off, int64_t len) {
  if (o->unk_n >= o->unk_cap) return false;
  o->unk_off[o->unk_n] = off;
  o->unk_len[o->unk_n] = len;
  o->unk_line[o->unk_n] = o->line_no;
  o->unk_n++;
  return true;
}

// Finds a non-empty line's value colon and type pipe; false for a line
// that goes to the Python slow path whatever the table holds.
inline bool split_line(const uint8_t* line, size_t len, size_t* value_start,
                       size_t* type_start) {
  // events and service checks dispatch on these exact prefixes
  // (reference server.go:949-1000); other '_' names are ordinary metrics
  if (len >= 3 && line[0] == '_' &&
      ((line[1] == 'e' && line[2] == '{') ||
       (line[1] == 's' && line[2] == 'c'))) {
    return false;
  }

  const uint8_t* pipe =
      static_cast<const uint8_t*>(memchr(line, '|', len));
  if (pipe == nullptr) return false;
  *type_start = pipe - line;
  const uint8_t* colon =
      static_cast<const uint8_t*>(memchr(line, ':', *type_start));
  if (colon == nullptr) return false;
  *value_start = colon - line;
  return true;
}

// Appends a split line's meta key to `keys`: the line minus its value
// chunk.
inline void append_key(std::string& keys, const uint8_t* line, size_t len,
                       size_t value_start, size_t type_start) {
  keys.append(reinterpret_cast<const char*>(line), value_start);
  keys.append(reinterpret_cast<const char*>(line + type_start),
              len - type_start);
}

// Emits the samples of a split line whose key resolved to `ent`; returns
// false, with everything the line emitted rolled back, when the line
// must go to the Python slow path.
inline bool emit_line(const Engine* e, const Entry& ent, const uint8_t* line,
                      size_t value_start, size_t type_start, Out* o) {
  // one sample per colon-separated value; a trailing empty segment is
  // ignored, an empty segment elsewhere is an error (Python path parity)
  const uint8_t* vc = line + value_start + 1;
  size_t vlen = type_start - value_start - 1;
  int64_t n_emitted[5] = {o->c_n, o->g_n, o->h_n, o->s_n, o->l_n};
  int64_t samples_before = o->samples;
  int64_t clamped_before = o->l_clamped;
  while (vlen > 0) {
    const uint8_t* next =
        static_cast<const uint8_t*>(memchr(vc, ':', vlen));
    size_t seg_len = (next == nullptr) ? vlen : (size_t)(next - vc);
    const uint8_t* seg = vc;
    if (next == nullptr) {
      vlen = 0;
    } else {
      vlen -= seg_len + 1;
      vc = next + 1;
    }

    bool ok = false;
    switch (ent.family) {
      case FAM_SET: {
        // non-ASCII members go to Python: its parser round-trips them
        // through UTF-8 decode with replacement, changing the hashed bytes
        bool ascii = true;
        for (size_t i = 0; i < seg_len; i++) {
          if (seg[i] >= 0x80) {
            ascii = false;
            break;
          }
        }
        if (!ascii || o->s_n >= o->s_cap) break;
        int32_t idx, rho;
        pos_val(hash_member(seg, seg_len), &idx, &rho);
        o->s_rows[o->s_n] = ent.row;
        o->s_idx[o->s_n] = idx;
        o->s_rho[o->s_n] = rho;
        o->s_n++;
        ok = true;
        break;
      }
      case FAM_COUNTER: {
        double v;
        if (o->c_n >= o->c_cap || !parse_float(e, seg, seg_len, &v)) break;
        o->c_rows[o->c_n] = ent.row;
        o->c_vals[o->c_n] = static_cast<float>(v);
        o->c_rates[o->c_n] = ent.rate;
        o->c_n++;
        ok = true;
        break;
      }
      case FAM_GAUGE: {
        double v;
        if (o->g_n >= o->g_cap || !parse_float(e, seg, seg_len, &v)) break;
        o->g_rows[o->g_n] = ent.row;
        o->g_vals[o->g_n] = static_cast<float>(v);
        o->g_lines[o->g_n] = o->line_no;
        o->g_n++;
        ok = true;
        break;
      }
      case FAM_HISTO: {
        double v;
        if (o->h_n >= o->h_cap || !parse_float(e, seg, seg_len, &v)) break;
        o->h_rows[o->h_n] = ent.row;
        o->h_vals[o->h_n] = static_cast<float>(v);
        o->h_wts[o->h_n] = 1.0f / ent.rate;
        o->h_n++;
        ok = true;
        break;
      }
      case FAM_LLHIST: {
        double v;
        if (o->l_n >= o->l_cap || !parse_float(e, seg, seg_len, &v)) break;
        // bin on the full-precision double (scalar-path parity: the
        // Python path bins float64 too, so no f32 round-trip may move
        // a value across a bin edge); weight = round(1/max(rate,1e-9))
        // half-to-even like Python round() / np.rint, with the scalar
        // path's 1e-9 rate floor, saturating into int32 as a guard
        // against the UB cast
        double r = static_cast<double>(ent.rate);
        double w = nearbyint(1.0 / (r > 1e-9 ? r : 1e-9));
        if (w < 1.0) w = 1.0;
        if (w > 2147483647.0) w = 2147483647.0;
        int32_t wt = static_cast<int32_t>(w);
        o->l_rows[o->l_n] = ent.row;
        o->l_bins[o->l_n] = llhist_bin_index(v);
        o->l_wts[o->l_n] = wt;
        o->l_n++;
        if (llhist_clamped(v)) o->l_clamped += wt;
        ok = true;
        break;
      }
      default:
        break;
    }
    if (!ok) {
      // a malformed segment fails the whole line in the Python parser;
      // roll back everything this line emitted and defer to Python
      o->c_n = n_emitted[0];
      o->g_n = n_emitted[1];
      o->h_n = n_emitted[2];
      o->s_n = n_emitted[3];
      o->l_n = n_emitted[4];
      o->samples = samples_before;
      o->l_clamped = clamped_before;
      return false;
    }
    o->samples++;
  }
  return true;
}

// Parses one non-empty line; returns false only if it must go to the
// Python slow path.
inline bool parse_line(const Engine* e, const uint8_t* line, size_t len,
                       std::string& keybuf, Out* o, Lookups* n) {
  size_t value_start, type_start;
  if (!split_line(line, len, &value_start, &type_start)) return false;
  keybuf.clear();
  append_key(keybuf, line, len, value_start, type_start);
  const Entry* ent = e->table.find(InternTable::hash(keybuf), keybuf, n);
  return ent != nullptr &&
         emit_line(e, *ent, line, value_start, type_start, o);
}

// vnt_parse resolves lines in windows of this many. The first pass over a
// window splits each line, assembles and hashes its key and prefetches
// its home slot; the second parses the lines in order, and finds the
// slots in cache or on their way.
constexpr int kWindow = 16;

struct WindowLine {
  int64_t pos, len;
  size_t value_start, type_start;
  size_t key_off, key_len;  // in the window's key buffer
  uint64_t hash;
  bool split;
};

// the lookups of this thread's last vnt_parse call (vnt_parse_lookups)
thread_local Lookups t_last_parse;

}  // namespace

extern "C" {

void* vnt_new() { return new Engine(); }

void vnt_free(void* e) { delete static_cast<Engine*>(e); }

int64_t vnt_size(void* ep) {
  Engine* e = static_cast<Engine*>(ep);
  std::shared_lock lock(e->mu);
  return static_cast<int64_t>(e->table.size());
}

// out[0..5]: keys, slots, arena bytes, and every caller's lookups,
// misses and probe steps since the engine was made.
void vnt_stats(void* ep, int64_t* out) {
  Engine* e = static_cast<Engine*>(ep);
  std::shared_lock lock(e->mu);
  out[0] = static_cast<int64_t>(e->table.size());
  out[1] = static_cast<int64_t>(e->table.capacity());
  out[2] = static_cast<int64_t>(e->table.arena_bytes());
  out[3] = e->lookups.load(std::memory_order_relaxed);
  out[4] = e->misses.load(std::memory_order_relaxed);
  out[5] = e->probes.load(std::memory_order_relaxed);
}

void vnt_register(void* ep, const uint8_t* key, int64_t keylen,
                  int32_t family, int32_t row, double rate) {
  Engine* e = static_cast<Engine*>(ep);
  Entry ent{family, row, static_cast<float>(rate)};
  std::unique_lock lock(e->mu);
  e->table.insert_or_assign(
      std::string_view(reinterpret_cast<const char*>(key), keylen), ent);
}

// Erases every intern mapping pointing at one of `rows` in `family` —
// the native half of idle-row reclamation (the Python column store
// tombstones the rows; this guarantees no NEW native samples can
// reference them before the row ids are recycled an interval later).
// One O(table) sweep amortizes over the whole evicted batch.
// Erases every (family, row) mapping named in the parallel arrays in
// ONE O(table) sweep under the unique lock. The server collects every
// family's evicted rows per flush and pays the reader-blocking lock
// once (a per-family sweep would block the pump readers up to four
// times per flush).
void vnt_unregister_rows2(void* ep, const int32_t* families,
                          const int32_t* rows, int64_t n) {
  Engine* e = static_cast<Engine*>(ep);
  std::unordered_set<int64_t> dead;
  dead.reserve(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; i++) {
    dead.insert((static_cast<int64_t>(families[i]) << 32) |
                static_cast<uint32_t>(rows[i]));
  }
  std::unique_lock lock(e->mu);
  e->table.erase_rows(dead);
}

// Parses a newline-joined buffer of packets. Returns the number of
// non-empty lines seen (the packets_received delta). Per-family sample
// arrays are filled up to their capacities; lines the native path cannot
// take are returned as (offset, length) pairs for the Python slow path.
int64_t vnt_parse(void* ep, const uint8_t* buf, int64_t buflen,
                  int32_t* c_rows, float* c_vals, float* c_rates,
                  int64_t c_cap, int64_t* c_n,
                  int32_t* g_rows, float* g_vals, int32_t* g_lines,
                  int64_t g_cap, int64_t* g_n,
                  int32_t* h_rows, float* h_vals, float* h_wts,
                  int64_t h_cap, int64_t* h_n,
                  int32_t* s_rows, int32_t* s_idx, int32_t* s_rho,
                  int64_t s_cap, int64_t* s_n,
                  int32_t* l_rows, int32_t* l_bins, int32_t* l_wts,
                  int64_t l_cap, int64_t* l_n, int64_t* l_clamped,
                  int64_t* unk_off, int64_t* unk_len, int32_t* unk_lines,
                  int64_t unk_cap, int64_t* unk_n, int64_t* samples_out) {
  Engine* e = static_cast<Engine*>(ep);
  Out o;
  o.c_rows = c_rows; o.c_vals = c_vals; o.c_rates = c_rates; o.c_cap = c_cap;
  o.g_rows = g_rows; o.g_vals = g_vals; o.g_lines = g_lines; o.g_cap = g_cap;
  o.h_rows = h_rows; o.h_vals = h_vals; o.h_wts = h_wts; o.h_cap = h_cap;
  o.s_rows = s_rows; o.s_idx = s_idx; o.s_rho = s_rho; o.s_cap = s_cap;
  o.l_rows = l_rows; o.l_bins = l_bins; o.l_wts = l_wts; o.l_cap = l_cap;
  o.unk_off = unk_off; o.unk_len = unk_len; o.unk_line = unk_lines;
  o.unk_cap = unk_cap;

  int64_t lines = 0;
  Lookups n;
  thread_local std::string keys;
  WindowLine win[kWindow];
  std::shared_lock lock(e->mu);
  const InternTable& table = e->table;
  int64_t pos = 0;
  while (pos < buflen) {
    int nwin = 0;
    keys.clear();
    while (nwin < kWindow && pos < buflen) {
      const uint8_t* nl = static_cast<const uint8_t*>(
          memchr(buf + pos, '\n', buflen - pos));
      int64_t line_len = (nl == nullptr) ? (buflen - pos)
                                         : (nl - (buf + pos));
      if (line_len > 0) {
        WindowLine& w = win[nwin++];
        w.pos = pos;
        w.len = line_len;
        w.split = split_line(buf + pos, line_len, &w.value_start,
                             &w.type_start);
        if (w.split) {
          w.key_off = keys.size();
          append_key(keys, buf + pos, line_len, w.value_start,
                     w.type_start);
          w.key_len = keys.size() - w.key_off;
          w.hash = InternTable::hash(
              std::string_view(keys.data() + w.key_off, w.key_len));
          table.prefetch(w.hash);
        }
      }
      pos += line_len + 1;
    }
    for (int i = 0; i < nwin; i++) {
      const WindowLine& w = win[i];
      o.line_no = static_cast<int32_t>(lines);
      lines++;
      const Entry* ent =
          w.split ? table.find(w.hash,
                               std::string_view(keys.data() + w.key_off,
                                                w.key_len),
                               &n)
                  : nullptr;
      if (ent == nullptr || !emit_line(e, *ent, buf + w.pos, w.value_start,
                                       w.type_start, &o)) {
        push_unknown(&o, w.pos, w.len);
      }
    }
  }
  lock.unlock();
  e->count(n);
  t_last_parse = n;
  *c_n = o.c_n;
  *g_n = o.g_n;
  *h_n = o.h_n;
  *s_n = o.s_n;
  *l_n = o.l_n;
  *l_clamped = o.l_clamped;
  *unk_n = o.unk_n;
  *samples_out = o.samples;
  return lines;
}

// out[0..2]: the lookups, misses and probe steps of the calling thread's
// last vnt_parse.
void vnt_parse_lookups(int64_t* out) {
  out[0] = t_last_parse.lookups;
  out[1] = t_last_parse.misses;
  out[2] = t_last_parse.probes;
}

// ---- batched UDP reader (recvmmsg) ----------------------------------------
//
// The kernel-facing half of the native ingest loop (the SO_REUSEPORT
// multi-reader equivalent of reference networking.go:54-107 +
// server.go:1103-1140): poll the socket, drain up to max_msgs queued
// datagrams in one recvmmsg syscall, and compact them into one
// newline-joined buffer ready for vnt_parse. Oversized datagrams are
// dropped and counted (metric_max_length parity with
// Server.handle_packet_buffer).

namespace {

struct Reader {
  int32_t max_msgs;
  int64_t max_dgram;
  std::vector<uint8_t> scratch;  // max_msgs contiguous datagram slots
  std::vector<uint8_t> joined;   // compacted newline-joined output
  std::vector<mmsghdr> hdrs;
  std::vector<iovec> iovs;

  Reader(int32_t msgs, int64_t dgram)
      : max_msgs(msgs),
        max_dgram(dgram),
        scratch(static_cast<size_t>(msgs) * dgram),
        joined(static_cast<size_t>(msgs) * (dgram + 1)),
        hdrs(msgs),
        iovs(msgs) {
    for (int32_t i = 0; i < msgs; i++) {
      iovs[i].iov_base = scratch.data() + static_cast<size_t>(i) * dgram;
      iovs[i].iov_len = dgram;
      memset(&hdrs[i], 0, sizeof(mmsghdr));
      hdrs[i].msg_hdr.msg_iov = &iovs[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
    }
  }
};

}  // namespace

void* vnt_reader_new(int32_t max_msgs, int64_t max_dgram) {
  return new Reader(max_msgs, max_dgram);
}

void vnt_reader_free(void* r) { delete static_cast<Reader*>(r); }

const uint8_t* vnt_reader_buf(void* r) {
  return static_cast<Reader*>(r)->joined.data();
}

// Waits up to timeout_ms for readability, then drains queued datagrams.
// Returns the joined buffer length (0 = timeout/nothing), or -1 on a
// fatal socket error (caller should exit its read loop).
int64_t vnt_reader_read(void* rp, int32_t fd, int64_t max_len,
                        int32_t timeout_ms, int32_t* n_dgrams,
                        int32_t* n_dropped) {
  Reader* r = static_cast<Reader*>(rp);
  *n_dgrams = 0;
  *n_dropped = 0;

  struct pollfd pfd = {fd, POLLIN, 0};
  int pr = poll(&pfd, 1, timeout_ms);
  if (pr < 0) return (errno == EINTR) ? 0 : -1;
  if (pr == 0) return 0;
  if (pfd.revents & (POLLERR | POLLNVAL)) return -1;

  int got = recvmmsg(fd, r->hdrs.data(), r->max_msgs, MSG_DONTWAIT, nullptr);
  if (got < 0) {
    if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) return 0;
    return -1;
  }

  uint8_t* out = r->joined.data();
  int64_t pos = 0;
  for (int i = 0; i < got; i++) {
    int64_t len = r->hdrs[i].msg_len;
    if (len <= 0) continue;
    if (len > max_len) {
      (*n_dropped)++;
      continue;
    }
    memcpy(out + pos, r->scratch.data() + static_cast<size_t>(i) * r->max_dgram,
           len);
    pos += len;
    out[pos++] = '\n';
    (*n_dgrams)++;
  }
  if (pos > 0) pos--;  // trailing separator
  return pos;
}

// Boundary-preserving variant for binary protocols (SSF): same drain as
// vnt_reader_read, but also reports each datagram's (offset, length)
// within the joined buffer — binary frames may contain '\n', so the
// separator convention of the DogStatsD path cannot delimit them.
int64_t vnt_reader_read2(void* rp, int32_t fd, int64_t max_len,
                         int32_t timeout_ms, int64_t* msg_off,
                         int64_t* msg_len, int32_t* n_dgrams,
                         int32_t* n_dropped) {
  Reader* r = static_cast<Reader*>(rp);
  *n_dgrams = 0;
  *n_dropped = 0;

  struct pollfd pfd = {fd, POLLIN, 0};
  int pr = poll(&pfd, 1, timeout_ms);
  if (pr < 0) return (errno == EINTR) ? 0 : -1;
  if (pr == 0) return 0;
  if (pfd.revents & (POLLERR | POLLNVAL)) return -1;

  int got = recvmmsg(fd, r->hdrs.data(), r->max_msgs, MSG_DONTWAIT, nullptr);
  if (got < 0) {
    if (errno == EAGAIN || errno == EWOULDBLOCK || errno == EINTR) return 0;
    return -1;
  }

  uint8_t* out = r->joined.data();
  int64_t pos = 0;
  for (int i = 0; i < got; i++) {
    int64_t len = r->hdrs[i].msg_len;
    if (len <= 0) continue;
    if (len > max_len) {
      (*n_dropped)++;
      continue;
    }
    memcpy(out + pos, r->scratch.data() + static_cast<size_t>(i) * r->max_dgram,
           len);
    msg_off[*n_dgrams] = pos;
    msg_len[*n_dgrams] = len;
    pos += len;
    (*n_dgrams)++;
  }
  return pos;
}

}  // extern "C"

// ---- C++-resident ingest pump ---------------------------------------------
//
// The round-4 hot loop: per-socket reader threads run the whole
// poll -> recvmmsg -> parse -> accumulate cycle in native code, free of the
// GIL, filling large per-chunk COO sample buffers. Python is woken only
// when a sealed chunk (tens of thousands of samples, i.e. hundreds of
// joined datagram buffers) is ready to dispatch to the device column
// store. This replaces the per-buffer Python round trip of the previous
// design (reference analog: the compiled-Go read loop of
// server.go:1103-1140, which likewise never leaves native code between
// the socket and the sampler).

namespace {

inline int64_t now_ms() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<int64_t>(ts.tv_sec) * 1000 + ts.tv_nsec / 1000000;
}

struct Chunk {
  int64_t cap;        // per-family sample capacity
  int64_t unk_cap;    // max deferred lines
  int64_t arena_cap;  // deferred-line byte arena
  std::vector<int32_t> c_rows;
  std::vector<float> c_vals, c_rates;
  std::vector<int32_t> g_rows;
  std::vector<float> g_vals;
  std::vector<int32_t> g_lines;
  std::vector<int32_t> h_rows;
  std::vector<float> h_vals, h_wts;
  std::vector<int32_t> s_rows, s_idx, s_rho;
  std::vector<int32_t> l_rows, l_bins, l_wts;
  std::vector<uint8_t> arena;
  std::vector<int64_t> unk_off, unk_len;
  std::vector<int32_t> unk_line;
  Out o;
  int64_t arena_n = 0;
  int64_t lines = 0;
  int64_t dgrams = 0;
  int64_t dropped = 0;
  int64_t first_ms = 0;  // when the first sample landed (seal aging)
  int32_t lane = 0;      // owning reader: release returns it there
  int64_t seal_ms = 0;   // when sealed (ring dwell attribution)

  explicit Chunk(int64_t sample_cap, int64_t max_line)
      : cap(sample_cap),
        unk_cap(sample_cap),
        arena_cap(sample_cap < 4 * max_line ? 4 * max_line : sample_cap),
        c_rows(cap), c_vals(cap), c_rates(cap),
        g_rows(cap), g_vals(cap), g_lines(cap),
        h_rows(cap), h_vals(cap), h_wts(cap),
        s_rows(cap), s_idx(cap), s_rho(cap),
        l_rows(cap), l_bins(cap), l_wts(cap),
        arena(arena_cap),
        unk_off(unk_cap), unk_len(unk_cap), unk_line(unk_cap) {
    reset();
  }

  void reset() {
    o = Out();
    o.c_rows = c_rows.data(); o.c_vals = c_vals.data();
    o.c_rates = c_rates.data(); o.c_cap = cap;
    o.g_rows = g_rows.data(); o.g_vals = g_vals.data();
    o.g_lines = g_lines.data(); o.g_cap = cap;
    o.h_rows = h_rows.data(); o.h_vals = h_vals.data();
    o.h_wts = h_wts.data(); o.h_cap = cap;
    o.s_rows = s_rows.data(); o.s_idx = s_idx.data();
    o.s_rho = s_rho.data(); o.s_cap = cap;
    o.l_rows = l_rows.data(); o.l_bins = l_bins.data();
    o.l_wts = l_wts.data(); o.l_cap = cap;
    o.unk_off = unk_off.data(); o.unk_len = unk_len.data();
    o.unk_line = unk_line.data(); o.unk_cap = unk_cap;
    arena_n = 0;
    lines = 0;
    dgrams = 0;
    dropped = 0;
    first_ms = 0;
    seal_ms = 0;
  }

  bool empty() const {
    return lines == 0 && dropped == 0 && dgrams == 0;
  }
};

struct ChunkDesc {
  int32_t* c_rows; float* c_vals; float* c_rates; int64_t c_n;
  int32_t* g_rows; float* g_vals; int32_t* g_lines; int64_t g_n;
  int32_t* h_rows; float* h_vals; float* h_wts; int64_t h_n;
  int32_t* s_rows; int32_t* s_idx; int32_t* s_rho; int64_t s_n;
  int32_t* l_rows; int32_t* l_bins; int32_t* l_wts; int64_t l_n;
  int64_t l_clamped;
  uint8_t* arena; int64_t* unk_off; int64_t* unk_len; int32_t* unk_line;
  int64_t unk_n;
  int64_t lines; int64_t samples; int64_t dgrams; int64_t dropped;
  int64_t reader;    // lane index (which reader sealed this chunk)
  int64_t dwell_ms;  // seal -> dispatch latency (ring dwell)
};

// Bounded lock-free single-producer/single-consumer ring of chunk
// pointers. Each reader lane runs two of these: `ready` (reader
// produces, dispatcher consumes) and `free_q` (dispatcher produces,
// reader consumes) — so the steady-state hand-off between a socket
// reader and the dispatcher is two atomic stores per CHUNK (tens of
// thousands of samples), with no lock on the data path. The pump
// mutex below exists only to park/wake sleeping threads; it never
// guards ring state.
struct SpscRing {
  std::vector<Chunk*> slots;
  uint64_t mask;
  std::atomic<uint64_t> head{0};  // consumer position
  std::atomic<uint64_t> tail{0};  // producer position

  explicit SpscRing(uint64_t cap_pow2)
      : slots(cap_pow2), mask(cap_pow2 - 1) {}

  bool push(Chunk* c) {  // single producer only
    uint64_t t = tail.load(std::memory_order_relaxed);
    if (t - head.load(std::memory_order_acquire) > mask) return false;
    slots[t & mask] = c;
    tail.store(t + 1, std::memory_order_release);
    return true;
  }

  Chunk* pop() {  // single consumer only
    uint64_t h = head.load(std::memory_order_relaxed);
    if (h == tail.load(std::memory_order_acquire)) return nullptr;
    Chunk* c = slots[h & mask];
    head.store(h + 1, std::memory_order_release);
    return c;
  }

  int64_t depth() const {
    return static_cast<int64_t>(tail.load(std::memory_order_relaxed) -
                                head.load(std::memory_order_relaxed));
  }
};

inline uint64_t next_pow2(uint64_t v) {
  uint64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

// One socket reader's lane: its fd, its private chunk set, and the two
// SPSC rings connecting it to the dispatcher. A full free ring BLOCKS
// the reader (backpressure into the kernel buffer — never a silent
// in-process drop); every such wait is a counted stall.
struct ReaderLane {
  int fd;
  SpscRing ready;   // reader -> dispatcher (sealed chunks)
  SpscRing free_q;  // dispatcher -> reader (recycled chunks)
  std::atomic<int64_t> sealed{0};  // chunks sealed (ring throughput)
  std::atomic<int64_t> stalls{0};  // reader waits for a free chunk

  ReaderLane(int fd_, uint64_t ring_cap)
      : fd(fd_), ready(ring_cap), free_q(ring_cap) {}
};

struct Pump {
  Engine* engine;
  int32_t max_msgs;
  int64_t max_dgram;
  int64_t max_len;
  int64_t chunk_cap;
  int32_t ring_slots = 0;  // chunks per lane (the ring's real capacity)
  int32_t seal_age_ms;
  int32_t poll_ms;

  // mu/cv park sleeping threads only (see SpscRing): sealers and
  // releasers take mu for the notify so a checked-then-waiting peer
  // can never miss its wakeup, but ring pushes/pops happen outside it
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::vector<ReaderLane*> lanes;
  size_t next_lane = 0;  // dispatcher round-robin cursor
  std::vector<Chunk*> all;
  std::vector<std::thread> threads;
  std::mutex stop_mu;  // vnt_pump_stop is callable from several threads
  std::atomic<bool> stop{false};
  std::atomic<int32_t> live{0};        // reader threads still running
  std::atomic<int64_t> stalls{0};      // total reader waits for a chunk
  std::atomic<int64_t> lost_lines{0};  // lines discarded at shutdown

  ~Pump() {
    for (Chunk* c : all) delete c;
    for (ReaderLane* l : lanes) delete l;
  }
};

// Seals a full/aged chunk onto the reader's ready ring and wakes the
// dispatcher. The push cannot fail: each ring is sized to hold every
// chunk its lane owns.
inline void pump_seal(Pump* p, ReaderLane* lane, Chunk* c) {
  c->seal_ms = now_ms();
  lane->ready.push(c);
  lane->sealed.fetch_add(1, std::memory_order_relaxed);
  std::lock_guard<std::mutex> lock(p->mu);
  p->cv_ready.notify_one();
}

// Blocks until the lane has a recycled chunk (dispatcher backpressure:
// while a reader waits here it is not draining its socket, so the
// kernel buffer absorbs or drops — standard UDP semantics, with the
// loss visible in ingest.kernel_drops). During stop the dispatcher
// keeps draining, so freed chunks still arrive; only after a bounded
// wait (dispatcher dead?) does this give up and return nullptr.
inline Chunk* pump_take_free(Pump* p, ReaderLane* lane) {
  Chunk* c = lane->free_q.pop();
  if (c != nullptr) return c;
  lane->stalls.fetch_add(1, std::memory_order_relaxed);
  p->stalls.fetch_add(1, std::memory_order_relaxed);
  for (int waited_ms = 0;;) {
    std::unique_lock<std::mutex> lock(p->mu);
    c = lane->free_q.pop();  // re-check under mu: release notifies under it
    if (c != nullptr) return c;
    if (p->stop && waited_ms >= 5000) return nullptr;
    p->cv_free.wait_for(lock, std::chrono::milliseconds(100));
    lock.unlock();
    c = lane->free_q.pop();
    if (c != nullptr) return c;
    waited_ms = p->stop ? waited_ms + 100 : 0;
  }
}

// Parses one joined buffer into the reader's current chunk, sealing and
// swapping chunks mid-buffer whenever capacity could run out. Returns the
// (possibly new) current chunk, or nullptr on stop.
inline Chunk* pump_parse(Pump* p, ReaderLane* lane, Chunk* cur,
                         const uint8_t* buf, int64_t buflen,
                         std::string& keybuf, int64_t now) {
  Lookups n;
  std::shared_lock lock(p->engine->mu);
  int64_t pos = 0;
  while (pos < buflen) {
    const uint8_t* nl = static_cast<const uint8_t*>(
        memchr(buf + pos, '\n', buflen - pos));
    int64_t line_len = (nl == nullptr) ? (buflen - pos) : (nl - (buf + pos));
    if (line_len > 0) {
      // worst case this line emits line_len/2+1 samples into one family
      int64_t need = line_len / 2 + 1;
      int64_t fill = cur->o.c_n;
      if (cur->o.g_n > fill) fill = cur->o.g_n;
      if (cur->o.h_n > fill) fill = cur->o.h_n;
      if (cur->o.s_n > fill) fill = cur->o.s_n;
      if (cur->o.l_n > fill) fill = cur->o.l_n;
      if (fill + need > cur->cap || cur->o.unk_n + 1 > cur->unk_cap ||
          cur->arena_n + line_len > cur->arena_cap) {
        lock.unlock();
        pump_seal(p, lane, cur);
        cur = pump_take_free(p, lane);
        if (cur == nullptr) {
          // shutdown with a dead dispatcher: account for what this
          // buffer still held so the loss is at least visible
          int64_t lost = 0;
          for (int64_t q = pos; q < buflen;) {
            const uint8_t* qnl = static_cast<const uint8_t*>(
                memchr(buf + q, '\n', buflen - q));
            int64_t ll = (qnl == nullptr) ? (buflen - q) : (qnl - (buf + q));
            if (ll > 0) lost++;
            q += ll + 1;
          }
          p->lost_lines.fetch_add(lost);
          p->engine->count(n);
          return nullptr;
        }
        cur->first_ms = now;
        lock.lock();
      }
      cur->o.line_no = static_cast<int32_t>(cur->lines);
      cur->lines++;
      if (!parse_line(p->engine, buf + pos, line_len, keybuf, &cur->o,
                      &n)) {
        // deferred lines outlive the joined buffer: copy into the arena
        memcpy(cur->arena.data() + cur->arena_n, buf + pos, line_len);
        push_unknown(&cur->o, cur->arena_n, line_len);
        cur->arena_n += line_len;
      }
    }
    pos += line_len + 1;
  }
  lock.unlock();
  p->engine->count(n);
  return cur;
}

void pump_reader(Pump* p, ReaderLane* lane) {
  struct Live {
    Pump* p;
    ~Live() { p->live.fetch_sub(1); }
  } live{p};
  Reader r(p->max_msgs, p->max_dgram);
  std::string keybuf;
  Chunk* cur = pump_take_free(p, lane);
  if (cur == nullptr) return;
  while (!p->stop.load(std::memory_order_relaxed)) {
    int32_t nd = 0, ndrop = 0;
    int64_t len = vnt_reader_read(&r, lane->fd, p->max_len, p->poll_ms,
                                  &nd, &ndrop);
    int64_t now = now_ms();
    if (len < 0) break;
    if (ndrop || len > 0) {
      if (cur->empty()) cur->first_ms = now;
      cur->dropped += ndrop;
    }
    if (len > 0) {
      cur->dgrams += nd;
      cur = pump_parse(p, lane, cur, r.joined.data(), len, keybuf, now);
      if (cur == nullptr) return;
    }
    // aging: never sit on samples longer than seal_age_ms, whether the
    // socket is quiet (poll timeout) or steadily trickling
    if (!cur->empty() && now - cur->first_ms >= p->seal_age_ms) {
      pump_seal(p, lane, cur);
      cur = pump_take_free(p, lane);
      if (cur == nullptr) return;
    }
  }
  if (!cur->empty()) {
    pump_seal(p, lane, cur);  // drain on shutdown
  }
  // An empty final chunk is deliberately NOT returned to free_q: the
  // dispatcher may be releasing chunks onto this lane's free ring
  // concurrently during wind-down, and free_q's producer side belongs
  // to it alone (SPSC). The chunk stays owned by Pump::all and is
  // freed with the pump; readers never take from this lane again.
}

}  // namespace

extern "C" {

// ring_slots is PER READER: each lane owns ring_slots chunks cycling
// through its private free/ready SPSC rings, so readers never contend
// with each other for buffer space and the hand-off to the dispatcher
// is lock-free.
void* vnt_pump_new(void* ep, const int32_t* fds, int32_t nfds,
                   int32_t max_msgs, int64_t max_dgram, int64_t max_len,
                   int64_t chunk_cap, int32_t ring_slots,
                   int32_t seal_age_ms, int32_t poll_ms) {
  Pump* p = new Pump();
  p->engine = static_cast<Engine*>(ep);
  p->max_msgs = max_msgs;
  p->max_dgram = max_dgram;
  p->max_len = max_len;
  p->chunk_cap = chunk_cap;
  p->seal_age_ms = seal_age_ms;
  p->poll_ms = poll_ms;
  // one chunk fills while the dispatcher holds one: 3 is the floor at
  // which the reader never self-deadlocks waiting for its own seal
  if (ring_slots < 3) ring_slots = 3;
  p->ring_slots = ring_slots;
  uint64_t ring_cap = next_pow2(static_cast<uint64_t>(ring_slots));
  for (int32_t i = 0; i < nfds; i++) {
    ReaderLane* lane = new ReaderLane(fds[i], ring_cap);
    for (int32_t k = 0; k < ring_slots; k++) {
      Chunk* c = new Chunk(chunk_cap, max_dgram);
      c->lane = i;
      p->all.push_back(c);
      lane->free_q.push(c);
    }
    p->lanes.push_back(lane);
  }
  for (ReaderLane* lane : p->lanes) {
    p->live.fetch_add(1);
    p->threads.emplace_back(pump_reader, p, lane);
  }
  return p;
}

int32_t vnt_pump_nreaders(void* pp) {
  return static_cast<int32_t>(static_cast<Pump*>(pp)->lanes.size());
}

// Per-lane ring telemetry: ready-ring depth, capacity (chunks the lane
// owns — the real bound, not the pow2 slot array), chunks sealed, and
// reader free-chunk stalls. Arrays must hold vnt_pump_nreaders entries.
void vnt_pump_ring_stats(void* pp, int64_t* depth, int64_t* cap,
                         int64_t* sealed, int64_t* stalls) {
  Pump* p = static_cast<Pump*>(pp);
  for (size_t i = 0; i < p->lanes.size(); i++) {
    ReaderLane* lane = p->lanes[i];
    depth[i] = lane->ready.depth();
    cap[i] = p->ring_slots;
    sealed[i] = lane->sealed.load(std::memory_order_relaxed);
    stalls[i] = lane->stalls.load(std::memory_order_relaxed);
  }
}

// Sets the stop flag without joining, so the caller (the dispatcher) can
// keep draining sealed chunks while the readers wind down and seal their
// partial chunks.
void vnt_pump_signal_stop(void* pp) {
  Pump* p = static_cast<Pump*>(pp);
  p->stop = true;
  p->cv_free.notify_all();
}

int32_t vnt_pump_live(void* pp) {
  return static_cast<Pump*>(pp)->live.load();
}

int64_t vnt_pump_lost_lines(void* pp) {
  return static_cast<Pump*>(pp)->lost_lines.load();
}

// Waits up to timeout_ms for a sealed chunk from any lane (round-robin
// across lanes so one hot reader can't starve the others); fills *out
// and returns the chunk handle (release it with vnt_pump_release), or
// nullptr on timeout.
void* vnt_pump_next(void* pp, int32_t timeout_ms, ChunkDesc* out) {
  Pump* p = static_cast<Pump*>(pp);
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  Chunk* c = nullptr;
  size_t nl = p->lanes.size();
  for (;;) {
    for (size_t k = 0; k < nl && c == nullptr; k++) {
      size_t i = (p->next_lane + k) % nl;
      c = p->lanes[i]->ready.pop();
      if (c != nullptr) p->next_lane = (i + 1) % nl;
    }
    if (c != nullptr) break;
    std::unique_lock<std::mutex> lock(p->mu);
    // re-check under mu: a sealer pushes BEFORE it takes mu to notify,
    // so any push that won the race is visible here and the wait below
    // can never sleep through it
    bool any = false;
    for (ReaderLane* lane : p->lanes) {
      if (lane->ready.depth() > 0) {
        any = true;
        break;
      }
    }
    if (any) continue;
    if (p->cv_ready.wait_until(lock, deadline) ==
            std::cv_status::timeout &&
        std::chrono::steady_clock::now() >= deadline) {
      return nullptr;
    }
  }
  out->c_rows = c->c_rows.data(); out->c_vals = c->c_vals.data();
  out->c_rates = c->c_rates.data(); out->c_n = c->o.c_n;
  out->g_rows = c->g_rows.data(); out->g_vals = c->g_vals.data();
  out->g_lines = c->g_lines.data(); out->g_n = c->o.g_n;
  out->h_rows = c->h_rows.data(); out->h_vals = c->h_vals.data();
  out->h_wts = c->h_wts.data(); out->h_n = c->o.h_n;
  out->s_rows = c->s_rows.data(); out->s_idx = c->s_idx.data();
  out->s_rho = c->s_rho.data(); out->s_n = c->o.s_n;
  out->l_rows = c->l_rows.data(); out->l_bins = c->l_bins.data();
  out->l_wts = c->l_wts.data(); out->l_n = c->o.l_n;
  out->l_clamped = c->o.l_clamped;
  out->arena = c->arena.data();
  out->unk_off = c->unk_off.data(); out->unk_len = c->unk_len.data();
  out->unk_line = c->unk_line.data(); out->unk_n = c->o.unk_n;
  out->lines = c->lines;
  out->samples = c->o.samples;
  out->dgrams = c->dgrams;
  out->dropped = c->dropped;
  out->reader = c->lane;
  int64_t dwell = now_ms() - c->seal_ms;
  out->dwell_ms = dwell > 0 ? dwell : 0;
  return c;
}

void vnt_pump_release(void* pp, void* cp) {
  Pump* p = static_cast<Pump*>(pp);
  Chunk* c = static_cast<Chunk*>(cp);
  int32_t lane = c->lane;
  c->reset();
  p->lanes[lane]->free_q.push(c);
  std::lock_guard<std::mutex> lock(p->mu);
  p->cv_free.notify_all();  // any lane's reader may be parked
}

int64_t vnt_pump_stalls(void* pp) {
  return static_cast<Pump*>(pp)->stalls.load();
}

// Stops the reader threads and wakes the dispatcher. Idempotent and safe
// to call from several threads (the listener's close and the dispatcher's
// shutdown both call it). Sealed chunks still queued can be drained with
// vnt_pump_next afterwards.
void vnt_pump_stop(void* pp) {
  Pump* p = static_cast<Pump*>(pp);
  p->stop = true;
  p->cv_free.notify_all();
  {
    std::lock_guard<std::mutex> lock(p->stop_mu);
    for (auto& t : p->threads) {
      if (t.joinable()) t.join();
    }
    p->threads.clear();
  }
  p->cv_ready.notify_all();
}

void vnt_pump_free(void* pp) {
  Pump* p = static_cast<Pump*>(pp);
  vnt_pump_stop(p);
  delete p;
}

// ---- native SSF span decode + metric extraction ---------------------------
//
// The span-pipeline hot path (SURVEY §2 native-components item 6;
// reference protocol/wire.go:108-186 + sinks/ssfmetrics/metrics.go:89-146):
// SSFSpan packets are decoded with a hand-rolled protobuf-wire reader and
// their embedded SSFSamples extracted straight into COO columns via the
// SAME intern table the DogStatsD path uses — the canonical meta-key for
// an SSF sample is rendered in DogStatsD line-key form
// ("name|c|@rate|#k:v,..." with tag keys sorted, plus a "|$N" suffix for
// an enum-forced scope), so a key's row identity is shared across both
// ingest planes. Anything the native path cannot take bit-exactly
// (uninterned keys, STATUS samples, non-ASCII set members, indicator
// spans when SLI timers are configured, malformed packets) defers to the
// Python slow path at per-sample granularity.

namespace {

struct PB {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  float fixed32f() {
    if (end - p < 4) {
      ok = false;
      return 0.0f;
    }
    float f;
    memcpy(&f, p, 4);
    p += 4;
    return f;
  }

  std::string_view bytes() {
    uint64_t n = varint();
    if (!ok || n > static_cast<uint64_t>(end - p)) {
      ok = false;
      return {};
    }
    std::string_view sv(reinterpret_cast<const char*>(p),
                        static_cast<size_t>(n));
    p += n;
    return sv;
  }

  void skip(uint32_t wire) {
    switch (wire) {
      case 0: varint(); break;
      case 1: p = (end - p >= 8) ? p + 8 : (ok = false, end); break;
      case 2: bytes(); break;
      case 5: p = (end - p >= 4) ? p + 4 : (ok = false, end); break;
      default: ok = false; break;
    }
  }
};

struct TagKV {
  std::string_view k, v;
  bool operator<(const TagKV& o) const { return k < o.k; }
};

// map<string,string> entry: {1: key, 2: value}
inline bool parse_map_entry(std::string_view entry, TagKV* out) {
  PB b{reinterpret_cast<const uint8_t*>(entry.data()),
       reinterpret_cast<const uint8_t*>(entry.data()) + entry.size()};
  while (b.ok && b.p < b.end) {
    uint64_t tag = b.varint();
    if (!b.ok) break;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if (field == 1 && wire == 2) {
      out->k = b.bytes();
    } else if (field == 2 && wire == 2) {
      out->v = b.bytes();
    } else {
      b.skip(wire);
    }
  }
  return b.ok;
}

struct SsfSampleView {
  int64_t metric = 0;       // enum: 0 c, 1 g, 2 h, 3 s, 4 status
  std::string_view name;
  float value = 0.0f;
  std::string_view message;  // SET member
  float sample_rate = 0.0f;
  int64_t scope = 0;         // 0 default, 1 local, 2 global
  std::vector<TagKV> tags;
  bool ok = true;
};

inline bool parse_ssf_sample(std::string_view raw, SsfSampleView* s) {
  PB b{reinterpret_cast<const uint8_t*>(raw.data()),
       reinterpret_cast<const uint8_t*>(raw.data()) + raw.size()};
  while (b.ok && b.p < b.end) {
    uint64_t tag = b.varint();
    if (!b.ok) break;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    switch (field) {
      case 1: if (wire == 0) s->metric = static_cast<int64_t>(b.varint());
              else b.skip(wire); break;
      case 2: if (wire == 2) s->name = b.bytes(); else b.skip(wire); break;
      case 3: if (wire == 5) s->value = b.fixed32f();
              else b.skip(wire); break;
      case 5: if (wire == 2) s->message = b.bytes();
              else b.skip(wire); break;
      case 7: if (wire == 5) s->sample_rate = b.fixed32f();
              else b.skip(wire); break;
      case 8: if (wire == 2) {
                TagKV kv;
                if (!parse_map_entry(b.bytes(), &kv)) return false;
                s->tags.push_back(kv);
              } else b.skip(wire);
              break;
      case 10: if (wire == 0) s->scope = static_cast<int64_t>(b.varint());
               else b.skip(wire); break;
      default: b.skip(wire); break;
    }
  }
  return b.ok;
}

struct SsfSpanView {
  int64_t trace_id = 0, id = 0, start = 0, end_ts = 0;
  bool error = false, indicator = false;
  std::string_view service, name;
  std::vector<std::string_view> samples;  // raw SSFSample submessages
  bool ok = true;
};

inline bool parse_ssf_span(const uint8_t* data, int64_t len,
                           SsfSpanView* sp) {
  PB b{data, data + len};
  // tags["name"] fills an empty span name (parse_ssf normalization,
  // wire.go ParseSSF); local so no cross-packet reset is needed
  std::string_view name_tag;
  while (b.ok && b.p < b.end) {
    uint64_t tag = b.varint();
    if (!b.ok) break;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    switch (field) {
      case 2: if (wire == 0) sp->trace_id = static_cast<int64_t>(b.varint());
              else b.skip(wire); break;
      case 3: if (wire == 0) sp->id = static_cast<int64_t>(b.varint());
              else b.skip(wire); break;
      case 5: if (wire == 0) sp->start = static_cast<int64_t>(b.varint());
              else b.skip(wire); break;
      case 6: if (wire == 0) sp->end_ts = static_cast<int64_t>(b.varint());
              else b.skip(wire); break;
      case 7: if (wire == 0) sp->error = b.varint() != 0;
              else b.skip(wire); break;
      case 8: if (wire == 2) sp->service = b.bytes();
              else b.skip(wire); break;
      case 10: if (wire == 2) sp->samples.push_back(b.bytes());
               else b.skip(wire); break;
      case 11: if (wire == 2) {
                 TagKV kv;
                 if (!parse_map_entry(b.bytes(), &kv)) return false;
                 if (kv.k == "name") name_tag = kv.v;
               } else b.skip(wire);
               break;
      case 12: if (wire == 0) sp->indicator = b.varint() != 0;
               else b.skip(wire); break;
      case 13: if (wire == 2) sp->name = b.bytes(); else b.skip(wire); break;
      default: b.skip(wire); break;
    }
  }
  if (b.ok && sp->name.empty() && !name_tag.empty()) {
    sp->name = name_tag;  // ParseSSF normalization parity
  }
  return b.ok;
}

const char kFamilyChar[4] = {'c', 'g', 'h', 's'};

// Canonical meta-key for an SSF sample, byte-identical to the Python
// helper (veneur_tpu/core/ingest.py ssf_meta_key): DogStatsD line-key
// form with sorted tag keys, so identical identities unify with
// DogStatsD-interned rows.
inline void ssf_key(std::string& out, std::string_view name, char tc,
                    float rate, std::vector<TagKV>& tags, int64_t scope) {
  out.clear();
  out.append(name.data(), name.size());
  out.push_back('|');
  out.push_back(tc);
  float r = (rate == 0.0f) ? 1.0f : rate;
  if (r != 1.0f) {
    char buf[40];
    snprintf(buf, sizeof(buf), "|@%g", static_cast<double>(r));
    out.append(buf);
  }
  if (!tags.empty()) {
    std::sort(tags.begin(), tags.end());
    out.append("|#");
    for (size_t i = 0; i < tags.size(); i++) {
      if (i) out.push_back(',');
      out.append(tags[i].k.data(), tags[i].k.size());
      out.push_back(':');
      out.append(tags[i].v.data(), tags[i].v.size());
    }
  }
  if (scope == 1 || scope == 2) {
    out.push_back('|');
    out.push_back('$');
    out.push_back(scope == 1 ? '1' : '2');
  }
}

inline bool all_ascii(std::string_view sv) {
  for (char c : sv) {
    if (static_cast<uint8_t>(c) >= 0x80) return false;
  }
  return true;
}

inline uint64_t xorshift64(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  *s = x;
  return x;
}

// pkt_flags bits
constexpr int32_t SSF_DECODED = 1;
constexpr int32_t SSF_BAD = 2;
constexpr int32_t SSF_NEEDS_UNIQ = 4;
constexpr int32_t SSF_NEEDS_INDICATOR = 8;

}  // namespace

extern "C" {

// Decodes n_pkts SSFSpan packets (buf + offs/lens) and extracts their
// samples into COO columns through the shared intern table. Samples the
// native path cannot take are returned as (pkt, off, len, line) tuples
// relative to buf; per-packet flags report decode status and which
// derived-metric replays Python owes. Returns the number of packets
// decoded successfully.
int64_t vnt_ssf_parse(void* ep, const uint8_t* buf, const int64_t* offs,
                      const int64_t* lens, int64_t n_pkts,
                      int32_t* c_rows, float* c_vals, float* c_rates,
                      int64_t cap, int64_t* c_n,
                      int32_t* g_rows, float* g_vals, int32_t* g_lines,
                      int64_t* g_n,
                      int32_t* h_rows, float* h_vals, float* h_wts,
                      int64_t* h_n,
                      int32_t* s_rows, int32_t* s_idx, int32_t* s_rho,
                      int64_t* s_n,
                      int32_t* def_pkt, int64_t* def_off, int64_t* def_len,
                      int32_t* def_line, int64_t def_cap, int64_t* def_n,
                      int32_t* pkt_flags,
                      int32_t indicator_enabled, double uniq_rate,
                      uint64_t rng_seed, int64_t* samples_out) {
  Engine* e = static_cast<Engine*>(ep);
  Out o;
  o.c_rows = c_rows; o.c_vals = c_vals; o.c_rates = c_rates; o.c_cap = cap;
  o.g_rows = g_rows; o.g_vals = g_vals; o.g_lines = g_lines; o.g_cap = cap;
  o.h_rows = h_rows; o.h_vals = h_vals; o.h_wts = h_wts; o.h_cap = cap;
  o.s_rows = s_rows; o.s_idx = s_idx; o.s_rho = s_rho; o.s_cap = cap;
  int64_t dn = 0;
  int64_t decoded = 0;
  int32_t line = 0;  // global sample index: keeps gauge LWW replayable
  uint64_t rng = rng_seed | 1;
  Lookups n;
  thread_local std::string keybuf;
  thread_local SsfSpanView sp;
  thread_local SsfSampleView sv;

  auto defer = [&](int32_t pkt, const uint8_t* p, int64_t len,
                   int32_t ln) {
    if (dn < def_cap) {
      def_pkt[dn] = pkt;
      def_off[dn] = p - buf;
      def_len[dn] = len;
      def_line[dn] = ln;
      dn++;
    }
  };

  std::shared_lock lock(e->mu);
  for (int64_t i = 0; i < n_pkts; i++) {
    sp.trace_id = sp.id = sp.start = sp.end_ts = 0;
    sp.error = sp.indicator = false;
    sp.service = {};
    sp.name = {};
    sp.samples.clear();  // reset by hand to reuse the vector's capacity
    if (!parse_ssf_span(buf + offs[i], lens[i], &sp)) {
      pkt_flags[i] = SSF_BAD;
      continue;
    }
    int32_t flags = SSF_DECODED;
    for (std::string_view raw : sp.samples) {
      int32_t my_line = line++;
      sv.metric = 0;
      sv.name = {};
      sv.value = 0.0f;
      sv.message = {};
      sv.sample_rate = 0.0f;
      sv.scope = 0;
      sv.tags.clear();
      bool sample_ok = parse_ssf_sample(raw, &sv);
      if (!sample_ok || sv.metric < 0 || sv.metric > 3 ||
          sv.name.empty()) {
        // STATUS, unknown enums, empty names and malformed samples all
        // take the Python path, which reproduces the reference's
        // invalid-sample accounting
        defer(static_cast<int32_t>(i),
              reinterpret_cast<const uint8_t*>(raw.data()),
              static_cast<int64_t>(raw.size()), my_line);
        continue;
      }
      ssf_key(keybuf, sv.name, kFamilyChar[sv.metric], sv.sample_rate,
              sv.tags, sv.scope);
      const Entry* found =
          e->table.find(InternTable::hash(keybuf), keybuf, &n);
      if (found == nullptr) {
        defer(static_cast<int32_t>(i),
              reinterpret_cast<const uint8_t*>(raw.data()),
              static_cast<int64_t>(raw.size()), my_line);
        continue;
      }
      const Entry& ent = *found;
      bool emitted = false;
      switch (ent.family) {
        case FAM_COUNTER:
          if (o.c_n < o.c_cap) {
            o.c_rows[o.c_n] = ent.row;
            o.c_vals[o.c_n] = sv.value;
            o.c_rates[o.c_n] = ent.rate;
            o.c_n++;
            emitted = true;
          }
          break;
        case FAM_GAUGE:
          if (o.g_n < o.g_cap) {
            o.g_rows[o.g_n] = ent.row;
            o.g_vals[o.g_n] = sv.value;
            o.g_lines[o.g_n] = my_line;
            o.g_n++;
            emitted = true;
          }
          break;
        case FAM_HISTO:
          if (o.h_n < o.h_cap) {
            o.h_rows[o.h_n] = ent.row;
            o.h_vals[o.h_n] = sv.value;
            o.h_wts[o.h_n] = 1.0f / ent.rate;
            o.h_n++;
            emitted = true;
          }
          break;
        case FAM_SET:
          if (o.s_n < o.s_cap && all_ascii(sv.message)) {
            int32_t idx, rho;
            pos_val(hash_member(
                reinterpret_cast<const uint8_t*>(sv.message.data()),
                sv.message.size()), &idx, &rho);
            o.s_rows[o.s_n] = ent.row;
            o.s_idx[o.s_n] = idx;
            o.s_rho[o.s_n] = rho;
            o.s_n++;
            emitted = true;
          }
          break;
        default:
          break;
      }
      if (emitted) {
        o.samples++;
      } else {
        defer(static_cast<int32_t>(i),
              reinterpret_cast<const uint8_t*>(raw.data()),
              static_cast<int64_t>(raw.size()), my_line);
      }
    }

    bool valid_trace = sp.id != 0 && sp.trace_id != 0 && sp.start != 0 &&
                       sp.end_ts != 0 && !sp.name.empty();
    if (indicator_enabled && sp.indicator && valid_trace) {
      flags |= SSF_NEEDS_INDICATOR;
    }
    if (uniq_rate > 0 && !sp.service.empty()) {
      // parity with ssf.randomly_sample: keep with probability rate,
      // survivor's sample_rate becomes 1.0 * rate
      double roll = static_cast<double>(xorshift64(&rng) >> 11) /
                    static_cast<double>(1ULL << 53);
      if (roll <= uniq_rate) {
        thread_local std::vector<TagKV> utags;
        utags.clear();
        utags.push_back({"indicator", sp.indicator ? "true" : "false"});
        utags.push_back(
            {"root_span", sp.id == sp.trace_id ? "true" : "false"});
        utags.push_back({"service", sp.service});
        ssf_key(keybuf, "ssf.names_unique", 's',
                static_cast<float>(uniq_rate), utags, 0);
        const Entry* uent =
            e->table.find(InternTable::hash(keybuf), keybuf, &n);
        if (uent != nullptr && all_ascii(sp.name) &&
            o.s_n < o.s_cap) {
          int32_t idx, rho;
          pos_val(hash_member(
              reinterpret_cast<const uint8_t*>(sp.name.data()),
              sp.name.size()), &idx, &rho);
          o.s_rows[o.s_n] = uent->row;
          o.s_idx[o.s_n] = idx;
          o.s_rho[o.s_n] = rho;
          o.s_n++;
          o.samples++;
        } else {
          flags |= SSF_NEEDS_UNIQ;
        }
      }
    }
    pkt_flags[i] = flags;
    decoded++;
  }
  *c_n = o.c_n;
  *g_n = o.g_n;
  *h_n = o.h_n;
  *s_n = o.s_n;
  *def_n = dn;
  *samples_out = o.samples;
  lock.unlock();
  e->count(n);
  return decoded;
}

}  // extern "C"

// ---- forward-plane digest encoder -----------------------------------------
//
// Bulk protobuf wire encoding of the flush's packed t-digest export.
// The reference serializes its digests invisibly in compiled Go
// (flusher.go:578-591); the Python proto path here built ~1M Centroid
// objects per 10k-key flush (883 keys/s, blown intervals, gRPC
// CANCELLED — BENCH_r04). This emits the exact bytes upb would
// (proto3 implicit presence: a double field is emitted iff its BIT
// PATTERN is nonzero, so -0.0 is emitted; fields in field-number
// order) so the metricpb byte fixtures still pin the wire format.

namespace {

inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
  while (v >= 0x80) {
    *p++ = static_cast<uint8_t>(v) | 0x80;
    v >>= 7;
  }
  *p++ = static_cast<uint8_t>(v);
  return p;
}

inline int varint_size(uint64_t v) {
  int n = 1;
  while (v >= 0x80) { v >>= 7; n++; }
  return n;
}

inline uint8_t* put_double_field(uint8_t* p, uint8_t tag, double v) {
  uint64_t bits;
  memcpy(&bits, &v, 8);
  if (bits == 0) return p;  // proto3 implicit presence (bitwise, upb)
  *p++ = tag;
  memcpy(p, &bits, 8);
  return p + 8;
}

}  // namespace

extern "C" {

// Encodes K MergingDigestData messages from the packed (K, C) f32
// centroid export. Centroids with weight > 0 are emitted in slot order
// (matching convert.py's nz filter); trailing scalar fields are
// compression(2), min(3), max(4), reciprocalSum(5). Writes the
// concatenated messages into `out` and K+1 boundaries into `offs`.
// Returns total bytes written, or -1 if out_cap is too small (the
// caller sizes out_cap as nnz(weights>0)*20 + K*36 + slack, which the
// per-write guards below make sufficient by construction).
int64_t vnt_digest_encode(const float* means, const float* weights,
                          int64_t K, int64_t C, const double* mins,
                          const double* maxs, const double* recips,
                          double compression, uint8_t* out,
                          int64_t out_cap, int64_t* offs) {
  uint8_t* p = out;
  uint8_t* end = out + out_cap;
  for (int64_t k = 0; k < K; k++) {
    offs[k] = p - out;
    if (end - p < 36) return -1;  // trailing scalar fields
    const float* mrow = means + k * C;
    const float* wrow = weights + k * C;
    for (int64_t c = 0; c < C; c++) {
      float wf = wrow[c];
      if (!(wf > 0.0f)) continue;
      if (end - p < 20 + 36) return -1;  // centroid + trailing scalars
      double mean = static_cast<double>(mrow[c]);
      double weight = static_cast<double>(wf);
      uint64_t mbits;
      memcpy(&mbits, &mean, 8);
      // weight > 0 so its field is always present (9 bytes); mean
      // present iff bitwise nonzero
      uint8_t clen = mbits != 0 ? 18 : 9;
      *p++ = 0x0A;  // main_centroids, length-delimited
      *p++ = clen;
      p = put_double_field(p, 0x09, mean);
      p = put_double_field(p, 0x11, weight);
    }
    p = put_double_field(p, 0x11, compression);
    p = put_double_field(p, 0x19, mins[k]);
    p = put_double_field(p, 0x21, maxs[k]);
    p = put_double_field(p, 0x29, recips[k]);
  }
  offs[K] = p - out;
  return p - out;
}

// Wraps each encoded digest into a full metricpb.Metric message:
//   head_k · field7( HistogramValue{ field1(digest_k) } ) · tail_k
// where head (fields 1-3: name, tags, type) and tail (field 9: scope)
// are the caller's per-row pre-serialized byte slices (cacheable across
// flushes — they only depend on row identity). Writes concatenated
// Metric messages + K+1 boundaries; returns total bytes or -1 if
// out_cap is too small.
int64_t vnt_metric_wrap(const uint8_t* digests, const int64_t* doffs,
                        const uint8_t* heads, const int64_t* hoffs,
                        const uint8_t* tails, const int64_t* toffs,
                        int64_t K, uint8_t* out, int64_t out_cap,
                        int64_t* offs) {
  uint8_t* p = out;
  uint8_t* end = out + out_cap;
  for (int64_t k = 0; k < K; k++) {
    offs[k] = p - out;
    int64_t dlen = doffs[k + 1] - doffs[k];
    int64_t hlen = hoffs[k + 1] - hoffs[k];
    int64_t tlen = toffs[k + 1] - toffs[k];
    // HistogramValue = 0x0A + varint(dlen) + digest
    int64_t hv = 1 + varint_size(dlen) + dlen;
    int64_t need = hlen + 1 + varint_size(hv) + hv + tlen;
    if (end - p < need) return -1;
    memcpy(p, heads + hoffs[k], hlen);
    p += hlen;
    *p++ = 0x3A;  // Metric.histogram, length-delimited
    p = put_varint(p, hv);
    *p++ = 0x0A;  // HistogramValue.t_digest
    p = put_varint(p, dlen);
    memcpy(p, digests + doffs[k], dlen);
    p += dlen;
    memcpy(p, tails + toffs[k], tlen);
    p += tlen;
  }
  offs[K] = p - out;
  return p - out;
}

}  // extern "C"

// ---- forward-plane import decoder -----------------------------------------
//
// Parses a whole forwardrpc.MetricList request straight from the wire
// into per-family column batches: identity keys (opaque bytes the
// Python side caches stubs under), scalar values, and histogram
// centroid grids ALREADY re-bucketed onto the k-scale import grid.
// Replaces the per-metric upb object walk + per-centroid Python
// generator + numpy re-bucketing (~1.7 s for a 50k-key flush on one
// core; sources/proxy/server.go gets this for free in compiled Go).

namespace {

struct WireReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  // returns field number, sets wire type; 0 on end/error (field number
  // 0 is invalid wire data, so it poisons ok rather than reading as a
  // clean end-of-message)
  uint32_t tag(uint32_t* wt) {
    if (p >= end) return 0;
    uint64_t t = varint();
    if (!ok) return 0;
    *wt = static_cast<uint32_t>(t & 7);
    uint32_t f = static_cast<uint32_t>(t >> 3);
    if (f == 0) ok = false;
    return f;
  }

  std::string_view bytes() {
    uint64_t n = varint();
    if (!ok || static_cast<uint64_t>(end - p) < n) {
      ok = false;
      return {};
    }
    std::string_view out(reinterpret_cast<const char*>(p),
                         static_cast<size_t>(n));
    p += n;
    return out;
  }

  double f64() {
    if (end - p < 8) {
      ok = false;
      return 0;
    }
    double v;
    memcpy(&v, p, 8);
    p += 8;
    return v;
  }

  void skip(uint32_t wt) {
    switch (wt) {
      case 0: varint(); break;
      case 1: if (end - p >= 8) p += 8; else ok = false; break;
      case 2: bytes(); break;
      case 5: if (end - p >= 4) p += 4; else ok = false; break;
      default: ok = false;
    }
  }
};

inline void put_key_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (v >= 0x80) {
    out.push_back(static_cast<uint8_t>(v) | 0x80);
    v >>= 7;
  }
  out.push_back(static_cast<uint8_t>(v));
}

// THE identity-key layout — [type][scope][varint nlen][name]
// [varint tcount]{[varint tlen][tag]}* — shared by the import decoder
// and the proxy route parser so the stub cache, the route cache, and
// decode_import_key can never drift. Caller guarantees type/scope fit
// a byte.
inline void emit_identity_key(std::vector<uint8_t>& key, int64_t type,
                              int64_t scope, std::string_view name,
                              const std::vector<std::string_view>& tags) {
  key.clear();
  key.push_back(static_cast<uint8_t>(type));
  key.push_back(static_cast<uint8_t>(scope));
  put_key_varint(key, name.size());
  key.insert(key.end(), name.begin(), name.end());
  put_key_varint(key, tags.size());
  for (const auto& t : tags) {
    put_key_varint(key, t.size());
    key.insert(key.end(), t.begin(), t.end());
  }
}

struct Centroid2 {
  double mean, weight;
};

// Shared wire-type guard for Metric-level fields: 1,2,5-8 are
// length-delimited, 3,9 varint; other SCALAR wire types under those
// numbers are unknown data to skip (upb semantics). The long-retired
// group wire types (3/4) still reject via skip()'s default case — a
// strictness upb doesn't share, but proto3 serializers never emit
// groups, and rejecting only forces the upb fallback. One definition
// so vnt_import_parse and vnt_route_parse cannot drift.
inline bool metric_field_wiretype_mismatch(uint32_t mf, uint32_t mwt) {
  return ((mf == 1 || mf == 2 || (mf >= 5 && mf <= 8)) && mwt != 2) ||
         ((mf == 3 || mf == 9) && mwt != 0);
}

// THE HistogramValue{ MergingDigestData t_digest=1 } walk — the single
// definition of "structurally valid digest" for both the import
// decoder (out params set) and the route validator (null out params).
// Returns false on structural corruption.
bool walk_histogram_value(std::string_view hv,
                          std::vector<Centroid2>* cents, double* dmin,
                          double* dmax, double* drecip) {
  WireReader h{reinterpret_cast<const uint8_t*>(hv.data()),
               reinterpret_cast<const uint8_t*>(hv.data()) + hv.size()};
  uint32_t hwt;
  while (uint32_t hf = h.tag(&hwt)) {
    if (!(hf == 1 && hwt == 2)) {
      h.skip(hwt);
      continue;
    }
    std::string_view dv = h.bytes();
    if (!h.ok) return false;
    WireReader d{reinterpret_cast<const uint8_t*>(dv.data()),
                 reinterpret_cast<const uint8_t*>(dv.data()) + dv.size()};
    uint32_t dwt;
    while (uint32_t df = d.tag(&dwt)) {
      switch (df) {
        case 1: {  // Centroid
          if (dwt != 2) {  // wrong wire type: unknown data
            d.skip(dwt);
            break;
          }
          std::string_view cb = d.bytes();
          if (!d.ok) return false;
          WireReader c{reinterpret_cast<const uint8_t*>(cb.data()),
                       reinterpret_cast<const uint8_t*>(cb.data()) +
                           cb.size()};
          double mean = 0, weight = 0;
          uint32_t ct;
          while (uint32_t cf2 = c.tag(&ct)) {
            if (cf2 == 1 && ct == 1) mean = c.f64();
            else if (cf2 == 2 && ct == 1) weight = c.f64();
            else c.skip(ct);  // samples etc.
          }
          if (!c.ok) return false;
          if (cents != nullptr && weight > 0) {
            cents->push_back({mean, weight});
          }
          break;
        }
        case 3:
          if (dwt == 1) {
            double v = d.f64();
            if (dmin != nullptr) *dmin = v;
          } else {
            d.skip(dwt);
          }
          break;
        case 4:
          if (dwt == 1) {
            double v = d.f64();
            if (dmax != nullptr) *dmax = v;
          } else {
            d.skip(dwt);
          }
          break;
        case 5:
          if (dwt == 1) {
            double v = d.f64();
            if (drecip != nullptr) *drecip = v;
          } else {
            d.skip(dwt);
          }
          break;
        default:
          d.skip(dwt);
      }
    }
    if (!d.ok) return false;
  }
  return h.ok;
}

}  // namespace

extern "C" {

// Counts top-level `metrics` entries so the caller can size the output
// arrays exactly. Returns -1 on a malformed buffer.
int64_t vnt_import_count(const uint8_t* buf, int64_t len) {
  WireReader r{buf, buf + len};
  int64_t n = 0;
  uint32_t wt;
  while (uint32_t f = r.tag(&wt)) {
    if (f == 1 && wt == 2) {
      r.bytes();
      n++;
    } else {
      r.skip(wt);
    }
    if (!r.ok) return -1;
  }
  return r.ok ? n : -1;
}

// Decodes a MetricList into per-family batches.
//
// Identity keys are self-delimiting byte strings
//   [type][scope][varint nlen][name][varint tcount]{[varint tlen][tag]}*
// written into key_buf; each family's rows reference (off, len) pairs.
// Histogram centroids are re-bucketed onto the C-slot k-scale grid with
// the same arcsine rule as ops/batch_tdigest.pack_centroids (weights
// <= 0 dropped, weightless/empty digests skipped entirely — merging
// one would clobber the row's min/max with zeros). Set payloads are
// returned as (off, len) into the INPUT buffer. Returns the number of
// metrics consumed, or -1 on malformed input / -2 when an output
// capacity was exhausted (caps come from vnt_import_count, so -2 only
// means key_cap was undersized).
int64_t vnt_import_parse(
    const uint8_t* buf, int64_t len, int64_t C, double compression,
    uint8_t* key_buf, int64_t key_cap,
    int64_t* c_keyoff, int64_t* c_keylen, double* c_vals, int64_t c_cap,
    int64_t* c_n,
    int64_t* g_keyoff, int64_t* g_keylen, double* g_vals, int64_t g_cap,
    int64_t* g_n,
    int64_t* h_keyoff, int64_t* h_keylen, float* h_means, float* h_weights,
    double* h_min, double* h_max, double* h_recip, int64_t h_cap,
    int64_t* h_n,
    int64_t* s_keyoff, int64_t* s_keylen, int64_t* s_payoff,
    int64_t* s_paylen, int64_t s_cap, int64_t* s_n) {
  WireReader top{buf, buf + len};
  int64_t key_used = 0;
  *c_n = *g_n = *h_n = *s_n = 0;
  int64_t consumed = 0;
  std::vector<uint8_t> key;
  std::vector<std::string_view> tags;
  std::vector<Centroid2> cents;
  uint32_t wt;
  while (uint32_t f = top.tag(&wt)) {
    if (!(f == 1 && wt == 2)) {
      top.skip(wt);
      if (!top.ok) return -1;
      continue;
    }
    std::string_view mbytes = top.bytes();
    if (!top.ok) return -1;
    WireReader m{reinterpret_cast<const uint8_t*>(mbytes.data()),
                 reinterpret_cast<const uint8_t*>(mbytes.data()) +
                     mbytes.size()};
    std::string_view name;
    tags.clear();
    int64_t type = 0, scope = 0;
    int which = 0;  // 5=counter 6=gauge 7=histogram 8=set
    double cval = 0, gval = 0;
    double dmin = 0, dmax = 0, drecip = 0;
    std::string_view set_payload;
    cents.clear();
    uint32_t mwt;
    while (uint32_t mf = m.tag(&mwt)) {
      // a field with an unexpected wire type is unknown data, not an
      // error (upb parses by WIRE type and skips) — misreading it as
      // the declared type would reject bodies upb accepts
      if (metric_field_wiretype_mismatch(mf, mwt)) {
        m.skip(mwt);
        if (!m.ok) return -1;
        continue;
      }
      switch (mf) {
        case 1: name = m.bytes(); break;
        case 2: tags.push_back(m.bytes()); break;
        case 3: type = static_cast<int64_t>(m.varint()); break;
        case 9: scope = static_cast<int64_t>(m.varint()); break;
        case 5: {  // CounterValue{int64 value=1}
          std::string_view v = m.bytes();
          WireReader cv{reinterpret_cast<const uint8_t*>(v.data()),
                        reinterpret_cast<const uint8_t*>(v.data()) +
                            v.size()};
          uint32_t cwt;
          while (uint32_t cf = cv.tag(&cwt)) {
            if (cf == 1 && cwt == 0) {
              cval = static_cast<double>(
                  static_cast<int64_t>(cv.varint()));
            } else {
              cv.skip(cwt);
            }
          }
          if (!cv.ok) return -1;
          which = 5;
          break;
        }
        case 6: {  // GaugeValue{double value=1}
          std::string_view v = m.bytes();
          WireReader gv{reinterpret_cast<const uint8_t*>(v.data()),
                        reinterpret_cast<const uint8_t*>(v.data()) +
                            v.size()};
          uint32_t gwt;
          while (uint32_t gf = gv.tag(&gwt)) {
            if (gf == 1 && gwt == 1) {
              gval = gv.f64();
            } else {
              gv.skip(gwt);
            }
          }
          if (!gv.ok) return -1;
          which = 6;
          break;
        }
        case 7: {  // HistogramValue{ MergingDigestData t_digest=1 }
          std::string_view hv = m.bytes();
          if (!m.ok ||
              !walk_histogram_value(hv, &cents, &dmin, &dmax, &drecip)) {
            return -1;
          }
          which = 7;
          break;
        }
        case 8: {  // SetValue{bytes hyper_log_log=1}
          std::string_view v = m.bytes();
          WireReader sv{reinterpret_cast<const uint8_t*>(v.data()),
                        reinterpret_cast<const uint8_t*>(v.data()) +
                            v.size()};
          uint32_t swt;
          while (uint32_t sf = sv.tag(&swt)) {
            if (sf == 1 && swt == 2) {
              set_payload = sv.bytes();
            } else {
              sv.skip(swt);
            }
          }
          if (!sv.ok) return -1;
          which = 8;
          break;
        }
        default:
          m.skip(mwt);
      }
      if (!m.ok) return -1;
    }
    if (!m.ok) return -1;
    consumed++;
    if (which == 0) continue;            // no value: skipped (logged by
                                         // the Python fallback path)
    if (type > 255 || scope > 255) continue;  // open enum beyond the
                                              // key's byte fields: skip
                                              // (upb path skips too)
    if (which == 7 && cents.empty()) continue;  // empty digest
    emit_identity_key(key, type, scope, name, tags);
    if (key_used + static_cast<int64_t>(key.size()) > key_cap) return -2;
    memcpy(key_buf + key_used, key.data(), key.size());
    int64_t koff = key_used;
    int64_t klen = static_cast<int64_t>(key.size());
    key_used += klen;

    if (which == 5) {
      if (*c_n >= c_cap) return -2;
      c_keyoff[*c_n] = koff;
      c_keylen[*c_n] = klen;
      c_vals[*c_n] = cval;
      (*c_n)++;
    } else if (which == 6) {
      if (*g_n >= g_cap) return -2;
      g_keyoff[*g_n] = koff;
      g_keylen[*g_n] = klen;
      g_vals[*g_n] = gval;
      (*g_n)++;
    } else if (which == 7) {
      if (*h_n >= h_cap) return -2;
      // re-bucket onto the k-scale grid: pack_centroids' arcsine rule
      std::stable_sort(cents.begin(), cents.end(),
                       [](const Centroid2& a, const Centroid2& b) {
                         return a.mean < b.mean;
                       });
      double tot = 0;
      for (const auto& c : cents) tot += c.weight;
      float* om = h_means + (*h_n) * C;
      float* ow = h_weights + (*h_n) * C;
      memset(om, 0, sizeof(float) * C);
      memset(ow, 0, sizeof(float) * C);
      if (tot > 0) {
        std::vector<double> acc_w(C, 0.0), acc_wv(C, 0.0);
        double cw = 0;
        for (const auto& c : cents) {
          cw += c.weight;
          double q_mid = (cw - c.weight * 0.5) / tot;
          double x = 2 * q_mid - 1;
          if (x < -1) x = -1;
          if (x > 1) x = 1;
          double k = compression * (asin(x) / M_PI + 0.5);
          int64_t b = static_cast<int64_t>(floor(k));
          if (b < 0) b = 0;
          if (b >= C) b = C - 1;
          acc_w[b] += c.weight;
          acc_wv[b] += c.weight * c.mean;
        }
        for (int64_t b = 0; b < C; b++) {
          if (acc_w[b] > 0) {
            ow[b] = static_cast<float>(acc_w[b]);
            om[b] = static_cast<float>(acc_wv[b] / acc_w[b]);
          }
        }
      }
      h_keyoff[*h_n] = koff;
      h_keylen[*h_n] = klen;
      h_min[*h_n] = dmin;
      h_max[*h_n] = dmax;
      h_recip[*h_n] = drecip;
      (*h_n)++;
    } else if (which == 8) {
      if (*s_n >= s_cap) return -2;
      s_keyoff[*s_n] = koff;
      s_keylen[*s_n] = klen;
      // a SetValue with no payload field decodes as empty bytes (the
      // Python HLL decoder then drops it with a log line)
      s_payoff[*s_n] = set_payload.data() == nullptr
          ? 0
          : reinterpret_cast<const uint8_t*>(set_payload.data()) - buf;
      s_paylen[*s_n] = static_cast<int64_t>(set_payload.size());
      (*s_n)++;
    }
  }
  return top.ok ? consumed : -1;
}

namespace {

// Structural validation of a Metric's value submessage (fields 5-8):
// the proxy forwards RAW bytes, so anything it accepts lands verbatim
// in a downstream importer's batch — one structurally-corrupt value
// would fail whole 512-metric destination sends. upb validated these
// nested messages when the proxy deserialized; the route parser must
// be exactly as strict about structure (utf-8 strictness lives in the
// Python key-decode layer).
bool validate_value_field(std::string_view v, int field) {
  if (field == 7) {  // HistogramValue: the shared digest walk decides
    return walk_histogram_value(v, nullptr, nullptr, nullptr, nullptr);
  }
  WireReader r{reinterpret_cast<const uint8_t*>(v.data()),
               reinterpret_cast<const uint8_t*>(v.data()) + v.size()};
  uint32_t wt;
  while (uint32_t f = r.tag(&wt)) {
    r.skip(wt);
  }
  return r.ok;
}

}  // namespace

// Proxy-side routing parse: walks a MetricList body and emits, per
// metric, the identity key (same layout as vnt_import_parse) plus the
// (offset, length) of the metric's own serialized bytes inside `buf` —
// the proxy hashes the key onto its ring and forwards the RAW bytes
// untouched, so re-scattering a 50k-metric body never deserializes a
// Metric in Python. Value fields are structurally validated but not
// decoded. Returns the metric count, -1 on malformed input, -2 on
// exhausted caps.
int64_t vnt_route_parse(const uint8_t* buf, int64_t len,
                        uint8_t* key_buf, int64_t key_cap,
                        int64_t* koff, int64_t* klen,
                        int64_t* moff, int64_t* mlen, int64_t cap,
                        int64_t* n_out) {
  WireReader top{buf, buf + len};
  int64_t key_used = 0;
  *n_out = 0;
  std::vector<uint8_t> key;
  std::vector<std::string_view> tags;
  uint32_t wt;
  while (uint32_t f = top.tag(&wt)) {
    if (!(f == 1 && wt == 2)) {
      top.skip(wt);
      if (!top.ok) return -1;
      continue;
    }
    std::string_view mbytes = top.bytes();
    if (!top.ok) return -1;
    WireReader m{reinterpret_cast<const uint8_t*>(mbytes.data()),
                 reinterpret_cast<const uint8_t*>(mbytes.data()) +
                     mbytes.size()};
    std::string_view name;
    tags.clear();
    int64_t type = 0, scope = 0;
    uint32_t mwt;
    while (uint32_t mf = m.tag(&mwt)) {
      // unexpected wire type = unknown data (upb semantics), not error
      if (metric_field_wiretype_mismatch(mf, mwt)) {
        m.skip(mwt);
        if (!m.ok) return -1;
        continue;
      }
      switch (mf) {
        case 1: name = m.bytes(); break;
        case 2: tags.push_back(m.bytes()); break;
        case 3: type = static_cast<int64_t>(m.varint()); break;
        case 9: scope = static_cast<int64_t>(m.varint()); break;
        case 5:
        case 6:
        case 7:
        case 8: {
          std::string_view v = m.bytes();
          if (!m.ok || !validate_value_field(v, static_cast<int>(mf))) {
            return -1;
          }
          break;
        }
        default: m.skip(mwt);
      }
    }
    if (!m.ok) return -1;
    if (*n_out >= cap) return -2;
    if (type > 255 || scope > 255) {
      // open enum beyond the key's byte fields: klen 0 marks "no
      // identity key"; the Python side handles this metric through the
      // upb slow path instead of risking a cache collision
      koff[*n_out] = key_used;
      klen[*n_out] = 0;
      moff[*n_out] =
          reinterpret_cast<const uint8_t*>(mbytes.data()) - buf;
      mlen[*n_out] = static_cast<int64_t>(mbytes.size());
      (*n_out)++;
      continue;
    }
    emit_identity_key(key, type, scope, name, tags);
    if (key_used + static_cast<int64_t>(key.size()) > key_cap) return -2;
    memcpy(key_buf + key_used, key.data(), key.size());
    koff[*n_out] = key_used;
    klen[*n_out] = static_cast<int64_t>(key.size());
    key_used += static_cast<int64_t>(key.size());
    moff[*n_out] =
        reinterpret_cast<const uint8_t*>(mbytes.data()) - buf;
    mlen[*n_out] = static_cast<int64_t>(mbytes.size());
    (*n_out)++;
  }
  return top.ok ? *n_out : -1;
}

}  // extern "C"

// ---- native load blaster (sendmmsg) ---------------------------------------
//
// The benchmark-driver half of the story (the veneur-emit equivalent,
// reference cmd/veneur-emit/main.go:169): pre-rendered datagrams are sent
// to a connected UDP socket in sendmmsg bursts from native threads, so
// load generation never competes with the server for the GIL. Used by
// bench.py; not part of the serving path.

namespace {

struct Blast {
  std::vector<uint8_t> corpus;
  std::vector<int64_t> offs, lens;
};

}  // namespace

void* vnt_blast_new(const uint8_t* data, int64_t datalen,
                    const int64_t* offs, const int64_t* lens, int64_t n) {
  Blast* b = new Blast();
  b->corpus.assign(data, data + datalen);
  b->offs.assign(offs, offs + n);
  b->lens.assign(lens, lens + n);
  return b;
}

void vnt_blast_free(void* bp) { delete static_cast<Blast*>(bp); }

// Sends datagrams round-robin (starting at `phase`) until *stop becomes
// nonzero or max_dgrams have been sent. pace_pps > 0 paces the send rate;
// 0 sends flat out. Returns the number of datagrams handed to the kernel.
int64_t vnt_blast_run(void* bp, int32_t fd, volatile int32_t* stop,
                      int64_t max_dgrams, int32_t burst, double pace_pps,
                      int64_t phase) {
  Blast* b = static_cast<Blast*>(bp);
  int64_t n = static_cast<int64_t>(b->offs.size());
  if (n == 0 || burst <= 0) return 0;
  if (burst > 1024) burst = 1024;
  std::vector<mmsghdr> hdrs(burst);
  std::vector<iovec> iovs(burst);
  memset(hdrs.data(), 0, sizeof(mmsghdr) * burst);
  for (int32_t i = 0; i < burst; i++) {
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
  }
  int64_t sent = 0;
  int64_t pos = ((phase % n) + n) % n;
  int64_t t0 = 0;
  if (pace_pps > 0) t0 = now_ms();
  while (!*stop && (max_dgrams <= 0 || sent < max_dgrams)) {
    int32_t take = burst;
    if (max_dgrams > 0 && max_dgrams - sent < take) {
      take = static_cast<int32_t>(max_dgrams - sent);
    }
    for (int32_t i = 0; i < take; i++) {
      iovs[i].iov_base = b->corpus.data() + b->offs[pos];
      iovs[i].iov_len = static_cast<size_t>(b->lens[pos]);
      pos++;
      if (pos >= n) pos = 0;
    }
    int got = sendmmsg(fd, hdrs.data(), take, 0);
    if (got < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK || errno == ENOBUFS ||
          errno == EINTR) {
        struct timespec ts = {0, 200000};  // 200us backoff
        nanosleep(&ts, nullptr);
        continue;
      }
      break;
    }
    sent += got;
    if (pace_pps > 0) {
      // keep the cumulative rate at pace_pps without drifting
      int64_t due_ms = t0 + static_cast<int64_t>(sent * 1000.0 / pace_pps);
      int64_t now = now_ms();
      if (now < due_ms) {
        struct timespec ts = {0, 0};
        int64_t wait = due_ms - now;
        ts.tv_sec = wait / 1000;
        ts.tv_nsec = (wait % 1000) * 1000000;
        nanosleep(&ts, nullptr);
      }
    }
  }
  return sent;
}

}  // extern "C"
