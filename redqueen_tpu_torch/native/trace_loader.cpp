// Native trace ingestion: the port's C++ data-loader component, a copy of
// the JAX package's own (that package keeps its source; the port builds
// from this file only).
//
// The reference feeds Twitter traces to its RealData broadcaster from
// Python; at the target scale (100k+ users, millions of rows) the
// pure-Python CSV path (redqueen_tpu_torch/data/traces.py::load_csv,
// engine="python") is minutes of interpreter loop before the first
// device step. This file is the same contract -- (user, timestamp) rows
// -> per-user ascending time arrays, users ordered by first appearance
// -- parsed natively. Python binds it with ctypes
// (redqueen_tpu_torch/native/loader.py); its output is held equal to the
// Python engine's, traces and LoadStats, by
// tests/test_torch_native_loader.py.
//
// Parsing is allocation-light by design: the whole file is read once,
// fields are std::string_view slices into that buffer, user keys hash as
// views (materialized only on first appearance via the map's key), and
// timestamps take a std::from_chars fast path with a strtod_l("C") slow
// path for the cases from_chars can't express (leading '+', Python's
// digit-separating underscores, out-of-range magnitudes that must round
// to +-inf/0 the way Python float() does).
//
// Deliberate C ABI (no pybind11 in this environment): an opaque handle
// carries the parse result; the caller sizes NumPy buffers from
// rq_n_users/rq_total_events and rq_fill copies into them; rq_free
// releases. Every error path reports through errbuf -- no exceptions
// cross the boundary.

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <charconv>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <locale.h>
#include <string>
#include <string_view>
#include <vector>

namespace {

struct ParseResult {
  std::string data;  // the whole file; field views point into it
  std::vector<std::vector<double>> per_user;  // first-appearance order
  // Load stats (the serving reorder window's measured input contract):
  // rows whose timestamp regressed vs the SAME user's previous row in
  // file order, and exact duplicate timestamps within a user (counted
  // post-sort as adjacent equals).
  long n_nonmonotonic = 0;
  long n_duplicates = 0;
};

// Open-addressing user-key index (FNV-1a, linear probing, stored hashes,
// power-of-two capacity, grow at 70% load). std::unordered_map's
// node-per-key layout was the measured hot spot of the whole parse (50%+
// of samples in _M_find_before_node; one heap node + pointer chase per
// row): a flat probe array with the hash pre-compared costs one cache
// line for almost every lookup.
struct UserIndex {
  struct Slot {
    std::string_view key;
    size_t val = 0;
    uint64_t hash = 0;
    bool used = false;
  };
  std::vector<Slot> slots;
  size_t count = 0;

  explicit UserIndex(size_t cap = 1 << 17) : slots(cap) {}

  static uint64_t fnv1a(std::string_view s) {
    uint64_t h = 1469598103934665603ull;
    for (char c : s) {
      h ^= static_cast<unsigned char>(c);
      h *= 1099511628211ull;
    }
    return h;
  }

  // Returns the value slot for `k`, inserting `next_val` (and setting
  // *inserted) when the key is new.
  size_t find_or_insert(std::string_view k, size_t next_val,
                        bool* inserted) {
    uint64_t h = fnv1a(k);
    size_t mask = slots.size() - 1;
    size_t i = h & mask;
    for (;;) {
      Slot& s = slots[i];
      if (!s.used) {
        if ((count + 1) * 10 > slots.size() * 7) {
          grow();
          return find_or_insert(k, next_val, inserted);
        }
        s.used = true;
        s.key = k;
        s.val = next_val;
        s.hash = h;
        ++count;
        *inserted = true;
        return next_val;
      }
      if (s.hash == h && s.key == k) {
        *inserted = false;
        return s.val;
      }
      i = (i + 1) & mask;
    }
  }

  void grow() {
    std::vector<Slot> old = std::move(slots);
    slots.assign(old.size() * 2, {});
    size_t mask = slots.size() - 1;
    for (auto& s : old) {
      if (!s.used) continue;
      size_t i = s.hash & mask;
      while (slots[i].used) i = (i + 1) & mask;
      slots[i] = s;
    }
  }
};

void set_err(char* errbuf, int errlen, const std::string& msg) {
  if (errbuf && errlen > 0) {
    std::snprintf(errbuf, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

// ASCII whitespace (' ', \t \n \v \f \r) inlined — the corpora are ASCII
// by contract (see parse_time) and std::isspace is an opaque call through
// the locale table on the hottest per-field path.
inline bool is_space(char c) {
  return c == ' ' || (c >= '\t' && c <= '\r');
}

// Mirror of Python "not line.strip()": every char is whitespace.
bool is_blank(std::string_view s) {
  for (char c : s) {
    if (!is_space(c)) return false;
  }
  return true;
}

locale_t c_locale() {
  static locale_t loc = ::newlocale(LC_ALL_MASK, "C", (locale_t)0);
  return loc;
}

// Slow path: Python-float() features std::from_chars can't express.
// Validates digit-separating underscores (dropping them), a single
// leading '+', then strtod_l under an explicit "C" locale (an embedding
// process's LC_NUMERIC must never change which corpora load) with
// full-consumption required. strtod's overflow/underflow behavior
// (+-HUGE_VAL / +-0 with ERANGE) matches Python float()'s.
bool parse_time_slow(std::string_view sv, double* out) {
  std::string s;
  s.reserve(sv.size());
  for (size_t i = 0; i < sv.size(); ++i) {
    char c = sv[i];
    // strtod-only envelope Python float() rejects: hex literals and
    // nan(...) payloads (the fast path rejects them too; this guard
    // covers the slow-path-only inputs like "+0x10")
    if (c == 'x' || c == 'X' || c == '(') return false;
    if (c == '_') {
      // Python: underscores only BETWEEN digits (also inside exponents)
      if (i == 0 || i + 1 >= sv.size() ||
          !std::isdigit(static_cast<unsigned char>(sv[i - 1])) ||
          !std::isdigit(static_cast<unsigned char>(sv[i + 1]))) {
        return false;
      }
      continue;  // drop the separator for strtod
    }
    s.push_back(c);
  }
  const char* cs = s.c_str();
  char* end = nullptr;
  errno = 0;
  double v = ::strtod_l(cs, &end, c_locale());
  if (end == cs || *end != '\0') return false;
  *out = v;
  return true;
}

// Mirror of Python float(field): optional surrounding whitespace, ASCII
// digit-separating underscores allowed, the full field must be consumed;
// empty/invalid -> error (returns false). The strtod envelope EXTRAS are
// rejected to match Python -- hex literals ("0x10") stop at 'x' and fail
// full consumption, "nan(chars)" is rejected explicitly. Non-ASCII
// numerals (which Python's float() accepts) are out of scope for the
// native parser: they report as a bad-float error rather than silently
// diverging.
bool parse_time(std::string_view sv, double* out) {
  while (!sv.empty() && is_space(sv.front())) sv.remove_prefix(1);
  while (!sv.empty() && is_space(sv.back())) sv.remove_suffix(1);
  if (sv.empty()) return false;
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  // Fast path: std::from_chars for doubles (libstdc++ >= 11 / libc++).
  if (sv.front() == '+') return parse_time_slow(sv, out);  // rare
  double v;
  auto [p, ec] = std::from_chars(sv.data(), sv.data() + sv.size(), v);
  if (ec == std::errc() && p == sv.data() + sv.size()) {
    // from_chars consumes "nan(charseq)"; Python float() rejects it —
    // scan for the payload parens only on the nan hit itself
    if (v != v && sv.find('(') != std::string_view::npos) return false;
    *out = v;
    return true;
  }
  if (ec == std::errc::result_out_of_range &&
      p == sv.data() + sv.size()) {
    // out-of-range magnitudes: strtod rounds to +-inf / +-0 exactly
    // like Python float()
    return parse_time_slow(sv, out);
  }
  // from_chars stopped early; the only Python-valid reason is a
  // digit-separating underscore
  if (sv.find('_') != std::string_view::npos) {
    return parse_time_slow(sv, out);
  }
  return false;
#else
  // Toolchains without floating-point from_chars (libstdc++ 10, the
  // container's g++) take the strtod_l slow path for EVERY field — the
  // semantic reference the fast path above mirrors, so the two builds
  // parse identically; only the throughput differs.
  return parse_time_slow(sv, out);
#endif
}

}  // namespace

extern "C" {

// Parse the CSV at `path`. Returns an opaque handle, or nullptr with
// errbuf filled. Column semantics match data/traces.py::load_csv: rows
// split on `delimiter`, `user_col`/`time_col` index the split fields, the
// first `skip_header` lines are skipped, blank lines are skipped, the
// user key is the raw (unstripped) field text.
void* rq_parse_csv(const char* path, int user_col, int time_col,
                   char delimiter, int skip_header, char* errbuf,
                   int errlen) {
  if (user_col < 0 || time_col < 0) {  // would index out of bounds below
    set_err(errbuf, errlen, "column indices must be non-negative");
    return nullptr;
  }
  std::FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_err(errbuf, errlen, std::string("cannot open ") + path);
    return nullptr;
  }
  auto* res = new ParseResult();
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (fsize > 0) {
    res->data.resize(static_cast<size_t>(fsize));
    size_t got = std::fread(res->data.data(), 1, res->data.size(), f);
    res->data.resize(got);
  } else {
    // Non-seekable (FIFO, /dev/stdin) or stat-size-0 (/proc) inputs:
    // ftell reports -1/0 there, so stream in chunks instead of silently
    // parsing an empty buffer.
    char buf[1 << 16];
    size_t got;
    while ((got = std::fread(buf, 1, sizeof buf, f)) > 0) {
      res->data.append(buf, got);
    }
  }
  std::fclose(f);

  UserIndex index;

  const size_t u_col = static_cast<size_t>(user_col);
  const size_t t_col = static_cast<size_t>(time_col);
  const size_t needed = std::max(u_col, t_col) + 1;
  const char* base = res->data.data();
  const size_t n = res->data.size();

  size_t pos = 0;
  long lineno = -1;
  while (pos < n) {
    // Universal-newline parity with the Python engine (binary read keeps
    // raw terminators): '\n', '\r', and '\r\n' all end a line — a '\r'
    // left in a field would silently split e.g. "alice" / "alice\r" into
    // two users on mixed-endings files, and CR-only (classic-Mac) files
    // would collapse to one giant line.
    const char* lf = static_cast<const char*>(
        std::memchr(base + pos, '\n', n - pos));
    // '\r' search bounded to the LF-terminated span: an unbounded scan of
    // the remaining buffer would be O(corpus) per line on LF-only files.
    const size_t span = lf ? static_cast<size_t>(lf - (base + pos)) : n - pos;
    const char* cr = static_cast<const char*>(
        std::memchr(base + pos, '\r', span));
    const char* nl = cr ? cr : lf;
    size_t le = nl ? static_cast<size_t>(nl - base) : n;
    std::string_view line(base + pos, le - pos);
    size_t next = le + 1;
    if (nl && *nl == '\r' && next < n && base[next] == '\n') {
      ++next;  // CRLF: consume both terminator bytes
    }
    ++lineno;
    if (lineno < skip_header || is_blank(line)) {
      pos = next;
      continue;
    }
    // Walk the fields in place; only the two interesting columns are kept.
    std::string_view uf, tf;
    size_t field_idx = 0, start = 0;
    for (size_t i = 0; i <= line.size(); ++i) {
      if (i == line.size() || line[i] == delimiter) {
        if (field_idx == u_col) uf = line.substr(start, i - start);
        if (field_idx == t_col) tf = line.substr(start, i - start);
        ++field_idx;
        start = i + 1;
      }
    }
    if (field_idx < needed) {
      set_err(errbuf, errlen,
              "line " + std::to_string(lineno) + ": expected at least " +
                  std::to_string(needed) + " fields, got " +
                  std::to_string(field_idx));
      delete res;
      return nullptr;
    }
    double t;
    if (!parse_time(tf, &t)) {
      set_err(errbuf, errlen,
              "line " + std::to_string(lineno) + ": bad float '" +
                  std::string(tf) + "'");
      delete res;
      return nullptr;
    }
    if (t != t) {
      // A NaN row cannot be ordered against any other row of its user:
      // typed rejection (the Python side maps "unorderable" onto
      // TraceOrderError), matching data/traces.py's Python engine —
      // including its .strip()ed field in the message (wording parity
      // is fuzz-pinned).
      std::string_view tt = tf;
      while (!tt.empty() && is_space(tt.front())) tt.remove_prefix(1);
      while (!tt.empty() && is_space(tt.back())) tt.remove_suffix(1);
      set_err(errbuf, errlen,
              "line " + std::to_string(lineno) + ": unorderable timestamp '" +
                  std::string(tt) + "' (NaN rows cannot be ordered)");
      delete res;
      return nullptr;
    }
    bool inserted;
    // key views into res->data: stable for the index's lifetime
    size_t ui = index.find_or_insert(uf, res->per_user.size(), &inserted);
    if (inserted) res->per_user.emplace_back();
    std::vector<double>& uv = res->per_user[ui];
    if (!uv.empty() && t < uv.back()) ++res->n_nonmonotonic;
    uv.push_back(t);
    pos = next;
  }
  for (auto& v : res->per_user) {
    // NaNs are rejected at parse above, so operator< is a strict weak
    // order here and plain std::sort is defined.
    std::sort(v.begin(), v.end());
    for (size_t i = 1; i < v.size(); ++i) {
      if (v[i] == v[i - 1]) ++res->n_duplicates;
    }
  }
  return res;
}

long rq_n_nonmonotonic(void* h) {
  return static_cast<ParseResult*>(h)->n_nonmonotonic;
}

long rq_n_duplicates(void* h) {
  return static_cast<ParseResult*>(h)->n_duplicates;
}

long rq_n_users(void* h) {
  return static_cast<long>(static_cast<ParseResult*>(h)->per_user.size());
}

long rq_total_events(void* h) {
  long total = 0;
  for (const auto& v : static_cast<ParseResult*>(h)->per_user)
    total += static_cast<long>(v.size());
  return total;
}

// times_out: rq_total_events doubles (per-user blocks, ascending within
// each); offsets_out: rq_n_users + 1 longs, user u's times are
// times_out[offsets_out[u] : offsets_out[u+1]].
void rq_fill(void* h, double* times_out, long* offsets_out) {
  auto* res = static_cast<ParseResult*>(h);
  long pos = 0;
  size_t u = 0;
  for (; u < res->per_user.size(); ++u) {
    offsets_out[u] = pos;
    const auto& v = res->per_user[u];
    std::memcpy(times_out + pos, v.data(), v.size() * sizeof(double));
    pos += static_cast<long>(v.size());
  }
  offsets_out[u] = pos;
}

void rq_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
