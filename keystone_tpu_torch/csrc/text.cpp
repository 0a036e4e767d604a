// Native host-text chain of the port: the fused
// trim -> lower -> tokenize -> n-gram -> tf -> {vocabulary lookup |
// feature hashing | document frequency} loop, with a thread pool over
// the documents.
//
// A copy of the reference's text section (native/keystone_native.cpp,
// the ks_text_* functions and ks_free), so that the port's rows and
// vocabularies are the reference's native path's, bit for bit; the
// parity is pinned by tests/test_torch_text_ops.py.  Built with g++ by
// keystone_tpu_torch/kernels/build.py and bound by ctypes in
// keystone_tpu_torch/ops/nlp_native.py.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

void ks_free(void* p) { free(p); }

}  // extern "C"

// ------------------------------------------------------------------ text
// Parity contract with keystone_tpu_torch/ops/nlp.py's Python chain:
//   - tokens = maximal runs of [A-Za-z0-9'] (the Python Tokenizer's
//     default split pattern); `lower` ASCII-lowercases first; `trim`
//     strips ASCII whitespace like str.strip().  Known divergence: a
//     handful of non-ASCII characters lowercase into ASCII in Python
//     (U+0130 'İ' -> 'i'+combining dot, U+212A Kelvin -> 'k'), so docs
//     containing them tokenize differently here (the original bytes are
//     separators).  ASCII and ordinary UTF-8 text is bit-identical.
//   - n-gram term key = tokens joined with '\x1f' (the Python side's
//     tuple <-> joined-string bridge).
//   - tf: raw counts or log(1+count) (TermFrequency(log_tf)).
//   - df top-N tie-break: (-df, first-doc-index, term), deterministic,
//     where Python's Counter.most_common orders ties by set iteration
//     (salted per process); terms with distinct dfs are identical.

namespace {

struct TfEntry { int32_t col; float val; };

// transparent string_view lookup (C++20 P0919): global maps keyed by
// std::string but probed with views into per-doc arenas — a string is
// only constructed on first insertion, never per occurrence
struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view s) const {
    return std::hash<std::string_view>{}(s);
  }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const {
    return a == b;
  }
};

// Reusable per-doc scratch: term keys live in one arena; counting is
// sort-views + run-length (beats a per-doc hash map: ~240 keys/doc ×
// 10⁵ docs was 24M small map allocations in the first cut).
struct DocScratch {
  std::string text;                             // trimmed/lowered copy
  std::vector<std::pair<size_t, size_t>> toks;  // (offset, len) in text
  std::string arena;                            // all n-gram keys, packed
  std::vector<std::pair<size_t, size_t>> keys;  // (offset, len) in arena
  std::vector<std::pair<std::string_view, int32_t>> counted;
};

// tokenize + n-grams into `ds.keys`, then sort + run-length into
// `ds.counted` (term view -> tf count, each term once)
static void doc_terms(const char* p, const char* end, bool lower, bool trim,
                      uint32_t orders_mask, DocScratch& ds) {
  if (trim) {
    while (p < end && (unsigned char)*p <= ' ') p++;
    while (end > p && (unsigned char)end[-1] <= ' ') end--;
  }
  ds.text.assign(p, end);
  if (lower)
    for (char& c : ds.text)
      if (c >= 'A' && c <= 'Z') c += 32;
  ds.toks.clear();
  const char* s = ds.text.data();
  size_t nbytes = ds.text.size();
  size_t i = 0;
  auto is_tok = [](char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '\'';
  };
  while (i < nbytes) {
    while (i < nbytes && !is_tok(s[i])) i++;
    size_t start = i;
    while (i < nbytes && is_tok(s[i])) i++;
    if (i > start) ds.toks.emplace_back(start, i - start);
  }
  ds.arena.clear();
  ds.keys.clear();
  for (int order = 1; order <= 8; order++) {
    if (!(orders_mask & (1u << (order - 1)))) continue;
    if (ds.toks.size() < (size_t)order) continue;
    for (size_t t = 0; t + order <= ds.toks.size(); t++) {
      size_t start = ds.arena.size();
      for (int j = 0; j < order; j++) {
        if (j) ds.arena.push_back('\x1f');
        ds.arena.append(s + ds.toks[t + j].first, ds.toks[t + j].second);
      }
      ds.keys.emplace_back(start, ds.arena.size() - start);
    }
  }
  const char* a = ds.arena.data();
  std::sort(ds.keys.begin(), ds.keys.end(),
            [a](const auto& x, const auto& y) {
              return std::string_view(a + x.first, x.second) <
                     std::string_view(a + y.first, y.second);
            });
  ds.counted.clear();
  for (size_t k = 0; k < ds.keys.size();) {
    std::string_view key(a + ds.keys[k].first, ds.keys[k].second);
    size_t j = k + 1;
    while (j < ds.keys.size() &&
           std::string_view(a + ds.keys[j].first, ds.keys[j].second) == key)
      j++;
    ds.counted.emplace_back(key, (int32_t)(j - k));
    k = j;
  }
}

}  // namespace

namespace {

// ---- BLAKE2b (RFC 7693; unkeyed, sequential) — the native twin of
// ops/nlp.py's stable_term_hash: blake2b(repr(term), digest_size=8),
// little-endian.  Implemented from the spec; held against hashlib by
// tests/test_torch_text_ops.py.
struct B2b {
  uint64_t h[8], t[2];
  uint8_t buf[128];
  size_t buflen;
};

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t B2B_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

static inline uint64_t rotr64(uint64_t x, int n) {
  return (x >> n) | (x << (64 - n));
}

static void b2b_compress(B2b* S, const uint8_t* block, bool last) {
  uint64_t v[16], m[16];
  for (int i = 0; i < 8; i++) v[i] = S->h[i];
  for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
  v[12] ^= S->t[0];
  v[13] ^= S->t[1];
  if (last) v[14] = ~v[14];
  for (int i = 0; i < 16; i++) memcpy(&m[i], block + 8 * i, 8);  // LE host
  auto G = [&](int a, int b, int c, int d, uint64_t x, uint64_t y) {
    v[a] = v[a] + v[b] + x;
    v[d] = rotr64(v[d] ^ v[a], 32);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 24);
    v[a] = v[a] + v[b] + y;
    v[d] = rotr64(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 63);
  };
  for (int r = 0; r < 12; r++) {
    const uint8_t* s = B2B_SIGMA[r];
    G(0, 4, 8, 12, m[s[0]], m[s[1]]);
    G(1, 5, 9, 13, m[s[2]], m[s[3]]);
    G(2, 6, 10, 14, m[s[4]], m[s[5]]);
    G(3, 7, 11, 15, m[s[6]], m[s[7]]);
    G(0, 5, 10, 15, m[s[8]], m[s[9]]);
    G(1, 6, 11, 12, m[s[10]], m[s[11]]);
    G(2, 7, 8, 13, m[s[12]], m[s[13]]);
    G(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; i++) S->h[i] ^= v[i] ^ v[i + 8];
}

// unkeyed blake2b-64 (8-byte digest) of msg, returned as LE uint64
static uint64_t blake2b8(const uint8_t* msg, size_t len) {
  B2b S;
  for (int i = 0; i < 8; i++) S.h[i] = B2B_IV[i];
  S.h[0] ^= 0x01010000ULL ^ 8ULL;  // digest_length=8, fanout=1, depth=1
  S.t[0] = S.t[1] = 0;
  S.buflen = 0;
  while (len > 128) {  // full blocks (never the last one)
    S.t[0] += 128;
    if (S.t[0] < 128) S.t[1]++;
    b2b_compress(&S, msg, false);
    msg += 128;
    len -= 128;
  }
  memcpy(S.buf, msg, len);
  memset(S.buf + len, 0, 128 - len);
  S.t[0] += len;
  b2b_compress(&S, S.buf, true);
  return S.h[0];  // first 8 digest bytes == h[0] little-endian
}

// repr() of a tuple of ASCII token strings, exactly as CPython renders
// it for the token alphabet [A-Za-z0-9']: strings containing an
// apostrophe are double-quoted (they can never contain '"'), others
// single-quoted; 1-tuples carry the trailing comma, n-tuples separate
// with ", ".
static void py_tuple_repr(const std::vector<std::string_view>& toks,
                          std::string& out) {
  out.clear();
  out.push_back('(');
  for (size_t i = 0; i < toks.size(); i++) {
    if (i) out.append(", ");
    char q = toks[i].find('\'') != std::string_view::npos ? '"' : '\'';
    out.push_back(q);
    out.append(toks[i]);
    out.push_back(q);
  }
  if (toks.size() == 1) out.push_back(',');
  out.push_back(')');
}

}  // namespace

extern "C" {

// Raw docs -> CSR rows over a fixed vocabulary (the fused
// trim→lower→tokenize→ngram→tf→CommonSparseFeaturesModel chain).
// blob/doc_offs: concatenated UTF-8 docs, ndocs+1 offsets.
// vocab_blob/voc_offs: concatenated '\x1f'-joined term keys, vsize+1.
// orders_mask: bit (n-1) set => emit n-grams.  log_tf: 0 raw, 1 log1p.
// indptr: caller-allocated int64[ndocs+1].  out_indices/out_values:
// malloc'd here (ks_free), CSR column/value arrays sorted by column
// within each row.
int ks_text_featurize(const char* blob, const int64_t* doc_offs, int64_t ndocs,
                      const char* vocab_blob, const int64_t* voc_offs,
                      int64_t vsize, uint32_t orders_mask, int log_tf,
                      int lower, int trim, int threads,
                      int64_t* indptr, int32_t** out_indices,
                      float** out_values) {
  std::unordered_map<std::string, int32_t, SvHash, SvEq> vocab;
  vocab.reserve((size_t)vsize * 2);
  for (int64_t v = 0; v < vsize; v++)
    vocab.emplace(std::string(vocab_blob + voc_offs[v],
                              (size_t)(voc_offs[v + 1] - voc_offs[v])),
                  (int32_t)v);
  if (threads < 1) threads = (int)std::thread::hardware_concurrency();
  if (threads < 1) threads = 1;
  if ((int64_t)threads > ndocs) threads = ndocs > 0 ? (int)ndocs : 1;
  std::vector<std::vector<TfEntry>> rows((size_t)ndocs);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    DocScratch ds;
    while (true) {
      int64_t d = next.fetch_add(1);
      if (d >= ndocs) break;
      doc_terms(blob + doc_offs[d], blob + doc_offs[d + 1], lower, trim,
                orders_mask, ds);
      auto& row = rows[(size_t)d];
      for (auto& kv : ds.counted) {
        auto it = vocab.find(kv.first);
        if (it == vocab.end()) continue;
        float v = (float)kv.second;
        if (log_tf) v = (float)std::log(1.0 + (double)kv.second);
        row.push_back({it->second, v});
      }
      std::sort(row.begin(), row.end(),
                [](const TfEntry& a, const TfEntry& b) { return a.col < b.col; });
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t d = 0; d < ndocs; d++) {
    nnz += (int64_t)rows[(size_t)d].size();
    indptr[d + 1] = nnz;
  }
  int32_t* idx = (int32_t*)malloc(sizeof(int32_t) * (size_t)(nnz > 0 ? nnz : 1));
  float* val = (float*)malloc(sizeof(float) * (size_t)(nnz > 0 ? nnz : 1));
  if (!idx || !val) { free(idx); free(val); return -4; }
  int64_t w = 0;
  for (int64_t d = 0; d < ndocs; d++)
    for (auto& e : rows[(size_t)d]) { idx[w] = e.col; val[w] = e.val; w++; }
  *out_indices = idx;
  *out_values = val;
  return 0;
}

// Raw docs -> hashed CSR rows (HashingTF over the fused chain): col =
// blake2b8(repr(term)) % num_features (the stable_term_hash contract),
// colliding terms' tf values ACCUMULATE.  Same output conventions as
// ks_text_featurize.  Float accumulation order on collisions is
// sorted-column here vs dict-insertion in Python — parity to 1e-6.
int ks_text_hashtf(const char* blob, const int64_t* doc_offs, int64_t ndocs,
                   uint32_t orders_mask, int log_tf, int lower, int trim,
                   int64_t num_features, int threads, int64_t* indptr,
                   int32_t** out_indices, float** out_values) {
  if (threads < 1) threads = (int)std::thread::hardware_concurrency();
  if (threads < 1) threads = 1;
  if ((int64_t)threads > ndocs) threads = ndocs > 0 ? (int)ndocs : 1;
  std::vector<std::vector<TfEntry>> rows((size_t)ndocs);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    DocScratch ds;
    std::string reprbuf;
    std::vector<std::string_view> toks;
    std::unordered_map<int64_t, float> acc;
    // capped term->hash memo, the native twin of Python's
    // _TERM_HASH_MEMO (zipfian corpora re-hash the hot head ~5.5x,
    // measured); per-thread, probed with arena views
    std::unordered_map<std::string, uint64_t, SvHash, SvEq> hmemo;
    constexpr size_t kMemoCap = 1u << 17;
    while (true) {
      int64_t d = next.fetch_add(1);
      if (d >= ndocs) break;
      doc_terms(blob + doc_offs[d], blob + doc_offs[d + 1], lower, trim,
                orders_mask, ds);
      acc.clear();
      for (auto& kv : ds.counted) {
        uint64_t h;
        auto hit = hmemo.find(kv.first);
        if (hit != hmemo.end()) {
          h = hit->second;
        } else {
          // split the '\x1f'-joined key back into tokens for repr()
          toks.clear();
          std::string_view key = kv.first;
          size_t start = 0;
          while (true) {
            size_t sep = key.find('\x1f', start);
            if (sep == std::string_view::npos) {
              toks.push_back(key.substr(start));
              break;
            }
            toks.push_back(key.substr(start, sep - start));
            start = sep + 1;
          }
          py_tuple_repr(toks, reprbuf);
          h = blake2b8(
              reinterpret_cast<const uint8_t*>(reprbuf.data()), reprbuf.size());
          if (hmemo.size() < kMemoCap) hmemo.emplace(std::string(kv.first), h);
        }
        int64_t col = (int64_t)(h % (uint64_t)num_features);
        float v = (float)kv.second;
        if (log_tf) v = (float)std::log(1.0 + (double)kv.second);
        acc[col] += v;
      }
      auto& row = rows[(size_t)d];
      row.reserve(acc.size());
      for (auto& cv : acc) row.push_back({(int32_t)cv.first, cv.second});
      std::sort(row.begin(), row.end(),
                [](const TfEntry& a, const TfEntry& b) { return a.col < b.col; });
    }
  };
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  int64_t nnz = 0;
  indptr[0] = 0;
  for (int64_t d = 0; d < ndocs; d++) {
    nnz += (int64_t)rows[(size_t)d].size();
    indptr[d + 1] = nnz;
  }
  int32_t* idx = (int32_t*)malloc(sizeof(int32_t) * (size_t)(nnz > 0 ? nnz : 1));
  float* val = (float*)malloc(sizeof(float) * (size_t)(nnz > 0 ? nnz : 1));
  if (!idx || !val) { free(idx); free(val); return -4; }
  int64_t w = 0;
  for (int64_t d = 0; d < ndocs; d++)
    for (auto& e : rows[(size_t)d]) { idx[w] = e.col; val[w] = e.val; w++; }
  *out_indices = idx;
  *out_values = val;
  return 0;
}

// Streaming document-frequency accumulator (CommonSparseFeatures.fit):
// new -> update(batch)* -> topn -> free.  df counts one per doc per
// distinct term; first-seen doc index is the deterministic tie-break.
struct KsDfState {
  // term -> (count, first_doc); probed with arena views (SvHash/SvEq)
  std::unordered_map<std::string, std::pair<int64_t, int64_t>, SvHash, SvEq> df;
  int64_t docs_seen = 0;
  uint32_t orders_mask;
  int lower, trim;
};

void* ks_text_df_new(uint32_t orders_mask, int lower, int trim) {
  KsDfState* st = new KsDfState();
  st->orders_mask = orders_mask;
  st->lower = lower;
  st->trim = trim;
  return st;
}

int ks_text_df_update(void* handle, const char* blob, const int64_t* doc_offs,
                      int64_t ndocs) {
  KsDfState* st = (KsDfState*)handle;
  DocScratch ds;
  for (int64_t d = 0; d < ndocs; d++) {
    doc_terms(blob + doc_offs[d], blob + doc_offs[d + 1], st->lower, st->trim,
              st->orders_mask, ds);
    int64_t doc_id = st->docs_seen + d;
    for (auto& kv : ds.counted) {
      auto it = st->df.find(kv.first);
      if (it == st->df.end())
        st->df.emplace(std::string(kv.first),
                       std::make_pair((int64_t)1, doc_id));
      else
        it->second.first++;
    }
  }
  st->docs_seen += ndocs;
  return 0;
}

// Top-N by (-df, first_doc, term); returns the joined term keys.
int ks_text_df_topn(void* handle, int64_t top_n, char** out_terms,
                    int64_t** out_offs, int64_t** out_counts,
                    int64_t* out_n) {
  KsDfState* st = (KsDfState*)handle;
  std::vector<const std::pair<const std::string, std::pair<int64_t, int64_t>>*> items;
  items.reserve(st->df.size());
  for (auto& kv : st->df) items.push_back(&kv);
  auto cmp = [](const auto* a, const auto* b) {
    if (a->second.first != b->second.first) return a->second.first > b->second.first;
    if (a->second.second != b->second.second) return a->second.second < b->second.second;
    return a->first < b->first;
  };
  int64_t n = std::min<int64_t>(top_n, (int64_t)items.size());
  std::partial_sort(items.begin(), items.begin() + n, items.end(), cmp);
  size_t blob_len = 0;
  for (int64_t i = 0; i < n; i++) blob_len += items[i]->first.size();
  char* terms = (char*)malloc(blob_len > 0 ? blob_len : 1);
  int64_t* offs = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n + 1));
  int64_t* cnts = (int64_t*)malloc(sizeof(int64_t) * (size_t)(n > 0 ? n : 1));
  if (!terms || !offs || !cnts) { free(terms); free(offs); free(cnts); return -4; }
  size_t w = 0;
  offs[0] = 0;
  for (int64_t i = 0; i < n; i++) {
    memcpy(terms + w, items[i]->first.data(), items[i]->first.size());
    w += items[i]->first.size();
    offs[i + 1] = (int64_t)w;
    cnts[i] = items[i]->second.first;
  }
  *out_terms = terms;
  *out_offs = offs;
  *out_counts = cnts;
  *out_n = n;
  return 0;
}

void ks_text_df_free(void* handle) { delete (KsDfState*)handle; }

}  // extern "C"
