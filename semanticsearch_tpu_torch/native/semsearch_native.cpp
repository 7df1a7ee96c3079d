// Native host kernels of semanticsearch_tpu_torch, called through ctypes.
//
// The card does the products; these C++ routines keep the host from being
// the bottleneck on the string- and posting-heavy parts of a query: the
// hashing and subword tokenizers that feed the encoder, batched BM25
// scoring over CSR term statistics, the serve-time BM25 top-k over term-
// major postings (unpruned and MaxScore-pruned, threaded across queries),
// and the host side of the device BM25 leg (rare-term touch lists and the
// exact post with its certificate).
//
// The port's own copy of semanticsearch_tpu/native/semsearch_native.cpp,
// with the same entry points, contracts and results. Built on first use by
// native/__init__.py:
//     g++ -O3 -march=native -ffp-contract=off -fPIC -std=c++17 -shared
// -ffp-contract=off keeps every BM25 contribution rounded like numpy's f32
// ops, so score ties order exactly as on the numpy path.
// ABI: plain C functions; all buffers caller-allocated numpy arrays.

#include <cstdint>
#include <cstring>
#include <cctype>
#include <cmath>
#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// FNV-1a 64-bit hashing tokenizer.
//
// Tokenization contract (must match models/tokenizer.py::_TOKEN_RE):
// lowercase; tokens are maximal runs of [a-z0-9]; each token hashes to
// 3 + (fnv1a64(token) % (vocab_size - 3)); optional CLS id 1 prepended;
// output padded with 0 to max_len.
// ---------------------------------------------------------------------------

static inline uint64_t fnv1a64(const unsigned char* data, int64_t len) {
    uint64_t h = 0xCBF29CE484222325ULL;
    for (int64_t i = 0; i < len; ++i) {
        h ^= (uint64_t)data[i];
        h *= 0x100000001B3ULL;
    }
    return h;
}

// texts: UTF-8 bytes of all texts concatenated; offsets: (n_texts+1) int64
// boundaries into `texts`. Writes ids/mask as (n_texts, max_len) int32
// row-major. Non-ASCII bytes are treated as separators (the Python regex
// tokenizer only admits [a-z0-9], so behavior matches for ASCII; non-ASCII
// letters are dropped by both).
void hash_tokenize_batch(
    const unsigned char* texts,
    const int64_t* offsets,
    int64_t n_texts,
    int32_t vocab_size,
    int32_t max_len,
    int32_t add_cls,
    int32_t* ids_out,
    int32_t* mask_out) {
    const uint64_t space = (uint64_t)(vocab_size - 3);
    for (int64_t t = 0; t < n_texts; ++t) {
        const unsigned char* s = texts + offsets[t];
        const int64_t len = offsets[t + 1] - offsets[t];
        int32_t* ids = ids_out + t * max_len;
        int32_t* mask = mask_out + t * max_len;
        std::memset(ids, 0, sizeof(int32_t) * max_len);
        std::memset(mask, 0, sizeof(int32_t) * max_len);
        int32_t pos = 0;
        if (add_cls && pos < max_len) {
            ids[pos] = 1;  // CLS_ID
            mask[pos] = 1;
            ++pos;
        }
        unsigned char buf[256];
        int blen = 0;
        for (int64_t i = 0; i <= len && pos < max_len; ++i) {
            unsigned char c = (i < len) ? s[i] : (unsigned char)' ';
            if (c >= 'A' && c <= 'Z') c = (unsigned char)(c - 'A' + 'a');
            const bool ok = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
            if (ok) {
                if (blen < (int)sizeof(buf)) buf[blen++] = c;
            } else if (blen > 0) {
                const uint64_t h = fnv1a64(buf, blen);
                ids[pos] = (int32_t)(3 + (h % space));
                mask[pos] = 1;
                ++pos;
                blen = 0;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Batched BM25 Okapi scoring over CSR document term statistics.
//
// Scoring contract matches index/bm25.py::BM25Okapi.get_scores_batch:
// score(q, d) = sum_{t in q∩d} ((w_q[t]*idf[t])*(k1+1)) * quot with the
// per-entry quotient quot = tf/(tf+norm[d]) PRECOMPUTED at index build
// (index/bm25.py::_ensure_doc_quot) — one multiply-add per entry, no
// division in the inner loop. w_q[t] is the term's occurrence count in the
// query (rank_bm25 accumulates once per occurrence).
// ---------------------------------------------------------------------------

void bm25_score_batch(
    const int64_t* doc_indptr,    // (n_docs+1)
    const int32_t* doc_termids,   // (nnz) term ids (int32: vocab < 2^31)
    const float* doc_quot,        // (nnz): tf/(tf+norm[doc])
    const float* idf,             // (n_terms)
    int64_t n_docs,
    const int64_t* q_indptr,      // (n_queries+1) into q_termids
    const int64_t* q_termids,     // (q_nnz) sorted unique term ids per query
    const float* q_weights,       // (q_nnz) occurrence count per query term
    int64_t n_queries,
    float k1,
    float* scores_out) {          // (n_queries, n_docs) row-major
    std::memset(scores_out, 0, sizeof(float) * (size_t)n_queries * n_docs);
    for (int64_t d = 0; d < n_docs; ++d) {
        const int64_t s = doc_indptr[d], e = doc_indptr[d + 1];
        for (int64_t q = 0; q < n_queries; ++q) {
            const int64_t qs = q_indptr[q], qe = q_indptr[q + 1];
            // merge-join the sorted doc term list with the sorted query list
            int64_t i = s, j = qs;
            float acc = 0.0f;
            while (i < e && j < qe) {
                const int64_t td = (int64_t)doc_termids[i];
                const int64_t tq = q_termids[j];
                if (td < tq) ++i;
                else if (td > tq) ++j;
                else {
                    acc += ((q_weights[j] * idf[td]) * (k1 + 1.0f))
                           * doc_quot[i];
                    ++i; ++j;
                }
            }
            scores_out[q * n_docs + d] += acc;
        }
    }
}

// ---------------------------------------------------------------------------
// Serve-time BM25 top-k over an inverted index (term-major postings),
// threaded across queries. Matches index/bm25.py::BM25Okapi.get_topk's
// sparse-path semantics exactly: touched docs ranked by (-score, doc id);
// when fewer than k docs match, filled with the lowest ids in [0, k) not
// already selected (score 0). Per-query cost is O(sum_t df(t) +
// touched * log k), never O(n_docs).
//
// Each thread owns an acc (f32, n_docs) + seen (u8, n_docs) scratch —
// ~5 bytes * n_docs per thread; cap n_threads accordingly at 10M docs.
// ---------------------------------------------------------------------------

static void bm25_topk_range(
    const int64_t* inv_indptr, const int32_t* inv_docs, const float* inv_quot,
    const float* idf, int64_t n_docs,
    const int64_t* q_indptr, const int64_t* q_termids, const float* q_weights,
    float k1, int32_t k,
    int64_t q_begin, int64_t q_end,
    int64_t* idx_out, float* scores_out) {
    std::vector<float> acc((size_t)n_docs, 0.0f);
    std::vector<uint8_t> seen((size_t)n_docs, 0);
    std::vector<int32_t> touched;
    touched.reserve(4096);
    for (int64_t q = q_begin; q < q_end; ++q) {
        touched.clear();
        for (int64_t j = q_indptr[q]; j < q_indptr[q + 1]; ++j) {
            const int64_t t = q_termids[j];
            // bit-identical to the numpy path's evaluation order
            // ((w*idf)*(k1+1)) * quot — boundary ties must not be
            // reshuffled by ulp differences (index/bm25.py::get_topk)
            const float w = (q_weights[j] * idf[t]) * (k1 + 1.0f);
            for (int64_t p = inv_indptr[t]; p < inv_indptr[t + 1]; ++p) {
                const int32_t d = inv_docs[p];
                acc[d] += w * inv_quot[p];
                if (!seen[d]) {
                    seen[d] = 1;
                    touched.push_back(d);
                }
            }
        }
        // rank touched by (-score, doc id); touched ids are NOT sorted, so
        // the comparator breaks score ties by id explicitly
        const int64_t kk = std::min<int64_t>(k, n_docs);
        const int64_t top = std::min<int64_t>(kk, (int64_t)touched.size());
        auto by_score = [&acc](int32_t a, int32_t b) {
            if (acc[a] != acc[b]) return acc[a] > acc[b];
            return a < b;
        };
        std::partial_sort(touched.begin(), touched.begin() + top,
                          touched.end(), by_score);
        int64_t* idx = idx_out + q * k;
        float* sc = scores_out + q * k;
        int64_t pos = 0;
        for (; pos < top; ++pos) {
            idx[pos] = touched[pos];
            sc[pos] = acc[touched[pos]];
        }
        // fill with the lowest ids in [0, kk) not already selected (score 0)
        for (int64_t d = 0; pos < kk && d < n_docs; ++d) {
            bool taken = false;
            for (int64_t i = 0; i < top; ++i) {
                if (idx[i] == d) { taken = true; break; }
            }
            if (!taken) {
                idx[pos] = d;
                sc[pos] = 0.0f;
                ++pos;
            }
        }
        for (; pos < k; ++pos) {  // k > n_docs: pad deterministically
            idx[pos] = 0;
            sc[pos] = 0.0f;
        }
        for (int32_t d : touched) {
            acc[d] = 0.0f;
            seen[d] = 0;
        }
    }
}

void bm25_topk_batch(
    const int64_t* inv_indptr,    // (n_terms+1) postings boundaries
    const int32_t* inv_docs,      // (nnz) doc ids (int32: 8 B/entry with
                                  // the f32 quotient vs 12 B at int64 —
                                  // the scoring loops are memory-bound)
    const float* inv_quot,        // (nnz): tf/(tf+norm[doc])
    const float* idf,             // (n_terms)
    int64_t n_docs,
    const int64_t* q_indptr,      // (n_queries+1)
    const int64_t* q_termids,     // (q_nnz) unique term ids per query
    const float* q_weights,       // (q_nnz) occurrence counts
    int64_t n_queries,
    float k1,
    int32_t k,
    int32_t n_threads,
    int64_t* idx_out,             // (n_queries, k)
    float* scores_out) {          // (n_queries, k)
    int64_t nt = n_threads > 0 ? n_threads : 1;
    nt = std::min<int64_t>(nt, n_queries > 0 ? n_queries : 1);
    if (nt <= 1) {
        bm25_topk_range(inv_indptr, inv_docs, inv_quot, idf, n_docs,
                        q_indptr, q_termids, q_weights, k1, k,
                        0, n_queries, idx_out, scores_out);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve((size_t)nt);
    const int64_t per = (n_queries + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t b = t * per;
        const int64_t e = std::min(n_queries, b + per);
        if (b >= e) break;
        threads.emplace_back(
            bm25_topk_range, inv_indptr, inv_docs, inv_quot, idf, n_docs,
            q_indptr, q_termids, q_weights, k1, k, b, e, idx_out, scores_out);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// MaxScore-pruned BM25 top-k (Turtle & Flood document-at-a-time pruning).
//
// EXACTLY the same results as bm25_topk_batch (same ranking, tie and fill
// rules — asserted by tests/test_native.py), but skips documents that
// provably cannot enter the top-k: query terms are sorted by their maximum
// possible score contribution ub(t) = w * max_d contribution(t, d)
// (precomputed per term at invert time, index/bm25.py::_ensure_inverted);
// once the running k-th best score theta exceeds the prefix sum of the
// smallest ubs, those terms become NON-ESSENTIAL — their (huge, stopword-
// class) posting lists are never traversed, only galloped into for
// candidates surfaced by the remaining essential lists. This is what makes
// Zipf-distributed serve traffic cheap: the head terms' million-entry
// postings stop being streamed as soon as theta rises above their ub.
//
// Pruning correctness under ties: every skip condition is STRICT
// (bound < theta); candidates that could tie theta are always evaluated,
// and the heap's worst element is ordered by (score asc, doc id desc) so a
// tying lower doc id displaces a higher one — identical ordering to the
// unpruned kernel's (-score, doc id) partial sort.
//
// Negative term upper bounds (possible only when the epsilon-floored IDF
// goes negative on pathological stopword-heavy corpora) break the prefix-
// bound monotonicity, so such queries fall back to the exact unpruned
// kernel (rare; allocates its own scratch).
// ---------------------------------------------------------------------------

namespace {

struct QTerm {
    float ub;            // w * term_ub[tid]
    float wik;           // (w*idf[tid])*(k1+1); contribution = wik * quot —
                         // bit-identical to numpy's evaluation order
                         // (index/bm25.py::get_topk)
    const int32_t* docs;
    const float* quots;
    int64_t len;
    int64_t pos;
    int64_t slot;        // original sorted-by-term-id position in the query
};

// heap ordering: "a is worse than b" — worst element at the root
static inline bool heap_worse(float sa, int64_t da, float sb, int64_t db) {
    if (sa != sb) return sa < sb;
    return da > db;
}

}  // namespace

static void bm25_topk_maxscore_range(
    const int64_t* inv_indptr, const int32_t* inv_docs, const float* inv_quot,
    const float* idf, const float* term_ub, int64_t n_docs,
    const int64_t* q_indptr, const int64_t* q_termids, const float* q_weights,
    float k1, int32_t k,
    int64_t q_begin, int64_t q_end,
    int64_t* idx_out, float* scores_out) {
    const int64_t kk = std::min<int64_t>(k, n_docs);
    std::vector<QTerm> terms;
    std::vector<float> prefix;
    std::vector<float> cslots;           // per-candidate term contributions
    std::vector<float> hs((size_t)kk);   // heap scores
    std::vector<int64_t> hd((size_t)kk); // heap doc ids
    std::vector<std::pair<float, int64_t>> fin;
    for (int64_t q = q_begin; q < q_end; ++q) {
        terms.clear();
        bool neg_ub = false;
        for (int64_t j = q_indptr[q]; j < q_indptr[q + 1]; ++j) {
            const int64_t t = q_termids[j];
            const int64_t s = inv_indptr[t], e = inv_indptr[t + 1];
            if (s == e) continue;
            const float w = q_weights[j];
            const float ub = w * term_ub[t];
            if (ub < 0.0f) neg_ub = true;
            terms.push_back({ub, (w * idf[t]) * (k1 + 1.0f),
                             inv_docs + s, inv_quot + s, e - s, 0,
                             (int64_t)terms.size()});
        }
        int64_t* idx = idx_out + q * k;
        float* sc = scores_out + q * k;
        if (terms.empty() || kk == 0) {
            for (int64_t p = 0; p < k; ++p) {
                idx[p] = p < n_docs ? p : 0;
                sc[p] = 0.0f;
            }
            continue;
        }
        if (neg_ub) {
            // exact unpruned fallback for this query (own scratch; rare)
            bm25_topk_range(inv_indptr, inv_docs, inv_quot, idf, n_docs,
                            q_indptr, q_termids, q_weights, k1, k,
                            q, q + 1, idx_out, scores_out);
            continue;
        }
        std::sort(terms.begin(), terms.end(),
                  [](const QTerm& a, const QTerm& b) { return a.ub < b.ub; });
        const int64_t m = (int64_t)terms.size();
        prefix.assign((size_t)m + 1, 0.0f);
        for (int64_t i = 0; i < m; ++i) prefix[i + 1] = prefix[i] + terms[i].ub;
        cslots.assign((size_t)m, 0.0f);

        int64_t hn = 0;           // heap size
        float theta = -FLT_MAX;   // valid once hn == kk
        // Pruning threshold with slack: the running `score` accumulates in
        // pruning (ub-sorted) order while the FINAL score sums the per-term
        // slots in term-id order (bit-identical to the Python/unpruned
        // paths), and the numpy-computed ubs differ from the C++
        // contributions by ulps — strict comparisons against theta could
        // wrongly skip a boundary tie. theta_lo absorbs both (scores are
        // O(1..1e2) sums of few floats; 1e-4 relative dwarfs the error).
        float theta_lo = -FLT_MAX;
        int64_t e = 0;            // terms [0, e) are non-essential

        for (;;) {
            int64_t d = INT64_MAX;
            for (int64_t i = e; i < m; ++i) {
                if (terms[i].pos < terms[i].len) {
                    d = std::min(d, (int64_t)terms[i].docs[terms[i].pos]);
                }
            }
            if (d == INT64_MAX) break;
            float score = 0.0f;
            for (int64_t i = e; i < m; ++i) {
                QTerm& t = terms[i];
                if (t.pos < t.len && t.docs[t.pos] == d) {
                    const float c = t.wik * t.quots[t.pos];
                    cslots[(size_t)t.slot] = c;
                    score += c;
                    ++t.pos;
                }
            }
            bool viable = hn < kk || score + prefix[e] >= theta_lo;
            if (viable) {
                for (int64_t i = e - 1; i >= 0; --i) {
                    if (hn == kk && score + prefix[i + 1] < theta_lo) {
                        viable = false;
                        break;
                    }
                    QTerm& t = terms[i];
                    t.pos = std::lower_bound(t.docs + t.pos, t.docs + t.len,
                                             (int32_t)d) - t.docs;
                    if (t.pos < t.len && t.docs[t.pos] == d) {
                        const float c = t.wik * t.quots[t.pos];
                        cslots[(size_t)t.slot] = c;
                        score += c;
                        ++t.pos;
                    }
                }
            }
            if (viable) {
                // final score in term-id order: bit-identical to the
                // unpruned kernel's accumulation
                score = 0.0f;
                for (int64_t j = 0; j < m; ++j) score += cslots[(size_t)j];
                if (hn < kk) {
                    // sift up: worst bubbles toward the root
                    int64_t i = hn++;
                    hs[i] = score;
                    hd[i] = d;
                    while (i > 0) {
                        const int64_t p = (i - 1) / 2;
                        if (!heap_worse(hs[i], hd[i], hs[p], hd[p])) break;
                        std::swap(hs[i], hs[p]);
                        std::swap(hd[i], hd[p]);
                        i = p;
                    }
                    if (hn == kk) {
                        theta = hs[0];
                        theta_lo = theta - (1e-4f * std::fabs(theta) + 1e-6f);
                    }
                } else if (heap_worse(hs[0], hd[0], score, d)) {
                    // replace the worst, sift down
                    hs[0] = score;
                    hd[0] = d;
                    int64_t i = 0;
                    for (;;) {
                        const int64_t l = 2 * i + 1, r = l + 1;
                        int64_t w2 = i;
                        if (l < kk && heap_worse(hs[l], hd[l], hs[w2], hd[w2]))
                            w2 = l;
                        if (r < kk && heap_worse(hs[r], hd[r], hs[w2], hd[w2]))
                            w2 = r;
                        if (w2 == i) break;
                        std::swap(hs[i], hs[w2]);
                        std::swap(hd[i], hd[w2]);
                        i = w2;
                    }
                    theta = hs[0];
                    theta_lo = theta - (1e-4f * std::fabs(theta) + 1e-6f);
                }
                // advance the essential boundary as theta rises
                while (e < m && hn == kk && prefix[e + 1] < theta_lo) ++e;
            }
            for (int64_t j = 0; j < m; ++j) cslots[(size_t)j] = 0.0f;
        }
        // emit: heap -> (-score, doc id) order, then the unpruned kernel's
        // lowest-id zero-score fill
        fin.clear();
        for (int64_t i = 0; i < hn; ++i) fin.emplace_back(hs[i], hd[i]);
        std::sort(fin.begin(), fin.end(),
                  [](const std::pair<float, int64_t>& a,
                     const std::pair<float, int64_t>& b) {
                      if (a.first != b.first) return a.first > b.first;
                      return a.second < b.second;
                  });
        int64_t pos = 0;
        for (; pos < hn; ++pos) {
            idx[pos] = fin[(size_t)pos].second;
            sc[pos] = fin[(size_t)pos].first;
        }
        for (int64_t dd = 0; pos < kk && dd < n_docs; ++dd) {
            bool taken = false;
            for (int64_t i = 0; i < hn; ++i) {
                if (idx[i] == dd) { taken = true; break; }
            }
            if (!taken) {
                idx[pos] = dd;
                sc[pos] = 0.0f;
                ++pos;
            }
        }
        for (; pos < k; ++pos) {
            idx[pos] = 0;
            sc[pos] = 0.0f;
        }
    }
}

void bm25_topk_maxscore_batch(
    const int64_t* inv_indptr, const int32_t* inv_docs, const float* inv_quot,
    const float* idf,
    const float* term_ub,         // (n_terms) max possible contribution
    int64_t n_docs,
    const int64_t* q_indptr, const int64_t* q_termids, const float* q_weights,
    int64_t n_queries, float k1, int32_t k, int32_t n_threads,
    int64_t* idx_out, float* scores_out) {
    int64_t nt = n_threads > 0 ? n_threads : 1;
    nt = std::min<int64_t>(nt, n_queries > 0 ? n_queries : 1);
    if (nt <= 1) {
        bm25_topk_maxscore_range(
            inv_indptr, inv_docs, inv_quot, idf, term_ub, n_docs,
            q_indptr, q_termids, q_weights, k1, k, 0, n_queries,
            idx_out, scores_out);
        return;
    }
    std::vector<std::thread> threads;
    threads.reserve((size_t)nt);
    const int64_t per = (n_queries + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
        const int64_t b = t * per;
        const int64_t e = std::min(n_queries, b + per);
        if (b >= e) break;
        threads.emplace_back(
            bm25_topk_maxscore_range, inv_indptr, inv_docs, inv_quot, idf,
            term_ub, n_docs, q_indptr, q_termids, q_weights, k1, k,
            b, e, idx_out, scores_out);
    }
    for (auto& th : threads) th.join();
}

// ---------------------------------------------------------------------------
// Subword (WordPiece greedy longest-match) tokenizer over a trained vocab.
//
// Contract matches models/subword.py::SubwordTokenizer.encode_batch
// bit-for-bit: lowercase, words are maximal [a-z0-9] runs, each word
// decomposes by greedy longest-match (window <= 20 chars) against the piece
// table; continuation pieces carry a "##" prefix; a word with an unmatched
// position becomes one UNK (id 2). CLS id 1 optionally prepended; pad 0.
//
// The piece table arrives flattened (blob + offsets + ids); an
// open-addressing hash table over the piece bytes is built per call
// (microseconds at 8-32k pieces vs millisecond-scale batch encodes).
// ---------------------------------------------------------------------------

namespace {

struct PieceTable {
    // open addressing, power-of-two capacity, empty slot = -1
    std::vector<int64_t> slot_piece;  // index into offsets/ids
    uint64_t mask;
    const unsigned char* blob;
    const int64_t* offsets;
    const int32_t* ids;

    static uint64_t hash_bytes(const unsigned char* d, int64_t len,
                               uint64_t h = 0xCBF29CE484222325ULL) {
        for (int64_t i = 0; i < len; ++i) {
            h ^= (uint64_t)d[i];
            h *= 0x100000001B3ULL;
        }
        return h;
    }

    void build(const unsigned char* blob_, const int64_t* offsets_,
               const int32_t* ids_, int64_t n_pieces) {
        blob = blob_;
        offsets = offsets_;
        ids = ids_;
        uint64_t cap = 16;
        while (cap < (uint64_t)n_pieces * 4) cap <<= 1;
        mask = cap - 1;
        slot_piece.assign(cap, -1);
        for (int64_t p = 0; p < n_pieces; ++p) {
            const int64_t len = offsets[p + 1] - offsets[p];
            uint64_t s = hash_bytes(blob + offsets[p], len) & mask;
            while (slot_piece[s] != -1) s = (s + 1) & mask;
            slot_piece[s] = p;
        }
    }

    // look up (##-prefix if cont) + word[b..e); -1 if absent
    int32_t find(const unsigned char* word, int64_t b, int64_t e,
                 bool cont) const {
        static const unsigned char HH[2] = {'#', '#'};
        uint64_t h = 0xCBF29CE484222325ULL;
        if (cont) h = hash_bytes(HH, 2, h);
        h = hash_bytes(word + b, e - b, h);
        const int64_t want_len = (e - b) + (cont ? 2 : 0);
        uint64_t s = h & mask;
        while (slot_piece[s] != -1) {
            const int64_t p = slot_piece[s];
            const int64_t len = offsets[p + 1] - offsets[p];
            if (len == want_len) {
                const unsigned char* pb = blob + offsets[p];
                bool eq = true;
                if (cont) eq = pb[0] == '#' && pb[1] == '#';
                if (eq && std::memcmp(pb + (cont ? 2 : 0), word + b,
                                      (size_t)(e - b)) == 0)
                    return ids[p];
            }
            s = (s + 1) & mask;
        }
        return -1;
    }
};

constexpr int kMaxPieceChars = 20;  // models/subword.py::_MAX_PIECE_CHARS

// emit a word's pieces into ids/mask at *pos; greedy longest-match
inline void emit_word(const PieceTable& table, const unsigned char* buf,
                      int blen, int32_t max_len, int32_t* ids, int32_t* mask,
                      int32_t* pos) {
    int32_t tmp[256];
    int n_out = 0;
    int64_t p = 0;
    bool unk = false;
    while (p < blen) {
        int64_t e = std::min<int64_t>(blen, p + kMaxPieceChars);
        int32_t id = -1;
        for (; e > p; --e) {
            id = table.find(buf, p, e, p > 0);
            if (id >= 0) break;
        }
        if (id < 0) {
            unk = true;
            break;
        }
        if (n_out < (int)(sizeof(tmp) / sizeof(tmp[0]))) tmp[n_out++] = id;
        p = e;
    }
    if (unk) {
        tmp[0] = 2;  // UNK_ID
        n_out = 1;
    }
    for (int i = 0; i < n_out && *pos < max_len; ++i) {
        ids[*pos] = tmp[i];
        mask[*pos] = 1;
        ++(*pos);
    }
}

}  // namespace

void subword_tokenize_batch(
    const unsigned char* texts,
    const int64_t* text_offsets,
    int64_t n_texts,
    const unsigned char* piece_blob,
    const int64_t* piece_offsets,
    const int32_t* piece_ids,
    int64_t n_pieces,
    int32_t max_len,
    int32_t add_cls,
    int32_t* ids_out,
    int32_t* mask_out) {
    PieceTable table;
    table.build(piece_blob, piece_offsets, piece_ids, n_pieces);
    for (int64_t t = 0; t < n_texts; ++t) {
        const unsigned char* s = texts + text_offsets[t];
        const int64_t len = text_offsets[t + 1] - text_offsets[t];
        int32_t* ids = ids_out + t * max_len;
        int32_t* mask = mask_out + t * max_len;
        std::memset(ids, 0, sizeof(int32_t) * max_len);
        std::memset(mask, 0, sizeof(int32_t) * max_len);
        int32_t pos = 0;
        if (add_cls && pos < max_len) {
            ids[pos] = 1;  // CLS_ID
            mask[pos] = 1;
            ++pos;
        }
        unsigned char buf[256];
        int blen = 0;
        for (int64_t i = 0; i <= len && pos < max_len; ++i) {
            unsigned char c = (i < len) ? s[i] : (unsigned char)' ';
            if (c >= 'A' && c <= 'Z') c = (unsigned char)(c - 'A' + 'a');
            const bool ok = (c >= 'a' && c <= 'z') || (c >= '0' && c <= '9');
            if (ok) {
                if (blen < (int)sizeof(buf)) buf[blen++] = c;
            } else if (blen > 0) {
                emit_word(table, buf, blen, max_len, ids, mask, &pos);
                blen = 0;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Device-BM25 host side (index/bm25_tpu.py): rare-term touch lists and the
// post-matmul certification pass. The card scores the frequent terms' dense
// int8 matrix; these routines keep the per-query host work out of
// numpy-call overhead (DeviceBM25's numpy post does the same ops and is
// kept as the plain version the tests hold these against).
// ---------------------------------------------------------------------------

namespace devbm25 {

// exact score of one query against one doc via the inverted index, f32 ops
// in ascending-term order — matches BM25Okapi.get_topk bit-for-bit
// (same factored ((w*idf)*(k1+1))*quot contraction; build with
// -ffp-contract=off).
static inline float exact_score(
    const int64_t* inv_indptr, const int32_t* inv_docs, const float* inv_quot,
    const float* idf, float k1p1,
    const int64_t* q_tids, const float* q_w, int64_t nq_terms, int64_t doc) {
    float acc = 0.0f;
    for (int64_t j = 0; j < nq_terms; ++j) {
        const int64_t t = q_tids[j];
        const int64_t s = inv_indptr[t], e = inv_indptr[t + 1];
        // binary search doc in inv_docs[s:e] (ascending)
        int64_t lo = s, hi = e;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (inv_docs[mid] < doc) lo = mid + 1; else hi = mid;
        }
        if (lo < e && inv_docs[lo] == doc) {
            acc += ((q_w[j] * idf[t]) * k1p1) * inv_quot[lo];
        }
    }
    return acc;
}

struct Cand {
    int64_t doc;
    float ub;      // approx + err_ub
    float exact;   // filled on rescore
    bool rescored;
};

}  // namespace devbm25

// Phase 1: rare-touched docs per query. For query q, accumulate the exact
// rare-term contribution per touched doc. Outputs CSR: caller allocates
// out_docs/out_scores with capacity = sum of rare-term dfs (upper bound);
// out_indptr (n_queries+1) receives the per-query unique-doc counts.
// Touched docs are emitted in ASCENDING doc order.
void bm25_rare_touch(
    const int64_t* inv_indptr, const int32_t* inv_docs, const float* inv_quot,
    const float* idf, float k1,
    const int64_t* r_indptr,   // (Q+1) into r_tids/r_w
    const int64_t* r_tids, const float* r_w,
    int64_t n_queries,
    int64_t* out_indptr, int32_t* out_docs, float* out_scores) {
    const float k1p1 = k1 + 1.0f;
    out_indptr[0] = 0;
    std::vector<std::pair<int32_t, float>> merged;
    for (int64_t q = 0; q < n_queries; ++q) {
        merged.clear();
        for (int64_t j = r_indptr[q]; j < r_indptr[q + 1]; ++j) {
            const int64_t t = r_tids[j];
            const float base = (r_w[j] * idf[t]) * k1p1;
            for (int64_t p = inv_indptr[t]; p < inv_indptr[t + 1]; ++p) {
                merged.emplace_back(inv_docs[p], base * inv_quot[p]);
            }
        }
        std::sort(merged.begin(), merged.end(),
                  [](const auto& a, const auto& b) {
                      return a.first < b.first;
                  });
        int64_t w = out_indptr[q];
        for (size_t i = 0; i < merged.size();) {
            const int32_t d = merged[i].first;
            float acc = 0.0f;
            while (i < merged.size() && merged[i].first == d) {
                acc += merged[i].second;
                ++i;
            }
            out_docs[w] = d;
            out_scores[w] = acc;
            ++w;
        }
        out_indptr[q + 1] = w;
    }
}

// Phase 2: candidate merge + exact rescore + certification, per query.
// Inputs: device top-K' (vals/idx) of the FREQUENT-term int8 matmul, the
// rare-touched docs (their exact rare scores), full query terms (ascending
// tid), and the error bound. Touched docs get a fully EXACT score up front
// (their frequent part recomputed here via the inverted index — a handful
// of binary searches — rather than gathered from the device score matrix,
// which costs random-access device reads). Outputs exact top-k
// (idx/scores) or fallback_flags[q]=1 when the certificate fails / fewer
// than k positive matches (the caller resolves those with the host top-k).
void bm25_device_post(
    const int64_t* inv_indptr, const int32_t* inv_docs, const float* inv_quot,
    const float* idf, float k1,
    const float* vals, const int64_t* idx, int32_t kp,    // (Q, K')
    const int64_t* touch_indptr, const int32_t* touch_docs,
    const int64_t* q_indptr, const int64_t* q_tids, const float* q_w,
    const float* err_ub,
    int64_t n_queries, int64_t n_docs, int32_t k,
    int64_t* idx_out, float* sc_out, uint8_t* fallback_flags) {
    const float k1p1 = k1 + 1.0f;
    std::vector<devbm25::Cand> cands;
    for (int64_t q = 0; q < n_queries; ++q) {
        fallback_flags[q] = 0;
        const int64_t ts = touch_indptr[q], te = touch_indptr[q + 1];
        cands.clear();
        cands.reserve((size_t)kp + (size_t)(te - ts));
        // touched docs: EXACT score immediately (ub == exact, no error)
        for (int64_t i = ts; i < te; ++i) {
            const float ex = devbm25::exact_score(
                inv_indptr, inv_docs, inv_quot, idf, k1p1,
                q_tids + q_indptr[q], q_w + q_indptr[q],
                q_indptr[q + 1] - q_indptr[q], touch_docs[i]);
            cands.push_back({(int64_t)touch_docs[i], ex, ex, true});
        }
        // device top-K': approx = vals (+ rare part if also touched).
        // PAD-COLUMN ids (>= n_docs) can appear when fewer than K' docs
        // have positive approx scores (pads score exactly 0.0 pre-mask);
        // they are not documents — skip them, and remember that a pad's
        // presence proves every real doc with approx > 0 is already a
        // candidate (so any non-candidate's approx is <= 0).
        bool pads_selected = false;
        for (int32_t i = 0; i < kp; ++i) {
            const int64_t d = idx[q * kp + i];
            if (d < 0 || d >= n_docs) { pads_selected = true; continue; }
            // binary search d among this query's touched docs (ascending)
            int64_t lo = ts, hi = te;
            while (lo < hi) {
                const int64_t mid = (lo + hi) >> 1;
                if (touch_docs[mid] < d) lo = mid + 1; else hi = mid;
            }
            if (lo < te && touch_docs[lo] == d) continue;  // already added
            cands.push_back({d, vals[q * kp + i] + err_ub[q], 0.0f, false});
        }
        // v_out: any doc outside the pool scores at most v_K' + err; with
        // pads selected, the masked -inf in vals[K'-1] would make the
        // certificate vacuously true — the sound outside-pool approx bound
        // is 0.0 there
        const float v_last = pads_selected ? 0.0f
            : vals[q * kp + (kp - 1)];
        const float v_out = ((int64_t)cands.size() < n_docs)
            ? v_last + err_ub[q]
            : -FLT_MAX;
        // sort by ub desc, doc asc
        std::sort(cands.begin(), cands.end(),
                  [](const devbm25::Cand& a, const devbm25::Cand& b) {
                      if (a.ub != b.ub) return a.ub > b.ub;
                      return a.doc < b.doc;
                  });
        const int64_t n_cand = (int64_t)cands.size();
        int64_t n_rescore = std::min<int64_t>(n_cand, (int64_t)k + 8);
        bool certified = false;
        // indices of rescored candidates ordered by (exact desc, doc asc)
        std::vector<int64_t> order;
        while (true) {
            for (int64_t i = 0; i < n_rescore; ++i) {
                if (!cands[i].rescored) {
                    cands[i].exact = devbm25::exact_score(
                        inv_indptr, inv_docs, inv_quot, idf, k1p1,
                        q_tids + q_indptr[q], q_w + q_indptr[q],
                        q_indptr[q + 1] - q_indptr[q], cands[i].doc);
                    cands[i].rescored = true;
                }
            }
            order.resize((size_t)n_rescore);
            for (int64_t i = 0; i < n_rescore; ++i) order[i] = i;
            std::sort(order.begin(), order.end(),
                      [&](int64_t a, int64_t b) {
                          if (cands[a].exact != cands[b].exact)
                              return cands[a].exact > cands[b].exact;
                          return cands[a].doc < cands[b].doc;
                      });
            const float kth = (n_rescore >= k)
                ? cands[order[k - 1]].exact : -FLT_MAX;
            float max_out = v_out;
            if (n_rescore < n_cand) {
                max_out = std::max(max_out, cands[n_rescore].ub);
            }
            if (max_out < kth || n_rescore >= n_cand) {
                certified = max_out < kth;
                break;
            }
            n_rescore = std::min(n_cand, n_rescore * 2);
        }
        const float kth_val = (n_rescore >= k && k > 0)
            ? cands[order[k - 1]].exact : 0.0f;
        if (!certified || n_rescore < k || kth_val <= 0.0f) {
            fallback_flags[q] = 1;
            continue;
        }
        for (int32_t i = 0; i < k; ++i) {
            idx_out[q * k + i] = cands[order[i]].doc;
            sc_out[q * k + i] = cands[order[i]].exact;
        }
    }
}

int32_t semsearch_native_abi_version() { return 9; }

}  // extern "C"
