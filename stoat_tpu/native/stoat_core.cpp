// stoat-tpu native core: streaming VCF -> bit-packed edge×haplotype matrix.
//
// A replacement for the reference's htslib ingestion loop
// (SnarlAnalyzer::make_edge_matrix, /root/reference/src/snarl_analyzer.cpp:
// 190-260) and the packed bit matrix (src/matrix.{hpp,cpp}).  Written from
// scratch in C++17: parses VCF text (plain or gzip via zlib), extracts the
// INFO AT allele traversals and diploid GTs, interns graph edges as rows,
// and fills a bit-packed uint32 edge×haplotype word matrix one chromosome
// at a time — the exact layout the device membership kernels consume
// (stoat_tpu/pipeline/packed.py: 32 haplotypes/word, little bit order,
// plus a trailing all-ones AND-identity row).  Exposed through a plain C
// ABI consumed from Python via ctypes.
//
// Pipelined + parallel (the reference is single-threaded by default,
// main.cpp:62; this is where our end-to-end throughput comes from):
//   - a producer thread reads 4 MB blocks (fread for plain files, zlib for
//     .gz) and splits lines in place — no per-line copies,
//   - worker threads parse a block's records concurrently into per-worker
//     arenas (AT edge keys + per-allele carrier bit masks built straight
//     from the GT fields — the dense calls array never exists),
//   - a short serial pass interns edge rows in deterministic record/allele
//     order (only alleles with at least one carrier get rows, matching
//     push_matrix semantics, matrix.cpp:40-51) and ORs each allele's
//     carrier mask into its rows' words.
// Output is identical for any thread count (row order is deterministic).
//
// Semantics mirrored from the reference:
//   - records with INFO LV present and != 0 are skipped (nested variants;
//     snarl_analyzer.cpp:199-208)
//   - missing genotype alleles ('.') contribute nothing (:242-252)
//   - every edge of a called allele's traversal is set in the haplotype
//     column 2*i / 2*i+1
//
// Thread count: STOAT_THREADS env var, default hardware_concurrency.
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread stoat_core.cpp -lz

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

#if defined(__GLIBC__)
#include <malloc.h>
// Keep freed block buffers in the heap instead of returning them to the
// kernel: the streaming reader allocates/frees a 4 MB batch per block and
// multi-MB word matrices per chromosome, and the default mmap/trim
// thresholds turn that into a page-fault storm (~12 ms/chromosome of sys
// time at the 8k-snarl test scale — measured, it doubled ingest time).
__attribute__((constructor)) static void stoat_tune_malloc() {
    mallopt(M_MMAP_THRESHOLD, 1 << 30);
    mallopt(M_TRIM_THRESHOLD, 1 << 30);
}
#endif

namespace {

// Phase profiling (STOAT_PROFILE=1): nanoseconds per pipeline stage.
// The counters are process-global but snapshotted per Reader at open and
// diffed at close, so each close dumps that reader's own phases.
std::atomic<uint64_t> g_ns_read{0}, g_ns_parse{0}, g_ns_intern{0};

static bool profile_enabled() {
    static const bool v = [] {
        const char* e = getenv("STOAT_PROFILE");
        return e && e[0] == '1';
    }();
    return v;
}

static inline uint64_t now_ns() {
    return uint64_t(std::chrono::duration_cast<std::chrono::nanoseconds>(
        std::chrono::steady_clock::now().time_since_epoch()).count());
}

struct EdgeKey {
    uint64_t a, b;      // node ids
    uint8_t arev, brev; // orientations
    bool operator==(const EdgeKey& o) const {
        return a == o.a && b == o.b && arev == o.arev && brev == o.brev;
    }
};

static unsigned num_threads() {
    const char* env = getenv("STOAT_THREADS");
    if (env) {
        int v = atoi(env);
        if (v >= 1) return unsigned(v);
    }
    unsigned hw = std::thread::hardware_concurrency();
    return hw ? (hw > 16 ? 16 : hw) : 1;
}

// ---------------------------------------------------------------------------
// Block reading (plain fread or zlib, detected by magic)

struct BlockSource {
    FILE* f = nullptr;
    gzFile gz = nullptr;

    bool open(const char* path) {
        FILE* probe = fopen(path, "rb");
        if (!probe) return false;
        unsigned char magic[2] = {0, 0};
        size_t got = fread(magic, 1, 2, probe);
        if (got == 2 && magic[0] == 0x1f && magic[1] == 0x8b) {
            fclose(probe);
            gz = gzopen(path, "rb");
            if (gz) gzbuffer(gz, 1 << 22);
            return gz != nullptr;
        }
        rewind(probe);
        f = probe;
        return true;
    }
    // Returns bytes read (0 at EOF); a stream ERROR (corrupt/truncated
    // gzip, I/O failure) sets ``err`` instead of masquerading as EOF —
    // a silently partial matrix means silently wrong p-values.
    bool err = false;
    size_t read(char* dst, size_t n) {
        if (f) {
            size_t got = fread(dst, 1, n, f);
            if (got < n && ferror(f)) err = true;
            return got;
        }
        int got = gzread(gz, dst, unsigned(n));
        if (got < 0) {
            err = true;
            return 0;
        }
        if (got == 0) {
            // a truncated stream surfaces as got==0 with Z_BUF_ERROR
            // (-5, "unexpected end of file") rather than -1 (measured)
            int errnum = 0;
            gzerror(gz, &errnum);
            if (errnum != Z_OK && errnum != Z_STREAM_END) err = true;
        }
        return size_t(got);
    }
    void close() {
        if (f) fclose(f);
        if (gz) gzclose(gz);
        f = nullptr;
        gz = nullptr;
    }
};

// A block of complete lines, NUL-terminated in place.  The text buffer
// is raw malloc'd storage grown without value-initialization: a
// std::vector would memset 4 MB per block that fread immediately
// overwrites.  Batches recycle through a free list (BatchQueue::recycle)
// so a long VCF touches the same few buffers instead of faulting fresh
// pages every block.
struct Batch {
    char* text = nullptr;
    size_t cap = 0;
    size_t len = 0;
    std::vector<uint32_t> offs;  // start of each data line in text

    ~Batch() { free(text); }
    void ensure(size_t n) {
        if (cap < n) {
            free(text);
            text = (char*)malloc(n);
            cap = n;
        }
    }
    size_t n_lines() const { return offs.size(); }
    const char* line(size_t i) const { return text + offs[i]; }
    char* line_mut(size_t i) { return text + offs[i]; }
};

constexpr size_t kBlockBytes = 4u << 20;
constexpr size_t kQueueDepth = 3;

struct BatchQueue {
    std::deque<Batch*> q;
    std::vector<Batch*> freelist;
    std::mutex mu;
    std::condition_variable cv_push, cv_pop;
    bool done = false;
    std::atomic<bool> stop{false};

    Batch* acquire() {
        std::lock_guard<std::mutex> lk(mu);
        if (freelist.empty()) return new Batch();
        Batch* b = freelist.back();
        freelist.pop_back();
        b->offs.clear();
        b->len = 0;
        return b;
    }
    void recycle(Batch* b) {
        std::lock_guard<std::mutex> lk(mu);
        if (freelist.size() >= kQueueDepth + 2) delete b;
        else freelist.push_back(b);
    }
    void push(Batch* b) {
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return q.size() < kQueueDepth ||
                                       stop.load(); });
        if (stop.load()) { delete b; return; }
        q.push_back(b);
        cv_pop.notify_one();
    }
    void finish() {
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        cv_pop.notify_all();
    }
    Batch* pop() {
        std::unique_lock<std::mutex> lk(mu);
        cv_pop.wait(lk, [&] { return !q.empty() || done; });
        if (q.empty()) return nullptr;
        Batch* b = q.front();
        q.pop_front();
        cv_push.notify_one();
        return b;
    }
    void shutdown() {
        {
            // stop must flip UNDER the mutex: a producer that has just
            // evaluated push()'s wait predicate but not yet blocked
            // would otherwise miss the notify forever (lost wakeup ->
            // stoat_vcf_close hangs in producer.join())
            std::lock_guard<std::mutex> lk(mu);
            stop.store(true);
            for (Batch* b : q) delete b;
            q.clear();
            for (Batch* b : freelist) delete b;
            freelist.clear();
        }
        cv_push.notify_all();
        cv_pop.notify_all();
    }
};

// ---------------------------------------------------------------------------
// Record parsing into per-worker arenas (no shared state, no per-record
// allocations in steady state)

static void parse_traversal_keys(const char* s, const char* end,
                                 std::vector<EdgeKey>& out) {
    uint64_t prev_id = 0;
    uint8_t prev_rev = 0;
    bool have_prev = false;
    const char* p = s;
    while (p < end) {
        char c = *p;
        if (c == '>' || c == '<') {
            uint8_t rev = (c == '<');
            ++p;
            uint64_t id = 0;
            while (p < end && *p >= '0' && *p <= '9') {
                id = id * 10 + uint64_t(*p - '0');
                ++p;
            }
            if (have_prev) out.push_back({prev_id, id, prev_rev, rev});
            prev_id = id;
            prev_rev = rev;
            have_prev = true;
        } else {
            ++p;
        }
    }
}

static bool info_field(const char* info, const char* info_end,
                       const char* key, const char** val,
                       const char** val_end) {
    size_t klen = strlen(key);
    const char* p = info;
    while (p < info_end) {
        const char* seg_end = (const char*)memchr(p, ';', info_end - p);
        if (!seg_end) seg_end = info_end;
        if (size_t(seg_end - p) > klen && memcmp(p, key, klen) == 0 &&
            p[klen] == '=') {
            *val = p + klen + 1;
            *val_end = seg_end;
            return true;
        }
        p = seg_end + 1;
    }
    return false;
}

static int parse_allele(const char* p, const char* end) {
    if (p >= end || *p == '.') return -1;
    int v = 0;
    bool any = false;
    while (p < end && *p >= '0' && *p <= '9') {
        v = v * 10 + (*p - '0');
        ++p;
        any = true;
    }
    return any ? v : -1;
}

// Per-record metadata into flat arena storage.
struct RecMeta {
    uint8_t ok = 0;               // has AT and LV==0
    uint16_t n_alleles = 0;
    uint32_t edge_off = 0;        // into Arena::edge_keys
    uint32_t edge_cnt_off = 0;    // into Arena::allele_edge_cnt (n_alleles)
    uint32_t mask_off = 0;        // into Arena::masks (n_alleles * W words)
};

struct Arena {
    std::vector<EdgeKey> edge_keys;
    std::vector<uint32_t> allele_edge_cnt;
    std::vector<uint32_t> masks;
    std::vector<RecMeta> recs;

    void begin(size_t n_recs) {
        edge_keys.clear();
        allele_edge_cnt.clear();
        masks.clear();
        recs.clear();
        recs.resize(n_recs);
    }
};

// Parse one data line into arena slot `ri` (mutates the line in place).
static void parse_line(char* line, size_t n_samples, Arena& ar, size_t ri,
                       size_t W) {
    RecMeta& rm = ar.recs[ri];
    // fields: CHROM POS ID REF ALT QUAL FILTER INFO FORMAT samples...
    char* fields[9];
    char* p = line;
    for (int i = 0; i < 9; ++i) {
        fields[i] = p;
        char* t = strchr(p, '\t');
        if (!t) {
            if (i < 8) return;
            p = p + strlen(p);
            break;
        }
        *t = '\0';
        p = t + 1;
    }
    const char* info = fields[7];
    const char* info_end = info + strlen(info);

    const char *lv, *lv_end;
    if (info_field(info, info_end, "LV", &lv, &lv_end)) {
        int v = atoi(std::string(lv, lv_end).c_str());
        if (v != 0) return;  // nested variant: skip
    }
    const char *at, *at_end;
    if (!info_field(info, info_end, "AT", &at, &at_end)) return;

    rm.edge_off = uint32_t(ar.edge_keys.size());
    rm.edge_cnt_off = uint32_t(ar.allele_edge_cnt.size());
    const char* a = at;
    uint32_t n_alleles = 0;
    while (a < at_end) {
        const char* seg_end = (const char*)memchr(a, ',', at_end - a);
        if (!seg_end) seg_end = at_end;
        size_t before = ar.edge_keys.size();
        parse_traversal_keys(a, seg_end, ar.edge_keys);
        ar.allele_edge_cnt.push_back(
            uint32_t(ar.edge_keys.size() - before));
        ++n_alleles;
        a = seg_end + 1;
    }
    rm.n_alleles = uint16_t(n_alleles);
    rm.mask_off = uint32_t(ar.masks.size());
    ar.masks.resize(ar.masks.size() + size_t(n_alleles) * W, 0);
    uint32_t* masks = ar.masks.data() + rm.mask_off;

    auto set_bit = [&](int al, uint32_t col) {
        if (al >= 0 && uint32_t(al) < n_alleles)
            masks[size_t(al) * W + (col >> 5)] |= 1u << (col & 31);
    };

    size_t si = 0;
    while (*p != '\0' && si < n_samples) {
        // fast path: single-digit diploid "a/b<TAB>"
        if (p[0] >= '0' && p[0] <= '9' && (p[1] == '/' || p[1] == '|') &&
            p[2] >= '0' && p[2] <= '9' &&
            (p[3] == '\t' || p[3] == '\0')) {
            set_bit(p[0] - '0', uint32_t(2 * si));
            set_bit(p[2] - '0', uint32_t(2 * si + 1));
            ++si;
            if (p[3] == '\0') break;
            p += 4;
            continue;
        }
        char* t = strchr(p, '\t');
        char* fend = t ? t : p + strlen(p);
        char* colon = (char*)memchr(p, ':', fend - p);
        char* gt_end = colon ? colon : fend;
        char* sep = nullptr;
        for (char* q = p; q < gt_end; ++q) {
            if (*q == '/' || *q == '|') {
                sep = q;
                break;
            }
        }
        if (sep) {
            set_bit(parse_allele(p, sep), uint32_t(2 * si));
            set_bit(parse_allele(sep + 1, gt_end), uint32_t(2 * si + 1));
        } else {
            set_bit(parse_allele(p, gt_end), uint32_t(2 * si));
        }
        ++si;
        if (!t) break;
        p = t + 1;
    }
    rm.ok = 1;
}

// ---------------------------------------------------------------------------
// Matrix builder (word rows; intern + mask-OR fill in one serial pass)

// Open-addressed (linear probe) edge→row table: the intern loop is the
// serial section of ingestion and std::unordered_map's chained nodes
// were its hottest cache misses.  Keys are the two oriented node handles
// packed (id<<1|rev); emptiness is tracked in val (row+1, 0 = empty).
struct EdgeSlot {
    uint64_t ka, kb;
    uint32_t val;
};

static inline uint64_t mix64(uint64_t x) {
    x ^= x >> 30;
    x *= 0xbf58476d1ce4e5b9ULL;
    x ^= x >> 27;
    x *= 0x94d049bb133111ebULL;
    x ^= x >> 31;
    return x;
}

struct EdgeTable {
    std::vector<EdgeSlot> slots;
    size_t mask = 0;
    size_t count = 0;

    void reset(size_t cap_hint) {
        size_t c = 64;
        while (c < cap_hint * 2) c *= 2;
        slots.assign(c, EdgeSlot{0, 0, 0});
        mask = c - 1;
        count = 0;
    }

    void grow() {
        std::vector<EdgeSlot> old = std::move(slots);
        slots.assign(old.size() * 2, EdgeSlot{0, 0, 0});
        mask = slots.size() - 1;
        for (const EdgeSlot& s : old) {
            if (!s.val) continue;
            size_t i = (mix64(s.ka) ^ mix64(s.kb + 1)) & mask;
            while (slots[i].val) i = (i + 1) & mask;
            slots[i] = s;
        }
    }

    // Find-only lookup: returns row or UINT32_MAX when absent.
    uint32_t find(uint64_t ka, uint64_t kb) const {
        if (slots.empty()) return UINT32_MAX;
        size_t i = (mix64(ka) ^ mix64(kb + 1)) & mask;
        for (;;) {
            const EdgeSlot& s = slots[i];
            if (!s.val) return UINT32_MAX;
            if (s.ka == ka && s.kb == kb) return s.val - 1;
            i = (i + 1) & mask;
        }
    }

    // Returns row for (ka, kb); `added` set when newly interned.
    uint32_t get_or_add(uint64_t ka, uint64_t kb, bool& added) {
        size_t i = (mix64(ka) ^ mix64(kb + 1)) & mask;
        for (;;) {
            EdgeSlot& s = slots[i];
            if (!s.val) {
                s.ka = ka;
                s.kb = kb;
                s.val = uint32_t(count) + 1;
                ++count;
                added = true;
                if (count * 4 > slots.size() * 3) grow();
                return uint32_t(count) - 1;
            }
            if (s.ka == ka && s.kb == kb) {
                added = false;
                return s.val - 1;
            }
            i = (i + 1) & mask;
        }
    }
};

struct MatrixBuilder {
    EdgeTable table;
    std::vector<uint32_t> data;  // row-major [cap_rows, W]
    std::vector<uint64_t> edges;
    size_t W = 0;
    uint64_t cap_rows = 0;

    size_t n_rows() const { return table.count; }

    void reset(size_t n_words, uint64_t initial_rows) {
        uint64_t want = initial_rows < 64 ? 64 : initial_rows;
        // keep capacity grown by earlier chromosomes: assign() reuses the
        // allocation, avoiding the doubling realloc+copy chain per chunk
        if (W == n_words && cap_rows > want) want = cap_rows;
        table.reset(size_t(want));
        edges.clear();
        W = n_words;
        cap_rows = want;
        data.assign(cap_rows * W, 0);
    }

    uint32_t intern(const EdgeKey& k) {
        bool added = false;
        uint32_t row = table.get_or_add((k.a << 1) | k.arev,
                                        (k.b << 1) | k.brev, added);
        if (added) {
            if (row >= cap_rows) {
                uint64_t new_cap = cap_rows * 2;
                data.resize(new_cap * W, 0);
                cap_rows = new_cap;
            }
            edges.push_back(k.a);
            edges.push_back(k.arev);
            edges.push_back(k.b);
            edges.push_back(k.brev);
        }
        return row;
    }
};

// Serial pass over one worker arena range: intern rows in deterministic
// record/allele/edge order, OR each allele's carrier mask into its rows.
static void intern_and_fill(MatrixBuilder& mb, const Arena& ar) {
    const size_t W = mb.W;
    for (const RecMeta& rm : ar.recs) {
        if (!rm.ok) continue;
        const EdgeKey* ek = ar.edge_keys.data() + rm.edge_off;
        const uint32_t* cnt = ar.allele_edge_cnt.data() + rm.edge_cnt_off;
        const uint32_t* masks = ar.masks.data() + rm.mask_off;
        for (uint32_t al = 0; al < rm.n_alleles; ++al) {
            const uint32_t* mask = masks + size_t(al) * W;
            uint32_t any = 0;
            for (size_t w = 0; w < W; ++w) any |= mask[w];
            if (any) {
                for (uint32_t e = 0; e < cnt[al]; ++e) {
                    uint32_t row = mb.intern(ek[e]);
                    uint32_t* dst = mb.data.data() + size_t(row) * W;
                    for (size_t w = 0; w < W; ++w) dst[w] |= mask[w];
                }
            }
            ek += cnt[al];
        }
    }
}

struct Reader {
    BlockSource src;
    std::atomic<bool> read_error{false};
    std::vector<std::string> samples;
    BatchQueue queue;
    std::thread producer;
    std::vector<std::string> pending;  // lines of the NEXT chromosome
    std::vector<char> carry;           // partial line handed to producer
    std::vector<Arena> arenas;         // parse arenas (double-buffered
    std::vector<Arena> arenas2;        //  across the parse/intern pipeline)
    MatrixBuilder mb;                  // reused: keeps row capacity
    // profiling counter snapshots taken at open (per-reader deltas)
    uint64_t ns_read0 = 0, ns_parse0 = 0, ns_intern0 = 0;

    Reader() {
        if (profile_enabled()) {
            ns_read0 = g_ns_read.load();
            ns_parse0 = g_ns_parse.load();
            ns_intern0 = g_ns_intern.load();
        }
    }

    ~Reader() {
        queue.shutdown();
        if (producer.joinable()) producer.join();
        src.close();
        if (profile_enabled())
            fprintf(stderr,
                    "[stoat_core] read=%.1fms parse(sum)=%.1fms "
                    "intern=%.1fms\n",
                    (g_ns_read.load() - ns_read0) / 1e6,
                    (g_ns_parse.load() - ns_parse0) / 1e6,
                    (g_ns_intern.load() - ns_intern0) / 1e6);
    }

    void start() {
        producer = std::thread([this] {
            std::vector<char> rest = std::move(carry);
            carry.clear();
            for (;;) {
                if (queue.stop.load()) return;
                Batch* b = queue.acquire();
                b->ensure(rest.size() + kBlockBytes + 1);
                if (!rest.empty())
                    memcpy(b->text, rest.data(), rest.size());
                uint64_t tr0 = profile_enabled() ? now_ns() : 0;
                size_t got = src.read(b->text + rest.size(),
                                      kBlockBytes);
                if (src.err) read_error.store(true);
                if (tr0) g_ns_read.fetch_add(now_ns() - tr0);
                size_t total = rest.size() + got;
                rest.clear();
                if (total == 0) { queue.recycle(b); break; }
                b->len = total + 1;
                char* base = b->text;
                size_t pos = 0;
                size_t line_start = 0;
                while (pos < total) {
                    char* nl = (char*)memchr(base + pos, '\n', total - pos);
                    if (!nl) break;
                    size_t eol = size_t(nl - base);
                    base[eol] = '\0';
                    if (eol > line_start && base[eol - 1] == '\r')
                        base[eol - 1] = '\0';
                    if (base[line_start] != '#' &&
                        base[line_start] != '\0')
                        b->offs.push_back(uint32_t(line_start));
                    line_start = eol + 1;
                    pos = eol + 1;
                }
                if (got == 0) {
                    // EOF: whatever is left is a final unterminated line
                    if (line_start < total) {
                        base[total] = '\0';
                        if (base[line_start] != '#')
                            b->offs.push_back(uint32_t(line_start));
                    }
                } else if (line_start < total) {
                    rest.assign(base + line_start, base + total);
                    b->len = line_start;  // drop the partial tail
                }
                bool eof = (got == 0);
                if (b->n_lines()) queue.push(b);
                else queue.recycle(b);
                if (eof) break;
            }
            queue.finish();
        });
    }
};

struct Chunk {
    uint64_t n_rows = 0, n_cols = 0, n_words = 0;
    uint64_t n_records = 0, n_with_at = 0;  // diagnostics counters
    std::vector<uint32_t> words;   // [n_rows + 1, n_words], last row ~0
    std::vector<uint8_t> dense;    // lazy [n_rows, n_cols] unpack
    std::vector<uint64_t> edges;   // per row: a_id, a_rev, b_id, b_rev
    EdgeTable table;               // edge→row (moved from the builder) so
                                   // paths resolve without a table rebuild
    std::string chrom;
};

static size_t chrom_len(const char* line) {
    const char* t = strchr(line, '\t');
    return t ? size_t(t - line) : strlen(line);
}

// Kick off asynchronous parsing of lines [0, n) of `batch` into
// per-worker arenas on `nt` detached worker threads (the CALLER does not
// participate — it interns the previous batch concurrently; join the
// returned threads before touching the arenas).
static std::vector<std::thread> parse_batch_async(
        Batch& batch, size_t n, size_t n_samples,
        std::vector<Arena>& arenas, unsigned nt, size_t W) {
    if (n < 64) nt = 1;
    if (arenas.size() < nt) arenas.resize(nt);
    for (unsigned t = 0; t < arenas.size(); ++t) arenas[t].begin(0);
    size_t per = (n + nt - 1) / nt;
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < nt; ++t) {
        size_t lo = t * per, hi = std::min(n, lo + per);
        threads.emplace_back([&batch, &arenas, t, lo, hi, n_samples, W] {
            uint64_t t0 = profile_enabled() ? now_ns() : 0;
            Arena& ar = arenas[t];
            ar.begin(lo < hi ? hi - lo : 0);
            for (size_t i = lo; i < hi; ++i)
                parse_line(batch.line_mut(i), n_samples, ar, i - lo, W);
            if (t0) g_ns_parse.fetch_add(now_ns() - t0);
        });
    }
    return threads;
}


// Shared path-blob tokenizer: walks the ','-joined '>id<id' path blob,
// resolving consecutive traversal pairs through ``lookup(prev, key)``
// (row index or UINT32_MAX = unknown); node-0 (*) traversals skip, an
// unknown edge invalidates the path and drops its partial rows
// (identify_path's early abort, snarl_analyzer.cpp:334-336).  The ONE
// copy behind stoat_resolve_paths and stoat_chunk_resolve_idx.
template <typename Lookup>
static void tokenize_path_blob(const char* blob, int64_t blob_len,
                               Lookup&& lookup,
                               std::vector<uint32_t>& rows,
                               std::vector<uint64_t>& offs,
                               std::vector<uint8_t>& valid) {
    rows.reserve(size_t(blob_len) / 4 + 1);
    offs.push_back(0);
    const char* p = blob;
    const char* end = blob + blob_len;
    uint64_t prev_key = 0;
    bool have_prev = false;
    bool ok = true;
    size_t path_row_start = 0;
    while (true) {
        if (p >= end || *p == ',') {
            if (!ok) rows.resize(path_row_start);   // drop partial rows
            offs.push_back(rows.size());
            valid.push_back(ok ? 1 : 0);
            if (p >= end) break;
            ++p;
            prev_key = 0;
            have_prev = false;
            ok = true;
            path_row_start = rows.size();
            continue;
        }
        char c = *p;
        if (c == '>' || c == '<') {
            uint64_t rev = (c == '<');
            ++p;
            uint64_t id = 0;
            while (p < end && *p >= '0' && *p <= '9') {
                id = id * 10 + uint64_t(*p - '0');
                ++p;
            }
            uint64_t key = (id << 1) | rev;
            if (have_prev && ok && (prev_key >> 1) != 0 && id != 0) {
                uint32_t row = lookup(prev_key, key);
                if (row != UINT32_MAX) rows.push_back(row);
                else ok = false;      // identify_path's early abort
            }
            prev_key = key;
            have_prev = true;
        } else {
            ++p;   // stray characters: skip (parity with the tokenizer)
        }
    }
}

}  // namespace

extern "C" {

void* stoat_vcf_open(const char* path) {
    Reader* r = new Reader();
    if (!r->src.open(path)) {
        delete r;
        return nullptr;
    }
    // Read blocks until the #CHROM header line is found; everything after
    // it becomes the producer's initial carry.
    std::vector<char> buf;
    size_t pos = 0;
    bool found = false;
    for (;;) {
        size_t old = buf.size();
        buf.resize(old + kBlockBytes);
        size_t got = r->src.read(buf.data() + old, kBlockBytes);
        buf.resize(old + got);
        if (got == 0) break;
        while (pos < buf.size()) {
            char* nl = (char*)memchr(buf.data() + pos, '\n',
                                     buf.size() - pos);
            if (!nl) break;
            size_t eol = size_t(nl - buf.data());
            std::string line(buf.data() + pos, eol - pos);
            if (!line.empty() && line.back() == '\r') line.pop_back();
            pos = eol + 1;
            if (line.rfind("##", 0) == 0 || line.empty()) continue;
            if (line.rfind("#CHROM", 0) == 0) {
                size_t col = 0, p = 0;
                while (p <= line.size()) {
                    size_t t = line.find('\t', p);
                    if (t == std::string::npos) t = line.size();
                    if (col >= 9)
                        r->samples.emplace_back(line.substr(p, t - p));
                    p = t + 1;
                    ++col;
                    if (t == line.size()) break;
                }
                found = true;
                break;
            }
            delete r;
            return nullptr;
        }
        if (found) break;
    }
    if (!found && pos < buf.size()) {
        // the header line may be the file's final line with no
        // trailing newline (the data path already handles unterminated
        // final lines; the header scan must too)
        std::string line(buf.data() + pos, buf.size() - pos);
        if (!line.empty() && line.back() == '\r') line.pop_back();
        if (line.rfind("#CHROM", 0) == 0) {
            size_t col = 0, p = 0;
            while (p <= line.size()) {
                size_t t = line.find('\t', p);
                if (t == std::string::npos) t = line.size();
                if (col >= 9)
                    r->samples.emplace_back(line.substr(p, t - p));
                p = t + 1;
                ++col;
                if (t == line.size()) break;
            }
            pos = buf.size();
            found = true;
        }
    }
    if (!found) {
        delete r;
        return nullptr;
    }
    r->carry.assign(buf.begin() + pos, buf.end());
    r->start();
    return r;
}

int stoat_vcf_read_error(void* rp) {
    return static_cast<Reader*>(rp)->read_error.load() ? 1 : 0;
}

int64_t stoat_vcf_n_samples(void* rp) {
    return int64_t(static_cast<Reader*>(rp)->samples.size());
}

const char* stoat_vcf_sample(void* rp, int64_t i) {
    Reader* r = static_cast<Reader*>(rp);
    if (i < 0 || size_t(i) >= r->samples.size()) return nullptr;
    return r->samples[size_t(i)].c_str();
}

// Parse the next chromosome chunk.  Returns an opaque Chunk* or nullptr at
// EOF.
// Incremental-rows callback: invoked during chunk construction after
// each intern batch with the word rows appended so far, [row_lo,
// row_hi).  NOTE: a shipped row is NOT guaranteed final — a later
// record whose traversal shares an edge with an earlier one ORs more
// carrier bits into the existing row (intern_and_fill) — so a caller
// that ships rows upstream MUST reconcile against the completed
// chunk's words afterwards (runner.assemble_words_device keeps each
// slice's host copy and patches stale rows).  The pointer is valid
// only for the duration of the call — copy before returning.
typedef void (*stoat_rows_cb)(void* ctx, const uint32_t* rows,
                              uint64_t row_lo, uint64_t row_hi,
                              uint64_t n_words, const char* chrom);

static void* next_chunk_impl(void* rp, uint64_t initial_rows,
                             stoat_rows_cb cb, void* cb_ctx) {
    Reader* r = static_cast<Reader*>(rp);
    const unsigned nt = num_threads();
    size_t n_samples = r->samples.size();
    const size_t W = std::max<size_t>((2 * n_samples + 31) / 32, 1);

    std::string chrom;
    MatrixBuilder& mb = r->mb;
    uint64_t n_records = 0, n_with_at = 0;
    bool have_chrom = false;
    bool boundary_hit = false;

    // Fetch the next batch of this chromosome's lines: the previous
    // chunk's stashed tail first, then the producer queue.  Establishes
    // the chromosome from the first line and stashes everything after a
    // chromosome change into r->pending.  Returns (batch, n_lines) with
    // batch == nullptr at EOF; the caller owns heap batches.
    auto fetch = [&]() -> std::pair<Batch*, size_t> {
        for (;;) {
            Batch* bp;
            if (!r->pending.empty()) {
                std::vector<std::string> pending = std::move(r->pending);
                r->pending.clear();
                bp = r->queue.acquire();
                size_t need = 0;
                for (auto& s : pending) need += s.size() + 1;
                bp->ensure(need);
                for (auto& s : pending) {
                    bp->offs.push_back(uint32_t(bp->len));
                    memcpy(bp->text + bp->len, s.c_str(), s.size() + 1);
                    bp->len += s.size() + 1;
                }
            } else {
                bp = r->queue.pop();
                if (!bp) return {nullptr, 0};
            }
            size_t n = bp->n_lines();
            if (n == 0) {
                r->queue.recycle(bp);
                continue;
            }
            if (!have_chrom) {
                chrom.assign(bp->line(0), chrom_len(bp->line(0)));
                have_chrom = true;
                mb.reset(W, initial_rows);
            }
            size_t boundary = n;
            for (size_t i = 0; i < n; ++i) {
                const char* ln = bp->line(i);
                size_t cl = chrom_len(ln);
                if (cl != chrom.size() ||
                    memcmp(ln, chrom.data(), cl) != 0) {
                    boundary = i;
                    break;
                }
            }
            if (boundary < n) {
                boundary_hit = true;
                for (size_t i = boundary; i < n; ++i)
                    r->pending.emplace_back(bp->line(i));
                if (boundary == 0) {
                    r->queue.recycle(bp);
                    return {nullptr, 0};
                }
            }
            return {bp, boundary};
        }
    };

    // Two-stage pipeline: worker threads parse batch i+1 while this
    // thread interns batch i (the serial section) — on top of the
    // producer thread reading batch i+2 from disk.
    auto [cur, cur_n] = fetch();
    if (cur) {
        std::vector<Arena>& setA = r->arenas;
        std::vector<Arena>& setB = r->arenas2;
        std::vector<Arena>* parsing = &setA;
        std::vector<Arena>* interning = &setB;
        auto threads = parse_batch_async(*cur, cur_n, n_samples,
                                         *parsing, nt, W);
        uint64_t cb_done = 0;
        while (true) {
            Batch* nxt = nullptr;
            size_t nxt_n = 0;
            if (!boundary_hit) {
                auto got = fetch();
                nxt = got.first;
                nxt_n = got.second;
            }
            for (auto& th : threads) th.join();
            std::swap(parsing, interning);
            std::vector<std::thread> next_threads;
            if (nxt)
                next_threads = parse_batch_async(*nxt, nxt_n, n_samples,
                                                 *parsing, nt, W);
            uint64_t ti0 = profile_enabled() ? now_ns() : 0;
            for (Arena& ar : *interning) {
                intern_and_fill(mb, ar);
                n_records += ar.recs.size();
                for (const RecMeta& rm : ar.recs)
                    if (rm.ok) ++n_with_at;
            }
            if (ti0) g_ns_intern.fetch_add(now_ns() - ti0);
            if (cb && mb.n_rows() > cb_done) {
                // hand the newly-appended rows upstream while the next
                // batch parses (see stoat_rows_cb: a shipped row may
                // still gain bits — callers reconcile at chunk end)
                cb(cb_ctx, mb.data.data() + cb_done * W, cb_done,
                   mb.n_rows(), W, chrom.c_str());
                cb_done = mb.n_rows();
            }
            r->queue.recycle(cur);
            cur = nxt;
            threads = std::move(next_threads);
            if (!cur) break;
        }
    }

    if (!have_chrom) return nullptr;

    Chunk* chunk = new Chunk();
    chunk->chrom = chrom;
    uint64_t rows = mb.n_rows();
    chunk->n_rows = rows;
    chunk->n_records = n_records;
    chunk->n_with_at = n_with_at;
    chunk->n_cols = 2 * n_samples;
    chunk->n_words = W;
    chunk->words.assign(mb.data.begin(), mb.data.begin() + rows * W);
    chunk->words.resize((rows + 1) * W, 0xFFFFFFFFu);  // AND-identity row
    chunk->edges = std::move(mb.edges);
    // hand the edge table to the chunk: resolution runs against it with
    // no rebuild (mb.reset() re-initializes a fresh one next chromosome)
    chunk->table = std::move(mb.table);
    return chunk;
}

void* stoat_vcf_next_chunk(void* rp, uint64_t initial_rows) {
    return next_chunk_impl(rp, initial_rows, nullptr, nullptr);
}

// Streaming variant: identical result, but newly-final word rows are
// handed to `cb` during construction (see stoat_rows_cb above) so the
// caller can overlap the device upload with the parse.
void* stoat_vcf_next_chunk_stream(void* rp, uint64_t initial_rows,
                                  stoat_rows_cb cb, void* cb_ctx) {
    return next_chunk_impl(rp, initial_rows, cb, cb_ctx);
}

const char* stoat_chunk_chrom(void* cp) {
    return static_cast<Chunk*>(cp)->chrom.c_str();
}

uint64_t stoat_chunk_rows(void* cp) {
    return static_cast<Chunk*>(cp)->n_rows;
}

uint64_t stoat_chunk_cols(void* cp) {
    return static_cast<Chunk*>(cp)->n_cols;
}

uint64_t stoat_chunk_n_records(void* cp) {
    return static_cast<Chunk*>(cp)->n_records;
}

// Records whose INFO carried a usable AT (and LV==0) — for the
// degenerate-input diagnostics (a header-only output with zero warnings
// is a support ticket, not a result).
uint64_t stoat_chunk_n_with_at(void* cp) {
    return static_cast<Chunk*>(cp)->n_with_at;
}

uint64_t stoat_chunk_nwords(void* cp) {
    return static_cast<Chunk*>(cp)->n_words;
}

// Bit-packed [n_rows + 1, n_words] uint32 matrix (last row all-ones).
const uint32_t* stoat_chunk_words(void* cp) {
    return static_cast<Chunk*>(cp)->words.data();
}

// Dense uint8 [n_rows, n_cols] view, unpacked lazily from the words.
const uint8_t* stoat_chunk_matrix(void* cp) {
    Chunk* c = static_cast<Chunk*>(cp);
    if (c->dense.empty() && c->n_rows) {
        c->dense.resize(c->n_rows * c->n_cols);
        for (uint64_t row = 0; row < c->n_rows; ++row) {
            const uint32_t* src = c->words.data() + row * c->n_words;
            uint8_t* dst = c->dense.data() + row * c->n_cols;
            for (uint64_t col = 0; col < c->n_cols; ++col)
                dst[col] = (src[col >> 5] >> (col & 31)) & 1u;
        }
    }
    return c->dense.data();
}

const uint64_t* stoat_chunk_edges(void* cp) {
    return static_cast<Chunk*>(cp)->edges.data();
}

void stoat_chunk_free(void* cp) {
    delete static_cast<Chunk*>(cp);
}

void stoat_vcf_close(void* rp) {
    delete static_cast<Reader*>(rp);
}

// ---------------------------------------------------------------------------
// Snarl-path resolution against a chunk's edge rows.
//
// The packing step's hot host loop: turn every snarl path string
// (">123>213<234", comma-separated across all paths of a chromosome)
// into the list of edge-matrix rows it references.  Semantics mirror
// identify_path (snarl_analyzer.cpp:315-356): '*'/node-0 edges are
// skipped, a path referencing an edge absent from the matrix is invalid
// (matches no haplotype), zero-edge paths stay valid.
//
// Outputs (malloc'd, caller frees via stoat_free_buf):
//   rows    u32[nnz]  — edge rows, concatenated in path order
//   offs    u64[P+1]  — per-path [start, end) into rows
//   valid   u8[P]     — 0 if the path referenced an unknown edge
// Returns P (number of paths = comma count + 1), or -1 on error.

int64_t stoat_resolve_paths(const uint64_t* edges, uint64_t n_edge_rows,
                            const char* blob, int64_t blob_len,
                            uint32_t** rows_out, uint64_t** offs_out,
                            uint8_t** valid_out) {
    EdgeTable table;
    table.reset(size_t(n_edge_rows) + 1);
    for (uint64_t r = 0; r < n_edge_rows; ++r) {
        const uint64_t* e = edges + 4 * r;
        bool added = false;
        table.get_or_add((e[0] << 1) | e[1], (e[2] << 1) | e[3], added);
    }

    std::vector<uint32_t> rows;
    std::vector<uint64_t> offs;
    std::vector<uint8_t> valid;
    // Unknown edges intern like any other (keeping the load factor
    // honest) but land at rows >= n_edge_rows -> invalid path.
    tokenize_path_blob(
        blob, blob_len,
        [&](uint64_t a, uint64_t b) -> uint32_t {
            bool added = false;
            uint32_t row = table.get_or_add(a, b, added);
            return row < n_edge_rows ? row : UINT32_MAX;
        },
        rows, offs, valid);

    int64_t P = int64_t(valid.size());
    *rows_out = (uint32_t*)malloc(rows.size() * sizeof(uint32_t) + 1);
    *offs_out = (uint64_t*)malloc(offs.size() * sizeof(uint64_t));
    *valid_out = (uint8_t*)malloc(valid.size() + 1);
    if (!*rows_out || !*offs_out || !*valid_out) return -1;
    memcpy(*rows_out, rows.data(), rows.size() * sizeof(uint32_t));
    memcpy(*offs_out, offs.data(), offs.size() * sizeof(uint64_t));
    memcpy(*valid_out, valid.data(), valid.size());
    return P;
}

// Fused variant: resolve a path blob against a CHUNK's own edge table
// (moved out of the builder at chunk creation — no table rebuild) and
// emit the pack-ready padded index matrix the packed device kernels
// consume directly:
//
//   idx   i32[P, K] — edge rows per path; padding entries point at
//                     n_rows (the all-ones AND-identity row of the words
//                     matrix), K = pow2(max rows on any valid path), ≥1.
//                     Invalid paths are entirely padding.
//   rows  u32[nnz], offs u64[P+1], valid u8[P] — as stoat_resolve_paths.
//
// The idx layout is the exact output contract of
// pipeline/packed.py:pack_path_edge_idx (pinned by tests); emitting it
// here turns the Python-side packing into array slicing.
// Returns P, or -1 on error.
int64_t stoat_chunk_resolve_idx(void* cp, const char* blob,
                                int64_t blob_len, int64_t* k_out,
                                int32_t** idx_out, uint32_t** rows_out,
                                uint64_t** offs_out, uint8_t** valid_out) {
    Chunk* c = static_cast<Chunk*>(cp);
    const EdgeTable& table = c->table;
    const uint32_t n_rows = uint32_t(c->n_rows);

    std::vector<uint32_t> rows;
    std::vector<uint64_t> offs;
    std::vector<uint8_t> valid;
    tokenize_path_blob(
        blob, blob_len,
        [&](uint64_t a, uint64_t b) { return table.find(a, b); },
        rows, offs, valid);

    const int64_t P = int64_t(valid.size());
    uint64_t max_k = 0;
    for (int64_t i = 0; i < P; ++i) {
        uint64_t n = offs[size_t(i) + 1] - offs[size_t(i)];
        if (valid[size_t(i)] && n > max_k) max_k = n;
    }
    uint64_t K = 1;
    while (K < max_k) K *= 2;

    int32_t* idx = (int32_t*)malloc(size_t(P) * K * sizeof(int32_t) + 1);
    *rows_out = (uint32_t*)malloc(rows.size() * sizeof(uint32_t) + 1);
    *offs_out = (uint64_t*)malloc(offs.size() * sizeof(uint64_t));
    *valid_out = (uint8_t*)malloc(valid.size() + 1);
    if (!idx || !*rows_out || !*offs_out || !*valid_out) return -1;
    for (int64_t i = 0; i < P; ++i) {
        int32_t* dst = idx + size_t(i) * K;
        uint64_t lo = offs[size_t(i)], hi = offs[size_t(i) + 1];
        uint64_t n = hi - lo;
        for (uint64_t e = 0; e < n; ++e)
            dst[e] = int32_t(rows[size_t(lo + e)]);
        for (uint64_t e = n; e < K; ++e) dst[e] = int32_t(n_rows);
    }
    memcpy(*rows_out, rows.data(), rows.size() * sizeof(uint32_t));
    memcpy(*offs_out, offs.data(), offs.size() * sizeof(uint64_t));
    memcpy(*valid_out, valid.data(), valid.size());
    *idx_out = idx;
    *k_out = int64_t(K);
    return P;
}

void stoat_free_buf(void* p) {
    free(p);
}

// ---------------------------------------------------------------------------
// Output-row formatting (the writer's per-row hot loop).
//
// Twin of the reference's stoat::set_precision (utils.cpp:5-15): printf
// %.4e when |x| < 0.1 && x != 0, else %.4g — identical to the Python
// formatting.set_precision (pinned against it by tests).  NaN renders as
// "NA" for statistics (format_p semantics).

static inline void fmt_p(double v, std::string& out) {
    char buf[48];
    if (v != v) { out += "NA"; return; }
    if (v == HUGE_VAL) { out += "inf"; return; }
    if (v == -HUGE_VAL) { out += "-inf"; return; }
    if (v != 0.0 && v < 0.1 && v > -0.1)
        snprintf(buf, sizeof buf, "%.4e", v);
    else
        snprintf(buf, sizeof buf, "%.4g", v);
    out += buf;
}

static inline void append_int(long long v, std::string& out) {
    char buf[24];
    snprintf(buf, sizeof buf, "%lld", v);
    out += buf;
}

static char* finish_blob(std::string& out, uint64_t* out_len) {
    char* buf = (char*)malloc(out.size() + 1);
    if (!buf) { *out_len = 0; return nullptr; }
    memcpy(buf, out.data(), out.size());
    buf[out.size()] = '\0';
    *out_len = out.size();
    return buf;
}

// Binary rows (writer.cpp:23-35 layout):
//   <chrom>\t<prefix>\t<P_FISHER>\t<P_CHI2>\t<g0:g1,...>\t<depth>\n
// prefixes = S NUL-terminated "START\tEND\tSNARL\tTYPES" strings.
// Skips filtered rows.  Caller frees via stoat_free_buf.
char* stoat_format_binary_rows(
        const char* chrom, const char* prefixes, const int64_t* depths,
        const uint8_t* filtered, const double* p_fisher,
        const double* p_chi2, const double* g0, const double* g1,
        const uint8_t* keep, int64_t S, int64_t Pmax, uint64_t* out_len) {
    std::string out;
    out.reserve(size_t(S) * 64);
    const char* pre = prefixes;
    for (int64_t s = 0; s < S; ++s) {
        size_t pre_len = strlen(pre);
        if (!filtered[s]) {
            out += chrom;
            out += '\t';
            out.append(pre, pre_len);
            out += '\t';
            fmt_p(p_fisher[s], out);
            out += '\t';
            fmt_p(p_chi2[s], out);
            out += '\t';
            bool first = true;
            const double* g0r = g0 + s * Pmax;
            const double* g1r = g1 + s * Pmax;
            const uint8_t* kr = keep + s * Pmax;
            for (int64_t c = 0; c < Pmax; ++c) {
                if (!kr[c]) continue;
                if (!first) out += ',';
                first = false;
                append_int((long long)g0r[c], out);
                out += ':';
                append_int((long long)g1r[c], out);
            }
            out += '\t';
            append_int(depths[s], out);
            out += '\n';
        }
        pre += pre_len + 1;
    }
    return finish_blob(out, out_len);
}

// Quantitative-family rows (writer.cpp:37-87 layouts):
//   has_r2=1:  ...\t<P>\t<RSQUARE>\t<BETA>\t<SE>\t<allele_paths>\t<depth>
//   has_r2=0:  ...\t<P>\t<BETA>\t<SE>\t<allele_paths>\t<depth>   (covar)
// allele_paths joins the first n_paths[s] columns with commas.
char* stoat_format_quant_rows(
        const char* chrom, const char* prefixes, const int64_t* depths,
        const uint8_t* filtered, const double* p, const double* r2,
        const double* beta, const double* se, const int32_t* allele_paths,
        const int64_t* n_paths, int64_t S, int64_t Pmax, int has_r2,
        uint64_t* out_len) {
    std::string out;
    out.reserve(size_t(S) * 72);
    const char* pre = prefixes;
    for (int64_t s = 0; s < S; ++s) {
        size_t pre_len = strlen(pre);
        if (!filtered[s]) {
            out += chrom;
            out += '\t';
            out.append(pre, pre_len);
            out += '\t';
            fmt_p(p[s], out);
            out += '\t';
            if (has_r2) {
                fmt_p(r2[s], out);
                out += '\t';
            }
            fmt_p(beta[s], out);
            out += '\t';
            fmt_p(se[s], out);
            out += '\t';
            const int32_t* ap = allele_paths + s * Pmax;
            int64_t n = n_paths[s] < Pmax ? n_paths[s] : Pmax;
            for (int64_t c = 0; c < n; ++c) {
                if (c) out += ',';
                append_int(ap[c], out);
            }
            out += '\t';
            append_int(depths[s], out);
            out += '\n';
        }
        pre += pre_len + 1;
    }
    return finish_blob(out, out_len);
}

}  // extern "C"
