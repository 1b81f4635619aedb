// Native data loader: mmap'd token shards + threaded prefetch.
//
// The TPU-native analog of the reference's data path (the reference delegates
// to torch DataLoader workers; its benchmark harness synthesizes batches on
// the fly, thunder/benchmarks/benchmark_litgpt.py). Feeding a TPU means the
// host must assemble (B, T+1) int32 batches faster than one XLA step — this
// loader does random-offset gather from an mmap'd token file on a small
// thread pool into a bounded ring of ready batches, so step N+1's batch is
// materialized while step N runs on device.
//
// C ABI (ctypes-friendly):
//   void*   ttl_create(path, vocab_dtype_bytes, batch, seqlen, seed, n_threads, queue_depth)
//   int64_t ttl_num_tokens(h)
//   int     ttl_next(h, int32* out)      // blocks until a batch is ready; 0 on ok
//   void    ttl_destroy(h)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp -o libttloader.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Loader {
    const uint8_t* data = nullptr;
    size_t file_bytes = 0;
    int token_bytes = 2;  // uint16 tokens by default (GPT-2/Llama vocab fits)
    int64_t n_tokens = 0;
    int64_t batch = 0;
    int64_t seqlen = 0;  // tokens per sample INCLUDING the shifted target (+1)
    int fd = -1;

    std::vector<std::thread> workers;
    // batches keyed by batch index and served strictly in order, so the
    // consumed sequence is deterministic given seed regardless of which
    // worker finishes first
    std::map<uint64_t, std::vector<int32_t>> ready;
    uint64_t next_serve = 0;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    size_t queue_depth = 4;
    std::atomic<bool> stop{false};
    uint64_t seed = 0;
    std::atomic<uint64_t> batch_counter{0};

    int64_t tok(int64_t i) const {
        const uint8_t* p = data + i * token_bytes;
        switch (token_bytes) {
            case 2: { uint16_t v; std::memcpy(&v, p, 2); return v; }
            case 4: { int32_t v; std::memcpy(&v, p, 4); return v; }
            default: { uint8_t v = *p; return v; }
        }
    }

    void worker() {
        const int64_t span = seqlen;  // seqlen already includes the +1 target
        while (!stop.load(std::memory_order_relaxed)) {
            std::vector<int32_t> buf(batch * span);
            uint64_t bidx = batch_counter.fetch_add(1);
            // contents depend only on (seed, bidx); combined with in-order
            // serving this makes the full stream reproducible
            std::mt19937_64 brng(seed ^ (bidx * 0xBF58476D1CE4E5B9ull));
            // max start offset n_tokens - span: last sampled index is n_tokens-1
            std::uniform_int_distribution<int64_t> dist(0, n_tokens - span);
            for (int64_t b = 0; b < batch; ++b) {
                int64_t off = dist(brng);
                for (int64_t t = 0; t < span; ++t) buf[b * span + t] = (int32_t)tok(off + t);
            }
            std::unique_lock<std::mutex> lk(mu);
            // always admit the batch the consumer is waiting for, even when
            // the ring is full — otherwise a straggler holding next_serve
            // deadlocks against a full queue
            cv_space.wait(lk, [&] {
                return ready.size() < queue_depth || bidx == next_serve || stop.load();
            });
            if (stop.load()) return;
            ready.emplace(bidx, std::move(buf));
            cv_ready.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void* ttl_create(const char* path, int token_bytes, int64_t batch, int64_t seqlen,
                 uint64_t seed, int n_threads, int queue_depth) {
    auto* L = new Loader();
    L->token_bytes = token_bytes;
    L->batch = batch;
    L->seqlen = seqlen;
    L->seed = seed;
    L->queue_depth = queue_depth > 0 ? (size_t)queue_depth : 4;

    L->fd = ::open(path, O_RDONLY);
    if (L->fd < 0) { delete L; return nullptr; }
    struct stat st;
    if (fstat(L->fd, &st) != 0) { ::close(L->fd); delete L; return nullptr; }
    L->file_bytes = (size_t)st.st_size;
    L->n_tokens = (int64_t)(L->file_bytes / token_bytes);
    if (L->n_tokens < seqlen) { ::close(L->fd); delete L; return nullptr; }
    void* m = mmap(nullptr, L->file_bytes, PROT_READ, MAP_PRIVATE, L->fd, 0);
    if (m == MAP_FAILED) { ::close(L->fd); delete L; return nullptr; }
    madvise(m, L->file_bytes, MADV_RANDOM);
    L->data = (const uint8_t*)m;

    int nt = n_threads > 0 ? n_threads : 2;
    for (int i = 0; i < nt; ++i) L->workers.emplace_back([L] { L->worker(); });
    return L;
}

int64_t ttl_num_tokens(void* h) { return h ? ((Loader*)h)->n_tokens : -1; }

int ttl_next(void* h, int32_t* out) {
    if (!h) return -1;
    auto* L = (Loader*)h;
    std::vector<int32_t> buf;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [&] {
            return L->ready.count(L->next_serve) || L->stop.load();
        });
        auto it = L->ready.find(L->next_serve);
        if (it == L->ready.end()) return -1;
        buf = std::move(it->second);
        L->ready.erase(it);
        L->next_serve++;
        L->cv_space.notify_all();
    }
    std::memcpy(out, buf.data(), buf.size() * sizeof(int32_t));
    return 0;
}

void ttl_destroy(void* h) {
    if (!h) return;
    auto* L = (Loader*)h;
    L->stop.store(true);
    L->cv_space.notify_all();
    L->cv_ready.notify_all();
    for (auto& t : L->workers) t.join();
    if (L->data) munmap((void*)L->data, L->file_bytes);
    if (L->fd >= 0) ::close(L->fd);
    delete L;
}

}  // extern "C"
