// fastloader: memory-mapped training-sample store with multithreaded
// shuffled batch assembly and background prefetch.
//
// The port's copy of `pyqg_generative_tpu/native/fastloader.cpp`, with the
// C API, the shuffle (std::mt19937_64(seed) and std::shuffle) and the wrap of
// the last batch unchanged, so that a seed gives the twin's batches. Two
// races of the twin are fixed here:
//
// * Slot collision. The twin's producer of batch b waits only for its slot
//   (b % kSlots) to be free. The producer of batch b + kSlots can pass that
//   check before the producer of b has stored into the slot; both then write
//   it, and the consumer waits for b forever. Here each slot carries `turn`,
//   the batch it holds next: a producer fills slot b % kSlots only when its
//   turn is b, and the consumer moves the turn on by kSlots after copying the
//   batch out.
// * Lost wakeup. The twin stores the slot state and notifies outside the
//   mutex, so a waiter that has just read the old state can sleep through the
//   notify. Here every store to the slot state (and to `stop`) is made under
//   `mu`, and the notify follows.
//
// A slot's data is written by the one producer whose turn it is and read by
// the consumer once the slot is full; neither holds the mutex while it
// copies.
//
// C API (ctypes-friendly), one consumer thread per handle:
//   fl_open(data_path, n_samples, sample_floats)        -> handle (>0) or -errno
//   fl_start_epoch(handle, seed, batch_size, drop_last) -> number of batches
//   fl_next_batch(handle, float* out)                   -> batch index or -1 at end
//   fl_batch_size(handle)                               -> current batch size
//   fl_close(handle)
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <numeric>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Slot {
    std::vector<float> data;
    long turn = 0;       // the batch this slot holds next
    bool full = false;   // data holds batch `turn`
};

struct Loader {
    const float* base = nullptr;   // mmap'ed sample store
    size_t file_bytes = 0;
    int fd = -1;
    long n_samples = 0;
    long sample_floats = 0;

    // epoch state
    std::vector<long> order;
    long batch_size = 0;
    long n_batches = 0;
    std::atomic<long> next_to_produce{0};
    long next_to_consume = 0;

    // prefetch ring; turn, full and stop change under mu only
    static constexpr int kSlots = 4;
    Slot slots[kSlots];
    std::vector<std::thread> workers;
    bool stop = false;
    std::mutex mu;
    std::condition_variable cv_ready, cv_free;

    ~Loader() { shutdown(); unmap(); }

    void unmap() {
        if (base) munmap(const_cast<float*>(base), file_bytes);
        if (fd >= 0) close(fd);
        base = nullptr;
        fd = -1;
    }

    void shutdown() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv_free.notify_all();
        cv_ready.notify_all();
        for (auto& t : workers)
            if (t.joinable()) t.join();
        workers.clear();
    }

    void produce_loop() {
        for (;;) {
            const long b = next_to_produce.fetch_add(1);
            if (b >= n_batches) return;
            Slot& slot = slots[b % kSlots];
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_free.wait(lk, [&] {
                    return stop || (slot.turn == b && !slot.full);
                });
                if (stop) return;
            }
            const long begin = b * batch_size;
            for (long i = 0; i < batch_size; ++i) {
                const long src = order[(begin + i) % n_samples];
                std::memcpy(slot.data.data() + i * sample_floats,
                            base + src * sample_floats,
                            sample_floats * sizeof(float));
            }
            {
                std::lock_guard<std::mutex> lk(mu);
                slot.full = true;
            }
            cv_ready.notify_all();
        }
    }
};

std::mutex g_mu;
std::map<long, Loader*> g_loaders;
long g_next_handle = 1;

Loader* get(long h) {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_loaders.find(h);
    return it == g_loaders.end() ? nullptr : it->second;
}

}  // namespace

extern "C" {

long fl_open(const char* data_path, long n_samples, long sample_floats) {
    int fd = open(data_path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return -2;
    }
    const size_t need =
        static_cast<size_t>(n_samples) * sample_floats * sizeof(float);
    if (static_cast<size_t>(st.st_size) < need) {
        close(fd);
        return -3;
    }
    void* p = mmap(nullptr, need, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
        close(fd);
        return -4;
    }
    madvise(p, need, MADV_WILLNEED);
    auto* L = new Loader();
    L->base = static_cast<const float*>(p);
    L->file_bytes = need;
    L->fd = fd;
    L->n_samples = n_samples;
    L->sample_floats = sample_floats;
    std::lock_guard<std::mutex> lk(g_mu);
    long h = g_next_handle++;
    g_loaders[h] = L;
    return h;
}

long fl_start_epoch(long handle, unsigned long seed, long batch_size,
                    int drop_last) {
    Loader* L = get(handle);
    if (!L || batch_size <= 0) return -1;
    L->shutdown();
    L->order.resize(L->n_samples);
    std::iota(L->order.begin(), L->order.end(), 0L);
    std::mt19937_64 rng(seed);
    std::shuffle(L->order.begin(), L->order.end(), rng);
    L->batch_size = batch_size;
    L->n_batches = drop_last ? L->n_samples / batch_size
                             : (L->n_samples + batch_size - 1) / batch_size;
    L->next_to_produce.store(0);
    L->next_to_consume = 0;
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->stop = false;
        for (int i = 0; i < Loader::kSlots; ++i) {
            L->slots[i].data.resize(static_cast<size_t>(batch_size) *
                                    L->sample_floats);
            L->slots[i].turn = i;
            L->slots[i].full = false;
        }
    }
    const unsigned n_threads =
        std::min(4u, std::max(1u, std::thread::hardware_concurrency() / 2));
    for (unsigned i = 0; i < n_threads; ++i)
        L->workers.emplace_back([L] { L->produce_loop(); });
    return L->n_batches;
}

long fl_next_batch(long handle, float* out) {
    Loader* L = get(handle);
    if (!L) return -1;
    if (L->next_to_consume >= L->n_batches) return -1;
    const long want = L->next_to_consume;
    Slot& slot = L->slots[want % Loader::kSlots];
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [&] {
            return L->stop || (slot.turn == want && slot.full);
        });
        if (L->stop) return -1;
    }
    std::memcpy(out, slot.data.data(),
                static_cast<size_t>(L->batch_size) * L->sample_floats *
                    sizeof(float));
    {
        std::lock_guard<std::mutex> lk(L->mu);
        slot.full = false;
        slot.turn = want + Loader::kSlots;
    }
    L->cv_free.notify_all();
    L->next_to_consume++;
    return want;
}

long fl_batch_size(long handle) {
    Loader* L = get(handle);
    return L ? L->batch_size : -1;
}

void fl_close(long handle) {
    Loader* L = nullptr;
    {
        std::lock_guard<std::mutex> lk(g_mu);
        auto it = g_loaders.find(handle);
        if (it != g_loaders.end()) {
            L = it->second;
            g_loaders.erase(it);
        }
    }
    delete L;
}

}  // extern "C"
