// Threaded prefetching batch loader.
//
// The data-loader runtime layer: producer threads synthesize batches
// ahead of consumption into a ring of slots, so batch generation
// overlaps the training step instead of serializing with it (and never
// touches the Python GIL). Batch contents are deterministic in
// (seed, batch_index) regardless of thread count or interleaving.
//
// C ABI for ctypes; see tf_operator_tpu_torch/native/prefetch.py. Built
// with g++ on first use by tf_operator_tpu_torch/native/__init__.py (into
// build/torch_native/).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

inline uint64_t splitmix64(uint64_t& state) {
  state += 0x9E3779B97F4A7C15ULL;
  uint64_t z = state;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

enum Kind : int32_t {
  kImages = 0,  // main: f32 [b,h,w,c] in [0,1); aux: i32 labels [b]
  kTokens = 1,  // main: i32 [b,s]; aux: unused
};

struct Slot {
  std::vector<uint8_t> main;
  std::vector<int32_t> aux;
  int64_t batch_index = -1;  // which batch currently occupies the slot
  bool ready = false;
};

struct Loader {
  int32_t kind;
  int64_t batch, d1, d2, d3;  // images: b,h,w,c; tokens: b,s,-,-
  int32_t cardinality;        // classes (images) or vocab (tokens)
  uint64_t seed;
  size_t main_bytes;
  size_t aux_count;

  std::vector<Slot> slots;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits
  std::condition_variable cv_free;    // producers wait
  std::condition_variable cv_idle;    // destroy waits for consumers
  std::atomic<int64_t> next_to_produce{0};
  int64_t next_to_consume = 0;        // guarded by mu
  std::atomic<int64_t> produced{0};
  bool stopping = false;              // guarded by mu
  int active_next = 0;                // consumers inside _next (mu)

  std::vector<std::thread> workers;

  void fill(Slot& slot, int64_t batch_index) {
    uint64_t state = seed ^ (0xD1B54A32D192ED03ULL * (batch_index + 1));
    if (kind == kImages) {
      float* out = reinterpret_cast<float*>(slot.main.data());
      size_t n = main_bytes / sizeof(float);
      for (size_t i = 0; i < n; ++i) {
        out[i] = static_cast<float>(splitmix64(state) >> 40) * 0x1.0p-24f;
      }
      for (size_t i = 0; i < aux_count; ++i) {
        slot.aux[i] = static_cast<int32_t>(
            splitmix64(state) % static_cast<uint64_t>(cardinality));
      }
    } else {
      int32_t* out = reinterpret_cast<int32_t*>(slot.main.data());
      size_t n = main_bytes / sizeof(int32_t);
      for (size_t i = 0; i < n; ++i) {
        out[i] = static_cast<int32_t>(
            splitmix64(state) % static_cast<uint64_t>(cardinality));
      }
    }
    slot.batch_index = batch_index;
  }

  void worker() {
    for (;;) {
      int64_t idx = next_to_produce.fetch_add(1);
      Slot& slot = slots[idx % slots.size()];
      {
        // Wait until the slot's previous occupant has been consumed.
        std::unique_lock<std::mutex> lock(mu);
        cv_free.wait(lock, [&] {
          return stopping || (!slot.ready && next_to_consume + static_cast<int64_t>(slots.size()) > idx);
        });
        if (stopping) return;
      }
      fill(slot, idx);
      {
        std::lock_guard<std::mutex> lock(mu);
        slot.ready = true;
        produced.fetch_add(1);
      }
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

// dims: images -> {b, h, w, c}; tokens -> {b, s, 0, 0}.
void* tpuop_loader_create(int32_t kind, const int64_t* dims,
                          int32_t cardinality, int32_t depth,
                          int32_t threads, uint64_t seed) {
  auto* ld = new Loader();
  ld->kind = kind;
  ld->batch = dims[0];
  ld->d1 = dims[1];
  ld->d2 = dims[2];
  ld->d3 = dims[3];
  ld->cardinality = cardinality > 0 ? cardinality : 1;
  ld->seed = seed;
  if (kind == kImages) {
    ld->main_bytes = static_cast<size_t>(dims[0]) * dims[1] * dims[2] *
                     dims[3] * sizeof(float);
    ld->aux_count = static_cast<size_t>(dims[0]);
  } else {
    ld->main_bytes = static_cast<size_t>(dims[0]) * dims[1] * sizeof(int32_t);
    ld->aux_count = 0;
  }
  if (depth < 2) depth = 2;
  ld->slots.resize(depth);
  for (auto& s : ld->slots) {
    s.main.resize(ld->main_bytes);
    s.aux.resize(ld->aux_count);
  }
  if (threads < 1) threads = 1;
  if (threads > 16) threads = 16;
  for (int t = 0; t < threads; ++t) {
    ld->workers.emplace_back([ld] { ld->worker(); });
  }
  return ld;
}

// Copies the next sequential batch into out_main (and out_aux when the
// kind has labels). Returns the batch index, or -1 if stopped.
int64_t tpuop_loader_next(void* handle, void* out_main, int32_t* out_aux) {
  auto* ld = static_cast<Loader*>(handle);
  int64_t want;
  Slot* slot;
  {
    std::unique_lock<std::mutex> lock(ld->mu);
    if (ld->stopping) return -1;
    ++ld->active_next;  // destroy() drains active consumers before freeing
    want = ld->next_to_consume;
    slot = &ld->slots[want % ld->slots.size()];
    ld->cv_ready.wait(lock, [&] {
      return ld->stopping || (slot->ready && slot->batch_index == want);
    });
    if (ld->stopping) {
      --ld->active_next;
      ld->cv_idle.notify_all();
      return -1;
    }
  }
  std::memcpy(out_main, slot->main.data(), ld->main_bytes);
  if (out_aux && ld->aux_count) {
    std::memcpy(out_aux, slot->aux.data(),
                ld->aux_count * sizeof(int32_t));
  }
  {
    std::lock_guard<std::mutex> lock(ld->mu);
    slot->ready = false;
    ld->next_to_consume = want + 1;
    --ld->active_next;
  }
  ld->cv_free.notify_all();
  ld->cv_idle.notify_all();
  return want;
}

int64_t tpuop_loader_produced(void* handle) {
  return static_cast<Loader*>(handle)->produced.load();
}

void tpuop_loader_destroy(void* handle) {
  auto* ld = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lock(ld->mu);
    ld->stopping = true;
  }
  ld->cv_free.notify_all();
  ld->cv_ready.notify_all();
  {
    // A consumer may be blocked inside tpuop_loader_next (e.g. a
    // feeder thread); wait until it has left before freeing.
    std::unique_lock<std::mutex> lock(ld->mu);
    ld->cv_idle.wait(lock, [&] { return ld->active_next == 0; });
  }
  for (auto& t : ld->workers) t.join();
  delete ld;
}

}  // extern "C"
