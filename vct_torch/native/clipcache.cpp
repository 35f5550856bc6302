// vct native clip cache — memory-mapped uint8 clip store + multithreaded
// prefetching batch loader.
//
// The reference's training input path is h5py random access from Python
// (loader_data.py:74-125 VideoDataset over an HDF5 file) — per-item chunk
// reads through the HDF5 C library and the GIL. This library replaces that
// hot path for the TPU trainer:
//
//   * single binary file: header | labels | raw uint8 clips (N,T,H,W,C)
//     — uint8 on disk (the device preprocessing kernel normalizes on-TPU),
//     4x smaller than the reference's float32 HDF5 cache
//   * loader mmaps the file and assembles shuffled batches with a worker
//     thread pool into a ring of reusable slots; Python pops completed
//     batches through ctypes without holding the GIL during the gather
//
// C ABI (ctypes-friendly), see vct_torch/data/clipcache.py for the Python side.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <map>
#include <queue>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5643544331ULL;  // "VCTC1"

struct Header {
  uint64_t magic;
  uint64_t num_clips;
  uint64_t t, h, w, c;
  uint64_t label_kind;  // 0 = int64 scalar, 1 = float32 vector[label_dim]
  uint64_t label_dim;
};

size_t clip_bytes(const Header& hd) { return hd.t * hd.h * hd.w * hd.c; }
size_t label_bytes(const Header& hd) {
  return hd.label_kind == 0 ? sizeof(int64_t) : hd.label_dim * sizeof(float);
}

// ---------------------------------------------------------------- writer

struct Writer {
  FILE* data_tmp = nullptr;
  std::string path;
  std::string tmp_path;
  Header hd{};
  std::vector<uint8_t> labels;  // raw label bytes
};

// ---------------------------------------------------------------- loader

struct Slot {
  std::vector<uint8_t> clips;
  std::vector<uint8_t> labels;
  int64_t count = 0;
  int64_t batch_index = -1;
};

struct Loader {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_size = 0;
  Header hd{};
  const uint8_t* labels_base = nullptr;
  const uint8_t* clips_base = nullptr;

  int64_t batch = 0;
  bool shuffle = false;
  bool drop_last = false;
  uint64_t seed = 0;
  int64_t epoch = 0;

  std::vector<uint32_t> order;
  std::atomic<int64_t> next_batch{0};
  int64_t num_batches = 0;

  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable ready_cv;
  std::condition_variable free_cv;
  std::map<int64_t, Slot*> ready;  // keyed by batch index: ordered delivery
  std::queue<Slot*> free_slots;
  std::vector<Slot> slots;
  std::atomic<bool> stop{false};
  std::atomic<int64_t> produced{0};
  int n_workers = 2;

  void worker_loop() {
    const size_t cb = clip_bytes(hd);
    const size_t lb = label_bytes(hd);
    while (!stop.load()) {
      // Acquire a slot BEFORE claiming a batch index: every claimed index
      // then owns a slot, so the lowest unconsumed batch can always complete
      // and ordered delivery cannot deadlock on slot starvation.
      Slot* slot = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        free_cv.wait(lk, [&] { return stop.load() || !free_slots.empty(); });
        if (stop.load()) return;
        slot = free_slots.front();
        free_slots.pop();
      }
      int64_t b = next_batch.fetch_add(1);
      if (b >= num_batches) {
        std::lock_guard<std::mutex> lk(mu);
        free_slots.push(slot);
        free_cv.notify_one();
        return;
      }
      int64_t start = b * batch;
      int64_t count = std::min(batch, (int64_t)hd.num_clips - start);
      slot->count = count;
      for (int64_t i = 0; i < count; ++i) {
        uint32_t idx = order[start + i];
        std::memcpy(slot->clips.data() + i * cb, clips_base + (size_t)idx * cb, cb);
        std::memcpy(slot->labels.data() + i * lb, labels_base + (size_t)idx * lb, lb);
      }
      slot->batch_index = b;
      {
        std::lock_guard<std::mutex> lk(mu);
        ready[b] = slot;
        produced.fetch_add(1);
      }
      ready_cv.notify_all();
    }
  }

  void reshuffle() {
    order.resize(hd.num_clips);
    for (uint64_t i = 0; i < hd.num_clips; ++i) order[i] = (uint32_t)i;
    if (shuffle) {
      std::mt19937_64 rng(seed + (uint64_t)epoch * 0x9e3779b97f4a7c15ULL);
      for (uint64_t i = hd.num_clips; i > 1; --i) {
        uint64_t j = rng() % i;
        std::swap(order[i - 1], order[j]);
      }
    }
  }

  void start_epoch() {
    reshuffle();
    int64_t full = (int64_t)hd.num_clips / batch;
    int64_t rem = (int64_t)hd.num_clips % batch;
    num_batches = full + ((rem && !drop_last) ? 1 : 0);
    next_batch.store(0);
    produced.store(0);
    stop.store(false);
    workers.clear();
    for (int i = 0; i < n_workers; ++i)
      workers.emplace_back([this] { worker_loop(); });
  }

  void join_workers() {
    stop.store(true);
    free_cv.notify_all();
    ready_cv.notify_all();
    for (auto& w : workers)
      if (w.joinable()) w.join();
    workers.clear();
  }
};

}  // namespace

extern "C" {

// ---- writer -----------------------------------------------------------

void* ccw_open(const char* path, int64_t t, int64_t h, int64_t w, int64_t c,
               int64_t label_kind, int64_t label_dim) {
  auto* wr = new Writer();
  wr->path = path;
  wr->tmp_path = std::string(path) + ".tmp";
  wr->data_tmp = std::fopen(wr->tmp_path.c_str(), "wb");
  if (!wr->data_tmp) {
    delete wr;
    return nullptr;
  }
  wr->hd = {kMagic, 0, (uint64_t)t, (uint64_t)h, (uint64_t)w, (uint64_t)c,
            (uint64_t)label_kind, (uint64_t)label_dim};
  return wr;
}

int ccw_append(void* handle, const uint8_t* clip, const int64_t* ilabel,
               const float* flabel) {
  auto* wr = (Writer*)handle;
  size_t cb = clip_bytes(wr->hd);
  if (std::fwrite(clip, 1, cb, wr->data_tmp) != cb) return -1;
  if (wr->hd.label_kind == 0) {
    const uint8_t* p = (const uint8_t*)ilabel;
    wr->labels.insert(wr->labels.end(), p, p + sizeof(int64_t));
  } else {
    const uint8_t* p = (const uint8_t*)flabel;
    wr->labels.insert(wr->labels.end(), p, p + wr->hd.label_dim * sizeof(float));
  }
  wr->hd.num_clips++;
  return 0;
}

int ccw_close(void* handle) {
  auto* wr = (Writer*)handle;
  std::fclose(wr->data_tmp);
  FILE* out = std::fopen(wr->path.c_str(), "wb");
  FILE* in = std::fopen(wr->tmp_path.c_str(), "rb");
  bool ok = out && in;
  if (ok) ok = std::fwrite(&wr->hd, sizeof(Header), 1, out) == 1;
  if (ok && !wr->labels.empty())
    ok = std::fwrite(wr->labels.data(), 1, wr->labels.size(), out) ==
         wr->labels.size();
  if (ok) {
    std::vector<uint8_t> buf(1 << 22);
    size_t n;
    while (ok && (n = std::fread(buf.data(), 1, buf.size(), in)) > 0)
      ok = std::fwrite(buf.data(), 1, n, out) == n;
  }
  if (in) std::fclose(in);
  if (out) ok = (std::fclose(out) == 0) && ok;
  if (ok) {
    std::remove(wr->tmp_path.c_str());
  } else {
    // never leave a truncated cache behind — a later open would mmap short;
    // and drop the (potentially multi-GB) tmp payload too, or failed
    // finalizes on a near-full disk accumulate orphans.
    std::remove(wr->path.c_str());
    std::remove(wr->tmp_path.c_str());
  }
  delete wr;
  return ok ? 0 : -1;
}

// ---- loader -----------------------------------------------------------

void* ccl_open(const char* path, int64_t batch, int shuffle, uint64_t seed,
               int workers, int drop_last, int depth) {
  if (batch <= 0) return nullptr;  // start_epoch divides by batch (SIGFPE)
  auto* ld = new Loader();
  ld->fd = ::open(path, O_RDONLY);
  if (ld->fd < 0) {
    delete ld;
    return nullptr;
  }
  struct stat st;
  fstat(ld->fd, &st);
  ld->map_size = st.st_size;
  if (ld->map_size < (int64_t)sizeof(Header)) {
    ::close(ld->fd);
    delete ld;
    return nullptr;
  }
  ld->map = (uint8_t*)mmap(nullptr, ld->map_size, PROT_READ, MAP_SHARED, ld->fd, 0);
  if (ld->map == MAP_FAILED) {
    ::close(ld->fd);
    delete ld;
    return nullptr;
  }
  std::memcpy(&ld->hd, ld->map, sizeof(Header));
  // A truncated or foreign file must fail the open, not SIGBUS a gather
  // thread: the payload size has to match the header exactly — with
  // overflow-safe arithmetic, or a crafted header whose products wrap
  // uint64 could make want_size match a tiny file. Per-dim caps keep
  // clip_bytes itself from wrapping (<= 2^16^3 * 64 = 2^54); the clip
  // count is then bounded by division instead of multiplying.
  const uint64_t kDimCap = 1ull << 16;  // far above any real clip dim
  uint64_t per = 0;
  bool sane = ld->hd.t <= kDimCap && ld->hd.h <= kDimCap &&
              ld->hd.w <= kDimCap && ld->hd.c <= 64 &&
              ld->hd.label_dim <= kDimCap;
  if (sane) {
    per = label_bytes(ld->hd) + clip_bytes(ld->hd);
    sane = per > 0 &&
           ld->hd.num_clips <= ((uint64_t)ld->map_size) / per;
  }
  uint64_t want_size =
      sane ? sizeof(Header) + ld->hd.num_clips * per : 0;
  if (!sane || ld->hd.magic != kMagic ||
      (uint64_t)ld->map_size != want_size) {
    munmap(ld->map, ld->map_size);
    ::close(ld->fd);
    delete ld;
    return nullptr;
  }
  ld->labels_base = ld->map + sizeof(Header);
  ld->clips_base = ld->labels_base + ld->hd.num_clips * label_bytes(ld->hd);
  ld->batch = batch;
  ld->shuffle = shuffle != 0;
  ld->drop_last = drop_last != 0;
  ld->seed = seed;

  int n_slots = depth > 0 ? depth : 3;
  ld->slots.resize(n_slots);
  for (auto& s : ld->slots) {
    s.clips.resize((size_t)batch * clip_bytes(ld->hd));
    s.labels.resize((size_t)batch * label_bytes(ld->hd));
    ld->free_slots.push(&s);
  }
  ld->n_workers = workers > 0 ? workers : 2;
  ld->start_epoch();
  return ld;
}

int64_t ccl_num_clips(void* handle) { return (int64_t)((Loader*)handle)->hd.num_clips; }
int64_t ccl_num_batches(void* handle) { return ((Loader*)handle)->num_batches; }

void ccl_dims(void* handle, int64_t* out) {  // t,h,w,c,label_kind,label_dim
  auto& hd = ((Loader*)handle)->hd;
  out[0] = hd.t; out[1] = hd.h; out[2] = hd.w; out[3] = hd.c;
  out[4] = hd.label_kind; out[5] = hd.label_dim;
}

// Returns number of clips in the batch, or 0 at epoch end, -1 on error.
int64_t ccl_next(void* handle, uint8_t* out_clips, uint8_t* out_labels,
                 int64_t consumed_so_far) {
  auto* ld = (Loader*)handle;
  if (consumed_so_far >= ld->num_batches) return 0;
  Slot* slot = nullptr;
  {
    std::unique_lock<std::mutex> lk(ld->mu);
    // Deliver batches strictly in index order regardless of worker
    // completion order (reproducible epochs for any worker count).
    ld->ready_cv.wait(lk, [&] {
      return ld->stop.load() || ld->ready.count(consumed_so_far) > 0;
    });
    auto it = ld->ready.find(consumed_so_far);
    if (it == ld->ready.end()) return -1;
    slot = it->second;
    ld->ready.erase(it);
  }
  size_t cb = clip_bytes(ld->hd), lb = label_bytes(ld->hd);
  std::memcpy(out_clips, slot->clips.data(), (size_t)slot->count * cb);
  std::memcpy(out_labels, slot->labels.data(), (size_t)slot->count * lb);
  int64_t count = slot->count;
  {
    std::lock_guard<std::mutex> lk(ld->mu);
    ld->free_slots.push(slot);
  }
  ld->free_cv.notify_one();
  return count;
}

// Start the next epoch (reshuffles when shuffle=1).
void ccl_next_epoch(void* handle) {
  auto* ld = (Loader*)handle;
  ld->join_workers();
  // drain any leftover ready slots back to free
  for (auto& kv : ld->ready) ld->free_slots.push(kv.second);
  ld->ready.clear();
  ld->epoch++;
  ld->start_epoch();
}

// Jump the shuffle stream to a given epoch index (checkpoint resume: the
// per-epoch shuffle is seed + epoch * const, so a resumed run replays the
// exact permutations an uninterrupted run would see).
void ccl_set_epoch(void* handle, int64_t epoch) {
  auto* ld = (Loader*)handle;
  ld->join_workers();
  for (auto& kv : ld->ready) ld->free_slots.push(kv.second);
  ld->ready.clear();
  ld->epoch = epoch;
  ld->start_epoch();
}

void ccl_close(void* handle) {
  auto* ld = (Loader*)handle;
  ld->join_workers();
  if (ld->map) munmap(ld->map, ld->map_size);
  if (ld->fd >= 0) ::close(ld->fd);
  delete ld;
}

}  // extern "C"
