// Native host data loader: threaded shuffled-batch assembly.
//
// The trainer's host feed: worker threads gather permuted rows from the
// caller's arrays (zero-copy views of numpy buffers) into a pool of
// staging buffers, handed to Python through a bounded queue. Python wraps
// the staging pointers as numpy arrays (no copy) and releases them once
// the feed has copied the batch into pinned memory (``Tensor.pin_memory``)
// or into a fresh array.
//
// Determinism contract (shared with the numpy path in
// unionml_tpu_torch/data/native.py): the epoch permutation is
//   argsort_u64( splitmix64(seed ^ (epoch+1)*PHI ^ row_index) )
// with ties broken by row index — identical in C++ and numpy, so resuming
// from (epoch, step) reproduces the same batches on either implementation.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 -o libhostloader.so hostloader.cpp
// (no external dependencies; bound via ctypes).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <numeric>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kPhi = 0x9E3779B97F4A7C15ull;

inline uint64_t splitmix64(uint64_t x) {
  x += kPhi;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

struct Batch {
  uint64_t index = 0;   // batch index within the epoch
  uint64_t rows = 0;    // rows actually filled (last batch may be short)
  std::vector<std::vector<uint8_t>> buffers;  // one per array
};

class Loader {
 public:
  Loader(const uint8_t** arrays, const uint64_t* row_bytes, int num_arrays,
         uint64_t n_rows, uint64_t batch_size, uint64_t seed, bool shuffle,
         bool drop_remainder, int num_threads, int queue_depth)
      : n_rows_(n_rows),
        batch_size_(batch_size),
        seed_(seed),
        shuffle_(shuffle),
        drop_remainder_(drop_remainder),
        queue_depth_(std::max(queue_depth, 1)),
        num_threads_(std::max(num_threads, 1)) {
    for (int a = 0; a < num_arrays; ++a) {
      arrays_.push_back(arrays[a]);
      row_bytes_.push_back(row_bytes[a]);
    }
    num_batches_ = drop_remainder_ ? n_rows_ / batch_size_
                                   : (n_rows_ + batch_size_ - 1) / batch_size_;
  }

  ~Loader() { Stop(); }

  uint64_t num_batches() const { return num_batches_; }

  void StartEpoch(uint64_t epoch, uint64_t start_batch) {
    Stop();
    BuildPermutation(epoch);
    next_to_assemble_ = start_batch;
    next_to_emit_ = start_batch;
    stop_ = false;
    for (int t = 0; t < num_threads_; ++t) {
      workers_.emplace_back([this] { WorkerLoop(); });
    }
  }

  // Returns rows in the batch (0 = epoch exhausted). Caller owns the
  // returned batch until ReleaseBatch.
  Batch* Next() {
    std::unique_lock<std::mutex> lk(mu_);
    for (;;) {
      // emit strictly in batch order so resume is deterministic
      auto it = std::find_if(ready_.begin(), ready_.end(), [&](Batch* b) {
        return b->index == next_to_emit_;
      });
      if (it != ready_.end()) {
        Batch* b = *it;
        ready_.erase(it);
        ++next_to_emit_;
        cv_space_.notify_all();
        return b;
      }
      if (next_to_emit_ >= num_batches_) return nullptr;
      cv_ready_.wait(lk);
    }
  }

  void ReleaseBatch(Batch* b) {
    std::lock_guard<std::mutex> lk(mu_);
    pool_.push_back(b);
    cv_space_.notify_all();
  }

 private:
  void BuildPermutation(uint64_t epoch) {
    perm_.resize(n_rows_);
    std::iota(perm_.begin(), perm_.end(), 0);
    if (!shuffle_) return;
    std::vector<uint64_t> keys(n_rows_);
    const uint64_t base = seed_ ^ ((epoch + 1) * kPhi);
    for (uint64_t i = 0; i < n_rows_; ++i) keys[i] = splitmix64(base ^ i);
    std::stable_sort(perm_.begin(), perm_.end(),
                     [&](uint64_t a, uint64_t b) { return keys[a] < keys[b]; });
  }

  void WorkerLoop() {
    for (;;) {
      uint64_t my_batch;
      Batch* buf = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [&] {
          return stop_ || next_to_assemble_ >= num_batches_ ||
                 InFlight() < static_cast<uint64_t>(queue_depth_);
        });
        if (stop_ || next_to_assemble_ >= num_batches_) return;
        my_batch = next_to_assemble_++;
        buf = TakeBufferLocked();
      }
      FillBatch(my_batch, buf);
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_.push_back(buf);
      }
      cv_ready_.notify_all();
    }
  }

  uint64_t InFlight() const {
    // batches assembled or being assembled but not yet emitted
    return next_to_assemble_ - next_to_emit_;
  }

  Batch* TakeBufferLocked() {
    if (!pool_.empty()) {
      Batch* b = pool_.back();
      pool_.pop_back();
      return b;
    }
    all_batches_.emplace_back(new Batch());
    Batch* b = all_batches_.back().get();
    b->buffers.resize(arrays_.size());
    for (size_t a = 0; a < arrays_.size(); ++a) {
      b->buffers[a].resize(batch_size_ * row_bytes_[a]);
    }
    return b;
  }

  void FillBatch(uint64_t batch_idx, Batch* out) {
    const uint64_t start = batch_idx * batch_size_;
    const uint64_t rows = std::min(batch_size_, n_rows_ - start);
    out->index = batch_idx;
    out->rows = rows;
    for (size_t a = 0; a < arrays_.size(); ++a) {
      const uint64_t rb = row_bytes_[a];
      uint8_t* dst = out->buffers[a].data();
      const uint8_t* src = arrays_[a];
      for (uint64_t r = 0; r < rows; ++r) {
        std::memcpy(dst + r * rb, src + perm_[start + r] * rb, rb);
      }
    }
  }

  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_ready_.notify_all();
    for (auto& w : workers_) w.join();
    workers_.clear();
    std::lock_guard<std::mutex> lk(mu_);
    for (Batch* b : ready_) pool_.push_back(b);
    ready_.clear();
  }

  std::vector<const uint8_t*> arrays_;
  std::vector<uint64_t> row_bytes_;
  uint64_t n_rows_, batch_size_, seed_;
  bool shuffle_, drop_remainder_;
  int queue_depth_, num_threads_;
  uint64_t num_batches_ = 0;

  std::vector<uint64_t> perm_;
  std::vector<std::thread> workers_;
  std::mutex mu_;
  std::condition_variable cv_ready_, cv_space_;
  std::deque<Batch*> ready_;
  std::vector<Batch*> pool_;
  std::vector<std::unique_ptr<Batch>> all_batches_;
  uint64_t next_to_assemble_ = 0, next_to_emit_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* hl_new(const uint8_t** arrays, const uint64_t* row_bytes, int num_arrays,
             uint64_t n_rows, uint64_t batch_size, uint64_t seed, int shuffle,
             int drop_remainder, int num_threads, int queue_depth) {
  return new Loader(arrays, row_bytes, num_arrays, n_rows, batch_size, seed,
                    shuffle != 0, drop_remainder != 0, num_threads, queue_depth);
}

uint64_t hl_num_batches(void* handle) {
  return static_cast<Loader*>(handle)->num_batches();
}

void hl_start_epoch(void* handle, uint64_t epoch, uint64_t start_batch) {
  static_cast<Loader*>(handle)->StartEpoch(epoch, start_batch);
}

// Fills out_ptrs[a] with the address of array a's staging buffer and
// returns the row count (0 = epoch exhausted). out_token receives an
// opaque token to pass to hl_release.
uint64_t hl_next(void* handle, uint8_t** out_ptrs, void** out_token) {
  Loader* l = static_cast<Loader*>(handle);
  Batch* b = l->Next();
  if (b == nullptr) {
    *out_token = nullptr;
    return 0;
  }
  for (size_t a = 0; a < b->buffers.size(); ++a) out_ptrs[a] = b->buffers[a].data();
  *out_token = b;
  return b->rows;
}

void hl_release(void* handle, void* token) {
  if (token == nullptr) return;
  static_cast<Loader*>(handle)->ReleaseBatch(static_cast<Batch*>(token));
}

void hl_free(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
