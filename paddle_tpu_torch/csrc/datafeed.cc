// Host batch assembly for the port's DataLoader (worker_mode="native"):
// a copy of the repo's csrc/datafeed.cc, built by the host C++ compiler
// at first use (paddle_tpu_torch/kernels/_build.py, load_host).
//
// The per-batch host work over memory-resident datasets is row GATHER
// (collate N sample rows into one contiguous batch). This core runs that
// gather on a worker pool over a depth-K ring of reusable batch buffers,
// with epoch shuffling (xorshift Fisher-Yates) done natively too. Python
// makes one ctypes call per batch.
//
// C ABI (ctypes-friendly), no Python.h: the wrapper owns numpy arrays
// and passes raw pointers; lifetimes are managed on the Python side. The
// ABI and the shuffle are the reference's, so both packages' feeds give
// the same batches for the same seed.
#include <atomic>
#include <map>
#include <memory>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Source {
  const uint8_t* data;
  uint64_t row_bytes;
};

struct Batch {
  std::vector<std::vector<uint8_t>> bufs;  // one per source
  uint64_t rows = 0;
  uint64_t epoch = 0;
  uint64_t index = 0;
};

struct Pipeline {
  std::vector<Source> sources;
  uint64_t n_rows = 0;
  uint64_t batch = 0;
  bool drop_last = false;
  bool shuffle = false;
  uint64_t seed = 0;
  uint64_t epochs = 0;          // 0 = endless
  int n_threads = 1;

  std::vector<uint64_t> perm;               // identity / unshuffled
  // per-epoch shuffled permutations (created by the first task of the
  // epoch, read lock-free through shared_ptr by concurrent gathers)
  std::map<uint64_t, std::shared_ptr<std::vector<uint64_t>>> epoch_perms;
  std::mutex perm_mu;
  uint64_t issued = 0;                      // tasks handed out (gated)
  uint64_t batches_per_epoch = 0;

  // ring of reusable buffers
  std::queue<Batch*> free_q;
  std::queue<Batch*> ready_q;   // producer -> consumer, ordered
  std::mutex mu;
  std::condition_variable cv_free, cv_ready;
  std::vector<Batch*> all;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  uint64_t produced_seq = 0;    // order tickets so batches stay ordered
  uint64_t emitted_seq = 0;
  std::mutex order_mu;
  std::condition_variable cv_order;

  ~Pipeline() {
    stop.store(true);
    // lock each waiter's mutex before notifying: a worker that checked
    // the predicate pre-stop but hasn't blocked yet would otherwise
    // miss the wakeup and hang the join below
    { std::lock_guard<std::mutex> g(mu); }
    { std::lock_guard<std::mutex> g(order_mu); }
    cv_free.notify_all();
    cv_ready.notify_all();
    cv_order.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    for (auto* b : all) delete b;
  }
};

uint64_t xorshift(uint64_t* s) {
  uint64_t x = *s;
  x ^= x << 13;
  x ^= x >> 7;
  x ^= x << 17;
  return *s = x;
}

void shuffle_perm(std::vector<uint64_t>& perm, uint64_t seed,
                  uint64_t epoch) {
  uint64_t s = seed * 0x9E3779B97F4A7C15ull + epoch + 1;
  for (uint64_t i = perm.size(); i > 1; --i) {
    uint64_t j = xorshift(&s) % i;
    std::swap(perm[i - 1], perm[j]);
  }
}

void gather_rows(const Source& src, const uint64_t* idx, uint64_t n,
                 uint8_t* dst) {
  for (uint64_t i = 0; i < n; ++i) {
    std::memcpy(dst + i * src.row_bytes,
                src.data + idx[i] * src.row_bytes, src.row_bytes);
  }
}

std::shared_ptr<std::vector<uint64_t>> epoch_perm(Pipeline* p,
                                                  uint64_t epoch) {
  std::lock_guard<std::mutex> g(p->perm_mu);
  auto it = p->epoch_perms.find(epoch);
  if (it != p->epoch_perms.end()) return it->second;
  auto perm = std::make_shared<std::vector<uint64_t>>(p->perm);
  if (p->shuffle) shuffle_perm(*perm, p->seed, epoch);
  p->epoch_perms[epoch] = perm;
  // keep the map tiny: in-flight tasks span a bounded epoch window
  while (p->epoch_perms.size() > 4) {
    p->epoch_perms.erase(p->epoch_perms.begin());
  }
  return perm;
}

void worker_loop(Pipeline* p) {
  size_t depth = p->all.size();
  while (!p->stop.load()) {
    uint64_t task;
    {
      // gate issuance to the ring depth: every in-flight task owns a
      // buffer, so the ordered publication below can never starve a
      // lower-numbered task of one (deadlock when n_threads > depth)
      std::unique_lock<std::mutex> lk(p->order_mu);
      p->cv_order.wait(lk, [&] {
        return p->stop.load() ||
               p->issued - p->produced_seq < depth;
      });
      if (p->stop.load()) break;
      task = p->issued++;
    }
    uint64_t epoch = task / p->batches_per_epoch;
    uint64_t bidx = task % p->batches_per_epoch;
    if (p->epochs && epoch >= p->epochs) break;

    auto perm = epoch_perm(p, epoch);

    uint64_t start = bidx * p->batch;
    uint64_t rows = std::min(p->batch, p->n_rows - start);

    Batch* b = nullptr;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_free.wait(lk, [&] {
        return p->stop.load() || !p->free_q.empty();
      });
      if (p->stop.load()) break;
      b = p->free_q.front();
      p->free_q.pop();
    }
    b->rows = rows;
    b->epoch = epoch;
    b->index = bidx;
    for (size_t s = 0; s < p->sources.size(); ++s) {
      gather_rows(p->sources[s], perm->data() + start, rows,
                  b->bufs[s].data());
    }
    // publish in task order so consumers see deterministic sequence
    {
      std::unique_lock<std::mutex> lk(p->order_mu);
      p->cv_order.wait(lk, [&] {
        return p->stop.load() || p->produced_seq == task;
      });
      if (p->stop.load()) break;
      {
        std::lock_guard<std::mutex> g(p->mu);
        p->ready_q.push(b);
      }
      p->produced_seq = task + 1;
      p->cv_order.notify_all();
      p->cv_ready.notify_one();
    }
  }
}

}  // namespace

extern "C" {

void* df_pipeline_create(const void** srcs, const uint64_t* row_bytes,
                         uint64_t n_sources, uint64_t n_rows,
                         uint64_t batch, int drop_last, int shuffle,
                         uint64_t seed, uint64_t epochs, int n_threads,
                         int depth) {
  auto* p = new Pipeline();
  for (uint64_t s = 0; s < n_sources; ++s) {
    p->sources.push_back(
        {static_cast<const uint8_t*>(srcs[s]), row_bytes[s]});
  }
  p->n_rows = n_rows;
  p->batch = batch;
  p->drop_last = drop_last != 0;
  p->shuffle = shuffle != 0;
  p->seed = seed;
  p->epochs = epochs;
  p->n_threads = n_threads < 1 ? 1 : n_threads;
  p->batches_per_epoch =
      p->drop_last ? n_rows / batch : (n_rows + batch - 1) / batch;
  if (p->batches_per_epoch == 0) {
    delete p;
    return nullptr;
  }
  p->perm.resize(n_rows);
  for (uint64_t i = 0; i < n_rows; ++i) p->perm[i] = i;
  if (depth < 2) depth = 2;
  for (int d = 0; d < depth; ++d) {
    auto* b = new Batch();
    for (auto& src : p->sources) {
      b->bufs.emplace_back(batch * src.row_bytes);
    }
    p->all.push_back(b);
    p->free_q.push(b);
  }
  for (int t = 0; t < p->n_threads; ++t) {
    p->workers.emplace_back(worker_loop, p);
  }
  return p;
}

// Pop the next batch into dsts (one pointer per source). Returns the
// number of rows, 0 at end of the final epoch.
uint64_t df_pipeline_next(void* handle, void** dsts, uint64_t* epoch,
                          uint64_t* index) {
  auto* p = static_cast<Pipeline*>(handle);
  uint64_t total = p->epochs ? p->epochs * p->batches_per_epoch : 0;
  if (total && p->emitted_seq >= total) return 0;
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_ready.wait(lk, [&] {
      return p->stop.load() || !p->ready_q.empty();
    });
    if (p->stop.load()) return 0;
    b = p->ready_q.front();
    p->ready_q.pop();
  }
  for (size_t s = 0; s < p->sources.size(); ++s) {
    std::memcpy(dsts[s], b->bufs[s].data(),
                b->rows * p->sources[s].row_bytes);
  }
  uint64_t rows = b->rows;
  if (epoch) *epoch = b->epoch;
  if (index) *index = b->index;
  {
    std::lock_guard<std::mutex> g(p->mu);
    p->free_q.push(b);
  }
  p->cv_free.notify_one();
  p->emitted_seq += 1;
  return rows;
}

void df_pipeline_destroy(void* handle) {
  delete static_cast<Pipeline*>(handle);
}

// standalone multi-call gather (no pipeline): used for benchmarking and
// as the collate primitive
void df_gather(const void* src, uint64_t row_bytes, const uint64_t* idx,
               uint64_t n, void* dst) {
  Source s{static_cast<const uint8_t*>(src), row_bytes};
  gather_rows(s, idx, n, static_cast<uint8_t*>(dst));
}

}  // extern "C"
