// Host event tracer of the port's profiler (copy of the JAX package's
// csrc/host_tracer.cc, the same C ABI).
//
// Reference capability: paddle/fluid/platform/profiler/ HostEventRecorder +
// chrometracing_logger.cc (RecordEvent instrumentation wrapped around every
// generated API call). This library owns the *host* span stream: lock-free
// per-thread buffers (the reference's thread-local HostEventSection),
// merged and exported as chrome://tracing JSON by
// paddle_tpu_torch/profiler. The card's kernels come from torch.profiler's
// CUDA trace (Profiler(device_tracing=True)), not from this library.
//
// Built by the host C++ compiler into build/host/
// (paddle_tpu_torch/kernels/_build.py load_host) and bound with ctypes:
// no C++ types cross the boundary.

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Event {
  uint64_t begin_ns;
  uint64_t end_ns;
  uint64_t tid;
  char name[120];
};

struct ThreadBuffer {
  std::vector<Event> events;
  std::vector<Event> open;  // stack of in-flight spans
};

std::mutex g_registry_mu;
std::vector<ThreadBuffer*> g_buffers;
std::atomic<bool> g_enabled{false};
uint64_t g_start_ns = 0;

uint64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

ThreadBuffer* tls_buffer() {
  thread_local ThreadBuffer* buf = nullptr;
  if (buf == nullptr) {
    buf = new ThreadBuffer();
    buf->events.reserve(4096);
    std::lock_guard<std::mutex> lk(g_registry_mu);
    g_buffers.push_back(buf);
  }
  return buf;
}

uint64_t tid_hash() {
  return std::hash<std::thread::id>{}(std::this_thread::get_id()) & 0xffffff;
}

}  // namespace

extern "C" {

void pt_tracer_start() {
  std::lock_guard<std::mutex> lk(g_registry_mu);
  for (auto* b : g_buffers) {
    b->events.clear();
    b->open.clear();
  }
  g_start_ns = now_ns();
  g_enabled.store(true, std::memory_order_release);
}

void pt_tracer_stop() { g_enabled.store(false, std::memory_order_release); }

int pt_tracer_enabled() {
  return g_enabled.load(std::memory_order_acquire) ? 1 : 0;
}

void pt_record_begin(const char* name) {
  if (!g_enabled.load(std::memory_order_acquire)) return;
  ThreadBuffer* buf = tls_buffer();
  Event e;
  e.begin_ns = now_ns();
  e.end_ns = 0;
  e.tid = tid_hash();
  std::snprintf(e.name, sizeof(e.name), "%s", name ? name : "?");
  buf->open.push_back(e);
}

void pt_record_end() {
  if (!g_enabled.load(std::memory_order_acquire)) return;
  ThreadBuffer* buf = tls_buffer();
  if (buf->open.empty()) return;
  Event e = buf->open.back();
  buf->open.pop_back();
  e.end_ns = now_ns();
  buf->events.push_back(e);
}

// One-shot complete span (begin/end supplied by caller, ns).
void pt_record_span(const char* name, uint64_t begin_ns, uint64_t end_ns) {
  if (!g_enabled.load(std::memory_order_acquire)) return;
  ThreadBuffer* buf = tls_buffer();
  Event e;
  e.begin_ns = begin_ns;
  e.end_ns = end_ns;
  e.tid = tid_hash();
  std::snprintf(e.name, sizeof(e.name), "%s", name ? name : "?");
  buf->events.push_back(e);
}

uint64_t pt_now_ns() { return now_ns(); }

int64_t pt_event_count() {
  std::lock_guard<std::mutex> lk(g_registry_mu);
  int64_t n = 0;
  for (auto* b : g_buffers) n += static_cast<int64_t>(b->events.size());
  return n;
}

// Export merged events as chrome://tracing JSON. Returns 0 on success.
int pt_tracer_export(const char* path, const char* process_name) {
  std::lock_guard<std::mutex> lk(g_registry_mu);
  FILE* f = std::fopen(path, "w");
  if (f == nullptr) return -1;
  std::fputs("{\"traceEvents\":[\n", f);
  bool first = true;
  std::fprintf(f,
               "{\"name\":\"process_name\",\"ph\":\"M\",\"pid\":0,"
               "\"args\":{\"name\":\"%s\"}}",
               process_name ? process_name : "paddle_tpu");
  first = false;
  for (auto* b : g_buffers) {
    for (const Event& e : b->events) {
      if (!first) std::fputs(",\n", f);
      first = false;
      double ts_us = (e.begin_ns - g_start_ns) / 1000.0;
      double dur_us = (e.end_ns - e.begin_ns) / 1000.0;
      // escape is unnecessary: names come from our own op registry
      std::fprintf(f,
                   "{\"name\":\"%s\",\"ph\":\"X\",\"pid\":0,"
                   "\"tid\":%llu,\"ts\":%.3f,\"dur\":%.3f}",
                   e.name, static_cast<unsigned long long>(e.tid), ts_us,
                   dur_us);
    }
  }
  std::fputs("\n]}\n", f);
  std::fclose(f);
  return 0;
}

// Copy up to `max_n` merged events into caller-provided arrays
// (names flattened into fixed 120-char rows). Returns copied count.
int64_t pt_tracer_dump(char* names, uint64_t* begins, uint64_t* ends,
                       uint64_t* tids, int64_t max_n) {
  std::lock_guard<std::mutex> lk(g_registry_mu);
  int64_t i = 0;
  for (auto* b : g_buffers) {
    for (const Event& e : b->events) {
      if (i >= max_n) return i;
      std::memcpy(names + i * 120, e.name, 120);
      begins[i] = e.begin_ns;
      ends[i] = e.end_ns;
      tids[i] = e.tid;
      ++i;
    }
  }
  return i;
}

}  // extern "C"
