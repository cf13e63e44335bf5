// Dynamic micro-batching queue for the inference server — the native
// serving runtime (scheduler + completion signaling) behind
// building_gan_torch/serving/server.py (ctypes binding:
// building_gan_torch/serving/batcher.py::NativeBatcher).
//
// Clients (any thread) submit integer request ids; a worker thread fetches
// micro-batches formed under a size-or-deadline policy (close the batch when
// it reaches max_batch, or when the OLDEST queued request has waited
// max_delay_us); after running the model the worker marks the ids complete,
// unblocking the per-request waiters.  Pure C API for ctypes.  Built at
// first use by building_gan_torch/ops/_build.py::build_host (g++ -O2
// -std=c++17 -fPIC -shared -pthread).
//
// The reference has no serving runtime at all (its test.ipynb is a manual
// loop); this is greenfield production surface.

#include <condition_variable>
#include <cstdint>
#include <chrono>
#include <deque>
#include <mutex>
#include <unordered_set>

namespace {

using Clock = std::chrono::steady_clock;

struct Batcher {
  std::mutex mu;
  std::condition_variable queue_cv;    // signaled on submit/shutdown
  std::condition_variable done_cv;     // signaled on completion
  std::condition_variable drain_cv;    // signaled when the last waiter leaves
  std::deque<std::pair<int64_t, Clock::time_point>> queue;
  std::unordered_set<int64_t> done;
  int32_t max_batch;
  int64_t max_delay_us;
  int32_t waiters = 0;  // threads blocked in sb_wait / sb_next_batch
  bool shutdown = false;
};

// RAII waiter count: sb_destroy must not free the Batcher while any thread
// still sleeps on its mutex/condvars (use-after-free otherwise).
struct WaiterGuard {
  explicit WaiterGuard(Batcher* b) : b_(b) { ++b_->waiters; }  // caller holds mu
  ~WaiterGuard() {
    if (--b_->waiters == 0) b_->drain_cv.notify_all();
  }
  Batcher* b_;
};

}  // namespace

extern "C" {

void* sb_create(int32_t max_batch, int64_t max_delay_us) {
  auto* b = new Batcher();
  b->max_batch = max_batch > 0 ? max_batch : 1;
  b->max_delay_us = max_delay_us >= 0 ? max_delay_us : 0;
  return b;
}

// Shut down, wait for every blocked waiter to drain, then free.  Safe to
// call while sb_wait / sb_next_batch calls are in flight on other threads.
void sb_destroy(void* h) {
  auto* b = static_cast<Batcher*>(h);
  {
    std::unique_lock<std::mutex> lk(b->mu);
    b->shutdown = true;
    b->queue_cv.notify_all();
    b->done_cv.notify_all();
    while (b->waiters > 0) b->drain_cv.wait(lk);
  }
  delete b;
}

void sb_shutdown(void* h) {
  auto* b = static_cast<Batcher*>(h);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    b->shutdown = true;
  }
  b->queue_cv.notify_all();
  b->done_cv.notify_all();
}

// Enqueue a request id.  Returns 0, or -1 after shutdown.
int32_t sb_submit(void* h, int64_t request_id) {
  auto* b = static_cast<Batcher*>(h);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    if (b->shutdown) return -1;
    b->queue.emplace_back(request_id, Clock::now());
  }
  b->queue_cv.notify_one();
  return 0;
}

// Blockingly fetch the next micro-batch into out_ids (capacity cap).
// Returns the batch size, 0 on poll timeout, or -1 after shutdown.
int32_t sb_next_batch(void* h, int64_t* out_ids, int32_t cap,
                      int64_t poll_timeout_us) {
  auto* b = static_cast<Batcher*>(h);
  std::unique_lock<std::mutex> lk(b->mu);
  WaiterGuard guard(b);
  const auto poll_deadline =
      Clock::now() + std::chrono::microseconds(poll_timeout_us);

  // wait for the first request (or give up at poll_deadline)
  while (b->queue.empty() && !b->shutdown) {
    if (b->queue_cv.wait_until(lk, poll_deadline) == std::cv_status::timeout &&
        b->queue.empty()) {
      return b->shutdown ? -1 : 0;
    }
  }
  if (b->shutdown && b->queue.empty()) return -1;

  // batch closes when full, or max_delay_us after the OLDEST request arrived
  const auto close_at =
      b->queue.front().second + std::chrono::microseconds(b->max_delay_us);
  const int32_t want = b->max_batch < cap ? b->max_batch : cap;
  while (static_cast<int32_t>(b->queue.size()) < want && !b->shutdown) {
    if (b->queue_cv.wait_until(lk, close_at) == std::cv_status::timeout) break;
  }

  int32_t n = 0;
  while (n < want && !b->queue.empty()) {
    out_ids[n++] = b->queue.front().first;
    b->queue.pop_front();
  }
  return n;
}

// Mark ids complete and wake their waiters.
void sb_complete(void* h, const int64_t* ids, int32_t n) {
  auto* b = static_cast<Batcher*>(h);
  {
    std::lock_guard<std::mutex> lk(b->mu);
    for (int32_t i = 0; i < n; ++i) b->done.insert(ids[i]);
  }
  b->done_cv.notify_all();
}

// Block until request_id completes.  Returns 0 on success, -2 on timeout,
// -1 on shutdown.  The id is consumed (single waiter per id).
int32_t sb_wait(void* h, int64_t request_id, int64_t timeout_us) {
  auto* b = static_cast<Batcher*>(h);
  std::unique_lock<std::mutex> lk(b->mu);
  WaiterGuard guard(b);
  const auto deadline = Clock::now() + std::chrono::microseconds(timeout_us);
  while (true) {
    auto it = b->done.find(request_id);
    if (it != b->done.end()) {
      b->done.erase(it);
      return 0;
    }
    if (b->shutdown) return -1;
    if (b->done_cv.wait_until(lk, deadline) == std::cv_status::timeout) {
      if (b->done.count(request_id)) {
        b->done.erase(request_id);
        return 0;
      }
      return -2;
    }
  }
}

// Queue depth (diagnostics).
int32_t sb_pending(void* h) {
  auto* b = static_cast<Batcher*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  return static_cast<int32_t>(b->queue.size());
}

}  // extern "C"
