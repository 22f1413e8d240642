// graftcopy: vectored, GIL-free copy engine for the object-store put
// plane.
//
// The put hot path serializes a value into pickle-5 out-of-band buffer
// segments and lands them in a tmpfs object file. Python can drive that
// with os.pwritev (one syscall, GIL dropped for its duration), but a
// single thread tops out at the per-core copy bandwidth; the reference's
// plasma client hits the same wall and parallelizes its memcpy
// (reference: src/ray/object_manager/plasma/client.cc WriteObject /
// plasma putting via multiple memcpy threads). This engine does the
// same for the file-backed layout: `copy_write_scatter` splits the
// segment list into fixed-size chunks and fans them out over a small
// worker pool, with the CALLING thread participating so a put never
// waits on a parked pool. On 1-core hosts the pool is empty and the
// caller runs the chunks sequentially — same syscall pattern as
// pwritev, no thread ping-pong.
//
// Also exported here: `copy_linkat`, the O_TMPFILE+linkat ingredient of
// the fused put pipeline (CPython's os.link cannot express
// AT_SYMLINK_FOLLOW on a /proc/self/fd source, so the atomic
// link-into-the-store-dir step needs a native helper).
//
// Exposed via libraytpu_torch_store.so next to the store engine; bound in
// ray_tpu_torch/core/object_store.py::_load_lib and wrapped by
// ray_tpu_torch/core/_native/graftcopy.py.

#include <atomic>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

#include "prof_core.h"
#include "scope_core.h"

extern "C" {
// One scatter segment: copy `len` bytes from `src` to file offset `off`.
// Mirrored field-for-field by the ctypes CopySeg struct in
// ray_tpu_torch/core/_native/graftcopy.py (lint pass 3d checks the binding
// signatures; keep the layout in sync).
typedef struct {
  const void* src;
  uint64_t len;
  uint64_t off;
} CopySeg;
}

namespace {

// Split unit: big enough that per-chunk overhead (one pwrite, one
// atomic fetch_add) is noise, small enough that a GiB put spreads over
// every worker.
constexpr uint64_t kCopyChunk = 8ull << 20;

int PwriteFull(int fd, const char* p, uint64_t n, uint64_t off) {
  while (n > 0) {
    ssize_t w = ::pwrite(fd, p, n, (off_t)off);
    if (w < 0) {
      if (errno == EINTR) continue;
      return errno ? errno : EIO;
    }
    p += w;
    n -= (uint64_t)w;
    off += (uint64_t)w;
  }
  return 0;
}

struct Job {
  int fd = -1;
  std::vector<CopySeg> chunks;   // pre-split; read-only once published
  std::atomic<size_t> next{0};   // claim cursor
  std::atomic<size_t> done{0};   // completed chunks
  std::atomic<int> err{0};       // first errno observed
};

// Claim-and-copy until the job's chunks are exhausted. Runs on workers
// AND the calling thread; the atomic cursor makes work-stealing free.
void RunChunks(Job* j) {
  for (;;) {
    size_t i = j->next.fetch_add(1, std::memory_order_relaxed);
    if (i >= j->chunks.size()) return;
    const CopySeg& c = j->chunks[i];
    int rc = PwriteFull(j->fd, static_cast<const char*>(c.src), c.len,
                        c.off);
    if (rc != 0) {
      // Relaxed is enough: the err CAS is sequenced before our
      // done.fetch_add(acq_rel) below, and the waiter only reads err
      // after done.load(acquire) observes the final count — the done
      // release sequence carries the err value across.
      int expected = 0;
      j->err.compare_exchange_strong(expected, rc,
                                     std::memory_order_relaxed,
                                     std::memory_order_relaxed);
    }
    j->done.fetch_add(1, std::memory_order_acq_rel);
  }
}

struct Engine {
  std::mutex mu;
  std::condition_variable cv_work;  // workers park here
  std::condition_variable cv_done;  // callers wait for their job
  std::deque<std::shared_ptr<Job>> queue;
  std::vector<std::thread> workers;
  bool stopping = false;
};

void WorkerLoop(Engine* e) {
  prof_register_thread("graftcopy-worker");
  std::unique_lock<std::mutex> lk(e->mu);
  for (;;) {
    while (!e->stopping && e->queue.empty()) e->cv_work.wait(lk);
    if (e->stopping) return;
    // shared_ptr copy keeps the job alive even if the caller returns
    // while this worker is between chunks.
    std::shared_ptr<Job> j = e->queue.front();
    lk.unlock();
    RunChunks(j.get());
    lk.lock();
    // RunChunks only returns once every chunk is claimed, so the job
    // can leave the queue (later workers would find nothing to do).
    if (!e->queue.empty() && e->queue.front() == j) e->queue.pop_front();
    if (j->done.load(std::memory_order_acquire) >= j->chunks.size()) {
      e->cv_done.notify_all();
    }
  }
}

}  // namespace

extern "C" {

// nthreads <= 0: auto-size to hardware cores minus one (the caller
// participates, so a pool of cores-1 saturates the machine without
// oversubscribing). A 1-core host gets an empty pool — every scatter
// runs sequentially on the calling thread, no threads, no locks.
void* copy_engine_create(int nthreads) {
  auto* e = new Engine();
  if (nthreads < 0) nthreads = 0;
  if (nthreads == 0) {
    unsigned hw = std::thread::hardware_concurrency();
    nthreads = hw > 1 ? (int)hw - 1 : 0;
    if (nthreads > 16) nthreads = 16;
  }
  for (int i = 0; i < nthreads; i++) {
    e->workers.emplace_back(WorkerLoop, e);
  }
  return e;
}

void copy_engine_destroy(void* handle) {
  auto* e = static_cast<Engine*>(handle);
  {
    std::lock_guard<std::mutex> g(e->mu);
    e->stopping = true;
  }
  e->cv_work.notify_all();
  for (auto& t : e->workers) t.join();
  delete e;
}

int copy_engine_threads(void* handle) {
  return (int)static_cast<Engine*>(handle)->workers.size();
}

// Copy every segment into fd. Returns 0 on success, -errno on the first
// write error (all claimed chunks still run to completion so no thread
// is left touching caller memory after return).
int copy_write_scatter(void* handle, int fd, const CopySeg* segs,
                       int nsegs) {
  auto* e = static_cast<Engine*>(handle);
  if (nsegs <= 0) return 0;

  uint64_t t0 = scope_enabled() ? scope_now_ns() : 0;
  // graftscope span-in-one on every exit: seq_or_oid = start_ns,
  // t_ns = end_ns, size = bytes (u32-clipped), op = 1 on error.
  auto scoped = [t0](uint64_t total, int rc) {
    if (t0 != 0) {
      uint64_t t1 = scope_now_ns();
      uint32_t sz = total > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)total;
      scope_emit(kScopeCopyScatter, rc == 0 ? 0 : 1, 0, sz, t0, t1,
                 t1 - t0);
    }
    return rc;
  };

  // Sequential path: no pool, or too little data to amortize a handoff.
  uint64_t total = 0;
  for (int i = 0; i < nsegs; i++) total += segs[i].len;
  if (e->workers.empty() || total <= kCopyChunk) {
    for (int i = 0; i < nsegs; i++) {
      int rc = PwriteFull(fd, static_cast<const char*>(segs[i].src),
                          segs[i].len, segs[i].off);
      if (rc != 0) return scoped(total, -rc);
    }
    return scoped(total, 0);
  }

  auto job = std::make_shared<Job>();
  job->fd = fd;
  job->chunks.reserve((size_t)(total / kCopyChunk) + (size_t)nsegs);
  for (int i = 0; i < nsegs; i++) {
    const char* p = static_cast<const char*>(segs[i].src);
    uint64_t len = segs[i].len, off = segs[i].off;
    while (len > 0) {
      uint64_t n = len < kCopyChunk ? len : kCopyChunk;
      job->chunks.push_back(CopySeg{p, n, off});
      p += n;
      off += n;
      len -= n;
    }
  }
  {
    std::lock_guard<std::mutex> g(e->mu);
    e->queue.push_back(job);
  }
  e->cv_work.notify_all();
  RunChunks(job.get());  // caller participates
  std::unique_lock<std::mutex> lk(e->mu);
  // Our RunChunks exhausted the claim cursor; drop the job from the
  // queue if no worker got there first.
  for (auto it = e->queue.begin(); it != e->queue.end(); ++it) {
    if (*it == job) {
      e->queue.erase(it);
      break;
    }
  }
  while (job->done.load(std::memory_order_acquire) < job->chunks.size()) {
    e->cv_done.wait(lk);
  }
  // Ordered by the done.load(acquire) above; see RunChunks.
  return scoped(total, -job->err.load(std::memory_order_relaxed));
}

// Atomically link the (possibly anonymous O_TMPFILE) fd's file at dst.
// 0 ok, -errno on failure (-EEXIST: dst already exists).
int copy_linkat(int src_fd, const char* dst) {
  char proc[64];
  std::snprintf(proc, sizeof proc, "/proc/self/fd/%d", src_fd);
  int rc = 0;
  if (::linkat(AT_FDCWD, proc, AT_FDCWD, dst, AT_SYMLINK_FOLLOW) != 0) {
    rc = errno ? -errno : -EIO;
  }
  scope_emit(kScopeCopyLink, rc == 0 ? 0 : 1, 0, 0, 0, 0, 0);
  return rc;
}

}  // extern "C"
