// graftprof sampler: one native thread per process snapshots
// per-registered-thread CPU time and GIL acquire latency into a
// lock-free fixed-record ring (SURVEY §5.1 — the reference profiles
// out-of-process and on demand via py-spy attach + reporter-agent
// flame graphs; an in-process always-on sampler sees every window and
// can carry task attribution).
//
// Design constraints, in order (inherited from scope_core.cc):
//   1. The sampled threads pay nothing: the sampler reads their CPU
//      clocks from outside (CLOCK_THREAD_CPUTIME_ID via the clockid
//      handed over at registration); no signals, no interpreter
//      interruption, no per-call instrumentation.
//   2. Losing records under overload is fine; corrupting them is not.
//      Single-writer ring (only the sampler emits) with the same
//      lap-detecting drain as the graftscope rings.
//   3. The GIL probe must never touch the interpreter during
//      finalization: the Python seam joins the sampler (prof_stop)
//      from atexit before teardown, and the probe only runs between
//      prof_start and prof_stop.
//
// No static destructors: globals are PODs/atomics only, cold-path
// mutual exclusion is atomic_flag spinlocks (registration happens at
// thread birth; detached sidecar threads may die after main()).

#include "prof_core.h"

#include <atomic>
#include <cstring>
#include <ctime>

#include <pthread.h>
#include <stdlib.h>
#include <strings.h>

namespace {

inline void CpuRelax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#elif defined(__aarch64__)
  asm volatile("yield" ::: "memory");
#endif
}

struct SpinLock {
  std::atomic_flag f = ATOMIC_FLAG_INIT;
  void lock() {
    while (f.test_and_set(std::memory_order_acquire)) {
      CpuRelax();
    }
  }
  void unlock() { f.clear(std::memory_order_release); }
};
struct SpinGuard {
  SpinLock& l;
  explicit SpinGuard(SpinLock& lk) : l(lk) { l.lock(); }
  ~SpinGuard() { l.unlock(); }
};

uint64_t NowNs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// --- registered-thread table ----------------------------------------------

// Slot states: free -> active -> dead. Dead slots keep their name and
// cumulative CPU total (an exited sidecar thread stays attributed in
// `prof top`); they are reused only when the table would otherwise
// overflow.
constexpr int kSlotFree = 0, kSlotActive = 1, kSlotDead = 2;

struct ProfThread {
  std::atomic<int> state{kSlotFree};
  clockid_t clk{};                     // sampler-only after registration
  char name[kProfNameCap] = {0};       // written under g_table_lock
  uint64_t last_cpu_ns = 0;            // sampler-only
  std::atomic<uint64_t> cum_cpu_ns{0};
};

ProfThread g_threads[kProfMaxThreads];
std::atomic<int> g_high_water{0};  // slots ever handed out
SpinLock g_table_lock;

// Mark the slot dead (not free) when its thread exits: the sampler
// stops reading a clockid that no longer exists, but the cumulative
// total stays visible.
struct ProfLease {
  int slot = -1;
  ~ProfLease() {
    if (slot >= 0) {
      g_threads[slot].state.store(kSlotDead, std::memory_order_release);
    }
  }
};
thread_local ProfLease t_prof_lease;

// --- sample ring (single writer: the sampler thread) ----------------------

std::atomic<uint64_t> g_head{0};
uint64_t g_tail = 0;  // drainer cursor, under g_drain_lock
std::atomic<uint64_t> g_ring[kProfRingCap * 3];
SpinLock g_drain_lock;
std::atomic<uint64_t> g_dropped{0};
std::atomic<uint64_t> g_ticks{0};

void EmitRec(uint8_t kind, uint8_t slot, uint16_t flags, uint32_t val_us,
             uint64_t tick, uint64_t t_ns) {
  uint64_t w0 = (uint64_t)kind | ((uint64_t)slot << 8) |
                ((uint64_t)flags << 16) | ((uint64_t)val_us << 32);
  uint64_t h = g_head.load(std::memory_order_relaxed);
  size_t i = (size_t)(h & (kProfRingCap - 1)) * 3;
  g_ring[i].store(w0, std::memory_order_relaxed);
  g_ring[i + 1].store(tick, std::memory_order_relaxed);
  g_ring[i + 2].store(t_ns, std::memory_order_relaxed);
  g_head.store(h + 1, std::memory_order_release);
}

// --- enabled flag ---------------------------------------------------------

std::atomic<int> g_enabled{-1};  // -1 = resolve from env on first use

int ResolveEnabled() {
  const char* v = getenv("RAY_TPU_TORCH_GRAFTPROF");
  int on = 1;
  if (v != nullptr &&
      (strcmp(v, "0") == 0 || strcasecmp(v, "false") == 0 ||
       strcasecmp(v, "off") == 0 || strcasecmp(v, "no") == 0)) {
    on = 0;
  }
  // Pure flag, no payload to publish: relaxed on both outcomes.
  int expected = -1;
  g_enabled.compare_exchange_strong(expected, on,
                                    std::memory_order_relaxed,
                                    std::memory_order_relaxed);
  return g_enabled.load(std::memory_order_relaxed);
}

// --- GIL probe ------------------------------------------------------------

typedef int (*GilEnsureFn)(void);
typedef void (*GilReleaseFn)(int);

std::atomic<void*> g_gil_ensure{nullptr};
std::atomic<void*> g_gil_release{nullptr};
std::atomic<uint64_t> g_gil_wait_ns{0};
std::atomic<uint64_t> g_gil_probes{0};

// One GIL probe every this-many ticks (~8 Hz at the default 67 Hz).
constexpr uint64_t kGilProbeStride = 8;

// --- sampler thread -------------------------------------------------------

std::atomic<int> g_run{0};
std::atomic<int> g_hz{kProfDefaultHz};
pthread_t g_sampler{};
int g_sampler_started = 0;  // under g_start_lock
SpinLock g_start_lock;

// Returns true when any registered thread burned CPU this tick — the
// idle-backoff signal for the sampler loop.
bool SampleTick(uint64_t tick, uint64_t now_ns, uint64_t period_ns) {
  EmitRec(kProfTick, 0, 0,
          (uint32_t)(period_ns / 1000 > 0xFFFFFFFFull
                         ? 0xFFFFFFFFull
                         : period_ns / 1000),
          tick, now_ns);
  bool active = false;
  int slots = g_high_water.load(std::memory_order_acquire);
  for (int s = 0; s < slots; s++) {
    ProfThread* t = &g_threads[s];
    if (t->state.load(std::memory_order_acquire) != kSlotActive) continue;
    timespec ts;
    if (clock_gettime(t->clk, &ts) != 0) {
      // The thread exited without running its lease destructor (e.g.
      // pthread_exit from foreign code): freeze its totals.
      t->state.store(kSlotDead, std::memory_order_release);
      continue;
    }
    uint64_t cpu =
        (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
    uint64_t d = cpu > t->last_cpu_ns ? cpu - t->last_cpu_ns : 0;
    t->last_cpu_ns = cpu;
    t->cum_cpu_ns.fetch_add(d, std::memory_order_relaxed);
    // A delta under ~100us over a whole period is scheduler noise (the
    // sampler's own bookkeeping shows up here), not workload.
    if (d > 100000ull) active = true;
    uint64_t d_us = d / 1000;
    EmitRec(kProfThreadCpu, (uint8_t)s, 0,
            (uint32_t)(d_us > 0xFFFFFFFFull ? 0xFFFFFFFFull : d_us),
            tick, now_ns);
  }
  GilEnsureFn ensure =
      (GilEnsureFn)g_gil_ensure.load(std::memory_order_acquire);
  GilReleaseFn release =
      (GilReleaseFn)g_gil_release.load(std::memory_order_acquire);
  // Probe the GIL on a stride, not every tick: each probe forces a GIL
  // handoff in the host process, and at full tick rate across every
  // worker on a small host that tax is measurable. A long hold is still
  // measured end-to-end — the probe blocks inside ensure() for the
  // remainder of whatever hold it lands in.
  if (ensure != nullptr && release != nullptr &&
      tick % kGilProbeStride == 0) {
    uint64_t t0 = NowNs();
    int st = ensure();
    uint64_t dt = NowNs() - t0;
    release(st);
    g_gil_wait_ns.fetch_add(dt, std::memory_order_relaxed);
    g_gil_probes.fetch_add(1, std::memory_order_relaxed);
    uint64_t w_us = dt / 1000;
    EmitRec(kProfGilWait, 0, 0,
            (uint32_t)(w_us > 0xFFFFFFFFull ? 0xFFFFFFFFull : w_us),
            tick, NowNs());
  }
  return active;
}

// Idle ticks stretch the sleep exponentially (1, 2, 4, 8, 16 periods);
// one active tick snaps back to full rate. On a core-starved host the
// wakeups themselves are the profiler's cost — a parked worker at the
// default 67 Hz was paying 75 context switches a second (67 ticks +
// 8 GIL probes) to observe nothing. The CPU-delta totals stay exact
// across stretched sleeps (they are cumulative clocks, not samples),
// only the reporting granularity coarsens while idle.
constexpr uint64_t kIdleStretchMax = 16;

void* SamplerLoop(void*) {
  prof_register_thread("graftprof-sampler");
  uint64_t last_ns = NowNs();
  uint64_t idle = 0;
  while (g_run.load(std::memory_order_acquire)) {
    int hz = g_hz.load(std::memory_order_relaxed);
    if (hz <= 0) hz = kProfDefaultHz;
    uint64_t period_ns = 1000000000ull / (uint64_t)hz;
    uint64_t stretch = idle < 4 ? (1ull << idle) : kIdleStretchMax;
    uint64_t sleep_ns = period_ns * stretch;
    timespec req;
    req.tv_sec = (time_t)(sleep_ns / 1000000000ull);
    req.tv_nsec = (long)(sleep_ns % 1000000000ull);
    nanosleep(&req, nullptr);
    if (!g_run.load(std::memory_order_acquire)) break;
    if (prof_enabled()) {
      uint64_t now = NowNs();
      uint64_t tick =
          g_ticks.fetch_add(1, std::memory_order_relaxed) + 1;
      bool active =
          SampleTick(tick, now, now > last_ns ? now - last_ns : period_ns);
      last_ns = now;
      idle = active ? 0 : idle + 1;
    } else {
      last_ns = NowNs();  // keep the next period honest after re-enable
      idle = idle + 1;    // disabled is as idle as it gets
    }
  }
  return nullptr;
}

}  // namespace

extern "C" {

int prof_register_thread(const char* name) {
  if (t_prof_lease.slot >= 0) return t_prof_lease.slot;
  clockid_t clk;
  if (pthread_getcpuclockid(pthread_self(), &clk) != 0) return -1;
  timespec ts;
  uint64_t cpu0 = 0;
  if (clock_gettime(clk, &ts) == 0) {
    cpu0 = (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
  }
  SpinGuard g(g_table_lock);
  int s = -1;
  int hw = g_high_water.load(std::memory_order_relaxed);
  if (hw < kProfMaxThreads) {
    s = hw;
  } else {
    // Full table: reuse a dead slot (its frozen total is forfeited to
    // keep live threads observable).
    for (int i = 0; i < kProfMaxThreads; i++) {
      if (g_threads[i].state.load(std::memory_order_relaxed)
          == kSlotDead) {
        s = i;
        break;
      }
    }
    if (s < 0) return -1;
  }
  ProfThread* t = &g_threads[s];
  t->clk = clk;
  t->last_cpu_ns = cpu0;
  t->cum_cpu_ns.store(0, std::memory_order_relaxed);
  size_t n = name != nullptr ? strlen(name) : 0;
  if (n >= kProfNameCap) n = kProfNameCap - 1;
  if (n > 0) memcpy(t->name, name, n);
  t->name[n] = '\0';
  // Publish the slot's clk/name/counters before the sampler can see
  // state == active.
  t->state.store(kSlotActive, std::memory_order_release);
  if (s == hw) {
    g_high_water.store(hw + 1, std::memory_order_release);
  }
  t_prof_lease.slot = s;
  return s;
}

void prof_set_gil_fns(void* ensure_fn, void* release_fn) {
  // Publish the pair; the sampler re-reads both with acquire each tick
  // and only probes when both are non-null.
  g_gil_ensure.store(ensure_fn, std::memory_order_release);
  g_gil_release.store(release_fn, std::memory_order_release);
}

int prof_start(int hz) {
  SpinGuard g(g_start_lock);
  g_hz.store(hz > 0 ? hz : kProfDefaultHz, std::memory_order_relaxed);
  if (g_sampler_started) return 0;
  g_run.store(1, std::memory_order_release);
  if (pthread_create(&g_sampler, nullptr, SamplerLoop, nullptr) != 0) {
    g_run.store(0, std::memory_order_release);
    return -1;
  }
  g_sampler_started = 1;
  return 0;
}

void prof_stop(void) {
  SpinGuard g(g_start_lock);
  if (!g_sampler_started) return;
  g_run.store(0, std::memory_order_release);
  pthread_join(g_sampler, nullptr);
  g_sampler_started = 0;
}

int prof_enabled(void) {
  int e = g_enabled.load(std::memory_order_relaxed);
  return e < 0 ? ResolveEnabled() : e;
}

void prof_set_enabled(int on) {
  g_enabled.store(on ? 1 : 0, std::memory_order_relaxed);
}

int prof_drain(char* buf, int cap) {
  SpinGuard dg(g_drain_lock);
  int n = 0;
  uint64_t head = g_head.load(std::memory_order_acquire);
  uint64_t t = g_tail;
  if (head - t >= kProfRingCap) {
    uint64_t safe = head - kProfRingCap + 1;
    g_dropped.fetch_add(safe - t, std::memory_order_relaxed);
    t = safe;
  }
  while (t < head) {
    if (n + kProfRecordSize > cap) break;
    size_t i = (size_t)(t & (kProfRingCap - 1)) * 3;
    uint64_t w0 = g_ring[i].load(std::memory_order_relaxed);
    uint64_t w1 = g_ring[i + 1].load(std::memory_order_relaxed);
    uint64_t w2 = g_ring[i + 2].load(std::memory_order_relaxed);
    // Lap check: if the sampler reached t + cap while we copied, the
    // slot may hold a half-written newer record — discard and skip to
    // the new safe window.
    uint64_t h2 = g_head.load(std::memory_order_acquire);
    if (h2 - t >= kProfRingCap) {
      uint64_t safe = h2 - kProfRingCap + 1;
      g_dropped.fetch_add(safe - t, std::memory_order_relaxed);
      t = safe;
      head = h2;
      continue;
    }
    ProfWireRec rec;
    rec.kind = (uint8_t)(w0 & 0xff);
    rec.slot = (uint8_t)((w0 >> 8) & 0xff);
    rec.flags = (uint16_t)((w0 >> 16) & 0xffff);
    rec.val_us = (uint32_t)(w0 >> 32);
    rec.tick = w1;
    rec.t_ns = w2;
    std::memcpy(buf + n, &rec, kProfRecordSize);
    n += kProfRecordSize;
    t++;
  }
  g_tail = t;
  return n;
}

uint64_t prof_dropped(void) {
  return g_dropped.load(std::memory_order_relaxed);
}

uint64_t prof_ticks(void) {
  return g_ticks.load(std::memory_order_relaxed);
}

int prof_thread_count(void) {
  return g_high_water.load(std::memory_order_acquire);
}

int prof_thread_cpu_ns(uint64_t* out, int max_slots) {
  int hw = g_high_water.load(std::memory_order_acquire);
  int k = max_slots < hw ? max_slots : hw;
  for (int s = 0; s < k; s++) {
    out[s] = g_threads[s].cum_cpu_ns.load(std::memory_order_relaxed);
  }
  return k;
}

int prof_thread_name(int slot, char* buf, int cap) {
  if (slot < 0 || slot >= g_high_water.load(std::memory_order_acquire)) {
    return -1;
  }
  if (g_threads[slot].state.load(std::memory_order_acquire)
      == kSlotFree) {
    return -1;
  }
  SpinGuard g(g_table_lock);  // names are written under the table lock
  int n = (int)strlen(g_threads[slot].name);
  if (n >= cap) n = cap - 1;
  if (n > 0) memcpy(buf, g_threads[slot].name, (size_t)n);
  if (cap > 0) buf[n] = '\0';
  return n;
}

uint64_t prof_gil_wait_ns(void) {
  return g_gil_wait_ns.load(std::memory_order_relaxed);
}

uint64_t prof_gil_probes(void) {
  return g_gil_probes.load(std::memory_order_relaxed);
}

}  // extern "C"
