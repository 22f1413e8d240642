// Unit tests for the graftprof sampler (prof_core.cc). Run plain and
// under TSAN/ASAN in CI — the drain-while-sampling test exercises the
// single-writer ring against a concurrent drainer, and the
// registration storm exercises the slot table against the sampler's
// scan.

#include "prof_core.h"

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <thread>
#include <vector>

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      std::fprintf(stderr, "FAIL %s:%d: %s\n", __FILE__, __LINE__,     \
                   #cond);                                             \
      std::abort();                                                    \
    }                                                                  \
  } while (0)

namespace {

struct Rec {
  uint8_t kind, slot;
  uint16_t flags;
  uint32_t val_us;
  uint64_t tick, t_ns;
};

std::vector<Rec> DrainOnce() {
  std::vector<Rec> out;
  std::vector<char> buf(1 << 20);
  int n = prof_drain(buf.data(), (int)buf.size());
  CHECK(n >= 0);
  CHECK(n % kProfRecordSize == 0);
  for (int i = 0; i < n; i += kProfRecordSize) {
    ProfWireRec w;
    std::memcpy(&w, buf.data() + i, kProfRecordSize);
    out.push_back(Rec{w.kind, w.slot, w.flags, w.val_us, w.tick, w.t_ns});
  }
  return out;
}

std::vector<Rec> Drain() {
  std::vector<Rec> out;
  for (;;) {
    auto recs = DrainOnce();
    if (recs.empty()) return out;
    out.insert(out.end(), recs.begin(), recs.end());
  }
}

void SleepMs(int ms) {
  timespec req;
  req.tv_sec = ms / 1000;
  req.tv_nsec = (long)(ms % 1000) * 1000000L;
  nanosleep(&req, nullptr);
}

uint64_t MonoNs() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

// Fake GIL: ensure() burns ~200us before "acquiring" so the probe has
// a contended wait to measure; release() checks the state cookie made
// the round trip.
std::atomic<uint64_t> g_fake_releases{0};

int FakeEnsure() {
  uint64_t t0 = MonoNs();
  while (MonoNs() - t0 < 200 * 1000) {
  }
  return 7;
}

void FakeRelease(int st) {
  if (st == 7) g_fake_releases.fetch_add(1, std::memory_order_relaxed);
}

int TestRegistration() {
  int s0 = prof_register_thread("main");
  CHECK(s0 >= 0);
  // Idempotent for the same thread.
  CHECK(prof_register_thread("main") == s0);
  char name[kProfNameCap];
  CHECK(prof_thread_name(s0, name, sizeof(name)) == 4);
  CHECK(std::string(name) == "main");
  CHECK(prof_thread_count() >= 1);
  CHECK(prof_thread_name(kProfMaxThreads + 1, name, sizeof(name)) == -1);
  return 0;
}

int TestCpuAttribution() {
  prof_set_enabled(1);
  Drain();
  std::atomic<bool> stop{false};
  std::atomic<int> spin_slot{-1}, idle_slot{-1};
  std::thread spinner([&] {
    spin_slot.store(prof_register_thread("spinner"),
                    std::memory_order_release);
    while (!stop.load(std::memory_order_relaxed)) {
    }
  });
  std::thread idler([&] {
    idle_slot.store(prof_register_thread("idler"),
                    std::memory_order_release);
    while (!stop.load(std::memory_order_relaxed)) {
      SleepMs(5);
    }
  });
  while (spin_slot.load(std::memory_order_acquire) < 0 ||
         idle_slot.load(std::memory_order_acquire) < 0) {
    SleepMs(1);
  }
  CHECK(prof_start(200) == 0);
  SleepMs(400);
  int ss = spin_slot.load(std::memory_order_acquire);
  int is = idle_slot.load(std::memory_order_acquire);
  CHECK(ss >= 0 && is >= 0 && ss != is);
  uint64_t cpu[kProfMaxThreads] = {0};
  int k = prof_thread_cpu_ns(cpu, kProfMaxThreads);
  CHECK(k > ss && k > is);
  // The spinner burned a core for ~400ms; the idler slept. Require a
  // 10x separation (generous for a loaded CI host).
  CHECK(cpu[ss] > 50ull * 1000 * 1000);
  CHECK(cpu[ss] > 10 * (cpu[is] + 1));
  // The ring carries per-tick deltas for both slots, tick markers, and
  // monotone tick ordinals.
  auto recs = Drain();
  CHECK(!recs.empty());
  uint64_t last_tick = 0;
  bool saw_spin = false, saw_idle = false, saw_tick = false;
  uint64_t spin_us = 0, idle_us = 0;
  for (const Rec& r : recs) {
    CHECK(r.kind >= 1 && r.kind < kProfKindCount);
    CHECK(r.tick >= last_tick);
    last_tick = r.tick;
    if (r.kind == kProfTick) saw_tick = true;
    if (r.kind == kProfThreadCpu && r.slot == (uint8_t)ss) {
      saw_spin = true;
      spin_us += r.val_us;
    }
    if (r.kind == kProfThreadCpu && r.slot == (uint8_t)is) {
      saw_idle = true;
      idle_us += r.val_us;
    }
  }
  CHECK(saw_tick && saw_spin && saw_idle);
  CHECK(spin_us > 10 * (idle_us + 1));
  CHECK(prof_ticks() > 0);
  stop.store(true);
  spinner.join();
  idler.join();
  return 0;
}

int TestGilProbe() {
  prof_set_enabled(1);
  Drain();
  uint64_t wait0 = prof_gil_wait_ns();
  uint64_t probes0 = prof_gil_probes();
  prof_set_gil_fns((void*)&FakeEnsure, (void*)&FakeRelease);
  // With no registered thread burning CPU the sampler stretches its
  // ticks up to 16 periods, and it probes every 8th tick, so a fixed
  // 300 ms window may hold no probe (seen on a gVisor host). Wait 300
  // ms, then on until a probe has run or 5 s have passed.
  uint64_t probe_deadline = MonoNs() + 5000ull * 1000 * 1000;
  SleepMs(300);
  while (prof_gil_probes() == probes0 && MonoNs() < probe_deadline) {
    SleepMs(10);
  }
  prof_set_gil_fns(nullptr, nullptr);
  uint64_t probes = prof_gil_probes() - probes0;
  uint64_t waited = prof_gil_wait_ns() - wait0;
  CHECK(probes > 0);
  // Every fake acquire burns ~200us.
  CHECK(waited >= probes * 150ull * 1000);
  CHECK(g_fake_releases.load(std::memory_order_relaxed) >= probes);
  bool saw_gil = false;
  for (const Rec& r : Drain()) {
    if (r.kind == kProfGilWait) {
      saw_gil = true;
      CHECK(r.val_us >= 150);
    }
  }
  CHECK(saw_gil);
  return 0;
}

int TestDisable() {
  prof_set_enabled(0);
  CHECK(prof_enabled() == 0);
  Drain();
  uint64_t ticks0 = prof_ticks();
  SleepMs(150);
  CHECK(prof_ticks() == ticks0);
  CHECK(Drain().empty());
  prof_set_enabled(1);
  CHECK(prof_enabled() == 1);
  SleepMs(150);
  CHECK(prof_ticks() > ticks0);
  CHECK(!Drain().empty());
  return 0;
}

int TestDrainWhileSampling() {
  prof_set_enabled(1);
  // Concurrent drainers against the live sampler: every record that
  // survives the lap check must be well-formed with non-decreasing
  // ticks per drainer pass.
  std::atomic<bool> stop{false};
  std::thread churn([&] {
    // Thread churn: registrations racing the sampler's table scan.
    while (!stop.load(std::memory_order_relaxed)) {
      std::thread t([] { prof_register_thread("churn"); });
      t.join();
      SleepMs(2);
    }
  });
  uint64_t deadline = MonoNs() + 500ull * 1000 * 1000;
  while (MonoNs() < deadline) {
    for (const Rec& r : DrainOnce()) {
      CHECK(r.kind >= 1 && r.kind < kProfKindCount);
      CHECK(r.slot < kProfMaxThreads);
    }
  }
  stop.store(true);
  churn.join();
  return 0;
}

int TestWraparound() {
  prof_set_enabled(1);
  // Without a drainer the ring laps: several records per tick at
  // 997 Hz overflow kProfRingCap well inside the window. Losses are
  // accounted when a drain detects the lap (same as the scope rings),
  // so poll via DrainOnce. A registered thread burns CPU throughout
  // the window — an idle process no longer ticks at full rate (the
  // sampler stretches its sleep up to 16x), and ring overflow is an
  // under-load phenomenon anyway.
  Drain();
  uint64_t dropped0 = prof_dropped();
  uint64_t ticks0 = prof_ticks();
  prof_start(997);  // raises the rate of the running sampler
  std::atomic<bool> stop{false};
  std::thread hot([&] {
    prof_register_thread("wrap-hot");
    volatile uint64_t sink = 0;
    while (!stop.load(std::memory_order_relaxed)) sink += 1;
  });
  uint64_t deadline = MonoNs() + 8000ull * 1000 * 1000;
  // Let the sampler produce > 2x the ring capacity worth of ticks
  // (>= 3 records per tick: tick marker + sampler + hot), then drain.
  while (MonoNs() < deadline && prof_ticks() - ticks0 < 2 * kProfRingCap) {
    SleepMs(50);
  }
  stop.store(true);
  hot.join();
  DrainOnce();
  CHECK(prof_dropped() > dropped0);
  // The drain still yields only well-formed records from the fresh
  // window.
  uint64_t last_tick = 0;
  for (const Rec& r : Drain()) {
    CHECK(r.kind >= 1 && r.kind < kProfKindCount);
    CHECK(r.tick >= last_tick);
    last_tick = r.tick;
  }
  prof_start(200);
  return 0;
}

int TestStopStart() {
  prof_stop();
  uint64_t ticks0 = prof_ticks();
  SleepMs(120);
  CHECK(prof_ticks() == ticks0);  // sampler really joined
  CHECK(prof_start(200) == 0);
  SleepMs(120);
  CHECK(prof_ticks() > ticks0);
  return 0;
}

}  // namespace

int main() {
  prof_set_enabled(1);
  int rc = 0;
  rc |= TestRegistration();
  std::printf("prof registration ok\n");
  rc |= TestCpuAttribution();
  std::printf("prof cpu attribution ok\n");
  rc |= TestGilProbe();
  std::printf("prof gil probe ok\n");
  rc |= TestDisable();
  std::printf("prof disable ok\n");
  rc |= TestDrainWhileSampling();
  std::printf("prof drain-while-sampling ok\n");
  rc |= TestWraparound();
  std::printf("prof wraparound ok\n");
  rc |= TestStopStart();
  std::printf("prof stop/start ok\n");
  prof_stop();
  if (rc == 0) std::printf("prof_core_test: ALL OK\n");
  return rc;
}
