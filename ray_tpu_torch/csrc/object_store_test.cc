// Native unit tests for the shared-memory object store — the gtest
// analogue of the reference's plasma unit suite (reference:
// src/ray/object_manager/plasma/ tests driven by Bazel). Plain asserts,
// no framework dependency: `make test` builds and runs this against the
// same translation unit the agent loads, so eviction/pin/refcount/
// ingest races are caught at the C++ layer instead of surfacing as
// flaky Python integration tests.

#undef NDEBUG
#include <cassert>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {
void* store_create(const char* dir, uint64_t capacity);
void store_destroy(void* handle);
int store_create_object(void* handle, const char* id, uint64_t data_size,
                        uint64_t meta_size, char* out_path, int path_cap);
int store_ingest_object(void* handle, const char* id, const char* src_path,
                        uint64_t data_size, uint64_t meta_size, int pinned);
int store_seal(void* handle, const char* id);
int store_get(void* handle, const char* id, char* out_path, int path_cap,
              uint64_t* data_size, uint64_t* meta_size);
int store_release(void* handle, const char* id);
int store_delete(void* handle, const char* id);
int store_contains(void* handle, const char* id);
int store_pin(void* handle, const char* id, int pinned);
void* store_server_start(void* store_handle, const char* sock_path,
                         int* notify_fd_out);
int store_server_drain(void* handle, char* buf, int cap);
void store_server_stop(void* handle);
int store_client_connect(const char* sock_path);
int store_client_request(int fd, uint8_t op, const char* oid, uint64_t a,
                         uint64_t b, const char* name, int32_t* rc_out,
                         uint64_t* ds_out, uint64_t* ms_out,
                         char* path_out, int path_cap);
int store_client_create(int fd, const char* oid, uint64_t data_size,
                        uint64_t meta_size, int32_t* rc_out,
                        uint64_t* reused_out, char* path_out, int path_cap,
                        int* slab_fd_out);
int store_client_seal(int fd, const char* oid, int32_t* rc_out,
                      uint64_t* ds_out, uint64_t* ms_out);
void store_client_close(int fd);
uint64_t store_used(void* handle);
uint64_t store_capacity(void* handle);
uint64_t store_num_objects(void* handle);
uint64_t store_num_evictions(void* handle);
}

namespace {

std::string MakeId(char tag) { return std::string(20, tag); }

bool FileExists(const std::string& path) {
  struct stat st;
  return ::stat(path.c_str(), &st) == 0;
}

void WriteFile(const std::string& path, const std::string& payload) {
  int fd = ::open(path.c_str(), O_CREAT | O_RDWR | O_TRUNC, 0600);
  assert(fd >= 0);
  assert(::write(fd, payload.data(), payload.size()) ==
         (ssize_t)payload.size());
  ::close(fd);
}

// The suites' scratch files go under $TMPDIR (else /tmp).
std::string TmpBase() {
  const char* t = std::getenv("TMPDIR");
  return (t != nullptr && *t != '\0') ? std::string(t) : std::string("/tmp");
}

std::string TempDir(const char* name) {
  std::string dir = TmpBase() + "/raytpu_torch_store_test_" + name + "_" +
                    std::to_string(::getpid());
  std::string cmd = "rm -rf " + dir;
  assert(std::system(cmd.c_str()) == 0);
  return dir;
}

void TestCreateSealGetLifecycle() {
  std::string dir = TempDir("lifecycle");
  void* s = store_create(dir.c_str(), 1 << 20);
  char path[4096];
  std::string id = MakeId('a');

  assert(store_create_object(s, id.c_str(), 100, 10, path, sizeof path) == 0);
  assert(FileExists(path));
  assert(store_contains(s, id.c_str()) == 2);  // present-unsealed
  // Unsealed objects are not gettable.
  uint64_t ds = 0, ms = 0;
  assert(store_get(s, id.c_str(), path, sizeof path, &ds, &ms) == -2);
  // Double-create is rejected.
  assert(store_create_object(s, id.c_str(), 1, 0, path, sizeof path) == -1);

  assert(store_seal(s, id.c_str()) == 0);
  assert(store_contains(s, id.c_str()) == 1);
  assert(store_get(s, id.c_str(), path, sizeof path, &ds, &ms) == 0);
  assert(ds == 100 && ms == 10);
  assert(store_used(s) == 110);
  assert(store_num_objects(s) == 1);

  // delete while referenced -> pending until release (rc 1: the name
  // survives, so staging-inode recyclers must not rewrite the pages).
  assert(store_delete(s, id.c_str()) == 1);
  assert(store_contains(s, id.c_str()) == 1);  // still readable
  assert(store_release(s, id.c_str()) == 0);
  assert(store_contains(s, id.c_str()) == 0);
  assert(store_used(s) == 0);
  store_destroy(s);
  std::printf("  lifecycle OK\n");
}

void TestEvictionRespectsPinsAndRefs() {
  std::string dir = TempDir("evict");
  void* s = store_create(dir.c_str(), 300);  // fits two 100-byte objects
  char path[4096];
  uint64_t ds, ms;
  std::string a = MakeId('a'), b = MakeId('b'), c = MakeId('c'),
              d = MakeId('d');
  for (const auto& id : {a, b}) {
    assert(store_create_object(s, id.c_str(), 100, 0, path, sizeof path) ==
           0);
    assert(store_seal(s, id.c_str()) == 0);
  }
  // a is PINNED (primary): eviction must take b, never a.
  assert(store_pin(s, a.c_str(), 1) == 0);
  assert(store_create_object(s, c.c_str(), 150, 0, path, sizeof path) == 0);
  assert(store_contains(s, a.c_str()) == 1);
  assert(store_contains(s, b.c_str()) == 0);  // LRU victim
  assert(store_num_evictions(s) == 1);

  // A REFERENCED object is not evictable: get(c) pins it; creating d
  // (needs eviction of c) must fail with -2, not corrupt c.
  assert(store_seal(s, c.c_str()) == 0);
  assert(store_get(s, c.c_str(), path, sizeof path, &ds, &ms) == 0);
  assert(store_create_object(s, d.c_str(), 200, 0, path, sizeof path) == -2);
  assert(store_contains(s, c.c_str()) == 1);
  // Released -> evictable -> d fits.
  assert(store_release(s, c.c_str()) == 0);
  assert(store_create_object(s, d.c_str(), 200, 0, path, sizeof path) == 0);
  assert(store_contains(s, c.c_str()) == 0);
  // Larger than capacity is rejected outright.
  std::string e = MakeId('e');
  assert(store_create_object(s, e.c_str(), 1000, 0, path, sizeof path) ==
         -2);
  store_destroy(s);
  std::printf("  eviction/pin/ref OK\n");
}

void TestIngestAdoptsSealed() {
  std::string dir = TempDir("ingest");
  void* s = store_create(dir.c_str(), 1024);
  std::string src = dir + "/ingest-test-1";
  WriteFile(src, "hello-ingest");
  std::string id = MakeId('i');
  assert(store_ingest_object(s, id.c_str(), src.c_str(), 12, 0, 0) == 0);
  assert(!FileExists(src));  // renamed in, not copied
  assert(store_contains(s, id.c_str()) == 1);  // sealed on arrival
  char path[4096];
  uint64_t ds, ms;
  assert(store_get(s, id.c_str(), path, sizeof path, &ds, &ms) == 0);
  assert(ds == 12);
  char buf[16] = {0};
  int fd = ::open(path, O_RDONLY);
  assert(::read(fd, buf, 12) == 12);
  ::close(fd);
  assert(std::memcmp(buf, "hello-ingest", 12) == 0);
  // Duplicate ingest is rejected; over-capacity ingest leaves src alone.
  WriteFile(src, "x");
  assert(store_ingest_object(s, id.c_str(), src.c_str(), 1, 0, 0) == -1);
  std::string big = MakeId('j');
  assert(store_ingest_object(s, big.c_str(), src.c_str(), 4096, 0, 0) == -2);
  assert(FileExists(src));  // caller's cleanup problem, not clobbered
  store_destroy(s);
  std::printf("  ingest OK\n");
}

void TestIngestPinnedSurvivesPressure() {
  // A pinned ingest is admitted atomically as a primary copy: capacity
  // pressure right after admission must evict OTHER unpinned objects,
  // never the fresh ingest (the r4 advisor race: sealed+unpinned entry
  // published before the rename could be evicted mid-ingest).
  std::string dir = TempDir("ingest-pin");
  void* s = store_create(dir.c_str(), 300);
  std::string src = dir + "/ingest-p-1";
  WriteFile(src, std::string(200, 'p'));
  std::string id = MakeId('p');
  assert(store_ingest_object(s, id.c_str(), src.c_str(), 200, 0, 1) == 0);
  // Filling the remaining 100 bytes forces eviction; the pinned ingest
  // must not be a victim, so a 200-byte create cannot fit.
  char path[4096];
  std::string q = MakeId('q');
  assert(store_create_object(s, q.c_str(), 200, 0, path, sizeof path) == -2);
  assert(store_contains(s, id.c_str()) == 1);
  // Unpinned ingest IS evictable under pressure.
  std::string src2 = dir + "/ingest-p-2";
  WriteFile(src2, std::string(50, 'u'));
  std::string u = MakeId('u');
  assert(store_ingest_object(s, u.c_str(), src2.c_str(), 50, 0, 0) == 0);
  assert(store_create_object(s, q.c_str(), 100, 0, path, sizeof path) == 0);
  assert(store_contains(s, u.c_str()) == 0);  // evicted
  assert(store_contains(s, id.c_str()) == 1);  // pinned survives
  store_destroy(s);
  std::printf("  ingest-pinned OK\n");
}

void TestConcurrentIngestEvict() {
  // Hammer ingest (pinned) + delete from several threads against a small
  // capacity: every rc=0 ingest must leave a readable object (the race
  // fixed in r5: rename outside the mutex let EvictFor erase the entry
  // first, acknowledging a put for a vanished object).
  std::string dir = TempDir("ingest-race");
  void* s = store_create(dir.c_str(), 1 << 16);
  std::atomic<int> bad{0};
  auto worker = [&](int t) {
    char path[4096];
    uint64_t ds, ms;
    for (int i = 0; i < 100; i++) {
      std::string src = dir + "/ingest-t" + std::to_string(t) + "-" +
                        std::to_string(i);
      WriteFile(src, std::string(512, (char)('a' + t)));
      std::string id(20, (char)('a' + t));
      id[19] = (char)('0' + (i % 10));
      store_delete(s, id.c_str());
      if (store_ingest_object(s, id.c_str(), src.c_str(), 512, 0, 1) == 0) {
        if (store_get(s, id.c_str(), path, sizeof path, &ds, &ms) != 0 ||
            !FileExists(path)) {
          bad.fetch_add(1);
        } else {
          store_release(s, id.c_str());
        }
        store_pin(s, id.c_str(), 0);
      } else {
        ::unlink(src.c_str());
      }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < 4; t++) ts.emplace_back(worker, t);
  for (auto& th : ts) th.join();
  assert(bad.load() == 0);
  store_destroy(s);
  std::printf("  ingest-concurrent OK\n");
}

void TestConcurrentCreateRelease() {
  // Hammer the index from multiple threads: the single mutex must keep
  // accounting exact (used() returns to 0; no crashes/races).
  std::string dir = TempDir("threads");
  void* s = store_create(dir.c_str(), 1 << 22);
  auto worker = [&](int t) {
    char path[4096];
    uint64_t ds, ms;
    for (int i = 0; i < 200; i++) {
      std::string id(20, (char)('A' + t));
      id[19] = (char)('0' + (i % 10));
      if (store_create_object(s, id.c_str(), 64, 0, path, sizeof path) == 0) {
        store_seal(s, id.c_str());
      }
      if (store_get(s, id.c_str(), path, sizeof path, &ds, &ms) == 0) {
        store_release(s, id.c_str());
      }
      store_delete(s, id.c_str());
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < 4; t++) threads.emplace_back(worker, t);
  for (auto& th : threads) th.join();
  assert(store_used(s) == 0);
  assert(store_num_objects(s) == 0);
  store_destroy(s);
  std::printf("  concurrent create/release OK\n");
}

}  // namespace


void TestSidecarProtocol() {
  // Fast-path sidecar: ingest/get/release/delete over the unix socket,
  // with journal events draining to the (Python-side) agent.
  std::string dir = TempDir("sidecar");
  void* s = store_create(dir.c_str(), 1 << 16);
  std::string sock = dir + ".sock";
  int notify_fd = -1;
  void* srv = store_server_start(s, sock.c_str(), &notify_fd);
  assert(srv != nullptr && notify_fd >= 0);
  int fd = store_client_connect(sock.c_str());
  assert(fd >= 0);

  std::string src = dir + "/ingest-c-1";
  WriteFile(src, "sidecar-payload!");
  std::string id = MakeId('s');
  int32_t rc; uint64_t ds, ms; char path[4096];
  // INGEST
  assert(store_client_request(fd, 1, id.c_str(), 16, 0, "ingest-c-1",
                              &rc, &ds, &ms, path, sizeof path) == 0);
  assert(rc == 0);
  // Path traversal refused.
  assert(store_client_request(fd, 1, id.c_str(), 1, 0, "../evil",
                              &rc, &ds, &ms, path, sizeof path) == 0);
  assert(rc == -4);
  // GET pins and returns the mapped path.
  assert(store_client_request(fd, 2, id.c_str(), 0, 0, nullptr,
                              &rc, &ds, &ms, path, sizeof path) == 0);
  assert(rc == 0 && ds == 16 && FileExists(path));
  // RELEASE + DELETE
  assert(store_client_request(fd, 3, id.c_str(), 0, 0, nullptr,
                              &rc, &ds, &ms, path, sizeof path) == 0);
  assert(rc == 0);
  assert(store_client_request(fd, 4, id.c_str(), 0, 0, nullptr,
                              &rc, &ds, &ms, path, sizeof path) == 0);
  assert(rc == 0);
  // CONTAINS -> absent now.
  assert(store_client_request(fd, 5, id.c_str(), 0, 0, nullptr,
                              &rc, &ds, &ms, path, sizeof path) == 0);
  assert(rc == 0);
  // Journal carries the ingest (op 1, size 16) then the delete (op 4);
  // each record leads with the wire op it originated from.
  char pokebyte;
  assert(::read(notify_fd, &pokebyte, 1) >= 0 || true);
  char buf[30 * 8];
  int n = store_server_drain(srv, buf, sizeof buf);
  assert(n == 30 * 2);
  assert(buf[0] == 1 && buf[1] == 1 &&
         std::memcmp(buf + 2, id.data(), 20) == 0);
  uint64_t jsize;
  std::memcpy(&jsize, buf + 22, 8);
  assert(jsize == 16);
  assert(buf[30] == 4 && buf[31] == 4);
  store_client_close(fd);
  store_server_stop(srv);
  store_destroy(s);
  std::printf("  sidecar OK\n");
}

void TestShmCreateSealWire() {
  // graftshm over the sidecar socket: CREATE passes a slab fd the
  // client serializes into; SEAL publishes it; GET returns the SAME
  // slab path (no rename, no copy); erase recycles the slab so the
  // next same-size CREATE reports a warm reuse.
  std::string dir = TempDir("shm-wire");
  void* s = store_create(dir.c_str(), 1 << 16);
  std::string sock = dir + ".sock";
  int notify_fd = -1;
  void* srv = store_server_start(s, sock.c_str(), &notify_fd);
  assert(srv != nullptr);
  int fd = store_client_connect(sock.c_str());
  assert(fd >= 0);

  std::string id = MakeId('m');
  int32_t rc;
  uint64_t reused = 99, ds, ms;
  char spath[4096], path[4096];
  int slab_fd = -1;
  assert(store_client_create(fd, id.c_str(), 4096, 64, &rc, &reused,
                             spath, sizeof spath, &slab_fd) == 0);
  assert(rc == 0 && reused == 0 && slab_fd >= 0);
  assert(std::strstr(spath, "shmslab-") != nullptr);
  // Staged: visible to contains as unsealed, not gettable.
  assert(store_contains(s, id.c_str()) == 2);
  assert(store_get(s, id.c_str(), path, sizeof path, &ds, &ms) == -2);
  // Serialize "in place" through the mapping.
  void* m = ::mmap(nullptr, 4096 + 64, PROT_READ | PROT_WRITE, MAP_SHARED,
                   slab_fd, 0);
  assert(m != MAP_FAILED);
  std::memset(m, 'z', 4096 + 64);
  std::memcpy(m, "shm-inplace!", 12);
  ::munmap(m, 4096 + 64);
  ::close(slab_fd);
  // SEAL publishes; GET hands back the very same slab path.
  assert(store_client_seal(fd, id.c_str(), &rc, &ds, &ms) == 0);
  assert(rc == 0);
  assert(store_client_seal(fd, id.c_str(), &rc, &ds, &ms) == 0);
  assert(rc == -1);  // double-seal rejected
  assert(store_client_request(fd, 2, id.c_str(), 0, 0, nullptr, &rc, &ds,
                              &ms, path, sizeof path) == 0);
  assert(rc == 0 && ds == 4096 && ms == 64);
  assert(std::strcmp(path, spath) == 0);
  char buf[12];
  int rfd = ::open(path, O_RDONLY);
  assert(rfd >= 0);
  assert(::read(rfd, buf, 12) == 12);
  ::close(rfd);
  assert(std::memcmp(buf, "shm-inplace!", 12) == 0);
  // CREATE journals its own record (op 9, origin 9), then the seal is
  // journaled as an ingest (op 1) whose origin byte marks the shm plane.
  char jbuf[30 * 4];
  int n = store_server_drain(srv, jbuf, sizeof jbuf);
  assert(n == 30 * 2);
  assert(jbuf[0] == 9 && jbuf[1] == 9 &&
         std::memcmp(jbuf + 2, id.data(), 20) == 0);
  assert(jbuf[30] == 1 && jbuf[31] == 10 &&
         std::memcmp(jbuf + 32, id.data(), 20) == 0);
  uint64_t jsize;
  std::memcpy(&jsize, jbuf + 52, 8);
  assert(jsize == 4096 + 64);
  // Release + delete: the slab goes back to the arena, so the next
  // same-size CREATE is a warm reuse of the SAME file.
  assert(store_client_request(fd, 3, id.c_str(), 0, 0, nullptr, &rc, &ds,
                              &ms, path, sizeof path) == 0);
  assert(store_client_request(fd, 4, id.c_str(), 0, 0, nullptr, &rc, &ds,
                              &ms, path, sizeof path) == 0);
  assert(rc == 0);
  std::string id2 = MakeId('n');
  assert(store_client_create(fd, id2.c_str(), 4096, 64, &rc, &reused,
                             path, sizeof path, &slab_fd) == 0);
  assert(rc == 0 && reused == 1 && slab_fd >= 0);
  assert(std::strcmp(path, spath) == 0);
  ::close(slab_fd);

  // Over-capacity CREATE: clean -2, no fd follows, slab recycled.
  std::string big = MakeId('o');
  int big_fd = -1;
  assert(store_client_create(fd, big.c_str(), 1 << 20, 0, &rc, &reused,
                             path, sizeof path, &big_fd) == 0);
  assert(rc == -2 && big_fd == -1);

  // Client death between CREATE and SEAL: a second connection stages an
  // object and dies; the sidecar reclaims it (store entry gone, delete
  // journaled) so the slab cannot leak behind an invisible entry.
  int fd2 = store_client_connect(sock.c_str());
  assert(fd2 >= 0);
  std::string dead = MakeId('d');
  int dead_fd = -1;
  assert(store_client_create(fd2, dead.c_str(), 2048, 0, &rc, &reused,
                             path, sizeof path, &dead_fd) == 0);
  assert(rc == 0 && dead_fd >= 0);
  ::close(dead_fd);
  store_client_close(fd2);  // dies before SEAL
  for (int i = 0; i < 5000 && store_contains(s, dead.c_str()) != 0; i++) {
    ::usleep(1000);
  }
  assert(store_contains(s, dead.c_str()) == 0);

  store_client_close(fd);
  store_server_stop(srv);
  store_destroy(s);
  std::printf("  shm create/seal wire OK\n");
}

int main() {
  TestCreateSealGetLifecycle();
  TestEvictionRespectsPinsAndRefs();
  TestIngestAdoptsSealed();
  TestIngestPinnedSurvivesPressure();
  TestConcurrentIngestEvict();
  TestConcurrentCreateRelease();
  TestSidecarProtocol();
  TestShmCreateSealWire();
  std::printf("object_store_test: ALL OK\n");
  return 0;
}
