// Shared-memory object store engine for ray_tpu node agents.
//
// TPU-native analogue of the reference's plasma store (reference:
// src/ray/object_manager/plasma/{store.cc,object_store.cc,obj_lifecycle_mgr.cc,
// plasma_allocator.cc,eviction_policy.cc}). Same role — node-local immutable
// shared-memory objects with zero-copy reads, refcount pinning, LRU eviction
// of unpinned sealed objects — but a different shape: instead of one dlmalloc
// arena behind a custom fd-passing socket protocol, every object is its own
// tmpfs-backed file under a session directory that clients mmap directly
// (control traffic rides the agent's RPC; the kernel page cache is the arena).
// This keeps the native engine focused on lifecycle/accounting/eviction and
// makes host<->TPU DMA staging a plain mmap.
//
// Built as libraytpu_torch_store.so, driven in-process by the node agent via ctypes.
//
// Thread-safe: a single mutex guards the index (operations are O(1)-ish and
// the data path never holds it — clients write/read through their own mmaps).

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <list>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

#include "prof_core.h"

namespace {

constexpr int kIdSize = 20;

struct ObjectEntry {
  std::string path;
  uint64_t data_size = 0;
  uint64_t meta_size = 0;
  bool sealed = false;
  bool pinned = false;          // primary copy: never evict
  bool pending_delete = false;  // delete once refcount drops to 0
  // graftshm: payload lives in an arena slab (stable "shmslab-*" name,
  // never renamed); on erase the file is recycled, not unlinked.
  bool slab_backed = false;
  int64_t refcount = 0;
  // LRU bookkeeping: valid iff evictable (sealed, refcount==0, !pinned).
  std::list<std::string>::iterator lru_it;
  bool in_lru = false;
};

struct Store {
  std::string dir;
  uint64_t capacity = 0;
  uint64_t used = 0;
  uint64_t num_evictions = 0;
  uint64_t bytes_evicted = 0;
  std::mutex mu;
  std::unordered_map<std::string, ObjectEntry> objects;
  std::list<std::string> lru;  // front = oldest
  // Deferred unlink: a GiB-scale tmpfs unlink frees pages synchronously
  // (~50 ms/GiB) and EraseObject runs under mu on the put admission
  // path, so eviction would stall every concurrent store op for that
  // long. Victims are instead renamed (metadata-only) to a trash name
  // and a background reaper unlinks them outside the lock.
  std::vector<std::string> trash;
  uint64_t trash_seq = 0;
  std::condition_variable trash_cv;
  std::thread reaper;
  bool stopping = false;
  // graftshm: where slab-backed payload files go on erase (the arena's
  // free list) instead of unlink. Set under mu via
  // store_set_slab_recycler; the callback only takes the arena mutex,
  // so the store.mu -> arena.mu order is acyclic.
  void (*slab_recycler)(void*, const char*, uint64_t) = nullptr;
  void* slab_recycler_ctx = nullptr;
};

std::string IdKey(const char* id) { return std::string(id, kIdSize); }

std::string HexPath(const Store& s, const std::string& key) {
  static const char* hexd = "0123456789abcdef";
  std::string hex;
  hex.reserve(kIdSize * 2);
  for (unsigned char c : key) {
    hex.push_back(hexd[c >> 4]);
    hex.push_back(hexd[c & 0xf]);
  }
  return s.dir + "/" + hex;
}

void LruPush(Store* s, const std::string& key, ObjectEntry* e) {
  s->lru.push_back(key);
  e->lru_it = std::prev(s->lru.end());
  e->in_lru = true;
}

void LruRemove(Store* s, ObjectEntry* e) {
  if (e->in_lru) {
    s->lru.erase(e->lru_it);
    e->in_lru = false;
  }
}

constexpr size_t kMaxTrashBacklog = 256;

void ReaperLoop(Store* s) {
  prof_register_thread("store-reaper");
  std::unique_lock<std::mutex> lk(s->mu);
  while (!s->stopping) {
    if (s->trash.empty()) {
      s->trash_cv.wait(lk);
      continue;
    }
    std::vector<std::string> batch;
    batch.swap(s->trash);
    lk.unlock();
    for (const std::string& p : batch) ::unlink(p.c_str());
    lk.lock();
  }
}

// Caller holds mu. Removes entry + backing file. With out_unlink set,
// the backing path is handed back for the caller to ::unlink AFTER
// dropping mu: explicit deletes free their pages synchronously (the
// worker blocks on the delete round-trip, so its next put reuses the
// just-freed tmpfs pages — hot-page writes are ~2x faster than cold
// allocation) without extending the critical section. With out_unlink
// null (eviction, whose caller is the admission path and must not
// block), the file is renamed to a trash name and reaped off-thread
// (see Store::trash) unless the backlog is deep or the rename fails,
// in which case it is unlinked inline.
void EraseObject(Store* s, const std::string& key,
                 std::string* out_unlink = nullptr) {
  auto it = s->objects.find(key);
  if (it == s->objects.end()) return;
  LruRemove(s, &it->second);
  s->used -= it->second.data_size + it->second.meta_size;
  if (it->second.slab_backed && s->slab_recycler != nullptr) {
    // graftshm slabs are recycled (warm pages, stable name), never
    // unlinked here. Recycling is a free-list push; the rare over-cap
    // unlink inside the recycler is a cheap tmpfs metadata op, so
    // holding mu across it does not stall the admission path the way
    // a GiB-scale page-freeing unlink would.
    std::string spath = it->second.path;
    uint64_t total = it->second.data_size + it->second.meta_size;
    s->objects.erase(it);
    s->slab_recycler(s->slab_recycler_ctx, spath.c_str(), total);
    if (out_unlink != nullptr) out_unlink->clear();
    return;
  }
  const std::string& path = it->second.path;
  if (out_unlink != nullptr) {
    *out_unlink = path;
    s->objects.erase(it);
    return;
  }
  bool deferred = false;
  if (s->reaper.joinable() && s->trash.size() < kMaxTrashBacklog) {
    std::string tpath = path + ".t" + std::to_string(++s->trash_seq);
    if (::rename(path.c_str(), tpath.c_str()) == 0) {
      s->trash.push_back(std::move(tpath));
      s->trash_cv.notify_one();
      deferred = true;
    }
  }
  if (!deferred) ::unlink(path.c_str());
  s->objects.erase(it);
}

// Caller holds mu. Evict LRU victims until `needed` bytes fit. Returns true
// if enough space was freed.
bool EvictFor(Store* s, uint64_t needed) {
  while (s->used + needed > s->capacity && !s->lru.empty()) {
    std::string victim = s->lru.front();
    auto it = s->objects.find(victim);
    // lru entries are kept consistent; still guard against staleness.
    if (it == s->objects.end()) {
      s->lru.pop_front();
      continue;
    }
    s->num_evictions++;
    s->bytes_evicted += it->second.data_size + it->second.meta_size;
    EraseObject(s, victim);
  }
  return s->used + needed <= s->capacity;
}

}  // namespace

extern "C" {

void* store_create(const char* dir, uint64_t capacity) {
  auto* s = new Store();
  s->dir = dir;
  s->capacity = capacity;
  ::mkdir(dir, 0700);
  s->reaper = std::thread(ReaperLoop, s);
  return s;
}

void store_destroy(void* handle) {
  auto* s = static_cast<Store*>(handle);
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->stopping = true;
  }
  s->trash_cv.notify_all();
  if (s->reaper.joinable()) s->reaper.join();
  {
    std::lock_guard<std::mutex> g(s->mu);
    for (const std::string& p : s->trash) ::unlink(p.c_str());
    for (auto& kv : s->objects) ::unlink(kv.second.path.c_str());
  }
  ::rmdir(s->dir.c_str());
  delete s;
}

// 0 ok, -1 already exists, -2 out of memory (after eviction), -3 io error.
int store_create_object(void* handle, const char* id, uint64_t data_size,
                        uint64_t meta_size, char* out_path, int path_cap) {
  auto* s = static_cast<Store*>(handle);
  std::string key = IdKey(id);
  uint64_t total = data_size + meta_size;
  std::string path;
  {
    std::lock_guard<std::mutex> g(s->mu);
    if (s->objects.count(key)) return -1;
    if (total > s->capacity) return -2;
    if (!EvictFor(s, total)) return -2;
    path = HexPath(*s, key);
    ObjectEntry e;
    e.path = path;
    e.data_size = data_size;
    e.meta_size = meta_size;
    s->used += total;
    s->objects.emplace(key, std::move(e));
  }
  int fd = ::open(path.c_str(), O_CREAT | O_RDWR | O_EXCL, 0600);
  if (fd < 0) {
    std::lock_guard<std::mutex> g(s->mu);
    EraseObject(s, key);
    return -3;
  }
  if (total > 0 && ::ftruncate(fd, (off_t)total) != 0) {
    ::close(fd);
    std::lock_guard<std::mutex> g(s->mu);
    EraseObject(s, key);
    return -3;
  }
  ::close(fd);
  std::snprintf(out_path, path_cap, "%s", path.c_str());
  return 0;
}

// Ingest a fully-written payload file as a SEALED object in one step
// (worker writes <dir>/ingest-* directly, then one RPC lands here —
// halves the control round-trips of the create+write+seal protocol).
// The rename happens UNDER the mutex, before the entry is published:
// otherwise a concurrent EvictFor could pick the just-inserted entry
// (refcount 0, unpinned) as a victim and erase it before the rename
// lands — the caller would get rc=0 for an object that is gone, with
// the renamed payload stranded untracked in the store dir. A tmpfs
// rename is a metadata-only op, so holding the lock across it is cheap.
// `pinned` != 0 admits the object as a pinned PRIMARY copy atomically,
// so the agent's pin cannot race with eviction either.
// 0 ok, -1 already exists, -2 out of memory (after eviction), -3 io error.
int store_ingest_object(void* handle, const char* id, const char* src_path,
                        uint64_t data_size, uint64_t meta_size, int pinned) {
  auto* s = static_cast<Store*>(handle);
  std::string key = IdKey(id);
  uint64_t total = data_size + meta_size;
  std::lock_guard<std::mutex> g(s->mu);
  if (s->objects.count(key)) return -1;
  if (total > s->capacity) return -2;
  if (!EvictFor(s, total)) return -2;
  std::string path = HexPath(*s, key);
  if (::rename(src_path, path.c_str()) != 0) return -3;
  ObjectEntry e;
  e.path = path;
  e.data_size = data_size;
  e.meta_size = meta_size;
  e.sealed = true;
  e.pinned = pinned != 0;
  s->used += total;
  auto ins = s->objects.emplace(key, std::move(e));
  if (!ins.first->second.pinned) LruPush(s, key, &ins.first->second);
  return 0;
}

// 0 ok, -1 missing.
int store_seal(void* handle, const char* id) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(IdKey(id));
  if (it == s->objects.end()) return -1;
  ObjectEntry& e = it->second;
  e.sealed = true;
  if (e.refcount == 0 && !e.pinned && !e.in_lru) LruPush(s, it->first, &e);
  return 0;
}

// Pins the object (refcount++). 0 ok, -1 missing, -2 unsealed.
int store_get(void* handle, const char* id, char* out_path, int path_cap,
              uint64_t* data_size, uint64_t* meta_size) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(IdKey(id));
  if (it == s->objects.end()) return -1;
  ObjectEntry& e = it->second;
  if (!e.sealed) return -2;
  e.refcount++;
  LruRemove(s, &e);
  std::snprintf(out_path, path_cap, "%s", e.path.c_str());
  *data_size = e.data_size;
  *meta_size = e.meta_size;
  return 0;
}

// 0 ok, -1 missing.
int store_release(void* handle, const char* id) {
  auto* s = static_cast<Store*>(handle);
  std::string doomed;
  {
    std::lock_guard<std::mutex> g(s->mu);
    std::string key = IdKey(id);
    auto it = s->objects.find(key);
    if (it == s->objects.end()) return -1;
    ObjectEntry& e = it->second;
    if (e.refcount > 0) e.refcount--;
    if (e.refcount == 0) {
      if (e.pending_delete) {
        EraseObject(s, key, &doomed);
      } else if (e.sealed && !e.pinned && !e.in_lru) {
        LruPush(s, key, &e);
      }
    }
  }
  if (!doomed.empty()) ::unlink(doomed.c_str());
  return 0;
}

// Deletes now if unreferenced, else marks pending-delete. The two
// outcomes are distinct on purpose: 0 means the store's name is gone
// NOW (a worker recycling its staging inode may rewrite the shared
// pages), 1 means readers still hold it and the erase is deferred to
// the last release. -1 missing.
int store_delete(void* handle, const char* id) {
  auto* s = static_cast<Store*>(handle);
  std::string doomed;
  bool erased = false;
  {
    std::lock_guard<std::mutex> g(s->mu);
    std::string key = IdKey(id);
    auto it = s->objects.find(key);
    if (it == s->objects.end()) return -1;
    if (it->second.refcount == 0) {
      // doomed stays empty for slab-backed entries (the slab was
      // recycled, not unlinked) — track the erase separately so the
      // rc still says "gone NOW".
      EraseObject(s, key, &doomed);
      erased = true;
    } else {
      it->second.pending_delete = true;
    }
  }
  if (!erased) return 1;
  if (!doomed.empty()) ::unlink(doomed.c_str());
  return 0;
}

// 1 sealed-present, 0 absent, 2 present-unsealed.
int store_contains(void* handle, const char* id) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(IdKey(id));
  if (it == s->objects.end()) return 0;
  return it->second.sealed ? 1 : 2;
}

// Pin/unpin primary copies (exempt from eviction; spill candidates).
int store_pin(void* handle, const char* id, int pinned) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(IdKey(id));
  if (it == s->objects.end()) return -1;
  ObjectEntry& e = it->second;
  e.pinned = pinned != 0;
  if (e.pinned) {
    LruRemove(s, &e);
  } else if (e.sealed && e.refcount == 0 && !e.in_lru) {
    LruPush(s, it->first, &e);
  }
  return 0;
}

// graftshm: admit a STAGED (unsealed) entry whose payload is a
// store-owned arena slab. No rename — the slab path IS the object path
// for the rest of its life, so the client's CREATE-time mapping stays
// coherent through seal and every later get (same inode). Staged
// entries are invisible to LRU/eviction until sealed, exactly like
// store_create_object's. 0 ok, -1 already exists, -2 out of memory
// (after eviction).
int store_adopt_staged(void* handle, const char* id, const char* slab_path,
                       uint64_t data_size, uint64_t meta_size) {
  auto* s = static_cast<Store*>(handle);
  std::string key = IdKey(id);
  uint64_t total = data_size + meta_size;
  std::lock_guard<std::mutex> g(s->mu);
  if (s->objects.count(key)) return -1;
  if (total > s->capacity) return -2;
  if (!EvictFor(s, total)) return -2;
  ObjectEntry e;
  e.path = slab_path;
  e.data_size = data_size;
  e.meta_size = meta_size;
  e.slab_backed = true;
  s->used += total;
  s->objects.emplace(key, std::move(e));
  return 0;
}

// graftshm: seal a staged entry and pin it as a primary copy in one
// step (mirrors store_ingest_object's pinned admission: the agent's
// ledger pin must not race eviction). *total_out gets data+meta for
// the journal record. 0 ok, -1 missing or already sealed.
int store_seal_pin(void* handle, const char* id, uint64_t* total_out) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->objects.find(IdKey(id));
  if (it == s->objects.end()) return -1;
  ObjectEntry& e = it->second;
  if (e.sealed) return -1;
  e.sealed = true;
  e.pinned = true;
  LruRemove(s, &e);
  if (total_out != nullptr) *total_out = e.data_size + e.meta_size;
  return 0;
}

// graftshm: register/unregister (fn=null) the arena recycler for
// slab-backed erases.
void store_set_slab_recycler(void* handle,
                             void (*fn)(void*, const char*, uint64_t),
                             void* ctx) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  s->slab_recycler = fn;
  s->slab_recycler_ctx = ctx;
}

// Borrowed pointer to the store's directory string (valid for the
// store's lifetime) — used by the fast-path sidecar (store_server.cc).
const char* store_dir_ref(void* handle) {
  return static_cast<Store*>(handle)->dir.c_str();
}

uint64_t store_used(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  return s->used;
}

uint64_t store_capacity(void* handle) {
  return static_cast<Store*>(handle)->capacity;
}

uint64_t store_num_objects(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  return s->objects.size();
}

uint64_t store_num_evictions(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> g(s->mu);
  return s->num_evictions;
}

}  // extern "C"
