// Shared-memory object store: the plasma equivalent, TPU-host flavored.
//
// Reference behavior being replaced: /root/reference/src/ray/object_manager/
// plasma/store.h:55 (arena allocator + object table + eviction + client
// mapping). This implementation is a single mmap arena with a first-fit
// free-list allocator and an open-addressed object table, all inside the
// mapped region with a process-shared mutex — so any process mapping the
// same file sees the same objects zero-copy (numpy arrays map directly).
//
// C API (ctypes-friendly); all functions return 0 on success, negative on
// error unless documented otherwise.
//
// Layout: [Header | table entries | arena bytes ...]

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x5254505553544f53ull;  // "RTPUSTOS" (v2: zombies)
constexpr uint32_t kIdLen = 28;                     // hex id length (like ObjectID)
constexpr uint32_t kEntryEmpty = 0;
constexpr uint32_t kEntryUsed = 1;
constexpr uint32_t kEntryTombstone = 2;
// deleted while readers still hold a pin (zero-copy views): the arena
// space is retained until the last release drops the refcount to zero —
// a mapped numpy view in another process must never see its pages reused
constexpr uint32_t kEntryZombie = 3;

struct Entry {
  char id[kIdLen];
  uint32_t state;
  uint32_t sealed;
  uint64_t offset;  // from arena base
  uint64_t size;
  int64_t refcount;
};

struct FreeBlock {
  uint64_t offset;
  uint64_t size;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;      // arena bytes
  uint64_t table_slots;   // number of Entry slots
  uint64_t arena_offset;  // file offset of arena base
  uint64_t used_bytes;
  uint64_t num_objects;
  uint64_t free_count;    // entries in free list
  uint64_t max_free;      // capacity of free list
  pthread_mutex_t mutex;
  // followed by: FreeBlock[max_free], Entry[table_slots], arena
};

struct Store {
  void* base;
  uint64_t total_size;
  Header* hdr;
  FreeBlock* free_list;
  Entry* table;
  uint8_t* arena;
};

uint64_t hash_id(const char* id) {
  uint64_t h = 1469598103934665603ull;
  for (uint32_t i = 0; i < kIdLen; i++) {
    h ^= (uint8_t)id[i];
    h *= 1099511628211ull;
  }
  return h;
}

Entry* find_entry(Store* s, const char* id, bool for_insert) {
  uint64_t slots = s->hdr->table_slots;
  uint64_t h = hash_id(id) % slots;
  Entry* first_tomb = nullptr;
  for (uint64_t probe = 0; probe < slots; probe++) {
    Entry* e = &s->table[(h + probe) % slots];
    if (e->state == kEntryUsed && memcmp(e->id, id, kIdLen) == 0) return e;
    if (e->state == kEntryTombstone && for_insert && !first_tomb)
      first_tomb = e;
    // zombies are invisible to lookups and NOT insertable (they still own
    // arena space); probing continues past them
    if (e->state == kEntryEmpty)
      return for_insert ? (first_tomb ? first_tomb : e) : nullptr;
  }
  return for_insert ? first_tomb : nullptr;
}

// Locate a used-or-zombie entry by id + arena offset (offsets are unique
// per live allocation, so a zombie and its same-id successor never
// collide). Entries never move, so the hash probe still finds them.
Entry* find_entry_at(Store* s, const char* id, uint64_t offset) {
  uint64_t slots = s->hdr->table_slots;
  uint64_t h = hash_id(id) % slots;
  for (uint64_t probe = 0; probe < slots; probe++) {
    Entry* e = &s->table[(h + probe) % slots];
    if ((e->state == kEntryUsed || e->state == kEntryZombie) &&
        e->offset == offset && memcmp(e->id, id, kIdLen) == 0)
      return e;
    if (e->state == kEntryEmpty) return nullptr;
  }
  return nullptr;
}

// first-fit allocation from the free list; splits blocks.
int64_t arena_alloc(Store* s, uint64_t size) {
  size = (size + 63) & ~63ull;  // 64-byte alignment (cache-line)
  Header* h = s->hdr;
  for (uint64_t i = 0; i < h->free_count; i++) {
    FreeBlock* b = &s->free_list[i];
    if (b->size >= size) {
      uint64_t off = b->offset;
      b->offset += size;
      b->size -= size;
      if (b->size == 0) {
        s->free_list[i] = s->free_list[h->free_count - 1];
        h->free_count--;
      }
      h->used_bytes += size;
      return (int64_t)off;
    }
  }
  return -1;
}

void arena_free(Store* s, uint64_t offset, uint64_t size) {
  size = (size + 63) & ~63ull;
  Header* h = s->hdr;
  h->used_bytes -= size;
  // coalesce with an adjacent block when possible
  for (uint64_t i = 0; i < h->free_count; i++) {
    FreeBlock* b = &s->free_list[i];
    if (b->offset + b->size == offset) {
      b->size += size;
      return;
    }
    if (offset + size == b->offset) {
      b->offset = offset;
      b->size += size;
      return;
    }
  }
  if (h->free_count < h->max_free) {
    s->free_list[h->free_count++] = FreeBlock{offset, size};
  }
  // else: leak the block (bounded by max_free fragmentation; acceptable)
}

}  // namespace

extern "C" {

// Create or open a store file of `capacity` arena bytes with `table_slots`
// object slots. Returns an opaque handle or null.
void* rtpu_store_open(const char* path, uint64_t capacity,
                      uint64_t table_slots, int create) {
  uint64_t max_free = table_slots;
  uint64_t header_bytes = sizeof(Header) + max_free * sizeof(FreeBlock) +
                          table_slots * sizeof(Entry);
  header_bytes = (header_bytes + 4095) & ~4095ull;
  uint64_t total = header_bytes + capacity;

  int fd = open(path, create ? (O_RDWR | O_CREAT) : O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  fstat(fd, &st);
  bool fresh = st.st_size == 0;
  if (fresh && !create) {
    close(fd);
    return nullptr;
  }
  if (fresh) {
    if (ftruncate(fd, (off_t)total) != 0) {
      close(fd);
      return nullptr;
    }
  } else {
    total = (uint64_t)st.st_size;
  }
  void* base =
      mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;

  Store* s = new Store();
  s->base = base;
  s->total_size = total;
  s->hdr = (Header*)base;
  s->free_list = (FreeBlock*)((uint8_t*)base + sizeof(Header));
  s->table = (Entry*)((uint8_t*)s->free_list + max_free * sizeof(FreeBlock));

  if (fresh) {
    Header* h = s->hdr;
    memset(h, 0, header_bytes);
    h->magic = kMagic;
    h->capacity = capacity;
    h->table_slots = table_slots;
    h->arena_offset = header_bytes;
    h->max_free = max_free;
    h->free_count = 1;
    s->free_list[0] = FreeBlock{0, capacity};
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mutex, &attr);
  } else if (s->hdr->magic != kMagic) {
    munmap(base, total);
    delete s;
    return nullptr;
  }
  s->arena = (uint8_t*)base + s->hdr->arena_offset;
  return s;
}

void rtpu_store_close(void* handle) {
  Store* s = (Store*)handle;
  munmap(s->base, s->total_size);
  delete s;
}

static int lock_hdr(Header* h) {
  int rc = pthread_mutex_lock(&h->mutex);
  if (rc == EOWNERDEAD) {  // holder died: state is still consistent enough
    pthread_mutex_consistent(&h->mutex);
    rc = 0;
  }
  return rc;
}

// Allocate an object buffer. Returns arena offset (>=0) or:
//   -1 out of memory, -2 already exists, -3 table full.
int64_t rtpu_store_create(void* handle, const char* id, uint64_t size) {
  Store* s = (Store*)handle;
  if (lock_hdr(s->hdr) != 0) return -4;
  Entry* e = find_entry(s, id, false);
  if (e != nullptr) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return -2;
  }
  e = find_entry(s, id, true);
  if (e == nullptr) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return -3;
  }
  int64_t off = arena_alloc(s, size);
  if (off < 0) {
    pthread_mutex_unlock(&s->hdr->mutex);
    return -1;
  }
  memcpy(e->id, id, kIdLen);
  e->state = kEntryUsed;
  e->sealed = 0;
  e->offset = (uint64_t)off;
  e->size = size;
  e->refcount = 1;
  s->hdr->num_objects++;
  pthread_mutex_unlock(&s->hdr->mutex);
  return off;
}

int rtpu_store_seal(void* handle, const char* id) {
  Store* s = (Store*)handle;
  if (lock_hdr(s->hdr) != 0) return -4;
  Entry* e = find_entry(s, id, false);
  int rc = 0;
  if (e == nullptr)
    rc = -1;
  else
    e->sealed = 1;
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

// Look up a sealed object. On success fills offset/size and bumps refcount.
//   0 ok, -1 missing, -2 not sealed.
int rtpu_store_get(void* handle, const char* id, uint64_t* offset,
                   uint64_t* size) {
  Store* s = (Store*)handle;
  if (lock_hdr(s->hdr) != 0) return -4;
  Entry* e = find_entry(s, id, false);
  int rc = 0;
  if (e == nullptr) {
    rc = -1;
  } else if (!e->sealed) {
    rc = -2;
  } else {
    e->refcount++;
    *offset = e->offset;
    *size = e->size;
  }
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

static void release_entry(Store* s, Entry* e) {
  if (e->refcount > 0) e->refcount--;
  if (e->state == kEntryZombie && e->refcount <= 0) {
    // last pinned reader of a deleted object: free for real now
    arena_free(s, e->offset, e->size);
    e->state = kEntryTombstone;
  }
}

int rtpu_store_release(void* handle, const char* id) {
  Store* s = (Store*)handle;
  if (lock_hdr(s->hdr) != 0) return -4;
  Entry* e = find_entry(s, id, false);
  int rc = e ? 0 : -1;
  if (e) release_entry(s, e);
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

// Release a long-held pin (zero-copy view) precisely: the (id, offset)
// pair survives a delete (zombie) and is never confused with a same-id
// successor allocation.
int rtpu_store_release_at(void* handle, const char* id, uint64_t offset) {
  Store* s = (Store*)handle;
  if (lock_hdr(s->hdr) != 0) return -4;
  Entry* e = find_entry_at(s, id, offset);
  int rc = e ? 0 : -1;
  if (e) release_entry(s, e);
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

// Delete: frees arena space when only the creator's share remains;
// otherwise the entry turns zombie and the space is reclaimed by the
// last reader's release (a mapped view must never see reused pages).
int rtpu_store_delete(void* handle, const char* id) {
  Store* s = (Store*)handle;
  if (lock_hdr(s->hdr) != 0) return -4;
  Entry* e = find_entry(s, id, false);
  int rc = 0;
  if (e == nullptr) {
    rc = -1;
  } else if (e->refcount <= 1) {
    arena_free(s, e->offset, e->size);
    e->state = kEntryTombstone;
    e->sealed = 0;
    s->hdr->num_objects--;
  } else {
    e->refcount--;  // consume the creator's share
    e->state = kEntryZombie;
    e->sealed = 0;
    s->hdr->num_objects--;
  }
  pthread_mutex_unlock(&s->hdr->mutex);
  return rc;
}

uint8_t* rtpu_store_base(void* handle) {
  return ((Store*)handle)->arena;
}

// Deleted-with-outstanding-pins entries still holding arena space. A
// nonzero count after every reader released (or died and had its pins
// released by the agent) is a leak; the chaos soak asserts zero.
uint64_t rtpu_store_zombie_count(void* handle) {
  Store* s = (Store*)handle;
  if (lock_hdr(s->hdr) != 0) return 0;
  uint64_t n = 0;
  for (uint64_t i = 0; i < s->hdr->table_slots; i++) {
    if (s->table[i].state == kEntryZombie) n++;
  }
  pthread_mutex_unlock(&s->hdr->mutex);
  return n;
}

void rtpu_store_stats(void* handle, uint64_t* capacity, uint64_t* used,
                      uint64_t* num_objects) {
  Store* s = (Store*)handle;
  *capacity = s->hdr->capacity;
  *used = s->hdr->used_bytes;
  *num_objects = s->hdr->num_objects;
}

}  // extern "C"
