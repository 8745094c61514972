// Embedded ordered KV store — native equivalent of the reference's
// LevelDB dependency (`level@8` -> classic-level C++, reference:
// packages/db/src/controller/level.ts, SURVEY.md §2.3).
//
// Design: an in-memory ordered map (std::map keeps byte-lexicographic
// order, which the repository layer's bucket-prefix range scans need)
// backed by an append-only write-ahead log.  Every mutation appends a
// length-prefixed record; open() replays the log; compact() rewrites a
// snapshot when garbage accumulates.  Simple, durable, and ordered —
// the three properties BeaconDb actually uses.
//
// Record format: u8 op (1=put, 2=del) | u32 klen | u32 vlen | key | val
//
// The port's copy of lodestar_tpu/native/kvstore.cpp; built with the host
// C++ compiler at first use by lodestar_tpu_torch/kernels/build.py
// build_native() into lodestar_tpu_torch/_build/.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct Store {
  std::map<std::string, std::string> data;
  std::string path;
  FILE* log = nullptr;
  size_t log_records = 0;

  bool append(uint8_t op, const std::string& k, const std::string& v) {
    if (!log) return false;  // compaction reopen failed: fail closed
    uint32_t klen = (uint32_t)k.size(), vlen = (uint32_t)v.size();
    if (fwrite(&op, 1, 1, log) != 1) return false;
    if (fwrite(&klen, 4, 1, log) != 1) return false;
    if (fwrite(&vlen, 4, 1, log) != 1) return false;
    if (klen && fwrite(k.data(), 1, klen, log) != klen) return false;
    if (vlen && fwrite(v.data(), 1, vlen, log) != vlen) return false;
    log_records++;
    return true;
  }
};

struct Iter {
  std::map<std::string, std::string>::const_iterator cur;
  std::map<std::string, std::string>::const_iterator end;
};

bool replay(Store* s) {
  FILE* f = fopen(s->path.c_str(), "rb");
  if (!f) return true;  // fresh store
  for (;;) {
    uint8_t op;
    uint32_t klen, vlen;
    if (fread(&op, 1, 1, f) != 1) break;
    if (fread(&klen, 4, 1, f) != 1) break;
    if (fread(&vlen, 4, 1, f) != 1) break;
    std::string k(klen, '\0'), v(vlen, '\0');
    if (klen && fread(&k[0], 1, klen, f) != klen) break;
    if (vlen && fread(&v[0], 1, vlen, f) != vlen) break;
    if (op == 1) {
      s->data[k] = std::move(v);
    } else if (op == 2) {
      s->data.erase(k);
    }
    s->log_records++;
  }
  fclose(f);
  return true;
}

}  // namespace

extern "C" {

void* kv_open(const char* path) {
  Store* s = new Store();
  s->path = path;
  if (!replay(s)) {
    delete s;
    return nullptr;
  }
  s->log = fopen(path, "ab");
  if (!s->log) {
    delete s;
    return nullptr;
  }
  return s;
}

int kv_put(void* h, const uint8_t* k, uint32_t klen, const uint8_t* v,
           uint32_t vlen) {
  Store* s = (Store*)h;
  std::string key((const char*)k, klen), val((const char*)v, vlen);
  if (!s->append(1, key, val)) return -1;
  s->data[std::move(key)] = std::move(val);
  return 0;
}

int kv_del(void* h, const uint8_t* k, uint32_t klen) {
  Store* s = (Store*)h;
  std::string key((const char*)k, klen);
  if (!s->append(2, key, "")) return -1;
  s->data.erase(key);
  return 0;
}

// Returns value length, or -1 if absent.  Copies min(vlen, cap) bytes
// into out; call with cap=0 to size-probe.
int64_t kv_get(void* h, const uint8_t* k, uint32_t klen, uint8_t* out,
               uint32_t cap) {
  Store* s = (Store*)h;
  auto it = s->data.find(std::string((const char*)k, klen));
  if (it == s->data.end()) return -1;
  uint32_t n = (uint32_t)it->second.size();
  if (out && cap) memcpy(out, it->second.data(), n < cap ? n : cap);
  return (int64_t)n;
}

uint64_t kv_count(void* h) { return ((Store*)h)->data.size(); }

int kv_flush(void* h) {
  Store* s = (Store*)h;
  return (s->log && fflush(s->log) == 0) ? 0 : -1;
}

// Rewrite the log as a compact snapshot of live records.  Every write
// is checked BEFORE the snapshot replaces the WAL: a short write (disk
// full, I/O error) must never destroy committed data.
int kv_compact(void* h) {
  Store* s = (Store*)h;
  std::string tmp = s->path + ".compact";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) return -1;
  bool ok = true;
  for (const auto& [k, v] : s->data) {
    uint8_t op = 1;
    uint32_t klen = (uint32_t)k.size(), vlen = (uint32_t)v.size();
    ok = ok && fwrite(&op, 1, 1, f) == 1;
    ok = ok && fwrite(&klen, 4, 1, f) == 1;
    ok = ok && fwrite(&vlen, 4, 1, f) == 1;
    if (klen) ok = ok && fwrite(k.data(), 1, klen, f) == klen;
    if (vlen) ok = ok && fwrite(v.data(), 1, vlen, f) == vlen;
    if (!ok) break;
  }
  ok = (fclose(f) == 0) && ok;
  if (!ok) {
    remove(tmp.c_str());
    return -1;  // WAL untouched; store remains fully usable
  }
  fclose(s->log);
  s->log = nullptr;
  if (rename(tmp.c_str(), s->path.c_str()) != 0) {
    remove(tmp.c_str());
    s->log = fopen(s->path.c_str(), "ab");  // reopen the original WAL
    return -1;
  }
  s->log = fopen(s->path.c_str(), "ab");
  s->log_records = s->data.size();
  return s->log ? 0 : -1;
}

uint64_t kv_log_records(void* h) { return ((Store*)h)->log_records; }

void kv_close(void* h) {
  Store* s = (Store*)h;
  if (s->log) fclose(s->log);
  delete s;
}

// -- ordered range iteration (bucket-prefix scans) --------------------------

void* kv_iter_new(void* h, const uint8_t* start, uint32_t slen,
                  const uint8_t* end, uint32_t elen) {
  Store* s = (Store*)h;
  Iter* it = new Iter();
  it->cur = slen ? s->data.lower_bound(std::string((const char*)start, slen))
                 : s->data.begin();
  it->end = elen ? s->data.lower_bound(std::string((const char*)end, elen))
                 : s->data.end();
  return it;
}

// 1 = entry copied and iterator advanced; 0 = end; -1 = buffers too
// small (sizes reported in klen/vlen, iterator NOT advanced — retry
// with bigger buffers).
int kv_iter_next(void* it_, uint8_t* kout, uint32_t kcap, int64_t* klen,
                 uint8_t* vout, uint32_t vcap, int64_t* vlen) {
  Iter* it = (Iter*)it_;
  if (it->cur == it->end) return 0;
  const std::string& k = it->cur->first;
  const std::string& v = it->cur->second;
  *klen = (int64_t)k.size();
  *vlen = (int64_t)v.size();
  if (k.size() > kcap || v.size() > vcap) return -1;
  if (k.size()) memcpy(kout, k.data(), k.size());
  if (v.size()) memcpy(vout, v.data(), v.size());
  ++it->cur;
  return 1;
}

void kv_iter_free(void* it) { delete (Iter*)it; }

}  // extern "C"
