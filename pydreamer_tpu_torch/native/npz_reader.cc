// Parallel npz (zip-of-npy) reader for the replay data plane.
//
// The reference's data loader is Python np.load in DataLoader workers
// (reference: pydreamer/data.py:35-37 via mlflow_load_npz). At accelerator
// training rates the learner consumes hundreds of MB/s of decompressed episode data;
// this native reader parses the zip central directory once and inflates all
// entries concurrently with a C++ thread pool, writing straight into
// Python-owned buffers (zero copies beyond the inflate itself, GIL released
// for the whole call).
//
// Scope: the subset of zip that numpy's savez_compressed emits — local
// file headers with correct sizes, deflate or stored entries, optional
// zip64 EOCD. Python parses the npy header from the inflated bytes.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 npz_reader.cc -o libnpz_reader.so -lz -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Entry {
  std::string name;
  uint64_t header_offset;   // offset of local file header
  uint64_t comp_size;
  uint64_t uncomp_size;
  uint16_t method;          // 0 = stored, 8 = deflate
  uint64_t data_offset;     // resolved lazily from the local header
};

struct NpzFile {
  FILE* fp = nullptr;
  std::vector<Entry> entries;
  std::string error;
};

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint64_t rd64(const uint8_t* p) {
  return (uint64_t)rd32(p) | ((uint64_t)rd32(p + 4) << 32);
}

bool read_at(FILE* fp, uint64_t off, void* dst, size_t n) {
  if (fseeko(fp, (off_t)off, SEEK_SET) != 0) return false;
  return fread(dst, 1, n, fp) == n;
}

// Parse the central directory (with zip64 support).
bool parse_central_dir(NpzFile* f) {
  if (fseeko(f->fp, 0, SEEK_END) != 0) return false;
  uint64_t file_size = (uint64_t)ftello(f->fp);
  // Find EOCD: signature 0x06054b50 within the last 64KB+22.
  uint64_t scan = file_size < 65558 ? file_size : 65558;
  std::vector<uint8_t> tail(scan);
  if (!read_at(f->fp, file_size - scan, tail.data(), scan)) return false;
  int64_t eocd = -1;
  for (int64_t i = (int64_t)scan - 22; i >= 0; i--) {
    if (rd32(&tail[i]) == 0x06054b50) { eocd = i; break; }
  }
  if (eocd < 0) { f->error = "EOCD not found"; return false; }
  uint64_t eocd_off = file_size - scan + eocd;
  uint64_t n_entries = rd16(&tail[eocd + 10]);
  uint64_t cd_size = rd32(&tail[eocd + 12]);
  uint64_t cd_off = rd32(&tail[eocd + 16]);

  // zip64? (numpy emits it for >4GB archives or when forced)
  if (n_entries == 0xFFFF || cd_off == 0xFFFFFFFFu || cd_size == 0xFFFFFFFFu) {
    uint8_t loc[20];
    if (eocd_off < 20 || !read_at(f->fp, eocd_off - 20, loc, 20) ||
        rd32(loc) != 0x07064b50) {
      f->error = "zip64 locator not found";
      return false;
    }
    uint64_t z64_off = rd64(loc + 8);
    uint8_t z64[56];
    if (!read_at(f->fp, z64_off, z64, 56) || rd32(z64) != 0x06064b50) {
      f->error = "zip64 EOCD not found";
      return false;
    }
    n_entries = rd64(z64 + 32);
    cd_size = rd64(z64 + 40);
    cd_off = rd64(z64 + 48);
  }

  std::vector<uint8_t> cd(cd_size);
  if (!read_at(f->fp, cd_off, cd.data(), cd_size)) return false;

  uint64_t p = 0;
  for (uint64_t i = 0; i < n_entries; i++) {
    if (p + 46 > cd_size || rd32(&cd[p]) != 0x02014b50) {
      f->error = "bad central directory entry";
      return false;
    }
    Entry e;
    e.method = rd16(&cd[p + 10]);
    e.comp_size = rd32(&cd[p + 20]);
    e.uncomp_size = rd32(&cd[p + 24]);
    uint16_t name_len = rd16(&cd[p + 28]);
    uint16_t extra_len = rd16(&cd[p + 30]);
    uint16_t comment_len = rd16(&cd[p + 32]);
    e.header_offset = rd32(&cd[p + 42]);
    e.name.assign((const char*)&cd[p + 46], name_len);
    // zip64 extra field overrides 0xFFFFFFFF values.
    uint64_t xp = p + 46 + name_len;
    uint64_t xend = xp + extra_len;
    while (xp + 4 <= xend) {
      uint16_t tag = rd16(&cd[xp]);
      uint16_t sz = rd16(&cd[xp + 2]);
      if (tag == 0x0001) {
        uint64_t fp2 = xp + 4;
        if (e.uncomp_size == 0xFFFFFFFFu) { e.uncomp_size = rd64(&cd[fp2]); fp2 += 8; }
        if (e.comp_size == 0xFFFFFFFFu) { e.comp_size = rd64(&cd[fp2]); fp2 += 8; }
        if (e.header_offset == 0xFFFFFFFFu) { e.header_offset = rd64(&cd[fp2]); }
      }
      xp += 4 + sz;
    }
    e.data_offset = 0;  // resolved on demand
    f->entries.push_back(std::move(e));
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// Local header: 30 bytes + name + extra, then data.
bool resolve_data_offset(NpzFile* f, Entry* e) {
  if (e->data_offset) return true;
  uint8_t lh[30];
  if (!read_at(f->fp, e->header_offset, lh, 30) || rd32(lh) != 0x04034b50) {
    f->error = "bad local header";
    return false;
  }
  uint16_t name_len = rd16(&lh[26]);
  uint16_t extra_len = rd16(&lh[28]);
  e->data_offset = e->header_offset + 30 + name_len + extra_len;
  return true;
}

bool inflate_entry(const uint8_t* src, uint64_t comp_size, uint8_t* dst,
                   uint64_t uncomp_size, uint16_t method) {
  if (method == 0) {  // stored
    if (comp_size != uncomp_size) return false;
    memcpy(dst, src, uncomp_size);
    return true;
  }
  if (method != 8) return false;
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) return false;  // raw deflate
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)comp_size;
  zs.next_out = dst;
  zs.avail_out = (uInt)uncomp_size;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return rc == Z_STREAM_END && zs.total_out == uncomp_size;
}

}  // namespace

extern "C" {

void* npz_open(const char* path) {
  auto* f = new NpzFile();
  f->fp = fopen(path, "rb");
  if (!f->fp) { delete f; return nullptr; }
  if (!parse_central_dir(f)) {
    fclose(f->fp);
    delete f;
    return nullptr;
  }
  return f;
}

int npz_count(void* handle) {
  return (int)((NpzFile*)handle)->entries.size();
}

const char* npz_name(void* handle, int i) {
  return ((NpzFile*)handle)->entries[i].name.c_str();
}

long long npz_uncomp_size(void* handle, int i) {
  return (long long)((NpzFile*)handle)->entries[i].uncomp_size;
}

// Inflate all entries concurrently into caller-provided buffers.
// dsts[i] must hold npz_uncomp_size(i) bytes. Returns 0 on success.
int npz_read_all(void* handle, void** dsts, int nthreads) {
  auto* f = (NpzFile*)handle;
  const int n = (int)f->entries.size();
  // Read compressed bytes serially (one disk pass, page-cache friendly) ...
  std::vector<std::vector<uint8_t>> comp(n);
  for (int i = 0; i < n; i++) {
    Entry& e = f->entries[i];
    if (!resolve_data_offset(f, &e)) return 1;
    comp[i].resize(e.comp_size);
    if (!read_at(f->fp, e.data_offset, comp[i].data(), e.comp_size)) return 2;
  }
  // ... then inflate in parallel.
  if (nthreads < 1) nthreads = 1;
  std::vector<int> status(n, 0);
  std::vector<std::thread> pool;
  std::vector<int> next_idx(1, 0);
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += nthreads) {
      const Entry& e = f->entries[i];
      if (!inflate_entry(comp[i].data(), e.comp_size, (uint8_t*)dsts[i],
                         e.uncomp_size, e.method)) {
        status[i] = 1;
      }
    }
  };
  for (int t = 1; t < nthreads; t++) pool.emplace_back(worker, t);
  worker(0);
  for (auto& th : pool) th.join();
  for (int i = 0; i < n; i++) {
    if (status[i]) return 3;
  }
  return 0;
}

void npz_close(void* handle) {
  auto* f = (NpzFile*)handle;
  if (f->fp) fclose(f->fp);
  delete f;
}

}  // extern "C"
