// Native batch codecs for the reference wire formats.
//
// The per-record codecs (`storage/serializers.py`) are bit-compatible with
// the reference's `utils/Serializers.scala` record formats, but encoding
// a million-row corpus record-at-a-time in Python is minutes of work. These
// batch codecs produce the IDENTICAL byte stream (concatenated records) with
// a multithreaded native pass — the framework's runtime-tier equivalent of
// the reference's DataIO/Serializer layer (SURVEY.md §2.4-5).
//
// Wire formats (cites in serializers.py; all ints are PLAIN DataOutput
// 4-byte big-endian — `Serializers.scala` never varint-packs record
// fields; asserted against spec-derived golden fixtures):
//   dense : be32(id) be32(dim) dim x big-endian f64
//   sparse: be32(id) be32(size) be32(nnz) nnz x be32(idx)
//           nnz x big-endian f64
//
// A copy of similaritysearchbyrdf_tpu/native/rdf_codec.cc, built into
// librdf_loader.so with rdf_loader.cc by native/loader.py, loaded via ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void put_be32(uint32_t v, uint8_t* out) {
  v = __builtin_bswap32(v);
  std::memcpy(out, &v, 4);
}

inline uint32_t get_be32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return __builtin_bswap32(v);
}

inline void put_be64(double d, uint8_t* out) {
  uint64_t u;
  std::memcpy(&u, &d, 8);
  u = __builtin_bswap64(u);
  std::memcpy(out, &u, 8);
}

inline double get_be64(const uint8_t* p) {
  uint64_t u;
  std::memcpy(&u, p, 8);
  u = __builtin_bswap64(u);
  double d;
  std::memcpy(&d, &u, 8);
  return d;
}

int n_threads() {
  unsigned hc = std::thread::hardware_concurrency();
  return hc ? static_cast<int>(hc) : 4;
}

struct Buf {
  uint8_t* data = nullptr;
  int64_t len = 0;
};

struct DenseBatch {
  std::vector<int32_t> ids;
  std::vector<double> values;
  int64_t n = 0, dim = 0;
};

struct SparseBatch {
  std::vector<int32_t> ids;
  std::vector<int32_t> idx;    // n * max_nnz (padded 0)
  std::vector<double> val;     // n * max_nnz (padded 0)
  std::vector<int32_t> nnz;
  int64_t n = 0, size = 0, max_nnz = 0;
};

}  // namespace

extern "C" {

uint8_t* rdf_encode_dense_batch(const int32_t* ids, const double* values,
                                int64_t n, int64_t dim, int64_t* out_len) {
  // fixed-size records: be32 id + be32 dim + 8*dim payload
  const int64_t rec = 8 + 8 * dim;
  int64_t total = rec * n;
  uint8_t* out = static_cast<uint8_t*>(std::malloc(total));
  if (!out) return nullptr;
  int nt = n_threads();
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&, t] {
      for (int64_t i = t; i < n; i += nt) {
        uint8_t* p = out + rec * i;
        put_be32(static_cast<uint32_t>(ids[i]), p);
        put_be32(static_cast<uint32_t>(dim), p + 4);
        p += 8;
        const double* row = values + i * dim;
        for (int64_t j = 0; j < dim; ++j) put_be64(row[j], p + 8 * j);
      }
    });
  }
  for (auto& th : ts) th.join();
  *out_len = total;
  return out;
}

void rdf_free_buf(uint8_t* p) { std::free(p); }

void* rdf_decode_dense_batch(const uint8_t* buf, int64_t len, int64_t* n,
                             int64_t* dim) {
  auto* b = new DenseBatch();
  size_t off = 0;
  while (static_cast<int64_t>(off) + 8 <= len) {
    uint32_t id = get_be32(buf + off);
    uint32_t d = get_be32(buf + off + 4);
    off += 8;
    if (b->dim == 0) b->dim = d;
    if (d != static_cast<uint32_t>(b->dim) ||
        static_cast<int64_t>(off) + 8 * static_cast<int64_t>(d) > len) {
      delete b;
      return nullptr;
    }
    b->ids.push_back(static_cast<int32_t>(id));
    for (uint32_t j = 0; j < d; ++j)
      b->values.push_back(get_be64(buf + off + 8 * j));
    off += 8 * static_cast<size_t>(d);
    ++b->n;
  }
  *n = b->n;
  *dim = b->dim;
  return b;
}

void rdf_copy_dense_batch(void* h, int32_t* ids, double* values) {
  auto* b = static_cast<DenseBatch*>(h);
  std::memcpy(ids, b->ids.data(), b->ids.size() * 4);
  std::memcpy(values, b->values.data(), b->values.size() * 8);
}

void rdf_free_dense_batch(void* h) { delete static_cast<DenseBatch*>(h); }

uint8_t* rdf_encode_sparse_batch(const int32_t* ids, int32_t size,
                                 const int32_t* idx, const double* val,
                                 const int32_t* nnz, int64_t n,
                                 int64_t max_nnz, int64_t* out_len) {
  // record length depends only on nnz: 12-byte header + 12 bytes per entry
  std::vector<int64_t> offs(n + 1, 0);
  for (int64_t i = 0; i < n; ++i)
    offs[i + 1] = offs[i] + 12 + 12 * static_cast<int64_t>(nnz[i]);
  int64_t total = offs[n];
  uint8_t* out = static_cast<uint8_t*>(std::malloc(total));
  if (!out) return nullptr;
  int nt = n_threads();
  std::vector<std::thread> ts;
  for (int t = 0; t < nt; ++t) {
    ts.emplace_back([&, t] {
      for (int64_t i = t; i < n; i += nt) {
        uint8_t* p = out + offs[i];
        put_be32(static_cast<uint32_t>(ids[i]), p);
        put_be32(static_cast<uint32_t>(size), p + 4);
        put_be32(static_cast<uint32_t>(nnz[i]), p + 8);
        p += 12;
        const int32_t* row_idx = idx + i * max_nnz;
        const double* row_val = val + i * max_nnz;
        for (int32_t j = 0; j < nnz[i]; ++j)
          put_be32(static_cast<uint32_t>(row_idx[j]), p + 4 * j);
        p += 4 * static_cast<int64_t>(nnz[i]);
        for (int32_t j = 0; j < nnz[i]; ++j) put_be64(row_val[j], p + 8 * j);
      }
    });
  }
  for (auto& th : ts) th.join();
  *out_len = total;
  return out;
}

void* rdf_decode_sparse_batch(const uint8_t* buf, int64_t len, int64_t* n,
                              int64_t* size, int64_t* max_nnz) {
  auto* b = new SparseBatch();
  size_t off = 0;
  std::vector<std::vector<int32_t>> all_idx;
  std::vector<std::vector<double>> all_val;
  while (static_cast<int64_t>(off) + 12 <= len) {
    uint32_t id = get_be32(buf + off);
    uint32_t sz = get_be32(buf + off + 4);
    uint32_t k = get_be32(buf + off + 8);
    off += 12;
    b->ids.push_back(static_cast<int32_t>(id));
    b->size = sz;
    if (static_cast<int64_t>(off) + 12 * static_cast<int64_t>(k) > len) {
      delete b;
      return nullptr;
    }
    std::vector<int32_t> ri(k);
    for (uint32_t j = 0; j < k; ++j)
      ri[j] = static_cast<int32_t>(get_be32(buf + off + 4 * j));
    off += 4 * static_cast<size_t>(k);
    std::vector<double> rv(k);
    for (uint32_t j = 0; j < k; ++j) rv[j] = get_be64(buf + off + 8 * j);
    off += 8 * static_cast<size_t>(k);
    if (static_cast<int64_t>(k) > b->max_nnz) b->max_nnz = k;
    b->nnz.push_back(static_cast<int32_t>(k));
    all_idx.push_back(std::move(ri));
    all_val.push_back(std::move(rv));
    ++b->n;
  }
  b->idx.assign(b->n * b->max_nnz, 0);
  b->val.assign(b->n * b->max_nnz, 0.0);
  for (int64_t i = 0; i < b->n; ++i) {
    std::memcpy(b->idx.data() + i * b->max_nnz, all_idx[i].data(),
                all_idx[i].size() * 4);
    std::memcpy(b->val.data() + i * b->max_nnz, all_val[i].data(),
                all_val[i].size() * 8);
  }
  *n = b->n;
  *size = b->size;
  *max_nnz = b->max_nnz;
  return b;
}

void rdf_copy_sparse_batch(void* h, int32_t* ids, int32_t* idx, double* val,
                           int32_t* nnz) {
  auto* b = static_cast<SparseBatch*>(h);
  std::memcpy(ids, b->ids.data(), b->ids.size() * 4);
  std::memcpy(idx, b->idx.data(), b->idx.size() * 4);
  std::memcpy(val, b->val.data(), b->val.size() * 8);
  std::memcpy(nnz, b->nnz.data(), b->nnz.size() * 4);
}

void rdf_free_sparse_batch(void* h) { delete static_cast<SparseBatch*>(h); }

}  // extern "C"
