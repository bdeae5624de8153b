// Native bulk dataset parser for the forest's host-side data path.
//
// The reference's ingest is line-at-a-time Scala string splitting on the JVM
// (`Vectors.parseDense`, `Vector.scala:215-219`; `Vectors.fromString`,
// `Vector.scala:162-175`) inside its fit loops. Here parsing is a native,
// multithreaded pass over the whole file (the framework's equivalent of the
// reference's JVM-internal "native tier", SURVEY.md §0) so host ingest never
// bottlenecks device index builds.
//
// Formats:
//   dense : one `[id,[v0,v1,...]]` line per vector
//   sparse: one `(id,size,[i...],[v...])` line per vector
//
// A copy of similaritysearchbyrdf_tpu/native/rdf_loader.cc. Built with
// rdf_codec.cc by g++ on first use (native/loader.py) into
// build/native/<source hash>/librdf_loader.so, loaded via ctypes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct DenseResult {
  std::vector<int32_t> ids;
  std::vector<float> values;  // rows * dim
  int64_t rows = 0;
  int64_t dim = 0;
};

struct SparseRow {
  int32_t id;
  std::vector<int32_t> idx;
  std::vector<float> val;
};

struct SparseResult {
  std::vector<SparseRow> rows;
  int64_t size = 0;     // dimensionality
  int64_t max_nnz = 0;
};

// Skip characters until a digit, sign, or '.' (number start).
inline const char* skip_to_number(const char* p, const char* end) {
  while (p < end && !((*p >= '0' && *p <= '9') || *p == '-' || *p == '+' ||
                      *p == '.'))
    ++p;
  return p;
}

bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(n));
  size_t got = std::fread(out->empty() ? nullptr : &(*out)[0], 1,
                          static_cast<size_t>(n), f);
  std::fclose(f);
  out->resize(got);
  return true;
}

// Split the buffer into per-thread chunks on line boundaries.
std::vector<std::pair<const char*, const char*>> chunk_lines(
    const std::string& buf, int nthreads) {
  std::vector<std::pair<const char*, const char*>> chunks;
  const char* begin = buf.data();
  const char* end = buf.data() + buf.size();
  size_t step = buf.size() / static_cast<size_t>(nthreads) + 1;
  const char* p = begin;
  while (p < end) {
    const char* q = p + step;
    if (q >= end) {
      q = end;
    } else {
      while (q < end && *q != '\n') ++q;
      if (q < end) ++q;
    }
    chunks.emplace_back(p, q);
    p = q;
  }
  return chunks;
}

// Parse one dense line `[id,[v0,...]]`; returns nnz parsed or -1.
inline int64_t parse_dense_line(const char* p, const char* end, int32_t* id,
                                std::vector<float>* vals) {
  p = skip_to_number(p, end);
  if (p >= end) return -1;
  char* next = nullptr;
  *id = static_cast<int32_t>(std::strtol(p, &next, 10));
  p = next;
  int64_t n = 0;
  while (true) {
    p = skip_to_number(p, end);
    if (p >= end) break;
    float v = std::strtof(p, &next);
    if (next == p) break;
    vals->push_back(v);
    ++n;
    p = next;
  }
  return n;
}

}  // namespace

extern "C" {

void* rdf_parse_dense_file(const char* path, int64_t limit, int64_t* out_rows,
                           int64_t* out_dim) {
  std::string buf;
  if (!read_file(path, &buf)) return nullptr;
  int nthreads =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  auto chunks = chunk_lines(buf, nthreads);

  std::vector<DenseResult> partial(chunks.size());
  std::vector<std::thread> workers;
  for (size_t c = 0; c < chunks.size(); ++c) {
    workers.emplace_back([&, c]() {
      const char* p = chunks[c].first;
      const char* end = chunks[c].second;
      DenseResult& r = partial[c];
      while (p < end) {
        const char* eol = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (!eol) eol = end;
        if (eol > p + 1) {
          int32_t id;
          int64_t n = parse_dense_line(p, eol, &id, &r.values);
          if (n > 0) {
            if (r.dim == 0) r.dim = n;
            if (n == r.dim) {
              r.ids.push_back(id);
              ++r.rows;
            } else {
              // malformed row: drop its values
              r.values.resize(r.values.size() - static_cast<size_t>(n));
            }
          }
        }
        p = eol + 1;
      }
    });
  }
  for (auto& w : workers) w.join();

  auto* out = new DenseResult();
  for (auto& r : partial) {
    if (r.rows == 0) continue;
    if (out->dim == 0) out->dim = r.dim;
    if (r.dim != out->dim) continue;
    out->ids.insert(out->ids.end(), r.ids.begin(), r.ids.end());
    out->values.insert(out->values.end(), r.values.begin(), r.values.end());
    out->rows += r.rows;
  }
  if (limit > 0 && out->rows > limit) {
    out->rows = limit;
    out->ids.resize(static_cast<size_t>(limit));
    out->values.resize(static_cast<size_t>(limit * out->dim));
  }
  *out_rows = out->rows;
  *out_dim = out->dim;
  return out;
}

void rdf_copy_dense(void* handle, int32_t* ids, float* values) {
  auto* r = static_cast<DenseResult*>(handle);
  std::memcpy(ids, r->ids.data(), sizeof(int32_t) * r->ids.size());
  std::memcpy(values, r->values.data(), sizeof(float) * r->values.size());
}

void rdf_free_dense(void* handle) { delete static_cast<DenseResult*>(handle); }

void* rdf_parse_sparse_file(const char* path, int64_t limit, int64_t* out_rows,
                            int64_t* out_max_nnz, int64_t* out_size) {
  std::string buf;
  if (!read_file(path, &buf)) return nullptr;
  auto* out = new SparseResult();
  const char* p = buf.data();
  const char* end = buf.data() + buf.size();
  while (p < end && (limit <= 0 || static_cast<int64_t>(out->rows.size()) < limit)) {
    const char* eol = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!eol) eol = end;
    if (eol > p + 1) {
      // (id,size,[i...],[v...])
      const char* q = skip_to_number(p, eol);
      if (q < eol) {
        char* next = nullptr;
        SparseRow row;
        row.id = static_cast<int32_t>(std::strtol(q, &next, 10));
        q = skip_to_number(next, eol);
        int64_t size = std::strtol(q, &next, 10);
        if (size > out->size) out->size = size;
        // indices block
        const char* lb = static_cast<const char*>(
            std::memchr(next, '[', static_cast<size_t>(eol - next)));
        const char* rb =
            lb ? static_cast<const char*>(
                     std::memchr(lb, ']', static_cast<size_t>(eol - lb)))
               : nullptr;
        if (lb && rb) {
          q = lb + 1;
          while (q < rb) {
            q = skip_to_number(q, rb);
            if (q >= rb) break;
            row.idx.push_back(
                static_cast<int32_t>(std::strtol(q, &next, 10)));
            q = next;
          }
          // values block
          lb = static_cast<const char*>(
              std::memchr(rb, '[', static_cast<size_t>(eol - rb)));
          rb = lb ? static_cast<const char*>(
                        std::memchr(lb, ']', static_cast<size_t>(eol - lb)))
                  : nullptr;
          if (lb && rb) {
            q = lb + 1;
            while (q < rb) {
              q = skip_to_number(q, rb);
              if (q >= rb) break;
              row.val.push_back(std::strtof(q, &next));
              q = next;
            }
            if (row.idx.size() == row.val.size()) {
              if (static_cast<int64_t>(row.idx.size()) > out->max_nnz)
                out->max_nnz = static_cast<int64_t>(row.idx.size());
              out->rows.push_back(std::move(row));
            }
          }
        }
      }
    }
    p = eol + 1;
  }
  *out_rows = static_cast<int64_t>(out->rows.size());
  *out_max_nnz = out->max_nnz;
  *out_size = out->size;
  return out;
}

void rdf_copy_sparse(void* handle, int32_t* ids, int32_t* indices,
                     float* values, int32_t* lengths, int64_t nnz_pad) {
  auto* r = static_cast<SparseResult*>(handle);
  for (size_t i = 0; i < r->rows.size(); ++i) {
    const SparseRow& row = r->rows[i];
    ids[i] = row.id;
    lengths[i] = static_cast<int32_t>(row.idx.size());
    std::memcpy(indices + i * nnz_pad, row.idx.data(),
                sizeof(int32_t) * row.idx.size());
    std::memcpy(values + i * nnz_pad, row.val.data(),
                sizeof(float) * row.val.size());
  }
}

void rdf_free_sparse(void* handle) {
  delete static_cast<SparseResult*>(handle);
}

}  // extern "C"
