// Fast click-file parser: the native data-ingest component.
//
// The reference frontend parses "user item1 item2 ..." text files in pure
// Python line-by-line (cf/datasets.py:31-68) — minutes at the 100M-user
// synthetic scale. This parser slurps the file, splits it into byte chunks
// on line boundaries, and parses integers with OpenMP threads, then
// resolves duplicate user lines (last line wins, matching the Python dict
// overwrite semantics, datasets.py:45) into a CSR layout (offsets per user
// + item stream) that the Python side wraps zero-copy into numpy arrays.
//
// Exposed with a C ABI for ctypes (no pybind11 in this image):
//   parse_click_file(path, sep) -> handle (NULL on failure)
//   parsed_{num_users,num_items,num_pairs}(handle)
//   parsed_fill(handle, offsets_out, items_out)   // copies out CSR
//   parsed_free(handle)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Parsed {
  int64_t num_users = 0;  // max user id + 1
  int64_t num_items = 0;  // max item id + 1
  std::vector<int64_t> offsets;  // (num_users + 1) CSR offsets
  std::vector<int32_t> items;    // item stream in user-id order
};

struct RawLines {
  std::vector<int32_t> user;
  std::vector<std::vector<int32_t>> items;
};

// Parse [begin, end) of the buffer: whole lines only.
void parse_chunk(const char* begin, const char* end, char sep, RawLines* out) {
  const char* p = begin;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    const char* line_end = nl ? nl : end;
    int64_t user = -1;
    std::vector<int32_t> items;
    const char* q = p;
    while (q < line_end) {
      while (q < line_end &&
             (*q == sep || *q == ' ' || *q == '\t' || *q == '\r')) {
        ++q;
      }
      if (q >= line_end) break;
      int64_t v = 0;
      bool any = false;
      while (q < line_end && *q >= '0' && *q <= '9') {
        v = v * 10 + (*q - '0');
        ++q;
        any = true;
      }
      if (!any) {
        ++q;  // non-numeric byte: skip
        continue;
      }
      if (user < 0) {
        user = v;
      } else {
        items.push_back(static_cast<int32_t>(v));
      }
    }
    if (user >= 0) {
      out->user.push_back(static_cast<int32_t>(user));
      out->items.push_back(std::move(items));
    }
    p = line_end + 1;
  }
}

}  // namespace

extern "C" {

void* parse_click_file(const char* path, char sep) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size);
  if (size > 0 && fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  int nthreads = 1;
#ifdef _OPENMP
  nthreads = omp_get_max_threads();
#endif
  std::vector<const char*> bounds(nthreads + 1);
  bounds[0] = buf.data();
  bounds[nthreads] = buf.data() + size;
  for (int t = 1; t < nthreads; ++t) {
    const char* guess = buf.data() + (size * t) / nthreads;
    const char* nl = static_cast<const char*>(
        memchr(guess, '\n', buf.data() + size - guess));
    bounds[t] = nl ? nl + 1 : buf.data() + size;
  }
  // Boundaries must be monotone (tiny files can fold chunks together).
  for (int t = 1; t < nthreads; ++t) {
    bounds[t] = std::max(bounds[t], bounds[t - 1]);
  }

  std::vector<RawLines> partial(nthreads);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int t = 0; t < nthreads; ++t) {
    if (bounds[t] < bounds[t + 1]) {
      parse_chunk(bounds[t], bounds[t + 1], sep, &partial[t]);
    }
  }

  // Merge, resolve duplicate user lines (last wins), and build CSR.
  int64_t max_user = -1, max_item = -1, num_lines = 0;
  for (const auto& part : partial) num_lines += part.user.size();
  std::vector<const std::vector<int32_t>*> line_items;
  std::vector<int32_t> line_user;
  line_items.reserve(num_lines);
  line_user.reserve(num_lines);
  for (const auto& part : partial) {
    for (size_t i = 0; i < part.user.size(); ++i) {
      line_user.push_back(part.user[i]);
      line_items.push_back(&part.items[i]);
      max_user = std::max<int64_t>(max_user, part.user[i]);
      for (int32_t it : part.items[i]) {
        max_item = std::max<int64_t>(max_item, it);
      }
    }
  }

  auto* out = new Parsed();
  out->num_users = max_user + 1;
  out->num_items = max_item + 1;
  std::vector<int64_t> line_of(out->num_users, -1);
  for (int64_t i = 0; i < num_lines; ++i) line_of[line_user[i]] = i;

  out->offsets.resize(out->num_users + 1);
  int64_t total = 0;
  for (int64_t u = 0; u < out->num_users; ++u) {
    out->offsets[u] = total;
    if (line_of[u] >= 0) total += static_cast<int64_t>(line_items[line_of[u]]->size());
  }
  out->offsets[out->num_users] = total;
  out->items.resize(total);
  for (int64_t u = 0; u < out->num_users; ++u) {
    if (line_of[u] >= 0) {
      const auto& its = *line_items[line_of[u]];
      memcpy(out->items.data() + out->offsets[u], its.data(),
             its.size() * sizeof(int32_t));
    }
  }
  return out;
}

int64_t parsed_num_users(void* h) { return static_cast<Parsed*>(h)->num_users; }
int64_t parsed_num_items(void* h) { return static_cast<Parsed*>(h)->num_items; }
int64_t parsed_num_pairs(void* h) {
  return static_cast<int64_t>(static_cast<Parsed*>(h)->items.size());
}

void parsed_fill(void* h, int64_t* offsets_out, int32_t* items_out) {
  Parsed* p = static_cast<Parsed*>(h);
  memcpy(offsets_out, p->offsets.data(), p->offsets.size() * sizeof(int64_t));
  if (!p->items.empty()) {
    memcpy(items_out, p->items.data(), p->items.size() * sizeof(int32_t));
  }
}

void parsed_free(void* h) { delete static_cast<Parsed*>(h); }

}  // extern "C"
