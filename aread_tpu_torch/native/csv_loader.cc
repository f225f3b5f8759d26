// Native CSV -> tensor loader for the aread_tpu_torch data layer (the
// port's own copy of aread_tpu/native/csv_loader.cc; the parse is the same
// bit for bit).
//
// Replaces the pandas read + per-row python seq parsing of the reference's
// save_tensor_from_data (reference run.py:237-265: pandas read_csv, ast
// literal_eval per sequence cell, keras pad_sequences) with a single
// multi-threaded pass over the file:
//   * one-hot columns  -> int32, row-major [N, n_onehot + n_seq*maxlen]
//   * sequence columns ("[id, id, ...]", possibly quoted) -> last `maxlen`
//     ids, padded with `pad_value` (run.py:105-111 keeps the LAST maxlen)
//   * label column -> int8
//   * split column (timestamp / train_tag) -> double
//
// Assumptions matching the generated CSVs: no embedded newlines inside
// quoted fields; quotes only wrap whole fields.
//
// Build: aread_tpu_torch/native/__init__.py compiles it at first use
// (g++ -O3 -std=c++17 -fPIC -pthread -shared) into aread_tpu_torch/_build/;
// python -m aread_tpu_torch.native builds it explicitly.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

thread_local std::string g_error;
std::string g_last_error;

struct Columns {
  std::vector<int> onehot;   // field index in the header
  std::vector<int> seq;
  int label = -1;
  int split = -1;
  int max_needed = -1;
};

std::vector<std::string> split_header(const std::string& line) {
  std::vector<std::string> out;
  std::string cur;
  for (char c : line) {
    if (c == ',') {
      out.push_back(cur);
      cur.clear();
    } else if (c != '\r') {
      cur += c;
    }
  }
  out.push_back(cur);
  return out;
}

// Split one data line into field [begin,end) spans, honoring quotes.
inline int split_fields(const char* p, const char* line_end,
                        const char** begins, const char** ends, int max_fields) {
  int n = 0;
  while (p <= line_end && n < max_fields) {
    const char* fb;
    const char* fe;
    if (*p == '"') {
      fb = p + 1;
      const char* q = fb;
      while (q < line_end && *q != '"') ++q;
      fe = q;
      p = q + 1;                       // skip closing quote
      while (p < line_end && *p != ',') ++p;  // to the comma
      ++p;                             // past the comma
    } else {
      fb = p;
      const char* q = p;
      while (q < line_end && *q != ',') ++q;
      fe = q;
      if (fe > fb && fe[-1] == '\r') --fe;
      p = q + 1;
    }
    begins[n] = fb;
    ends[n] = fe;
    ++n;
    if (p > line_end) break;
  }
  return n;
}

inline int64_t parse_int(const char* b, const char* e, bool* ok) {
  while (b < e && (*b == ' ' || *b == '\t')) ++b;
  bool neg = false;
  if (b < e && (*b == '-' || *b == '+')) {
    neg = (*b == '-');
    ++b;
  }
  if (b >= e) {
    *ok = false;
    return 0;
  }
  int64_t v = 0;
  for (; b < e; ++b) {
    if (*b < '0' || *b > '9') {
      if (*b == '.') break;  // tolerate "3.0"
      *ok = false;
      return 0;
    }
    v = v * 10 + (*b - '0');
  }
  *ok = true;
  return neg ? -v : v;
}

// Parse "[id, id, ...]" (field already unquoted) into the LAST `maxlen`
// ids, left-filled in order, padded on the right with pad_value.
inline bool parse_seq(const char* b, const char* e, int maxlen,
                      int32_t pad_value, int32_t* out) {
  while (b < e && *b != '[') ++b;
  if (b < e) ++b;  // past '['
  const char* close = e;
  while (close > b && close[-1] != ']') --close;
  if (close > b) --close;  // points at ']'
  // ring buffer of the last maxlen ids
  std::vector<int32_t> ring(maxlen);
  int count = 0;
  const char* p = b;
  while (p < close) {
    while (p < close && (*p == ' ' || *p == ',')) ++p;
    if (p >= close) break;
    const char* q = p;
    while (q < close && *q != ',') ++q;
    bool ok = false;
    int64_t v = parse_int(p, q, &ok);
    if (!ok) return false;
    ring[count % maxlen] = static_cast<int32_t>(v);
    ++count;
    p = q + 1;
  }
  int n = count < maxlen ? count : maxlen;
  int start = count <= maxlen ? 0 : count % maxlen;
  for (int i = 0; i < n; ++i) out[i] = ring[(start + i) % maxlen];
  for (int i = n; i < maxlen; ++i) out[i] = pad_value;
  return true;
}

inline double parse_double(const char* b, const char* e, bool* ok) {
  std::string tmp(b, e);
  char* endp = nullptr;
  double v = std::strtod(tmp.c_str(), &endp);
  *ok = endp != tmp.c_str();
  return v;
}

}  // namespace

extern "C" {

struct CsvResult {
  int64_t n_rows;
  int64_t n_x_cols;
  int32_t* x;
  int8_t* y;
  double* split;
};

const char* aread_csv_last_error() { return g_last_error.c_str(); }

void aread_csv_free(CsvResult* r) {
  if (!r) return;
  std::free(r->x);
  std::free(r->y);
  std::free(r->split);
  std::free(r);
}

// col lists are comma-separated header names. Returns nullptr on error
// (message via aread_csv_last_error).
CsvResult* aread_csv_load(const char* path, const char* onehot_cols_csv,
                          const char* seq_cols_csv, const char* label_col,
                          const char* split_col, int seq_maxlen,
                          int64_t pad_value, int n_threads) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) {
    g_last_error = std::string("cannot open ") + path;
    return nullptr;
  }
  const int64_t size = f.tellg();
  f.seekg(0);
  std::vector<char> buf(size);
  if (!f.read(buf.data(), size)) {
    g_last_error = "read failed";
    return nullptr;
  }

  const char* data = buf.data();
  const char* end = data + size;
  const char* hdr_end = static_cast<const char*>(memchr(data, '\n', size));
  if (!hdr_end) {
    g_last_error = "no header line";
    return nullptr;
  }
  std::vector<std::string> header = split_header(std::string(data, hdr_end));

  auto find_col = [&](const std::string& name) {
    for (size_t i = 0; i < header.size(); ++i)
      if (header[i] == name) return static_cast<int>(i);
    return -1;
  };
  auto parse_list = [&](const char* csv, std::vector<int>* out) {
    if (!csv || !*csv) return true;
    for (const std::string& name : split_header(csv)) {
      int idx = find_col(name);
      if (idx < 0) {
        g_last_error = "column not found: " + name;
        return false;
      }
      out->push_back(idx);
    }
    return true;
  };

  Columns cols;
  if (!parse_list(onehot_cols_csv, &cols.onehot)) return nullptr;
  if (!parse_list(seq_cols_csv, &cols.seq)) return nullptr;
  cols.label = find_col(label_col);
  cols.split = find_col(split_col);
  if (cols.label < 0 || cols.split < 0) {
    g_last_error = std::string("label/split column not found: ") + label_col +
                   "/" + split_col;
    return nullptr;
  }
  cols.max_needed = std::max(cols.label, cols.split);
  for (int c : cols.onehot) cols.max_needed = std::max(cols.max_needed, c);
  for (int c : cols.seq) cols.max_needed = std::max(cols.max_needed, c);

  const char* body = hdr_end + 1;
  const int64_t body_size = end - body;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }

  // chunk boundaries at newlines
  std::vector<const char*> chunk_begin(n_threads), chunk_end(n_threads);
  {
    const char* p = body;
    for (int t = 0; t < n_threads; ++t) {
      chunk_begin[t] = p;
      const char* target = body + body_size * (t + 1) / n_threads;
      if (target >= end) {
        p = end;
      } else {
        const char* nl = static_cast<const char*>(
            memchr(target, '\n', end - target));
        p = nl ? nl + 1 : end;
      }
      chunk_end[t] = p;
    }
  }

  // pass 1: count rows per chunk
  std::vector<int64_t> rows_in_chunk(n_threads, 0);
  {
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t) {
      th.emplace_back([&, t] {
        int64_t n = 0;
        const char* p = chunk_begin[t];
        while (p < chunk_end[t]) {
          const char* nl = static_cast<const char*>(
              memchr(p, '\n', chunk_end[t] - p));
          if (!nl) {
            if (chunk_end[t] - p > 1) ++n;  // last line w/o newline
            break;
          }
          if (nl > p) ++n;  // skip empty lines
          p = nl + 1;
        }
        rows_in_chunk[t] = n;
      });
    }
    for (auto& x : th) x.join();
  }
  std::vector<int64_t> row_offset(n_threads + 1, 0);
  for (int t = 0; t < n_threads; ++t)
    row_offset[t + 1] = row_offset[t] + rows_in_chunk[t];
  const int64_t n_rows = row_offset[n_threads];

  const int64_t n_x_cols =
      static_cast<int64_t>(cols.onehot.size()) +
      static_cast<int64_t>(cols.seq.size()) * seq_maxlen;
  int32_t* X = static_cast<int32_t*>(std::malloc(n_rows * n_x_cols * 4));
  int8_t* Y = static_cast<int8_t*>(std::malloc(n_rows));
  double* S = static_cast<double*>(std::malloc(n_rows * 8));
  if (!X || !Y || !S) {
    std::free(X);
    std::free(Y);
    std::free(S);
    g_last_error = "allocation failed";
    return nullptr;
  }

  // pass 2: parse
  std::atomic<bool> failed{false};
  std::vector<std::string> errors(n_threads);
  {
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t) {
      th.emplace_back([&, t] {
        const int max_fields = static_cast<int>(header.size()) + 2;
        std::vector<const char*> fb(max_fields), fe(max_fields);
        int64_t row = row_offset[t];
        const char* p = chunk_begin[t];
        while (p < chunk_end[t] && !failed.load(std::memory_order_relaxed)) {
          const char* nl = static_cast<const char*>(
              memchr(p, '\n', chunk_end[t] - p));
          const char* line_end = nl ? nl : chunk_end[t];
          if (line_end > p + 1) {
            int nf = split_fields(p, line_end, fb.data(), fe.data(), max_fields);
            if (nf <= cols.max_needed) {
              errors[t] = "row " + std::to_string(row) + ": too few fields";
              failed = true;
              break;
            }
            int32_t* xr = X + row * n_x_cols;
            bool ok = true;
            int64_t k = 0;
            for (int c : cols.onehot) {
              int64_t v = parse_int(fb[c], fe[c], &ok);
              if (!ok) break;
              xr[k++] = static_cast<int32_t>(v);
            }
            if (ok) {
              for (int c : cols.seq) {
                if (!parse_seq(fb[c], fe[c], seq_maxlen,
                               static_cast<int32_t>(pad_value), xr + k)) {
                  ok = false;
                  break;
                }
                k += seq_maxlen;
              }
            }
            if (ok) {
              int64_t yv = parse_int(fb[cols.label], fe[cols.label], &ok);
              Y[row] = static_cast<int8_t>(yv);
            }
            if (ok) {
              S[row] = parse_double(fb[cols.split], fe[cols.split], &ok);
            }
            if (!ok) {
              errors[t] = "row " + std::to_string(row) + ": parse error";
              failed = true;
              break;
            }
            ++row;
          }
          if (!nl) break;
          p = nl + 1;
        }
      });
    }
    for (auto& x : th) x.join();
  }
  if (failed.load()) {
    for (auto& e : errors)
      if (!e.empty()) g_last_error = e;
    std::free(X);
    std::free(Y);
    std::free(S);
    return nullptr;
  }

  CsvResult* r = static_cast<CsvResult*>(std::malloc(sizeof(CsvResult)));
  r->n_rows = n_rows;
  r->n_x_cols = n_x_cols;
  r->x = X;
  r->y = Y;
  r->split = S;
  return r;
}

}  // extern "C"
