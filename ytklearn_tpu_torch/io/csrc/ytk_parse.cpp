// Native multithreaded parser for the ytklearn text data format:
//     weight###label[,label...]###name:val,name:val,...
//
// The port's copy of the JAX package's native/ytk_parse.cpp (the port
// imports nothing of that package and keeps its own source). It is the
// reference ingest hot loop (dataflow/CoreData.java:536-645 readData/
// trainDataSplit and fs/IFileSystem selectRead line-modulo sharding): the
// reference parallelizes parsing across Java reader threads feeding
// per-thread CoreData shards; here the same row-range parallelism runs as
// std::thread workers over byte ranges of one buffer, and the merged output
// is columnar arrays (row_ptr/feat-id/val + ragged labels) that numpy
// assembles into the dense GBDT matrix or the padded-ELL convex layout with
// vectorized scatter stores. Values are parsed as float32.
//
// Parity contract with the Python parser (ytklearn_tpu_torch/io/reader.py
// parse_line): same field splitting (x_delim, >=3 fields, extras ignored),
// same float acceptance (leading +, inf/nan, surrounding whitespace), same
// error-line semantics (malformed line => counted + skipped, contributes no
// feature names), same first-seen feature-name order (by (line, in-line
// position) of first occurrence across kept lines), same empty/whitespace
// line skipping, and the same global line-modulo shard selection
// (i % divisor == remainder over the concatenated line stream).
//
// C ABI only (consumed via ctypes): ytk_parse -> counts -> ytk_fill -> free.
// Built on the host with g++ by ytklearn_tpu_torch/io/native.py.

#include <algorithm>
#include <charconv>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct ThreadOut {
  std::vector<float> weights;
  std::vector<int64_t> label_ptr;  // per-row label counts (delta form)
  std::vector<float> labels;
  std::vector<int64_t> row_nnz;  // per-row feature counts
  std::vector<uint32_t> feat_ids;  // local name ids
  std::vector<float> feat_vals;
  // local name table, insertion-ordered
  std::vector<std::string_view> names;
  std::unordered_map<std::string_view, uint32_t> name_map;
  // first occurrence of each local name: (global line no, in-line position)
  std::vector<int64_t> first_line;
  std::vector<int32_t> first_pos;
  int64_t n_errors = 0;
};

struct ParseResult {
  std::vector<float> weights;
  std::vector<int64_t> label_ptr;  // (n_rows+1,) exclusive prefix
  std::vector<float> labels;
  std::vector<int64_t> row_ptr;  // (n_rows+1,)
  std::vector<int32_t> feat_ids;  // global name ids
  std::vector<float> feat_vals;
  std::vector<std::string_view> names;  // global, first-seen order
  int64_t name_bytes = 0;
  int64_t n_errors = 0;
};

inline std::string_view trim(std::string_view s) {
  size_t b = 0, e = s.size();
  while (b < e && (unsigned char)s[b] <= ' ') b++;
  while (e > b && (unsigned char)s[e - 1] <= ' ') e--;
  return s.substr(b, e - b);
}

// Python float() semantics: surrounding whitespace, a single optional +/-,
// inf/nan, and underscores between digits ('1_5' == 15.0; '_1'/'1_'/'1__5'
// are errors). from_chars also accepts '-', so reject any second sign after
// the manual strip to keep '--1'/'+-2' as error lines like float() does.
inline bool parse_float(std::string_view tok, float* out) {
  tok = trim(tok);
  if (tok.empty()) return false;
  bool neg = false;
  if (tok[0] == '+' || tok[0] == '-') {
    neg = tok[0] == '-';
    tok.remove_prefix(1);
    if (tok.empty() || tok[0] == '+' || tok[0] == '-') return false;
  }
  char buf[64];
  if (tok.find('_') != std::string_view::npos) {
    if (tok.size() >= sizeof(buf)) return false;
    size_t m = 0;
    for (size_t i = 0; i < tok.size(); i++) {
      if (tok[i] == '_') {
        bool digit_l = i > 0 && (unsigned char)(tok[i - 1] - '0') < 10;
        bool digit_r =
            i + 1 < tok.size() && (unsigned char)(tok[i + 1] - '0') < 10;
        if (!digit_l || !digit_r) return false;
        continue;
      }
      buf[m++] = tok[i];
    }
    tok = std::string_view(buf, m);
    if (tok.empty()) return false;
  }
  float v;
  auto [p, ec] = std::from_chars(tok.data(), tok.data() + tok.size(), v);
  if (ec != std::errc() || p != tok.data() + tok.size()) return false;
  *out = neg ? -v : v;
  return true;
}

// Split tok on a single-char delimiter, calling fn(piece) for each piece.
template <typename F>
inline void for_each_split(std::string_view s, char d, F&& fn) {
  size_t start = 0;
  while (true) {
    size_t p = s.find(d, start);
    if (p == std::string_view::npos) {
      fn(s.substr(start));
      return;
    }
    fn(s.substr(start, p - start));
    start = p + 1;
  }
}

// Find the next occurrence of a (possibly multi-char) delimiter.
inline size_t find_delim(std::string_view s, std::string_view d, size_t from) {
  return s.find(d, from);
}

void parse_range(const char* buf, int64_t begin, int64_t end, int64_t line0,
                 std::string_view x_delim, char y_delim, char f_delim,
                 char nv_delim, int64_t divisor, int64_t remainder,
                 ThreadOut* out) {
  int64_t line_no = line0;
  const char* p = buf + begin;
  const char* stop = buf + end;
  while (p < stop) {
    const char* nl = (const char*)memchr(p, '\n', stop - p);
    const char* line_end = nl ? nl : stop;
    std::string_view raw(p, line_end - p);
    int64_t this_line = line_no++;
    p = nl ? nl + 1 : stop;

    if (divisor > 1 && (this_line % divisor) != remainder) continue;
    std::string_view line = trim(raw);
    if (line.empty()) continue;  // skipped, not an error (matches Python)

    // split on x_delim; need >= 3 fields, extras ignored
    size_t d1 = find_delim(line, x_delim, 0);
    if (d1 == std::string_view::npos) {
      out->n_errors++;
      continue;
    }
    size_t d2 = find_delim(line, x_delim, d1 + x_delim.size());
    if (d2 == std::string_view::npos) {
      out->n_errors++;
      continue;
    }
    std::string_view wtok = line.substr(0, d1);
    std::string_view ytok = line.substr(d1 + x_delim.size(),
                                        d2 - d1 - x_delim.size());
    size_t fstart = d2 + x_delim.size();
    size_t d3 = find_delim(line, x_delim, fstart);
    std::string_view ftok = d3 == std::string_view::npos
                                ? line.substr(fstart)
                                : line.substr(fstart, d3 - fstart);

    float weight;
    if (!parse_float(wtok, &weight)) {
      out->n_errors++;
      continue;
    }

    // labels
    size_t labels_before = out->labels.size();
    bool ok = true;
    for_each_split(ytok, y_delim, [&](std::string_view t) {
      float v;
      if (!parse_float(t, &v)) ok = false;
      else out->labels.push_back(v);
    });
    if (!ok || out->labels.size() == labels_before) {
      out->labels.resize(labels_before);
      out->n_errors++;
      continue;
    }

    // features — names STAGED until the whole line parses clean so error
    // lines claim no dict entries (matches GBDTIngest._parse staging)
    size_t feats_before = out->feat_vals.size();
    std::vector<std::pair<std::string_view, float>> staged;
    ftok = trim(ftok);
    if (!ftok.empty()) {
      for_each_split(ftok, f_delim, [&](std::string_view t) {
        if (!ok) return;
        size_t c = t.find(nv_delim);
        std::string_view name = trim(c == std::string_view::npos ? t : t.substr(0, c));
        std::string_view vtok =
            c == std::string_view::npos ? std::string_view() : t.substr(c + 1);
        float v;
        if (!parse_float(vtok, &v)) {
          ok = false;
          return;
        }
        staged.emplace_back(name, v);
      });
    }
    if (!ok) {
      out->labels.resize(labels_before);
      out->feat_vals.resize(feats_before);
      out->n_errors++;
      continue;
    }

    int32_t pos = 0;
    for (auto& [name, v] : staged) {
      auto it = out->name_map.find(name);
      uint32_t id;
      if (it == out->name_map.end()) {
        id = (uint32_t)out->names.size();
        out->name_map.emplace(name, id);
        out->names.push_back(name);
        out->first_line.push_back(this_line);
        out->first_pos.push_back(pos);
      } else {
        id = it->second;
      }
      out->feat_ids.push_back(id);
      out->feat_vals.push_back(v);
      pos++;
    }

    out->weights.push_back(weight);
    out->label_ptr.push_back((int64_t)(out->labels.size() - labels_before));
    out->row_nnz.push_back((int64_t)(out->feat_vals.size() - feats_before));
  }
}

}  // namespace

extern "C" {

ParseResult* ytk_parse(const char* buf, int64_t len, const char* x_delim_c,
                       const char* y_delim_c, const char* f_delim_c,
                       const char* nv_delim_c, int32_t n_threads,
                       int64_t divisor, int64_t remainder) {
  std::string_view x_delim(x_delim_c);
  char y_delim = y_delim_c[0];
  char f_delim = f_delim_c[0];
  char nv_delim = nv_delim_c[0];
  if (n_threads < 1) n_threads = 1;

  // chunk boundaries aligned to line starts
  std::vector<int64_t> starts{0};
  for (int t = 1; t < n_threads; t++) {
    int64_t target = len * t / n_threads;
    const char* nl = (const char*)memchr(buf + target, '\n', len - target);
    int64_t s = nl ? (nl - buf) + 1 : len;
    if (s > starts.back()) starts.push_back(s);
  }
  starts.push_back(len);
  int nchunks = (int)starts.size() - 1;

  // pass A: per-chunk line counts -> starting global line numbers
  std::vector<int64_t> chunk_lines(nchunks, 0);
  {
    std::vector<std::thread> ts;
    for (int c = 0; c < nchunks; c++) {
      ts.emplace_back([&, c] {
        int64_t cnt = 0;
        const char* p = buf + starts[c];
        const char* stop = buf + starts[c + 1];
        while (p < stop) {
          const char* nl = (const char*)memchr(p, '\n', stop - p);
          if (!nl) {
            cnt++;  // final unterminated line
            break;
          }
          cnt++;
          p = nl + 1;
        }
        chunk_lines[c] = cnt;
      });
    }
    for (auto& t : ts) t.join();
  }
  std::vector<int64_t> line0(nchunks, 0);
  for (int c = 1; c < nchunks; c++) line0[c] = line0[c - 1] + chunk_lines[c - 1];

  // pass B: parse
  std::vector<ThreadOut> outs(nchunks);
  {
    std::vector<std::thread> ts;
    for (int c = 0; c < nchunks; c++) {
      ts.emplace_back([&, c] {
        parse_range(buf, starts[c], starts[c + 1], line0[c], x_delim, y_delim,
                    f_delim, nv_delim, divisor, remainder, &outs[c]);
      });
    }
    for (auto& t : ts) t.join();
  }

  // merge: global name order by (first line, in-line position)
  auto* res = new ParseResult();
  struct NameRef {
    std::string_view name;
    int64_t line;
    int32_t pos;
  };
  std::vector<NameRef> refs;
  std::unordered_map<std::string_view, size_t> seen;
  for (auto& o : outs) {
    for (size_t i = 0; i < o.names.size(); i++) {
      auto it = seen.find(o.names[i]);
      if (it == seen.end()) {
        seen.emplace(o.names[i], refs.size());
        refs.push_back({o.names[i], o.first_line[i], o.first_pos[i]});
      } else {
        NameRef& r = refs[it->second];
        if (o.first_line[i] < r.line ||
            (o.first_line[i] == r.line && o.first_pos[i] < r.pos)) {
          r.line = o.first_line[i];
          r.pos = o.first_pos[i];
        }
      }
    }
  }
  std::vector<size_t> order(refs.size());
  for (size_t i = 0; i < order.size(); i++) order[i] = i;
  std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    if (refs[a].line != refs[b].line) return refs[a].line < refs[b].line;
    return refs[a].pos < refs[b].pos;
  });
  std::unordered_map<std::string_view, int32_t> global_id;
  res->names.reserve(order.size());
  for (size_t i = 0; i < order.size(); i++) {
    global_id.emplace(refs[order[i]].name, (int32_t)i);
    res->names.push_back(refs[order[i]].name);
    res->name_bytes += (int64_t)refs[order[i]].name.size() + 1;
  }

  // concatenate rows in chunk order, remapping local -> global name ids
  int64_t n_rows = 0, nnz = 0, nlab = 0;
  for (auto& o : outs) {
    n_rows += (int64_t)o.weights.size();
    nnz += (int64_t)o.feat_vals.size();
    nlab += (int64_t)o.labels.size();
    res->n_errors += o.n_errors;
  }
  res->weights.reserve(n_rows);
  res->row_ptr.reserve(n_rows + 1);
  res->label_ptr.reserve(n_rows + 1);
  res->feat_ids.reserve(nnz);
  res->feat_vals.reserve(nnz);
  res->labels.reserve(nlab);
  res->row_ptr.push_back(0);
  res->label_ptr.push_back(0);
  for (auto& o : outs) {
    std::vector<int32_t> remap(o.names.size());
    for (size_t i = 0; i < o.names.size(); i++)
      remap[i] = global_id.at(o.names[i]);
    res->weights.insert(res->weights.end(), o.weights.begin(), o.weights.end());
    res->labels.insert(res->labels.end(), o.labels.begin(), o.labels.end());
    for (int64_t c : o.label_ptr)
      res->label_ptr.push_back(res->label_ptr.back() + c);
    for (int64_t c : o.row_nnz) res->row_ptr.push_back(res->row_ptr.back() + c);
    for (uint32_t id : o.feat_ids) res->feat_ids.push_back(remap[id]);
    res->feat_vals.insert(res->feat_vals.end(), o.feat_vals.begin(),
                          o.feat_vals.end());
    // free per-thread storage as we go
    o = ThreadOut();
  }
  return res;
}

int64_t ytk_n_rows(ParseResult* r) { return (int64_t)r->weights.size(); }
int64_t ytk_nnz(ParseResult* r) { return (int64_t)r->feat_vals.size(); }
int64_t ytk_n_label_vals(ParseResult* r) { return (int64_t)r->labels.size(); }
int64_t ytk_n_names(ParseResult* r) { return (int64_t)r->names.size(); }
int64_t ytk_name_bytes(ParseResult* r) { return r->name_bytes; }
int64_t ytk_n_errors(ParseResult* r) { return r->n_errors; }

void ytk_fill(ParseResult* r, float* weights, int64_t* label_ptr, float* labels,
              int64_t* row_ptr, int32_t* feat_ids, float* feat_vals,
              char* name_buf) {
  memcpy(weights, r->weights.data(), r->weights.size() * sizeof(float));
  memcpy(label_ptr, r->label_ptr.data(), r->label_ptr.size() * sizeof(int64_t));
  memcpy(labels, r->labels.data(), r->labels.size() * sizeof(float));
  memcpy(row_ptr, r->row_ptr.data(), r->row_ptr.size() * sizeof(int64_t));
  memcpy(feat_ids, r->feat_ids.data(), r->feat_ids.size() * sizeof(int32_t));
  memcpy(feat_vals, r->feat_vals.data(), r->feat_vals.size() * sizeof(float));
  char* nb = name_buf;
  for (auto& n : r->names) {
    memcpy(nb, n.data(), n.size());
    nb += n.size();
    *nb++ = '\n';
  }
}

void ytk_free(ParseResult* r) { delete r; }

}  // extern "C"
