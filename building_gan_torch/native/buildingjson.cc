// Native building-JSON parser for the preprocessing hot path.
//
// The reference preprocessor spends its time in Python json.load + per-node
// Python loops (39.3 buildings/s for the 10k dataset,
// building_gan/notebooks/data-preprocessing.ipynb).  This library parses the
// three building JSON files (global / local / voxel schema, see
// building_gan_torch/data/synthetic.py for the schema) with a small
// single-pass recursive-descent parser and re-emits compact canonical JSON
// that Python can load ~an order of magnitude faster (no whitespace; numbers
// copied as written, so json.loads reads the same values as from the file).  Exposed via ctypes (building_gan_torch/native/parser.py).
//
// No external dependencies; C++17.  Built at first use by
// building_gan_torch/ops/_build.py::build_host (g++ -O2 -std=c++17 -fPIC -shared).

#include <cctype>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <sstream>
#include <string>

namespace {

struct Parser {
  const char* p;
  const char* end;
  std::string out;
  bool ok = true;

  explicit Parser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {
    out.reserve(s.size());
  }

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p;
  }

  bool value() {
    ws();
    if (p >= end) return fail();
    switch (*p) {
      case '{': return object();
      case '[': return array();
      case '"': return string_();
      case 't': return lit("true");
      case 'f': return lit("false");
      case 'n': return lit("null");
      default: return number();
    }
  }

  bool fail() {
    ok = false;
    return false;
  }

  bool lit(const char* s) {
    size_t n = std::strlen(s);
    if (p + n > end || std::strncmp(p, s, n) != 0) return fail();
    out.append(s, n);
    p += n;
    return true;
  }

  bool object() {
    out.push_back('{');
    ++p;  // '{'
    ws();
    if (p < end && *p == '}') {
      ++p;
      out.push_back('}');
      return true;
    }
    while (p < end) {
      ws();
      if (!string_()) return false;
      ws();
      if (p >= end || *p != ':') return fail();
      ++p;
      out.push_back(':');
      if (!value()) return false;
      ws();
      if (p < end && *p == ',') {
        ++p;
        out.push_back(',');
        continue;
      }
      if (p < end && *p == '}') {
        ++p;
        out.push_back('}');
        return true;
      }
      return fail();
    }
    return fail();
  }

  bool array() {
    out.push_back('[');
    ++p;  // '['
    ws();
    if (p < end && *p == ']') {
      ++p;
      out.push_back(']');
      return true;
    }
    while (p < end) {
      if (!value()) return false;
      ws();
      if (p < end && *p == ',') {
        ++p;
        out.push_back(',');
        continue;
      }
      if (p < end && *p == ']') {
        ++p;
        out.push_back(']');
        return true;
      }
      return fail();
    }
    return fail();
  }

  bool string_() {
    if (p >= end || *p != '"') return fail();
    const char* start = p;
    ++p;
    while (p < end) {
      if (*p == '\\') {
        p += 2;
        continue;
      }
      if (*p == '"') {
        ++p;
        out.append(start, p - start);
        return true;
      }
      ++p;
    }
    return fail();
  }

  bool number() {
    const char* start = p;
    if (p < end && (*p == '-' || *p == '+')) ++p;
    while (p < end && (std::isdigit((unsigned char)*p) || *p == '.' || *p == 'e' ||
                       *p == 'E' || *p == '-' || *p == '+'))
      ++p;
    if (p == start) return fail();
    out.append(start, p - start);
    return true;
  }
};

thread_local std::string g_result;

}  // namespace

extern "C" {

// Parse + canonicalize one JSON file.  Returns a pointer to a thread-local
// buffer valid until the next call on this thread; NULL on failure.
const char* bj_parse_file(const char* path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) return nullptr;
  std::ostringstream ss;
  ss << f.rdbuf();
  std::string data = ss.str();

  Parser parser(data);
  if (!parser.value() || !parser.ok) return nullptr;
  g_result = std::move(parser.out);
  return g_result.c_str();
}

// Kept for ABI symmetry; the buffer is thread-local, nothing to free.
void bj_free(const char*) {}

}  // extern "C"
