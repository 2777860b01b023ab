// Minimal recursive-descent JSON parser (DOM), self-contained: the card's
// machine ships no JSON library. Sufficient for Jaeger trace files:
// objects, arrays, strings (with escapes incl. \uXXXX surrogate pairs),
// numbers as double (microsecond epoch timestamps are < 2^53, so exact),
// true/false/null.
//
// The port's own copy of the JAX package's native/src/json.hpp.
#pragma once

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace tw {

struct Json {
  enum class Type { Null, Bool, Num, Str, Arr, Obj };
  Type type = Type::Null;
  bool boolean = false;
  double num = 0.0;
  std::string str;
  std::vector<Json> arr;          // Type::Arr elements
  std::vector<std::string> keys;  // Type::Obj keys, parallel to vals
  std::vector<Json> vals;         // Type::Obj values

  bool is_obj() const { return type == Type::Obj; }
  bool is_arr() const { return type == Type::Arr; }
  bool is_str() const { return type == Type::Str; }
  bool is_num() const { return type == Type::Num; }

  const Json* find(const char* key) const {
    if (type != Type::Obj) return nullptr;
    for (size_t i = 0; i < keys.size(); ++i)
      if (keys[i] == key) return &vals[i];
    return nullptr;
  }
  // Convenience: string field or fallback.
  const std::string* find_str(const char* key) const {
    const Json* v = find(key);
    return (v && v->is_str()) ? &v->str : nullptr;
  }
  // Convenience: numeric field; ok=false if absent / not a number.
  double find_num(const char* key, bool* ok) const {
    const Json* v = find(key);
    if (v && v->is_num()) {
      if (ok) *ok = true;
      return v->num;
    }
    if (ok) *ok = false;
    return 0.0;
  }
};

class JsonParser {
 public:
  JsonParser(const char* data, size_t len) : p_(data), end_(data + len) {}

  // Parses one JSON document. Returns false (with error()) on malformed
  // input; trailing whitespace is allowed, trailing garbage is not.
  bool parse(Json* out) {
    skip_ws();
    if (!parse_value(out)) return false;
    skip_ws();
    if (p_ != end_) return fail("trailing characters after document");
    return true;
  }

  const std::string& error() const { return error_; }

 private:
  const char* p_;
  const char* end_;
  std::string error_;

  bool fail(const char* msg) {
    if (error_.empty()) error_ = msg;
    return false;
  }

  void skip_ws() {
    while (p_ != end_ &&
           (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' || *p_ == '\r'))
      ++p_;
  }

  bool parse_value(Json* out) {
    if (p_ == end_) return fail("unexpected end of input");
    switch (*p_) {
      case '{': return parse_object(out);
      case '[': return parse_array(out);
      case '"':
        out->type = Json::Type::Str;
        return parse_string(&out->str);
      case 't':
        if (end_ - p_ >= 4 && std::memcmp(p_, "true", 4) == 0) {
          p_ += 4;
          out->type = Json::Type::Bool;
          out->boolean = true;
          return true;
        }
        return fail("bad literal");
      case 'f':
        if (end_ - p_ >= 5 && std::memcmp(p_, "false", 5) == 0) {
          p_ += 5;
          out->type = Json::Type::Bool;
          out->boolean = false;
          return true;
        }
        return fail("bad literal");
      case 'n':
        if (end_ - p_ >= 4 && std::memcmp(p_, "null", 4) == 0) {
          p_ += 4;
          out->type = Json::Type::Null;
          return true;
        }
        return fail("bad literal");
      default: return parse_number(out);
    }
  }

  bool parse_object(Json* out) {
    out->type = Json::Type::Obj;
    ++p_;  // '{'
    skip_ws();
    if (p_ != end_ && *p_ == '}') {
      ++p_;
      return true;
    }
    while (true) {
      skip_ws();
      if (p_ == end_ || *p_ != '"') return fail("expected object key");
      std::string key;
      if (!parse_string(&key)) return false;
      skip_ws();
      if (p_ == end_ || *p_ != ':') return fail("expected ':'");
      ++p_;
      skip_ws();
      out->keys.push_back(std::move(key));
      out->vals.emplace_back();
      if (!parse_value(&out->vals.back())) return false;
      skip_ws();
      if (p_ == end_) return fail("unterminated object");
      if (*p_ == ',') {
        ++p_;
        continue;
      }
      if (*p_ == '}') {
        ++p_;
        return true;
      }
      return fail("expected ',' or '}'");
    }
  }

  bool parse_array(Json* out) {
    out->type = Json::Type::Arr;
    ++p_;  // '['
    skip_ws();
    if (p_ != end_ && *p_ == ']') {
      ++p_;
      return true;
    }
    while (true) {
      skip_ws();
      out->arr.emplace_back();
      if (!parse_value(&out->arr.back())) return false;
      skip_ws();
      if (p_ == end_) return fail("unterminated array");
      if (*p_ == ',') {
        ++p_;
        continue;
      }
      if (*p_ == ']') {
        ++p_;
        return true;
      }
      return fail("expected ',' or ']'");
    }
  }

  bool parse_number(Json* out) {
    char* num_end = nullptr;
    double v = std::strtod(p_, &num_end);
    if (num_end == p_) return fail("bad number");
    p_ = num_end;
    out->type = Json::Type::Num;
    out->num = v;
    return true;
  }

  static void append_utf8(std::string* s, unsigned cp) {
    if (cp < 0x80) {
      s->push_back(static_cast<char>(cp));
    } else if (cp < 0x800) {
      s->push_back(static_cast<char>(0xC0 | (cp >> 6)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
      s->push_back(static_cast<char>(0xE0 | (cp >> 12)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    } else {
      s->push_back(static_cast<char>(0xF0 | (cp >> 18)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
      s->push_back(static_cast<char>(0x80 | (cp & 0x3F)));
    }
  }

  bool parse_hex4(unsigned* out) {
    if (end_ - p_ < 4) return fail("bad \\u escape");
    unsigned v = 0;
    for (int i = 0; i < 4; ++i) {
      char c = p_[i];
      v <<= 4;
      if (c >= '0' && c <= '9') v |= static_cast<unsigned>(c - '0');
      else if (c >= 'a' && c <= 'f') v |= static_cast<unsigned>(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') v |= static_cast<unsigned>(c - 'A' + 10);
      else return fail("bad \\u escape");
    }
    p_ += 4;
    *out = v;
    return true;
  }

  bool parse_string(std::string* out) {
    ++p_;  // opening quote
    out->clear();
    // Fast path: scan for a segment free of escapes.
    while (true) {
      const char* seg = p_;
      while (p_ != end_ && *p_ != '"' && *p_ != '\\') ++p_;
      out->append(seg, static_cast<size_t>(p_ - seg));
      if (p_ == end_) return fail("unterminated string");
      if (*p_ == '"') {
        ++p_;
        return true;
      }
      ++p_;  // backslash
      if (p_ == end_) return fail("unterminated escape");
      char c = *p_++;
      switch (c) {
        case '"': out->push_back('"'); break;
        case '\\': out->push_back('\\'); break;
        case '/': out->push_back('/'); break;
        case 'b': out->push_back('\b'); break;
        case 'f': out->push_back('\f'); break;
        case 'n': out->push_back('\n'); break;
        case 'r': out->push_back('\r'); break;
        case 't': out->push_back('\t'); break;
        case 'u': {
          unsigned cp;
          if (!parse_hex4(&cp)) return false;
          if (cp >= 0xD800 && cp <= 0xDBFF && end_ - p_ >= 6 &&
              p_[0] == '\\' && p_[1] == 'u') {
            p_ += 2;
            unsigned lo;
            if (!parse_hex4(&lo)) return false;
            if (lo >= 0xDC00 && lo <= 0xDFFF)
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            else
              return fail("bad surrogate pair");
          }
          append_utf8(out, cp);
          break;
        }
        default: return fail("bad escape character");
      }
    }
  }
};

}  // namespace tw
