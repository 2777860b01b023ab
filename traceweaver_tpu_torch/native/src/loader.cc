// Jaeger-JSON corpus loader: parses trace files (in parallel across a
// thread pool) into an interned, struct-of-arrays span corpus that the
// Python side turns into Span objects without a Python JSON parser.
//
// The port's copy of the JAX package's native/src/loader.cc (its
// tw_parse_files, tw_root_start_time and accessors), with one change: a
// malformed trace or span record does not fail the whole parse. It is
// kept in the corpus with a flag (tw_trace_malformed, tw_span_malformed),
// so the Python side skips and counts it, or raises under --strict,
// exactly where the pure-Python front end does. A trace object is
// malformed without a string traceID or a spans array; a span record is
// malformed when it is not an object, lacks a string spanID, traceID or
// processID, a numeric startTime or duration, or carries references that
// are not an array of objects with string traceID and spanID.
//
// Field extraction follows the Python front end:
//   - span.kind from the tags array (verbatim value, last tag wins);
//   - operationName with Alibaba's requestType taking precedence;
//   - the full references list (parent edges);
//   - caller/callee (Alibaba converter fields) when present;
//   - the top-level processes table (pid -> serviceName).
// Dataset repair and Alibaba client/server rewrites stay in Python so that
// all RNG-dependent semantics live in one place.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "json.hpp"

namespace tw {

struct Corpus {
  // Interned strings; index 0 is always "" so 0 can double as "empty".
  std::vector<std::string> strings;
  std::unordered_map<std::string, int32_t> intern_map;

  // Span SoA (parallel arrays).
  std::vector<double> start_mus, duration_mus;
  std::vector<int32_t> trace_sidx, sid_sidx, op_sidx, process_sidx;
  std::vector<int32_t> kind_sidx;  // verbatim span.kind tag value, -1 absent
  std::vector<int32_t> caller_sidx, callee_sidx;  // -1 = absent
  std::vector<int32_t> span_malformed;  // 1: skip and count this record
  // References, flattened (a span may carry several): refs of span i are
  // [ref_offsets[i], ref_offsets[i+1]) in ref_trace/ref_sid.
  std::vector<int64_t> ref_offsets{0};
  std::vector<int32_t> ref_trace_sidx, ref_sid_sidx;

  // Trace boundaries: spans of trace t are [offsets[t], offsets[t+1]).
  std::vector<int64_t> trace_offsets{0};
  std::vector<int32_t> trace_id_sidx;
  std::vector<int32_t> trace_file;  // input-path index
  std::vector<int32_t> trace_malformed;  // 1: no traceID or spans array

  // Flattened per-trace process tables (trace index, pid, service).
  std::vector<int32_t> proc_trace, proc_pid, proc_service;

  int32_t intern(const std::string& s) {
    auto it = intern_map.find(s);
    if (it != intern_map.end()) return it->second;
    int32_t idx = static_cast<int32_t>(strings.size());
    strings.push_back(s);
    intern_map.emplace(strings.back(), idx);
    return idx;
  }
};

namespace {

thread_local std::string g_last_error;

bool read_file(const char* path, std::string* out) {
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) {
    std::fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

// Verbatim span.kind tag value, last occurrence winning — matching the
// Python front-end's tag loop exactly. Returns nullptr when absent.
const std::string* span_kind_of(const Json& span) {
  const Json* tags = span.find("tags");
  if (!tags || !tags->is_arr()) return nullptr;
  const std::string* kind = nullptr;
  for (const Json& tag : tags->arr) {
    const std::string* key = tag.find_str("key");
    if (key && *key == "span.kind") {
      const std::string* value = tag.find_str("value");
      kind = value;  // may be nullptr for a non-string value, like Python's
                     // tag.get("value") -> None
    }
  }
  return kind;
}

// A span's references as interned (trace, span) pairs; false when the
// list is present but malformed (the Python front end's KeyError or
// TypeError on ref["traceID"] / ref["spanID"]).
bool span_refs(const Json& s, Corpus* c, std::vector<int32_t>* out) {
  const Json* refs = s.find("references");
  if (!refs) return true;
  if (!refs->is_arr()) return false;
  for (const Json& ref : refs->arr) {
    const std::string* ref_trace = ref.find_str("traceID");
    const std::string* ref_sid = ref.find_str("spanID");
    if (!ref_trace || !ref_sid) return false;
    out->push_back(c->intern(*ref_trace));
    out->push_back(c->intern(*ref_sid));
  }
  return true;
}

void push_malformed_span(Corpus* c) {
  c->start_mus.push_back(0.0);
  c->duration_mus.push_back(0.0);
  for (auto* v : {&c->trace_sidx, &c->sid_sidx, &c->op_sidx, &c->process_sidx,
                  &c->kind_sidx, &c->caller_sidx, &c->callee_sidx})
    v->push_back(-1);
  c->span_malformed.push_back(1);
  c->ref_offsets.push_back(static_cast<int64_t>(c->ref_trace_sidx.size()));
}

// Extract one trace object ({traceID, spans, processes}) into the corpus.
void extract_trace(const Json& trace, int file_idx, Corpus* c) {
  const std::string* trace_id = trace.find_str("traceID");
  const Json* spans = trace.find("spans");
  int32_t tidx = static_cast<int32_t>(c->trace_id_sidx.size());
  c->trace_file.push_back(file_idx);
  if (!trace_id || !spans || !spans->is_arr()) {
    c->trace_id_sidx.push_back(-1);
    c->trace_malformed.push_back(1);
    c->trace_offsets.push_back(static_cast<int64_t>(c->start_mus.size()));
    return;
  }
  c->trace_id_sidx.push_back(c->intern(*trace_id));
  c->trace_malformed.push_back(0);

  std::vector<int32_t> refs;
  for (const Json& s : spans->arr) {
    const std::string* sid = s.find_str("spanID");
    const std::string* span_trace = s.find_str("traceID");
    const std::string* pid = s.find_str("processID");
    bool ok_start = false, ok_dur = false;
    double start = s.find_num("startTime", &ok_start);
    double dur = s.find_num("duration", &ok_dur);
    refs.clear();
    if (!s.is_obj() || !sid || !span_trace || !pid || !ok_start || !ok_dur ||
        !span_refs(s, c, &refs)) {
      push_malformed_span(c);
      continue;
    }
    // Alibaba-converted files carry requestType; it wins over operationName.
    const std::string* op = s.find_str("requestType");
    if (!op) op = s.find_str("operationName");

    for (size_t r = 0; r < refs.size(); r += 2) {
      c->ref_trace_sidx.push_back(refs[r]);
      c->ref_sid_sidx.push_back(refs[r + 1]);
    }
    c->ref_offsets.push_back(static_cast<int64_t>(c->ref_trace_sidx.size()));

    const std::string* caller = s.find_str("caller");
    const std::string* callee = s.find_str("callee");
    const std::string* kind = span_kind_of(s);

    c->start_mus.push_back(start);
    c->duration_mus.push_back(dur);
    c->trace_sidx.push_back(c->intern(*span_trace));
    c->sid_sidx.push_back(c->intern(*sid));
    c->op_sidx.push_back(op ? c->intern(*op) : -1);
    c->process_sidx.push_back(c->intern(*pid));
    c->kind_sidx.push_back(kind ? c->intern(*kind) : -1);
    c->caller_sidx.push_back(caller ? c->intern(*caller) : -1);
    c->callee_sidx.push_back(callee ? c->intern(*callee) : -1);
    c->span_malformed.push_back(0);
  }
  c->trace_offsets.push_back(static_cast<int64_t>(c->start_mus.size()));

  const Json* procs = trace.find("processes");
  if (procs && procs->is_obj()) {
    for (size_t i = 0; i < procs->keys.size(); ++i) {
      const std::string* svc = procs->vals[i].find_str("serviceName");
      if (!svc) continue;
      c->proc_trace.push_back(tidx);
      c->proc_pid.push_back(c->intern(procs->keys[i]));
      c->proc_service.push_back(c->intern(*svc));
    }
  }
}

}  // namespace
}  // namespace tw

extern "C" {

const char* tw_last_error() { return tw::g_last_error.c_str(); }

// Parse `n` Jaeger-JSON files into one corpus. JSON decoding runs across a
// thread pool; extraction/interning is a serial second phase so string ids
// are globally consistent. Returns nullptr (see tw_last_error) when a file
// cannot be read, is not JSON, or has no data[] array.
tw::Corpus* tw_parse_files(const char* const* paths, long n) {
  std::vector<tw::Json> docs(static_cast<size_t>(n));
  std::vector<std::string> errors(static_cast<size_t>(n));
  std::atomic<long> next{0};

  unsigned hw = std::thread::hardware_concurrency();
  unsigned n_threads = hw ? hw : 4;
  if (static_cast<long>(n_threads) > n) n_threads = static_cast<unsigned>(n);

  auto worker = [&]() {
    std::string buf;
    for (long i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      if (!tw::read_file(paths[i], &buf)) {
        errors[i] = std::string("cannot read ") + paths[i];
        continue;
      }
      tw::JsonParser parser(buf.data(), buf.size());
      if (!parser.parse(&docs[i]))
        errors[i] = std::string(paths[i]) + ": " + parser.error();
    }
  };
  std::vector<std::thread> pool;
  for (unsigned t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();

  for (long i = 0; i < n; ++i) {
    if (!errors[i].empty()) {
      tw::g_last_error = errors[i];
      return nullptr;
    }
  }

  auto* corpus = new tw::Corpus();
  corpus->intern("");
  for (long i = 0; i < n; ++i) {
    const tw::Json* data = docs[i].find("data");
    if (!data || !data->is_arr()) {
      tw::g_last_error = std::string(paths[i]) + ": no data[] array";
      delete corpus;
      return nullptr;
    }
    for (const tw::Json& trace : data->arr)
      tw::extract_trace(trace, static_cast<int>(i), corpus);
    docs[i] = tw::Json();  // free the DOM as we go
  }
  return corpus;
}

void tw_corpus_free(tw::Corpus* c) { delete c; }

long tw_num_spans(const tw::Corpus* c) {
  return static_cast<long>(c->start_mus.size());
}
long tw_num_traces(const tw::Corpus* c) {
  return static_cast<long>(c->trace_id_sidx.size());
}
long tw_num_strings(const tw::Corpus* c) {
  return static_cast<long>(c->strings.size());
}
const char* tw_string(const tw::Corpus* c, long i) {
  return c->strings[static_cast<size_t>(i)].c_str();
}

const double* tw_span_start(const tw::Corpus* c) { return c->start_mus.data(); }
const double* tw_span_duration(const tw::Corpus* c) {
  return c->duration_mus.data();
}
const int32_t* tw_span_trace(const tw::Corpus* c) {
  return c->trace_sidx.data();
}
const int32_t* tw_span_sid(const tw::Corpus* c) { return c->sid_sidx.data(); }
const int32_t* tw_span_op(const tw::Corpus* c) { return c->op_sidx.data(); }
const int32_t* tw_span_process(const tw::Corpus* c) {
  return c->process_sidx.data();
}
const int32_t* tw_span_kind(const tw::Corpus* c) {
  return c->kind_sidx.data();
}
const int32_t* tw_span_malformed(const tw::Corpus* c) {
  return c->span_malformed.data();
}
long tw_num_refs(const tw::Corpus* c) {
  return static_cast<long>(c->ref_trace_sidx.size());
}
const int64_t* tw_span_ref_offsets(const tw::Corpus* c) {
  return c->ref_offsets.data();
}
const int32_t* tw_ref_trace(const tw::Corpus* c) {
  return c->ref_trace_sidx.data();
}
const int32_t* tw_ref_sid(const tw::Corpus* c) {
  return c->ref_sid_sidx.data();
}
const int32_t* tw_span_caller(const tw::Corpus* c) {
  return c->caller_sidx.data();
}
const int32_t* tw_span_callee(const tw::Corpus* c) {
  return c->callee_sidx.data();
}

const int64_t* tw_trace_span_offsets(const tw::Corpus* c) {
  return c->trace_offsets.data();
}
const int32_t* tw_trace_id(const tw::Corpus* c) {
  return c->trace_id_sidx.data();
}
const int32_t* tw_trace_file(const tw::Corpus* c) {
  return c->trace_file.data();
}
const int32_t* tw_trace_malformed(const tw::Corpus* c) {
  return c->trace_malformed.data();
}

long tw_num_process_entries(const tw::Corpus* c) {
  return static_cast<long>(c->proc_trace.size());
}
const int32_t* tw_process_trace(const tw::Corpus* c) {
  return c->proc_trace.data();
}
const int32_t* tw_process_pid(const tw::Corpus* c) {
  return c->proc_pid.data();
}
const int32_t* tw_process_service(const tw::Corpus* c) {
  return c->proc_service.data();
}

// Root-span start time of the first trace in a file — the sort key for
// time-ordered directory listing. Returns +inf when the file cannot be
// read or parsed or has no rooted span (as the Python front end does).
double tw_root_start_time(const char* path) {
  std::string buf;
  if (!tw::read_file(path, &buf)) return HUGE_VAL;
  tw::Json doc;
  tw::JsonParser parser(buf.data(), buf.size());
  if (!parser.parse(&doc)) return HUGE_VAL;
  const tw::Json* data = doc.find("data");
  if (!data || !data->is_arr() || data->arr.empty()) return HUGE_VAL;
  const tw::Json* spans = data->arr[0].find("spans");
  if (!spans || !spans->is_arr()) return HUGE_VAL;
  for (const tw::Json& s : spans->arr) {
    const tw::Json* refs = s.find("references");
    if (!refs || !refs->is_arr() || refs->arr.empty()) {
      bool ok = false;
      double t = s.find_num("startTime", &ok);
      if (ok) return t;
    }
  }
  return HUGE_VAL;
}

}  // extern "C"
