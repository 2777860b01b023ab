// Native reconstruction schemes over packed span arrays.
//
// The reference ships a C++ plugin skeleton — an abstract
// `Scheme::FindAssignments()` and an empty `Fcfs` subclass
// (reference: src/trace_reconstructor/ports/cpp/scheme.h:4-11,
// fcfs.h:6-13, fcfs.cpp — all `//!TODO`). This file is the real thing:
// the same plugin shape, implemented over struct-of-arrays inputs so the
// Python layer can hand a whole service partition across the FFI in one
// call. Assignment semantics mirror the Python baselines exactly
// (reference: ports/python/algorithms/{fcfs.py:1-26, vpath.py:36-89,
// vpath_old.py:1-31}); equivalence is asserted in tests/test_native.py.

#include <algorithm>
#include <cstdint>
#include <unordered_map>
#include <vector>

namespace tw {

// One service's assignment problem: a single incoming partition plus all
// outgoing spans tagged with their endpoint index. Times are microseconds;
// trace ids are interned ints (any consistent numbering works).
struct ServiceProblem {
  const double* in_start;
  const double* in_end;
  const int32_t* in_trace;
  long n_in;
  const double* out_start;
  const double* out_end;
  const int32_t* out_ep;
  const int32_t* out_trace;
  long n_out;
  long n_eps;
};

// Plugin contract, native edition: fill assign[ep * n_in + i] with the
// outgoing-span index matched to incoming span i on endpoint ep, -1 = NA.
class Scheme {
 public:
  virtual ~Scheme() = default;
  virtual void FindAssignments(const ServiceProblem& p, int32_t* assign) = 0;
};

// First-come-first-served: the i-th incoming span takes the i-th outgoing
// span of every endpoint, both sides in start-time order.
class Fcfs : public Scheme {
 public:
  void FindAssignments(const ServiceProblem& p, int32_t* assign) override {
    std::fill(assign, assign + p.n_eps * p.n_in, -1);
    // Per-endpoint arrival order of outgoing spans.
    std::vector<long> count(static_cast<size_t>(p.n_eps), 0);
    std::vector<long> order(static_cast<size_t>(p.n_out));
    for (long j = 0; j < p.n_out; ++j) order[j] = j;
    std::stable_sort(order.begin(), order.end(), [&](long a, long b) {
      return p.out_start[a] < p.out_start[b];
    });
    for (long j : order) {
      long ep = p.out_ep[j];
      long i = count[ep]++;
      if (i < p.n_in) assign[ep * p.n_in + i] = static_cast<int32_t>(j);
    }
  }
};

// vPath single time-ordered event sweep: a server request makes its span
// the latest in-flight incoming span, a server response clears it, a client
// request attaches to it, and a client response restores the in-flight span
// to the incoming span of the same trace (thread-serialized processing).
class VPathSweep : public Scheme {
  struct Event {
    double t;
    int sort_key;   // 1 in-req, 2 out-req, 3 out-resp, 4 in-resp
    bool is_server;
    bool is_request;
    long idx;       // span index on its own side
  };

 public:
  void FindAssignments(const ServiceProblem& p, int32_t* assign) override {
    std::fill(assign, assign + p.n_eps * p.n_in, -1);
    std::vector<Event> events;
    events.reserve(static_cast<size_t>(2 * (p.n_in + p.n_out)));
    for (long i = 0; i < p.n_in; ++i) {
      events.push_back({p.in_start[i], 1, true, true, i});
      events.push_back({p.in_end[i], 4, true, false, i});
    }
    for (long j = 0; j < p.n_out; ++j) {
      events.push_back({p.out_start[j], 2, false, true, j});
      events.push_back({p.out_end[j], 3, false, false, j});
    }
    // Stable sort on (time, sort_key) keeps insertion order for full ties,
    // matching Python's list.sort over the same construction order.
    std::stable_sort(events.begin(), events.end(),
                     [](const Event& a, const Event& b) {
                       if (a.t != b.t) return a.t < b.t;
                       return a.sort_key < b.sort_key;
                     });

    // trace id -> first incoming span with that trace (partition order).
    std::unordered_map<int32_t, long> in_by_trace;
    for (long i = 0; i < p.n_in; ++i)
      in_by_trace.emplace(p.in_trace[i], i);

    long latest_incoming = -1;
    for (const Event& e : events) {
      if (e.is_server) {
        latest_incoming = e.is_request ? e.idx : -1;
      } else if (e.is_request) {
        if (latest_incoming >= 0) {
          long ep = p.out_ep[e.idx];
          assign[ep * p.n_in + latest_incoming] = static_cast<int32_t>(e.idx);
        }
      } else {
        auto it = in_by_trace.find(p.out_trace[e.idx]);
        if (it != in_by_trace.end()) latest_incoming = it->second;
      }
    }
  }
};

// vPathOld per-endpoint pointer sweep: each incoming span claims the next
// outgoing span starting after it but before the next incoming span starts.
class VPathOldSweep : public Scheme {
 public:
  void FindAssignments(const ServiceProblem& p, int32_t* assign) override {
    std::fill(assign, assign + p.n_eps * p.n_in, -1);
    // Per-endpoint outgoing spans in start order.
    std::vector<std::vector<long>> by_ep(static_cast<size_t>(p.n_eps));
    std::vector<long> order(static_cast<size_t>(p.n_out));
    for (long j = 0; j < p.n_out; ++j) order[j] = j;
    std::stable_sort(order.begin(), order.end(), [&](long a, long b) {
      return p.out_start[a] < p.out_start[b];
    });
    for (long j : order) by_ep[p.out_ep[j]].push_back(j);

    for (long ep = 0; ep < p.n_eps; ++ep) {
      const std::vector<long>& outs = by_ep[ep];
      size_t j = 0;
      for (long i = 0; i < p.n_in; ++i) {
        while (j < outs.size() && p.out_start[outs[j]] < p.in_start[i]) ++j;
        if (j >= outs.size()) break;
        bool is_last = i == p.n_in - 1;
        if (p.out_start[outs[j]] >= p.in_start[i] &&
            (is_last || p.out_start[outs[j]] < p.in_start[i + 1])) {
          assign[ep * p.n_in + i] = static_cast<int32_t>(outs[j]);
          ++j;
        }
      }
    }
  }
};

}  // namespace tw

extern "C" {

static void run_scheme(tw::Scheme&& scheme, const double* in_start,
                       const double* in_end, const int32_t* in_trace,
                       long n_in, const double* out_start,
                       const double* out_end, const int32_t* out_ep,
                       const int32_t* out_trace, long n_out, long n_eps,
                       int32_t* assign) {
  tw::ServiceProblem p{in_start, in_end, in_trace, n_in,
                       out_start, out_end, out_ep, out_trace, n_out, n_eps};
  scheme.FindAssignments(p, assign);
}

void tw_fcfs_assign(const double* in_start, const double* in_end,
                    const int32_t* in_trace, long n_in,
                    const double* out_start, const double* out_end,
                    const int32_t* out_ep, const int32_t* out_trace,
                    long n_out, long n_eps, int32_t* assign) {
  run_scheme(tw::Fcfs(), in_start, in_end, in_trace, n_in, out_start, out_end,
             out_ep, out_trace, n_out, n_eps, assign);
}

void tw_vpath_assign(const double* in_start, const double* in_end,
                     const int32_t* in_trace, long n_in,
                     const double* out_start, const double* out_end,
                     const int32_t* out_ep, const int32_t* out_trace,
                     long n_out, long n_eps, int32_t* assign) {
  run_scheme(tw::VPathSweep(), in_start, in_end, in_trace, n_in, out_start,
             out_end, out_ep, out_trace, n_out, n_eps, assign);
}

void tw_vpath_old_assign(const double* in_start, const double* in_end,
                         const int32_t* in_trace, long n_in,
                         const double* out_start, const double* out_end,
                         const int32_t* out_ep, const int32_t* out_trace,
                         long n_out, long n_eps, int32_t* assign) {
  run_scheme(tw::VPathOldSweep(), in_start, in_end, in_trace, n_in, out_start,
             out_end, out_ep, out_trace, n_out, n_eps, assign);
}

}  // extern "C"
