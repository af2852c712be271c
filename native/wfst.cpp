// Native WFST build-time core: compose / determinize / rmepsilon / connect
// over the tropical semiring.
//
// Framework layering: the composed graph is frozen to packed
// int32 arc tensors and decoded on-device (dsr/asr/fsm/packed.py,
// asr/decoder/); graph CONSTRUCTION is host-side and irregular — exactly
// where the reference used raw C++ (asr/fsm/fsm.{h,cc} [K], tree
// unavailable, SURVEY.md §0).  Semantics mirror dsr/asr/fsm/wfst.py,
// the tested golden oracle; dsr/asr/fsm/native.py binds via ctypes and
// falls back to the Python implementation when this library is absent.
//
// Build: make -C native  (adds this TU to libdsrnative.so)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <map>
#include <queue>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kEps = 0;
constexpr double kInf = std::numeric_limits<double>::infinity();

struct Fst {
  int ns = 0;
  int start = -1;
  std::vector<int64_t> off;  // ns+1 arc offsets (CSR by source state)
  std::vector<int> il, ol, nxt;
  std::vector<float> w;
  std::vector<float> fin;  // dense, +inf = non-final

  int64_t na() const { return static_cast<int64_t>(il.size()); }
  bool is_final(int s) const { return fin[s] < kInf; }
};

// compose/determinize both emit all arcs of a state before moving on, so we
// track explicit per-arc sources to build CSR at the end (zero-arc states
// and interleaving-safe).
struct FlatBuilder {
  int start = -1;
  int ns = 0;
  std::vector<int> src, il, ol, nxt;
  std::vector<float> w;
  std::vector<float> fin;

  int add_state() {
    ++ns;
    fin.push_back(std::numeric_limits<float>::infinity());
    return ns - 1;
  }
  void add_arc(int s, int i, int o, float wt, int d) {
    src.push_back(s);
    il.push_back(i);
    ol.push_back(o);
    w.push_back(wt);
    nxt.push_back(d);
  }
  Fst finish() const {
    Fst f;
    f.ns = ns;
    f.start = start;
    f.fin = fin;
    const int64_t na = static_cast<int64_t>(src.size());
    f.off.assign(ns + 1, 0);
    for (int64_t a = 0; a < na; ++a) f.off[src[a] + 1]++;
    for (int s = 0; s < ns; ++s) f.off[s + 1] += f.off[s];
    f.il.resize(na);
    f.ol.resize(na);
    f.w.resize(na);
    f.nxt.resize(na);
    std::vector<int64_t> pos(f.off.begin(), f.off.end() - 1);
    for (int64_t a = 0; a < na; ++a) {
      int64_t p = pos[src[a]]++;
      f.il[p] = il[a];
      f.ol[p] = ol[a];
      f.w[p] = w[a];
      f.nxt[p] = nxt[a];
    }
    return f;
  }
};

// ------------------------------------------------------------------ connect
Fst connect(const Fst& f) {
  Fst out;
  if (f.start < 0) return out;
  std::vector<char> fwd(f.ns, 0);
  std::deque<int> dq{f.start};
  fwd[f.start] = 1;
  while (!dq.empty()) {
    int s = dq.front();
    dq.pop_front();
    for (int64_t a = f.off[s]; a < f.off[s + 1]; ++a)
      if (!fwd[f.nxt[a]]) {
        fwd[f.nxt[a]] = 1;
        dq.push_back(f.nxt[a]);
      }
  }
  // reverse reachability from finals
  std::vector<std::vector<int>> radj(f.ns);
  for (int s = 0; s < f.ns; ++s)
    for (int64_t a = f.off[s]; a < f.off[s + 1]; ++a)
      radj[f.nxt[a]].push_back(s);
  std::vector<char> bwd(f.ns, 0);
  for (int s = 0; s < f.ns; ++s)
    if (f.is_final(s) && !bwd[s]) {
      bwd[s] = 1;
      dq.push_back(s);
    }
  while (!dq.empty()) {
    int s = dq.front();
    dq.pop_front();
    for (int p : radj[s])
      if (!bwd[p]) {
        bwd[p] = 1;
        dq.push_back(p);
      }
  }
  std::vector<int> remap(f.ns, -1);
  int n = 0;
  for (int s = 0; s < f.ns; ++s)
    if (fwd[s] && bwd[s]) remap[s] = n++;
  if (remap[f.start] < 0) return out;
  out.ns = n;
  out.start = remap[f.start];
  out.fin.assign(n, std::numeric_limits<float>::infinity());
  out.off.assign(n + 1, 0);
  for (int s = 0; s < f.ns; ++s) {
    if (remap[s] < 0) continue;
    out.fin[remap[s]] = f.fin[s];
    for (int64_t a = f.off[s]; a < f.off[s + 1]; ++a)
      if (remap[f.nxt[a]] >= 0) out.off[remap[s] + 1]++;
  }
  for (int s = 0; s < n; ++s) out.off[s + 1] += out.off[s];
  out.il.resize(out.off[n]);
  out.ol.resize(out.off[n]);
  out.w.resize(out.off[n]);
  out.nxt.resize(out.off[n]);
  std::vector<int64_t> pos(out.off.begin(), out.off.end() - 1);
  for (int s = 0; s < f.ns; ++s) {
    if (remap[s] < 0) continue;
    for (int64_t a = f.off[s]; a < f.off[s + 1]; ++a) {
      if (remap[f.nxt[a]] < 0) continue;
      int64_t p = pos[remap[s]]++;
      out.il[p] = f.il[a];
      out.ol[p] = f.ol[a];
      out.w[p] = f.w[a];
      out.nxt[p] = remap[f.nxt[a]];
    }
  }
  return out;
}

// ------------------------------------------------------------------ compose
// 3-state epsilon filter: 0 free, 1 eps on A-output only, 2 eps on B-input
// only (mirrors Wfst.compose in wfst.py).
Fst compose(const Fst& A, const Fst& B) {
  FlatBuilder out;
  if (A.start < 0 || B.start < 0) return out.finish();
  std::unordered_map<uint64_t, int> state_map;
  const uint64_t nb = static_cast<uint64_t>(B.ns);
  auto key_of = [nb](int s1, int s2, int filt) {
    return (static_cast<uint64_t>(s1) * nb + static_cast<uint64_t>(s2)) * 3 +
           static_cast<uint64_t>(filt);
  };
  auto get = [&](int s1, int s2, int filt) {
    uint64_t k = key_of(s1, s2, filt);
    auto it = state_map.find(k);
    if (it != state_map.end()) return it->second;
    int id = out.add_state();
    state_map.emplace(k, id);
    if (A.is_final(s1) && B.is_final(s2))
      out.fin[id] = A.fin[s1] + B.fin[s2];
    return id;
  };
  struct Item {
    int s1, s2, filt;
  };
  std::deque<Item> dq;
  out.start = get(A.start, B.start, 0);
  dq.push_back({A.start, B.start, 0});
  while (!dq.empty()) {
    Item it = dq.front();
    dq.pop_front();
    int cur = get(it.s1, it.s2, it.filt);
    auto push = [&](int ns1, int ns2, int nf, int ilab, int olab, float wt) {
      uint64_t k = key_of(ns1, ns2, nf);
      bool fresh = state_map.find(k) == state_map.end();
      int nxt = get(ns1, ns2, nf);
      out.add_arc(cur, ilab, olab, wt, nxt);
      if (fresh) dq.push_back({ns1, ns2, nf});
    };
    // B arcs are ilabel-sorted by the binding layer; binary search ranges.
    const int64_t b0 = B.off[it.s2], b1 = B.off[it.s2 + 1];
    auto b_range = [&](int lab) {
      const int* base = B.il.data();
      const int* lo = std::lower_bound(base + b0, base + b1, lab);
      const int* hi = std::upper_bound(base + b0, base + b1, lab);
      return std::pair<int64_t, int64_t>(lo - base, hi - base);
    };
    for (int64_t a = A.off[it.s1]; a < A.off[it.s1 + 1]; ++a) {
      if (A.ol[a] == kEps) {
        if (it.filt != 2)
          push(A.nxt[a], it.s2, 1, A.il[a], kEps, A.w[a]);
        if (it.filt == 0) {
          // JOINT eps:eps move (Mohri filter's eps2:eps1 arc): without it,
          // paths needing an A-output-eps AND a B-input-eps between two
          // matches are dropped in BOTH orders (filter states 1 and 2
          // block the other side's eps) — e.g. H's eps-output self-loops
          // right before G's eps-input back-off arcs.
          auto [lo, hi] = b_range(kEps);
          for (int64_t b = lo; b < hi; ++b)
            push(A.nxt[a], B.nxt[b], 0, A.il[a], B.ol[b], A.w[a] + B.w[b]);
        }
      } else {
        auto [lo, hi] = b_range(A.ol[a]);
        for (int64_t b = lo; b < hi; ++b)
          push(A.nxt[a], B.nxt[b], 0, A.il[a], B.ol[b], A.w[a] + B.w[b]);
      }
    }
    if (it.filt != 1) {
      auto [lo, hi] = b_range(kEps);
      for (int64_t b = lo; b < hi; ++b)
        push(it.s1, B.nxt[b], 2, kEps, B.ol[b], B.w[b]);
    }
  }
  return connect(out.finish());
}

// -------------------------------------------------------------- determinize
// Weighted subset construction over tropical residuals; transducer labels
// are encoded as (ilabel<<32)|olabel pairs (the OpenFst encode recipe, as
// in Wfst.determinize).  Residuals kept in double to match the Python
// float64 arithmetic; subset identity uses exact bit patterns.
struct Subset {
  std::vector<std::pair<int, double>> items;  // sorted by state
  bool operator==(const Subset& o) const {
    if (items.size() != o.items.size()) return false;
    for (size_t i = 0; i < items.size(); ++i)
      if (items[i].first != o.items[i].first ||
          items[i].second != o.items[i].second)
        return false;
    return true;
  }
};
struct SubsetHash {
  size_t operator()(const Subset& s) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) {
      h ^= v;
      h *= 1099511628211ull;
    };
    for (auto& [st, r] : s.items) {
      mix(static_cast<uint64_t>(st));
      uint64_t bits;
      std::memcpy(&bits, &r, 8);
      mix(bits);
    }
    return static_cast<size_t>(h);
  }
};

Fst determinize(const Fst& f, int64_t max_states, bool* ok) {
  *ok = true;
  FlatBuilder out;
  if (f.start < 0) return out.finish();
  std::unordered_map<Subset, int, SubsetHash> state_map;
  std::deque<Subset> dq;
  Subset s0;
  s0.items = {{f.start, 0.0}};
  state_map.emplace(s0, out.add_state());
  out.start = 0;
  dq.push_back(std::move(s0));
  while (!dq.empty()) {
    Subset subset = std::move(dq.front());
    dq.pop_front();
    int cur = state_map.find(subset)->second;
    double fw = kInf;
    for (auto& [s, r] : subset.items)
      if (f.is_final(s)) fw = std::min(fw, r + static_cast<double>(f.fin[s]));
    if (fw < kInf) out.fin[cur] = static_cast<float>(fw);
    // group by encoded label, sorted (std::map) to mirror Python ordering
    std::map<uint64_t, std::vector<std::pair<int, double>>> by_label;
    for (auto& [s, r] : subset.items)
      for (int64_t a = f.off[s]; a < f.off[s + 1]; ++a) {
        uint64_t lab = (static_cast<uint64_t>(static_cast<uint32_t>(f.il[a]))
                        << 32) |
                       static_cast<uint32_t>(f.ol[a]);
        by_label[lab].emplace_back(f.nxt[a], r + static_cast<double>(f.w[a]));
      }
    for (auto& [lab, items] : by_label) {
      double wmin = kInf;
      for (auto& [ns, wt] : items) wmin = std::min(wmin, wt);
      std::map<int, double> dest;  // sorted by state
      for (auto& [ns, wt] : items) {
        double res = wt - wmin;
        auto it = dest.find(ns);
        if (it == dest.end() || res < it->second) dest[ns] = res;
      }
      Subset nsub;
      nsub.items.assign(dest.begin(), dest.end());
      auto it = state_map.find(nsub);
      int nid;
      if (it == state_map.end()) {
        if (out.ns >= max_states) {
          *ok = false;  // twins-property violation guard
          return out.finish();
        }
        nid = out.add_state();
        state_map.emplace(nsub, nid);
        dq.push_back(std::move(nsub));
      } else {
        nid = it->second;
      }
      out.add_arc(cur, static_cast<int>(lab >> 32),
                  static_cast<int>(lab & 0xffffffffu),
                  static_cast<float>(wmin), nid);
    }
  }
  return out.finish();
}

// --------------------------------------------------------------- rmepsilon
// Per-state tropical eps-closure (Dijkstra over eps:eps arcs), then copy
// non-eps arcs and finals through the closure (mirrors Wfst.rmepsilon).
Fst rmepsilon(const Fst& f) {
  FlatBuilder out;
  out.start = f.start;
  for (int s = 0; s < f.ns; ++s) out.add_state();
  using QI = std::pair<double, int>;
  std::vector<double> dist(f.ns);
  std::vector<int> touched;
  std::vector<char> in_touched(f.ns, 0);
  for (int s = 0; s < f.ns; ++s) {
    std::priority_queue<QI, std::vector<QI>, std::greater<QI>> pq;
    for (int t : touched) in_touched[t] = 0;
    touched.clear();
    auto relax = [&](int u, double d) {
      if (!in_touched[u]) {
        in_touched[u] = 1;
        touched.push_back(u);
        dist[u] = d;
        return true;
      }
      if (d < dist[u] - 1e-12) {
        dist[u] = d;
        return true;
      }
      return false;
    };
    relax(s, 0.0);
    pq.push({0.0, s});
    while (!pq.empty()) {
      auto [d, u] = pq.top();
      pq.pop();
      if (d > dist[u] + 1e-12) continue;
      for (int64_t a = f.off[u]; a < f.off[u + 1]; ++a)
        if (f.il[a] == kEps && f.ol[a] == kEps &&
            relax(f.nxt[a], d + f.w[a]))
          pq.push({dist[f.nxt[a]], f.nxt[a]});
    }
    double best_final = kInf;
    for (int u : touched) {
      double d = dist[u];
      if (f.is_final(u))
        best_final = std::min(best_final, d + static_cast<double>(f.fin[u]));
      for (int64_t a = f.off[u]; a < f.off[u + 1]; ++a)
        if (!(f.il[a] == kEps && f.ol[a] == kEps))
          out.add_arc(s, f.il[a], f.ol[a], static_cast<float>(d + f.w[a]),
                      f.nxt[a]);
    }
    if (best_final < kInf) out.fin[s] = static_cast<float>(best_final);
  }
  return connect(out.finish());
}

}  // namespace

// ----------------------------------------------------------------- C ABI
extern "C" {

void* dsr_fst_create(int ns, int64_t na, const int64_t* off, const int* il,
                     const int* ol, const float* w, const int* nxt, int start,
                     const float* fin) {
  Fst* f = new Fst();
  f->ns = ns;
  f->start = start;
  f->off.assign(off, off + ns + 1);
  f->il.assign(il, il + na);
  f->ol.assign(ol, ol + na);
  f->w.assign(w, w + na);
  f->nxt.assign(nxt, nxt + na);
  f->fin.assign(fin, fin + ns);
  return f;
}

void dsr_fst_free(void* h) { delete static_cast<Fst*>(h); }

int dsr_fst_num_states(void* h) { return static_cast<Fst*>(h)->ns; }
int64_t dsr_fst_num_arcs(void* h) { return static_cast<Fst*>(h)->na(); }
int dsr_fst_start(void* h) { return static_cast<Fst*>(h)->start; }

void dsr_fst_copy_out(void* h, int64_t* off, int* il, int* ol, float* w,
                      int* nxt, float* fin) {
  Fst* f = static_cast<Fst*>(h);
  std::memcpy(off, f->off.data(), (f->ns + 1) * sizeof(int64_t));
  std::memcpy(il, f->il.data(), f->na() * sizeof(int));
  std::memcpy(ol, f->ol.data(), f->na() * sizeof(int));
  std::memcpy(w, f->w.data(), f->na() * sizeof(float));
  std::memcpy(nxt, f->nxt.data(), f->na() * sizeof(int));
  std::memcpy(fin, f->fin.data(), f->ns * sizeof(float));
}

void* dsr_fst_compose(void* a, void* b) {
  return new Fst(compose(*static_cast<Fst*>(a), *static_cast<Fst*>(b)));
}

void* dsr_fst_determinize(void* a, int64_t max_states) {
  bool ok;
  Fst r = determinize(*static_cast<Fst*>(a), max_states, &ok);
  if (!ok) return nullptr;
  return new Fst(std::move(r));
}

void* dsr_fst_rmepsilon(void* a) {
  return new Fst(rmepsilon(*static_cast<Fst*>(a)));
}

void* dsr_fst_connect(void* a) {
  return new Fst(connect(*static_cast<Fst*>(a)));
}

// In-place stable arc sort by (ilabel, olabel) per state — the precondition
// for this file's compose(B) binary search, so handle-level pipelines can
// chain ops without re-sorting through Python.
void dsr_fst_arcsort(void* h) {
  Fst* f = static_cast<Fst*>(h);
  std::vector<int64_t> idx;
  for (int s = 0; s < f->ns; ++s) {
    const int64_t a0 = f->off[s], a1 = f->off[s + 1];
    idx.resize(a1 - a0);
    for (int64_t i = 0; i < a1 - a0; ++i) idx[i] = a0 + i;
    std::stable_sort(idx.begin(), idx.end(), [f](int64_t x, int64_t y) {
      if (f->il[x] != f->il[y]) return f->il[x] < f->il[y];
      return f->ol[x] < f->ol[y];
    });
    std::vector<int> il(a1 - a0), ol(a1 - a0), nxt(a1 - a0);
    std::vector<float> w(a1 - a0);
    for (int64_t i = 0; i < a1 - a0; ++i) {
      il[i] = f->il[idx[i]];
      ol[i] = f->ol[idx[i]];
      w[i] = f->w[idx[i]];
      nxt[i] = f->nxt[idx[i]];
    }
    std::copy(il.begin(), il.end(), f->il.begin() + a0);
    std::copy(ol.begin(), ol.end(), f->ol.begin() + a0);
    std::copy(w.begin(), w.end(), f->w.begin() + a0);
    std::copy(nxt.begin(), nxt.end(), f->nxt.begin() + a0);
  }
}

// Max out-degree over states — sizing diagnostic for the packed decoder's
// per-state arc-row padding.
int64_t dsr_fst_max_outdeg(void* h) {
  Fst* f = static_cast<Fst*>(h);
  int64_t m = 0;
  for (int s = 0; s < f->ns; ++s)
    m = std::max(m, f->off[s + 1] - f->off[s]);
  return m;
}

}  // extern "C"
