// lyndon — native batch factorization of fpmash_tpu_torch (a copy of the JAX
// package's native/lyndon.cpp, its C interface and semantics unchanged).
//
// C++ equivalents of the scalar models in fpmash_tpu_torch/scalar/lyndon.py
// (Duval's CFL, the ICFL inverse-Lyndon factorization, the CFL_ICFL hybrid,
// and the *_COMB reverse-complement refinements — reference lyn2vec
// factorizations.py + factorizations_comb.py).  They factorize on the host
// the rows that the port keeps off the card; outputs are factor-LENGTH lists
// (the fingerprint), written CSR-style for whole batches in one call
// (fpmash_tpu_torch/utils/native_lyndon.py; built at first use by
// fpmash_tpu_torch/ops/_build.py, host_library("lyndon"), into build/).
//
// Quirk preserved: in COMB merges the reverse-complement side uses the
// DEFAULT threshold C=30, not the caller's T (factorizations_comb.py:213).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

using std::string;
using std::vector;

// ---- CFL (Duval) ----
void cfl(const char* s, long n, vector<int32_t>& out) {
  long i = 0;
  while (i < n) {
    long j = i + 1, k = i;
    while (j < n && s[k] <= s[j]) {
      k = (s[k] < s[j]) ? i : k + 1;
      j++;
    }
    long period = j - k;
    while (i <= k) {
      out.push_back((int32_t)period);
      i += period;
    }
  }
}

// ---- ICFL ----
// failure function of s[0..m)
static void failure(const char* s, long m, vector<long>& f) {
  f.assign(m, 0);
  long k = 0;
  for (long i = 1; i < m; i++) {
    while (k > 0 && s[k] != s[i]) k = f[k - 1];
    if (s[k] == s[i]) k++;
    f[i] = k;
  }
}

// Split w into (x_len, rest) at first ascent; returns false if w is an
// inverse Lyndon word.
static bool first_ascent_prefix(const char* w, long n, long& x_len) {
  if (n == 1) return false;
  long i = 0, j = 1;
  while (j < n - 1 && w[j] <= w[i]) {
    i = (w[j] < w[i]) ? 0 : i + 1;
    j++;
  }
  if (j == n - 1 && w[j] <= w[i]) return false;
  x_len = j + 1;
  return true;
}

// Given w = x + y (x_len = |x|), compute p (prefix emitted), the bre start
// (suffix to recurse on starts at n - last - 1 ... in python terms), and
// `last`.  Mirrors scalar/lyndon.py _bounded_right_extension.
static void bounded_right_extension(const char* w, long x_len, long& p_len,
                                    long& rec_start, long& last_out,
                                    vector<long>& fbuf) {
  long n = x_len - 1;
  failure(w, x_len - 1, fbuf);
  long i = n - 1;
  long last = n;
  while (i >= 0) {
    if (w[fbuf[i]] < w[x_len - 1]) last = fbuf[i] - 1;
    i = fbuf[i] - 1;
  }
  p_len = n - last - 1;
  rec_start = p_len;  // bre+y starts right after p
  last_out = last + 1;
}

void icfl(const char* word, long n0, vector<int32_t>& out) {
  // iterative version of the recursion: collect (p_len, last) frames, then
  // fold from the innermost result outwards.
  vector<std::pair<long, long>> stack;  // (p_len, last)
  const char* w = word;
  long n = n0;
  vector<long> fbuf;
  long final_len;
  while (true) {
    long x_len;
    if (!first_ascent_prefix(w, n, x_len)) {
      final_len = n;
      break;
    }
    long p_len, rec_start, last;
    bounded_right_extension(w, x_len, p_len, rec_start, last, fbuf);
    stack.emplace_back(p_len, last);
    w += rec_start;
    n -= rec_start;
  }
  // result (list of factor lengths), built back-to-front
  vector<int32_t> result;
  result.push_back((int32_t)final_len);
  for (long idx = (long)stack.size() - 1; idx >= 0; idx--) {
    long p_len = stack[idx].first;
    long last = stack[idx].second;
    if (result.front() > last) {
      result.insert(result.begin(), (int32_t)p_len);
    } else {
      result.front() += (int32_t)p_len;
    }
  }
  out.insert(out.end(), result.begin(), result.end());
}

// ---- CFL_ICFL ----
void cfl_icfl(const char* s, long n, long C, vector<int32_t>& out) {
  vector<int32_t> cfl_out;
  cfl(s, n, cfl_out);
  long pos = 0;
  for (int32_t flen : cfl_out) {
    if (flen > C) {
      icfl(s + pos, flen, out);
    } else {
      out.push_back(flen);
    }
    pos += flen;
  }
}

// ---- COMB ----
static char comp(char c) {
  switch (c) {
    case 'A': return 'T';
    case 'C': return 'G';
    case 'G': return 'C';
    case 'T': return 'A';
    default: return 'N';
  }
}

// alg: 0=cfl, 1=icfl, 2=cfl_icfl(C)
static void run_alg(int alg, const char* s, long n, long C, vector<int32_t>& out) {
  switch (alg) {
    case 0: cfl(s, n, out); break;
    case 1: icfl(s, n, out); break;
    default: cfl_icfl(s, n, C, out); break;
  }
}

void comb(int alg, const char* s, long n, long T, bool has_T, vector<int32_t>& out) {
  vector<int32_t> fwd;
  run_alg(alg, s, n, has_T ? T : 30, fwd);

  string rc(n, 'N');
  for (long i = 0; i < n; i++) rc[n - 1 - i] = comp(s[i]);
  vector<int32_t> rc_f;
  run_alg(alg, rc.data(), n, 30, rc_f);  // RC side always default C=30
  vector<int32_t> rev(rc_f.rbegin(), rc_f.rend());

  // common refinement merge (factorizations_comb.py:225-245)
  size_t a = 0, b = 0;
  int32_t ra = fwd.empty() ? 0 : fwd[0];
  int32_t rb = rev.empty() ? 0 : rev[0];
  while (a < fwd.size() && b < rev.size()) {
    if (ra < rb) {
      out.push_back(ra);
      rb -= ra;
      a++;
      if (a < fwd.size()) ra = fwd[a];
      if (rb == 0) {
        b++;
        if (b < rev.size()) rb = rev[b];
      }
    } else {
      out.push_back(rb);
      ra -= rb;
      b++;
      if (b < rev.size()) rb = rev[b];
      if (ra == 0) {
        a++;
        if (a < fwd.size()) ra = fwd[a];
      }
    }
  }
  while (a < fwd.size()) {
    out.push_back(ra);
    a++;
    if (a < fwd.size()) ra = fwd[a];
  }
  while (b < rev.size()) {
    out.push_back(rb);
    b++;
    if (b < rev.size()) rb = rev[b];
  }
}

}  // namespace

extern "C" {

// Batch factorization.
//  blob: concatenated window bytes; offsets[i]..offsets[i+1] = window i.
//  alg_id: 0 CFL, 1 ICFL, 2 CFL_ICFL(T), 3 CFL_COMB, 4 ICFL_COMB,
//          5 CFL_ICFL_COMB(T).
//  out_lens: caller buffer of capacity cap (int32); out_offsets: n_rows+1.
// Returns total factor count, or -1 if cap is insufficient.
long lyn_factorize_batch(const char* blob, const int64_t* offsets, long n_rows,
                         int alg_id, long T, int32_t* out_lens, long cap,
                         int64_t* out_offsets) {
  vector<int32_t> buf;
  long total = 0;
  out_offsets[0] = 0;
  for (long r = 0; r < n_rows; r++) {
    const char* s = blob + offsets[r];
    long n = offsets[r + 1] - offsets[r];
    buf.clear();
    if (n > 0) {
      switch (alg_id) {
        case 0: cfl(s, n, buf); break;
        case 1: icfl(s, n, buf); break;
        case 2: cfl_icfl(s, n, T, buf); break;
        case 3: comb(0, s, n, T, false, buf); break;
        case 4: comb(1, s, n, T, false, buf); break;
        case 5: comb(2, s, n, T, true, buf); break;
        default: return -2;
      }
    }
    if (total + (long)buf.size() > cap) return -1;
    memcpy(out_lens + total, buf.data(), buf.size() * sizeof(int32_t));
    total += (long)buf.size();
    out_offsets[r + 1] = total;
  }
  return total;
}

}  // extern "C"
