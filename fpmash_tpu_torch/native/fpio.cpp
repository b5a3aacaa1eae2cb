// fpio — native host IO of fpmash_tpu_torch (a copy of the JAX package's
// native/fpio.cpp, its C interface and semantics unchanged).
//
// The reference's C++ host-side IO: the fingerprint .txt parser
// (Sketch::initFromFingerprints' getline/istringstream loop,
// Sketch.cpp:82-100) and a kseq-style FASTA/FASTQ reader (kseq.h), rebuilt
// as batch parsers that emit flat arrays, exposed through a C ABI consumed
// via ctypes (fpmash_tpu_torch/utils/native.py).
//
// Built at first use by fpmash_tpu_torch/ops/_build.py (host_library("fpio"))
// into build/.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FingerprintFile {
  // flat values of all lines, with per-line offsets (CSR layout)
  std::vector<uint64_t> values;
  std::vector<uint64_t> line_offsets;  // size = n_lines + 1
  std::string ids;                     // NUL-joined per-line IDs
  std::vector<uint64_t> id_offsets;    // size = n_lines + 1 (byte offsets)
};

struct SeqFile {
  std::string seq;                   // concatenated sequence bytes
  std::vector<uint64_t> seq_offsets; // size = n_records + 1
  std::string names;                 // NUL-joined names
  std::vector<uint64_t> name_offsets;
  std::string comments;              // NUL-joined comments
  std::vector<uint64_t> comment_offsets;
};

bool read_whole_file(const char* path, std::string& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  out.resize(got);
  return true;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- //
// fingerprint .txt
// ---------------------------------------------------------------- //

// Parse a fingerprint file.  Returns an opaque handle (or null).
// max_lines <= 0 means unlimited.
void* fpio_parse_fingerprint(const char* path, long max_lines) {
  std::string data;
  if (!read_whole_file(path, data)) return nullptr;

  auto* out = new FingerprintFile();
  out->line_offsets.push_back(0);
  out->id_offsets.push_back(0);

  const char* p = data.data();
  const char* end = p + data.size();
  long lines = 0;
  while (p < end && (max_lines <= 0 || lines < max_lines)) {
    // find end of line
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    // skip leading spaces
    const char* q = p;
    while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
    if (q == eol) {  // blank line: skip entirely
      p = eol + 1;
      continue;
    }
    // ID token
    const char* id_start = q;
    while (q < eol && *q != ' ' && *q != '\t' && *q != '\r') q++;
    out->ids.append(id_start, q - id_start);
    out->ids.push_back('\0');
    out->id_offsets.push_back(out->ids.size());
    // integer tokens; stop at first non-integer (istringstream semantics)
    while (q < eol) {
      while (q < eol && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
      if (q == eol) break;
      if (*q < '0' || *q > '9') break;
      uint64_t v = 0;
      bool any = false;
      while (q < eol && *q >= '0' && *q <= '9') {
        v = v * 10 + (*q - '0');
        q++;
        any = true;
      }
      if (!any) break;
      out->values.push_back(v);
      // a trailing non-space terminates parsing of the line like
      // `ss >> number` failing mid-stream
      if (q < eol && *q != ' ' && *q != '\t' && *q != '\r') break;
    }
    out->line_offsets.push_back(out->values.size());
    lines++;
    p = eol + 1;
  }
  return out;
}

long fpio_fingerprint_n_lines(void* h) {
  return static_cast<FingerprintFile*>(h)->line_offsets.size() - 1;
}
long fpio_fingerprint_n_values(void* h) {
  return static_cast<FingerprintFile*>(h)->values.size();
}
const uint64_t* fpio_fingerprint_values(void* h) {
  return static_cast<FingerprintFile*>(h)->values.data();
}
const uint64_t* fpio_fingerprint_line_offsets(void* h) {
  return static_cast<FingerprintFile*>(h)->line_offsets.data();
}
const char* fpio_fingerprint_ids(void* h) {
  return static_cast<FingerprintFile*>(h)->ids.data();
}
long fpio_fingerprint_ids_size(void* h) {
  return static_cast<FingerprintFile*>(h)->ids.size();
}
void fpio_fingerprint_free(void* h) { delete static_cast<FingerprintFile*>(h); }

// ---------------------------------------------------------------- //
// FASTA / FASTQ
// ---------------------------------------------------------------- //

void* fpio_parse_seq(const char* path) {
  std::string data;
  if (!read_whole_file(path, data)) return nullptr;

  auto* out = new SeqFile();
  out->seq_offsets.push_back(0);
  out->name_offsets.push_back(0);
  out->comment_offsets.push_back(0);

  const char* p = data.data();
  const char* end = p + data.size();
  while (p < end && (*p == '\n' || *p == '\r' || *p == ' ')) p++;
  if (p >= end) return out;
  const char fasta_marker = '>';
  const bool is_fastq = (*p == '@');

  auto emit_header = [&](const char* h, const char* eol) {
    // name = first token; comment = rest of line (keeps \r like kseq)
    const char* q = h;
    while (q < eol && *q != ' ' && *q != '\t') q++;
    out->names.append(h, q - h);
    out->names.push_back('\0');
    out->name_offsets.push_back(out->names.size());
    while (q < eol && (*q == ' ' || *q == '\t')) q++;
    out->comments.append(q, eol - q);
    out->comments.push_back('\0');
    out->comment_offsets.push_back(out->comments.size());
  };

  if (!is_fastq) {
    while (p < end) {
      if (*p != fasta_marker) break;
      p++;  // skip '>'
      const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!eol) eol = end;
      // keep a trailing \r in the header (kseq does; sketch comments
      // containing \r are byte-compatible with the reference)
      emit_header(p, eol);
      p = (eol < end) ? eol + 1 : end;
      // sequence lines until next '>'
      while (p < end && *p != fasta_marker) {
        const char* seol = static_cast<const char*>(memchr(p, '\n', end - p));
        if (!seol) seol = end;
        const char* send = seol;
        if (send > p && send[-1] == '\r') send--;
        out->seq.append(p, send - p);
        p = (seol < end) ? seol + 1 : end;
      }
      out->seq_offsets.push_back(out->seq.size());
    }
  } else {
    while (p < end) {
      if (*p != '@') break;
      p++;
      const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!eol) eol = end;
      emit_header(p, eol);
      p = (eol < end) ? eol + 1 : end;
      // sequence line
      const char* seol = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!seol) seol = end;
      const char* send = seol;
      if (send > p && send[-1] == '\r') send--;
      out->seq.append(p, send - p);
      out->seq_offsets.push_back(out->seq.size());
      p = (seol < end) ? seol + 1 : end;
      // '+' line
      const char* plus_eol = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!plus_eol) plus_eol = end;
      p = (plus_eol < end) ? plus_eol + 1 : end;
      // quality line (skipped)
      const char* qeol = static_cast<const char*>(memchr(p, '\n', end - p));
      if (!qeol) qeol = end;
      p = (qeol < end) ? qeol + 1 : end;
    }
  }
  return out;
}

long fpio_seq_n_records(void* h) {
  return static_cast<SeqFile*>(h)->seq_offsets.size() - 1;
}
const char* fpio_seq_data(void* h) { return static_cast<SeqFile*>(h)->seq.data(); }
long fpio_seq_data_size(void* h) { return static_cast<SeqFile*>(h)->seq.size(); }
const uint64_t* fpio_seq_offsets(void* h) {
  return static_cast<SeqFile*>(h)->seq_offsets.data();
}
const char* fpio_seq_names(void* h) { return static_cast<SeqFile*>(h)->names.data(); }
long fpio_seq_names_size(void* h) { return static_cast<SeqFile*>(h)->names.size(); }
const char* fpio_seq_comments(void* h) {
  return static_cast<SeqFile*>(h)->comments.data();
}
long fpio_seq_comments_size(void* h) {
  return static_cast<SeqFile*>(h)->comments.size();
}
void fpio_seq_free(void* h) { delete static_cast<SeqFile*>(h); }

}  // extern "C"
