// The port's native host runtime: fused FASTA parse and encode, the three
// subject packers and the prefilter's k-mer signatures, as host C++.
//
// The port's copy of swtpu/native/sw_native.cpp (sw_parse_fasta :70,
// sw_pack_batch :126, sw_pack_segments :145, sw_pack_bucket_T :170,
// sw_build_signatures :210), with the same results on every valid input.
// It is host code, not a device kernel: g++ builds it (ops/_build.py) and
// swtpu_torch/native binds it with ctypes.  Each entry point has a NumPy
// twin in the package (io/fasta.py parse_database_plain, utils/bucketing.py
// pack_batch_plain and gather_wave_stack, utils/segpack.py
// pack_segments_plain, ops/prefilter.py database_signatures_plain), which
// the tests and chip_smoke.py hold it to bit for bit.
//
// What bounds it: bytes through one core.  Parse reads the file once and
// writes each residue once; the packers write each output byte once (a
// memset of the pads, then one memcpy a member row, or for the transposed
// wavefront layout a blocked copy that keeps 128 lanes' source streams and
// their output rows in cache); the signatures read each residue 3 times
// from cache and set one byte a 3-mer.
//
// The ABI follows the port's kernel libraries: every entry point returns an
// int error code (0 = success), which sw_native_error_string names; a count
// goes out through a pointer.  Ids and segment starts are checked against
// the database and the output's shape, so a bad plan raises in Python
// instead of writing past a buffer.  Ids are int32 for the row and
// wavefront packers and int64 for the segment packer, as in swtpu; offsets
// are int64 everywhere, so a buffer of 2^31 residues or more works.

#include <cstdint>
#include <cstring>

namespace {

enum : int {
  SW_NATIVE_OK = 0,
  SW_NATIVE_CAPACITY = 1,  // parse: more records than offsets_out holds
  SW_NATIVE_BAD_ID = 2,    // an id outside [0, n_seqs)
  SW_NATIVE_BAD_RECORD = 3,  // a record whose end offset lies before its start
  SW_NATIVE_BAD_SHAPE = 4,   // more members than rows or lanes, a negative size, a start outside its row
  SW_NATIVE_BAD_HASH = 5,    // a signature width that is not a power of two
};

constexpr int8_t STAR = 24;

// byte -> residue index (BLAST order "ARNDCQEGHILKMFPSTWYVBJZX*"; every other
// byte -> STAR), as swtpu_torch.alphabet's table; whitespace is dropped.
struct EncodeTable {
  int8_t t[256];
  uint8_t keep[256];  // 0 for whitespace
  EncodeTable() {
    const char* alphabet = "ARNDCQEGHILKMFPSTWYVBJZX*";
    for (int i = 0; i < 256; ++i) t[i] = STAR, keep[i] = 1;
    for (int i = 0; alphabet[i]; ++i) t[(unsigned char)alphabet[i]] = (int8_t)i;
    keep[(unsigned char)'\r'] = keep[(unsigned char)'\n'] = 0;
    keep[(unsigned char)'\t'] = keep[(unsigned char)' '] = 0;
  }
};
const EncodeTable kTable;

// Append the encoded bytes [begin, end) without whitespace at out + pos;
// returns the new length.
inline int64_t encode_body(const char* begin, const char* end, int8_t* out, int64_t pos) {
  for (const char* p = begin; p < end; ++p) {
    unsigned char c = (unsigned char)*p;
    if (kTable.keep[c]) out[pos++] = kTable.t[c];
  }
  return pos;
}

// [begin, length) of record id, or an error code.
inline int record(const int64_t* offsets, int64_t n_seqs, int64_t id, int64_t* begin, int64_t* len) {
  if (id < 0 || id >= n_seqs) return SW_NATIVE_BAD_ID;
  *begin = offsets[id];
  *len = offsets[id + 1] - *begin;
  return *len < 0 ? SW_NATIVE_BAD_RECORD : SW_NATIVE_OK;
}

}  // namespace

extern "C" {

const char* sw_native_error_string(int code) {
  switch (code) {
    case SW_NATIVE_OK: return "no error";
    case SW_NATIVE_CAPACITY: return "more records than the offsets buffer holds";
    case SW_NATIVE_BAD_ID: return "a sequence id outside the database";
    case SW_NATIVE_BAD_RECORD: return "a record whose end offset lies before its start";
    case SW_NATIVE_BAD_SHAPE: return "more members than rows or lanes, a negative size, or a segment start outside its row";
    case SW_NATIVE_BAD_HASH: return "a signature width that is not a power of two";
    default: return "unknown sw_native error";
  }
}

// An upper bound on the records sw_parse_fasta finds in data: the count of
// '>' plus one (a record starts at a '>' or is the headerless file).
// memchr runs at memory speed, several times Python's bytes.count.
int sw_fasta_record_bound(const char* data, int64_t n, int64_t* bound) {
  if (n < 0) return SW_NATIVE_BAD_SHAPE;
  int64_t count = 1;
  for (const char *p = data, *end = data + n; p < end; ++count, ++p) {
    p = (const char*)memchr(p, '>', (size_t)(end - p));
    if (p == nullptr) break;
  }
  *bound = count;
  return SW_NATIVE_OK;
}

// Parse FASTA bytes into encoded residues and offsets.
//
//   data, n       the file's bytes
//   residues_out  capacity >= n
//   offsets_out   capacity >= max_records + 1; offsets_out[0] = 0 and
//                 offsets_out[k] = the end of record k - 1's residues
//   n_records     out: the number of records
//
// Records (swtpu's native parse, swtpu/native/sw_native.cpp:61-68):
//   * with no '>' in the file, the whole file without whitespace is one
//     record, if it is not empty;
//   * else records start at the first '>' and after every "\n>"; bytes
//     before the first '>' are ignored;
//   * a record's header is its first line; its body is the rest, without
//     whitespace, encoded;
//   * a record is dropped when its header, less one trailing '\r', and its
//     body are both empty.  So a header line of two or more '\r' keeps its
//     record, empty body and all.
int sw_parse_fasta(const char* data, int64_t n, int8_t* residues_out, int64_t* offsets_out, int64_t max_records,
                   int64_t* n_records) {
  if (n < 0 || max_records < 0) return SW_NATIVE_BAD_SHAPE;
  int64_t n_rec = 0;
  int64_t pos = 0;
  offsets_out[0] = 0;
  *n_records = 0;

  const char* first = n ? (const char*)memchr(data, '>', (size_t)n) : nullptr;
  if (first == nullptr) {
    pos = encode_body(data, data + n, residues_out, 0);
    if (pos == 0) return SW_NATIVE_OK;
    if (max_records < 1) return SW_NATIVE_CAPACITY;
    offsets_out[1] = pos;
    *n_records = 1;
    return SW_NATIVE_OK;
  }

  // One pass, a line at a time: a record ends where a line starts with
  // '>' (the "\n>" boundary), so the body's lines are encoded as they are
  // found.
  const char* end = data + n;
  const char* rec = first + 1;  // just past '>'
  while (true) {
    const char* nl = (const char*)memchr(rec, '\n', (size_t)(end - rec));
    const char* header_end = nl ? nl : end;
    int64_t header_len = header_end - rec;
    if (header_len > 0 && header_end[-1] == '\r') header_len--;
    int64_t new_pos = pos;
    const char* next_rec = nullptr;
    for (const char* line = nl ? nl + 1 : end; line < end;) {
      if (*line == '>') {
        next_rec = line + 1;
        break;
      }
      const char* line_end = (const char*)memchr(line, '\n', (size_t)(end - line));
      if (line_end == nullptr) line_end = end;
      new_pos = encode_body(line, line_end, residues_out, new_pos);
      line = line_end + 1;
    }
    if (header_len > 0 || new_pos > pos) {
      if (n_rec + 1 > max_records) return SW_NATIVE_CAPACITY;
      pos = new_pos;
      offsets_out[++n_rec] = pos;
    }
    if (next_rec == nullptr) break;
    rec = next_rec;
  }
  *n_records = n_rec;
  return SW_NATIVE_OK;
}

// A (rows, width) row-major batch: member r's residues at row r, cut at
// width; every other byte `pad` (swtpu's sw_pack_batch).
int sw_pack_batch(const int8_t* residues, const int64_t* offsets, int64_t n_seqs, const int32_t* ids, int64_t n_ids,
                  int64_t rows, int64_t width, int8_t pad, int8_t* out) {
  if (n_ids < 0 || width < 0 || n_ids > rows) return SW_NATIVE_BAD_SHAPE;
  memset(out, pad, (size_t)(rows * width));
  for (int64_t r = 0; r < n_ids; ++r) {
    int64_t beg, len;
    if (int rc = record(offsets, n_seqs, ids[r], &beg, &len)) return rc;
    if (len > width) len = width;
    memcpy(out + r * width, residues + beg, (size_t)len);
  }
  return SW_NATIVE_OK;
}

// A (rows, width) row-major batch of segment-shared rows: row r holds up to
// s_max members, member s from column starts[r, s], cut at the row's end;
// ids[r, s] = -1 ends the row (swtpu's sw_pack_segments).
int sw_pack_segments(const int8_t* residues, const int64_t* offsets, int64_t n_seqs, const int64_t* ids,
                     const int32_t* starts, int64_t rows, int64_t s_max, int64_t width, int8_t pad, int8_t* out) {
  if (rows < 0 || s_max < 0 || width < 0) return SW_NATIVE_BAD_SHAPE;
  memset(out, pad, (size_t)(rows * width));
  for (int64_t r = 0; r < rows; ++r) {
    int8_t* row = out + r * width;
    for (int64_t s = 0; s < s_max; ++s) {
      int64_t id = ids[r * s_max + s];
      if (id < 0) break;
      int64_t beg, len;
      if (int rc = record(offsets, n_seqs, id, &beg, &len)) return rc;
      int64_t col = starts[r * s_max + s];
      if (col < 0 || col > width) return SW_NATIVE_BAD_SHAPE;
      if (col + len > width) len = width - col;
      memcpy(row + col, residues + beg, (size_t)len);
    }
  }
  return SW_NATIVE_OK;
}

// A wavefront bucket's (l2, bpad) transposed layout (subjects on lanes,
// residue position on rows; ops/wave_sw.py): member b down lane b, cut at
// l2 rows; every other byte `pad` (swtpu's sw_pack_bucket_T).  Blocked by
// 128 lanes, so each output row piece is one contiguous 128-byte write and
// each member's source stream stays in cache.  The output's row stride is
// bpad, so a caller can pack a chained bucket's segments one call each
// into consecutive row ranges of one stack.
int sw_pack_bucket_T(const int8_t* residues, const int64_t* offsets, int64_t n_seqs, const int32_t* ids,
                     int64_t n_ids, int64_t l2, int64_t bpad, int8_t pad, int8_t* out) {
  if (n_ids < 0 || l2 < 0 || n_ids > bpad) return SW_NATIVE_BAD_SHAPE;
  memset(out, pad, (size_t)(l2 * bpad));
  const int64_t TB = 128;
  for (int64_t b0 = 0; b0 < n_ids; b0 += TB) {
    int64_t bend = b0 + TB < n_ids ? b0 + TB : n_ids;
    int64_t kmax = 0;
    const int8_t* src[TB];
    int64_t len[TB];
    for (int64_t b = b0; b < bend; ++b) {
      int64_t beg, l;
      if (int rc = record(offsets, n_seqs, ids[b], &beg, &l)) return rc;
      if (l > l2) l = l2;
      src[b - b0] = residues + beg;
      len[b - b0] = l;
      if (l > kmax) kmax = l;
    }
    for (int64_t k = 0; k < kmax; ++k) {
      int8_t* row = out + k * bpad + b0;
      for (int64_t b = 0; b < bend - b0; ++b) {
        if (k < len[b]) row[b] = src[b][k];
      }
    }
  }
  return SW_NATIVE_OK;
}

// (n, dim) int8 3-mer presence signatures of the prefilter (ops/prefilter.py,
// whose k is 3): one pass over the flat residue buffer, every 3-mer window
// inside a record hashed into one presence byte of its record's row.
// hash = ((acc >> 20) ^ acc) & (dim - 1), acc = r[p] * mix[0] + r[p + 1] *
// mix[1] + r[p + 2] * mix[2] on uint32 wrap-around (prefilter._MIX; swtpu's
// sw_build_signatures at k = 3).
int sw_build_signatures(const int8_t* residues, const int64_t* offsets, int64_t n, int64_t dim, const uint32_t* mix,
                        int8_t* out) {
  if (n < 0) return SW_NATIVE_BAD_SHAPE;
  if (dim < 1 || (dim & (dim - 1)) != 0) return SW_NATIVE_BAD_HASH;
  memset(out, 0, (size_t)(n * dim));
  const uint32_t mask = (uint32_t)(dim - 1);
  const uint32_t m0 = mix[0], m1 = mix[1], m2 = mix[2];
  for (int64_t i = 0; i < n; ++i) {
    int64_t beg, len;
    if (int rc = record(offsets, n, i, &beg, &len)) return rc;
    const uint8_t* seq = (const uint8_t*)residues + beg;
    int8_t* sig = out + i * dim;
    for (int64_t p = 0; p + 3 <= len; ++p) {
      uint32_t acc = seq[p] * m0 + seq[p + 1] * m1 + seq[p + 2] * m2;
      sig[((acc >> 20) ^ acc) & mask] = 1;
    }
  }
  return SW_NATIVE_OK;
}

}  // extern "C"
