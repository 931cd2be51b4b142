// Native host record layer of the fast simplex and group engines.
//
// A trimmed copy of the JAX package's native runtime: only the batch record
// exports the fast simplex engine (consensus/fast.py), the fast group engine
// (commands/fast_group.py), the UMI assigners (umi/assigners.py) and the
// batch reader (io/batch_reader.py) call — record boundaries, fixed-field
// decode, aux-tag scan, byte-range grouping/equality/hashing, SourceRead
// packing, mate-overlap clips, in-place overlap correction, RX unanimity,
// the consensus-record serializer, the duplex engine's record serializer,
// per-segment depth/error recount and RX fast path, UMI scans and span concatenation,
// unclipped 5' positions, the MI-tag record rewrite, pigeonhole UMI
// neighbour pairs and the directed adjacency BFS; the fast filter's
// quality sums, per-base tag gathers and in-place masks; and the exports of
// the front of the pipeline: FASTQ -> unmapped-BAM record assembly
// (extract), packed template-coordinate and natural-queryname sort keys,
// reference ends for the BAI/CSI index, and the external sort engine (span
// argsort, gather, spill runs, k-way merge with frame prefetch). BGZF (de)compression
// stays in Python's zlib (io/bgzf.py) and spill runs are written as stored
// frames, so this file needs only the C++ standard library. Built by g++ at first use
// into fgumi_tpu_torch/_build/ (native/__init__.py) and called through ctypes
// with raw numpy addresses (native/batch.py).

#include <algorithm>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

inline uint16_t read_u16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0]) | (static_cast<uint16_t>(p[1]) << 8);
}

inline uint32_t read_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" {

// Scan decoded BAM bytes for record boundaries: offsets[i] = start of record i
// (the 4-byte block_size prefix). Returns the number of complete records
// found; sets *scanned to the byte offset just past the last complete record.
// Mirrors the FindBoundaries step (unified_pipeline/bam.rs:180).
long fgumi_find_record_boundaries(const uint8_t* buf, long len,
                                  int64_t* offsets, long max_records,
                                  int64_t* scanned) {
  long off = 0;
  long n = 0;
  while (off + 4 <= len && n < max_records) {
    const uint32_t block_size = read_u32(buf + off);
    if (off + 4 + static_cast<long>(block_size) > len) break;
    offsets[n++] = off;
    off += 4 + static_cast<long>(block_size);
  }
  *scanned = off;
  return n;
}

}  // extern "C"
// ---------------------------------------------------------------------------
// Batch consensus-record serializer.
// ---------------------------------------------------------------------------

namespace {

// consensus base code -> BAM seq nibble (A,C,G,T,N -> 1,2,4,8,15).
const uint8_t kCode2Nib[5] = {1, 2, 4, 8, 15};

inline void put_u16(uint8_t* p, uint16_t v) {
  p[0] = v & 0xFF;
  p[1] = v >> 8;
}

inline void put_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xFF;
  p[1] = (v >> 8) & 0xFF;
  p[2] = (v >> 16) & 0xFF;
  p[3] = (v >> 24) & 0xFF;
}

}  // namespace

extern "C" {

// Serialize J unmapped consensus records (block_size-prefixed BAM wire bytes)
// into `out`. Mirrors VanillaConsensusCaller._build_record
// (consensus/vanilla.py:439-483; reference build_consensus_record_into,
// vanilla_caller.rs:1452-1540): header + name + packed seq + quals, then tags
// RG:Z, cD:i, cM:i, cE:f, [cd:B:s, ce:B:s], MI:Z, [RX:Z]. depth/errors clamp
// to i16::MAX (fgbio Short semantics). Names are prefix + ':' + MI value.
// Per-record data arrives as raw addresses (code_addr[j] -> uint8[lens[j]],
// depth_addr[j] -> int32[lens[j]], ...) so callers can point straight into
// their bucket tensors without gathering a dense (J, L) copy. MI/RX values
// are absolute addresses too (mi_addr[j] -> uint8[mi_len[j]]) so they can
// reference the decoded batch buffer directly (no per-job gather blob);
// rx_addr[j] == 0 marks an absent RX tag.
// Returns total bytes written, or -1 when out_cap is insufficient.
long fgumi_build_consensus_records(
    const int64_t* code_addr, const int64_t* qual_addr,
    const int64_t* depth_addr, const int64_t* err_addr, const int32_t* lens,
    const int32_t* flags, long J, const uint8_t* prefix, int prefix_len,
    const int64_t* mi_addr, const int32_t* mi_len,
    const int64_t* rx_addr, const int32_t* rx_len,
    const uint8_t* rg, int rg_len, int per_base_tags, uint8_t* out,
    long out_cap, int64_t* rec_end) {
  long off = 0;
  for (long j = 0; j < J; ++j) {
    const int32_t L = lens[j];
    const uint8_t* crow = reinterpret_cast<const uint8_t*>(code_addr[j]);
    const uint8_t* qrow = reinterpret_cast<const uint8_t*>(qual_addr[j]);
    const int32_t* drow = reinterpret_cast<const int32_t*>(depth_addr[j]);
    const int32_t* erow = reinterpret_cast<const int32_t*>(err_addr[j]);
    const int32_t name_len = prefix_len + 1 + mi_len[j];
    if (name_len + 1 > 255) return -2;  // l_read_name is a u8 (caller raises)
    long need = 4 + 32 + name_len + 1 + (L + 1) / 2 + L;
    need += 3 + rg_len + 1;        // RG:Z
    need += (7 + 7 + 7);           // cD cM cE
    if (per_base_tags) need += 2 * (8 + 2 * static_cast<long>(L));
    need += 3 + mi_len[j] + 1;     // MI:Z
    if (rx_addr[j] != 0) need += 3 + rx_len[j] + 1;
    if (off + need > out_cap) return -1;
    const uint8_t* mi_p = reinterpret_cast<const uint8_t*>(mi_addr[j]);

    uint8_t* rec = out + off + 4;  // past block_size prefix
    // fixed header (io/bam.py start_unmapped): refID -1, pos -1, l_read_name,
    // mapq 0, bin 4680, n_cigar 0, flag, l_seq, next_refID -1, next_pos -1,
    // tlen 0
    put_u32(rec + 0, 0xFFFFFFFFu);
    put_u32(rec + 4, 0xFFFFFFFFu);
    rec[8] = static_cast<uint8_t>(name_len + 1);
    rec[9] = 0;
    put_u16(rec + 10, 4680);
    put_u16(rec + 12, 0);
    put_u16(rec + 14, static_cast<uint16_t>(flags[j]));
    put_u32(rec + 16, static_cast<uint32_t>(L));
    put_u32(rec + 20, 0xFFFFFFFFu);
    put_u32(rec + 24, 0xFFFFFFFFu);
    put_u32(rec + 28, 0);
    uint8_t* p = rec + 32;
    std::memcpy(p, prefix, static_cast<size_t>(prefix_len));
    p += prefix_len;
    *p++ = ':';
    std::memcpy(p, mi_p, static_cast<size_t>(mi_len[j]));
    p += mi_len[j];
    *p++ = 0;
    // packed seq
    for (int32_t i = 0; i + 1 < L; i += 2) {
      const uint8_t hi = kCode2Nib[crow[i] < 4 ? crow[i] : 4];
      const uint8_t lo = kCode2Nib[crow[i + 1] < 4 ? crow[i + 1] : 4];
      *p++ = static_cast<uint8_t>((hi << 4) | lo);
    }
    if (L & 1) {
      *p++ = static_cast<uint8_t>(kCode2Nib[crow[L - 1] < 4 ? crow[L - 1] : 4]
                                  << 4);
    }
    std::memcpy(p, qrow, static_cast<size_t>(L));
    p += L;
    // RG:Z
    p[0] = 'R'; p[1] = 'G'; p[2] = 'Z';
    std::memcpy(p + 3, rg, static_cast<size_t>(rg_len));
    p += 3 + rg_len;
    *p++ = 0;
    // depth/error aggregates over clamped i16 values
    int32_t max_d = 0, min_d = 0;
    int64_t tot_d = 0, tot_e = 0;
    if (L > 0) {
      max_d = -1;
      min_d = 0x7FFFFFFF;
      for (int32_t i = 0; i < L; ++i) {
        const int32_t d16 = drow[i] < 32767 ? drow[i] : 32767;
        const int32_t e16 = erow[i] < 32767 ? erow[i] : 32767;
        if (d16 > max_d) max_d = d16;
        if (d16 < min_d) min_d = d16;
        tot_d += d16;
        tot_e += e16;
      }
    }
    p[0] = 'c'; p[1] = 'D'; p[2] = 'i';
    put_u32(p + 3, static_cast<uint32_t>(L > 0 ? max_d : 0));
    p += 7;
    p[0] = 'c'; p[1] = 'M'; p[2] = 'i';
    put_u32(p + 3, static_cast<uint32_t>(L > 0 ? min_d : 0));
    p += 7;
    const float rate =
        tot_d ? static_cast<float>(tot_e) / static_cast<float>(tot_d) : 0.0f;
    p[0] = 'c'; p[1] = 'E'; p[2] = 'f';
    uint32_t rate_bits;
    std::memcpy(&rate_bits, &rate, 4);
    put_u32(p + 3, rate_bits);
    p += 7;
    if (per_base_tags) {
      p[0] = 'c'; p[1] = 'd'; p[2] = 'B'; p[3] = 's';
      put_u32(p + 4, static_cast<uint32_t>(L));
      p += 8;
      for (int32_t i = 0; i < L; ++i) {
        const int32_t d16 = drow[i] < 32767 ? drow[i] : 32767;
        put_u16(p, static_cast<uint16_t>(static_cast<int16_t>(d16)));
        p += 2;
      }
      p[0] = 'c'; p[1] = 'e'; p[2] = 'B'; p[3] = 's';
      put_u32(p + 4, static_cast<uint32_t>(L));
      p += 8;
      for (int32_t i = 0; i < L; ++i) {
        const int32_t e16 = erow[i] < 32767 ? erow[i] : 32767;
        put_u16(p, static_cast<uint16_t>(static_cast<int16_t>(e16)));
        p += 2;
      }
    }
    p[0] = 'M'; p[1] = 'I'; p[2] = 'Z';
    std::memcpy(p + 3, mi_p, static_cast<size_t>(mi_len[j]));
    p += 3 + mi_len[j];
    *p++ = 0;
    if (rx_addr[j] != 0) {
      p[0] = 'R'; p[1] = 'X'; p[2] = 'Z';
      std::memcpy(p + 3, reinterpret_cast<const uint8_t*>(rx_addr[j]),
                  static_cast<size_t>(rx_len[j]));
      p += 3 + rx_len[j];
      *p++ = 0;
    }
    const long rec_size = p - rec;
    put_u32(out + off, static_cast<uint32_t>(rec_size));
    off += 4 + rec_size;
    rec_end[j] = off;
  }
  return off;
}

// Batch byte-range equality within one buffer: out[i] = 1 iff both ranges
// are present (offset >= 0), equal length, and byte-identical. Used for
// read-name pair checks without per-record Python slicing.
void fgumi_ranges_equal(const uint8_t* buf, const int64_t* off_a,
                        const int32_t* len_a, const int64_t* off_b,
                        const int32_t* len_b, long n, uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    out[i] = (off_a[i] >= 0 && off_b[i] >= 0 && len_a[i] == len_b[i] &&
              std::memcmp(buf + off_a[i], buf + off_b[i],
                          static_cast<size_t>(len_a[i])) == 0)
                 ? 1
                 : 0;
  }
}

// FNV-1a 64-bit hash per byte range (off < 0 hashes to 0); for duplicate
// detection over read names without materializing Python bytes.
void fgumi_hash_ranges(const uint8_t* buf, const int64_t* off,
                       const int32_t* len, long n, uint64_t* out) {
  for (long i = 0; i < n; ++i) {
    if (off[i] < 0) {
      out[i] = 0;
      continue;
    }
    uint64_t h = 1469598103934665603ULL;
    const uint8_t* p = buf + off[i];
    for (int32_t k = 0; k < len[i]; ++k) {
      h = (h ^ p[k]) * 1099511628211ULL;
    }
    out[i] = h;
  }
}

// Per-segment RX-tag unanimity (consensus/simple_umi.py::consensus_umis fast
// cases). Rows [starts[j], starts[j+1]) with (off, len) per row (off < 0 =
// tag absent). Per segment:
//   out_off[j] = -1  when no row has the tag (emit no RX)
//   out_off[j] = -2  when present values differ, or are unanimous but a
//                    multi-row value needs uppercasing (acgtn present) —
//                    caller runs the Python consensus for these
//   otherwise        out_off/out_len reference the verbatim unanimous value
//                    (single present row, or multi-row already-uppercase)
void fgumi_rx_unanimous(const uint8_t* buf, const int64_t* off,
                        const int32_t* len, const int64_t* starts, long J,
                        int64_t* out_off, int32_t* out_len) {
  for (long j = 0; j < J; ++j) {
    int64_t first = -1;
    int32_t flen = 0;
    long present = 0;
    bool equal = true;
    for (int64_t r = starts[j]; r < starts[j + 1]; ++r) {
      if (off[r] < 0) continue;
      if (present == 0) {
        first = off[r];
        flen = len[r];
      } else if (len[r] != flen ||
                 std::memcmp(buf + off[r], buf + first,
                             static_cast<size_t>(flen)) != 0) {
        equal = false;
        break;
      }
      ++present;
    }
    if (present == 0) {
      out_off[j] = -1;
      out_len[j] = 0;
      continue;
    }
    if (!equal) {
      out_off[j] = -2;
      out_len[j] = 0;
      continue;
    }
    if (present > 1) {
      // multi-read unanimous output is uppercased for a/c/g/t/n only
      bool lower = false;
      const uint8_t* p = buf + first;
      for (int32_t k = 0; k < flen; ++k) {
        const uint8_t c = p[k];
        if (c == 'a' || c == 'c' || c == 'g' || c == 't' || c == 'n') {
          lower = true;
          break;
        }
      }
      if (lower) {
        out_off[j] = -2;
        out_len[j] = 0;
        continue;
      }
    }
    out_off[j] = first;
    out_len[j] = flen;
  }
}


// Serialize J unmapped duplex consensus records. Byte-exact analog of
// DuplexConsensusCaller._build_record (consensus/duplex.py; reference
// duplex_read_into, duplex_caller.rs:1056-1249): header + name + packed seq +
// quals, then tags MI:Z, RG:Z, aD/aE/aM [+ac/ad/ae/aq], bD/bE/bM
// [+bc/bd/be/bq], cD/cE/cM, [RX:Z]. All per-record data arrives as raw
// addresses; b_present[j] == 0 marks a missing BA strand (bD/bE/bM still
// written as zeros, per-base b tags skipped); rx_addr[j] == 0 marks no RX.
// a_* arrays have a_len[j] entries (full strand length), code/qual/err have
// lens[j] (the combined length). Returns total bytes, or -1 on overflow.
long fgumi_build_duplex_records(
    const int64_t* code_addr, const int64_t* qual_addr, const int64_t* err_addr,
    const int32_t* lens, const int32_t* flags, long J, const uint8_t* prefix,
    int prefix_len, const int64_t* mi_addr, const int32_t* mi_len,
    const int64_t* a_code, const int64_t* a_qual, const int64_t* a_depth,
    const int64_t* a_err, const int32_t* a_len,
    const int64_t* b_code, const int64_t* b_qual, const int64_t* b_depth,
    const int64_t* b_err, const int32_t* b_len, const uint8_t* b_present,
    const int64_t* rx_addr, const int32_t* rx_len, const uint8_t* rg,
    int rg_len, int per_base_tags, uint8_t* out, long out_cap,
    int64_t* rec_end) {
  const uint8_t kBase[5] = {'A', 'C', 'G', 'T', 'N'};
  long off = 0;
  for (long j = 0; j < J; ++j) {
    const int32_t L = lens[j];
    const int32_t aL = a_len[j];
    const int32_t bL = b_present[j] ? b_len[j] : 0;
    const uint8_t* crow = reinterpret_cast<const uint8_t*>(code_addr[j]);
    const uint8_t* qrow = reinterpret_cast<const uint8_t*>(qual_addr[j]);
    const int32_t* erow = reinterpret_cast<const int32_t*>(err_addr[j]);
    const uint8_t* mi_p = reinterpret_cast<const uint8_t*>(mi_addr[j]);
    const int32_t name_len = prefix_len + 1 + mi_len[j];
    if (name_len + 1 > 255) return -2;  // l_read_name is a u8 (caller raises)
    long need = 4 + 32 + name_len + 1 + (L + 1) / 2 + L;
    need += (3 + mi_len[j] + 1) + (3 + rg_len + 1);  // MI RG
    need += 6 * 7 + 3 * 7;  // aD/aM/bD/bM/cD/cM + aE/bE/cE (7 bytes each)
    if (per_base_tags) {
      need += (3 + aL + 1) + 2 * (8 + 2 * static_cast<long>(aL)) + (3 + aL + 1);
      if (b_present[j]) {
        need += (3 + bL + 1) + 2 * (8 + 2 * static_cast<long>(bL))
                + (3 + bL + 1);
      }
    }
    if (rx_addr[j] != 0) need += 3 + rx_len[j] + 1;
    if (off + need > out_cap) return -1;

    uint8_t* rec = out + off + 4;
    put_u32(rec + 0, 0xFFFFFFFFu);
    put_u32(rec + 4, 0xFFFFFFFFu);
    rec[8] = static_cast<uint8_t>(name_len + 1);
    rec[9] = 0;
    put_u16(rec + 10, 4680);
    put_u16(rec + 12, 0);
    put_u16(rec + 14, static_cast<uint16_t>(flags[j]));
    put_u32(rec + 16, static_cast<uint32_t>(L));
    put_u32(rec + 20, 0xFFFFFFFFu);
    put_u32(rec + 24, 0xFFFFFFFFu);
    put_u32(rec + 28, 0);
    uint8_t* p = rec + 32;
    std::memcpy(p, prefix, static_cast<size_t>(prefix_len));
    p += prefix_len;
    *p++ = ':';
    std::memcpy(p, mi_p, static_cast<size_t>(mi_len[j]));
    p += mi_len[j];
    *p++ = 0;
    for (int32_t i = 0; i + 1 < L; i += 2) {
      const uint8_t hi = kCode2Nib[crow[i] < 4 ? crow[i] : 4];
      const uint8_t lo = kCode2Nib[crow[i + 1] < 4 ? crow[i + 1] : 4];
      *p++ = static_cast<uint8_t>((hi << 4) | lo);
    }
    if (L & 1) {
      *p++ = static_cast<uint8_t>(kCode2Nib[crow[L - 1] < 4 ? crow[L - 1] : 4]
                                  << 4);
    }
    std::memcpy(p, qrow, static_cast<size_t>(L));
    p += L;
    p[0] = 'M'; p[1] = 'I'; p[2] = 'Z';
    std::memcpy(p + 3, mi_p, static_cast<size_t>(mi_len[j]));
    p += 3 + mi_len[j];
    *p++ = 0;
    p[0] = 'R'; p[1] = 'G'; p[2] = 'Z';
    std::memcpy(p + 3, rg, static_cast<size_t>(rg_len));
    p += 3 + rg_len;
    *p++ = 0;

    // one strand's aggregate + optional per-base tags (strand_metrics +
    // the ac/ad/ae/aq block of consensus/duplex.py)
    auto strand_tags = [&](char sc, const uint8_t* scode, const uint8_t* squal,
                           const int32_t* sdep, const int32_t* serr,
                           int32_t sl, bool present, bool base_tags) {
      int32_t mx = 0, mn = 0;
      float rate = 0.0f;
      if (sl > 0) {
        mx = -1;
        mn = 0x7FFFFFFF;
        int64_t td = 0, te = 0;
        for (int32_t i = 0; i < sl; ++i) {
          const int32_t d16 = sdep[i] < 32767 ? sdep[i] : 32767;
          const int32_t e16 = serr[i] < 32767 ? serr[i] : 32767;
          if (d16 > mx) mx = d16;
          if (d16 < mn) mn = d16;
          td += d16;
          te += e16;
        }
        rate = td ? static_cast<float>(te) / static_cast<float>(td) : 0.0f;
      }
      p[0] = sc; p[1] = 'D'; p[2] = 'i';
      put_u32(p + 3, static_cast<uint32_t>(sl > 0 ? mx : 0));
      p += 7;
      uint32_t bits;
      std::memcpy(&bits, &rate, 4);
      p[0] = sc; p[1] = 'E'; p[2] = 'f';
      put_u32(p + 3, bits);
      p += 7;
      p[0] = sc; p[1] = 'M'; p[2] = 'i';
      put_u32(p + 3, static_cast<uint32_t>(sl > 0 ? mn : 0));
      p += 7;
      if (base_tags && present) {
        p[0] = sc; p[1] = 'c'; p[2] = 'Z';
        p += 3;
        for (int32_t i = 0; i < sl; ++i) *p++ = kBase[scode[i] < 4 ? scode[i] : 4];
        *p++ = 0;
        p[0] = sc; p[1] = 'd'; p[2] = 'B'; p[3] = 's';
        put_u32(p + 4, static_cast<uint32_t>(sl));
        p += 8;
        for (int32_t i = 0; i < sl; ++i) {
          put_u16(p, static_cast<uint16_t>(
                         static_cast<int16_t>(sdep[i] < 32767 ? sdep[i] : 32767)));
          p += 2;
        }
        p[0] = sc; p[1] = 'e'; p[2] = 'B'; p[3] = 's';
        put_u32(p + 4, static_cast<uint32_t>(sl));
        p += 8;
        for (int32_t i = 0; i < sl; ++i) {
          put_u16(p, static_cast<uint16_t>(
                         static_cast<int16_t>(serr[i] < 32767 ? serr[i] : 32767)));
          p += 2;
        }
        p[0] = sc; p[1] = 'q'; p[2] = 'Z';
        p += 3;
        for (int32_t i = 0; i < sl; ++i) *p++ = static_cast<uint8_t>(squal[i] + 33);
        *p++ = 0;
      }
    };
    strand_tags('a', reinterpret_cast<const uint8_t*>(a_code[j]),
                reinterpret_cast<const uint8_t*>(a_qual[j]),
                reinterpret_cast<const int32_t*>(a_depth[j]),
                reinterpret_cast<const int32_t*>(a_err[j]), aL, true,
                per_base_tags != 0);
    strand_tags('b', reinterpret_cast<const uint8_t*>(b_code[j]),
                reinterpret_cast<const uint8_t*>(b_qual[j]),
                reinterpret_cast<const int32_t*>(b_depth[j]),
                reinterpret_cast<const int32_t*>(b_err[j]), bL,
                b_present[j] != 0, per_base_tags != 0);

    // combined cD/cE/cM: per-strand per-base i16 clamp before summing
    // (consensus/duplex.py, duplex_caller.rs:1188-1215)
    const int32_t* adp = reinterpret_cast<const int32_t*>(a_depth[j]);
    const int32_t* bdp = reinterpret_cast<const int32_t*>(b_depth[j]);
    int64_t comb_max = 0, comb_min = 0, total_d = 0, total_e = 0;
    if (L > 0) {
      comb_max = -1;
      comb_min = 0x7FFFFFFFFFFFLL;
      for (int32_t i = 0; i < L; ++i) {
        int64_t c = adp[i] < 32767 ? adp[i] : 32767;
        if (b_present[j]) c += bdp[i] < 32767 ? bdp[i] : 32767;
        if (c > comb_max) comb_max = c;
        if (c < comb_min) comb_min = c;
        total_d += c;
        total_e += erow[i] < 32767 ? erow[i] : 32767;
      }
    }
    const float crate =
        total_d ? static_cast<float>(total_e) / static_cast<float>(total_d)
                : 0.0f;
    p[0] = 'c'; p[1] = 'D'; p[2] = 'i';
    put_u32(p + 3, static_cast<uint32_t>(L > 0 ? comb_max : 0));
    p += 7;
    uint32_t crate_bits;
    std::memcpy(&crate_bits, &crate, 4);
    p[0] = 'c'; p[1] = 'E'; p[2] = 'f';
    put_u32(p + 3, crate_bits);
    p += 7;
    p[0] = 'c'; p[1] = 'M'; p[2] = 'i';
    put_u32(p + 3, static_cast<uint32_t>(L > 0 ? comb_min : 0));
    p += 7;
    if (rx_addr[j] != 0) {
      p[0] = 'R'; p[1] = 'X'; p[2] = 'Z';
      std::memcpy(p + 3, reinterpret_cast<const uint8_t*>(rx_addr[j]),
                  static_cast<size_t>(rx_len[j]));
      p += 3 + rx_len[j];
      *p++ = 0;
    }
    const long rec_size = p - rec;
    put_u32(out + off, static_cast<uint32_t>(rec_size));
    off += 4 + rec_size;
    rec_end[j] = off;
  }
  return off;
}

// Per-segment depth/error counts for the ragged consensus layout: codes is
// the dense (N, L) read-row array (N = starts[J]), winner the (J, L) called
// bases; depth[j,i] = valid (non-N) observations, errors[j,i] = valid
// observations disagreeing with the winner (all of them when the winner is
// N). Integer-exact: the duplex engine's exact-error pass
// (consensus/fast_duplex.py) calls the ranges form below.
void fgumi_segment_depth_errors(const uint8_t* codes, const uint8_t* winner,
                                const int64_t* starts, long J, long L,
                                int32_t* depth, int32_t* errors) {
  for (long j = 0; j < J; ++j) {
    int32_t* drow = depth + j * L;
    int32_t* erow = errors + j * L;
    const uint8_t* wrow = winner + j * L;
    std::memset(drow, 0, static_cast<size_t>(L) * 4);
    std::memset(erow, 0, static_cast<size_t>(L) * 4);
    for (int64_t r = starts[j]; r < starts[j + 1]; ++r) {
      const uint8_t* crow = codes + r * L;
      for (long i = 0; i < L; ++i) {
        const uint8_t c = crow[i];
        if (c != 4) {
          ++drow[i];
          erow[i] += (c != wrow[i]);
        }
      }
    }
  }
}

// fgumi_segment_depth_errors with explicit, possibly non-contiguous row
// ranges [lo[j], hi[j]) per segment (the duplex exact-error pass sums a
// molecule's two strand segs, which are not adjacent in the dense layout).
void fgumi_segment_depth_errors_ranges(const uint8_t* codes,
                                       const uint8_t* winner,
                                       const int64_t* lo, const int64_t* hi,
                                       long J, long L, int32_t* depth,
                                       int32_t* errors) {
  for (long j = 0; j < J; ++j) {
    int32_t* drow = depth + j * L;
    int32_t* erow = errors + j * L;
    const uint8_t* wrow = winner + j * L;
    std::memset(drow, 0, static_cast<size_t>(L) * 4);
    std::memset(erow, 0, static_cast<size_t>(L) * 4);
    for (int64_t r = lo[j]; r < hi[j]; ++r) {
      const uint8_t* crow = codes + r * L;
      for (long i = 0; i < L; ++i) {
        const uint8_t c = crow[i];
        if (c != 4) {
          ++drow[i];
          erow[i] += (c != wrow[i]);
        }
      }
    }
  }
}


// Duplex consensus-RX fast path (fast_duplex.py _output_rx): per output
// read, combine the a-seg RX (verbatim) and b-seg RX (strand-flipped =
// '-'-separated fields reversed) when BOTH contributing segs are unanimous
// (una_off >= 0) or absent (-1). Emits into `blob`:
//   total-present == 1  -> the single value verbatim
//   values all equal    -> the value with acgtn uppercased
// Anything else (divergent seg una_off == -2, or disagreeing values) is a
// python-fallback output: its index lands in fb_idx and rx_len stays 0.
// Returns the fallback count, or -1 if blob_cap would overflow (caller
// sizes blob_cap as the sum of both contributing lengths per output, so
// this is a programming-error guard, not a retry protocol).
int64_t fgumi_duplex_rx_fast(const uint8_t* buf, const int64_t* una_off,
                             const int32_t* una_len, const int64_t* cnt,
                             const int64_t* a_seg, const int64_t* b_seg,
                             int64_t K, uint8_t* blob, int64_t blob_cap,
                             int64_t* rx_off, int32_t* rx_len,
                             int64_t* fb_idx, int64_t* blob_used_out) {
  int64_t used = 0;
  int64_t n_fb = 0;
  uint8_t val[2][512];
  int32_t vlen[2];
  int64_t vcnt[2];
  for (int64_t k = 0; k < K; ++k) {
    rx_off[k] = 0;
    rx_len[k] = 0;
    int nv = 0;
    bool fallback = false;
    for (int side = 0; side < 2; ++side) {
      const int64_t s = side == 0 ? a_seg[k] : b_seg[k];
      if (s < 0 || una_off[s] == -1) continue;
      if (una_off[s] == -2 || una_len[s] > 512) {
        fallback = true;
        break;
      }
      const int32_t L = una_len[s];
      const uint8_t* src = buf + una_off[s];
      if (side == 0) {
        for (int32_t i = 0; i < L; ++i) val[nv][i] = src[i];
      } else {
        // strand flip: reverse the '-'-separated fields
        int32_t w = 0;
        int32_t end = L;
        for (int32_t i = L - 1; i >= -1; --i) {
          if (i == -1 || src[i] == '-') {
            for (int32_t j = i + 1; j < end; ++j) val[nv][w++] = src[j];
            if (i >= 0) val[nv][w++] = '-';
            end = i;
          }
        }
      }
      vlen[nv] = L;
      vcnt[nv] = cnt[s];
      ++nv;
    }
    if (fallback) {
      fb_idx[n_fb++] = k;
      continue;
    }
    if (nv == 0) continue;  // nothing to emit (rx_len stays 0)
    const int64_t total = nv == 2 ? vcnt[0] + vcnt[1] : vcnt[0];
    bool emit_upper;
    if (total == 1) {
      emit_upper = false;  // single read: verbatim
    } else if (nv == 2 && (vlen[0] != vlen[1] ||
                           memcmp(val[0], val[1], vlen[0]) != 0)) {
      fb_idx[n_fb++] = k;  // disagreeing unanimous values: likelihood call
      continue;
    } else {
      emit_upper = true;
    }
    const int32_t L = vlen[0];
    if (used + L > blob_cap) return -1;
    rx_off[k] = used;
    rx_len[k] = L;
    if (emit_upper) {
      for (int32_t i = 0; i < L; ++i) {
        const uint8_t c = val[0][i];
        blob[used + i] =
            (c == 'a' || c == 'c' || c == 'g' || c == 't' || c == 'n')
                ? c - 32 : c;
      }
    } else {
      memcpy(blob + used, val[0], L);
    }
    used += L;
  }
  *blob_used_out = used;
  return n_fb;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batch record decode / pack layer.
//
// C++ equivalents of the reference's raw-record hot path
// (crates/fgumi-raw-bam/src/fields.rs:1-43, raw_bam_record.rs:6-13): Python
// touches per-*batch* numpy arrays, never per-record objects. All offsets are
// into one decompressed chunk buffer; fixed BAM field layout per SAM spec §4.2.
// ---------------------------------------------------------------------------

namespace {

inline int32_t read_i32(const uint8_t* p) {
  return static_cast<int32_t>(read_u32(p));
}

// BAM nibble -> consensus base code (A,C,G,T -> 0..3, everything else 4/N),
// composing NIBBLE_TO_BASE ("=ACMGRSVTWYHKDBN") with BASE_TO_CODE
// (fgumi_tpu_torch/constants.py; reference BASE_TO_INDEX base_builder.rs:307-318).
const uint8_t kNib2Code[16] = {4, 0, 1, 4, 2, 4, 4, 4, 3, 4, 4, 4, 4, 4, 4, 4};

// CIGAR op index (MIDNSHP=X) predicates.
inline bool op_consumes_query(uint32_t op) {
  // M I S = X
  return op == 0 || op == 1 || op == 4 || op == 7 || op == 8;
}
inline bool op_consumes_ref(uint32_t op) {
  // M D N = X
  return op == 0 || op == 2 || op == 3 || op == 7 || op == 8;
}
inline bool op_is_align(uint32_t op) {  // M = X
  return op == 0 || op == 7 || op == 8;
}

struct CigarView {
  const uint8_t* p;
  int32_t n;
  inline uint32_t op(int32_t i) const { return read_u32(p + 4 * i) & 0xF; }
  inline int64_t len(int32_t i) const { return read_u32(p + 4 * i) >> 4; }
};

int64_t cigar_ref_len(const CigarView& c) {
  int64_t total = 0;
  for (int32_t i = 0; i < c.n; ++i) {
    if (op_consumes_ref(c.op(i))) total += c.len(i);
  }
  return total;
}

int64_t cigar_read_len(const CigarView& c) {
  int64_t total = 0;
  for (int32_t i = 0; i < c.n; ++i) {
    if (op_consumes_query(c.op(i))) total += c.len(i);
  }
  return total;
}

int64_t cigar_leading_soft(const CigarView& c) {
  int64_t total = 0;
  for (int32_t i = 0; i < c.n; ++i) {
    const uint32_t op = c.op(i);
    if (op == 4) {       // S
      total += c.len(i);
    } else if (op == 5) {  // H
      continue;
    } else {
      break;
    }
  }
  return total;
}

int64_t cigar_trailing_soft(const CigarView& c) {
  int64_t total = 0;
  for (int32_t i = c.n - 1; i >= 0; --i) {
    const uint32_t op = c.op(i);
    if (op == 4) {
      total += c.len(i);
    } else if (op == 5) {
      continue;
    } else {
      break;
    }
  }
  return total;
}

// 1-based read position at reference position `target`; 0 if in a
// deletion/outside. Mirrors fgumi_tpu_torch/core/overlap.py::_read_pos_at_ref
// (reference overlap.rs:362-411).
int64_t read_pos_at_ref(const CigarView& c, int64_t start_1based,
                        int64_t target, bool before) {
  int64_t ref_pos = start_1based;
  int64_t read_pos = 0;
  for (int32_t i = 0; i < c.n; ++i) {
    const uint32_t op = c.op(i);
    const int64_t length = c.len(i);
    if (op_is_align(op)) {
      if (target < ref_pos) return 0;
      if (target < ref_pos + length) {
        read_pos += target - ref_pos + 1;
        if (before) {
          const int64_t b = read_pos - 1;
          return b > 0 ? b : 0;
        }
        return read_pos;
      }
      read_pos += length;
      ref_pos += length;
    } else if (op == 1 || op == 4) {  // I S
      read_pos += length;
    } else if (op == 2 || op == 3) {  // D N
      if (ref_pos <= target && target < ref_pos + length) return 0;
      ref_pos += length;
    }
  }
  return 0;
}

// Parse an MC-tag CIGAR string: (leading_soft, ref_len, trailing_soft).
// Mirrors overlap.py::parse_soft_clips_and_ref_len (overlap.rs:277-345).
bool parse_mc_cigar(const uint8_t* s, int64_t len, int64_t* leading_soft,
                    int64_t* ref_len, int64_t* trailing_soft) {
  std::vector<std::pair<int64_t, char>> tokens;
  int64_t num = 0;
  bool have_digits = false;
  for (int64_t i = 0; i < len; ++i) {
    const char ch = static_cast<char>(s[i]);
    if (ch >= '0' && ch <= '9') {
      num = num * 10 + (ch - '0');
      have_digits = true;
      continue;
    }
    if (!have_digits || num == 0 ||
        std::strchr("MIDNSHP=X", ch) == nullptr) {
      return false;
    }
    tokens.emplace_back(num, ch);
    num = 0;
    have_digits = false;
  }
  if (have_digits || tokens.empty()) return false;

  const size_t last = tokens.size() - 1;
  int64_t lead = 0, trail = 0, rlen = 0;
  bool saw_ref_op = false;
  for (size_t i = 0; i < tokens.size(); ++i) {
    const int64_t length = tokens[i].first;
    const char op = tokens[i].second;
    if (op == 'M' || op == 'D' || op == 'N' || op == '=' || op == 'X') {
      rlen += length;
      saw_ref_op = true;
    } else if (op == 'I' || op == 'P') {
      // no-op
    } else if (op == 'S') {
      bool leading = true;
      for (size_t j = 0; j < i; ++j) {
        if (tokens[j].second != 'H') { leading = false; break; }
      }
      bool trailing = true;
      for (size_t j = i + 1; j < tokens.size(); ++j) {
        if (tokens[j].second != 'H') { trailing = false; break; }
      }
      if (!leading && !trailing) return false;
      if (saw_ref_op) {
        trail += length;
      } else {
        lead += length;
      }
    } else if (op == 'H') {
      if (i != 0 && i != last) return false;
    } else {
      return false;
    }
  }
  if (!saw_ref_op) return false;
  *leading_soft = lead;
  *ref_len = rlen;
  *trailing_soft = trail;
  return true;
}

// BAM flag bits.
constexpr int32_t kFlagPaired = 0x1;
constexpr int32_t kFlagUnmapped = 0x4;
constexpr int32_t kFlagMateUnmapped = 0x8;
constexpr int32_t kFlagReverse = 0x10;
constexpr int32_t kFlagMateReverse = 0x20;

// Mirrors overlap.py::is_fr_pair (overlap.rs:14-61).
bool is_fr_pair(int32_t flag, int32_t ref_id, int32_t next_ref_id, int32_t pos,
                int32_t next_pos, int32_t tlen, const CigarView& c) {
  if (!(flag & kFlagPaired)) return false;
  if (flag & (kFlagUnmapped | kFlagMateUnmapped)) return false;
  if (ref_id != next_ref_id) return false;
  const bool is_rev = flag & kFlagReverse;
  if (is_rev == static_cast<bool>(flag & kFlagMateReverse)) return false;
  const int64_t start = static_cast<int64_t>(pos) + 1;
  const int64_t mate_start = static_cast<int64_t>(next_pos) + 1;
  int64_t positive_5p, negative_5p;
  if (is_rev) {
    const int64_t rl = cigar_ref_len(c);
    positive_5p = mate_start;
    negative_5p = start + (rl - 1 > 0 ? rl - 1 : 0);
  } else {
    positive_5p = start;
    negative_5p = start + tlen;
  }
  return positive_5p < negative_5p;
}

// Mirrors overlap.py::_bases_extending_past_mate (overlap.rs:172-231).
int64_t bases_extending_past_mate(const CigarView& c, int32_t flag, int32_t pos,
                                  int64_t mate_unclipped_start,
                                  int64_t mate_unclipped_end) {
  const int64_t read_length = cigar_read_len(c);
  const int64_t this_pos = static_cast<int64_t>(pos) + 1;
  if (flag & kFlagReverse) {
    if (this_pos <= mate_unclipped_start) {
      return read_pos_at_ref(c, this_pos, mate_unclipped_start, true);
    }
    const int64_t gap = this_pos - mate_unclipped_start;
    const int64_t v = cigar_leading_soft(c) - (gap > 0 ? gap : 0);
    return v > 0 ? v : 0;
  }
  const int64_t alignment_end = this_pos - 1 + cigar_ref_len(c);
  if (alignment_end >= mate_unclipped_end) {
    const int64_t bases_past =
        read_pos_at_ref(c, this_pos, mate_unclipped_end, false);
    const int64_t v = read_length - bases_past;
    return v > 0 ? v : 0;
  }
  const int64_t gap = mate_unclipped_end - alignment_end;
  const int64_t v = cigar_trailing_soft(c) - (gap > 0 ? gap : 0);
  return v > 0 ? v : 0;
}

// Size of a fixed-width aux value type, or 0 when variable/unknown.
inline int64_t tag_fixed_size(uint8_t typ) {
  switch (typ) {
    case 'A': case 'c': case 'C': return 1;
    case 's': case 'S': return 2;
    case 'i': case 'I': case 'f': return 4;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Decode fixed-offset fields for n records into struct-of-arrays outputs.
// rec_off[i] points at record i's 4-byte block_size prefix.
void fgumi_decode_fields(const uint8_t* buf, const int64_t* rec_off, long n,
                         int32_t* ref_id, int32_t* pos, int32_t* mapq,
                         int32_t* flag, int32_t* l_seq, int32_t* n_cigar,
                         int32_t* l_read_name, int32_t* next_ref_id,
                         int32_t* next_pos, int32_t* tlen, int64_t* data_off,
                         int64_t* data_end) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* r = buf + rec_off[i];
    const uint32_t block_size = read_u32(r);
    const uint8_t* d = r + 4;
    ref_id[i] = read_i32(d);
    pos[i] = read_i32(d + 4);
    l_read_name[i] = d[8];
    mapq[i] = d[9];
    n_cigar[i] = read_u16(d + 12);
    flag[i] = read_u16(d + 14);
    l_seq[i] = read_i32(d + 16);
    next_ref_id[i] = read_i32(d + 20);
    next_pos[i] = read_i32(d + 24);
    tlen[i] = read_i32(d + 28);
    data_off[i] = rec_off[i] + 4;
    data_end[i] = rec_off[i] + 4 + block_size;
  }
}

// Scan each record's aux TLV region for k 2-byte tags (tags = k*2 bytes).
// Outputs are row-major (n, k): val_off = byte offset of the value (-1 when
// missing), val_len = value length in bytes (Z/H: strlen excluding NUL),
// val_type = type char. A malformed TLV entry stops that record's scan
// (already-found tags are kept). Mirrors io/bam.py::_iter_tags (tags.rs:8-40).
void fgumi_scan_tags(const uint8_t* buf, const int64_t* aux_off,
                     const int64_t* aux_end, long n, const uint8_t* tags,
                     long k, int64_t* val_off, int32_t* val_len,
                     uint8_t* val_type) {
  for (long i = 0; i < n; ++i) {
    int64_t* vo = val_off + i * k;
    int32_t* vl = val_len + i * k;
    uint8_t* vt = val_type + i * k;
    for (long j = 0; j < k; ++j) {
      vo[j] = -1;
      vl[j] = 0;
      vt[j] = 0;
    }
    int64_t off = aux_off[i];
    const int64_t end = aux_end[i];
    long found = 0;
    while (off + 3 <= end && found < k) {
      const uint8_t t1 = buf[off];
      const uint8_t t2 = buf[off + 1];
      const uint8_t typ = buf[off + 2];
      off += 3;
      int64_t size = tag_fixed_size(typ);
      if (size == 0) {
        if (typ == 'Z' || typ == 'H') {
          const uint8_t* nul = static_cast<const uint8_t*>(
              std::memchr(buf + off, 0, static_cast<size_t>(end - off)));
          if (nul == nullptr) break;  // malformed: unterminated string
          size = (nul - (buf + off)) + 1;
        } else if (typ == 'B') {
          if (off + 5 > end) break;
          const int64_t esize = tag_fixed_size(buf[off]);
          if (esize == 0) break;
          size = 5 + esize * static_cast<int64_t>(read_u32(buf + off + 1));
        } else {
          break;  // unknown type: stop scanning this record
        }
      }
      if (off + size > end) break;
      for (long j = 0; j < k; ++j) {
        if (vo[j] < 0 && tags[2 * j] == t1 && tags[2 * j + 1] == t2) {
          vo[j] = off;
          vl[j] = static_cast<int32_t>(
              (typ == 'Z' || typ == 'H') ? size - 1 : size);
          vt[j] = typ;
          ++found;
        }
      }
      off += size;
    }
  }
}

// Group n records by equality of a byte range (e.g. an MI tag value or the
// CIGAR region): starts[g] = first record index of group g; returns the group
// count. A record with off < 0 (missing tag) returns -(i+1) so the caller can
// raise (iter_mi_groups raises on missing MI, core/grouper.py:38-41).
long fgumi_group_starts(const uint8_t* buf, const int64_t* off,
                        const int32_t* len, long n, int64_t* starts) {
  long g = 0;
  for (long i = 0; i < n; ++i) {
    if (off[i] < 0) return -(i + 1);
    if (i == 0 || len[i] != len[i - 1] ||
        std::memcmp(buf + off[i], buf + off[i - 1],
                    static_cast<size_t>(len[i])) != 0) {
      starts[g++] = i;
    }
  }
  return g;
}

// Batch SourceRead conversion (vanilla_caller.rs:940-1032 semantics; mirrors
// consensus/vanilla.py::_create_source_read with trim disabled): unpack 4-bit
// seq into base codes 0..4 + quals at codes/quals + i*stride, reverse-
// complement reverse-strand reads, mask q<min_q to N/Q2, clip `clip[i]` bases
// from the (oriented) end, trim trailing Ns. final_len[i] = surviving length,
// -1 for rejected reads (empty or all-0xFF quals). Row tails are padded N/0.
void fgumi_pack_reads(const uint8_t* buf, const int64_t* seq_off,
                      const int64_t* qual_off, const int32_t* l_seq,
                      const uint8_t* reverse, const int32_t* clip, long n,
                      int min_q, long stride, int mode, uint8_t* codes,
                      uint8_t* quals, int32_t* final_len) {
  // mode bit0: keep all-0xFF-quality reads (no -1 rejection); bit1: keep
  // trailing Ns (no final-length trim) — the CODEC SourceRead conversion
  // (codec_caller.rs:467-532) does neither of the vanilla post-steps.
  for (long i = 0; i < n; ++i) {
    uint8_t* crow = codes + i * stride;
    uint8_t* qrow = quals + i * stride;
    int64_t read_len = l_seq[i];
    if (read_len > stride) read_len = stride;
    if (read_len <= 0) {
      final_len[i] = -1;
      std::memset(crow, 4, static_cast<size_t>(stride));
      std::memset(qrow, 0, static_cast<size_t>(stride));
      continue;
    }
    const uint8_t* packed = buf + seq_off[i];
    const uint8_t* q = buf + qual_off[i];
    bool all_ff = (mode & 1) == 0;
    for (int64_t j = 0; all_ff && j < read_len; ++j) {
      if (q[j] != 0xFF) all_ff = false;
    }
    if (all_ff) {
      final_len[i] = -1;
      std::memset(crow, 4, static_cast<size_t>(stride));
      std::memset(qrow, 0, static_cast<size_t>(stride));
      continue;
    }
    if (reverse[i]) {
      // write reverse-complemented: output j <- input read_len-1-j
      for (int64_t j = 0; j < read_len; ++j) {
        const int64_t src = read_len - 1 - j;
        const uint8_t nib =
            (src & 1) ? (packed[src >> 1] & 0xF) : (packed[src >> 1] >> 4);
        const uint8_t code = kNib2Code[nib];
        crow[j] = code < 4 ? static_cast<uint8_t>(3 - code) : 4;
        qrow[j] = q[src];
      }
    } else {
      for (int64_t j = 0; j < read_len; ++j) {
        const uint8_t nib =
            (j & 1) ? (packed[j >> 1] & 0xF) : (packed[j >> 1] >> 4);
        crow[j] = kNib2Code[nib];
        qrow[j] = q[j];
      }
    }
    for (int64_t j = 0; j < read_len; ++j) {
      if (qrow[j] < min_q) {
        crow[j] = 4;
        qrow[j] = 2;
      }
    }
    int64_t final_n = read_len - clip[i];
    if (final_n < 0) final_n = 0;
    if (!(mode & 2)) {
      while (final_n > 0 && crow[final_n - 1] == 4) --final_n;
    }
    final_len[i] = static_cast<int32_t>(final_n);
    if (final_n < stride) {
      std::memset(crow + final_n, 4, static_cast<size_t>(stride - final_n));
      std::memset(qrow + final_n, 0, static_cast<size_t>(stride - final_n));
    }
  }
}

// Batch mate-overlap clip counts (overlap.rs:117-140 via the MC tag; mirrors
// core/overlap.py::num_bases_extending_past_mate). mc_off/mc_len locate each
// record's MC tag value (-1 = absent -> clip 0).
void fgumi_mate_clips(const uint8_t* buf, const int64_t* cigar_off,
                      const int32_t* n_cigar, const int32_t* flag,
                      const int32_t* ref_id, const int32_t* pos,
                      const int32_t* next_ref_id, const int32_t* next_pos,
                      const int32_t* tlen, const int64_t* mc_off,
                      const int32_t* mc_len, long n, int32_t* clip) {
  for (long i = 0; i < n; ++i) {
    clip[i] = 0;
    const CigarView c{buf + cigar_off[i], n_cigar[i]};
    if (!is_fr_pair(flag[i], ref_id[i], next_ref_id[i], pos[i], next_pos[i],
                    tlen[i], c)) {
      continue;
    }
    if (mc_off[i] < 0) continue;
    int64_t lead = 0, rlen = 0, trail = 0;
    if (!parse_mc_cigar(buf + mc_off[i], mc_len[i], &lead, &rlen, &trail)) {
      continue;
    }
    const int64_t mate_pos = static_cast<int64_t>(next_pos[i]) + 1;
    clip[i] = static_cast<int32_t>(bases_extending_past_mate(
        c, flag[i], pos[i], mate_pos - lead, mate_pos - 1 + rlen + trail));
  }
}

// In-place overlapping-pair base correction on the chunk buffer (mirrors
// consensus/overlapping.py::OverlappingBasesConsensusCaller.call; reference
// overlapping.rs:80-345). r1_off/r2_off are the paired records' data offsets
// (post-block_size). agreement: 0=consensus 1=max-qual 2=pass-through;
// disagreement: 0=consensus 1=mask-both 2=mask-lower-qual. stats (int64[4]):
// overlapping, agreeing, disagreeing, corrected.
void fgumi_overlap_correct_pairs(uint8_t* buf, const int64_t* r1_off,
                                 const int64_t* r2_off, long n_pairs,
                                 int agreement, int disagreement,
                                 int64_t* stats) {
  for (long p = 0; p < n_pairs; ++p) {
    const uint8_t* d1 = buf + r1_off[p];
    const uint8_t* d2 = buf + r2_off[p];
    const int32_t flag1 = read_u16(d1 + 14), flag2 = read_u16(d2 + 14);
    if ((flag1 | flag2) & kFlagUnmapped) continue;
    if (read_i32(d1) != read_i32(d2)) continue;  // ref_id mismatch
    const int32_t n_cig1 = read_u16(d1 + 12), n_cig2 = read_u16(d2 + 12);
    const int32_t l_seq1 = read_i32(d1 + 16), l_seq2 = read_i32(d2 + 16);
    const int64_t cig1_off = 32 + d1[8], cig2_off = 32 + d2[8];
    const CigarView c1{d1 + cig1_off, n_cig1};
    const CigarView c2{d2 + cig2_off, n_cig2};
    if (cigar_ref_len(c1) == 0 || cigar_ref_len(c2) == 0) continue;
    uint8_t* seq1 = buf + r1_off[p] + cig1_off + 4 * n_cig1;
    uint8_t* seq2 = buf + r2_off[p] + cig2_off + 4 * n_cig2;
    uint8_t* q1 = seq1 + (l_seq1 + 1) / 2;
    uint8_t* q2 = seq2 + (l_seq2 + 1) / 2;

    // Merge-walk the two reads' aligned (ref_pos, read_off) streams
    // (ReadMateAndRefPosIterator, overlapping.rs:560-620).
    int32_t i1 = 0, i2 = 0;            // cigar op indices
    int64_t ref1 = read_i32(d1 + 4) + 1, ref2 = read_i32(d2 + 4) + 1;
    int64_t off1 = 0, off2 = 0;        // read offsets
    int64_t rem1 = 0, rem2 = 0;        // remaining bases in current align op

    auto advance = [](const CigarView& c, int32_t& i, int64_t& ref_pos,
                      int64_t& read_off, int64_t& rem) {
      // position at the next aligned base; rem = bases left in this op
      while (rem == 0 && i < c.n) {
        const uint32_t op = c.op(i);
        const int64_t len = c.len(i);
        if (op_is_align(op)) {
          rem = len;
        } else if (op == 1 || op == 4) {  // I S
          read_off += len;
        } else if (op == 2 || op == 3) {  // D N
          ref_pos += len;
        }
        ++i;
      }
      return rem > 0;
    };

    while (true) {
      if (!advance(c1, i1, ref1, off1, rem1)) break;
      if (!advance(c2, i2, ref2, off2, rem2)) break;
      if (ref1 < ref2) {
        const int64_t skip = ref2 - ref1 < rem1 ? ref2 - ref1 : rem1;
        ref1 += skip; off1 += skip; rem1 -= skip;
        continue;
      }
      if (ref2 < ref1) {
        const int64_t skip = ref1 - ref2 < rem2 ? ref1 - ref2 : rem2;
        ref2 += skip; off2 += skip; rem2 -= skip;
        continue;
      }
      // ref1 == ref2: one overlapping aligned base
      const int64_t o1 = off1, o2 = off2;
      ref1 += 1; off1 += 1; rem1 -= 1;
      ref2 += 1; off2 += 1; rem2 -= 1;
      const uint8_t nib1 =
          (o1 & 1) ? (seq1[o1 >> 1] & 0xF) : (seq1[o1 >> 1] >> 4);
      const uint8_t nib2 =
          (o2 & 1) ? (seq2[o2 >> 1] & 0xF) : (seq2[o2 >> 1] >> 4);
      if (nib1 == 15 || nib2 == 15) continue;  // no-call skipped entirely
      ++stats[0];
      const int32_t qa = q1[o1], qb = q2[o2];
      auto write_nib = [](uint8_t* seq, int64_t o, uint8_t nib) {
        if (o & 1) {
          seq[o >> 1] = (seq[o >> 1] & 0xF0) | nib;
        } else {
          seq[o >> 1] = (seq[o >> 1] & 0x0F) | (nib << 4);
        }
      };
      if (nib1 == nib2) {
        ++stats[1];
        if (agreement == 2) continue;  // pass-through
        const int32_t new_q =
            agreement == 0 ? (qa + qb < 93 ? qa + qb : 93)
                           : (qa > qb ? qa : qb);
        if (new_q != qa || new_q != qb) ++stats[3];
        q1[o1] = static_cast<uint8_t>(new_q);
        q2[o2] = static_cast<uint8_t>(new_q);
      } else {
        ++stats[2];
        if (disagreement == 0) {  // consensus: higher qual wins by difference
          if (qa == qb) {
            write_nib(seq1, o1, 15);
            write_nib(seq2, o2, 15);
            q1[o1] = 2;
            q2[o2] = 2;
          } else {
            const uint8_t win_nib = qa > qb ? nib1 : nib2;
            const int32_t dq = qa > qb ? qa - qb : qb - qa;
            const uint8_t new_q = static_cast<uint8_t>(dq > 2 ? dq : 2);
            write_nib(seq1, o1, win_nib);
            write_nib(seq2, o2, win_nib);
            q1[o1] = new_q;
            q2[o2] = new_q;
          }
          stats[3] += 2;
        } else if (disagreement == 1) {  // mask-both
          write_nib(seq1, o1, 15);
          write_nib(seq2, o2, 15);
          q1[o1] = 2;
          q2[o2] = 2;
          stats[3] += 2;
        } else {  // mask-lower-qual; tie masks both
          if (qa <= qb) {
            write_nib(seq1, o1, 15);
            q1[o1] = 2;
            ++stats[3];
          }
          if (qb <= qa) {
            write_nib(seq2, o2, 15);
            q2[o2] = 2;
            ++stats[3];
          }
        }
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fast group engine and UMI assigners.
// ---------------------------------------------------------------------------

extern "C" {

// Per-range UMI scan: has_n = contains 'N'/'n', bases = byte length minus
// '-' separators (commands/group.py::_umi_base_count), ascii = no high-bit
// bytes (non-ASCII UMIs take the per-template path: their decoded character
// count can differ from the byte count). off < 0 -> (0, -1, 1).
void fgumi_umi_scan(const uint8_t* buf, const int64_t* off,
                    const int32_t* len, long n, uint8_t* has_n,
                    int32_t* bases, uint8_t* ascii) {
  for (long i = 0; i < n; ++i) {
    if (off[i] < 0) {
      has_n[i] = 0;
      bases[i] = -1;
      ascii[i] = 1;
      continue;
    }
    const uint8_t* p = buf + off[i];
    uint8_t nn = 0, asc = 1;
    int32_t dashes = 0;
    for (int32_t k = 0; k < len[i]; ++k) {
      const uint8_t c = p[k];
      nn |= (c == 'N') | (c == 'n');
      asc &= c < 0x80;
      dashes += c == '-';
    }
    has_n[i] = nn;
    bases[i] = len[i] - dashes;
    ascii[i] = asc;
  }
}

// Concatenate spans drawn from up to 8 source buffers (addresses in
// src_addrs) into one output blob. Zero-length spans are legal. Returns the
// total bytes; out_off gets n_spans + 1 offsets.
long fgumi_concat_spans(const int64_t* src_addrs, const int32_t* src_id,
                        const int64_t* off, const int32_t* len, long n_spans,
                        uint8_t* out, int64_t* out_off) {
  int64_t o = 0;
  out_off[0] = 0;
  for (long i = 0; i < n_spans; ++i) {
    const int32_t l = len[i];
    if (l > 0) {
      const uint8_t* src =
          reinterpret_cast<const uint8_t*>(src_addrs[src_id[i]]);
      std::memcpy(out + o, src + off[i], static_cast<size_t>(l));
      o += l;
    }
    out_off[i + 1] = o;
  }
  return o;
}

// Batch unclipped 5' positions (core/template.py::unclipped_5prime):
// forward reads -> unclipped start (pos - leading S/H), reverse -> unclipped
// end (pos + ref_len - 1 + trailing S/H). Unmapped records get pos as-is
// (callers sentinel them by flag).
void fgumi_unclipped_5prime(const uint8_t* buf, const int64_t* cigar_off,
                            const int32_t* n_cigar, const int32_t* flag,
                            const int32_t* pos, long n, int64_t* out) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* cp = buf + cigar_off[i];
    const int32_t nc = n_cigar[i];
    if (flag[i] & 0x10) {
      int64_t rlen = 0, trail = 0;
      for (int32_t k = 0; k < nc; ++k) {
        const uint32_t v = read_u32(cp + 4 * k);
        const uint32_t op = v & 0xF;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8)
          rlen += v >> 4;
      }
      for (int32_t k = nc - 1; k >= 0; --k) {
        const uint32_t v = read_u32(cp + 4 * k);
        const uint32_t op = v & 0xF;
        if (op == 4 || op == 5) trail += v >> 4; else break;
      }
      out[i] = pos[i] + rlen - 1 + trail;
    } else {
      int64_t lead = 0;
      for (int32_t k = 0; k < nc; ++k) {
        const uint32_t v = read_u32(cp + 4 * k);
        const uint32_t op = v & 0xF;
        if (op == 4 || op == 5) lead += v >> 4; else break;
      }
      out[i] = pos[i] - lead;
    }
  }
}

// Rewrite records with one tag replaced: every existing occurrence of `tag`
// is removed from the aux region (any type; RawRecord.data_without_tag
// semantics) and a fresh Z-typed value appended, each record emitted as
// block_size-prefixed wire bytes, packed contiguously into `out` (sized for
// the worst case sum(data_len + 8 + val_len)). Returns the total bytes
// written, or -1 - i on a malformed aux region in record i (the caller
// reroutes through the per-record Python editor).
long fgumi_rewrite_tag_records(
    const uint8_t* buf, const int64_t* data_off, const int64_t* data_end,
    const int64_t* aux_off, long n, uint8_t t1, uint8_t t2,
    const uint8_t* val_blob, const int64_t* val_off, const int32_t* val_len,
    const int32_t* new_flag, uint8_t* out) {
  int64_t total = 0;
  for (long i = 0; i < n; ++i) {
    uint8_t* dst = out + total + 4;
    const uint8_t* src = buf + data_off[i];
    const int64_t aux0 = aux_off[i] - data_off[i];
    const int64_t dlen = data_end[i] - data_off[i];
    // fixed header + name/cigar/seq/qual copied verbatim
    std::memcpy(dst, src, static_cast<size_t>(aux0));
    int64_t w = aux0;
    int64_t off = aux0;
    bool ok = true;
    while (off + 3 <= dlen) {
      const uint8_t a = src[off];
      const uint8_t b = src[off + 1];
      const uint8_t typ = src[off + 2];
      int64_t size = tag_fixed_size(typ);
      if (size == 0) {
        if (typ == 'Z' || typ == 'H') {
          const uint8_t* nul = static_cast<const uint8_t*>(std::memchr(
              src + off + 3, 0, static_cast<size_t>(dlen - off - 3)));
          if (nul == nullptr) { ok = false; break; }
          size = (nul - (src + off + 3)) + 1;
        } else if (typ == 'B') {
          if (off + 8 > dlen) { ok = false; break; }
          const int64_t esize = tag_fixed_size(src[off + 3]);
          if (esize == 0) { ok = false; break; }
          size = 5 + esize * static_cast<int64_t>(read_u32(src + off + 4));
        } else {
          ok = false;
          break;
        }
      }
      if (off + 3 + size > dlen) { ok = false; break; }
      if (!(a == t1 && b == t2)) {
        std::memcpy(dst + w, src + off, static_cast<size_t>(3 + size));
        w += 3 + size;
      }
      off += 3 + size;
    }
    if (!ok || off != dlen) return -1 - i;
    dst[w] = t1;
    dst[w + 1] = t2;
    dst[w + 2] = 'Z';
    std::memcpy(dst + w + 3, val_blob + val_off[i],
                static_cast<size_t>(val_len[i]));
    w += 3 + val_len[i];
    dst[w++] = 0;
    // dedup's duplicate flag: a row's new FLAG (-1 or no array: kept)
    if (new_flag != nullptr && new_flag[i] >= 0) {
      put_u16(dst + 14, static_cast<uint16_t>(new_flag[i]));
    }
    put_u32(out + total, static_cast<uint32_t>(w));
    total += 4 + w;
  }
  return total;
}

// Candidate UMI pairs with hamming(A[i], B[j]) <= d over (n, L)/(m, L) byte
// matrices, via the d+1-part pigeonhole (umi/assigners.py
// _pigeonhole_pairs): any pair within distance d agrees exactly on at least
// one of d+1 disjoint column chunks. B == A (same pointer) emits each
// unordered pair once (i < j); otherwise all cross pairs with i != j. A
// pair is emitted only from the first chunk it agrees on, so the output
// holds no duplicate. Returns the pair count; only the first `cap` pairs
// are written (the caller retries with a larger buffer when count > cap).
long fgumi_umi_neighbor_pairs(const uint8_t* A, long n, const uint8_t* B,
                              long m, long L, int d, int64_t* out_i,
                              int64_t* out_j, long cap) {
  const bool same = (A == B);
  const int parts = d + 1 <= static_cast<int>(L) ? d + 1 : static_cast<int>(L);
  if (parts <= 0) return 0;
  // np.array_split sizing: the first (L % parts) chunks get one extra column
  std::vector<long> p_lo(static_cast<size_t>(parts) + 1, 0);
  {
    const long base = L / parts;
    const long extra = L % parts;
    for (int p = 0; p < parts; ++p) {
      p_lo[static_cast<size_t>(p) + 1] =
          p_lo[static_cast<size_t>(p)] + base + (p < extra ? 1 : 0);
    }
  }
  auto ham_le = [&](const uint8_t* a, const uint8_t* b) {
    int miss = 0;
    for (long c = 0; c < L; ++c) {
      miss += (a[c] != b[c]);
      if (miss > d) return false;
    }
    return true;
  };
  auto chunk_eq = [&](const uint8_t* a, const uint8_t* b, int p) {
    const long lo = p_lo[static_cast<size_t>(p)];
    const long hi = p_lo[static_cast<size_t>(p) + 1];
    return std::memcmp(a + lo, b + lo, static_cast<size_t>(hi - lo)) == 0;
  };
  auto first_part = [&](const uint8_t* ra, const uint8_t* rb, int p) {
    for (int q = 0; q < p; ++q) {
      if (chunk_eq(ra, rb, q)) return false;
    }
    return true;
  };
  long count = 0;
  auto emit = [&](long i, long j) {
    if (count < cap) {
      out_i[count] = i;
      out_j[count] = j;
    }
    ++count;
  };
  std::vector<int64_t> ob(static_cast<size_t>(m));
  std::vector<int64_t> oa;
  for (int p = 0; p < parts; ++p) {
    const long clo = p_lo[static_cast<size_t>(p)];
    const size_t clen =
        static_cast<size_t>(p_lo[static_cast<size_t>(p) + 1] - clo);
    auto bkey = [&](long x) { return B + ob[static_cast<size_t>(x)] * L + clo; };
    for (long r = 0; r < m; ++r) ob[static_cast<size_t>(r)] = r;
    std::sort(ob.begin(), ob.end(), [&](int64_t x, int64_t y) {
      const int c = std::memcmp(B + x * L + clo, B + y * L + clo, clen);
      return c < 0 || (c == 0 && x < y);
    });
    if (same) {
      for (long s = 0; s < m;) {
        long e = s + 1;
        while (e < m && std::memcmp(bkey(s), bkey(e), clen) == 0) ++e;
        for (long x = s; x < e; ++x) {
          for (long y = x + 1; y < e; ++y) {
            const long i = static_cast<long>(ob[static_cast<size_t>(x)]);
            const long j = static_cast<long>(ob[static_cast<size_t>(y)]);
            const uint8_t* ra = A + i * L;
            const uint8_t* rb = A + j * L;
            if (ham_le(ra, rb) && first_part(ra, rb, p)) {
              emit(i < j ? i : j, i < j ? j : i);
            }
          }
        }
        s = e;
      }
    } else {
      // cross case (the paired strategy's reversed rows): bucket B, probe
      // with each bucket of A
      oa.resize(static_cast<size_t>(n));
      for (long r = 0; r < n; ++r) oa[static_cast<size_t>(r)] = r;
      std::sort(oa.begin(), oa.end(), [&](int64_t x, int64_t y) {
        const int c = std::memcmp(A + x * L + clo, A + y * L + clo, clen);
        return c < 0 || (c == 0 && x < y);
      });
      long bs = 0;
      for (long as = 0; as < n;) {
        long ae = as + 1;
        const uint8_t* akey = A + oa[static_cast<size_t>(as)] * L + clo;
        while (ae < n && std::memcmp(
                             akey, A + oa[static_cast<size_t>(ae)] * L + clo,
                             clen) == 0) {
          ++ae;
        }
        while (bs < m && std::memcmp(bkey(bs), akey, clen) < 0) ++bs;
        long be = bs;
        while (be < m && std::memcmp(bkey(be), akey, clen) == 0) ++be;
        for (long x = as; x < ae; ++x) {
          for (long y = bs; y < be; ++y) {
            const long i = static_cast<long>(oa[static_cast<size_t>(x)]);
            const long j = static_cast<long>(ob[static_cast<size_t>(y)]);
            if (i == j) continue;
            const uint8_t* ra = A + i * L;
            const uint8_t* rb = B + j * L;
            if (ham_le(ra, rb) && first_part(ra, rb, p)) emit(i, j);
          }
        }
        as = ae;
      }
    }
  }
  return count;
}

// UMI-tools directed adjacency BFS over flattened neighbour lists
// (umi/assigners.py _adjacency_bfs). Nodes are sorted by (-count, string);
// neighbours(i) = nbr_flat[nbr_start[i]:nbr_start[i+1]], ascending.
// root_of[i] receives the component root index.
void fgumi_adjacency_bfs(const int64_t* nbr_flat, const int64_t* nbr_start,
                         const int64_t* counts, long n, int64_t* root_of) {
  std::vector<uint8_t> assigned(static_cast<size_t>(n), 0);
  std::vector<int64_t> queue;
  queue.reserve(64);
  for (long root = 0; root < n; ++root) {
    if (assigned[static_cast<size_t>(root)]) continue;
    assigned[static_cast<size_t>(root)] = 1;
    root_of[root] = root;
    queue.clear();
    queue.push_back(root);
    size_t head = 0;
    while (head < queue.size()) {
      const int64_t idx = queue[head++];
      const int64_t max_child = counts[idx] / 2 + 1;
      for (int64_t t = nbr_start[idx]; t < nbr_start[idx + 1]; ++t) {
        const int64_t child = nbr_flat[t];
        if (!assigned[static_cast<size_t>(child)] &&
            counts[child] <= max_child) {
          assigned[static_cast<size_t>(child)] = 1;
          root_of[child] = root_of[idx];
          queue.push_back(child);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The fast filter engine's batch passes (commands/fast_filter.py).
// ---------------------------------------------------------------------------

// Sum of the qualities >= min_q per record, capped at `cap` (the filter's
// full-length mean quality reads it with min_q 0).
void fgumi_qual_scores(const uint8_t* buf, const int64_t* qual_off,
                       const int32_t* l_seq, long n, int min_q, long cap,
                       int32_t* out) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* q = buf + qual_off[i];
    int64_t s = 0;
    for (int32_t k = 0; k < l_seq[i]; ++k) {
      if (q[k] >= min_q) s += q[k];
    }
    out[i] = static_cast<int32_t>(s < cap ? s : cap);
  }
}

// Gather B:s/B:S per-base tag arrays into a dense (n, L) uint16 matrix,
// zero-padded or truncated to L (consensus/filter.py::_per_base_padded).
// val_off points at the B value's subtype byte; out_count[i] is the array's
// element count, -1 where the tag is absent (val_off < 0) and -2 for any
// other subtype (the caller re-runs the per-record route).
void fgumi_gather_u16_arrays(const uint8_t* buf, const int64_t* val_off,
                             long n, long L, uint16_t* out,
                             int32_t* out_count) {
  std::memset(out, 0, static_cast<size_t>(n) * L * 2);
  for (long i = 0; i < n; ++i) {
    if (val_off[i] < 0) {
      out_count[i] = -1;
      continue;
    }
    const uint8_t* p = buf + val_off[i];
    const uint8_t sub = p[0];
    if (sub != 's' && sub != 'S') {
      out_count[i] = -2;
      continue;
    }
    const uint32_t count = read_u32(p + 1);
    const long take = static_cast<long>(count) < L ? count : L;
    uint16_t* row = out + i * L;
    for (long k = 0; k < take; ++k) row[k] = read_u16(p + 5 + 2 * k);
    out_count[i] = static_cast<int32_t>(count);
  }
}

// Per-record base masks applied in place: a masked position becomes N
// (nibble 15) with quality 2. mask is a dense (n, L) uint8 matrix over each
// record's first l_seq positions. skip_existing_n = 1 leaves already-N
// positions alone (quality too); 0 rewrites their quality as well (the
// simplex mask_bases). newly[i] counts positions that were not N before,
// n_after[i] the N count after masking (the no-call check's input).
void fgumi_apply_masks(uint8_t* buf, const int64_t* seq_off,
                       const int64_t* qual_off, const int32_t* l_seq, long n,
                       const uint8_t* mask, long L, int skip_existing_n,
                       int32_t* newly, int32_t* n_after) {
  for (long i = 0; i < n; ++i) {
    uint8_t* seq = buf + seq_off[i];
    uint8_t* quals = buf + qual_off[i];
    const uint8_t* mrow = mask + i * L;
    const int32_t len = l_seq[i];
    int32_t fresh = 0, total_n = 0;
    for (int32_t k = 0; k < len; ++k) {
      const int shift = (k & 1) ? 0 : 4;
      uint8_t nib = (seq[k >> 1] >> shift) & 0xF;
      const bool was_n = nib == 15;
      if (mrow[k] && !(skip_existing_n && was_n)) {
        if (!was_n) ++fresh;
        seq[k >> 1] = static_cast<uint8_t>(
            (seq[k >> 1] & (0xF << ((k & 1) ? 4 : 0))) | (15u << shift));
        quals[k] = 2;
        nib = 15;
      }
      total_n += nib == 15;
    }
    newly[i] = fresh;
    n_after[i] = total_n;
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Batched FASTQ -> unmapped-BAM extraction (the hot half of `extract`).
// Reference analog: the FASTQ pipeline's Decode step and the
// UnmappedSamBuilder record assembly (extract.rs:887-980). One call
// consumes one aligned batch of records across all FASTQ inputs and emits
// block_size-prefixed BAM wire bytes with the common tag set (RG:Z, RX:Z,
// QX:Z); the other options (cell/sample barcodes, single-tag, name
// annotation, read-name UMIs) take the per-record route
// (commands/extract.py Extractor.make_records).
//
// Segments: flattened read-structure ops in emission order. kind: 0=template
// 1=UMI(M) 2=skip(S). seg_len -1 means "rest of the read". UMI segments join
// with '-' (quals with ' ') across all inputs, fgbio style.
//
// Returns records written; negative = error: -1 out_cap too small,
// -2 read-name mismatch at state[1], -3 read too short at state[1],
// -4 read name too long at state[1]. state[0] = bytes written.
// ---------------------------------------------------------------------------

namespace {

struct NibInit {
  uint8_t t[256];
  NibInit() {
    // full BAM nibble alphabet "=ACMGRSVTWYHKDBN" (io/bam.py
    // BASE_TO_NIBBLE; unknown bytes encode as N)
    const char* alpha = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 256; ++i) t[i] = 15;
    for (int v = 0; v < 16; ++v) {
      t[static_cast<uint8_t>(alpha[v])] = static_cast<uint8_t>(v);
      t[static_cast<uint8_t>(alpha[v] | 0x20)] = static_cast<uint8_t>(v);
    }
  }
};
const NibInit kNib;

inline long strip_name(const uint8_t* name, long len) {
  long n = len;
  for (long i = 0; i < n; ++i) {
    if (name[i] == ' ' || name[i] == '\t') { n = i; break; }
  }
  if (n >= 2 && name[n - 2] == '/' && name[n - 1] >= '0' && name[n - 1] <= '9')
    n -= 2;
  return n;
}

}  // namespace

extern "C" {

long fgumi_extract_records(
    long n_inputs, long n_records, const int64_t* buf_addr,
    const int64_t* name_off, const int32_t* name_len, const int64_t* seq_off,
    const int32_t* seq_len, const int64_t* qual_off, long n_segs,
    const int32_t* seg_input, const int32_t* seg_kind, const int32_t* seg_len,
    int qual_offset, const uint8_t* rg, int rg_len, int store_umi_quals,
    uint8_t* out, long out_cap, int64_t* state) {
  long off = 0;
  uint8_t umi[1024];
  uint8_t umiq[1024];
  const uint8_t* tmpl_seq[8];
  const uint8_t* tmpl_qual[8];
  long tmpl_len[8];

  for (long r = 0; r < n_records; ++r) {
    // stripped-name agreement across inputs
    const uint8_t* name0 =
        reinterpret_cast<const uint8_t*>(buf_addr[0]) + name_off[r];
    long n0 = strip_name(name0, name_len[r]);
    for (long k = 1; k < n_inputs; ++k) {
      const uint8_t* nk = reinterpret_cast<const uint8_t*>(buf_addr[k]) +
                          name_off[k * n_records + r];
      long lk = strip_name(nk, name_len[k * n_records + r]);
      if (lk != n0 || memcmp(nk, name0, n0) != 0) {
        state[1] = r;
        return -2;
      }
    }

    // walk segments
    long umi_len = 0, umiq_len = 0, n_tmpl = 0;
    long cursor[8] = {0};
    for (long s = 0; s < n_segs; ++s) {
      const long k = seg_input[s];
      const long idx = k * n_records + r;
      const uint8_t* sbuf =
          reinterpret_cast<const uint8_t*>(buf_addr[k]) + seq_off[idx];
      const uint8_t* qbuf =
          reinterpret_cast<const uint8_t*>(buf_addr[k]) + qual_off[idx];
      const long total = seq_len[idx];
      long len = seg_len[s];
      if (len < 0) {
        len = total - cursor[k];
        if (len < 0) len = 0;
      } else if (cursor[k] + len > total) {
        state[1] = r;
        return -3;
      }
      const long at = cursor[k];
      cursor[k] += len;
      if (seg_kind[s] == 1) {  // UMI
        if (umi_len + len + 1 > static_cast<long>(sizeof(umi))) {
          state[1] = r;
          return -3;
        }
        if (umi_len) { umi[umi_len++] = '-'; umiq[umiq_len++] = ' '; }
        memcpy(umi + umi_len, sbuf + at, len);
        umi_len += len;
        memcpy(umiq + umiq_len, qbuf + at, len);
        umiq_len += len;
      } else if (seg_kind[s] == 0) {  // template
        if (n_tmpl >= 8) { state[1] = r; return -3; }
        tmpl_seq[n_tmpl] = sbuf + at;
        tmpl_qual[n_tmpl] = qbuf + at;
        tmpl_len[n_tmpl] = len;
        ++n_tmpl;
      }  // skip: nothing
    }

    // emit one record per template
    for (long t = 0; t < n_tmpl; ++t) {
      const uint8_t* seq = tmpl_seq[t];
      const uint8_t* qual = tmpl_qual[t];
      long L = tmpl_len[t];
      const uint8_t one_n[1] = {'N'};
      int empty = (L == 0);
      if (empty) { seq = one_n; L = 1; }  // qual emitted as literal Q2 below

      uint32_t flag = 0x4;  // unmapped
      if (n_tmpl == 2)
        flag |= 0x1u | 0x8u | (t == 0 ? 0x40u : 0x80u);

      const long nlen = n0;
      if (nlen + 1 > 255) {  // l_read_name is u8 (RecordBuilder parity)
        state[1] = r;
        return -4;
      }
      long need = 4 + 32 + nlen + 1 + (L + 1) / 2 + L;
      need += 3 + rg_len + 1;
      if (umi_len) need += 3 + umi_len + 1;
      if (umi_len && store_umi_quals) need += 3 + umiq_len + 1;
      if (off + need > out_cap) return -1;

      uint8_t* rec = out + off + 4;
      put_u32(rec + 0, 0xFFFFFFFFu);
      put_u32(rec + 4, 0xFFFFFFFFu);
      rec[8] = static_cast<uint8_t>(nlen + 1);
      rec[9] = 0;                    // mapq
      rec[10] = 0x48;                // bin 4680 lo
      rec[11] = 0x12;                // bin 4680 hi
      rec[12] = 0;                   // n_cigar lo
      rec[13] = 0;
      rec[14] = static_cast<uint8_t>(flag & 0xFF);
      rec[15] = static_cast<uint8_t>(flag >> 8);
      put_u32(rec + 16, static_cast<uint32_t>(L));
      put_u32(rec + 20, 0xFFFFFFFFu);
      put_u32(rec + 24, 0xFFFFFFFFu);
      put_u32(rec + 28, 0);
      uint8_t* p = rec + 32;
      memcpy(p, name0, nlen);
      p += nlen;
      *p++ = 0;
      // 4-bit packed sequence
      for (long i = 0; i + 1 < L; i += 2)
        *p++ = static_cast<uint8_t>((kNib.t[seq[i]] << 4) | kNib.t[seq[i + 1]]);
      if (L & 1) *p++ = static_cast<uint8_t>(kNib.t[seq[L - 1]] << 4);
      // saturating qual subtract (extract.rs:256-261)
      if (empty) {
        *p++ = 2;
      } else {
        for (long i = 0; i < L; ++i)
          *p++ = qual[i] >= qual_offset
                     ? static_cast<uint8_t>(qual[i] - qual_offset)
                     : 0;
      }
      // tags
      p[0] = 'R'; p[1] = 'G'; p[2] = 'Z';
      memcpy(p + 3, rg, rg_len);
      p += 3 + rg_len;
      *p++ = 0;
      if (umi_len) {
        p[0] = 'R'; p[1] = 'X'; p[2] = 'Z';
        memcpy(p + 3, umi, umi_len);
        p += 3 + umi_len;
        *p++ = 0;
        if (store_umi_quals) {
          p[0] = 'Q'; p[1] = 'X'; p[2] = 'Z';
          memcpy(p + 3, umiq, umiq_len);
          p += 3 + umiq_len;
          *p++ = 0;
        }
      }
      const long rec_len = p - rec;
      put_u32(out + off, static_cast<uint32_t>(rec_len));
      off += 4 + rec_len;
    }
  }
  state[0] = off;
  return n_records;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Template-coordinate sort keys and the external sort engine.
// ---------------------------------------------------------------------------

namespace {

inline void put_u32_be(uint8_t* p, uint32_t v) {
  p[0] = v >> 24;
  p[1] = (v >> 16) & 0xFF;
  p[2] = (v >> 8) & 0xFF;
  p[3] = v & 0xFF;
}

inline void put_u64_be(uint8_t* p, uint64_t v) {
  for (int i = 0; i < 8; ++i) p[i] = (v >> (56 - 8 * i)) & 0xFF;
}

}  // namespace

extern "C" {

// Batch template-coordinate sort keys (sort/keys.py::
// template_coordinate_key_bytes; reference fgumi-sort/src/inline.rs
// TemplateKey). Writes each record's packed key at out + out_off[i]
// (28 + name_len bytes: 16B ends, 2B strand, 2B library, 8B MI value,
// 1B MI sub, name, NUL, is_upper). Returns 0.
long fgumi_template_coord_keys(
    const uint8_t* buf, const int64_t* data_off, const int32_t* l_read_name,
    const int64_t* cigar_off, const int32_t* n_cigar, const int32_t* flag,
    const int32_t* ref_id, const int32_t* pos, const int32_t* next_ref_id,
    const int32_t* next_pos, const int64_t* mc_off, const int32_t* mc_len,
    const int64_t* mi_off, const int32_t* mi_len, const int32_t* lib_ord,
    long n, uint8_t* out, const int64_t* out_off) {
  const int64_t kTidUnmapped = 1LL << 31;
  const int64_t kPosSentinel = 0x7FFFFFFFLL;
  const uint32_t kPosBias = 0x40000000u;
  for (long i = 0; i < n; ++i) {
    const int32_t f = flag[i];
    // own end (keys.py::_own_end): unclipped 5' position, 1-based
    int64_t own_tid, own_pos;
    bool own_rev = false;
    if (f & 0x4) {
      own_tid = kTidUnmapped;
      own_pos = kPosSentinel;
    } else {
      own_tid = ref_id[i];
      own_rev = (f & 0x10) != 0;
      const uint8_t* cp = buf + cigar_off[i];
      const int32_t nc = n_cigar[i];
      int64_t lead = 0, trail = 0, rlen = 0;
      for (int32_t k = 0; k < nc; ++k) {
        uint32_t v;
        std::memcpy(&v, cp + 4 * k, 4);
        const uint32_t op = v & 0xF;
        const int64_t ln = v >> 4;
        if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) rlen += ln;
      }
      for (int32_t k = 0; k < nc; ++k) {
        uint32_t v;
        std::memcpy(&v, cp + 4 * k, 4);
        const uint32_t op = v & 0xF;
        if (op == 4 || op == 5) lead += v >> 4; else break;
      }
      for (int32_t k = nc - 1; k >= 0; --k) {
        uint32_t v;
        std::memcpy(&v, cp + 4 * k, 4);
        const uint32_t op = v & 0xF;
        if (op == 4 || op == 5) trail += v >> 4; else break;
      }
      const int64_t un_start = pos[i] - lead;
      const int64_t un_end = pos[i] + rlen - 1 + trail;
      own_pos = (own_rev ? un_end : un_start) + 1;
    }
    // mate end (keys.py::_mate_end) via the MC tag
    int64_t mate_tid, mate_pos;
    bool mate_rev = false;
    if (!(f & 0x1) || (f & 0x8) || next_ref_id[i] < 0) {
      mate_tid = kTidUnmapped;
      mate_pos = kPosSentinel;
    } else {
      mate_tid = next_ref_id[i];
      mate_rev = (f & 0x20) != 0;
      int64_t lead = 0, rlen = 0, trail = 0;
      if (mc_off[i] >= 0) {
        int64_t l2, r2, t2;
        if (parse_mc_cigar(buf + mc_off[i], mc_len[i], &l2, &r2, &t2)) {
          lead = l2;
          rlen = r2;
          trail = t2;
        }
      }
      const int64_t mp1 = next_pos[i] + 1;
      mate_pos = mate_rev ? (mp1 - 1 + (rlen > 1 ? rlen : 1) - 1 + trail + 1)
                          : (mp1 - lead);
    }
    // tuple compare (tid, pos, rev): lower end first
    bool own_low =
        (own_tid != mate_tid) ? (own_tid < mate_tid)
        : (own_pos != mate_pos) ? (own_pos < mate_pos)
                                : (own_rev <= mate_rev);
    int64_t tid1, tid2, pos1, pos2;
    bool neg1, neg2;
    uint8_t is_upper;
    if (own_low) {
      tid1 = own_tid; pos1 = own_pos; neg1 = own_rev;
      tid2 = mate_tid; pos2 = mate_pos; neg2 = mate_rev;
      is_upper = 0;
    } else {
      tid1 = mate_tid; pos1 = mate_pos; neg1 = mate_rev;
      tid2 = own_tid; pos2 = own_pos; neg2 = own_rev;
      is_upper = 1;
    }
    // MI value (external.py::_mi_key): int() of the prefix before '/'
    // (optional surrounding ASCII whitespace and sign; negatives clamp to
    // 0), suffix 'A' -> 0, anything else (incl. no suffix) -> 1; absent or
    // non-string tag -> (0, 0)
    uint64_t mi_val = 0;
    uint8_t mi_sub = 0;
    if (mi_off[i] >= 0) {
      const uint8_t* mp = buf + mi_off[i];
      const int32_t ml = mi_len[i];
      int32_t slash = 0;
      while (slash < ml && mp[slash] != '/') ++slash;
      int32_t b0 = 0, b1 = slash;  // int() strips whitespace both ends
      while (b0 < b1 && (mp[b0] == ' ' || (mp[b0] >= '\t' && mp[b0] <= '\r')))
        ++b0;
      while (b1 > b0 && (mp[b1 - 1] == ' '
                         || (mp[b1 - 1] >= '\t' && mp[b1 - 1] <= '\r')))
        --b1;
      bool negative = false;
      if (b0 < b1 && (mp[b0] == '+' || mp[b0] == '-')) {
        negative = mp[b0] == '-';
        ++b0;
      }
      bool digits_ok = b0 < b1;
      uint64_t v = 0;
      const uint64_t kU64Max = ~0ULL;
      for (int32_t k = b0; k < b1; ++k) {
        if (mp[k] < '0' || mp[k] > '9') {
          digits_ok = false;
          break;
        }
        if (v > (kU64Max - (mp[k] - '0')) / 10) {
          v = kU64Max;  // saturate like the Python min(value, u64::MAX)
        } else {
          v = v * 10 + (mp[k] - '0');
        }
      }
      mi_val = (digits_ok && !negative) ? v : 0;  // max(0, ...) clamps sign
      mi_sub = (slash + 2 == ml && mp[slash + 1] == 'A') ? 0 : 1;
    }
    uint8_t* p = out + out_off[i];
    put_u32_be(p + 0, static_cast<uint32_t>(tid1));
    put_u32_be(p + 4, static_cast<uint32_t>(tid2));
    put_u32_be(p + 8, static_cast<uint32_t>(pos1) + kPosBias);
    put_u32_be(p + 12, static_cast<uint32_t>(pos2) + kPosBias);
    p[16] = neg1 ? 0 : 1;
    p[17] = neg2 ? 0 : 1;
    p[18] = (lib_ord[i] >> 8) & 0xFF;
    p[19] = lib_ord[i] & 0xFF;
    put_u64_be(p + 20, mi_val);
    p[28] = mi_sub;
    const int32_t nl = l_read_name[i] - 1;
    std::memcpy(p + 29, buf + data_off[i] + 32, static_cast<size_t>(nl));
    p[29 + nl] = 0;
    p[30 + nl] = is_upper;
  }
  return 0;
}

// External sort engine (sort/external.py NativeExternalSorter; reference
// fgumi-sort RawExternalSorter). Keys are the memcmp-ordered packed byte
// strings of sort/keys.py; records are BAM wire bytes (block_size-
// prefixed). The Python layer holds contiguous key/record pools + span
// tables and calls:
//   fgumi_sort_spans  — argsort spans by (memcmp, ingest order)
//   fgumi_gather_spans — permute spans into one output blob
//   fgumi_write_run   — write a sorted run to disk as stored frames
//   fgumi_merge_open2/next/close — streaming k-way merge of runs, with a
//                       frame prefetch pool when asked for one
// and, for the other orders, fgumi_natural_name_keys (queryname keys) and
// fgumi_ref_spans (the index's per-record reference ends).

// Batch natural-queryname sort keys (sort/keys.py::queryname_key_bytes):
// digit runs as 0x01 + count + stripped digits, text runs as 0x02 + text +
// 0x00, then NUL + 4-byte rank (secondary flag, R1/R2, flag big-endian).
// Writes at out + out_off[i]; out_len[i] receives the key's length (the
// caller sizes out_off for the worst case 3 * l_read_name + 2).
long fgumi_natural_name_keys(const uint8_t* buf, const int64_t* data_off,
                             const int32_t* l_read_name, const int32_t* flag,
                             long n, uint8_t* out, const int64_t* out_off,
                             int32_t* out_len) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* name = buf + data_off[i] + 32;
    const int32_t nl = l_read_name[i] - 1;
    uint8_t* p = out + out_off[i];
    uint8_t* q = p;
    int32_t k = 0;
    while (k < nl) {
      if (name[k] >= '0' && name[k] <= '9') {
        int32_t s = k;
        while (k < nl && name[k] >= '0' && name[k] <= '9') ++k;
        while (s < k && name[s] == '0') ++s;  // lstrip('0'): "000" -> ""
        const int32_t sig = k - s;
        *q++ = 0x01;
        *q++ = static_cast<uint8_t>(sig);
        std::memcpy(q, name + s, static_cast<size_t>(sig));
        q += sig;
      } else {
        *q++ = 0x02;
        while (k < nl && (name[k] < '0' || name[k] > '9')) *q++ = name[k++];
        *q++ = 0x00;
      }
    }
    *q++ = 0x00;
    const int32_t f = flag[i];
    *q++ = (f & 0x900) ? 1 : 0;
    *q++ = !(f & 0x1) ? 0 : ((f & 0x40) ? 1 : 2);
    *q++ = (f >> 8) & 0xFF;
    *q++ = f & 0xFF;
    out_len[i] = static_cast<int32_t>(q - p);
  }
  return 0;
}

// Reference end per record: pos + the reference-consumed CIGAR length
// (M, D, N, =, X), at least 1 (RawRecord.reference_length, floored the way
// the index builders floor it).
void fgumi_ref_spans(const uint8_t* buf, const int64_t* cigar_off,
                     const int32_t* n_cigar, const int32_t* pos, long n,
                     int32_t* end_out) {
  for (long i = 0; i < n; ++i) {
    const uint8_t* c = buf + cigar_off[i];
    int64_t ref_len = 0;
    for (int32_t k = 0; k < n_cigar[i]; ++k) {
      const uint32_t v = read_u32(c + 4 * k);
      const uint32_t op = v & 0xF;
      if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) {
        ref_len += v >> 4;
      }
    }
    if (ref_len < 1) ref_len = 1;
    end_out[i] = pos[i] + static_cast<int32_t>(ref_len);
  }
}

// argsort of n byte spans by (memcmp, index). A precomputed 8-byte
// big-endian prefix settles most comparisons in one u64 compare (the packed
// keys front-load tid/pos exactly so this works).
void fgumi_sort_spans(const uint8_t* keys, const int64_t* off,
                      const int32_t* len, long n, int64_t* perm) {
  std::vector<uint64_t> pfx(static_cast<size_t>(n));
  for (long i = 0; i < n; ++i) {
    const uint8_t* p = keys + off[i];
    const int l = len[i] < 8 ? len[i] : 8;
    uint64_t v = 0;
    for (int j = 0; j < l; ++j) v |= static_cast<uint64_t>(p[j]) << (56 - 8 * j);
    pfx[static_cast<size_t>(i)] = v;
  }
  for (long i = 0; i < n; ++i) perm[i] = i;
  std::sort(perm, perm + n, [&](int64_t a, int64_t b) {
    const uint64_t pa = pfx[static_cast<size_t>(a)];
    const uint64_t pb = pfx[static_cast<size_t>(b)];
    if (pa != pb) return pa < pb;
    const int32_t la = len[a], lb = len[b];
    if (la > 8 || lb > 8) {
      const int32_t l = la < lb ? la : lb;
      // first 8 bytes already known equal when both spans reach 8
      const int32_t skip = (la >= 8 && lb >= 8) ? 8 : 0;
      const int c = memcmp(keys + off[a] + skip, keys + off[b] + skip,
                           static_cast<size_t>(l - skip));
      if (c != 0) return c < 0;
      if (la != lb) return la < lb;
    }
    return a < b;  // ingest-order tiebreak makes the sort total (radix.rs:35)
  });
}

// Concatenate spans in permutation order into out (caller sizes out to
// sum(len)). Returns bytes written.
long fgumi_gather_spans(const uint8_t* src, const int64_t* off,
                        const int32_t* len, const int64_t* perm, long n,
                        uint8_t* out) {
  long o = 0;
  for (long i = 0; i < n; ++i) {
    const int64_t j = perm[i];
    memcpy(out + o, src + off[j], static_cast<size_t>(len[j]));
    o += len[j];
  }
  return o;
}

}  // extern "C"

namespace {

// Spill-run entry: [u16 klen][u32 rlen] then key bytes, record wire bytes.
// Frame: [u32 stored][u32 raw] header then `stored` payload bytes. A run
// never reaches the output and is read back once, so this file writes
// stored frames (stored == raw); the reader refuses any other frame.
constexpr long kRunEntryHeader = 6;

bool write_frame(FILE* f, const uint8_t* buf, long n) {
  uint8_t hdr[8];
  put_u32(hdr, static_cast<uint32_t>(n));
  put_u32(hdr + 4, static_cast<uint32_t>(n));
  return fwrite(hdr, 1, 8, f) == 8 &&
         fwrite(buf, 1, static_cast<size_t>(n), f) == static_cast<size_t>(n);
}

struct MergeState;  // the prefetch pool lives on the merge state

// One spill run being merged: streams frames, exposes the current entry.
// With a prefetch pool (fgumi_merge_open2) the NEXT frame is read on a
// worker thread while the heap consumes the current one (the reference's
// merge prefetch, fgumi-sort/src/worker_pool.rs:25-31). Prefetch changes
// only when a frame is read, never which entry comes next.
struct RunReader {
  FILE* f = nullptr;
  std::vector<uint8_t> frame;
  size_t pos = 0;
  bool eof = false;
  const uint8_t* key = nullptr;
  uint32_t klen = 0;
  const uint8_t* rec = nullptr;
  uint32_t rlen = 0;
  // prefetch slot (guarded by MergeState::mu; a worker owns f while the
  // slot is decoding)
  MergeState* pf = nullptr;
  int idx = -1;
  std::vector<uint8_t> next_frame;
  bool next_eof = false;
  bool next_ok = true;
  // 0 = nothing scheduled, 1 = queued (the merge thread may take it back),
  // 2 = ready, 3 = being read on a worker
  int pf_state = 0;

  // Read one frame into (dst, dst_eof); false on corrupt input. Only one
  // thread (a worker or the merge thread) touches f at a time.
  bool read_frame_into(std::vector<uint8_t>* dst, bool* dst_eof) {
    uint8_t hdr[8];
    *dst_eof = false;
    if (fread(hdr, 1, 8, f) != 8) {
      *dst_eof = true;
      return true;  // clean end
    }
    const uint32_t c = read_u32(hdr);
    const uint32_t u = read_u32(hdr + 4);
    if (c != u) return false;
    dst->resize(u);
    return fread(dst->data(), 1, u, f) == u;
  }

  bool load_frame();  // defined after MergeState (uses the pool)

  // Advance to the next entry; false on corrupt input (eof flag on clean end).
  bool next() {
    if (pos >= frame.size()) {
      if (!load_frame()) return false;
      if (eof) return true;
    }
    if (pos + kRunEntryHeader > frame.size()) return false;
    const uint8_t* p = frame.data() + pos;
    klen = read_u16(p);
    rlen = read_u32(p + 2);
    pos += kRunEntryHeader;
    if (pos + klen + rlen > frame.size()) return false;
    key = frame.data() + pos;
    rec = frame.data() + pos + klen;
    pos += klen + rlen;
    return true;
  }
};

struct MergeState {
  std::vector<RunReader> runs;
  std::vector<int> heap;  // indices into runs, min-heap by (key, run index)

  // frame prefetch pool (empty: the merge reads every frame itself)
  std::vector<std::thread> pool;
  std::deque<int> work;
  std::mutex mu;
  std::condition_variable work_cv;  // workers: work arrived or stopping
  std::condition_variable done_cv;  // merge thread: a frame became ready
  bool stopping = false;
  long max_prefetch = 0;  // frame slots across all runs
  long slots = 0;         // queued, in-flight and ready prefetched frames

  // Call with mu held. Past the budget it schedules nothing, and the merge
  // thread reads that run's next frame itself: bounded memory, no
  // deadlock, the same output.
  void schedule_locked(int i) {
    RunReader& r = runs[static_cast<size_t>(i)];
    if (r.pf_state != 0 || r.eof || slots >= max_prefetch) return;
    slots += 1;
    r.pf_state = 1;
    work.push_back(i);
    work_cv.notify_one();
  }

  void worker_loop() {
    for (;;) {
      int i;
      {
        std::unique_lock<std::mutex> lk(mu);
        work_cv.wait(lk, [&] { return stopping || !work.empty(); });
        if (stopping) return;
        i = work.front();
        work.pop_front();
        // claimed: the merge thread takes back QUEUED (1) frames but waits
        // for one being read (3)
        runs[static_cast<size_t>(i)].pf_state = 3;
      }
      RunReader& r = runs[static_cast<size_t>(i)];
      const bool ok = r.read_frame_into(&r.next_frame, &r.next_eof);
      {
        std::lock_guard<std::mutex> lk(mu);
        r.next_ok = ok;
        r.pf_state = 2;
        done_cv.notify_all();
      }
    }
  }

  void start_pool(int n_threads, long max_frames) {
    max_prefetch = max_frames;
    for (int i = 0; i < static_cast<int>(runs.size()); ++i) {
      runs[static_cast<size_t>(i)].pf = this;
      runs[static_cast<size_t>(i)].idx = i;
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      for (int i = 0; i < static_cast<int>(runs.size()); ++i) {
        schedule_locked(i);
      }
    }
    for (int t = 0; t < n_threads; ++t) {
      pool.emplace_back([this] { worker_loop(); });
    }
  }

  void stop_pool() {
    if (pool.empty()) return;
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
      work_cv.notify_all();
    }
    for (std::thread& t : pool) t.join();
    pool.clear();
  }

  // (key, run index): runs are ingest-ordered chunks, so the run-index
  // tiebreak reproduces the global ingest-order total order
  bool less(int a, int b) const {
    const RunReader& ra = runs[a];
    const RunReader& rb = runs[b];
    const uint32_t l = ra.klen < rb.klen ? ra.klen : rb.klen;
    const int c = memcmp(ra.key, rb.key, l);
    if (c != 0) return c < 0;
    if (ra.klen != rb.klen) return ra.klen < rb.klen;
    return a < b;
  }

  void sift_down(size_t i) {
    const size_t n = heap.size();
    while (true) {
      size_t best = i;
      const size_t l = 2 * i + 1, r = 2 * i + 2;
      if (l < n && less(heap[l], heap[best])) best = l;
      if (r < n && less(heap[r], heap[best])) best = r;
      if (best == i) return;
      std::swap(heap[i], heap[best]);
      i = best;
    }
  }

  void sift_up(size_t i) {
    while (i > 0) {
      const size_t p = (i - 1) / 2;
      if (!less(heap[i], heap[p])) return;
      std::swap(heap[i], heap[p]);
      i = p;
    }
  }
};

bool RunReader::load_frame() {
  if (pf == nullptr || pf->pool.empty()) {
    const bool ok = read_frame_into(&frame, &eof);
    if (ok && !eof) pos = 0;
    return ok;
  }
  MergeState* st = pf;
  std::unique_lock<std::mutex> lk(st->mu);
  if (pf_state == 1) {
    // still queued: take it back, so the merge thread never waits behind
    // reads of runs it does not need yet
    for (auto it = st->work.begin(); it != st->work.end(); ++it) {
      if (*it == idx) {
        st->work.erase(it);
        break;
      }
    }
    st->slots -= 1;
    pf_state = 0;
  }
  if (pf_state == 0) {
    // nothing in flight for this run: read inline (off the lock: only
    // this thread touches f now), then schedule the frame after it
    lk.unlock();
    const bool ok = read_frame_into(&frame, &eof);
    pos = 0;
    if (ok && !eof) {
      std::lock_guard<std::mutex> lk2(st->mu);
      st->schedule_locked(idx);
    }
    return ok;
  }
  st->done_cv.wait(lk, [&] { return pf_state == 2; });
  pf_state = 0;
  st->slots -= 1;
  if (!next_ok) return false;
  frame.swap(next_frame);
  eof = next_eof;
  pos = 0;
  if (!eof) st->schedule_locked(idx);
  return true;
}

}  // namespace

extern "C" {

// Write one sorted spill run: entries in perm order, in stored frames of
// about frame_bytes. Returns 0 on success, -errno on I/O failure, -9999
// when the failure left no errno.
long fgumi_write_run(const uint8_t* path, const uint8_t* keys,
                     const int64_t* koff, const int32_t* klen,
                     const uint8_t* recs, const int64_t* roff,
                     const int32_t* rlen, const int64_t* perm, long n,
                     long frame_bytes) {
  errno = 0;
  FILE* f = fopen(reinterpret_cast<const char*>(path), "wb");
  if (f == nullptr) return errno ? -errno : -9999;
  std::vector<uint8_t> frame;
  frame.reserve(static_cast<size_t>(frame_bytes) + (64 << 10));
  bool ok = true;
  for (long i = 0; i < n && ok; ++i) {
    const int64_t j = perm[i];
    const uint32_t kl = static_cast<uint32_t>(klen[j]);
    const uint32_t rl = static_cast<uint32_t>(rlen[j]);
    uint8_t hdr[kRunEntryHeader];
    put_u16(hdr, static_cast<uint16_t>(kl));
    put_u32(hdr + 2, rl);
    frame.insert(frame.end(), hdr, hdr + kRunEntryHeader);
    frame.insert(frame.end(), keys + koff[j], keys + koff[j] + kl);
    frame.insert(frame.end(), recs + roff[j], recs + roff[j] + rl);
    if (static_cast<long>(frame.size()) >= frame_bytes) {
      ok = write_frame(f, frame.data(), static_cast<long>(frame.size()));
      frame.clear();
    }
  }
  if (ok && !frame.empty()) {
    ok = write_frame(f, frame.data(), static_cast<long>(frame.size()));
  }
  if (fclose(f) != 0) ok = false;
  if (ok) return 0;
  return errno ? -errno : -9999;
}

void fgumi_merge_close(void* handle) {
  MergeState* st = static_cast<MergeState*>(handle);
  st->stop_pool();  // join the workers before their FILE*s go away
  for (RunReader& r : st->runs) {
    if (r.f != nullptr) fclose(r.f);
  }
  delete st;
}

// Open a k-way merge over '\n'-joined run paths, with a frame prefetch
// pool when n_threads > 0 and max_prefetch_frames > 0 (and more than one
// run): n_threads workers read each run's next frame while the heap drains
// the current one, holding at most max_prefetch_frames frames beyond the
// runs' current ones. Returns nullptr on failure (a run that cannot be
// opened, or a corrupt first frame).
void* fgumi_merge_open2(const uint8_t* paths, long paths_len, long n_runs,
                        int n_threads, long max_prefetch_frames) {
  MergeState* st = new MergeState();
  st->runs.resize(static_cast<size_t>(n_runs));
  long start = 0;
  long run = 0;
  for (long i = 0; i <= paths_len && run < n_runs; ++i) {
    if (i == paths_len || paths[i] == '\n') {
      std::string path(reinterpret_cast<const char*>(paths + start),
                       static_cast<size_t>(i - start));
      st->runs[static_cast<size_t>(run)].f = fopen(path.c_str(), "rb");
      if (st->runs[static_cast<size_t>(run)].f == nullptr) {
        fgumi_merge_close(st);
        return nullptr;
      }
      ++run;
      start = i + 1;
    }
  }
  for (int i = 0; i < static_cast<int>(st->runs.size()); ++i) {
    RunReader& r = st->runs[static_cast<size_t>(i)];
    if (!r.next()) {
      fgumi_merge_close(st);
      return nullptr;
    }
    if (!r.eof) {
      st->heap.push_back(i);
      st->sift_up(st->heap.size() - 1);
    }
  }
  if (n_threads > 0 && max_prefetch_frames > 0 && n_runs > 1) {
    st->start_pool(n_threads, max_prefetch_frames);
  }
  return st;
}

// Emit merged records (wire bytes, concatenated) into out, up to cap bytes
// or max_recs records; per-record wire lengths land in rec_lens. Returns
// bytes written (0 = merge complete), -1 on corrupt input.
long fgumi_merge_next(void* handle, uint8_t* out, long cap, int32_t* rec_lens,
                      long max_recs, long* n_recs) {
  MergeState* st = static_cast<MergeState*>(handle);
  long o = 0;
  long emitted = 0;
  while (!st->heap.empty() && emitted < max_recs) {
    const int top = st->heap[0];
    RunReader& r = st->runs[static_cast<size_t>(top)];
    if (o + static_cast<long>(r.rlen) > cap) break;
    memcpy(out + o, r.rec, r.rlen);
    o += r.rlen;
    rec_lens[emitted++] = static_cast<int32_t>(r.rlen);
    if (!r.next()) return -1;
    if (r.eof) {
      st->heap[0] = st->heap.back();
      st->heap.pop_back();
    }
    if (!st->heap.empty()) st->sift_down(0);
  }
  *n_recs = emitted;
  return o;
}

}  // extern "C"

namespace {

// Full case-insensitive IUPAC base -> BAM nibble table (io/bam.py
// BASE_TO_NIBBLE: "=ACMGRSVTWYHKDBN" both cases, everything else 15/N),
// built once, thread-safely, at first use.
struct IupacNibbles {
  uint8_t t[256];
  IupacNibbles() {
    const char* order = "=ACMGRSVTWYHKDBN";
    for (int i = 0; i < 256; ++i) t[i] = 15;
    for (int i = 0; i < 16; ++i) {
      const char c = order[i];
      t[static_cast<uint8_t>(c)] = static_cast<uint8_t>(i);
      if (c >= 'A' && c <= 'Z')
        t[static_cast<uint8_t>(c - 'A' + 'a')] = static_cast<uint8_t>(i);
    }
  }
};

const uint8_t* iupac_nibble_table() {
  static const IupacNibbles table;
  return table.t;
}

}  // namespace

extern "C" {

// Serialize J unmapped CODEC consensus records. Byte-exact analog of
// CodecConsensusCaller._build_record (consensus/codec.py; reference
// build_output_record_into, codec_caller.rs:1374-1539): header + name +
// packed seq + quals, then tags RG:Z, [MI:Z], cD/cM/cE, aD/aM/aE, bD/bM/bE,
// [ad/bd/ae/be:B,s ac/bc:Z aq/bq:Z], [RX:Z]. Per-record data arrives as raw
// addresses: seq/qual/strand-base/strand-qual rows are uint8 of length
// lens[j]; cons_err/strand depth+error rows are int64. mi_len[j] < 0 skips
// MI; rx_addr[j] == 0 skips RX. Returns total bytes, -2 on an over-long
// name, -1 on overflow.
long fgumi_build_codec_records(
    const int64_t* seq_addr, const int64_t* qual_addr,
    const int64_t* cons_err_addr,
    const int64_t* a_base, const int64_t* a_qual, const int64_t* a_depth,
    const int64_t* a_err,
    const int64_t* b_base, const int64_t* b_qual, const int64_t* b_depth,
    const int64_t* b_err,
    const int32_t* lens, long J,
    const int64_t* name_addr, const int32_t* name_len,
    const int64_t* mi_addr, const int32_t* mi_len,
    const int64_t* rx_addr, const int32_t* rx_len,
    const uint8_t* rg, int rg_len, int flags, int per_base_tags,
    uint8_t* out, long out_cap, int64_t* rec_end) {
  const uint8_t* nib = iupac_nibble_table();
  long off = 0;
  for (long j = 0; j < J; ++j) {
    const int32_t L = lens[j];
    const int32_t nl = name_len[j];
    if (nl + 1 > 255) return -2;
    long need = 4 + 32 + nl + 1 + (L + 1) / 2 + L;
    need += 3 + rg_len + 1;
    if (mi_len[j] >= 0) need += 3 + mi_len[j] + 1;
    need += 9 * 7;  // cD cM cE aD aM aE bD bM bE
    if (per_base_tags)
      need += 4 * (8 + 2 * static_cast<long>(L)) + 4 * (3 + L + 1);
    if (rx_addr[j] != 0) need += 3 + rx_len[j] + 1;
    if (off + need > out_cap) return -1;

    const uint8_t* seq = reinterpret_cast<const uint8_t*>(seq_addr[j]);
    const uint8_t* qual = reinterpret_cast<const uint8_t*>(qual_addr[j]);
    const int64_t* cerr = reinterpret_cast<const int64_t*>(cons_err_addr[j]);
    uint8_t* rec = out + off + 4;
    put_u32(rec + 0, 0xFFFFFFFFu);
    put_u32(rec + 4, 0xFFFFFFFFu);
    rec[8] = static_cast<uint8_t>(nl + 1);
    rec[9] = 0;
    put_u16(rec + 10, 4680);
    put_u16(rec + 12, 0);
    put_u16(rec + 14, static_cast<uint16_t>(flags));
    put_u32(rec + 16, static_cast<uint32_t>(L));
    put_u32(rec + 20, 0xFFFFFFFFu);
    put_u32(rec + 24, 0xFFFFFFFFu);
    put_u32(rec + 28, 0);
    uint8_t* p = rec + 32;
    std::memcpy(p, reinterpret_cast<const uint8_t*>(name_addr[j]),
                static_cast<size_t>(nl));
    p += nl;
    *p++ = 0;
    for (int32_t i = 0; i + 1 < L; i += 2)
      *p++ = static_cast<uint8_t>((nib[seq[i]] << 4) | nib[seq[i + 1]]);
    if (L & 1) *p++ = static_cast<uint8_t>(nib[seq[L - 1]] << 4);
    std::memcpy(p, qual, static_cast<size_t>(L));
    p += L;
    p[0] = 'R'; p[1] = 'G'; p[2] = 'Z';
    std::memcpy(p + 3, rg, static_cast<size_t>(rg_len));
    p += 3 + rg_len;
    *p++ = 0;
    if (mi_len[j] >= 0) {
      p[0] = 'M'; p[1] = 'I'; p[2] = 'Z';
      std::memcpy(p + 3, reinterpret_cast<const uint8_t*>(mi_addr[j]),
                  static_cast<size_t>(mi_len[j]));
      p += 3 + mi_len[j];
      *p++ = 0;
    }

    const int64_t* adp = reinterpret_cast<const int64_t*>(a_depth[j]);
    const int64_t* aer = reinterpret_cast<const int64_t*>(a_err[j]);
    const int64_t* bdp = reinterpret_cast<const int64_t*>(b_depth[j]);
    const int64_t* ber = reinterpret_cast<const int64_t*>(b_err[j]);
    auto cap16 = [](int64_t v) -> int64_t { return v < 32767 ? v : 32767; };

    // cD/cM over cap(a)+cap(b); cE = sum(cap(cons_err)) / sum(total_depth)
    int64_t td_max = 0, td_min = 0, td_sum = 0, ce_sum = 0;
    if (L > 0) {
      td_max = -1;
      td_min = 0x7FFFFFFFFFFFLL;
      for (int32_t i = 0; i < L; ++i) {
        const int64_t td = cap16(adp[i]) + cap16(bdp[i]);
        if (td > td_max) td_max = td;
        if (td < td_min) td_min = td;
        td_sum += td;
        ce_sum += cap16(cerr[i]);
      }
    }
    const float crate = td_sum
        ? static_cast<float>(ce_sum) / static_cast<float>(td_sum) : 0.0f;
    p[0] = 'c'; p[1] = 'D'; p[2] = 'i';
    put_u32(p + 3, static_cast<uint32_t>(L > 0 ? td_max : 0));
    p += 7;
    p[0] = 'c'; p[1] = 'M'; p[2] = 'i';
    put_u32(p + 3, static_cast<uint32_t>(L > 0 ? td_min : 0));
    p += 7;
    uint32_t bits;
    std::memcpy(&bits, &crate, 4);
    p[0] = 'c'; p[1] = 'E'; p[2] = 'f';
    put_u32(p + 3, bits);
    p += 7;

    // aD/aM/aE then bD/bM/bE (strand aggregates over capped values)
    const int64_t* deps[2] = {adp, bdp};
    const int64_t* errs[2] = {aer, ber};
    const char sc[2] = {'a', 'b'};
    for (int s = 0; s < 2; ++s) {
      int64_t mx = 0, mn = 0, dsum = 0, esum = 0;
      if (L > 0) {
        mx = -1;
        mn = 0x7FFFFFFFFFFFLL;
        for (int32_t i = 0; i < L; ++i) {
          const int64_t d = cap16(deps[s][i]);
          if (d > mx) mx = d;
          if (d < mn) mn = d;
          dsum += d;
          esum += cap16(errs[s][i]);
        }
      }
      const float srate = dsum
          ? static_cast<float>(esum) / static_cast<float>(dsum) : 0.0f;
      p[0] = sc[s]; p[1] = 'D'; p[2] = 'i';
      put_u32(p + 3, static_cast<uint32_t>(L > 0 ? mx : 0));
      p += 7;
      p[0] = sc[s]; p[1] = 'M'; p[2] = 'i';
      put_u32(p + 3, static_cast<uint32_t>(L > 0 ? mn : 0));
      p += 7;
      std::memcpy(&bits, &srate, 4);
      p[0] = sc[s]; p[1] = 'E'; p[2] = 'f';
      put_u32(p + 3, bits);
      p += 7;
    }

    if (per_base_tags) {
      // ad bd ae be (B,s of capped values), then ac bc (Z), aq bq (Z +33)
      const int64_t* rows[4] = {adp, bdp, aer, ber};
      const char tag0[4] = {'a', 'b', 'a', 'b'};
      const char tag1[4] = {'d', 'd', 'e', 'e'};
      for (int t = 0; t < 4; ++t) {
        p[0] = tag0[t]; p[1] = tag1[t]; p[2] = 'B'; p[3] = 's';
        put_u32(p + 4, static_cast<uint32_t>(L));
        p += 8;
        for (int32_t i = 0; i < L; ++i) {
          put_u16(p, static_cast<uint16_t>(
                         static_cast<int16_t>(cap16(rows[t][i]))));
          p += 2;
        }
      }
      const uint8_t* sb[2] = {reinterpret_cast<const uint8_t*>(a_base[j]),
                              reinterpret_cast<const uint8_t*>(b_base[j])};
      const uint8_t* sq[2] = {reinterpret_cast<const uint8_t*>(a_qual[j]),
                              reinterpret_cast<const uint8_t*>(b_qual[j])};
      for (int s = 0; s < 2; ++s) {
        p[0] = sc[s]; p[1] = 'c'; p[2] = 'Z';
        std::memcpy(p + 3, sb[s], static_cast<size_t>(L));
        p += 3 + L;
        *p++ = 0;
      }
      for (int s = 0; s < 2; ++s) {
        p[0] = sc[s]; p[1] = 'q'; p[2] = 'Z';
        p += 3;
        for (int32_t i = 0; i < L; ++i)
          *p++ = static_cast<uint8_t>(sq[s][i] + 33);
        *p++ = 0;
      }
    }
    if (rx_addr[j] != 0) {
      p[0] = 'R'; p[1] = 'X'; p[2] = 'Z';
      std::memcpy(p + 3, reinterpret_cast<const uint8_t*>(rx_addr[j]),
                  static_cast<size_t>(rx_len[j]));
      p += 3 + rx_len[j];
      *p++ = 0;
    }
    const long rec_size = p - rec;
    put_u32(out + off, static_cast<uint32_t>(rec_size));
    off += 4 + rec_size;
    rec_end[j] = off;
  }
  return off;
}

}  // extern "C"

// The zipper's and correct's batch passes (record_edit.TagEditor's
// native form).
extern "C" {

// Per-record aux tag names (u16 little-endian pairs): the zipper's batch
// engine builds per-record drop lists from the unmapped record's tag names
// (zipper.rs merge_raw removes every same-named mapped tag before copying).
// counts[i] = names found, or -1 when > max_per or malformed (the caller
// takes that template down the per-record path).
void fgumi_tag_name_list(const uint8_t* buf, const int64_t* aux_off,
                         const int64_t* aux_end, long n, long max_per,
                         uint16_t* out_names, int32_t* counts) {
  for (long i = 0; i < n; ++i) {
    uint16_t* names = out_names + i * max_per;
    int64_t off = aux_off[i];
    const int64_t end = aux_end[i];
    long found = 0;
    bool bad = false;
    while (off + 3 <= end) {
      const uint16_t name = static_cast<uint16_t>(buf[off]) |
                            (static_cast<uint16_t>(buf[off + 1]) << 8);
      const uint8_t typ = buf[off + 2];
      off += 3;
      int64_t size = tag_fixed_size(typ);
      if (size == 0) {
        if (typ == 'Z' || typ == 'H') {
          const uint8_t* nul = static_cast<const uint8_t*>(
              std::memchr(buf + off, 0, static_cast<size_t>(end - off)));
          if (nul == nullptr) { bad = true; break; }
          size = (nul - (buf + off)) + 1;
        } else if (typ == 'B') {
          if (off + 5 > end) { bad = true; break; }
          const int64_t esize = tag_fixed_size(buf[off]);
          if (esize == 0) { bad = true; break; }
          size = 5 + esize * static_cast<int64_t>(read_u32(buf + off + 1));
        } else {
          bad = true;
          break;
        }
      }
      if (off + size > end) { bad = true; break; }
      if (found >= max_per) { bad = true; break; }
      names[found++] = name;
      off += size;
    }
    counts[i] = bad ? -1 : static_cast<int32_t>(found);
  }
}

// CIGAR strings for a whole batch ("*" for zero ops). Caller sizes out to
// sum(max(11 * n_cigar, 1)). Returns 0, or -1 on an invalid op code.
long fgumi_cigar_strings(const uint8_t* buf, const int64_t* cigar_off,
                         const int32_t* n_cigar, long n, uint8_t* out,
                         int64_t* out_off) {
  static const char kOps[] = "MIDNSHP=X";
  int64_t o = 0;
  out_off[0] = 0;
  for (long i = 0; i < n; ++i) {
    if (n_cigar[i] == 0) {
      out[o++] = '*';
    } else {
      const uint8_t* c = buf + cigar_off[i];
      for (int32_t k = 0; k < n_cigar[i]; ++k) {
        const uint32_t v = read_u32(c + 4 * k);
        const uint32_t op = v & 0xF;
        if (op > 8) return -1;
        uint32_t len = v >> 4;
        char digits[10];
        int nd = 0;
        do {
          digits[nd++] = static_cast<char>('0' + len % 10);
          len /= 10;
        } while (len != 0);
        while (nd > 0) out[o++] = digits[--nd];
        out[o++] = kOps[op];
      }
    }
    out_off[i + 1] = o;
  }
  return 0;
}

// Rebuild records with edited aux regions, in one pass (the native form of
// record_edit.TagEditor.finish: [prefix][surviving originals in order]
// [append blob]). drop lists are per-record u16 tag-name spans; appends are
// pre-encoded TLV bytes. Output records carry their block_size prefixes
// (write_serialized form), written contiguously; out_pos gets n+1 offsets.
// Returns total bytes, or -(i+1) on a malformed record i (the caller
// takes the per-record editor, as the reference does).
long fgumi_rebuild_aux_records(
    const uint8_t* buf, const int64_t* data_off, const int64_t* aux_off,
    const int64_t* data_end, long n, const uint16_t* drop,
    const int64_t* drop_off, const uint8_t* appends, const int64_t* app_off,
    uint8_t* out, int64_t* out_pos) {
  int64_t o = 0;
  out_pos[0] = 0;
  for (long i = 0; i < n; ++i) {
    uint8_t* rec0 = out + o + 4;
    uint8_t* dst = rec0;
    const int64_t pre = aux_off[i] - data_off[i];
    memcpy(dst, buf + data_off[i], static_cast<size_t>(pre));
    dst += pre;
    const uint16_t* dr = drop + drop_off[i];
    const long nd = static_cast<long>(drop_off[i + 1] - drop_off[i]);
    int64_t off = aux_off[i];
    const int64_t end = data_end[i];
    while (off + 3 <= end) {
      const int64_t entry0 = off;
      const uint16_t name = static_cast<uint16_t>(buf[off]) |
                            (static_cast<uint16_t>(buf[off + 1]) << 8);
      const uint8_t typ = buf[off + 2];
      off += 3;
      int64_t size = tag_fixed_size(typ);
      if (size == 0) {
        if (typ == 'Z' || typ == 'H') {
          const uint8_t* nul = static_cast<const uint8_t*>(
              std::memchr(buf + off, 0, static_cast<size_t>(end - off)));
          if (nul == nullptr) return -(i + 1);
          size = (nul - (buf + off)) + 1;
        } else if (typ == 'B') {
          if (off + 5 > end) return -(i + 1);
          const int64_t esize = tag_fixed_size(buf[off]);
          if (esize == 0) return -(i + 1);
          size = 5 + esize * static_cast<int64_t>(read_u32(buf + off + 1));
        } else {
          return -(i + 1);
        }
      }
      if (off + size > end) return -(i + 1);
      off += size;
      bool dropped = false;
      for (long d = 0; d < nd; ++d) {
        if (dr[d] == name) { dropped = true; break; }
      }
      if (!dropped) {
        memcpy(dst, buf + entry0, static_cast<size_t>(off - entry0));
        dst += off - entry0;
      }
    }
    const int64_t alen = app_off[i + 1] - app_off[i];
    memcpy(dst, appends + app_off[i], static_cast<size_t>(alen));
    dst += alen;
    const int64_t rec_len = dst - rec0;
    put_u32(out + o, static_cast<uint32_t>(rec_len));
    o += 4 + rec_len;
    out_pos[i + 1] = o;
  }
  return o;
}

}  // extern "C"
