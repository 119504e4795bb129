// Native I/O layer: BGZF codec + BAM record decode to columnar arrays.
//
// Replaces the reference's native compression library and C# BAM reader
// (libFileCompression.so P/Invoked from Common.IO/FileCompression.cs;
// Alignment.IO/BamReader.cs:22-677) with a C++ module that emits columnar
// read batches (positions, flags, CIGAR op arrays, seq codes, quals) ready
// for host->device DMA.
//
// Build: pisces_tpu_torch/io/native.py get_lib() (g++ at first use, with
// rmxn.cpp, into one library under pisces_tpu_torch/build/).
// Binding: ctypes (pisces_tpu_torch/io/native.py), every export, the
// lazy-region reader (bam_open_lazy, bam_fetch_region) and the BGZF
// compressor (bgzf_compress) included.

#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <unordered_map>
#include <string>
#include <system_error>
#include <thread>
#include <utility>
#include <vector>

#include <zlib.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <cmath>
#include <algorithm>

namespace {

struct BgzfBlock {
  size_t file_off;
  size_t cdata_off;
  uint32_t cdata_len;
  uint32_t isize;
  size_t out_off;
};

// Scan BGZF block boundaries; returns false on malformed input.
bool scan_blocks(const uint8_t* data, size_t n, std::vector<BgzfBlock>* blocks,
                 size_t* total_out) {
  size_t off = 0;
  size_t out = 0;
  while (off + 18 <= n) {
    if (data[off] != 0x1f || data[off + 1] != 0x8b) return false;
    uint16_t xlen;
    memcpy(&xlen, data + off + 10, 2);
    size_t p = off + 12;
    size_t extra_end = p + xlen;
    if (extra_end > n) return false;
    uint32_t bsize = 0;
    while (p + 4 <= extra_end) {
      uint8_t si1 = data[p], si2 = data[p + 1];
      uint16_t slen;
      memcpy(&slen, data + p + 2, 2);
      if (si1 == 66 && si2 == 67 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, data + p + 4, 2);
        bsize = bs + 1;
        break;
      }
      p += 4 + slen;
    }
    if (bsize == 0 || off + bsize > n) return false;
    uint32_t cdata_len = bsize - xlen - 19 - 6;  // minus header(12)+extra+crc+isize... computed below
    // header=10, xlen field=2, extra=xlen, crc=4, isize=4
    cdata_len = bsize - (12 + xlen + 8);
    uint32_t isize;
    memcpy(&isize, data + off + bsize - 4, 4);
    blocks->push_back({off, off + 12 + xlen, cdata_len, isize, out});
    out += isize;
    off += bsize;
  }
  *total_out = out;
  return true;
}

bool inflate_block(const uint8_t* src, uint32_t src_len, uint8_t* dst,
                   uint32_t dst_len) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = src_len;
  zs.next_out = dst;
  zs.avail_out = dst_len;
  int ret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  return ret == Z_STREAM_END || (ret == Z_OK && zs.avail_out == 0) ||
         (dst_len == 0);
}

// seq nibble code -> allele code ('=ACMGRSVTWYHKDBN' -> A0 G1 C2 T3 N4)
const int8_t kNibbleToAllele[16] = {4, 0, 2, 4, 1, 4, 4, 4,
                                    3, 4, 4, 4, 4, 4, 4, 4};

const bool kConsumesRead[9] = {true, true, false, false, true,
                               false, false, true, true};
const bool kConsumesRef[9] = {true, false, true, true, false,
                              false, false, true, true};

// An allocator whose resize leaves new elements uninitialised: the pileup
// pass's slabs zero their own parts of its dense buffers, on their threads.
template <class T>
struct NoInitAllocator : std::allocator<T> {
  template <class U>
  struct rebind {
    using other = NoInitAllocator<U>;
  };
  NoInitAllocator() = default;
  template <class U>
  NoInitAllocator(const NoInitAllocator<U>&) noexcept {}
  template <class U>
  void construct(U* p) noexcept {
    ::new ((void*)p) U;
  }
  template <class U, class... Args>
  void construct(U* p, Args&&... args) {
    ::new ((void*)p) U(std::forward<Args>(args)...);
  }
};
template <class T>
using DenseBuf = std::vector<T, NoInitAllocator<T>>;

// Per-handle pileup accumulation result (RegionStateManager block tensors).
// Owned by the BamFile handle so concurrent pileups over distinct handles
// never share state (reference discipline: one job owns one block,
// RegionStateManager.cs:336-439).
struct PileupResult {
  std::vector<int64_t> block_keys;
  DenseBuf<int32_t> counts_t;   // [nb * block_size * 6 * 3]
  DenseBuf<double> qual_t;      // same shape
  DenseBuf<int32_t> anchored_counts;  // [K * 6 * 3 * (2A+1)]
  DenseBuf<double> anchored_quals;
  int64_t n_slabs = 0;        // the slabs the last pass ran in
  std::vector<size_t> kept;   // the last pass's kept reads (scratch)
  // SNV mismatch events (candidate discovery, call_mnvs=false rules)
  std::vector<int64_t> mm_gpos;
  std::vector<int8_t> mm_alt;
  std::vector<int8_t> mm_dir;
  std::vector<int8_t> mm_flags;  // bit0 openR, bit1 openL, bit2 well-anchored
  // per-position scoring tuples (when ref_codes given): 8 int32 per row
  // [sup_f, sup_r, sup_s, cov_f, cov_r, cov_s, n_total, 0] — everything the
  // gVCF reference scorer needs, so Python never re-reduces the dense tensor
  DenseBuf<int32_t> pos_tuples;
  // gVCF dedup (pileup_gvcf_unique): covered in-reference positions, their
  // unique (sup, cov)-by-direction 6-tuples, and the per-position inverse
  // index (fast_gvcf.score_reference_positions contract)
  std::vector<int64_t> sel_positions;
  std::vector<int32_t> uniq_tuples;  // [U * 6]
  std::vector<int32_t> uniq_inv;     // [n_sel]
};

struct BamFile {
  std::vector<uint8_t> udata;  // inflated content
  // header
  std::string text;
  std::unique_ptr<PileupResult> pileup;  // last pileup pass's result
  std::vector<std::string> ref_names;
  std::vector<int32_t> ref_lens;
  size_t records_start = 0;
  // record index
  std::vector<size_t> rec_offsets;
  // lazy mode (bam_open_lazy): compressed bytes + block table retained so
  // bam_fetch_region can inflate only the .bai-indexed chunks of a window
  // (the BamReader.Jump analog at native speed, BamReader.cs:22-677).
  // The compressed file is mmap'd read-only, so concurrent lazy handles on
  // the same BAM share one page-cache copy.
  bool lazy = false;
  const uint8_t* raw = nullptr;  // mmap'd when raw_len > 0
  size_t raw_len = 0;
  std::vector<BgzfBlock> blocks;

  ~BamFile();

  // decoded columnar batch (for the last decode call)
  std::vector<int32_t> ref_id, pos, end_pos;
  std::vector<uint8_t> mapq;
  std::vector<uint16_t> flag;
  std::vector<int64_t> cigar_off, seq_off;
  std::vector<uint8_t> cigar_ops;
  std::vector<int32_t> cigar_lens;
  std::vector<int8_t> seq;
  std::vector<uint8_t> qual;
  std::vector<int32_t> mate_ref_id, mate_pos;
  std::string name_blob;            // concatenated read names
  std::vector<int64_t> name_off;    // [n+1] offsets into name_blob
  // typed tag columns (TagUtils analog, BamCommon.cs; filled when
  // bam_decode_tags parse_tags=1): each Z-string tag gets its own blob +
  // [n+1] prefix offsets (slots: 0 XD, 1 XN, 2 XR, 3 XU, 4 XW-string),
  // int tags as value columns, and a per-read presence bitmask
  // (1 XD, 2 XN, 4 XR, 8 XU, 16 XV, 32 XW-int, 64 XW-string)
  std::string tag_blobs[5];
  std::vector<int64_t> tag_offs[5];
  std::vector<int32_t> xv_val, xw_val;
  std::vector<uint8_t> tag_present;
};

BamFile::~BamFile() {
  if (raw != nullptr && raw_len > 0) munmap((void*)raw, raw_len);
}

int32_t rd_i32(const uint8_t* p) {
  int32_t v;
  memcpy(&v, p, 4);
  return v;
}

// Parse the BAM header (magic, text, reference dictionary) from the
// inflated prefix in bf->udata; fills text/ref_names/ref_lens and
// records_start. Returns false when the prefix is too short.
bool parse_bam_header(BamFile* bf) {
  const uint8_t* d = bf->udata.data();
  size_t n = bf->udata.size();
  if (n < 12 || memcmp(d, "BAM\x01", 4) != 0) return false;
  int32_t l_text = rd_i32(d + 4);
  if ((size_t)8 + l_text + 4 > n) return false;
  size_t off = 8 + l_text;
  int32_t n_ref = rd_i32(d + off);
  off += 4;
  std::vector<std::string> names;
  std::vector<int32_t> lens;
  for (int i = 0; i < n_ref; i++) {
    if (off + 4 > n) return false;
    int32_t l_name = rd_i32(d + off);
    if (off + 8 + l_name > n) return false;
    names.emplace_back((const char*)d + off + 4, l_name - 1);
    lens.push_back(rd_i32(d + off + 4 + l_name));
    off += 8 + l_name;
  }
  bf->text.assign((const char*)d + 8, l_text);
  bf->ref_names = std::move(names);
  bf->ref_lens = std::move(lens);
  bf->records_start = off;
  return true;
}
uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
uint16_t rd_u16(const uint8_t* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

}  // namespace

extern "C" {

void* bam_open(const char* path, int n_threads) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long fsize = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> raw(fsize);
  if (fread(raw.data(), 1, fsize, f) != (size_t)fsize) {
    fclose(f);
    return nullptr;
  }
  fclose(f);

  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!scan_blocks(raw.data(), raw.size(), &blocks, &total)) return nullptr;

  auto* bf = new BamFile();
  bf->udata.resize(total);

  if (n_threads < 1) n_threads = 1;
  size_t nb = blocks.size();
  std::vector<std::thread> threads;
  std::vector<bool> ok(n_threads, true);
  size_t per = (nb + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = t * per, hi = std::min(nb, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi, t]() {
      for (size_t i = lo; i < hi; i++) {
        const auto& b = blocks[i];
        if (!inflate_block(raw.data() + b.cdata_off, b.cdata_len,
                           bf->udata.data() + b.out_off, b.isize)) {
          ok[t] = false;
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 0; t < (int)threads.size(); t++) {
    if (!ok[t]) {
      delete bf;
      return nullptr;
    }
  }

  if (!parse_bam_header(bf)) {
    delete bf;
    return nullptr;
  }
  const uint8_t* d = bf->udata.data();
  size_t n = bf->udata.size();
  size_t off = bf->records_start;
  while (off + 4 <= n) {
    int32_t bs = rd_i32(d + off);
    if (bs <= 0 || off + 4 + bs > n) break;
    bf->rec_offsets.push_back(off);
    off += 4 + bs;
  }
  return bf;
}

// Lazy open (the .bai jump path): read + block-scan the compressed file,
// inflate only the prefix needed for the header; bam_fetch_region later
// inflates just the indexed chunks of each window.
void* bam_open_lazy(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return nullptr;
  }
  void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (m == MAP_FAILED) return nullptr;
  auto* bf = new BamFile();
  bf->lazy = true;
  bf->raw = (const uint8_t*)m;
  bf->raw_len = (size_t)st.st_size;
  size_t total = 0;
  if (!scan_blocks(bf->raw, bf->raw_len, &bf->blocks, &total)) {
    delete bf;
    return nullptr;
  }
  // inflate leading blocks until the header parses
  for (size_t i = 0; i < bf->blocks.size(); i++) {
    const auto& b = bf->blocks[i];
    size_t base = bf->udata.size();
    bf->udata.resize(base + b.isize);
    if (!inflate_block(bf->raw + b.cdata_off, b.cdata_len,
                       bf->udata.data() + base, b.isize)) {
      delete bf;
      return nullptr;
    }
    if (parse_bam_header(bf)) return bf;
  }
  delete bf;
  return nullptr;
}

// Materialize the records overlapping [beg0, end0) on ref_id whose bytes
// live in the given .bai chunk ranges (virtual offsets, merged/disjoint,
// from the Python-side index query). Inflates only the touched BGZF
// blocks, applies the FULL overlap filter (rid match, pos < end0,
// alignment end >= beg0) so the handle's decoded state stays 1:1 with the
// returned batch (native pileup depends on that). Follow with
// bam_decode_tags. Returns the number of selected records, or -1.
int64_t bam_fetch_region(void* h, int want_ref_id, int64_t beg0, int64_t end0,
                         const uint64_t* chunk_begs,
                         const uint64_t* chunk_ends, int64_t n_chunks) {
  auto* bf = (BamFile*)h;
  if (!bf->lazy) return -1;
  bf->udata.clear();
  bf->rec_offsets.clear();

  const auto& blocks = bf->blocks;
  auto block_of = [&](uint64_t file_off) -> int64_t {
    // bsearch blocks by file_off
    int64_t lo = 0, hi = (int64_t)blocks.size() - 1, ans = -1;
    while (lo <= hi) {
      int64_t mid = (lo + hi) / 2;
      if ((uint64_t)blocks[mid].file_off <= file_off) {
        ans = mid;
        lo = mid + 1;
      } else {
        hi = mid - 1;
      }
    }
    return ans;
  };

  for (int64_t c = 0; c < n_chunks; c++) {
    uint64_t vbeg = chunk_begs[c], vend = chunk_ends[c];
    int64_t b0 = block_of(vbeg >> 16);
    int64_t b1 = block_of(vend >> 16);
    if (b0 < 0) continue;
    if (b1 < 0) b1 = (int64_t)blocks.size() - 1;
    if ((vend & 0xFFFF) == 0 && b1 > b0
        && (uint64_t)blocks[b1].file_off == (vend >> 16))
      b1--;  // chunk ends exactly at a block boundary
    // inflate the run [b0..b1] contiguously
    size_t run_base = bf->udata.size();
    std::vector<size_t> iso(b1 - b0 + 2, 0);  // prefix isizes within run
    size_t run_len = 0;
    for (int64_t j = b0; j <= b1; j++) {
      iso[j - b0] = run_len;
      run_len += blocks[j].isize;
    }
    iso[b1 - b0 + 1] = run_len;
    bf->udata.resize(run_base + run_len);
    for (int64_t j = b0; j <= b1; j++) {
      if (!inflate_block(bf->raw + blocks[j].cdata_off,
                         blocks[j].cdata_len,
                         bf->udata.data() + run_base + iso[j - b0],
                         blocks[j].isize))
        return -1;
    }
    // walk records from the chunk's start voff to its end voff
    size_t p = run_base + ((vbeg >> 16) == (uint64_t)blocks[b0].file_off
                               ? (vbeg & 0xFFFF)
                               : 0);
    size_t run_end = run_base + run_len;
    const uint8_t* d = bf->udata.data();
    while (p + 4 <= run_end) {
      // virtual offset of the record at p
      size_t local = p - run_base;
      int64_t j = b0;
      while (j < b1 && iso[j - b0 + 1] <= local) j++;
      uint64_t voff = ((uint64_t)blocks[j].file_off << 16)
                      | (uint64_t)(local - iso[j - b0]);
      if (voff >= vend) break;
      int32_t bs = rd_i32(d + p);
      if (bs <= 0 || p + 4 + (size_t)bs > run_end) break;
      const uint8_t* r = d + p + 4;
      int32_t rid = rd_i32(r);
      int32_t pos0 = rd_i32(r + 4);
      if (rid == want_ref_id && pos0 < end0) {
        // alignment end from the CIGAR's reference-consuming ops
        uint16_t n_cigar = rd_u16(r + 12);
        uint8_t l_read_name = r[8];
        const uint8_t* cp = r + 32 + l_read_name;
        int64_t ref_span = 0;
        for (int k = 0; k < n_cigar; k++) {
          uint32_t cv = rd_u32(cp + 4 * k);
          uint8_t op = cv & 0xF;
          if (op < 9 && kConsumesRef[op]) ref_span += cv >> 4;
        }
        int64_t end_pos0 = pos0 + (ref_span > 0 ? ref_span : 1) - 1;
        if (end_pos0 >= beg0) bf->rec_offsets.push_back(p);
      }
      p += 4 + bs;
    }
  }
  return (int64_t)bf->rec_offsets.size();
}

void bam_close(void* h) { delete (BamFile*)h; }

int bam_n_refs(void* h) { return (int)((BamFile*)h)->ref_names.size(); }
const char* bam_ref_name(void* h, int i) {
  return ((BamFile*)h)->ref_names[i].c_str();
}
int bam_ref_len(void* h, int i) { return ((BamFile*)h)->ref_lens[i]; }
int64_t bam_n_records(void* h) {
  return (int64_t)((BamFile*)h)->rec_offsets.size();
}
const char* bam_header_text(void* h) { return ((BamFile*)h)->text.c_str(); }
int64_t bam_header_text_len(void* h) {
  return (int64_t)((BamFile*)h)->text.size();
}

// Decode records mapped to ref_id (-1 = all) into the handle's columnar
// arrays, optionally with typed tag extraction (XD/XN/XR/XU strings,
// XV/XW ints — TagUtils analog). Returns number of records decoded.
int64_t bam_decode_tags(void* h, int want_ref_id, int parse_tags) {
  auto* bf = (BamFile*)h;
  const uint8_t* d = bf->udata.data();

  bf->ref_id.clear();
  bf->pos.clear();
  bf->end_pos.clear();
  bf->mapq.clear();
  bf->flag.clear();
  bf->cigar_off.assign(1, 0);
  bf->seq_off.assign(1, 0);
  bf->cigar_ops.clear();
  bf->cigar_lens.clear();
  bf->seq.clear();
  bf->qual.clear();
  bf->mate_ref_id.clear();
  bf->mate_pos.clear();
  bf->name_blob.clear();
  bf->name_off.assign(1, 0);
  for (int s = 0; s < 5; s++) {
    bf->tag_blobs[s].clear();
    bf->tag_offs[s].assign(1, 0);
  }
  bf->xv_val.clear();
  bf->xw_val.clear();
  bf->tag_present.clear();

  for (size_t off : bf->rec_offsets) {
    const uint8_t* r = d + off + 4;
    int32_t rid = rd_i32(r);
    if (want_ref_id >= 0 && rid != want_ref_id) continue;
    int32_t pos = rd_i32(r + 4);
    uint8_t l_read_name = r[8];
    uint8_t mapq = r[9];
    uint16_t n_cigar = rd_u16(r + 12);
    uint16_t flag = rd_u16(r + 14);
    int32_t l_seq = rd_i32(r + 16);

    bf->ref_id.push_back(rid);
    bf->pos.push_back(pos);
    bf->mapq.push_back(mapq);
    bf->flag.push_back(flag);
    bf->mate_ref_id.push_back(rd_i32(r + 20));
    bf->mate_pos.push_back(rd_i32(r + 24));
    bf->name_blob.append((const char*)r + 32, l_read_name - 1);
    bf->name_off.push_back((int64_t)bf->name_blob.size());

    const uint8_t* p = r + 32 + l_read_name;
    int64_t ref_span = 0;
    for (int i = 0; i < n_cigar; i++) {
      uint32_t c = rd_u32(p + 4 * i);
      uint8_t op = c & 0xF;
      int32_t len = c >> 4;
      bf->cigar_ops.push_back(op);
      bf->cigar_lens.push_back(len);
      if (op < 9 && kConsumesRef[op]) ref_span += len;
    }
    bf->cigar_off.push_back((int64_t)bf->cigar_ops.size());
    bf->end_pos.push_back(pos + (ref_span > 0 ? ref_span : 1) - 1);
    p += 4 * n_cigar;

    size_t sbase = bf->seq.size();
    bf->seq.resize(sbase + l_seq);
    for (int i = 0; i < l_seq; i++) {
      uint8_t packed = p[i / 2];
      uint8_t nib = (i % 2 == 0) ? (packed >> 4) : (packed & 0xF);
      bf->seq[sbase + i] = kNibbleToAllele[nib];
    }
    p += (l_seq + 1) / 2;
    bf->qual.insert(bf->qual.end(), p, p + l_seq);
    bf->seq_off.push_back((int64_t)bf->seq.size());
    p += l_seq;

    if (parse_tags) {
      // walk the tag block [p, rec_end): Z-typed XD/XN/XR/XU(/XW) strings,
      // integer-typed XV/XW values (BamReader._parse_string_tags semantics)
      int32_t block_size = rd_i32(d + off);
      const uint8_t* rec_end = d + off + 4 + block_size;
      uint8_t present = 0;
      int32_t xv = 0, xw = 0;
      const char* s_vals[5] = {nullptr, nullptr, nullptr, nullptr, nullptr};
      size_t s_lens[5] = {0, 0, 0, 0, 0};
      while (p + 3 <= rec_end) {
        char t0 = (char)p[0], t1 = (char)p[1];
        uint8_t typ = p[2];
        p += 3;
        int sz = 0;
        bool is_int = false;
        switch (typ) {
          case 'A': sz = 1; break;
          case 'c': case 'C': sz = 1; is_int = true; break;
          case 's': case 'S': sz = 2; is_int = true; break;
          case 'i': case 'I': sz = 4; is_int = true; break;
          case 'f': sz = 4; break;
          default: sz = -1;
        }
        if (sz > 0) {
          if (is_int && t0 == 'X' && (t1 == 'V' || t1 == 'W')) {
            int64_t v = 0;
            switch (typ) {
              case 'c': v = *(const int8_t*)p; break;
              case 'C': v = *p; break;
              case 's': { int16_t x; memcpy(&x, p, 2); v = x; } break;
              case 'S': { uint16_t x; memcpy(&x, p, 2); v = x; } break;
              case 'i': v = rd_i32(p); break;
              case 'I': v = (int64_t)rd_u32(p); break;
            }
            if (t1 == 'V') { xv = (int32_t)v; present |= 16; }
            else { xw = (int32_t)v; present |= 32; }
          }
          p += sz;
        } else if (typ == 'Z' || typ == 'H') {
          const uint8_t* e = p;
          while (e < rec_end && *e != 0) e++;
          if (t0 == 'X') {
            int slot = -1;
            if (t1 == 'D') { slot = 0; present |= 1; }
            else if (t1 == 'N') { slot = 1; present |= 2; }
            else if (t1 == 'R') { slot = 2; present |= 4; }
            else if (t1 == 'U') { slot = 3; present |= 8; }
            else if (t1 == 'W') { slot = 4; present |= 64; }
            if (slot >= 0) {
              s_vals[slot] = (const char*)p;
              s_lens[slot] = (size_t)(e - p);
            }
          }
          p = e + 1;
        } else if (typ == 'B') {
          uint8_t sub = *p;
          int32_t count = rd_i32(p + 1);
          int ssz = (sub == 'c' || sub == 'C') ? 1
                    : (sub == 's' || sub == 'S') ? 2
                    : (sub == 'i' || sub == 'I' || sub == 'f') ? 4 : 1;
          p += 5 + (int64_t)ssz * count;
        } else {
          break;
        }
      }
      for (int s = 0; s < 5; s++) {
        if (s_vals[s]) bf->tag_blobs[s].append(s_vals[s], s_lens[s]);
        bf->tag_offs[s].push_back((int64_t)bf->tag_blobs[s].size());
      }
      bf->xv_val.push_back(xv);
      bf->xw_val.push_back(xw);
      bf->tag_present.push_back(present);
    }
  }
  return (int64_t)bf->ref_id.size();
}

int64_t bam_decode(void* h, int want_ref_id) {
  return bam_decode_tags(h, want_ref_id, 0);
}

// accessors for the decoded batch (valid until the next bam_decode)
const int32_t* bam_col_ref_id(void* h) { return ((BamFile*)h)->ref_id.data(); }
const int32_t* bam_col_pos(void* h) { return ((BamFile*)h)->pos.data(); }
const int32_t* bam_col_end_pos(void* h) { return ((BamFile*)h)->end_pos.data(); }
const uint8_t* bam_col_mapq(void* h) { return ((BamFile*)h)->mapq.data(); }
const uint16_t* bam_col_flag(void* h) { return ((BamFile*)h)->flag.data(); }
const int64_t* bam_col_cigar_off(void* h) {
  return ((BamFile*)h)->cigar_off.data();
}
const uint8_t* bam_col_cigar_ops(void* h) {
  return ((BamFile*)h)->cigar_ops.data();
}
const int32_t* bam_col_cigar_lens(void* h) {
  return ((BamFile*)h)->cigar_lens.data();
}
const int64_t* bam_col_seq_off(void* h) { return ((BamFile*)h)->seq_off.data(); }
const int8_t* bam_col_seq(void* h) { return ((BamFile*)h)->seq.data(); }
const uint8_t* bam_col_qual(void* h) { return ((BamFile*)h)->qual.data(); }
int64_t bam_total_cigar(void* h) {
  return (int64_t)((BamFile*)h)->cigar_ops.size();
}
int64_t bam_total_bases(void* h) { return (int64_t)((BamFile*)h)->seq.size(); }
const int32_t* bam_col_mate_ref_id(void* h) {
  return ((BamFile*)h)->mate_ref_id.data();
}
const int32_t* bam_col_mate_pos(void* h) {
  return ((BamFile*)h)->mate_pos.data();
}
const char* bam_col_name_blob(void* h) {
  return ((BamFile*)h)->name_blob.data();
}
const int64_t* bam_col_name_off(void* h) {
  return ((BamFile*)h)->name_off.data();
}
// tag columns (valid after bam_decode_tags with parse_tags=1);
// slot: 0 XD, 1 XN, 2 XR, 3 XU, 4 XW-string
const char* bam_col_tag_blob(void* h, int slot) {
  return ((BamFile*)h)->tag_blobs[slot].data();
}
const int64_t* bam_col_tag_off(void* h, int slot) {
  return ((BamFile*)h)->tag_offs[slot].data();
}
const int32_t* bam_col_xv_val(void* h) { return ((BamFile*)h)->xv_val.data(); }
const int32_t* bam_col_xw_val(void* h) { return ((BamFile*)h)->xw_val.data(); }
const uint8_t* bam_col_tag_present(void* h) {
  return ((BamFile*)h)->tag_present.data();
}

// Stitched per-base directions of the decoded batch (valid after
// bam_decode_tags with parse_tags=1): Read.CreateSequencedBaseDirectionMap
// as pileup/directions.sequenced_direction_map computes it. Each read's XD
// string ("20F30S21R": F 0, R 1, S 2) expands to one direction an expanded
// CIGAR position; read-consuming ops take their entries, D and N consume
// entries only, and a read op that runs past the XD's end takes its last
// direction (forward without one), over the Python slice the map pads.
// A read without an XD, or with an empty one, takes its strand.
//   base_dirs: int8 [total bases], one direction a sequenced base;
//   del_dirs:  int8 [total cigar ops], on each D op of a read with an XD
//              the direction CandidateVariantFinder.GetSupportDirection
//              gives its deletion (directions.support_direction with the
//              expanded maps: the first and last expanded entries between
//              the two flanking bases, the later one where the first is
//              stitched), -1 on every other op.
// Returns the number of reads whose XD holds a stitched segment.
int64_t bam_xd_directions(void* h, int8_t* base_dirs, int8_t* del_dirs) {
  auto* bf = (BamFile*)h;
  const size_t n = bf->ref_id.size();
  if (bf->tag_present.size() != n) return -1;
  const std::string& blob = bf->tag_blobs[0];
  const std::vector<int64_t>& toff = bf->tag_offs[0];
  std::vector<int8_t> expanded;   // one direction an expanded position
  std::vector<int8_t> dm;         // the read's direction map
  std::vector<int64_t> exp_of;    // expanded index of each sequenced base
  int64_t n_stitched = 0;
  for (size_t i = 0; i < n; i++) {
    const int64_t co = bf->cigar_off[i], ce = bf->cigar_off[i + 1];
    const int64_t so = bf->seq_off[i], se = bf->seq_off[i + 1];
    for (int64_t c = co; c < ce; c++) del_dirs[c] = -1;
    const int64_t xs = toff[i], xe = toff[i + 1];
    if (!(bf->tag_present[i] & 1) || xe <= xs) {
      memset(base_dirs + so, (bf->flag[i] & 0x10) ? 1 : 0, se - so);
      continue;
    }
    // the expanded positions the map can read: the read-consuming ops'
    // bases (the map's own length L) and the D and N entries
    int64_t L = 0, need = 0;
    for (int64_t c = co; c < ce; c++) {
      const uint8_t op = bf->cigar_ops[c];
      if (op < 9 && kConsumesRead[op]) L += bf->cigar_lens[c];
      if (op < 9 && (kConsumesRead[op] || op == 2 || op == 3))
        need += bf->cigar_lens[c];
    }
    // the XD's <digits><F|R|S> segments (re.findall(r"(\d+)([FRS])")),
    // expanded as far as the CIGAR reaches; E counts every entry, pad is
    // the last one's direction
    expanded.clear();
    bool stitched = false;
    int64_t E = 0;
    int8_t pad = 0;
    for (int64_t p = xs; p < xe;) {
      if (blob[p] < '0' || blob[p] > '9') { p++; continue; }
      int64_t q = p, len = 0;
      while (q < xe && blob[q] >= '0' && blob[q] <= '9') {
        len = std::min<int64_t>(len * 10 + (blob[q] - '0'), INT64_C(1) << 40);
        q++;
      }
      if (q < xe && (blob[q] == 'F' || blob[q] == 'R' || blob[q] == 'S')) {
        const int8_t d = blob[q] == 'F' ? 0 : blob[q] == 'R' ? 1 : 2;
        if (len > 0) {
          stitched |= d == 2;
          pad = d;
          const int64_t room = need - (int64_t)expanded.size();
          expanded.insert(expanded.end(), (size_t)std::min(len, room), d);
          E += len;
        }
        q++;
      }
      p = q;
    }
    n_stitched += stitched;
    dm.assign((size_t)L, 0);
    exp_of.assign((size_t)L, 0);
    int64_t seq_i = 0, exp_i = 0;
    for (int64_t c = co; c < ce; c++) {
      const uint8_t op = bf->cigar_ops[c];
      const int64_t ln = bf->cigar_lens[c];
      if (op < 9 && kConsumesRead[op]) {
        const int64_t k = std::min(ln, E - exp_i);
        if (k > 0)
          memcpy(dm.data() + seq_i, expanded.data() + exp_i, (size_t)k);
        if (k < ln) {
          // out[seq_i + k : seq_i + ln] = pad, a Python slice: a negative
          // start counts from the map's end
          int64_t a = seq_i + k, b = seq_i + ln;
          if (a < 0) a = std::max<int64_t>(a + L, 0);
          b = std::min(b, L);
          if (a < b) memset(dm.data() + a, pad, (size_t)(b - a));
        }
        for (int64_t j = 0; j < ln; j++) exp_of[seq_i + j] = exp_i + j;
        seq_i += ln;
        exp_i += ln;
      } else if (op == 2 || op == 3) {
        exp_i += ln;
      }
    }
    const int64_t m = std::min(L, se - so);
    if (m > 0) memcpy(base_dirs + so, dm.data(), (size_t)m);
    if (m < se - so)
      memset(base_dirs + so + m, (bf->flag[i] & 0x10) ? 1 : 0, se - so - m);
    // deletions: support_direction(DELETION, dm, start, 1, expanded, exp_of)
    int64_t start = 0;
    for (int64_t c = co; c < ce; c++) {
      const uint8_t op = bf->cigar_ops[c];
      if (op == 2 && L > 0) {
        const int64_t left = start - 1, right = start, last = L - 1;
        int8_t d;
        if (right == 0) {
          d = dm[0];
        } else if (left == last) {
          d = dm[last];
        } else {
          const int64_t li = exp_of[left] + 1, ri = exp_of[right] - 1;
          int8_t sd, ed;
          if (li >= 0 && li < E && ri >= 0 && ri < E) {
            sd = expanded[li];
            ed = expanded[ri];
          } else {
            sd = dm[left];
            ed = dm[right];
          }
          d = sd == 2 ? ed : sd;
        }
        del_dirs[c] = d;
      }
      if (op < 9 && kConsumesRead[op]) start += bf->cigar_lens[c];
    }
  }
  return n_stitched;
}

// ---------------------------------------------------------------------------
// Columnar gVCF reference-line rendering (fast_gvcf.format_reference_lines
// hot tail: one line per covered locus; the QUAL..SAMPLE tail is memoized
// per unique scoring tuple on the Python side and passed as a blob here)
// ---------------------------------------------------------------------------

namespace {
struct RenderedLines {
  std::string blob;               // all lines concatenated, incl. '\n'
  std::vector<int64_t> line_off;  // [n+1] offsets into blob
};
}  // namespace

extern "C" {

// Build "<prefix><pos>\t.\t<base><tail>\n" per row. tails are indexed by
// inv[i] into tails_blob via tail_off ([n_tails+1]). Returns an opaque
// handle; read with rl_* accessors, release with rl_free.
void* render_ref_lines(const char* prefix, int64_t prefix_len, int64_t n,
                       const int64_t* pos, const int32_t* inv,
                       const uint8_t* bases, const char* tails_blob,
                       const int64_t* tail_off) {
  auto* out = new RenderedLines();
  out->line_off.reserve(n + 1);
  out->line_off.push_back(0);
  // estimate: prefix + 10-digit pos + 3 + 1 + avg tail 64
  out->blob.reserve((size_t)n * (prefix_len + 78));
  char digits[24];
  char* const dend = digits + sizeof digits;
  for (int64_t i = 0; i < n; i++) {
    out->blob.append(prefix, prefix_len);
    // manual itoa (positions are non-negative): ~6x faster than snprintf
    // on this loop, which renders every gVCF locus
    char* dp = dend;
    int64_t v = pos[i];
    do { *--dp = (char)('0' + (v % 10)); v /= 10; } while (v > 0);
    out->blob.append(dp, dend - dp);
    out->blob.append("\t.\t", 3);
    out->blob.push_back((char)bases[i]);
    int64_t t = inv[i];
    out->blob.append(tails_blob + tail_off[t], tail_off[t + 1] - tail_off[t]);
    out->blob.push_back('\n');
    out->line_off.push_back((int64_t)out->blob.size());
  }
  return out;
}

int64_t rl_blob_len(void* h) { return (int64_t)((RenderedLines*)h)->blob.size(); }
const char* rl_blob(void* h) { return ((RenderedLines*)h)->blob.data(); }
const int64_t* rl_line_off(void* h) {
  return ((RenderedLines*)h)->line_off.data();
}
void rl_free(void* h) { delete (RenderedLines*)h; }

}  // extern "C"

// Standalone BGZF helpers (gzip-compatible writer support)
int64_t bgzf_decompress_size(const uint8_t* data, int64_t n) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!scan_blocks(data, (size_t)n, &blocks, &total)) return -1;
  return (int64_t)total;
}

int bgzf_decompress(const uint8_t* data, int64_t n, uint8_t* out,
                    int64_t out_len, int n_threads) {
  std::vector<BgzfBlock> blocks;
  size_t total = 0;
  if (!scan_blocks(data, (size_t)n, &blocks, &total)) return -1;
  if ((int64_t)total != out_len) return -2;
  if (n_threads < 1) n_threads = 1;
  size_t nb = blocks.size();
  std::vector<std::thread> threads;
  size_t per = (nb + n_threads - 1) / n_threads;
  std::vector<int> rc(n_threads, 0);
  for (int t = 0; t < n_threads; t++) {
    size_t lo = t * per, hi = std::min(nb, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi, t]() {
      for (size_t i = lo; i < hi; i++) {
        const auto& b = blocks[i];
        if (!inflate_block(data + b.cdata_off, b.cdata_len, out + b.out_off,
                           b.isize))
          rc[t] = -3;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int v : rc)
    if (v != 0) return v;
  return 0;
}

// Parallel BGZF compressor (the BamWriterMultithreaded counterpart,
// reference Alignment.IO/BamWriterMultithreaded): deflates fixed 0xFF00-byte
// uncompressed chunks across a thread pool; block file offsets follow from
// the prefix sum of compressed sizes so callers can compute virtual offsets
// analytically after the fact.
static const size_t kBgzfChunk = 0xFF00;
static const uint8_t kBgzfEof[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00};

struct BgzfCompressed {
  std::vector<uint8_t> data;        // concatenated blocks (incl. EOF block)
  std::vector<int64_t> block_off;   // file offset of each data block
};

static bool deflate_chunk(const uint8_t* src, size_t n, int level,
                          std::vector<uint8_t>* out) {
  z_stream zs{};
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  out->resize(deflateBound(&zs, n) + 26);
  uint8_t* blk = out->data();
  // 18-byte BGZF header; BSIZE patched below
  static const uint8_t hdr[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0,
                                  0,    0xff, 0x06, 0x00, 0x42, 0x43, 0x02, 0x00};
  memcpy(blk, hdr, 16);
  zs.next_in = const_cast<uint8_t*>(src);
  zs.avail_in = (uInt)n;
  zs.next_out = blk + 18;
  zs.avail_out = (uInt)(out->size() - 26);
  if (deflate(&zs, Z_FINISH) != Z_STREAM_END) {
    deflateEnd(&zs);
    return false;
  }
  size_t clen = zs.total_out;
  deflateEnd(&zs);
  size_t bsize = clen + 26;
  if (bsize - 1 > 0xFFFF) return false;
  blk[16] = (uint8_t)((bsize - 1) & 0xFF);
  blk[17] = (uint8_t)((bsize - 1) >> 8);
  uint32_t crc = crc32(0, src, n);
  uint8_t* tail = blk + 18 + clen;
  memcpy(tail, &crc, 4);
  uint32_t isize = (uint32_t)n;
  memcpy(tail + 4, &isize, 4);
  out->resize(bsize);
  return true;
}

void* bgzf_compress(const uint8_t* data, int64_t n, int level, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  size_t nblk = (size_t)((n + kBgzfChunk - 1) / kBgzfChunk);
  std::vector<std::vector<uint8_t>> parts(nblk);
  std::vector<std::thread> threads;
  std::vector<int> rc(n_threads, 0);
  size_t per = (nblk + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; t++) {
    size_t lo = t * per, hi = std::min(nblk, lo + per);
    if (lo >= hi) break;
    threads.emplace_back([&, lo, hi, t]() {
      for (size_t i = lo; i < hi; i++) {
        size_t off = i * kBgzfChunk;
        size_t len = std::min(kBgzfChunk, (size_t)n - off);
        if (!deflate_chunk(data + off, len, level, &parts[i])) rc[t] = -1;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int v : rc)
    if (v != 0) return nullptr;
  auto* res = new BgzfCompressed();
  res->block_off.resize(nblk + 1);
  int64_t total = 0;
  for (size_t i = 0; i < nblk; i++) {
    res->block_off[i] = total;
    total += (int64_t)parts[i].size();
  }
  res->block_off[nblk] = total;
  res->data.reserve(total + sizeof(kBgzfEof));
  for (auto& p : parts) res->data.insert(res->data.end(), p.begin(), p.end());
  res->data.insert(res->data.end(), kBgzfEof, kBgzfEof + sizeof(kBgzfEof));
  return res;
}

int64_t bgzfc_data_len(void* h) {
  return (int64_t)((BgzfCompressed*)h)->data.size();
}
const uint8_t* bgzfc_data(void* h) {
  return ((BgzfCompressed*)h)->data.data();
}
int64_t bgzfc_n_blocks(void* h) {
  return (int64_t)((BgzfCompressed*)h)->block_off.size() - 1;
}
const int64_t* bgzfc_block_off(void* h) {
  return ((BgzfCompressed*)h)->block_off.data();
}
void bgzfc_free(void* h) { delete (BgzfCompressed*)h; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Native pileup accumulation (RegionStateManager.AddAlleleCounts hot loop)
// ---------------------------------------------------------------------------
//
// Walks the decoded columnar batch, scattering every counted base
// (including deletion gaps and terminal deletions) into block-tiled
// anchor-summed totals plus sparse anchor-resolved rows, exactly matching
// the Python pileup/events.py + pileup/counts.py semantics.
//
// The touched blocks are cut into slabs of whole blocks, one thread a slab.
// A slab owns a contiguous range of positions: it walks, in batch order, the
// kept reads that meet its range, and applies only the adds and mismatch
// events at positions it owns. Every position has one owner, so its f64
// quality sums add in read order at any slab count, and the dense outputs
// are the one-slab pass's bit for bit. The mismatch events come out slab
// after slab: the one-slab pass's multiset, in another order.

namespace {

inline int anchor_index(int64_t gpos, int64_t start1, int64_t end1, int A) {
  int64_t left = gpos - start1;
  int64_t right = end1 - gpos;
  if (left >= right) {
    if (right >= A) return A;
    return 2 * A - (int)right;  // num_idx - right - 1 = 2A+1 - right - 1
  }
  if (left >= A) return A;
  return (int)left;
}

// static init (no lazy racing writes): err[q] = 10^(-q/10)
const std::array<double, 128> kQualToErr = [] {
  std::array<double, 128> t{};
  for (int q = 0; q < 128; q++) t[q] = pow(10.0, -q / 10.0);
  return t;
}();

// Resize a result buffer without zeroing it (its slabs zero their own
// parts, on their own threads); a buffer too small is replaced, not copied.
template <class V>
void size_uninit(V& v, size_t n) {
  if (n > v.capacity()) V().swap(v);
  v.resize(n);
}

// One slab of a pass: the positions [lo, hi] (1-based) it owns, the block
// slots [s0, s1) and anchored rows [a0, a1) at those positions, the first
// kept read that may reach lo, and its mismatch events. Aligned to a cache
// line: each thread appends to its own vectors.
struct alignas(64) Slab {
  int64_t lo, hi;
  int64_t s0, s1;
  int64_t a0, a1;
  size_t r0;
  std::vector<int64_t> mm_gpos;
  std::vector<int8_t> mm_alt, mm_dir, mm_flags;
};

// What every slab of one pass reads; res's dense buffers are written at
// the slab's own slots and rows only.
struct PassInputs {
  const BamFile* bf;
  PileupResult* res;
  bool sorted;  // the kept reads' starts never decrease
  int min_bq, A, K;
  int64_t block_size;
  const int64_t* anchored_pos;
  int64_t n_anchored;
  const int8_t* base_dirs;
  const int8_t* ref_codes;
  int64_t ref_len;
  bool track_open_ended;
  // block key -> slot (-1 untouched) over the keys [kmin, kmin + n_span)
  const int64_t* slot_of;
  int64_t kmin, n_span;
};

void walk_slab(const PassInputs& p, Slab& s) {
  const BamFile* bf = p.bf;
  PileupResult& res = *p.res;
  const int64_t block_size = p.block_size;
  const int A = p.A, K = p.K, min_bq = p.min_bq;
  const int64_t lo = s.lo, hi = s.hi;
  const int8_t* base_dirs = p.base_dirs;
  const int8_t* ref_codes = p.ref_codes;
  const int64_t ref_len = p.ref_len;
  const int64_t* anchored_pos = p.anchored_pos;
  const int64_t n_anchored = p.n_anchored;
  int32_t* counts = res.counts_t.data();
  double* quals = res.qual_t.data();
  int32_t* acounts = res.anchored_counts.data();
  double* aquals = res.anchored_quals.data();
  std::fill(counts + s.s0 * block_size * 18, counts + s.s1 * block_size * 18,
            0);
  std::fill(quals + s.s0 * block_size * 18, quals + s.s1 * block_size * 18,
            0.0);
  std::fill(acounts + s.a0 * 18 * K, acounts + s.a1 * 18 * K, 0);
  std::fill(aquals + s.a0 * 18 * K, aquals + s.a1 * 18 * K, 0.0);

  // the positions [m_lo, m_hi] of the last block found start at row
  // m_row0: consecutive bases almost always stay in one 1000-bp block, so
  // the key's division and slot lookup run about once a block transition
  int64_t m_lo = 1, m_hi = 0, m_row0 = 0;
  auto row_of = [&](int64_t gpos) -> int64_t {
    if (gpos >= m_lo && gpos <= m_hi) return m_row0 + (gpos - m_lo);
    int64_t key = (gpos + block_size - 1) / block_size;
    int64_t j = key - p.kmin;
    int64_t slot = (j >= 0 && j < p.n_span) ? p.slot_of[j] : -1;
    if (slot < 0) return -1;
    if (key >= 1) {
      m_lo = (key - 1) * block_size + 1;
      m_hi = key * block_size;
      m_row0 = slot * block_size;
    }
    return slot * block_size + (gpos - 1) % block_size;
  };
  const int64_t anch_lo = n_anchored ? anchored_pos[0] : 0;
  const int64_t anch_hi = n_anchored ? anchored_pos[n_anchored - 1] : -1;
  // cursor-hinted membership test: base events arrive in near-monotone
  // gpos order (sorted reads, in-read walks), so the hint advances O(1)
  // per event instead of a fresh binary search per base (~12 probes per
  // event over a WGS window's anchored set)
  int64_t a_hint = s.a0;
  auto anchored_of = [&](int64_t gpos) -> int64_t {
    if (gpos < anch_lo || gpos > anch_hi) return -1;  // covers n_anchored==0
    if (a_hint >= n_anchored || anchored_pos[a_hint] < gpos ||
        (a_hint > 0 && anchored_pos[a_hint - 1] >= gpos)) {
      if (a_hint < n_anchored && anchored_pos[a_hint] < gpos &&
          gpos - anchored_pos[a_hint] < 4096) {
        while (a_hint < n_anchored && anchored_pos[a_hint] < gpos) a_hint++;
      } else {
        a_hint = std::lower_bound(anchored_pos, anchored_pos + n_anchored,
                                  gpos) - anchored_pos;
      }
    }
    if (a_hint < n_anchored && anchored_pos[a_hint] == gpos) return a_hint;
    return -1;
  };
  auto add = [&](int64_t gpos, int allele, int dir, int anchor, double qerr) {
    if (gpos < lo || gpos > hi) return;  // another slab's position
    int64_t row = row_of(gpos);
    if (row >= 0) {
      int64_t idx = (row * 6 + allele) * 3 + dir;
      counts[idx] += 1;
      quals[idx] += qerr;
    }
    int64_t ar = anchored_of(gpos);
    if (ar >= 0) {
      int64_t idx = ((ar * 6 + allele) * 3 + dir) * K + anchor;
      acounts[idx] += 1;
      aquals[idx] += qerr;
    }
  };

  const std::vector<size_t>& kept = res.kept;
  for (size_t r = s.r0; r < kept.size(); r++) {
    size_t i = kept[r];
    int64_t start1 = (int64_t)bf->pos[i] + 1;
    int64_t end1 = (int64_t)bf->end_pos[i] + 1;
    if (start1 > hi) {
      if (p.sorted) break;
      continue;
    }
    if (end1 < lo) continue;
    int64_t co = bf->cigar_off[i], ce = bf->cigar_off[i + 1];
    int64_t so = bf->seq_off[i], se = bf->seq_off[i + 1];
    int64_t read_len = se - so;
    int dir_uniform = (bf->flag[i] & 0x10) ? 1 : 0;

    int64_t ref = start1;
    int64_t rd = 0;
    int64_t last_pos = start1 - 1;
    for (int64_t c = co; c < ce; c++) {
      uint8_t op = bf->cigar_ops[c];
      int32_t ln = bf->cigar_lens[c];
      if (op == 0 || op == 7 || op == 8) {  // M
        for (int32_t k = 0; k < ln; k++) {
          int64_t gpos = ref + k;
          int64_t sidx = so + rd + k;
          uint8_t q = bf->qual[sidx];
          int dir = base_dirs ? base_dirs[sidx] : dir_uniform;
          // deletion gap before this base
          if (gpos - last_pos - 1 > 0) {
            uint8_t prevq = (rd + k > 0) ? bf->qual[sidx - 1] : q;
            if (q >= min_bq && prevq >= min_bq) {
              int anc = anchor_index(gpos, start1, end1, A);
              for (int64_t j = last_pos + 1; j < gpos; j++)
                add(j, 5, dir, anc, 0.0);
            }
          }
          int allele = bf->seq[sidx];
          if (q < min_bq) allele = 4;  // N
          int anc = anchor_index(gpos, start1, end1, A);
          add(gpos, allele, dir, anc, kQualToErr[q & 0x7f]);
          last_pos = gpos;
        }
        ref += ln;
        rd += ln;
      } else if (op == 1 || op == 4) {  // I / S
        rd += ln;
      } else if (op == 2 || op == 3) {  // D / N: handled as gaps above
        ref += ln;
      }
    }
    // SNV mismatch extraction (second sweep over M ops, with open-end rules)
    if (ref_codes) {
      // effective first/last ops for boundary annotation
      uint8_t f_eff = (ce > co) ? bf->cigar_ops[co] : 9;
      if (f_eff == 4 && ce - co > 1) f_eff = bf->cigar_ops[co + 1];
      uint8_t l_eff = (ce > co) ? bf->cigar_ops[ce - 1] : 9;
      if (l_eff == 4 && ce - co > 1) l_eff = bf->cigar_ops[ce - 2];
      bool first_m = (f_eff == 0 || f_eff == 7 || f_eff == 8);
      bool last_m = (l_eff == 0 || l_eff == 7 || l_eff == 8);

      int64_t ref2 = start1;
      int64_t rd2 = 0;
      for (int64_t c = co; c < ce; c++) {
        uint8_t op = bf->cigar_ops[c];
        int32_t ln = bf->cigar_lens[c];
        if (op == 0 || op == 7 || op == 8) {
          for (int32_t k = 0; k < ln; k++) {
            int64_t gpos = ref2 + k;
            if (gpos > ref_len) break;
            if (gpos < lo || gpos > hi) continue;  // another slab's position
            int64_t sidx = so + rd2 + k;
            int8_t rc = ref_codes[gpos - 1];
            int8_t bc = bf->seq[sidx];
            uint8_t q = bf->qual[sidx];
            if (q < min_bq || bc == 4 || rc == 4 || bc == rc) continue;
            bool open_l = false, open_r = false;
            if (p.track_open_ended) {
              // state machine: next base in the same M op is bad
              if (k + 1 < ln && gpos + 1 <= ref_len) {
                int64_t nidx = sidx + 1;
                int8_t nrc = ref_codes[gpos];
                if (bf->qual[nidx] < min_bq || bf->seq[nidx] == 4 || nrc == 4)
                  open_r = true;
              }
              if (first_m && gpos == start1) open_l = true;
              if (last_m && gpos == end1) open_r = true;
            }
            int64_t left = gpos - start1;
            int64_t right = end1 - gpos;
            bool wa = (left < right ? left : right) > 0;
            int dir = base_dirs ? base_dirs[sidx] : dir_uniform;
            s.mm_gpos.push_back(gpos);
            s.mm_alt.push_back(bc);
            s.mm_dir.push_back((int8_t)dir);
            s.mm_flags.push_back((int8_t)((open_r ? 1 : 0) |
                                          (open_l ? 2 : 0) | (wa ? 4 : 0)));
          }
          ref2 += ln;
          rd2 += ln;
        } else if (op == 1 || op == 4) {
          rd2 += ln;
        } else if (op == 2 || op == 3) {
          ref2 += ln;
        }
      }
    }

    // terminal deletion (cigar ends in D, or D before trailing S)
    uint8_t last_op = (ce > co) ? bf->cigar_ops[ce - 1] : 0;
    uint8_t prev_op = (ce - co >= 2) ? bf->cigar_ops[ce - 2] : 0;
    bool ends_d = last_op == 2;
    bool ends_d_s = (last_op == 4 && prev_op == 2);
    if (ends_d || ends_d_s) {
      int32_t dlen = ends_d_s ? bf->cigar_lens[ce - 2] : bf->cigar_lens[ce - 1];
      int64_t chk = ends_d_s ? read_len - bf->cigar_lens[ce - 1] : read_len - 1;
      if (read_len > 0) {
        uint8_t after = (chk < read_len) ? bf->qual[so + chk] : bf->qual[so + chk - 1];
        uint8_t before = (chk > 0) ? bf->qual[so + chk - 1] : after;
        if (after >= min_bq && before >= min_bq) {
          int64_t di = so + (chk < read_len ? chk : read_len - 1);
          int dir = base_dirs ? base_dirs[di] : dir_uniform;
          int64_t last_mapped = end1 - dlen;
          for (int32_t j = 1; j <= dlen; j++)
            add(last_mapped + j, 5, dir, K - 1, 0.0);
        }
      }
    }
  }

  // per-position gVCF scoring tuples (sup/cov by direction + N total)
  if (!ref_codes) return;
  const int64_t* keys = res.block_keys.data();
  for (int64_t slot = s.s0; slot < s.s1; slot++) {
    int64_t base_pos = (keys[slot] - 1) * block_size;  // 0-based
    for (int64_t off = 0; off < block_size; off++) {
      int64_t gpos0 = base_pos + off;
      const int32_t* cnt = &counts[(slot * block_size + off) * 18];
      int32_t* out = &res.pos_tuples[(slot * block_size + off) * 8];
      int ref_allele = (gpos0 < ref_len) ? ref_codes[gpos0] : -1;
      out[6] = 0;
      out[7] = 0;
      for (int d = 0; d < 3; d++) {
        out[d] = ref_allele >= 0 ? cnt[ref_allele * 3 + d] : 0;
        // coverage alleles: A,G,C,T (0-3) + deletion (5); N (4) excluded
        out[3 + d] = cnt[0 * 3 + d] + cnt[1 * 3 + d] + cnt[2 * 3 + d] +
                     cnt[3 * 3 + d] + cnt[5 * 3 + d];
        out[6] += cnt[4 * 3 + d];
      }
    }
  }
}

}  // namespace

extern "C" {

// Full pass over the decoded batch in handle h: pileup accumulation, and
// SNV mismatch extraction and scoring tuples when a reference sequence
// (allele codes) is supplied. keep: uint8 [n] mask; anchored_pos: sorted
// int64 [n_anchored]; base_dirs: optional int8 per sequenced base (stitched
// XD), null = strand. track_open_ended enables the open-end flags
// (bad-next-base flush + read-boundary annotation). The pass runs in
// min(max_slabs, touched blocks / min_slab_blocks) slabs, at least one;
// pileup_n_slabs gives the count. Returns the number of touched blocks.
int64_t bam_pileup_mm(void* h, const uint8_t* keep, int min_bq, int anchor_size,
                      int block_size, const int64_t* anchored_pos,
                      int64_t n_anchored, const int8_t* base_dirs,
                      const int8_t* ref_codes, int64_t ref_len,
                      int track_open_ended, int max_slabs,
                      int min_slab_blocks) {
  auto* bf = (BamFile*)h;
  // reuse the handle's result buffers across calls: repeat pileups write
  // warm pages instead of faulting ~30k fresh pages per call (the dense
  // dual tensors are ~130 MB at WES shapes; fault cost dominated round-3
  // profiles)
  if (!bf->pileup) bf->pileup = std::make_unique<PileupResult>();
  auto& res = *bf->pileup;
  const size_t n = bf->ref_id.size();
  const int64_t bs = block_size;

  // pass 1: the kept reads, the block keys they span, their longest
  // reference span, and whether their starts are sorted
  std::vector<size_t>& kept = res.kept;
  kept.clear();
  int64_t kmin = 0, kmax = -1, max_span = 0;
  int64_t prev_start = INT64_MIN;
  bool sorted = true;
  for (size_t i = 0; i < n; i++) {
    if (!keep[i]) continue;
    int64_t start1 = (int64_t)bf->pos[i] + 1;
    int64_t end1 = (int64_t)bf->end_pos[i] + 1;
    int64_t k0 = (start1 + bs - 1) / bs;
    int64_t k1 = (end1 + bs - 1) / bs;
    if (kept.empty()) {
      kmin = k0;
      kmax = k1;
    }
    kmin = std::min(kmin, k0);
    kmax = std::max(kmax, k1);
    max_span = std::max(max_span, end1 - start1);
    sorted = sorted && start1 >= prev_start;
    prev_start = start1;
    kept.push_back(i);
  }
  // one mark a block of the span: the reads touching it, then its slot
  const int64_t n_span = kmax - kmin + 1;
  std::vector<int64_t> slot_of(n_span, 0);
  for (size_t i : kept) {
    int64_t k0 = ((int64_t)bf->pos[i] + bs) / bs;
    int64_t k1 = ((int64_t)bf->end_pos[i] + bs) / bs;
    for (int64_t k = k0; k <= k1; k++) slot_of[k - kmin]++;
  }
  std::vector<int64_t>& keys = res.block_keys;
  keys.clear();
  std::vector<int64_t> weight_before{0};  // reads-by-blocks before each slot
  for (int64_t j = 0; j < n_span; j++) {
    if (slot_of[j] == 0) {
      slot_of[j] = -1;
      continue;
    }
    weight_before.push_back(weight_before.back() + slot_of[j]);
    slot_of[j] = (int64_t)keys.size();
    keys.push_back(kmin + j);
  }
  const int64_t nb = (int64_t)keys.size();
  const int K = 2 * anchor_size + 1;
  size_uninit(res.counts_t, nb * bs * 18);
  size_uninit(res.qual_t, nb * bs * 18);
  size_uninit(res.anchored_counts, n_anchored * 18 * K);
  size_uninit(res.anchored_quals, n_anchored * 18 * K);
  if (ref_codes)
    size_uninit(res.pos_tuples, nb * bs * 8);
  else
    res.pos_tuples.clear();

  // slabs of whole blocks, cut where the reads-by-blocks weight reaches
  // each slab's even share (depth differs between a panel's targets), at
  // least one block a slab
  const int64_t n_slabs = std::max<int64_t>(
      1, std::min<int64_t>(max_slabs, nb / std::max(min_slab_blocks, 1)));
  std::vector<int64_t> cut(n_slabs + 1, nb);
  cut[0] = 0;
  for (int64_t s = 1; s < n_slabs; s++) {
    int64_t share = weight_before[nb] * s / n_slabs;
    int64_t b = cut[s - 1] + 1;
    while (b < nb - (n_slabs - s) && weight_before[b] < share) b++;
    cut[s] = b;
  }
  std::vector<Slab> slabs(n_slabs);
  for (int64_t s = 0; s < n_slabs; s++) {
    Slab& sl = slabs[s];
    sl.s0 = cut[s];
    sl.s1 = cut[s + 1];
    sl.lo = s == 0 ? INT64_MIN : (keys[sl.s0] - 1) * bs + 1;
    sl.hi = s == n_slabs - 1 ? INT64_MAX : (keys[sl.s1] - 1) * bs;
    sl.a0 = s == 0 ? 0
                   : std::lower_bound(anchored_pos, anchored_pos + n_anchored,
                                      sl.lo) - anchored_pos;
    sl.a1 = s == n_slabs - 1
                ? n_anchored
                : std::lower_bound(anchored_pos, anchored_pos + n_anchored,
                                   sl.hi + 1) - anchored_pos;
    // in sorted batches a read starting before lo - max_span ends before lo
    sl.r0 = 0;
    if (sorted && s > 0)
      sl.r0 = std::partition_point(kept.begin(), kept.end(), [&](size_t i) {
                return (int64_t)bf->pos[i] + 1 < sl.lo - max_span;
              }) - kept.begin();
  }

  // the first slab appends to the result's own (cleared) mismatch buffers
  res.mm_gpos.clear();
  res.mm_alt.clear();
  res.mm_dir.clear();
  res.mm_flags.clear();
  slabs[0].mm_gpos.swap(res.mm_gpos);
  slabs[0].mm_alt.swap(res.mm_alt);
  slabs[0].mm_dir.swap(res.mm_dir);
  slabs[0].mm_flags.swap(res.mm_flags);

  const PassInputs in{bf, &res, sorted, min_bq, anchor_size, K, bs,
                      anchored_pos, n_anchored, base_dirs, ref_codes,
                      ref_len, track_open_ended != 0, slot_of.data(), kmin,
                      n_span};
  std::vector<std::thread> threads;
  for (int64_t s = 1; s < n_slabs; s++) {
    try {
      threads.emplace_back(walk_slab, std::cref(in), std::ref(slabs[s]));
    } catch (const std::system_error&) {  // no thread to be had: walk here
      walk_slab(in, slabs[s]);
    }
  }
  walk_slab(in, slabs[0]);
  for (auto& t : threads) t.join();

  res.mm_gpos.swap(slabs[0].mm_gpos);
  res.mm_alt.swap(slabs[0].mm_alt);
  res.mm_dir.swap(slabs[0].mm_dir);
  res.mm_flags.swap(slabs[0].mm_flags);
  for (int64_t s = 1; s < n_slabs; s++) {
    const Slab& sl = slabs[s];
    res.mm_gpos.insert(res.mm_gpos.end(), sl.mm_gpos.begin(), sl.mm_gpos.end());
    res.mm_alt.insert(res.mm_alt.end(), sl.mm_alt.begin(), sl.mm_alt.end());
    res.mm_dir.insert(res.mm_dir.end(), sl.mm_dir.begin(), sl.mm_dir.end());
    res.mm_flags.insert(res.mm_flags.end(), sl.mm_flags.begin(),
                        sl.mm_flags.end());
  }
  res.n_slabs = n_slabs;
  return nb;
}

int64_t pileup_n_slabs(void* h) { return ((BamFile*)h)->pileup->n_slabs; }

// Dedup covered in-reference positions to unique scoring tuples (the
// fast-gVCF hot reduction: every scoring output is a pure function of the
// (support, coverage)-by-direction 6-tuple, so U << L rows get scored).
// Requires a prior bam_pileup_mm with ref_codes (pos_tuples filled).
// Returns the number of selected positions, or -1 when unavailable.
int64_t pileup_gvcf_unique(void* h, int block_size, int64_t ref_len) {
  auto* bf = (BamFile*)h;
  auto* res = bf->pileup.get();
  if (res == nullptr || res->pos_tuples.empty()) return -1;
  int64_t nrows = (int64_t)res->pos_tuples.size() / 8;
  res->sel_positions.clear();
  res->uniq_tuples.clear();
  res->uniq_inv.clear();

  // packed-key dedup (6 fields x 10 bits) with an ordered-map fallback
  // when a field overflows; uniq order is first-occurrence either way —
  // every consumer memoizes per unique row, order-independent
  std::unordered_map<uint64_t, int32_t> seen;
  std::map<std::array<int32_t, 6>, int32_t> seen_big;
  bool big = false;
  const int64_t* keys = res->block_keys.data();
  for (int64_t r = 0; r < nrows; r++) {
    const int32_t* t = &res->pos_tuples[r * 8];
    int64_t total = (int64_t)t[3] + t[4] + t[5] + t[6];
    if (total <= 0) continue;
    int64_t slot = r / block_size;
    int64_t gpos = (keys[slot] - 1) * block_size + (r % block_size) + 1;
    if (gpos > ref_len) continue;
    res->sel_positions.push_back(gpos);
    int32_t idx;
    if (!big) {
      bool overflow = false;
      uint64_t key = 0;
      for (int j = 0; j < 6; j++) {
        if ((uint32_t)t[j] >= 1024u) {
          overflow = true;
          break;
        }
        key = (key << 10) | (uint32_t)t[j];
      }
      if (overflow) {
        // migrate existing entries to the wide map
        big = true;
        for (auto& kv : seen) {
          std::array<int32_t, 6> a;
          uint64_t k = kv.first;
          for (int j = 5; j >= 0; j--) {
            a[j] = (int32_t)(k & 0x3FF);
            k >>= 10;
          }
          seen_big[a] = kv.second;
        }
        seen.clear();
      } else {
        auto it = seen.find(key);
        if (it == seen.end()) {
          idx = (int32_t)(res->uniq_tuples.size() / 6);
          seen.emplace(key, idx);
          res->uniq_tuples.insert(res->uniq_tuples.end(), t, t + 6);
        } else {
          idx = it->second;
        }
        res->uniq_inv.push_back(idx);
        continue;
      }
    }
    std::array<int32_t, 6> a;
    for (int j = 0; j < 6; j++) a[j] = t[j];
    auto it = seen_big.find(a);
    if (it == seen_big.end()) {
      idx = (int32_t)(res->uniq_tuples.size() / 6);
      seen_big.emplace(a, idx);
      res->uniq_tuples.insert(res->uniq_tuples.end(), t, t + 6);
    } else {
      idx = it->second;
    }
    res->uniq_inv.push_back(idx);
  }
  return (int64_t)res->sel_positions.size();
}

const int64_t* pileup_sel_positions(void* h) {
  return ((BamFile*)h)->pileup->sel_positions.data();
}
int64_t pileup_n_uniq(void* h) {
  return (int64_t)((BamFile*)h)->pileup->uniq_tuples.size() / 6;
}
const int32_t* pileup_uniq_tuples(void* h) {
  return ((BamFile*)h)->pileup->uniq_tuples.data();
}
const int32_t* pileup_uniq_inv(void* h) {
  return ((BamFile*)h)->pileup->uniq_inv.data();
}

static inline PileupResult* pu(void* h) { return ((BamFile*)h)->pileup.get(); }

const int64_t* pileup_block_keys(void* h) { return pu(h)->block_keys.data(); }
int64_t pileup_n_mismatches(void* h) { return (int64_t)pu(h)->mm_gpos.size(); }
const int64_t* pileup_mm_gpos(void* h) { return pu(h)->mm_gpos.data(); }
const int8_t* pileup_mm_alt(void* h) { return pu(h)->mm_alt.data(); }
const int8_t* pileup_mm_dir(void* h) { return pu(h)->mm_dir.data(); }
const int8_t* pileup_mm_flags(void* h) { return pu(h)->mm_flags.data(); }
const int32_t* pileup_counts_t(void* h) { return pu(h)->counts_t.data(); }
const double* pileup_qual_t(void* h) { return pu(h)->qual_t.data(); }
const int32_t* pileup_anchored_counts(void* h) {
  return pu(h)->anchored_counts.data();
}
const double* pileup_anchored_quals(void* h) {
  return pu(h)->anchored_quals.data();
}
int64_t pileup_has_pos_tuples(void* h) {
  return (int64_t)pu(h)->pos_tuples.size();
}
const int32_t* pileup_pos_tuples(void* h) { return pu(h)->pos_tuples.data(); }

}  // extern "C"
