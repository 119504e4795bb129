// ThreadSanitizer stress harness for the port's native host library.
//
// The schedulers run concurrent (bam, chr) jobs, each owning a private
// BamFile handle but sharing the process (the reference's
// one-job-owns-one-block discipline, RegionStateManager.cs:336-439). Each
// -MaxThreads job runs the full pass: decode one chromosome, bam_pileup_mm
// with its reference codes (counts, SNV mismatches, per-position tuples; in
// slabs, each on a thread the pass starts),
// then pileup_gvcf_unique (the gVCF tuple dedup). This harness drives that
// shape from many threads at once, per-thread handles, under
// -fsanitize=thread, so shared mutable state in pisces_io.cpp is reported
// as a data race instead of a latent wrong count.
//
// It lives outside io/_native/ so the library's build (every .cpp directly
// in io/_native/) never links its main(). io/native.build_tsan_check()
// compiles it with the library's sources:
//
//   tsan_check <bam> [n_threads] [iters] [ref_codes]
//
// ref_codes: int8 allele codes (domain/types.BASE_TO_ALLELE) of every
// reference in the BAM header's order, back to back. Without it only the
// whole-file decode and the count pileup run. Exit 0 = clean and every
// thread's checksums equal; TSan exits non-zero on any race.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
void* bam_open(const char* path, int n_threads);
void bam_close(void* h);
int bam_n_refs(void* h);
int bam_ref_len(void* h, int i);
int64_t bam_decode(void* h, int want_ref_id);
const int32_t* bam_col_pos(void* h);
const int32_t* bam_col_end_pos(void* h);
const uint8_t* bam_col_mapq(void* h);
const uint16_t* bam_col_flag(void* h);
int64_t bam_pileup_mm(void* h, const uint8_t* keep, int min_bq,
                      int anchor_size, int block_size,
                      const int64_t* anchored_pos, int64_t n_anchored,
                      const int8_t* base_dirs, const int8_t* ref_codes,
                      int64_t ref_len, int track_open_ended, int max_slabs,
                      int min_slab_blocks);
int64_t pileup_gvcf_unique(void* h, int block_size, int64_t ref_len);
int64_t pileup_n_uniq(void* h);
const int64_t* pileup_sel_positions(void* h);
const int32_t* pileup_uniq_tuples(void* h);
const int32_t* pileup_uniq_inv(void* h);
int64_t pileup_has_pos_tuples(void* h);
const int32_t* pileup_counts_t(void* h);
const double* pileup_qual_t(void* h);
const int64_t* pileup_block_keys(void* h);
int64_t pileup_n_mismatches(void* h);
const int64_t* pileup_mm_gpos(void* h);
const int8_t* pileup_mm_alt(void* h);
const int8_t* pileup_mm_dir(void* h);
const int8_t* pileup_mm_flags(void* h);
}

namespace {

constexpr int kBlock = 1000;
constexpr int kSlabs = 3;  // every pass in three slabs, on threads of its own
constexpr int kChannels = 6 * 3;  // allele types x directions

struct Sums {
  long long ints = 0;     // counts, keys, columns, mismatches, tuples
  double quals = 0.0;     // the f64 quality-error scatter
  long long mismatches = 0;
  long long unique = 0;   // unique gVCF tuples
};

bool same(const Sums& a, const Sums& b) {
  return a.ints == b.ints && a.quals == b.quals &&
         a.mismatches == b.mismatches && a.unique == b.unique;
}

// the handle's count tensors after a pileup of nb blocks
void add_counts(void* h, int64_t nb, Sums* s) {
  const int32_t* counts = pileup_counts_t(h);
  const double* quals = pileup_qual_t(h);
  const int64_t* keys = pileup_block_keys(h);
  for (int64_t i = 0; i < nb * kBlock * kChannels; i++) {
    s->ints += counts[i];
    s->quals += quals[i];
  }
  for (int64_t i = 0; i < nb; i++) s->ints += keys[i];
}

// the whole file decoded at once, counts only (the reference's harness)
void whole_file(void* h, Sums* s) {
  int64_t n = bam_decode(h, -1);
  std::vector<uint8_t> keep(n, 1);
  int64_t nb = bam_pileup_mm(h, keep.data(), 20, 5, kBlock, nullptr, 0,
                             nullptr, nullptr, 0, 0, kSlabs, 1);
  add_counts(h, nb, s);
}

// one chromosome as a -MaxThreads job runs it: decode, the full pass with
// the reference codes, then the gVCF tuple dedup
void one_chromosome(void* h, int r, const int8_t* codes, int64_t len,
                    Sums* s) {
  int64_t n = bam_decode(h, r);
  const int32_t* pos = bam_col_pos(h);
  const int32_t* end = bam_col_end_pos(h);
  const uint8_t* mapq = bam_col_mapq(h);
  const uint16_t* flag = bam_col_flag(h);
  std::vector<uint8_t> keep(n);
  for (int64_t i = 0; i < n; i++) {
    s->ints += pos[i] + end[i] + mapq[i] + flag[i];
    keep[i] = (flag[i] & 0x704) == 0 && mapq[i] > 0;  // the read filter
  }
  int64_t nb = bam_pileup_mm(h, keep.data(), 20, 5, kBlock, nullptr, 0,
                             nullptr, codes, len, 1, kSlabs, 1);
  add_counts(h, nb, s);
  int64_t n_mm = pileup_n_mismatches(h);
  const int64_t* gpos = pileup_mm_gpos(h);
  const int8_t* alt = pileup_mm_alt(h);
  const int8_t* dir = pileup_mm_dir(h);
  const int8_t* flags = pileup_mm_flags(h);
  for (int64_t i = 0; i < n_mm; i++)
    s->ints += gpos[i] + alt[i] + 7 * dir[i] + 13 * flags[i];
  s->mismatches += n_mm;
  if (pileup_has_pos_tuples(h) == 0) return;
  int64_t n_sel = pileup_gvcf_unique(h, kBlock, len);
  int64_t n_uniq = pileup_n_uniq(h);
  const int64_t* sel = pileup_sel_positions(h);
  const int32_t* uniq = pileup_uniq_tuples(h);
  const int32_t* inv = pileup_uniq_inv(h);
  for (int64_t i = 0; i < n_sel; i++) s->ints += sel[i] + inv[i];
  for (int64_t i = 0; i < n_uniq * 6; i++) s->ints += uniq[i];
  s->unique += n_uniq;
}

std::vector<int8_t> read_codes(const char* path) {
  std::vector<int8_t> codes;
  FILE* f = fopen(path, "rb");
  if (!f) {
    fprintf(stderr, "cannot open %s\n", path);
    exit(2);
  }
  int8_t buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof(buf), f)) > 0)
    codes.insert(codes.end(), buf, buf + got);
  fclose(f);
  return codes;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <bam> [n_threads] [iters] [ref_codes]\n",
            argv[0]);
    return 2;
  }
  const char* path = argv[1];
  int n_threads = argc > 2 ? atoi(argv[2]) : 8;
  int iters = argc > 3 ? atoi(argv[3]) : 4;
  std::vector<int8_t> codes;
  if (argc > 4) codes = read_codes(argv[4]);

  // each reference's offset into the codes, from the header
  std::vector<int64_t> offsets, lens;
  {
    void* h = bam_open(path, 1);
    if (!h) {
      fprintf(stderr, "open failed: %s\n", path);
      return 3;
    }
    int64_t off = 0;
    for (int r = 0; r < bam_n_refs(h); r++) {
      offsets.push_back(off);
      lens.push_back(bam_ref_len(h, r));
      off += bam_ref_len(h, r);
    }
    bam_close(h);
    if (!codes.empty() && (int64_t)codes.size() != off) {
      fprintf(stderr, "ref_codes holds %zu codes; the header's references "
              "hold %lld bases\n", codes.size(), (long long)off);
      return 2;
    }
  }

  std::vector<std::thread> threads;
  std::vector<Sums> sums(n_threads);
  for (int t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int it = 0; it < iters; it++) {
        void* h = bam_open(path, 2);
        if (!h) {
          fprintf(stderr, "thread %d: open failed\n", t);
          exit(3);
        }
        whole_file(h, &sums[t]);
        if (!codes.empty()) {
          for (size_t r = 0; r < lens.size(); r++)
            one_chromosome(h, (int)r, codes.data() + offsets[r], lens[r],
                           &sums[t]);
        }
        bam_close(h);
      }
    });
  }
  for (auto& th : threads) th.join();
  for (int t = 1; t < n_threads; t++) {
    if (!same(sums[t], sums[0])) {
      fprintf(stderr, "MISMATCH: thread %d checksum %lld (%.17g) != %lld "
              "(%.17g)\n", t, sums[t].ints, sums[t].quals, sums[0].ints,
              sums[0].quals);
      return 4;
    }
  }
  printf("tsan_check ok: %d threads x %d iters, checksum %lld, "
         "mismatches %lld, unique tuples %lld\n", n_threads, iters,
         sums[0].ints, sums[0].mismatches, sums[0].unique);
  return 0;
}
