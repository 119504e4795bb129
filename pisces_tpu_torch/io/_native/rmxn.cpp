// RMxN repeat scan (RMxNCalculator.cs:1-136; Python version in
// calling/repeats.py). The per-allele char-slice scans dominate the
// filter's cost in Python; this is the same algorithm over the raw uint8
// reference.
//
// Build: pisces_tpu_torch/io/native.py get_lib() (g++ at first use, with
// pisces_io.cpp, into one library under pisces_tpu_torch/build/).
// Binding: ctypes (pisces_tpu_torch/calling/repeats.py RefSeqStr).
#include <cstdint>
#include <cstring>

namespace {

int rmxn_for_indel(const uint8_t* ref, int64_t ref_len, int64_t variant_pos,
                   const char* vb, int length, int max_unit_len) {
  int max_found = 0;
  int lo = length - (max_unit_len < length ? max_unit_len : length);
  for (int i = lo; i < length; i++) {
    // bookends: prefix vb[:length-i] and suffix vb[i:]
    for (int which = 0; which < 2; which++) {
      const char* unit = which == 0 ? vb : vb + i;
      int n = length - i;
      if (n <= 0) continue;
      int64_t back = variant_pos;
      while (true) {
        int64_t nb = back - n;
        if (nb < 0) break;
        if (memcmp(ref + nb, unit, (size_t)n) != 0) break;
        back = nb;
      }
      int count = 0;
      int64_t cur = back;
      while (cur + n <= ref_len
             && memcmp(ref + cur, unit, (size_t)n) == 0) {
        count++;
        cur += n;
      }
      if (count > max_found) max_found = count;
    }
  }
  return max_found;
}

}  // namespace

extern "C" {

// category: 0 = SNV/MNV, 1 = insertion, 2 = deletion.
// Returns min(component1, component2) (RMxNCalculator.ComputeComponent...).
int rmxn_min_component(const uint8_t* ref, int64_t ref_len, int64_t position,
                       const char* ref_allele, int rlen,
                       const char* alt_allele, int alen, int category,
                       int max_unit_len) {
  const char* vb;
  int vlen;
  if (category == 1) {
    vb = alt_allele + 1;
    vlen = alen - 1;
  } else if (category == 2) {
    vb = ref_allele + 1;
    vlen = rlen - 1;
  } else {
    vb = alt_allele;
    vlen = alen;
  }
  int c1, c2;
  if (category == 1 || category == 2) {
    c1 = rmxn_for_indel(ref, ref_len, position, vb, vlen, max_unit_len);
    c2 = 0x7fffffff;
  } else {
    c1 = rmxn_for_indel(ref, ref_len, position - 1, ref_allele, rlen,
                        max_unit_len);
    int a = rmxn_for_indel(ref, ref_len, position + rlen - 1, vb, vlen,
                           max_unit_len);
    int b = rmxn_for_indel(ref, ref_len, position - 1, vb, vlen,
                           max_unit_len);
    c2 = a > b ? a : b;
  }
  return c1 < c2 ? c1 : c2;
}

}  // extern "C"
