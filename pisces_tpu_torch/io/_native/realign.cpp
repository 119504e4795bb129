// Native realigner core: the per-read position-map layering/judging loop
// of preprocessing/realigner.py (GeminiReadRealigner._realign_for_anchor,
// _add_indel, _reapply_softclips, softclip_cigar, get_mismatch_map,
// construct_cigar — themselves ports of the reference's
// GeminiReadRealigner.cs:179-505, SoftclipReapplier.cs:33-129,
// Helper.cs:372-672). Semantics are intentionally IDENTICAL to the Python
// implementation, including order-dependent quirks (e.g. each
// _add_indel's alignment summary is computed over ITS OWN N-merged
// sequence built from the ORIGINAL details.seq — earlier indels'
// N-merges do not propagate). tests/test_torch_preprocessing.py checks it
// against the Python path and the reference package on seeded reads.
//
// Build: pisces_tpu_torch/io/native.py get_lib() (one library with the
// other io/_native sources). Binding: ctypes
// (pisces_tpu_torch/preprocessing/realigner.py).
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

extern "C" int aln_summary(const uint8_t* ref, int64_t ref_len,
                           int64_t start_ref0, const uint8_t* ops,
                           const int32_t* lens, int nc, const char* read_seq,
                           int check_softclips, int32_t* out);

namespace {

constexpr uint8_t OP_M = 0, OP_I = 1, OP_D = 2, OP_N = 3, OP_S = 4;
constexpr int8_t MT_NONE = 0, MT_MISMATCH = 1, MT_NMISMATCH = 2,
                 MT_UNMAPPED = 3;

struct CigOp {
  uint8_t op;
  int64_t len;
};
using Cigar = std::vector<CigOp>;

struct RIndel {
  int64_t position;
  int64_t length;
  bool is_insertion, is_repeat, is_duplication;
  int64_t n_dups_left, n_dups_right, n_ref_suffix_unique;
  std::string ref_allele, alt_allele, repeat_unit, ref_suffix;
};

struct RConfig {
  bool remask, mask_partial_ins, keep_probe, keep_both, mask_ns_only;
  int64_t min_ins_mismatch;
  double max_prop_ins_mismatch;
  int64_t min_unanchored_ins;
};

struct RResult {
  int64_t num_matches = 0, num_mismatches = 0, num_mm_incl_sc = 0,
          num_indels = 0, num_inserted = 0, num_deleted = 0,
          num_indel_bases = 0, num_softclips = 0, num_non_n_softclips = 0,
          anchor_length = 0;
  int64_t sum_mm_quals = -1;  // -1 == Python None
  int64_t position = 0;       // 1-based
  Cigar cigar;
  std::vector<int64_t> nified, added_at;
  bool is_sketchy = false;
};

int64_t prefix_clip_of(const Cigar& c) {
  int64_t n = 0;
  for (const auto& o : c) {
    if (o.op == OP_S) n += o.len;
    else if (o.op != 5) break;
  }
  return n;
}

int64_t suffix_clip_of(const Cigar& c) {
  int64_t n = 0;
  for (auto it = c.rbegin(); it != c.rend(); ++it) {
    if (it->op == OP_S) n += it->len;
    else if (it->op != 5) break;
  }
  return n;
}

int64_t n_prefix_of(const char* s, int64_t n) {
  int64_t k = 0;
  while (k < n && s[k] == 'N') k++;
  return k;
}

int64_t n_suffix_of(const char* s, int64_t n) {
  int64_t k = 0;
  while (k < n && s[n - 1 - k] == 'N') k++;
  return k;
}

// Helper.ConstructCigar (realigner.py:260-288); soft_clip=false variant
Cigar construct_cigar(const std::vector<int64_t>& pmap) {
  Cigar out;
  int64_t last_ref = -1;
  int last_op = -1;  // -1 == Python None
  int64_t last_len = 0;
  for (int64_t p : pmap) {
    uint8_t op = p < 0 ? OP_I : OP_M;
    if (op == OP_M) {
      if (last_ref != -1 && p > last_ref + 1) {
        out.push_back({(uint8_t)last_op, last_len});
        out.push_back({OP_D, p - last_ref - 1});
        last_op = OP_D;
        last_len = 0;
      }
      last_ref = p;
    }
    if ((int)op != last_op) {
      if (last_op != -1 && last_op != OP_D)
        out.push_back({(uint8_t)last_op, last_len});
      last_op = op;
      last_len = 1;
    } else {
      last_len++;
    }
  }
  out.push_back({(uint8_t)last_op, last_len});
  return out;
}

// Helper.GetMismatchMap (realigner.py:291-311); returns false for None
bool mismatch_map(const std::string& read, const std::vector<int64_t>& pmap,
                  const uint8_t* ref, int64_t ref_len,
                  std::vector<int8_t>* out) {
  out->assign(read.size(), MT_NONE);
  for (size_t i = 0; i < pmap.size(); i++) {
    int64_t p = pmap[i];
    if (p < 0) {
      (*out)[i] = read[i] == 'N' ? MT_NMISMATCH : MT_UNMAPPED;
      continue;
    }
    if (p > ref_len) return false;
    if (p - 1 >= 0) {
      char rb = (char)ref[p - 1];
      char b = read[i];
      if (rb != 'N' && b != 'N' && rb != b) (*out)[i] = MT_MISMATCH;
      else if (rb == 'N' || b == 'N') (*out)[i] = MT_NMISMATCH;
    } else {
      (*out)[i] = MT_UNMAPPED;
    }
  }
  return true;
}

int64_t sum_mm_quals_of(const std::vector<int8_t>& mm, const uint8_t* quals) {
  int64_t s = 0;
  for (size_t i = 0; i < mm.size(); i++)
    if (mm[i] == MT_MISMATCH) s += quals[i];
  return s;
}

Cigar compress_expanded(const std::vector<uint8_t>& expanded) {
  Cigar out;
  for (uint8_t o : expanded) {
    if (!out.empty() && out.back().op == o) out.back().len++;
    else out.push_back({o, 1});
  }
  return out;
}

// Helper.SoftclipCigar (realigner.py:319-427)
Cigar softclip_cigar(const Cigar& raw, const std::vector<int8_t>& mm,
                     int64_t orig_prefix_clip, int64_t orig_suffix_clip,
                     bool mask_ns_only, int64_t prefix_ns, int64_t suffix_ns,
                     bool softclip_even_if_match,
                     bool softclip_represents_mess) {
  const bool rescue_edge_matches = true;
  const double allow_one_per = 12.0;
  if (orig_prefix_clip == 0 && orig_suffix_clip == 0) return raw;
  std::vector<uint8_t> expanded;
  for (const auto& o : raw)
    for (int64_t k = 0; k < o.len; k++) expanded.push_back(o.op);
  bool changed = false;

  int64_t first_non_ms = (int64_t)expanded.size() - 1;
  for (size_t i = 0; i < expanded.size(); i++)
    if (expanded[i] != OP_M && expanded[i] != OP_S) {
      first_non_ms = (int64_t)i;
      break;
    }
  int64_t last_non_ms = 0;
  for (int64_t i = (int64_t)expanded.size() - 1; i >= 0; i--)
    if (expanded[i] != OP_M && expanded[i] != OP_S) {
      last_non_ms = i;
      break;
    }
  int64_t max_prefix = std::min(first_non_ms + 1, orig_prefix_clip);
  int64_t max_suffix =
      std::min((int64_t)expanded.size() - last_non_ms, orig_suffix_clip);

  double min_mism_prefix = orig_prefix_clip / allow_one_per;
  double min_mism_suffix = orig_suffix_clip / allow_one_per;

  int64_t mmi = orig_prefix_clip;
  int64_t n_mism = 0;
  {
    int64_t tmp = mmi;
    for (int64_t k = 0; k < max_prefix; k++) {
      tmp -= 1;
      if (mm[tmp] == MT_MISMATCH || mm[tmp] == MT_NMISMATCH) n_mism++;
    }
  }
  bool prefix_too_messy = (double)n_mism > min_mism_prefix;

  bool started = false;
  uint8_t prev_op = OP_N, prev_prev_op = OP_N;
  for (int64_t i = 0; i < max_prefix; i++) {
    int64_t index = max_prefix - 1 - i;
    mmi -= 1;
    uint8_t op_at = expanded[index];
    if (op_at != OP_M) {
      prev_op = op_at;
      continue;
    }
    bool should;
    if (mask_ns_only) {
      should = index < prefix_ns;
    } else {
      should = softclip_even_if_match || !rescue_edge_matches || started ||
               prefix_too_messy;
      if (!should && (mm[mmi] == MT_MISMATCH || mm[mmi] == MT_NMISMATCH))
        should = true;
      if (prev_op == OP_D || prev_op == OP_I ||
          (softclip_represents_mess &&
           (prev_prev_op == OP_D || prev_prev_op == OP_I)))
        should = false;
    }
    if (should) {
      changed = true;
      started = true;
      expanded[index] = OP_S;
    }
    prev_prev_op = prev_op;
    prev_op = op_at;
  }

  started = false;
  int64_t read_span = 0;
  for (uint8_t o : expanded)
    if (o == OP_M || o == OP_I || o == OP_S) read_span++;
  mmi = (int64_t)mm.size() - max_suffix - 1;
  n_mism = 0;
  {
    int64_t tmp = mmi;
    for (int64_t k = 0; k < max_suffix; k++) {
      tmp += 1;
      if (mm[tmp] == MT_MISMATCH || mm[tmp] == MT_NMISMATCH) n_mism++;
    }
  }
  bool suffix_too_messy = (double)n_mism > min_mism_suffix;
  prev_op = OP_N;
  for (int64_t i = 0; i < max_suffix; i++) {
    int64_t index = (int64_t)expanded.size() - (max_suffix - i);
    mmi += 1;
    uint8_t op_at = expanded[index];
    if (op_at != OP_M) {
      prev_op = op_at;
      continue;
    }
    bool should;
    if (mask_ns_only) {
      should = suffix_ns > 0 && mmi >= read_span - suffix_ns;
    } else {
      should = !rescue_edge_matches || started || suffix_too_messy;
      if (!should && (mm[mmi] == MT_MISMATCH || mm[mmi] == MT_NMISMATCH))
        should = true;
      if (prev_op == OP_D || prev_op == OP_I) should = false;
    }
    if (should) {
      changed = true;
      started = true;
      expanded[index] = OP_S;
    }
    prev_op = op_at;
  }

  bool any_m = false;
  for (uint8_t o : expanded)
    if (o == OP_M) { any_m = true; break; }
  if (!any_m) {
    int64_t first_non_s = (int64_t)expanded.size();
    for (size_t i = 0; i < expanded.size(); i++)
      if (expanded[i] != OP_S) {
        first_non_s = (int64_t)i;
        break;
      }
    // Python writes expanded[first_non_s - 1]; when first_non_s == 0
    // (no leading S at all) negative indexing sets the LAST element
    int64_t fix = first_non_s - 1;
    if (fix < 0) fix += (int64_t)expanded.size();
    expanded[fix] = OP_M;
  }
  if (!changed) return raw;
  return compress_expanded(expanded);
}

// Helper.DeletionHasSketchyAnchor (realigner.py:1159-1190)
bool deletion_has_sketchy_anchor(const std::string& seq, const RIndel& ind,
                                 int64_t del_pos) {
  const std::string& unit = ind.repeat_unit;
  if (unit.empty()) return false;
  int64_t ulen = (int64_t)unit.size();
  int64_t n = (int64_t)seq.size();
  bool any_non_repeat_right = false, assessed_right = false;
  int64_t i = del_pos + 1;
  while (i < n) {
    assessed_right = true;
    int64_t take = std::min(ulen, n - i);
    if (seq.compare(i, take, unit, 0, take) != 0) any_non_repeat_right = true;
    i += ulen;
  }
  bool any_non_repeat_left = false, assessed_left = false;
  i = del_pos + 1;
  while (i >= 0) {
    if (i - 1 < 0) break;
    if (i + ulen >= n) {
      i -= ulen;
      continue;
    }
    assessed_left = true;
    int64_t take = std::min(ulen, i);
    // cmp = unit[len(unit)-take:] vs seq[i-1 : i-1+take]
    if (seq.compare(i - 1, take, unit, ulen - take, take) != 0)
      any_non_repeat_left = true;
    i -= ulen;
  }
  return (assessed_left && !any_non_repeat_left) ||
         (assessed_right && !any_non_repeat_right);
}

bool get_summary(const uint8_t* ref, int64_t ref_len, int64_t start_ref0,
                 const Cigar& cig, const std::string& read, bool check_sc,
                 int32_t out[10]) {
  std::vector<uint8_t> ops(cig.size());
  std::vector<int32_t> lens(cig.size());
  for (size_t k = 0; k < cig.size(); k++) {
    ops[k] = cig[k].op;
    lens[k] = (int32_t)cig[k].len;
  }
  return aln_summary(ref, ref_len, start_ref0, ops.data(), lens.data(),
                     (int)cig.size(), read.c_str(), check_sc ? 1 : 0,
                     out) == 0;
}

// GeminiReadRealigner._add_indel (realigner.py:725-885). Mutates pmap.
// Returns false for Python None.
bool add_indel(const std::string& seq, const RIndel& indel, bool anchor_left,
               std::vector<int64_t>& pmap, const uint8_t* ref,
               int64_t ref_len, bool pair_specific, const RConfig& cfg,
               RResult* r) {
  bool found = false;
  int64_t ins_start = -1, ins_end = -1, del_pos = -1;
  bool any_after_del = false;
  int64_t n = (int64_t)pmap.size();

  if (anchor_left) {
    for (int64_t i = 0; i < n; i++) {
      if (pmap[i] == indel.position && i != n - 1) {
        found = true;
        if (indel.is_insertion) {
          ins_start = i + 1;
          for (int64_t j = i + 1; j < n; j++) {
            if (j - i <= indel.length) {
              pmap[j] = -1;
              if (j - i == indel.length || j == n - 1) ins_end = j;
            } else {
              if (pmap[j] != -1) pmap[j] = pmap[j] - indel.length;
            }
          }
          break;
        } else {
          del_pos = i;
          for (int64_t j = i + 1; j < n; j++) {
            if (pmap[j] != -1) {
              any_after_del = true;
              pmap[j] = pmap[j] + indel.length;
            }
          }
          break;
        }
      }
    }
  } else {
    if (indel.is_insertion) {
      for (int64_t i = n - 1; i >= 0; i--) {
        if (pmap[i] == indel.position + 1 && i != 0) {
          found = true;
          ins_end = i - 1;
        } else if (pmap[i] == indel.position && i != n - 1) {
          found = true;
          ins_end = i;
        }
        if (found) {
          for (int64_t j = ins_end; j >= 0; j--) {
            if (ins_end - j + 1 <= indel.length) {
              pmap[j] = -1;
              if (ins_end - j + 1 == indel.length || j == 0) ins_start = j;
            } else {
              if (pmap[j] != -1) pmap[j] = pmap[j] + indel.length;
            }
          }
          break;
        }
      }
    } else {
      for (int64_t i = n - 1; i > 0; i--) {
        if (pmap[i] == indel.position + indel.length + 1) {
          found = true;
          del_pos = i - 1;
          for (int64_t j = i - 1; j >= 0; j--) {
            if (pmap[j] != -1) {
              any_after_del = true;
              pmap[j] = pmap[j] - indel.length;
            }
          }
          break;
        }
      }
    }
  }

  bool any_nonneg = false;
  for (int64_t p : pmap)
    if (p >= 0) { any_nonneg = true; break; }
  if (!found || (!indel.is_insertion && !any_after_del) || !any_nonneg)
    return false;

  bool is_sketchy = false;
  if (indel.is_repeat && !indel.repeat_unit.empty()) {
    int64_t slen = (int64_t)seq.size();
    int64_t anchor_length =
        indel.is_insertion ? std::min(ins_start, slen - ins_end)
                           : std::min(del_pos, slen - del_pos);
    if (anchor_length < std::max((int64_t)10, indel.length)) {
      if (!indel.is_insertion) {
        if (deletion_has_sketchy_anchor(seq, indel, del_pos)) {
          if (pair_specific) is_sketchy = true;
          else return false;
        }
      } else {
        if (indel.n_ref_suffix_unique >= anchor_length) {
          if (pair_specific) is_sketchy = true;
          else return false;
        }
      }
    }
  }

  if (!indel.is_insertion) {
    int64_t anchor_start = del_pos + 1;
    int64_t right_anchor_len = (int64_t)seq.size() - anchor_start;
    if (right_anchor_len < indel.length &&
        anchor_start < (int64_t)seq.size()) {
      // seq[anchor_start:] == ref_allele[1:1+right_anchor_len]
      if ((int64_t)indel.ref_allele.size() >= 1 &&
          seq.compare(anchor_start, std::string::npos, indel.ref_allele, 1,
                      (size_t)right_anchor_len) == 0)
        return false;
    }
  }

  if (indel.is_duplication && indel.is_insertion) {
    if ((int64_t)seq.size() - ins_end <= 3) return false;
  }

  std::string new_seq = seq;
  std::vector<int64_t> nified;
  if (indel.is_insertion) {
    if (ins_start == -1 || ins_end == -1) return false;
    std::string read_ins = seq.substr(ins_start, ins_end - ins_start + 1);
    std::string indel_seq = indel.alt_allele.substr(1);
    if (anchor_left && read_ins.size() < indel_seq.size() &&
        indel.n_dups_right > 0)
      return false;
    if (!anchor_left && read_ins.size() < indel_seq.size() &&
        indel.n_dups_left > 0)
      return false;
    std::string clipped =
        anchor_left ? indel_seq.substr(0, read_ins.size())
                    : indel_seq.substr(indel_seq.size() - read_ins.size());
    if (read_ins != clipped) {
      int64_t mismatches = -1;  // -1 == None
      double to_dq = 0.0;
      if (indel.length >= cfg.min_ins_mismatch &&
          !(indel.n_dups_left + indel.n_dups_right > 0)) {
        // hamming (lengths equal by construction of clipped)
        mismatches = 0;
        for (size_t k = 0; k < read_ins.size(); k++)
          if (read_ins[k] != clipped[k]) mismatches++;
        to_dq = (double)indel.length * cfg.max_prop_ins_mismatch;
        if (mismatches != -1 && (double)mismatches <= to_dq) {
          std::string merged;
          merged.reserve(clipped.size());
          for (size_t k = 0; k < clipped.size() && k < read_ins.size();
               k++) {
            char a = clipped[k], b = read_ins[k];
            if (a == b || a == 'N') {
              merged.push_back(b);
            } else {
              merged.push_back('N');
              nified.push_back((int64_t)k);
            }
          }
          new_seq = seq.substr(0, ins_start) + merged +
                    seq.substr(ins_end + 1);
          for (auto& x : nified) x += ins_start;
        }
      }
      if (mismatches == -1 || (double)mismatches > to_dq) return false;
    }
  }

  Cigar new_cigar = construct_cigar(pmap);
  int64_t start_ref = -1;
  for (int64_t p : pmap)
    if (p > 0) { start_ref = p - 1; break; }
  if (start_ref < 0) return false;
  int32_t s[10];
  if (!get_summary(ref, ref_len, start_ref, new_cigar, new_seq, false, s))
    return false;
  r->position = start_ref + 1;
  r->cigar = new_cigar;
  r->num_indels = 0;
  for (const auto& o : new_cigar)
    if (o.op == OP_I || o.op == OP_D) r->num_indels++;
  r->num_mismatches = s[1];
  r->num_softclips = s[7];
  r->num_non_n_softclips = s[8];
  r->num_deleted = s[5];
  r->num_inserted = s[4];
  r->num_matches = s[0];
  r->num_indel_bases = s[6];
  r->num_mm_incl_sc = s[2];
  r->anchor_length = 0;  // Python: dataclass default, not set here
  r->sum_mm_quals = -1;
  r->nified = nified;
  r->added_at = {indel.is_insertion ? ins_start : del_pos};
  r->is_sketchy = is_sketchy;
  return true;
}

// SoftclipReapplier.ReapplySoftclips (realigner.py:983-1042)
void reapply_softclips(const std::string& full_seq, const uint8_t* quals,
                       int64_t n_prefix, int64_t n_suffix,
                       int64_t prefix_softclip, int64_t suffix_softclip,
                       const std::vector<int64_t>& pmap, const uint8_t* ref,
                       int64_t ref_len, const RConfig& cfg, RResult* r) {
  std::vector<int64_t> final_map;
  final_map.reserve(n_prefix + pmap.size() + n_suffix);
  for (int64_t k = 0; k < n_prefix; k++) final_map.push_back(-1);
  final_map.insert(final_map.end(), pmap.begin(), pmap.end());
  for (int64_t k = 0; k < n_suffix; k++) final_map.push_back(-1);

  Cigar final_cigar;
  if (n_prefix) final_cigar.push_back({OP_S, n_prefix});
  final_cigar.insert(final_cigar.end(), r->cigar.begin(), r->cigar.end());
  if (n_suffix) final_cigar.push_back({OP_S, n_suffix});
  Cigar compressed;
  for (const auto& o : final_cigar) {
    if (!compressed.empty() && compressed.back().op == o.op)
      compressed.back().len += o.len;
    else
      compressed.push_back(o);
  }
  r->cigar = compressed;

  if (!cfg.remask) return;
  std::vector<int8_t> mm;
  if (!mismatch_map(full_seq, final_map, ref, ref_len, &mm)) return;
  bool probeish = cfg.keep_probe || cfg.keep_both;
  Cigar adjusted = softclip_cigar(
      r->cigar, mm, prefix_softclip, suffix_softclip, cfg.mask_ns_only,
      n_prefix_of(full_seq.c_str(), (int64_t)full_seq.size()),
      n_suffix_of(full_seq.c_str(), (int64_t)full_seq.size()), probeish,
      !probeish);
  int64_t pre = prefix_clip_of(adjusted);
  for (int64_t i = 0; i < pre; i++) final_map[i] = -2;
  int64_t suf = suffix_clip_of(adjusted);
  for (int64_t i = 0; i < suf; i++)
    final_map[(int64_t)final_map.size() - 1 - i] = -2;

  std::vector<int8_t> mm2;
  if (!mismatch_map(full_seq, final_map, ref, ref_len, &mm2)) return;
  int64_t first_pos = 0;
  bool any = false;
  for (int64_t p : final_map)
    if (p > 0) {
      first_pos = p;
      any = true;
      break;
    }
  if (!any) return;
  r->position = first_pos;
  r->cigar = adjusted;
  r->num_mismatches = 0;
  for (int8_t x : mm2)
    if (x == MT_MISMATCH) r->num_mismatches++;
  for (auto& x : r->added_at) x += n_prefix;
  for (auto& x : r->nified) x += n_prefix;
  int32_t s[10];
  if (get_summary(ref, ref_len, r->position - 1, adjusted, full_seq, false,
                  s)) {
    r->num_non_n_softclips = s[8];
    r->num_softclips = s[7];
    r->num_inserted = s[4];
    r->num_mm_incl_sc = s[2];
    r->anchor_length = s[9];
    r->num_matches = s[0];
  }
  r->sum_mm_quals = sum_mm_quals_of(mm, quals);
}

}  // namespace

extern "C" {

// GeminiReadRealigner._realign_for_anchor (realigner.py:889-943) for ONE
// anchor over the supplied target indels (1 or 2 in practice — single
// candidates and observed-together coexisting pairs).
//
// Returns 1 with outputs filled, 0 for Python None, -1 on output
// overflow (caller falls back to the Python path).
// out_counters[13] = {num_indels, num_mismatches, num_softclips,
//   num_non_n_softclips, num_deleted, num_inserted, num_matches,
//   num_indel_bases, num_mm_incl_sc, anchor_length,
//   sum_mm_quals (-1 == None), is_sketchy, position}.
int realign_anchor(
    const uint8_t* ref, int64_t ref_len,
    // details (GeminiReadRealigner._details, computed by the caller)
    int64_t det_position, int64_t n_prefix, int64_t n_suffix,
    int64_t prefix_softclip, int64_t suffix_softclip,
    // full read
    const char* seq, const uint8_t* quals, int64_t seq_len,
    // target indels, columnar, in list order (apply order is handled
    // here: forward for the left anchor, reversed for the right)
    int64_t n_indels, const int64_t* ind_position, const int64_t* ind_length,
    const uint8_t* ind_flags,  // bit0 insertion, bit1 repeat, bit2 dup
    const int64_t* ind_dups_left, const int64_t* ind_dups_right,
    const int64_t* ind_suffix_unique,
    const char* str_pool, const int64_t* ref_allele_off,
    const int64_t* alt_allele_off, const int64_t* repeat_unit_off,
    const int64_t* ref_suffix_off,  // each n_indels+1 offsets into pool
    int anchor_left, int pair_specific,
    // config
    int remask, int mask_partial_ins, int keep_probe, int keep_both,
    int mask_ns_only, int64_t min_ins_mismatch,
    double max_prop_ins_mismatch, int64_t min_unanchored_ins,
    // outputs
    uint8_t* out_ops, int32_t* out_lens, int32_t* out_nc,
    int64_t* out_counters, int32_t* out_added, int32_t* out_n_added,
    int32_t* out_nified, int32_t* out_n_nified, int32_t cap) {
  RConfig cfg{remask != 0,       mask_partial_ins != 0, keep_probe != 0,
              keep_both != 0,    mask_ns_only != 0,     min_ins_mismatch,
              max_prop_ins_mismatch, min_unanchored_ins};
  std::vector<RIndel> indels((size_t)n_indels);
  for (int64_t k = 0; k < n_indels; k++) {
    RIndel& d = indels[k];
    d.position = ind_position[k];
    d.length = ind_length[k];
    d.is_insertion = ind_flags[k] & 1;
    d.is_repeat = ind_flags[k] & 2;
    d.is_duplication = ind_flags[k] & 4;
    d.n_dups_left = ind_dups_left[k];
    d.n_dups_right = ind_dups_right[k];
    d.n_ref_suffix_unique = ind_suffix_unique[k];
    d.ref_allele.assign(str_pool + ref_allele_off[k],
                        str_pool + ref_allele_off[k + 1]);
    d.alt_allele.assign(str_pool + alt_allele_off[k],
                        str_pool + alt_allele_off[k + 1]);
    d.repeat_unit.assign(str_pool + repeat_unit_off[k],
                         str_pool + repeat_unit_off[k + 1]);
    d.ref_suffix.assign(str_pool + ref_suffix_off[k],
                        str_pool + ref_suffix_off[k + 1]);
  }
  std::string full_seq(seq, (size_t)seq_len);
  int64_t mid_len = seq_len - n_prefix - n_suffix;
  if (mid_len <= 0) return 0;
  std::string det_seq = full_seq.substr(n_prefix, mid_len);
  std::vector<int64_t> pmap((size_t)mid_len);
  for (int64_t k = 0; k < mid_len; k++) pmap[k] = det_position + k;

  RResult result;
  bool have = false;
  std::vector<int64_t> added_at, nified;
  std::vector<int64_t> accepted_sub;
  for (int64_t oi = 0; oi < n_indels; oi++) {
    int64_t i = anchor_left ? oi : n_indels - 1 - oi;
    RResult r;
    if (!add_indel(det_seq, indels[i], anchor_left != 0, pmap, ref, ref_len,
                   pair_specific != 0, cfg, &r))
      return 0;
    have = true;
    accepted_sub.push_back(i);
    for (int64_t a : r.added_at) added_at.push_back(a);
    for (int64_t v : r.nified) nified.push_back(v);
    result = r;
  }
  if (!have) return 0;
  result.nified = nified;
  result.added_at = added_at;

  // _mask_partial (realigner.py:951-981)
  if (cfg.mask_partial_ins || cfg.min_unanchored_ins > 0) {
    const RIndel& first = indels.front();
    const RIndel& last = indels.back();
    if (first.is_insertion || last.is_insertion) {
      auto should_mask = [&](const CigOp& o, const RIndel& ind) {
        if (o.op != OP_I) return false;
        bool partial = cfg.mask_partial_ins && o.len < ind.length;
        bool unanchored = ind.length < cfg.min_unanchored_ins;
        return partial || unanchored;
      };
      Cigar new_cigar;
      for (size_t i = 0; i < result.cigar.size(); i++) {
        const CigOp& o = result.cigar[i];
        if (i == 0 && should_mask(o, first))
          new_cigar.push_back({OP_S, o.len});
        else if (i == result.cigar.size() - 1 && should_mask(o, last))
          new_cigar.push_back({OP_S, o.len});
        else
          new_cigar.push_back(o);
      }
      Cigar compressed;
      for (const auto& o : new_cigar) {
        if (!compressed.empty() && compressed.back().op == o.op)
          compressed.back().len += o.len;
        else
          compressed.push_back(o);
      }
      result.cigar = compressed;
    }
  }

  reapply_softclips(full_seq, quals, n_prefix, n_suffix, prefix_softclip,
                    suffix_softclip, pmap, ref, ref_len, cfg, &result);

  // post-reapply deletion right-anchor recheck (realigner.py:921-935)
  for (size_t k = 0; k < accepted_sub.size(); k++) {
    const RIndel& cur = indels[accepted_sub[k]];
    if (!cur.is_insertion) {
      int64_t added = result.added_at[k];
      int64_t anchor_start = added + 1;
      int64_t right_sc = 0;
      if (!result.cigar.empty() && result.cigar.back().op == OP_S)
        right_sc = result.cigar.back().len;
      int64_t right_anchor_len = seq_len - anchor_start - right_sc;
      if (right_anchor_len < cur.length && anchor_start < seq_len &&
          right_anchor_len >= 0) {
        if (anchor_start + right_anchor_len <= seq_len &&
            (int64_t)cur.ref_allele.size() >= 1 + right_anchor_len &&
            full_seq.compare(anchor_start, right_anchor_len, cur.ref_allele,
                             1, right_anchor_len) == 0)
          return 0;
      }
    }
  }

  if (result.sum_mm_quals == -1) {
    std::vector<int64_t> final_map;
    final_map.reserve(n_prefix + pmap.size() + n_suffix);
    for (int64_t k = 0; k < n_prefix; k++) final_map.push_back(-1);
    final_map.insert(final_map.end(), pmap.begin(), pmap.end());
    for (int64_t k = 0; k < n_suffix; k++) final_map.push_back(-1);
    std::vector<int8_t> mm;
    if (mismatch_map(full_seq, final_map, ref, ref_len, &mm))
      result.sum_mm_quals = sum_mm_quals_of(mm, quals);
  }

  // emit
  if ((int32_t)result.cigar.size() > cap ||
      (int32_t)result.added_at.size() > cap ||
      (int32_t)result.nified.size() > cap)
    return -1;
  for (size_t k = 0; k < result.cigar.size(); k++) {
    out_ops[k] = result.cigar[k].op;
    out_lens[k] = (int32_t)result.cigar[k].len;
  }
  *out_nc = (int32_t)result.cigar.size();
  out_counters[0] = result.num_indels;
  out_counters[1] = result.num_mismatches;
  out_counters[2] = result.num_softclips;
  out_counters[3] = result.num_non_n_softclips;
  out_counters[4] = result.num_deleted;
  out_counters[5] = result.num_inserted;
  out_counters[6] = result.num_matches;
  out_counters[7] = result.num_indel_bases;
  out_counters[8] = result.num_mm_incl_sc;
  out_counters[9] = result.anchor_length;
  out_counters[10] = result.sum_mm_quals;
  out_counters[11] = result.is_sketchy ? 1 : 0;
  out_counters[12] = result.position;
  for (size_t k = 0; k < result.added_at.size(); k++)
    out_added[k] = (int32_t)result.added_at[k];
  *out_n_added = (int32_t)result.added_at.size();
  for (size_t k = 0; k < result.nified.size(); k++)
    out_nified[k] = (int32_t)result.nified[k];
  *out_n_nified = (int32_t)result.nified.size();
  return 1;
}

}  // extern "C"
