// Native read-pair stitcher: CigarReconciler-grade port of
// preprocessing/stitcher.py (which itself ports the reference's
// StitchingLogic layer — BasicStitcher.cs:68-211, CigarReconciler.cs:91-1328,
// OverlapEvaluator.cs:1-292). Semantics are intentionally IDENTICAL to the
// Python implementation, including its bug-compatible quirks (general path
// never increments n_agree; N-disagreements fold into n_disagree on the
// general path only). tests/test_torch_preprocessing.py checks it against
// the Python stitcher and against the reference package on seeded pairs.
//
// Build: pisces_tpu_torch/io/native.py get_lib() (g++ at first use, with
// the other io/_native sources, into one library).
// Binding: ctypes (pisces_tpu_torch/preprocessing/stitcher.py).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <string>
#include <vector>

namespace {

constexpr int MAX_BQ = 93;

struct Item {
  char op;
  char base;    // 0 for D/N
  int16_t qual; // -1 for D/N
};

struct Site {
  std::vector<Item> r1, r2;
  bool is_prefix = false, is_suffix = false;
  std::vector<Item>& ops(bool read1) { return read1 ? r1 : r2; }
  const std::vector<Item>& cops(bool read1) const { return read1 ? r1 : r2; }
  bool has_value() const { return !r1.empty() || !r2.empty(); }
  bool has_ref_span(bool read1) const {
    for (const auto& it : cops(read1))
      if (it.op == 'M' || it.op == 'D' || it.op == 'N') return true;
    return false;
  }
  bool has_insertion(bool read1) const {
    for (const auto& it : cops(read1))
      if (it.op == 'I') return true;
    return false;
  }
};

struct Pos {
  Site unmapped, mapped;
};

struct Info {
  std::string cigar;  // expanded op chars
  std::string dirs;   // expanded F/R/S per op
  std::string bases;
  std::vector<int16_t> quals;
  int n_disagree = 0, n_agree = 0, n_ndis = 0;
  bool is_simple = false;
  std::string overlap_bases;
  int ignored_probe_prefix = 0, ignored_probe_suffix = 0;
};

inline bool is_read_span(char c) { return c == 'M' || c == 'I' || c == 'S'; }
inline bool is_ref_span(char c) { return c == 'M' || c == 'D' || c == 'N'; }

// _OP_CHAR: 0..4 -> MIDNS, 7/8 -> M, others -> '?'
inline char op_char(uint8_t code) {
  switch (code) {
    case 0: return 'M';
    case 1: return 'I';
    case 2: return 'D';
    case 3: return 'N';
    case 4: return 'S';
    case 7: case 8: return 'M';
    default: return '?';
  }
}

int64_t read_span_of(const uint8_t* ops, const int32_t* lens, int n) {
  int64_t s = 0;
  for (int i = 0; i < n; i++)
    if (is_read_span(op_char(ops[i]))) s += lens[i];
  return s;
}

int64_t ref_span_of(const uint8_t* ops, const int32_t* lens, int n) {
  int64_t s = 0;
  for (int i = 0; i < n; i++)
    if (is_ref_span(op_char(ops[i]))) s += lens[i];
  return s;
}

// _prefix_clip: leading S length; hard clips (5) don't interrupt
int64_t prefix_clip_of(const uint8_t* ops, const int32_t* lens, int n) {
  int64_t s = 0;
  for (int i = 0; i < n; i++) {
    if (ops[i] == 4) s += lens[i];
    else if (ops[i] != 5) break;
  }
  return s;
}

int64_t suffix_clip_of(const uint8_t* ops, const int32_t* lens, int n) {
  int64_t s = 0;
  for (int i = n - 1; i >= 0; i--) {
    if (ops[i] == 4) s += lens[i];
    else if (ops[i] != 5) break;
  }
  return s;
}

void expand_chars(const uint8_t* ops, const int32_t* lens, int n,
                  std::string* out) {
  out->clear();
  for (int i = 0; i < n; i++) out->append((size_t)lens[i], op_char(ops[i]));
}

// ---------------------------------------------------------------------------
// super-simple fast path (CigarReconciler.GetSuperDuperSimpleStitchedCigar)
// ---------------------------------------------------------------------------

// (prefixS, M, suffixS) for S?M S? cigars (skipping hard clips), else false
bool simple_components(const uint8_t* ops, const int32_t* lens, int n,
                       int64_t* sp, int64_t* m, int64_t* ss) {
  std::vector<std::pair<uint8_t, int32_t>> v;
  for (int i = 0; i < n; i++)
    if (ops[i] != 5) v.push_back({ops[i], lens[i]});
  if (v.size() == 3 && v[0].first == 4 && v[1].first == 0 && v[2].first == 4) {
    *sp = v[0].second; *m = v[1].second; *ss = v[2].second;
    return true;
  }
  if (v.size() == 2) {
    if (v[0].first == 4 && v[1].first == 0) {
      *sp = v[0].second; *m = v[1].second; *ss = 0;
      return true;
    }
    if (v[0].first == 0 && v[1].first == 4) {
      *sp = 0; *m = v[0].second; *ss = v[1].second;
      return true;
    }
  }
  if (v.size() == 1 && v[0].first == 0) {
    *sp = 0; *m = v[0].second; *ss = 0;
    return true;
  }
  return false;
}

bool super_simple(int64_t p1, const uint8_t* ops1, const int32_t* lens1,
                  int nc1, const char* seq1, const uint8_t* qual1, int len1,
                  int64_t p2, const uint8_t* ops2, const int32_t* lens2,
                  int nc2, const char* seq2, const uint8_t* qual2, int len2,
                  bool r1_is_reverse, bool r1_is_first_mate, int min_bq,
                  bool nify, Info* info) {
  bool super_clean = (nc1 == 1 && nc2 == 1 && ops1[0] == 0 && ops2[0] == 0);
  int64_t sp1, m1, ss1, sp2, m2, ss2;
  if (!simple_components(ops1, lens1, nc1, &sp1, &m1, &ss1)) return false;
  if (!simple_components(ops2, lens2, nc2, &sp2, &m2, &ss2)) return false;
  if (ss1 + sp2 > 0) return false;
  int64_t pos_gap = p2 - p1;
  if ((pos_gap > 0 && pos_gap > m1) || (pos_gap < 0 && -pos_gap > m2))
    return false;
  int64_t r1_end = p1 + ref_span_of(ops1, lens1, nc1);
  int64_t r2_end = p2 + ref_span_of(ops2, lens2, nc2);
  if (!(p2 < r1_end && r1_end <= r2_end)) return false;
  int64_t overlap = r1_end - p2;
  int64_t r1_len = len1;
  int64_t r1_first_overlap = r1_len - overlap;
  if ((sp1 > 0 && sp1 >= r1_first_overlap) || (ss2 > 0 && m2 < overlap))
    return false;
  if (overlap <= 0) return false;
  if (!super_clean) {
    std::string e1, e2;
    expand_chars(ops1, lens1, nc1, &e1);
    expand_chars(ops2, lens2, nc2, &e2);
    for (int64_t i = 0; i < overlap; i++)
      if (e1[(size_t)(r1_first_overlap + i)] != e2[(size_t)i]) return false;
  }

  info->is_simple = true;
  int64_t r1_before = r1_len - overlap;
  int64_t r2_after = len2 - overlap;
  std::string s1o(seq1 + r1_first_overlap, (size_t)overlap);
  std::string s2o(seq2, (size_t)overlap);
  std::vector<int16_t> out_q((size_t)overlap);
  for (int64_t i = 0; i < overlap; i++) {
    int q = (int)qual1[r1_before + i] + (int)qual2[i];
    out_q[(size_t)i] = (int16_t)(q > MAX_BQ ? MAX_BQ : q);
  }
  std::string stitched_s;
  if (s1o == s2o) {
    info->n_agree = (int)overlap;
    stitched_s = s1o;
  } else {
    stitched_s = s1o;
    int n_dis = 0;
    for (int64_t i = 0; i < overlap; i++) {
      char b1 = s1o[(size_t)i], b2 = s2o[(size_t)i];
      if (b1 == b2) continue;
      n_dis++;
      if (b1 == 'N' || b2 == 'N') info->n_ndis++;
      int q1 = qual1[r1_before + i], q2 = qual2[i];
      char b;
      int q;
      if (nify) {
        q = 0; b = 'N';
      } else {
        if (r1_is_first_mate) {
          if (q1 >= q2) { b = b1; q = q1; } else { b = b2; q = q2; }
        } else {
          if (q2 >= q1) { b = b2; q = q2; } else { b = b1; q = q1; }
        }
        if (q1 > min_bq && q2 > min_bq) q = 0;
      }
      stitched_s[(size_t)i] = b;
      out_q[(size_t)i] = (int16_t)q;
    }
    info->n_disagree = n_dis - info->n_ndis;
    info->n_agree = (int)overlap - n_dis;
  }
  info->quals.clear();
  for (int64_t i = 0; i < r1_before; i++)
    info->quals.push_back((int16_t)qual1[i]);
  for (auto q : out_q) info->quals.push_back(q);
  for (int64_t i = overlap; i < len2; i++)
    info->quals.push_back((int16_t)qual2[i]);

  info->bases.assign(seq1, (size_t)r1_before);
  info->bases += stitched_s;
  info->bases.append(seq2 + overlap, (size_t)(len2 - overlap));
  info->overlap_bases = stitched_s;
  int64_t m_len = (int64_t)info->bases.size() - sp1 - ss2;
  info->cigar.assign((size_t)sp1, 'S');
  info->cigar.append((size_t)m_len, 'M');
  info->cigar.append((size_t)ss2, 'S');
  char d1 = r1_is_reverse ? 'R' : 'F';
  char d2 = r1_is_reverse ? 'F' : 'R';
  info->dirs.assign((size_t)r1_before, d1);
  info->dirs.append((size_t)overlap, 'S');
  info->dirs.append((size_t)r2_after, d2);
  return true;
}

// ---------------------------------------------------------------------------
// site-by-site reconciliation (the general path)
// ---------------------------------------------------------------------------

// AddR1ToList/AddR2ToList
void add_read(std::vector<Pos>* positions, const std::string& expanded,
              const char* bases, const uint8_t* quals, int64_t start_offset,
              bool read1) {
  int64_t n_ref = 0;
  for (char c : expanded)
    if (is_ref_span(c)) n_ref++;
  int64_t target = start_offset + n_ref +
      ((!expanded.empty() && !is_ref_span(expanded.back())) ? 1 : 0);
  while ((int64_t)positions->size() < target) positions->push_back(Pos());
  int64_t ref_pos = start_offset;
  int64_t idx = 0;
  for (char op : expanded) {
    if (is_ref_span(op)) {
      Item item;
      if (op == 'D' || op == 'N') {
        item = {op, 0, -1};
      } else {
        item = {op, bases[idx], (int16_t)quals[idx]};
        idx++;
      }
      (*positions)[(size_t)ref_pos].mapped.ops(read1).push_back(item);
      ref_pos++;
    } else {
      Item item = {op, bases[idx], (int16_t)quals[idx]};
      idx++;
      (*positions)[(size_t)ref_pos].unmapped.ops(read1).push_back(item);
    }
  }
}

// RedistributeSoftclips (CigarReconciler.cs:949-1167)
void redistribute_softclips(std::vector<Pos>* positions, bool operate_on_r1,
                            bool has_prefix_clip, bool has_suffix_clip,
                            bool allow_terminal_dels) {
  bool th = operate_on_r1;
  bool ot = !operate_on_r1;
  bool have_suffix_to_add = false;
  Pos suffix_to_add;

  size_t i = 0;
  while (i < positions->size()) {
    Pos& sp = (*positions)[i];
    Pos* nxt = (i + 1 < positions->size()) ? &(*positions)[i + 1] : nullptr;
    Pos* prv = (i > 0) ? &(*positions)[i - 1] : nullptr;

    bool is_suffix = (i == positions->size() - 1)
        || (nxt != nullptr && nxt->unmapped.cops(th).empty()
            && nxt->mapped.cops(th).empty());
    bool is_prefix = (i == 0)
        || (prv != nullptr && prv->unmapped.cops(th).empty()
            && prv->mapped.cops(th).empty());
    if (is_prefix) is_suffix = false;
    if (sp.unmapped.has_value()) {
      sp.unmapped.is_prefix = is_prefix;
      sp.unmapped.is_suffix = is_suffix;
    }

    if (!is_prefix && !has_suffix_clip) break;
    if (!is_suffix && !has_prefix_clip) { i++; continue; }

    if (is_suffix) {
      std::vector<Item>& ops_this = sp.unmapped.ops(th);
      if (ops_this.size() > sp.unmapped.cops(ot).size()) {
        std::deque<Item> give;
        size_t n_give = 0;
        for (size_t k = ops_this.size(); k-- > 0;) {
          if (ops_this[k].op == 'S') { give.push_front(ops_this[k]); n_give++; }
          else break;
        }
        ops_this.resize(ops_this.size() - n_give);
        size_t count = 0;
        while (!give.empty()) {
          size_t j = i + count;
          if (j > positions->size() - 1) {
            // Python overwrites suffix_to_add with a fresh _Pos on each
            // spill (a later spill discards an earlier one) — mirror that
            suffix_to_add = Pos();
            for (const auto& it : give)
              suffix_to_add.unmapped.ops(th).push_back(it);
            have_suffix_to_add = true;
            give.clear();
            break;
          }
          Pos& cur = (*positions)[j];
          while (cur.unmapped.cops(ot).size() != cur.unmapped.cops(th).size()
                 && !give.empty()) {
            cur.unmapped.ops(th).push_back(give.front());
            give.pop_front();
          }
          std::vector<Item>& other_mapped = cur.mapped.ops(ot);
          bool all_d = !other_mapped.empty();
          for (const auto& it : other_mapped)
            if (it.op != 'D') { all_d = false; break; }
          if (allow_terminal_dels && all_d) {
            // terminal S supports the overlapping deletion
            cur.mapped.ops(th).push_back(other_mapped[0]);
          } else if (!other_mapped.empty() && !give.empty()
                     && cur.mapped.cops(th).empty()) {
            cur.mapped.ops(th).push_back(give.front());
            give.pop_front();
          }
          count++;
        }
      }
    }
    if (is_prefix) {
      std::vector<Item>& ops_this = sp.unmapped.ops(th);
      if (ops_this.size() > sp.unmapped.cops(ot).size()) {
        std::deque<Item> give;
        size_t n_give = 0;
        for (const auto& it : ops_this) {
          if (it.op == 'S') { give.push_back(it); n_give++; }
          else break;
        }
        ops_this.erase(ops_this.begin(), ops_this.begin() + n_give);
        int64_t count = 0;
        while (!give.empty()) {
          count++;
          int64_t j = (int64_t)i - count;
          Pos& penultimate = (*positions)[(size_t)(j + 1)];
          if (j < 0) {
            penultimate.unmapped.ops(th).assign(give.begin(), give.end());
            break;
          }
          Pos& cur = (*positions)[(size_t)j];
          std::vector<Item>& other_mapped = cur.mapped.ops(ot);
          bool all_d = !other_mapped.empty();
          for (const auto& it : other_mapped)
            if (it.op != 'D') { all_d = false; break; }
          if (allow_terminal_dels && all_d) {
            cur.mapped.ops(th).push_back(other_mapped[0]);
            continue;
          } else if (!other_mapped.empty() && !give.empty()
                     && cur.mapped.cops(th).empty()) {
            cur.mapped.ops(th).push_back(give.back());
            give.pop_back();
          } else {
            penultimate.unmapped.ops(th).assign(give.begin(), give.end());
            break;
          }
        }
      }
    }
    i++;
  }
  if (have_suffix_to_add) positions->push_back(suffix_to_add);
}

// 0 means "no combined op" (Python None)
char combined_op(char op1, char op2) {
  if (op1 == 0 && op2 == 0) return 0;
  if (op1 == 0) return op2;
  if (op2 == 0) return op1;
  if (op1 == op2) return op1;
  if (op1 == 'S') return op2;
  if (op2 == 'S') return op1;
  return 0;
}

struct Cursor {
  int64_t in_r1 = -1, in_r2 = -1;
};

// AddStitchedBaseAndUpdateNumDisagreements (CigarReconciler.cs:866-946)
void merge_stitched_base(Info* info, const Item& r1_item, const Item& r2_item,
                         char r1_dir, bool r1_is_first_mate, int min_bq,
                         bool nify) {
  char b1 = r1_item.base, b2 = r2_item.base;
  int q1 = r1_item.qual, q2 = r2_item.qual;
  if (b1 == b2) {
    info->bases.push_back(b1);
    int q = q1 + q2;
    info->quals.push_back((int16_t)(q > MAX_BQ ? MAX_BQ : q));
    return;
  }
  info->n_disagree++;
  if (nify) {
    info->bases.push_back('N');
    info->quals.push_back(0);
    return;
  }
  const Item& fwd = (r1_dir == 'F') ? r1_item : r2_item;
  const Item& rev = (r1_dir == 'F') ? r2_item : r1_item;
  char base;
  int q;
  if (fwd.qual > rev.qual) {
    base = fwd.base;
    q = (rev.qual < min_bq) ? fwd.qual : 0;
  } else if (fwd.qual == rev.qual) {
    const Item& first = r1_is_first_mate ? r1_item : r2_item;
    const Item& second = r1_is_first_mate ? r2_item : r1_item;
    base = first.base;
    q = (second.qual < min_bq) ? first.qual : 0;
  } else {
    base = rev.base;
    q = (fwd.qual < min_bq) ? rev.qual : 0;
  }
  info->bases.push_back(base);
  info->quals.push_back((int16_t)q);
}

void fill_in_from_read(const std::vector<Item>& items, Info* info,
                       char direction, Cursor* cur, bool read1) {
  for (const auto& it : items) {
    info->dirs.push_back(direction);
    info->cigar.push_back(it.op);
    if (it.op == 'D' || it.op == 'N') continue;
    if (is_read_span(it.op)) {
      if (read1) cur->in_r1++;
      else cur->in_r2++;
    }
    info->bases.push_back(it.base);
    info->quals.push_back(it.qual);
  }
}

// ReconcileSite (CigarReconciler.cs:668-832)
// returns 1 ok, 0 unstitchable, -2 probe ValueError
int reconcile_site(const Site& site, Info* info, Cursor* cur,
                   int64_t prefix_probe_clip_end,
                   int64_t suffix_probe_clip_start, bool pair_is_outie,
                   char r1_dir, char r2_dir, bool r1_is_first_mate,
                   bool right_align, bool use_softclipped_bases,
                   bool ignore_probe_softclips, int min_bq, bool nify) {
  int64_t n1 = (int64_t)site.r1.size();
  int64_t n2 = (int64_t)site.r2.size();
  if (n1 == 1 && n2 == 1) {
    const Item& item1 = site.r1[0];
    const Item& item2 = site.r2[0];
    if (item1.op == 'M' && item2.op == 'M') {
      info->cigar.push_back('M');
      cur->in_r1++;
      cur->in_r2++;
      info->dirs.push_back('S');
      merge_stitched_base(info, item1, item2, r1_dir, r1_is_first_mate,
                          min_bq, nify);
      return 1;
    }
  }
  int64_t offset = (n1 > n2) ? n1 - n2 : n2 - n1;
  bool r1_longer = n1 > n2;
  int64_t mx = (n1 > n2) ? n1 : n2;
  for (int64_t j = 0; j < mx; j++) {
    int64_t i1, i2;
    if (right_align) {
      i1 = r1_longer ? j : j - offset;
      i2 = r1_longer ? j - offset : j;
    } else {
      i1 = j;
      i2 = j;
    }
    const Item* item1 = (i1 >= 0 && i1 < n1) ? &site.r1[(size_t)i1] : nullptr;
    const Item* item2 = (i2 >= 0 && i2 < n2) ? &site.r2[(size_t)i2] : nullptr;
    char op1 = item1 ? item1->op : 0;
    char op2 = item2 ? item2->op : 0;
    char combined = combined_op(op1, op2);
    if (combined == 0) return 0;
    info->cigar.push_back(combined);

    bool r1_used = (item1 != nullptr);
    bool r2_used = (item2 != nullptr);
    if (r1_used && is_read_span(op1)) cur->in_r1++;
    if (r2_used && is_read_span(op2)) cur->in_r2++;
    if (combined != 'S') {
      if (!use_softclipped_bases && op2 == 'S') r2_used = false;
      if (!use_softclipped_bases && op1 == 'S') r1_used = false;
    }
    if (ignore_probe_softclips) {
      if (r1_used && op1 == 'S') {
        bool is_probe = (pair_is_outie && cur->in_r1 >= suffix_probe_clip_start)
            || (!pair_is_outie && cur->in_r1 < prefix_probe_clip_end);
        if (is_probe && r2_used) {
          r1_used = false;
          if (pair_is_outie) info->ignored_probe_suffix++;
          else info->ignored_probe_prefix++;
        }
      }
      if (r2_used && op2 == 'S') {
        bool is_probe = (pair_is_outie && cur->in_r2 < prefix_probe_clip_end)
            || (!pair_is_outie && cur->in_r2 >= suffix_probe_clip_start);
        if (is_probe && r1_used) {
          r2_used = false;
          if (pair_is_outie) info->ignored_probe_prefix++;
          else info->ignored_probe_suffix++;
        }
      }
      if (!r1_used && !r2_used) return -2;
    }

    bool stitched = r1_used && r2_used;
    info->dirs.push_back(stitched ? 'S' : (r1_used ? r1_dir : r2_dir));
    if (combined == 'D' || combined == 'N') continue;
    if (stitched) {
      merge_stitched_base(info, *item1, *item2, r1_dir, r1_is_first_mate,
                          min_bq, nify);
    } else {
      const Item* item = r1_used ? item1 : item2;
      info->bases.push_back(item->base);
      info->quals.push_back(item->qual);
    }
  }
  return 1;
}

bool has_incompatible_insertion(const Pos& pos, const Pos* before) {
  const Site& um = pos.unmapped;
  if (um.r1.empty() && um.r2.empty()) return false;
  for (int r = 0; r < 2; r++) {
    bool read1 = (r == 0);
    bool other = !read1;
    if (pos.unmapped.cops(other).empty() && pos.unmapped.has_insertion(read1)
        && pos.mapped.has_ref_span(other) && before != nullptr
        && before->mapped.has_ref_span(other))
      return true;
  }
  return false;
}

bool has_internal_softclip_runs(const std::string& expanded) {
  // over compressed runs: an S run that is neither first nor last
  std::vector<char> runs;
  for (size_t i = 0; i < expanded.size(); i++)
    if (i == 0 || expanded[i] != expanded[i - 1]) runs.push_back(expanded[i]);
  for (size_t i = 0; i < runs.size(); i++)
    if (runs[i] == 'S' && i > 0 && i + 1 < runs.size()) return true;
  return false;
}

// returns 1 ok, 0 null, -2 probe error
int reconcile_sites(std::vector<Pos>* positions, bool r1_is_reverse,
                    bool pair_is_outie, bool r1_is_first_mate,
                    int64_t prefix_probe_clip_end,
                    int64_t suffix_probe_clip_start, bool r1_has_prefix,
                    bool r1_has_suffix, bool r2_has_prefix, bool r2_has_suffix,
                    bool use_softclipped_bases, bool ignore_probe_softclips,
                    int min_bq, bool nify, bool allow_terminal_dels,
                    Info* info) {
  char r1_dir = r1_is_reverse ? 'R' : 'F';
  char r2_dir = r1_is_reverse ? 'F' : 'R';

  if (r1_has_prefix || r1_has_suffix)
    redistribute_softclips(positions, true, r1_has_prefix, r1_has_suffix,
                           allow_terminal_dels);
  if (r2_has_prefix || r2_has_suffix)
    redistribute_softclips(positions, false, r2_has_prefix, r2_has_suffix,
                           allow_terminal_dels);

  Cursor cur;
  int empty_sites = 0;
  for (size_t i = 0; i < positions->size(); i++) {
    Pos& pos = (*positions)[i];
    const Pos* before = (i > 0) ? &(*positions)[i - 1] : nullptr;
    if (has_incompatible_insertion(pos, before)) return 0;
    if (empty_sites >= 1 && pos.mapped.has_value()) return 0;
    if (!pos.unmapped.has_value() && !pos.mapped.has_value()) {
      empty_sites++;
      continue;
    }
    int ok = reconcile_site(pos.unmapped, info, &cur, prefix_probe_clip_end,
                            suffix_probe_clip_start, pair_is_outie, r1_dir,
                            r2_dir, r1_is_first_mate, pos.unmapped.is_prefix,
                            use_softclipped_bases, ignore_probe_softclips,
                            min_bq, nify);
    if (ok != 1) return ok;
    size_t n1 = pos.mapped.r1.size();
    size_t n2 = pos.mapped.r2.size();
    if (n2 > 0 && n1 == 0) {
      fill_in_from_read(pos.mapped.r2, info, r2_dir, &cur, false);
      continue;
    }
    if (n1 > 0 && n2 == 0) {
      fill_in_from_read(pos.mapped.r1, info, r1_dir, &cur, true);
      continue;
    }
    if (n1 == 0 && n2 == 0) continue;
    ok = reconcile_site(pos.mapped, info, &cur, prefix_probe_clip_end,
                        suffix_probe_clip_start, pair_is_outie, r1_dir, r2_dir,
                        r1_is_first_mate, false, use_softclipped_bases,
                        ignore_probe_softclips, min_bq, nify);
    if (ok != 1) return ok;
  }

  if (has_internal_softclip_runs(info->cigar)) return 0;
  return 1;
}

// ---------------------------------------------------------------------------
// repeat detection (OverlapEvaluator)
// ---------------------------------------------------------------------------

bool string_is_repeat_of_units(const std::string& overlap,
                               const std::string& unit) {
  size_t first = overlap.find(unit);
  if (first != std::string::npos && first > 0) {
    if (first >= unit.size()) return false;
    if (overlap.compare(0, first, unit, unit.size() - first, first) != 0)
      return false;
  }
  if (first == std::string::npos) return false;  // matches Python .find -1 path
  size_t i = first;
  bool is_full = true;
  while (i < overlap.size()) {
    if (overlap.compare(i, unit.size(), unit) == 0) {
      i += unit.size();
      continue;
    }
    size_t remaining = overlap.size() - i;
    if (remaining <= unit.size())
      return overlap.compare(i, remaining, unit, 0, remaining) == 0;
    return false;
  }
  return is_full;
}

bool is_repeat(const std::string& overlap, int max_unit = 3) {
  int window = 1;
  int max_window = (int)overlap.size() - 1;
  if (max_window > max_unit) max_window = max_unit;
  while (window <= max_window) {
    // SlideSequence: candidate units from the first few start offsets
    int n = (int)overlap.size();
    int limit = (n >= 5) ? 2 : n - window;
    std::vector<std::string> units;
    for (int i = 0; i <= limit; i++) {
      if (i + window > n) continue;
      std::string u = overlap.substr((size_t)i, (size_t)window);
      bool seen = false;
      for (const auto& x : units)
        if (x == u) { seen = true; break; }
      if (!seen) units.push_back(u);
    }
    for (const auto& unit : units) {
      if (overlap.size() == unit.size()) continue;
      if (string_is_repeat_of_units(overlap, unit)) return true;
    }
    window++;
  }
  return false;
}

char char_op_code(char c) {
  switch (c) {
    case 'M': return 0;
    case 'I': return 1;
    case 'D': return 2;
    case 'N': return 3;
    case 'S': return 4;
    default: return 0;
  }
}

}  // namespace

extern "C" {

// Stitch one mate pair. Returns:
//   1  stitched (outputs filled)
//   0  unstitchable
//  -2  "both R1 and R2 in probe softclip" (caller raises ValueError)
//
// Output buffers are caller-allocated: out_cigar_ops/out_cigar_lens sized
// >= out_cap entries, out_seq/out_qual >= out_cap bytes, out_xd >= 8*out_cap.
// out_counts = {n_agree, n_disagree, n_ndis}. out_len/out_ncigar/out_xd_len
// receive the filled sizes; *out_pos1 the 1-based stitched start.
int stitch_pair(
    int64_t pos1_r1, const uint8_t* ops1, const int32_t* lens1, int nc1,
    const char* seq1, const uint8_t* qual1, int len1,
    int64_t pos1_r2, const uint8_t* ops2, const int32_t* lens2, int nc2,
    const char* seq2, const uint8_t* qual2, int len2,
    int r1_is_reverse, int min_base_quality, int nify_disagreements,
    int use_softclipped_bases, int dont_stitch_homopolymer_bridge,
    int max_read_length, int pair_is_outie /* -1 => default */,
    int r1_is_first_mate, int ignore_probe_softclips,
    int allow_terminal_dels, int threshold_num_disagreeing /* -1 => none */,
    int count_ns_toward_disagreements,
    int64_t* out_pos1, uint8_t* out_cigar_ops, int32_t* out_cigar_lens,
    int32_t* out_ncigar, char* out_seq, uint8_t* out_qual, int32_t* out_len,
    char* out_xd, int32_t* out_xd_len, int32_t* out_counts, int32_t out_cap) {
  if (nc1 == 0 || nc2 == 0) return 0;

  // normalize so r1 is the earlier read by clip-adjusted position
  // (AlignmentSet.cs:29-36)
  if (pos1_r1 - prefix_clip_of(ops1, lens1, nc1)
      > pos1_r2 - prefix_clip_of(ops2, lens2, nc2)) {
    std::swap(pos1_r1, pos1_r2);
    std::swap(ops1, ops2);
    std::swap(lens1, lens2);
    std::swap(nc1, nc2);
    std::swap(seq1, seq2);
    std::swap(qual1, qual2);
    std::swap(len1, len2);
    r1_is_reverse = !r1_is_reverse;
    r1_is_first_mate = !r1_is_first_mate;
  }
  bool outie = (pair_is_outie < 0) ? (r1_is_reverse != 0)
                                   : (pair_is_outie != 0);

  // IsStitchable span gate (BasicStitcher.cs:195-200)
  int64_t r1_end = pos1_r1 + ref_span_of(ops1, lens1, nc1) - 1;
  bool stitchable;
  if (use_softclipped_bases)
    stitchable = (r1_end + suffix_clip_of(ops1, lens1, nc1)
                  >= pos1_r2 - prefix_clip_of(ops2, lens2, nc2));
  else
    stitchable = r1_end >= pos1_r2;
  if (!stitchable) return 0;

  int64_t max_stitched = (int64_t)max_read_length * 2 - 1;

  Info info;
  bool have = super_simple(pos1_r1, ops1, lens1, nc1, seq1, qual1, len1,
                           pos1_r2, ops2, lens2, nc2, seq2, qual2, len2,
                           r1_is_reverse != 0, r1_is_first_mate != 0,
                           min_base_quality, nify_disagreements != 0, &info);
  if (have && (int64_t)info.bases.size() > max_stitched) return 0;
  if (!have) {
    std::vector<Pos> positions;
    std::string e1, e2;
    expand_chars(ops1, lens1, nc1, &e1);
    expand_chars(ops2, lens2, nc2, &e2);
    // unsupported op chars would misalign base bookkeeping — refuse so the
    // caller falls back to the Python path (which is equally unsupported)
    for (char c : e1)
      if (c == '?') return -1;
    for (char c : e2)
      if (c == '?') return -1;
    if (pos1_r1 < pos1_r2) {
      add_read(&positions, e1, seq1, qual1, 0, true);
      add_read(&positions, e2, seq2, qual2, pos1_r2 - pos1_r1, false);
    } else {
      add_read(&positions, e2, seq2, qual2, 0, false);
      add_read(&positions, e1, seq1, qual1, pos1_r1 - pos1_r2, true);
    }
    if ((int64_t)positions.size() > max_stitched) return 0;
    int64_t r1_pre = prefix_clip_of(ops1, lens1, nc1);
    int64_t r2_pre = prefix_clip_of(ops2, lens2, nc2);
    int64_t r1_suf = suffix_clip_of(ops1, lens1, nc1);
    int64_t r2_suf = suffix_clip_of(ops2, lens2, nc2);
    int64_t prefix_probe_clip_end = outie ? r2_pre : r1_pre;
    int64_t suffix_probe_clip_start = outie
        ? read_span_of(ops1, lens1, nc1) - r1_suf
        : read_span_of(ops2, lens2, nc2) - r2_suf;
    int ok = reconcile_sites(
        &positions, r1_is_reverse != 0, outie, r1_is_first_mate != 0,
        prefix_probe_clip_end, suffix_probe_clip_start, r1_pre > 0,
        r1_suf > 0, r2_pre > 0, r2_suf > 0, use_softclipped_bases != 0,
        ignore_probe_softclips != 0, min_base_quality,
        nify_disagreements != 0, allow_terminal_dels != 0, &info);
    if (ok != 1) return ok;
  }

  // disagreement threshold (BasicStitcher.cs:85-88)
  if (threshold_num_disagreeing >= 0) {
    int n = info.n_disagree
        + (count_ns_toward_disagreements ? info.n_ndis : 0);
    if (n > threshold_num_disagreeing) return 0;
  }

  // homopolymer-bridge rejection (OverlapEvaluator.BridgeAnchored)
  if (dont_stitch_homopolymer_bridge) {
    bool anchored;
    if (info.is_simple) {
      anchored = (info.overlap_bases.size() <= 3)
          || !is_repeat(info.overlap_bases);
    } else {
      std::string ov;
      size_t bi = 0;
      for (size_t k = 0; k < info.cigar.size(); k++) {
        char op = info.cigar[k];
        if (op == 'D' || op == 'N') continue;
        if (info.dirs[k] == 'S') ov.push_back(info.bases[bi]);
        bi++;
      }
      if (ov.size() <= 3) {
        anchored = true;
      } else {
        bool all_same = true;
        for (char c : ov)
          if (c != ov[0]) { all_same = false; break; }
        anchored = all_same ? false : !is_repeat(ov);
      }
    }
    if (!anchored) return 0;
  }

  // emit: compressed cigar, seq, quals, XD
  int32_t ncig = 0;
  for (size_t k = 0; k < info.cigar.size(); k++) {
    if (k == 0 || info.cigar[k] != info.cigar[k - 1]) {
      if (ncig >= out_cap) return -1;
      out_cigar_ops[ncig] = (uint8_t)char_op_code(info.cigar[k]);
      out_cigar_lens[ncig] = 1;
      ncig++;
    } else {
      out_cigar_lens[ncig - 1]++;
    }
  }
  *out_ncigar = ncig;
  if ((int64_t)info.bases.size() > out_cap) return -1;
  memcpy(out_seq, info.bases.data(), info.bases.size());
  for (size_t k = 0; k < info.quals.size(); k++)
    out_qual[k] = (uint8_t)info.quals[k];
  *out_len = (int32_t)info.bases.size();
  int32_t xn = 0;
  {
    size_t k = 0;
    while (k < info.dirs.size()) {
      size_t j = k;
      while (j < info.dirs.size() && info.dirs[j] == info.dirs[k]) j++;
      xn += snprintf(out_xd + xn, 16, "%d%c", (int)(j - k), info.dirs[k]);
      k = j;
    }
  }
  *out_xd_len = xn;
  out_counts[0] = info.n_agree;
  out_counts[1] = info.n_disagree;
  out_counts[2] = info.n_ndis;
  *out_pos1 = (pos1_r1 < pos1_r2) ? pos1_r1 : pos1_r2;
  return 1;
}

// Stitch many mate pairs in ONE call over the columnar ReadBatch arrays
// (io/bam.py ReadBatch layout): the per-pair ctypes marshalling of
// stitch_pair measured ~64us/pair in the warm gemini profile — more than
// the stitch itself. Pairs are given as (idx1, idx2) read-index arrays,
// ALREADY ordered so pos[idx1] <= pos[idx2] (the caller's mate ordering);
// stitch_pair still performs its own clip-adjusted normalization.
//
// Outputs land at fixed per-pair strides: cigar entry p at
// out_ops[p*cig_stride..], sequence/quals at out_seq[p*seq_stride..], XD
// at out_xd[p*xd_stride..]. ok[p] receives stitch_pair's return code
// (1 stitched, 0 unstitchable, -1 unsupported -> caller re-runs that pair
// through the Python path, -2 probe-softclip conflict).
int stitch_pairs_batch(
    int64_t n_pairs, const int64_t* idx1, const int64_t* idx2,
    const int32_t* pos, const uint16_t* flag,
    const int64_t* cigar_off, const uint8_t* cigar_ops,
    const int32_t* cigar_lens,
    const int64_t* seq_off, const int8_t* seq_codes, const uint8_t* qual,
    const char* code_lut, int lut_len,
    int min_base_quality, int nify_disagreements, int use_softclipped_bases,
    int dont_stitch_homopolymer_bridge, int max_read_length,
    int ignore_probe_softclips, int allow_terminal_dels,
    int threshold_num_disagreeing, int count_ns_toward_disagreements,
    int8_t* ok, int64_t* out_pos1,
    uint8_t* out_ops, int32_t* out_lens, int32_t* out_ncig,
    int64_t cig_stride,
    char* out_seq, uint8_t* out_qual, int32_t* out_len, int64_t seq_stride,
    char* out_xd, int32_t* out_xd_len, int64_t xd_stride,
    int32_t* out_counts) {
  std::vector<char> s1, s2;
  for (int64_t p = 0; p < n_pairs; p++) {
    int64_t a = idx1[p], b = idx2[p];
    int64_t ca = cigar_off[a], cb = cigar_off[b];
    int nc1 = (int)(cigar_off[a + 1] - ca);
    int nc2 = (int)(cigar_off[b + 1] - cb);
    int64_t sa = seq_off[a], sb = seq_off[b];
    int len1 = (int)(seq_off[a + 1] - sa);
    int len2 = (int)(seq_off[b + 1] - sb);
    // the native stitcher assumes the valid-BAM invariant
    // len(seq) == read-span(cigar); the per-pair wrapper gates on it
    // (stitcher.py stitch_reads) — malformed records must take the
    // Python fallback, not index past their buffers here
    if (read_span_of(cigar_ops + ca, cigar_lens + ca, nc1) != len1 ||
        read_span_of(cigar_ops + cb, cigar_lens + cb, nc2) != len2) {
      ok[p] = -1;
      continue;
    }
    s1.resize(len1);
    s2.resize(len2);
    for (int k = 0; k < len1; k++) {
      int c = seq_codes[sa + k];
      s1[k] = (c >= 0 && c < lut_len) ? code_lut[c] : 'N';
    }
    for (int k = 0; k < len2; k++) {
      int c = seq_codes[sb + k];
      s2[k] = (c >= 0 && c < lut_len) ? code_lut[c] : 'N';
    }
    int cap = (int)(cig_stride < seq_stride ? cig_stride : seq_stride);
    ok[p] = (int8_t)stitch_pair(
        (int64_t)pos[a] + 1, cigar_ops + ca, cigar_lens + ca, nc1,
        s1.data(), qual + sa, len1,
        (int64_t)pos[b] + 1, cigar_ops + cb, cigar_lens + cb, nc2,
        s2.data(), qual + sb, len2,
        (flag[a] & 0x10) ? 1 : 0, min_base_quality, nify_disagreements,
        use_softclipped_bases, dont_stitch_homopolymer_bridge,
        max_read_length, /*pair_is_outie=*/-1,
        (flag[a] & 0x40) ? 1 : 0, ignore_probe_softclips,
        allow_terminal_dels, threshold_num_disagreeing,
        count_ns_toward_disagreements,
        out_pos1 + p, out_ops + p * cig_stride, out_lens + p * cig_stride,
        out_ncig + p, out_seq + p * seq_stride, out_qual + p * seq_stride,
        out_len + p, out_xd + p * xd_stride, out_xd_len + p,
        out_counts + 3 * p, cap);
  }
  return 0;
}

}  // extern "C"

// The alignment summary of the realigner (realign.cpp calls it). The RMxN
// scan that follows it in the reference package's source is rmxn.cpp here.
extern "C" {

// Extensions.GetAlignmentSummary (ReadRealignmentLogic/Utlity/
// Extensions.cs:18-179; Python port preprocessing/realigner.py:71-140).
// Walks the cigar against the reference counting matches/mismatches/
// softclips/indels and the min(front, back) anchor. Returns 0 and fills
// out[10] = {num_matches, num_mismatches, num_mismatches_incl_softclip,
// num_indels, num_inserted_bases, num_deleted_bases, num_indel_bases,
// num_softclips, num_non_n_softclips, anchor_length}; returns 1 for the
// Python path's None (an M base falling outside the reference).
int aln_summary(const uint8_t* ref, int64_t ref_len, int64_t start_ref0,
                const uint8_t* ops, const int32_t* lens, int nc,
                const char* read_seq, int check_softclips,
                int32_t* out) {
  int64_t prefix_clip = 0;
  for (int i = 0; i < nc; i++) {
    if (ops[i] == 4) prefix_clip += lens[i];
    else if (ops[i] != 5) break;
  }
  int64_t ref_i = start_ref0;
  if (check_softclips) ref_i -= prefix_clip;
  int64_t read_i = 0;
  int64_t anchor = 0, end_anchor = 0;
  bool hit_non_match = false, hit_non_n_softclip = false;
  int32_t n_match = 0, n_mm = 0, n_mm_sc = 0, n_indels = 0, n_ins = 0,
      n_del = 0, n_indel_bases = 0, n_sc = 0, n_nn_sc = 0;
  for (int k = 0; k < nc; k++) {
    uint8_t op = ops[k];
    int64_t ln = lens[k];
    if (op == 4) {
      for (int64_t i = 0; i < ln; i++) {
        n_sc++;
        char b = read_seq[read_i + i];
        if (b != 'N' || hit_non_n_softclip) {
          hit_non_n_softclip = true;
          n_nn_sc++;
          if (check_softclips) {
            int64_t p = ref_i + i;
            if (p < 0 || p >= ref_len) n_mm_sc++;
            else if (b != (char)ref[p] && b != 'N') n_mm_sc++;
          }
        }
      }
    } else if (op == 0 || op == 7 || op == 8) {
      for (int64_t i = 0; i < ln; i++) {
        if (ref_i + i > ref_len - 1) return 1;
        if (ref_i + i < 0) return 1;
        char b = read_seq[read_i + i];
        if (b != 'N' && b != (char)ref[ref_i + i]) {
          n_mm++;
          n_mm_sc++;
          hit_non_match = true;
          end_anchor = 0;
        } else {
          if (b != 'N') n_match++;
          if (!hit_non_match) anchor++;
          end_anchor++;
        }
      }
    } else if (op == 1) {
      hit_non_match = true;
      end_anchor = 0;
      n_indels++;
      n_indel_bases += (int32_t)ln;
      n_ins += (int32_t)ln;
    } else if (op == 2 || op == 3) {
      hit_non_match = true;
      end_anchor = 0;
      n_indels++;
      n_indel_bases += (int32_t)ln;
      n_del += (int32_t)ln;
    }
    if (op == 0 || op == 1 || op == 4 || op == 7 || op == 8) read_i += ln;
    if (op == 0 || op == 2 || op == 3 || op == 7 || op == 8) ref_i += ln;
    if (check_softclips && op == 4) ref_i += ln;
  }
  out[0] = n_match;
  out[1] = n_mm;
  out[2] = n_mm_sc;
  out[3] = n_indels;
  out[4] = n_ins;
  out[5] = n_del;
  out[6] = n_indel_bases;
  out[7] = n_sc;
  out[8] = n_nn_sc;
  out[9] = (int32_t)(anchor < end_anchor ? anchor : end_anchor);
  return 0;
}

}  // extern "C"
