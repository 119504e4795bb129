"""Judge a VCF/gVCF body against the plain reference's expected lines.

expected_body() builds, per chromosome, the lines the reference expects at
a precision; render() writes them as a VCF body (the control's output is
such a rendering); compare() reads a body (the program's, or the control's)
and returns the numbers that decide `correct`:

- line_mismatches: expected lines that are missing or differ in any field
  (QUAL, FILTER, INFO DP, GT, GQ, AD, DP, NL; VF beyond its printed
  rounding), plus lines the reference does not expect;
- sb_gap: the widest gap of the SB field, |program - reference| over
  max(1, |reference|) dB, over the lines compared.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.reference import calls
from portbench.reference.scoring import GT_STRINGS, Precision

# printed with 3 decimals: half a unit of the last digit, and round-off
VF_SLACK = 0.0005 + 1e-6


def expected_body(sample, counts, cfg: dict, pr: Precision) -> list:
    """Per chromosome of the sample: (name, sequence, variant lines by
    position, reference-line arrays or None). counts is the read layout's
    counts(sample, ch, min_base_quality); cfg the configuration's "calling"
    block."""
    out = []
    for ch in sample.chroms:
        counts_ch = counts(sample, ch, cfg["min_bq"])
        seq_str = ch.seq.tobytes().decode()
        snv = calls.score_snvs(counts_ch, ch.seq, cfg, pr)
        if cfg["genotyper"] == "diploid":
            var = calls.diploid_lines(snv, seq_str, cfg, pr)
        else:
            var = calls.somatic_variant_lines(snv, seq_str, cfg, pr)
        ref = calls.reference_lines(counts_ch, ch.seq, cfg, pr) \
            if cfg["gvcf"] else None
        out.append((ch.name, ch.seq, var, ref))
    return out


def _fmt_line(chrom, pos, d) -> str:
    filt = ";".join(sorted(d["filters"])) or "PASS"
    ad = ",".join(str(x) for x in d["ad"])
    return (f"{chrom}\t{pos}\t.\t{d['ref']}\t{d['alt']}\t{d['qual']}\t{filt}"
            f"\tDP={d['dp_info']}\tGT:GQ:AD:DP:VF:NL:SB\t{d['gt']}:{d['gq']}:"
            f"{ad}:{d['dp']}:{d['vf']:.3f}:{d['nl']}:{d['sb']:.4f}")


def render(expected: list, q_filter: int) -> str:
    """The expected lines as a VCF body (no header)."""
    lines = []
    for chrom, seq, var, ref in expected:
        positions = sorted(var) if ref is None else range(1, len(seq) + 1)
        for pos in positions:
            if pos in var:
                lines.extend(_fmt_line(chrom, pos, d) for d in var[pos])
                continue
            i = pos - 1
            filt = ("LowDP;" if ref["low_dp"][i] else "") + \
                (f"q{q_filter}" if ref["low_q"][i] else "")
            filt = filt.rstrip(";") or "PASS"
            t = int(ref["total"][i])
            lines.append(
                f"{chrom}\t{pos}\t.\t{chr(seq[i])}\t.\t{int(ref['qual'][i])}"
                f"\t{filt}\tDP={t}\tGT:GQ:AD:DP:VF:NL:SB\t"
                f"{GT_STRINGS[int(ref['gt'][i])]}:{int(ref['gq'][i])}:"
                f"{int(ref['support'][i])}:{t}:{ref['vf'][i]:.3f}:"
                f"{int(ref['nl'][i])}:{ref['sb'][i]:.4f}")
    return "\n".join(lines) + "\n"


def read_body(path: str) -> str:
    with open(path) as f:
        return "".join(line for line in f if not line.startswith("#"))


def _parse(line: str) -> Tuple[str, int, dict]:
    f = line.split("\t")
    keys = f[8].split(":")
    vals = dict(zip(keys, f[9].split(":")))
    d = {"ref": f[3], "alt": f[4], "qual": int(f[5]),
         "filters": frozenset(() if f[6] == "PASS" else f[6].split(";")),
         "dp_info": int(f[7].split("=")[1]) if f[7].startswith("DP=") else -1,
         "gt": vals.get("GT"), "gq": int(vals.get("GQ", -1)),
         "ad": tuple(int(x) for x in vals.get("AD", "").split(",") if x),
         "dp": int(vals.get("DP", -1)), "vf": float(vals.get("VF", "nan")),
         "nl": int(vals.get("NL", -1)), "sb": float(vals.get("SB", "nan"))}
    return f[0], int(f[1]), d


def _differs(got: dict, want: dict) -> str:
    for k in ("ref", "alt", "qual", "filters", "dp_info", "gt", "gq", "ad",
              "dp", "nl"):
        if got[k] != want[k]:
            return k
    if not abs(got["vf"] - want["vf"]) <= VF_SLACK:
        return "vf"
    return ""


def _sb_gap(got: float, want: float) -> float:
    return abs(got - want) / max(1.0, abs(want))


def _ref_columns(rows: List[List[str]]) -> dict:
    """The fields of reference lines (split on tabs) as arrays."""
    smp = [r[9].split(":") for r in rows]
    cols = {"pos": np.array([int(r[1]) for r in rows], np.int64),
            "ref": np.array([r[3] for r in rows]),
            "qual": np.array([int(r[5]) for r in rows], np.int64),
            "filter": np.array([r[6] for r in rows]),
            "dp_info": np.array([int(r[7][3:]) for r in rows], np.int64),
            "format": np.array([r[8] for r in rows])}
    for j, (k, t) in enumerate((("gt", str), ("gq", int), ("ad", int),
                                ("dp", int), ("vf", float), ("nl", int),
                                ("sb", float))):
        cols[k] = np.array([t(x[j]) if len(x) > j else t(-1)
                            for x in smp])
    return cols


def _compare_ref_lines(chrom, seq, ref, rows, positions, q_filter, bad):
    """Reference lines, columnar: (lines compared, widest SB gap)."""
    if not len(positions):
        for r in rows:
            bad(f"{chrom}:{r[1]} {r[3]}>. unexpected")
        return 0, 0.0
    got = _ref_columns(rows) if rows else None
    have = got["pos"] if got else np.empty(0, np.int64)
    for p in np.setdiff1d(positions, have)[:8].tolist():
        bad(f"{chrom}:{p} reference line missing")
    n_missing = len(np.setdiff1d(positions, have))
    for _ in range(max(0, n_missing - 8)):
        bad(None)
    extra = ~np.isin(have, positions) if got else np.empty(0, bool)
    for p in have[extra].tolist():
        bad(f"{chrom}:{p} reference line unexpected")
    if not got:
        return len(positions), 0.0
    keep = ~extra
    pos = have[keep]
    i = pos - 1
    g = {k: v[keep] for k, v in got.items()}
    filt = np.where(ref["low_dp"][i] & ref["low_q"][i], f"LowDP;q{q_filter}",
                    np.where(ref["low_dp"][i], "LowDP",
                             np.where(ref["low_q"][i], f"q{q_filter}",
                                      "PASS")))
    gt = np.array([GT_STRINGS[int(x)] for x in ref["gt"][i]])
    want = {"ref": seq[i].view("S1").astype(str), "qual": ref["qual"][i],
            "filter": filt, "dp_info": ref["total"][i], "gt": gt,
            "gq": ref["gq"][i], "ad": ref["support"][i],
            "dp": ref["total"][i], "nl": ref["nl"][i]}
    wrong = np.zeros(len(pos), bool)
    for k, w in want.items():
        diff = g[k] != w
        for j in np.flatnonzero(diff)[:2].tolist():
            bad(f"{chrom}:{pos[j]} reference line {k}: {g[k][j]} != {w[j]}",
                count=False)
        wrong |= diff
    wrong |= ~(np.abs(g["vf"] - ref["vf"][i]) <= VF_SLACK)
    wrong |= g["format"] != "GT:GQ:AD:DP:VF:NL:SB"
    for _ in range(int(wrong.sum())):
        bad(None)
    gap = np.abs(g["sb"] - ref["sb"][i]) / np.maximum(1.0,
                                                     np.abs(ref["sb"][i]))
    return len(positions), float(gap.max(initial=0.0))


def compare(body: str, expected: list, q_filter: int) -> dict:
    """Numbers of a body against the expected lines (module docstring)."""
    var_got: Dict[Tuple[str, int], List[dict]] = {}
    ref_rows: Dict[str, List[List[str]]] = {}
    for line in body.splitlines():
        if not line:
            continue
        f = line.split("\t")
        if f[4] == "." and len(f) >= 10:
            ref_rows.setdefault(f[0], []).append(f)
        else:
            chrom, pos, d = _parse(line)
            var_got.setdefault((chrom, pos), []).append(d)
    mismatches, compared, sb_gap = 0, 0, 0.0
    examples: List[str] = []

    def bad(msg, count=True):
        nonlocal mismatches
        if count:
            mismatches += 1
        if msg is not None and len(examples) < 8:
            examples.append(msg)

    for chrom, seq, var, ref in expected:
        for pos in sorted(var):
            lines = var_got.pop((chrom, pos), [])
            for j, w in enumerate(var[pos]):
                compared += 1
                if j >= len(lines):
                    bad(f"{chrom}:{pos} {w['ref']}>{w['alt']} missing")
                    continue
                k = _differs(lines[j], w)
                if k:
                    bad(f"{chrom}:{pos} {w['ref']}>{w['alt']} {k}: "
                        f"{lines[j][k]} != {w[k]}")
                sb_gap = max(sb_gap, _sb_gap(lines[j]["sb"], w["sb"]))
            for extra in lines[len(var[pos]):]:
                bad(f"{chrom}:{pos} {extra['ref']}>{extra['alt']} unexpected")
        rows = ref_rows.pop(chrom, [])
        if ref is None:
            for r in rows:
                bad(f"{chrom}:{r[1]} {r[3]}>. unexpected")
            continue
        positions = np.setdiff1d(np.arange(1, len(seq) + 1),
                                 np.fromiter(var, np.int64, len(var)))
        n, gap = _compare_ref_lines(chrom, seq, ref, rows, positions,
                                    q_filter, bad)
        compared += n
        sb_gap = max(sb_gap, gap)
    for (chrom, pos), lines in var_got.items():
        for extra in lines:
            bad(f"{chrom}:{pos} {extra['ref']}>{extra['alt']} unexpected")
    for chrom, rows in ref_rows.items():
        for r in rows:
            bad(f"{chrom}:{r[1]} {r[3]}>. unexpected")
    return {"lines_compared": compared, "line_mismatches": mismatches,
            "sb_gap": sb_gap, "examples": examples}
