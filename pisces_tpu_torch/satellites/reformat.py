"""ReformatVcf: crush <-> uncrush VCF rewriting.

Port of src/tools/ReformatVcf/Reformat.cs:33-61: the input VCF (which may
be a non-Pisces VCF) is streamed allele-by-allele through the AlleleReader
conversion (our to_called_alleles) and every locus is re-emitted through a
default-config Pisces VcfFileWriter — a full conversion into Pisces
format (header, FORMAT tags, filter mapping incl. Unknown->"Other"), not
a textual rewrite. Crush mode merges co-located alleles into one record;
uncrush splits them into per-allele lines (1/2 loci get the <M>
placeholder alt, VcfFileWriter uncrushed mode).
"""
from __future__ import annotations

import argparse
import os
import sys


def reformat(in_path: str, out_path: str, crush: bool) -> str:
    """Reformat.DoReformating: AllowMultipleVcfLinesPerLoci = !crush
    (Reformat.cs:40-44); writer built from default VcfConsumerAppOptions
    (gVCF-style header, VcfWritingParameters.cs:7)."""
    from pisces_tpu_torch.options import PiscesApplicationOptions
    from pisces_tpu_torch.io.vcf_write import VcfWriter, VcfWriterConfig
    from pisces_tpu_torch.io.vcf_read import (read_header_and_variants,
                                        iter_colocated, to_called_alleles)

    opts = PiscesApplicationOptions()
    opts.vcf_writing_parameters.output_gvcf_file = True
    # validate() re-derives allow_multiple_vcf_lines_per_loci from ploidy;
    # ForceCrush is the override that survives it (Reformat.cs:40-44)
    opts.vcf_writing_parameters.force_crush = crush
    cfg = VcfWriterConfig(opts)

    _, variants = read_header_and_variants(in_path)
    writer = VcfWriter(out_path, cfg, reference_name="", sample_name="",
                       command_line="")
    writer.write_header()
    for group in iter_colocated(variants):
        alleles = []
        for v in group:
            alleles.extend(to_called_alleles(v))
        if alleles:
            writer.write(alleles)
    writer.close()
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="reformat-vcf")
    p.add_argument("-vcf", required=True)
    p.add_argument("-log", default=None, help="log file name base")
    p.add_argument("-crush", default=None, help="true to crush, false to uncrush")
    p.add_argument("-o", "-out", "-outfolder", "--out", dest="out", default=None)
    args = p.parse_args(argv)
    crush = (args.crush or "true").lower() == "true"
    out_dir = args.out or os.path.dirname(args.vcf)
    os.makedirs(out_dir, exist_ok=True)
    suffix = ".crushed.vcf" if crush else ".uncrushed.vcf"
    out = os.path.join(out_dir,
                       os.path.basename(args.vcf).replace(".vcf", suffix))
    reformat(args.vcf, out, crush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
