"""CreateGenomeSizeFile CLI (reference: src/tools/CreateGenomeSizeFile/
Program.cs:33-52): writes GenomeSize.xml (and any missing .fai indexes)
for a folder of FASTA files so it can be used as a Pisces genome directory.
"""
import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="create_genome_size")
    p.add_argument("genome_dir", help="folder containing *.fa / *.fasta")
    p.add_argument("genome_name", nargs="?", default=None,
                   help="genomeName attribute (default: folder name)")
    p.add_argument("-out", default=None, help="output xml path "
                   "(default: <genome_dir>/GenomeSize.xml)")
    a = p.parse_args(argv)
    from pisces_tpu_torch.io.fasta import create_genome_size_xml
    path = create_genome_size_xml(a.genome_dir, out_path=a.out,
                                  genome_name=a.genome_name)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
