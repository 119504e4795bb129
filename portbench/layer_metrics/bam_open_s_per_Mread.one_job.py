"""bam_open_s_per_Mread, in the cells whose runs spread reads_per_s too widely
to hold it end to end: the same reader, under a name whose moves is
peak_rss_gib, the end-to-end metric those cells keep besides setup_s."""

from portbench.layer_metrics.bam_open_s_per_Mread import read  # noqa: F401
