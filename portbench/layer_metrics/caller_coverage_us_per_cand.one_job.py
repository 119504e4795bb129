"""caller_coverage_us_per_cand, in the cells whose runs spread reads_per_s too widely
to hold it end to end: the same reader, under a name whose moves is
peak_rss_gib, the end-to-end metric those cells keep besides setup_s."""

from portbench.layer_metrics.caller_coverage_us_per_cand import read  # noqa: F401
