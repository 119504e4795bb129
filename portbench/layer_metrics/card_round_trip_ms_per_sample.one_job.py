"""card_round_trip_ms_per_sample, in the cells whose runs spread reads_per_s too widely
to hold it end to end: the same reader, under a name whose moves is
peak_rss_gib, the end-to-end metric those cells keep besides setup_s."""

from portbench.layer_metrics.card_round_trip_ms_per_sample import read  # noqa: F401
