"""Analyses of the port's traces, models and dry runs: the per-wave trace
report (:mod:`.wave_report`), the collective statistics
(:mod:`.hlo_stats`), the three-term roofline with its analytic counters
(:mod:`.roofline`) and the dry-run fit table (:mod:`.report`)."""
