"""Analyses of the port's traces and models: the per-wave trace report
(:mod:`.wave_report`) and the analytic roofline counters
(:mod:`.roofline`)."""
