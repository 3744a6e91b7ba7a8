"""Deprecated location of the jitted-op corpus (:mod:`.corpus`)."""
