"""Deprecated location of the fault-tolerance objects
(:mod:`.fault_tolerance`)."""
