"""Architecture configs (copies of the reference's ``repro/configs``)."""
