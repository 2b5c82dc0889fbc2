"""Problem generators (counterpart of ``repro.data``)."""
