"""The LM substrate's dense serving path (counterpart of ``repro.models``)."""
