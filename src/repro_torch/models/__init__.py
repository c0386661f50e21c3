"""The LM substrate's serving path, every family (counterpart of ``repro.models``)."""
