"""Command-line drivers (counterpart of ``repro.launch``)."""
