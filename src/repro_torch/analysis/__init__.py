"""Measurement half of the analysis layer (counterpart of
``repro.analysis``): the H100 roofline (``roofline``) and the dry run's
markdown table (``report``)."""
