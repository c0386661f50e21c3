"""The analysis layer (counterpart of ``repro.analysis``): the H100
roofline (``roofline``), the dry run's markdown table (``report``) and the
port's static analysis (``lint``)."""
