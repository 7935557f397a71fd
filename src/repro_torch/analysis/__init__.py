"""Cost counting and the three-term roofline of the dry run (twin of
``repro.analysis``)."""
