"""Traffic: each mix is a data file here (``<mix>.json``) whose
``generator`` names the module that drives it (``<generator>.py``)."""
