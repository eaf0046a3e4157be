"""Launchers of the port (``repro.launch``): ``steps`` builds the step
functions, ``serve`` is the serving entry point."""
