"""Model-zoo configurations of the port (``repro.configs``): the schema in
``base``, one module per architecture, ``registry`` for ``--arch``."""
