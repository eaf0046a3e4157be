"""Models of the port (``repro.models``): the paper's backbones (``small``)
as plain functions over parameter dicts, and the dense GQA decoders of the
LLM zoo (``transformer`` over ``attention``, ``moe``, ``layers`` and
``pdefs``, reached through ``registry``)."""
