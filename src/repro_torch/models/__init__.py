"""The paper's backbones (``small``) as plain functions over parameter dicts."""
