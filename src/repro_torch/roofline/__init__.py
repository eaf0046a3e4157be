"""Roofline of the port's steps — the port of ``repro.roofline``: the cost
of a step counted on the meta device or on the card (:mod:`.cost`), its
roofline terms on the H100 (:mod:`.analysis`) and the dry-run's tables
(:mod:`.report`)."""
