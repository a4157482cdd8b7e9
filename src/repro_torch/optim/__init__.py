"""Server optimizers (:mod:`.base`) and the DASHA trainer's config and
method factory (:mod:`.distributed`); port of ``repro.optim``."""
