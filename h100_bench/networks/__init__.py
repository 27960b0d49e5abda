"""Network builders, one module each, found by the ``builder`` a
configuration's network names: ``build(draws, spec) -> Graph`` (or a
parameter dict where the port loads the network from a checkpoint)."""
