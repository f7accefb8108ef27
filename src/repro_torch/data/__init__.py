"""The port's data layer: ``data.synthetic``, the deterministic token stream."""
