"""GP linear algebra, SVGD transport, metrics and distributions on torch tensors."""
