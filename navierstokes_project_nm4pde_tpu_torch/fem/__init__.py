"""P1/P2 reference elements, quadrature, the Taylor-Hood space and cell
geometry: the port's own copies of the JAX package's `fem/` (numpy only)."""
