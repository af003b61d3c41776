"""Models of the port (Stage 4: Gaussian-on-Mesh)."""
