"""Math ops of the port: rays, positional encoding, density, volume
rendering, the hash grid (H1/H2) and the error-bound sampler with its probe
grid (Stage 1); projection + SH, SSIM, flat binning and the K1/K2 tile
walks, the K3/K4 top-K walks, the image epilogue, the mesh rasterizer
(Stage 4)."""
