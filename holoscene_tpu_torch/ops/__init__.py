"""Math ops of the port: projection + SH, SSIM, flat binning and the K1/K2
tile walks, the image epilogue, the mesh rasterizer."""
