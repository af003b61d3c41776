"""Stage 0 of the port: monocular depth / normal priors for every image
(port of holoscene_tpu/stage0; reference marigold/run.py +
midas/omnidata.py)."""
