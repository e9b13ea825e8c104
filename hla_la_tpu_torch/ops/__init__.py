"""Device operations of the port: the banded NW forward (K1) and the typing
likelihood model (matrix products and the pair reduction, K3)."""
