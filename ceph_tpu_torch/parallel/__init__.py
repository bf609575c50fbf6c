"""Device-mesh sharding for the batched erasure-code engine (mesh.py),
and its standalone smoke run (dryrun.py)."""
