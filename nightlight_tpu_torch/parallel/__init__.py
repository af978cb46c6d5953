"""Multi-device scaling: a single-process device mesh and sharded pipeline
steps (parallel/mesh.py)."""
