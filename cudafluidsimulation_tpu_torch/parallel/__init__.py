"""The sharded rollout: the grid split over a mesh of devices, rows or
rows x cols, each shard stepping its part with explicit halo exchanges
(``mesh.py``, ``halo.py``, ``shardmap_step.py``, ``shardmap2d.py``)."""
