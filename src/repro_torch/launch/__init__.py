"""Device meshes for the port's sharded execution (``launch/mesh.py``)."""
