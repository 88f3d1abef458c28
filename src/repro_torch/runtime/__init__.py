"""The port's runtime: checkpoint and restart (``checkpoint``).  The elastic
re-mesh and straggler handling wait for the mesh slice."""
