"""Scale-out over several ranks: the data x model mesh and its sharded steps
(mesh.py) and the launcher of one process per rank (launch.py)."""
